"""PyTorch/CUDA port of parallelwavegan_tpu for one NVIDIA H100.

The JAX package ``parallelwavegan_tpu`` is the reference: every module
here mirrors its counterpart's path and class name, and the tests hold the
two to each other on the CPU. Modules use the (B, C, T) layout and
upstream's state-dict keys. Hand-written CUDA kernels replace the Pallas
kernels on the ported paths: ``ops/kernels/hifigan_tail.py`` the HiFi-GAN
decode tail, ``ops/kernels/hifigan_mrf.py`` HiFi-GAN's MRF stages,
``ops/kernels/wavenet.py`` the WaveNet stack and gated block of Parallel
WaveGAN, ``ops/kernels/melgan_stack.py`` the residual stacks of MelGAN and
Multi-band MelGAN.

This package imports torch, numpy, scipy and the standard library only; it
never imports jax, flax or ``parallelwavegan_tpu``.
"""

__version__ = "0.1.0"
