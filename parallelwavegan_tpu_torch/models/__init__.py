"""Model registry of the port: the YAML-facing class names.

``HiFiGANGenerator`` (causal or not), ``ParallelWaveGANGenerator`` (causal or not, with
any of its three upsample nets), ``MelGANGenerator`` (MelGAN and
Multi-band MelGAN, causal or not), ``StyleMelGANGenerator``,
the discrete-symbol generators ``DiscreteSymbolHiFiGANGenerator``,
``DiscreteSymbolDurationGenerator`` and
``DiscreteSymbolStyleMelGANGenerator``,
``ParallelWaveGANDiscriminator``, ``ResidualParallelWaveGANDiscriminator``,
``MelGANDiscriminator``, ``MelGANMultiScaleDiscriminator``,
``StyleMelGANDiscriminator``, HiFi-GAN's period, multi-period, scale,
multi-scale and multi-scale multi-period discriminators, the U-Net
HiFi-GAN generator ``UHiFiGANGenerator`` (causal or not) and the VQ-VAE
codec ``VQVAE`` are ported: every name of the JAX package's registry.
Any other name raises ``NotImplementedError`` (ROADMAP.md).
"""

from parallelwavegan_tpu_torch.models.discrete import (
    DiscreteSymbolDurationGenerator,
    DiscreteSymbolHiFiGANGenerator,
)
from parallelwavegan_tpu_torch.models.hifigan import (
    HiFiGANGenerator,
    HiFiGANMultiPeriodDiscriminator,
    HiFiGANMultiScaleDiscriminator,
    HiFiGANMultiScaleMultiPeriodDiscriminator,
    HiFiGANPeriodDiscriminator,
    HiFiGANScaleDiscriminator,
)
from parallelwavegan_tpu_torch.models.melgan import (
    MelGANDiscriminator,
    MelGANGenerator,
    MelGANMultiScaleDiscriminator,
)
from parallelwavegan_tpu_torch.models.parallel_wavegan import (
    ParallelWaveGANDiscriminator,
    ParallelWaveGANGenerator,
    ResidualParallelWaveGANDiscriminator,
)
from parallelwavegan_tpu_torch.models.uhifigan import UHiFiGANGenerator
from parallelwavegan_tpu_torch.models.vqvae import VQVAE
from parallelwavegan_tpu_torch.models.style_melgan import (
    DiscreteSymbolStyleMelGANGenerator,
    StyleMelGANDiscriminator,
    StyleMelGANGenerator,
)

MODEL_REGISTRY = {
    "DiscreteSymbolDurationGenerator": DiscreteSymbolDurationGenerator,
    "DiscreteSymbolHiFiGANGenerator": DiscreteSymbolHiFiGANGenerator,
    "DiscreteSymbolStyleMelGANGenerator": DiscreteSymbolStyleMelGANGenerator,
    "HiFiGANGenerator": HiFiGANGenerator,
    "HiFiGANMultiPeriodDiscriminator": HiFiGANMultiPeriodDiscriminator,
    "HiFiGANMultiScaleDiscriminator": HiFiGANMultiScaleDiscriminator,
    "HiFiGANMultiScaleMultiPeriodDiscriminator": HiFiGANMultiScaleMultiPeriodDiscriminator,
    "HiFiGANPeriodDiscriminator": HiFiGANPeriodDiscriminator,
    "HiFiGANScaleDiscriminator": HiFiGANScaleDiscriminator,
    "MelGANDiscriminator": MelGANDiscriminator,
    "MelGANGenerator": MelGANGenerator,
    "MelGANMultiScaleDiscriminator": MelGANMultiScaleDiscriminator,
    "ParallelWaveGANDiscriminator": ParallelWaveGANDiscriminator,
    "ParallelWaveGANGenerator": ParallelWaveGANGenerator,
    "ResidualParallelWaveGANDiscriminator": ResidualParallelWaveGANDiscriminator,
    "StyleMelGANDiscriminator": StyleMelGANDiscriminator,
    "StyleMelGANGenerator": StyleMelGANGenerator,
    "UHiFiGANGenerator": UHiFiGANGenerator,
    "VQVAE": VQVAE,
}


def get_model_class(name: str):
    if name not in MODEL_REGISTRY:
        raise NotImplementedError(
            f"{name} is not ported to parallelwavegan_tpu_torch yet; "
            "see ROADMAP.md for the modules still to port"
        )
    return MODEL_REGISTRY[name]
