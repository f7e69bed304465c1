"""Model loading + inference wrapper (the port's ``load_model``).

Counterpart of parallelwavegan_tpu/utils/model.py:42-231 and :613-670:
config discovery from the checkpoint directory, the ``upsample_kernal_sizes``
typo remap, generator-only weight load from an upstream ``.pkl``, stats
registered for ``normalize_before``, and ``inference`` padding the mel to a
bucket of 32 frames with edge values before trimming the output, so that
the waveform equals the JAX package's. For Parallel WaveGAN the padded
forward also edge-pads the mel by ``aux_context_window`` frames and takes
noise of the padded length (:67-75, :155-164). A generator with more than
one output channel (Multi-band MelGAN) gets PQMF synthesis after its
forward, with the config's ``pqmf_params`` or, for a config without them
whose ``version`` is 0.4.2 or older (or absent), the old defaults taps 62,
cutoff 0.15, beta 9.0 (:657-665); the upsample factor then counts the
sub-bands (:588-604). StyleMelGAN (:76-88, :142-153) takes noise of
``noise_len`` = ceil(T' / noise_upsample_factor) frames rounded up to a
multiple of 4, and the mel edge-padded to ``noise_len * factor`` frames
instead of the 32-frame bucket; since its instance norms run over the
whole padded length, this padding, which is the JAX package's and not
upstream's, is copied exactly. ``inference_batch`` (JAX :167-231) decodes
a list of mels of HiFi-GAN, Parallel WaveGAN or (Multi-band) MelGAN as
one (B, T, C) forward: each mel edge-padded to the 32-frame bucket of the
longest, each output trimmed to its own length (Parallel WaveGAN takes
noise of the padded length); StyleMelGAN, whose instance norms run over
the whole padded length, is refused, as in JAX. ``load_model`` runs on
the GPU unless the caller asks for the CPU. Streaming and sharded decode
are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch
import torch.nn.functional as F

from parallelwavegan_tpu_torch.ops.pqmf import PQMF
from parallelwavegan_tpu_torch.utils.checkpoint import load_generator_state_dict
from parallelwavegan_tpu_torch.utils.config import load_config
from parallelwavegan_tpu_torch.utils.io import read_hdf5


def _load_stats(stats_path: str):
    if stats_path.endswith(".h5"):
        mean = read_hdf5(stats_path, "mean").reshape(-1)
        scale = read_hdf5(stats_path, "scale").reshape(-1)
    else:
        arr = np.load(stats_path)
        mean = arr[0].reshape(-1)
        scale = arr[1].reshape(-1)
    return mean.astype(np.float32), scale.astype(np.float32)


class InferenceModel:
    """A generator on its device with a reference-compatible ``inference``."""

    BUCKET = 32  # mel frames; the JAX package pads to the same multiple

    def __init__(self, generator, device, mean=None, scale=None, pqmf=None):
        self.generator = generator
        self.device = torch.device(device)
        self.mean = mean
        self.scale = scale
        self.pqmf = pqmf

    @property
    def upsample_factor(self) -> int:
        """Mel frame -> output sample ratio, PQMF synthesis included."""
        f = self.generator.upsample_factor
        return f * self.pqmf.subbands if self.pqmf is not None else f

    def _style(self) -> bool:
        return hasattr(self.generator, "noise_upsample_factor")

    def forward_padded(self, c: torch.Tensor,
                       z: torch.Tensor | None = None) -> torch.Tensor:
        """The padded forward, counterpart of the JAX ``_forward_fn()``: mel
        (pad_t, num_mels) and, for a generator that takes noise, z
        (pad_t * upsample_factor,) -> (pad_t * upsample_factor, out); with
        PQMF, the sub-bands synthesised to (pad_t * upsample_factor, 1).
        StyleMelGAN takes z (noise_len, in_channels) and edge-pads the mel
        to noise_len * noise_upsample_factor frames first."""
        return self.forward_padded_batch(c[None], None if z is None else z[None])[0]

    def forward_padded_batch(self, c: torch.Tensor,
                             z: torch.Tensor | None = None) -> torch.Tensor:
        """``forward_padded`` of a batch, one forward: mel (B, pad_t,
        num_mels) and z (B, ...) -> (B, pad_t * upsample_factor, out), the
        JAX ``jax.vmap(_forward_fn())``."""
        x = c.transpose(1, 2)
        if self._style():
            pad = z.shape[1] * self.generator.noise_upsample_factor - c.shape[1]
            x = F.pad(x, (0, pad), mode="replicate")
            return self.generator(x, z.transpose(1, 2)).transpose(1, 2)
        if not getattr(self.generator, "requires_noise_input", False):
            y = self.generator(x).transpose(1, 2)
            if self.pqmf is not None:
                y = self.pqmf.synthesis(y)
            return y
        win = self.generator.aux_context_window
        x = F.pad(x, (win, win), mode="replicate")
        return self.generator(z.reshape(z.shape[0], 1, -1), x).transpose(1, 2)

    def _noise_rng(self, rng: torch.Generator | None) -> torch.Generator:
        if rng is None:
            rng = torch.Generator(device=self.device)
            rng.manual_seed(int(np.random.randint(2**31)))
        return rng

    @torch.inference_mode()
    def inference(self, c, normalize_before: bool = False,
                  rng: torch.Generator | None = None) -> np.ndarray:
        """mel (T', num_mels) -> waveform (T' * upsample_factor, out).

        A generator that takes noise gets it from ``rng``, a generator on
        the model's device, or else from one seeded by
        ``np.random.randint(2**31)`` as the JAX package seeds its key."""
        c = np.asarray(c, dtype=np.float32)
        if normalize_before:
            if self.mean is None:
                raise ValueError("normalize_before needs registered stats")
            c = (c - self.mean) / self.scale
        t = c.shape[0]
        up = self.upsample_factor
        style = self._style()
        if style:  # the mel is padded to the noise length in forward_padded
            nuf = self.generator.noise_upsample_factor
            noise_len = -(-((t - 1) // nuf + 1) // 4) * 4
            pad_t = t
        else:
            pad_t = -(-t // self.BUCKET) * self.BUCKET
        c_p = np.pad(c, ((0, pad_t - t), (0, 0)), mode="edge")
        c_p = torch.from_numpy(np.ascontiguousarray(c_p)).to(self.device)
        z = None
        if style or getattr(self.generator, "requires_noise_input", False):
            shape = ((noise_len, self.generator.in_channels) if style
                     else (pad_t * up,))
            z = torch.randn(shape, generator=self._noise_rng(rng), device=self.device)
        y = self.forward_padded(c_p, z)
        return y.cpu().numpy()[: t * up]

    # the generators whose output at a frame does not depend on the padded
    # length (JAX ``_STREAMABLE``)
    BATCHABLE = ("ParallelWaveGANGenerator", "MelGANGenerator", "HiFiGANGenerator")

    @torch.inference_mode()
    def inference_batch(self, mels: list, normalize_before: bool = False,
                        rng: torch.Generator | None = None) -> list:
        """A list of mels (T'_i, num_mels) -> their waveforms (T'_i *
        upsample_factor, out), decoded as one (B, pad_t, num_mels) forward:
        each mel edge-padded to pad_t, the 32-frame bucket of the longest.
        Parallel WaveGAN's noise (B, pad_t * upsample_factor) comes from
        ``rng`` as in ``inference``."""
        name = type(self.generator).__name__
        if name not in self.BATCHABLE:
            raise ValueError(f"{name} does not support batched decode")
        mels = [np.asarray(c, np.float32) for c in mels]
        if normalize_before:
            if self.mean is None:
                raise ValueError("normalize_before needs registered stats")
            mels = [(c - self.mean) / self.scale for c in mels]
        lens = [c.shape[0] for c in mels]
        pad_t = -(-max(lens) // self.BUCKET) * self.BUCKET
        batch = np.stack([np.pad(c, ((0, pad_t - c.shape[0]), (0, 0)), mode="edge")
                          for c in mels])
        up = self.upsample_factor
        z = None
        if getattr(self.generator, "requires_noise_input", False):
            z = torch.randn((len(mels), pad_t * up), generator=self._noise_rng(rng),
                            device=self.device)
        y = self.forward_padded_batch(torch.from_numpy(batch).to(self.device), z)
        y = y.cpu().numpy()
        return [y[i, : n * up] for i, n in enumerate(lens)]


def load_model(checkpoint: str, config: dict | None = None,
               stats: str | None = None, *, device="cuda") -> InferenceModel:
    """Load a generator from an upstream ``.pkl`` for inference on ``device``
    (the GPU unless ``device="cpu"`` is asked for): weight norm folded, eval
    mode, kernel weights prepared."""
    from parallelwavegan_tpu_torch.models import get_model_class

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "load_model runs on the GPU by default and no CUDA device is "
            "available: pass device='cpu' to run on the CPU")
    dirname = os.path.dirname(checkpoint)
    if config is None:
        config = load_config(os.path.join(dirname, "config.yml"))
    generator_type = config.get("generator_type", "ParallelWaveGANGenerator")
    # workaround for the reference's config typo (#295)
    generator_params = {
        k.replace("upsample_kernal_sizes", "upsample_kernel_sizes"): v
        for k, v in config["generator_params"].items()
    }
    generator = get_model_class(generator_type)(**generator_params)
    generator.load_state_dict(load_generator_state_dict(checkpoint))
    generator.remove_weight_norm()
    generator.eval().to(device)
    generator.prepare_kernels()

    if stats is None:
        ext = "h5" if config.get("format", "hdf5") == "hdf5" else "npy"
        cand = os.path.join(dirname, f"stats.{ext}")
        if os.path.exists(cand):
            stats = cand
    mean = scale = None
    if stats is not None:
        mean, scale = _load_stats(stats)
        logging.info("Successfully registered stats as buffer.")
    pqmf = None
    if config["generator_params"].get("out_channels", 1) > 1:
        pqmf_params = dict(config.get("pqmf_params", {}))
        if not pqmf_params and _version_leq(str(config.get("version", "0.1.0")),
                                            "0.4.2"):
            pqmf_params.update(taps=62, cutoff_ratio=0.15, beta=9.0)
        pqmf = PQMF(subbands=config["generator_params"]["out_channels"],
                    **pqmf_params)
    return InferenceModel(generator, device, mean=mean, scale=scale, pqmf=pqmf)


def _version_leq(a: str, b: str) -> bool:
    """a <= b for dotted versions, non-digits ignored (the JAX package's
    ``_version_leq``)."""

    def key(v):
        parts = []
        for tok in v.split("."):
            num = "".join(ch for ch in tok if ch.isdigit())
            parts.append(int(num) if num else 0)
        return parts

    return key(a) <= key(b)
