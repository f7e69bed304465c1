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
the whole padded length, is refused, as in JAX. The discrete-symbol
generators decode unit ids (T, 1|2) as JAX's ``_inference_discrete``
does (:502-590), padding included, since edge padding changes the last
samples: the discrete HiFi-GAN's ids edge-padded to the 32-frame bucket
(at least one bucket) and the output trimmed; the duration generator's
ids embedded and their durations predicted (or ``ds`` given, bypassing
the predictor), the embeddings expanded on the host
(``repeat_by_durations_np``), edge-padded to the bucket, through
``decode_expanded`` and trimmed; the discrete StyleMelGAN's ids
edge-padded to ``noise_len * noise_upsample_factor``, noise_len = (T - 1)
// factor + 1 with no rounding to a multiple of 4 (the mel StyleMelGAN's
differs). ``inference_batch`` refuses them, as JAX's ``_STREAMABLE``
does. The U-Net HiFi-GAN decodes a mel with its excitation (JAX
``_inference_uhifigan``, :468-499): the mel edge-padded to the 32-frame
bucket, the excitation cut or zero-padded to the padded length times
prod(upsample_scales), the output trimmed. A VQ-VAE loads without stats
(:653) and decodes through ``bin/decode.py``'s own loop (its ``encode`` and
``decode``). ``load_model`` runs on the GPU unless the caller asks for
the CPU. The decode surfaces of JAX :167-462 are ported for the
time-local generators (``STREAMABLE``): ``inference_streaming`` (windows
of ``chunk_frames`` with ``context_frames`` of context, interior windows
stacked in power-of-two batches of at most 64), ``inference_sharded``
(one utterance split in time over a ``make_mesh`` list of devices) and
``inference_batch(mesh=...)`` (the rows split over the devices); each
device runs its share as one batched forward on its own replica of the
generator, and every device's share is queued before any is read back.
"""

from __future__ import annotations

import copy
import logging
import os

import numpy as np
import torch
import torch.nn.functional as F

from parallelwavegan_tpu_torch.layers.duration import repeat_by_durations_np
from parallelwavegan_tpu_torch.ops.pqmf import PQMF
from parallelwavegan_tpu_torch.parallel.mesh import canonical_device
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
        self.device = canonical_device(device)
        self._replicas = {}  # device -> this model there (``_on``)
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

    def _takes_noise(self) -> bool:
        return getattr(self.generator, "requires_noise_input", False)

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
        if not self._takes_noise():
            y = self.generator(x).transpose(1, 2)
            if self.pqmf is not None:
                y = self.pqmf.synthesis(y)
            return y
        win = self.generator.aux_context_window
        x = F.pad(x, (win, win), mode="replicate")
        return self.generator(z.reshape(z.shape[0], 1, -1), x).transpose(1, 2)

    def _noise(self, shape: tuple, rng: torch.Generator | None) -> torch.Tensor:
        """N(0, 1) noise on the model's device from ``rng``, or from a
        generator seeded by ``np.random.randint(2**31)`` as the JAX package
        seeds its key."""
        if rng is None:
            rng = torch.Generator(device=self.device)
            rng.manual_seed(int(np.random.randint(2**31)))
        return torch.randn(shape, generator=rng, device=self.device)

    DISCRETE = ("DiscreteSymbolHiFiGANGenerator", "DiscreteSymbolDurationGenerator",
                "DiscreteSymbolStyleMelGANGenerator")

    def _normalized(self, c: np.ndarray, normalize_before: bool) -> np.ndarray:
        if not normalize_before:
            return c
        if self.mean is None:
            raise ValueError("normalize_before needs registered stats")
        return (c - self.mean) / self.scale

    @torch.inference_mode()
    def inference(self, c, normalize_before: bool = False,
                  rng: torch.Generator | None = None, ds=None,
                  excitation=None) -> np.ndarray:
        """mel (T', num_mels) -> waveform (T' * upsample_factor, out), or
        for a discrete-symbol generator unit ids (T', 1|2) -> waveform,
        ``ds`` (T',) the duration generator's given durations; the U-Net
        HiFi-GAN takes the excitation (T' * hop samples, in any shape).

        A generator that takes noise gets it from ``rng``, a generator on
        the model's device (``_noise``)."""
        name = type(self.generator).__name__
        if name in self.DISCRETE:
            return self._inference_discrete(np.asarray(c), rng, ds)
        c = self._normalized(np.asarray(c, dtype=np.float32), normalize_before)
        if name == "UHiFiGANGenerator":
            return self._inference_uhifigan(c, excitation)
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
        if style or self._takes_noise():
            shape = ((noise_len, self.generator.in_channels) if style
                     else (pad_t * up,))
            z = self._noise(shape, rng)
        y = self.forward_padded(c_p, z)
        return y.cpu().numpy()[: t * up]

    def _inference_uhifigan(self, c: np.ndarray, excitation) -> np.ndarray:
        """(mel (T', C), excitation) -> waveform (T' * factor, 1) (JAX
        ``_inference_uhifigan``)."""
        t = c.shape[0]
        factor = self.generator.upsample_factor
        pad_t = -(-t // self.BUCKET) * self.BUCKET
        c = np.pad(c, ((0, pad_t - t), (0, 0)), mode="edge")
        e = np.asarray(excitation, np.float32).reshape(-1)[: pad_t * factor]
        e = np.pad(e, (0, pad_t * factor - len(e)))
        y = self.generator(torch.from_numpy(e[None, None].copy()).to(self.device),
                           torch.from_numpy(np.ascontiguousarray(c.T[None])).to(self.device))
        return y[0].T.cpu().numpy()[: t * factor]

    def _bucket(self, t: int) -> int:
        return max(self.BUCKET, -(-t // self.BUCKET) * self.BUCKET)

    def _ids(self, c: np.ndarray) -> torch.Tensor:
        """Ids (T, C) -> (1, C, T) on the device, cast there by the model."""
        return torch.from_numpy(np.ascontiguousarray(c.T[None])).to(self.device)

    def _inference_discrete(self, c: np.ndarray, rng, ds) -> np.ndarray:
        """Unit ids (T, 1|2) -> waveform (JAX ``_inference_discrete``)."""
        if c.ndim == 1:
            c = c[:, None]
        gen, t = self.generator, c.shape[0]
        name = type(gen).__name__
        if name == "DiscreteSymbolDurationGenerator":
            ids = self._ids(c.astype(np.int64))
            if ds is None:
                ds = gen.predict_durations(ids)[0].cpu().numpy()
            emb = gen.embed_tokens(ids)[0].T.cpu().numpy()  # (T, C)
            expanded = repeat_by_durations_np(emb, np.asarray(ds).reshape(-1))
            frames = expanded.shape[0]
            pad_t = self._bucket(frames)
            expanded = np.pad(expanded, ((0, pad_t - frames), (0, 0)), mode="edge")
            y = gen.decode_expanded(torch.from_numpy(expanded.T[None].copy()).to(self.device))
            return y[0].T.cpu().numpy()[: frames * (y.shape[-1] // pad_t)]
        if name == "DiscreteSymbolStyleMelGANGenerator":
            nuf = gen.noise_upsample_factor
            noise_len = (t - 1) // nuf + 1
            pad_t = noise_len * nuf
            c_p = np.pad(c, ((0, pad_t - t), (0, 0)), mode="edge")
            z = self._noise((1, gen.in_channels, noise_len), rng)
            y = gen(self._ids(c_p), z)
            return y[0].T.cpu().numpy()[: t * gen.upsample_factor]
        pad_t = self._bucket(t)
        c_p = np.pad(c, ((0, pad_t - t), (0, 0)), mode="edge").astype(np.float32)
        y = gen(self._ids(c_p))
        return y[0].T.cpu().numpy()[: t * (y.shape[-1] // pad_t)]

    # the generators whose output at a frame does not depend on the padded
    # length or on frames beyond its receptive field (JAX ``_STREAMABLE``)
    STREAMABLE = ("ParallelWaveGANGenerator", "MelGANGenerator", "HiFiGANGenerator")
    MAX_STREAM_BATCH = 64  # interior windows per forward, bounding device memory

    def _on(self, device: torch.device) -> "InferenceModel":
        """This model on ``device``: itself, or a replica of its generator
        (weights copied, kernel weights prepared there), made on first use
        and kept."""
        if device == self.device:
            return self
        if device not in self._replicas:
            with torch.inference_mode(False):
                gen = copy.deepcopy(self.generator).to(device)
                gen.prepare_kernels()
            self._replicas[device] = InferenceModel(gen, device, mean=self.mean,
                                                    scale=self.scale, pqmf=self.pqmf)
        return self._replicas[device]

    def _forward_split(self, devices: list, c: np.ndarray,
                       z: torch.Tensor | None) -> np.ndarray:
        """``forward_padded_batch`` of rows c (n, frames, num_mels) and z (n,
        ...) with row i on ``devices[i]``: the rows of one device go
        through its replica as one batched forward, every device's forward
        is queued before any result is read back, so that distinct cards
        overlap. Returns the (n, frames * upsample_factor, out) outputs."""
        groups = {}
        for i, dev in enumerate(devices):
            groups.setdefault(dev, []).append(i)
        queued = []
        for dev, rows in groups.items():
            model = self._on(dev)
            cw = torch.from_numpy(np.ascontiguousarray(c[rows])).to(dev)
            zw = None if z is None else z[rows].to(dev)
            queued.append((rows, model.forward_padded_batch(cw, zw)))
        out = None
        for rows, y in queued:
            y = y.cpu().numpy()
            if out is None:
                out = np.empty((len(devices),) + y.shape[1:], np.float32)
            out[rows] = y
        return out

    @torch.inference_mode()
    def inference_batch(self, mels: list, normalize_before: bool = False,
                        rng: torch.Generator | None = None, mesh=None) -> list:
        """A list of mels (T'_i, num_mels) -> their waveforms (T'_i *
        upsample_factor, out), decoded as one (B, pad_t, num_mels) forward:
        each mel edge-padded to pad_t, the 32-frame bucket of the longest.
        Parallel WaveGAN's noise (B, pad_t * upsample_factor) comes from
        ``rng`` as in ``inference``. With ``mesh`` (``make_mesh``), B is
        padded to a multiple of its length by repeating the last row, as
        JAX does (:194-201), and the rows are split over its entries in
        contiguous blocks; only the real rows are returned."""
        name = type(self.generator).__name__
        if name not in self.STREAMABLE:
            raise ValueError(f"{name} does not support batched decode")
        mels = [self._normalized(np.asarray(c, np.float32), normalize_before)
                for c in mels]
        lens = [c.shape[0] for c in mels]
        pad_t = -(-max(lens) // self.BUCKET) * self.BUCKET
        batch = np.stack([np.pad(c, ((0, pad_t - c.shape[0]), (0, 0)), mode="edge")
                          for c in mels])
        mesh = mesh or [self.device]
        n_pad = (-len(mels)) % len(mesh)
        if n_pad:
            batch = np.concatenate([batch, np.repeat(batch[-1:], n_pad, axis=0)])
        up = self.upsample_factor
        z = self._noise((batch.shape[0], pad_t * up), rng) if self._takes_noise() else None
        per = batch.shape[0] // len(mesh)
        y = self._forward_split([d for d in mesh for _ in range(per)], batch, z)
        return [y[i, : n * up] for i, n in enumerate(lens)]

    @torch.inference_mode()
    def inference_streaming(self, c, chunk_frames: int = 256, context_frames: int = 64,
                            normalize_before: bool = False,
                            rng: torch.Generator | None = None) -> np.ndarray:
        """Chunked mel -> wave decode for unbounded lengths (JAX
        ``inference_streaming``, :238-357): windows of ``chunk_frames``
        frames with ``context_frames`` of true neighbouring frames on each
        side. The first window (chunk + ctx frames) starts at the true
        start and the last one ends at the true end, so the model's own
        edge padding applies there as in one forward of the whole mel; the
        interior windows (chunk + 2 ctx frames) are stacked into batches of
        at most 64, each zero-padded to a power-of-two number of windows,
        and the last window is written after them (it overwrites the
        interior's weak-context tail). Every window is queued before any
        result is read back. With the context covering the receptive
        field, the result equals ``forward_padded`` of the exact-length
        mel (not the bucketed ``inference``). A mel of at most chunk + ctx
        frames goes through ``inference``. Parallel WaveGAN's noise is
        drawn once, (T' * upsample_factor,) from ``rng``, and sliced per
        window. StyleMelGAN (instance norms over the whole length) and the
        discrete-symbol, U-Net and VQ-VAE generators are refused."""
        name = type(self.generator).__name__
        if name not in self.STREAMABLE:
            raise ValueError(f"{name} is not streamable "
                             "(global-in-time ops or input-length expansion)")
        c = self._normalized(np.asarray(c, dtype=np.float32), normalize_before)
        t = c.shape[0]
        chunk, ctx = chunk_frames, context_frames
        if t <= chunk + ctx:  # too short to stream
            return self.inference(c, rng=rng)
        if ctx > chunk:
            raise ValueError(f"context_frames ({ctx}) must not exceed chunk_frames "
                             f"({chunk})")
        up = self.upsample_factor
        z_all = self._noise((t * up,), rng) if self._takes_noise() else None
        # (lo, hi, valid_lo, valid_hi) of each window
        first = (0, chunk + ctx, 0, chunk)
        interior = []
        s = chunk
        while s + chunk < t:
            hi = min(s + chunk + ctx, t)
            interior.append((hi - (chunk + 2 * ctx), hi, s, s + chunk))
            s += chunk
        last = (t - (chunk + ctx), t, t - chunk, t)

        def dispatch(lo, hi):
            cw = torch.from_numpy(np.ascontiguousarray(c[lo:hi])).to(self.device)
            return self.forward_padded(cw, None if z_all is None else z_all[lo * up: hi * up])

        queued = [([first], dispatch(*first[:2])[None])]
        win = chunk + 2 * ctx
        for s0 in range(0, len(interior), self.MAX_STREAM_BATCH):
            part = interior[s0: s0 + self.MAX_STREAM_BATCH]
            bucket = 1 << (len(part) - 1).bit_length()
            cw = np.zeros((bucket, win, c.shape[1]), np.float32)
            zw = None if z_all is None else torch.zeros((bucket, win * up),
                                                        device=self.device)
            for j, (lo, hi, _, _) in enumerate(part):
                cw[j] = c[lo:hi]
                if zw is not None:
                    zw[j] = z_all[lo * up: hi * up]
            queued.append((part, self.forward_padded_batch(
                torch.from_numpy(cw).to(self.device), zw)))
        queued.append(([last], dispatch(*last[:2])[None]))

        y = None
        for part, out in queued:
            out = out.cpu().numpy()
            if y is None:
                y = np.empty((t * up, out.shape[2]), np.float32)
            for j, (lo, _, vlo, vhi) in enumerate(part):
                off = (vlo - lo) * up
                y[vlo * up: vhi * up] = out[j, off: off + (vhi - vlo) * up]
        return y

    @torch.inference_mode()
    def inference_sharded(self, c, mesh, context_frames: int = 64,
                          normalize_before: bool = False,
                          rng: torch.Generator | None = None) -> np.ndarray:
        """One utterance with its time axis split over ``mesh``
        (``make_mesh``; JAX ``inference_sharded``, :360-449): the mel is
        edge-padded to the 32-frame bucket as ``inference`` pads it, cut
        into one window per mesh entry, each a bucket-aligned chunk of
        ceil(T / n) frames with ``context_frames`` of true context on each
        side and clamped into [0, T - window] (a clamped window reaches
        the true edge, so its chunk still sees complete context even when
        the chunk is shorter than the context), and the output trimmed.
        The windows of one device run as one batched forward on its
        replica of the generator (``_forward_split``). With the context
        covering the receptive field the result equals ``inference``: the
        noise is drawn as there, (T_padded * upsample_factor,) from
        ``rng``. One mesh entry, or a mel shorter than a window and a
        chunk, goes through ``inference``."""
        name = type(self.generator).__name__
        if name not in self.STREAMABLE:
            raise ValueError(f"{name} is not shardable in time "
                             "(global-in-time ops or input-length expansion)")
        c = self._normalized(np.asarray(c, dtype=np.float32), normalize_before)
        t_orig = c.shape[0]
        t = -(-t_orig // self.BUCKET) * self.BUCKET
        c = np.pad(c, ((0, t - t_orig), (0, 0)), mode="edge")
        n_dev, ctx = len(mesh), context_frames
        chunk = -(-t // n_dev)
        chunk = -(-chunk // self.BUCKET) * self.BUCKET
        win = chunk + 2 * ctx
        if n_dev == 1 or t < win + chunk:  # too short to profit
            return self.inference(c[:t_orig], rng=rng)
        up = self.upsample_factor
        z_all = self._noise((t * up,), rng) if self._takes_noise() else None
        windows = []  # (lo, valid_lo, valid_hi) of each device's window
        for i in range(n_dev):
            vlo = min(i * chunk, t)
            vhi = min(vlo + chunk, t)
            windows.append((max(0, min(vlo - ctx, t - win)), vlo, vhi))
        batch = np.stack([c[lo: lo + win] for lo, _, _ in windows])
        z = None if z_all is None else torch.stack(
            [z_all[lo * up: (lo + win) * up] for lo, _, _ in windows])
        y = self._forward_split(list(mesh), batch, z)
        out = np.empty((t * up, y.shape[2]), np.float32)
        for i, (lo, vlo, vhi) in enumerate(windows):
            if vhi > vlo:
                off = (vlo - lo) * up
                out[vlo * up: vhi * up] = y[i, off: off + (vhi - vlo) * up]
        return out[: t_orig * up]


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
    if stats is not None and generator_type != "VQVAE":
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
