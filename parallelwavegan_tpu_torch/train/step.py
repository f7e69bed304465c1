"""Train and eval steps (counterpart of parallelwavegan_tpu/train/step.py).

One ``TrainStep`` call is one step of upstream's hot loop as the JAX
package computes it (:152-365):

* the G phase (:243-313): the generator's output, the auxiliary (STFT,
  mel) losses times ``lambda_aux`` and, when a D phase runs this step, the
  adversarial loss of D's output on it plus, with the feature-matching
  loss, ``lambda_feat_match`` times the L1 between D's features of it and
  of the real wave (D's pass over the real wave runs without grad: its
  features are detached), all times ``lambda_adv``; then one update of G
  (clipping inside the optimizer);
* the D phase (:315-353): with
  ``update_prediction_after_generator_update`` (the default), or when G
  did not train, G is re-run with its updated weights under
  ``torch.no_grad()`` (for Parallel WaveGAN with ``use_pallas_stack_train``
  that is the K3 inference path); D's real and fake losses, and one
  update of D.

A multi-band generator (Multi-band MelGAN: ``criterion.pqmf`` is set)
gives sub-bands (B, S, T / S); ``aux_losses`` synthesises them to the full
band (B, 1, T) as JAX's ``_generator_losses`` does (:125-150), and the
full band is what the full-band losses and D see, in both phases and in
the eval step. With the sub-band STFT loss the full-band STFT loss is
halved and half the sub-band loss of the sub-bands against the target's
PQMF analysis is added, before ``lambda_aux`` and the adversarial terms.

A discriminator with spectral norm runs one power iteration in every
train-mode forward: the G phase's one or two, then the D phase's over the
real and the fake wave, in JAX's order (:281-303, :337-341); the eval
step runs D in eval mode (``Trainer`` sets it), so (u, v) stay.

Gradients are taken with ``torch.autograd.grad`` with respect to the
phase's own parameters, so the G phase leaves D's untouched; a parameter
the loss does not reach gets a zero gradient, as in JAX. Batches are dicts
of float32 tensors in the (B, C, T) layout (``batch_to_device``).

The discrete-symbol generators (JAX step.py:59-74) take the collated ids
``c``; ``DiscreteSymbolStyleMelGANGenerator`` draws its noise as
StyleMelGAN does. ``DiscreteSymbolDurationGenerator`` runs teacher-forced
to ``out_length = T // prod(upsample_scales)`` frames on the batch's
durations ``ds`` and also returns log-domain durations; its duration
loss, mean((ds_ - log(ds + 1))^2) over every position, padded ones
included (the + 1 is JAX's, which does not read
``duration_loss_params.offset``), is added to the auxiliary losses before
``lambda_aux`` in the G phase and in eval (:261-268, :396-400). The
predictor's dropout follows the module's mode, on in training and off in
eval, its masks drawn as StyleMelGAN's noise is (below).

The VQ-VAE (JAX step.py:76-82, :116-122, :240-260, :315-330, :372-395)
reads the wave itself (``batch["y_in"]``, ``vq_input``: the wave, or its
PQMF analysis where the encoder reads more than one channel) with the
batch's ``local`` and ``global`` conditioning and gives (x_bar, z_e,
z_q); its own loss, added to the auxiliary losses before ``lambda_aux``
in the G phase and in eval, is the quantization loss mean((z_q -
sg(z_e))^2) plus ``lambda_commit`` times the commitment loss mean((z_e
- sg(z_q))^2) (``own_loss``). The U-Net HiFi-GAN takes the batch's
``excitation`` and mel (:51-58); its dropout runs in the G phase with
masks drawn as StyleMelGAN's noise is (below), and is off in the D
phase's re-run of G, as JAX's ``deterministic=not train``, and in eval.
Where D does not train in a step, the G phase has no adversarial term,
as JAX's ``g_sees_d``.

StyleMelGAN draws what JAX draws from its step key: the noise z of the G
phase and of the D phase's re-run (on the device; the duration
predictor's dropout masks likewise), and the random-window
discriminator's starts of the G phase's adversarial call and of the D
phase's real and fake calls (on the CPU). Each draw comes from a generator
seeded by (seed, step, stream) alone (``seeded``), so a resumed run draws
what the uninterrupted run drew at the same step. A batch that holds
``z`` or ``rwd_starts_adv`` / ``_fm`` / ``_real`` / ``_fake`` pins them
instead, as JAX's step.py:46-50, :288 and :338-340 take them.

With ``mixed_precision: true`` the step runs JAX's mixed form
(step.py:182-205, :247-341; ``train/precision.py``): each phase's
parameters are cast to bf16 at use and the module runs on those copies,
the batch is cast to bf16 (StyleMelGAN's noise is drawn in the mel's
type, bf16, inside the generator, or cast with the batch where the batch
holds it), and G's output and D's outputs and features go back to float32
before any loss. The G phase casts D's parameters without grad (it takes
no gradient of them); the D phase's re-run of G casts G's updated ones.
The master parameters, the optimizer state, the losses and spectral
norm's (u, v) stay float32. ``eval_step`` runs in float32, as JAX's
does.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from parallelwavegan_tpu_torch.train import precision
from parallelwavegan_tpu_torch.train.criterion import Criterion


def batch_to_device(batch: dict, device) -> dict:
    """A collated numpy batch ((B, T, C) arrays) -> float32 tensors in the
    port's (B, C, T) layout on ``device``."""
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        if v.ndim == 3:
            v = v.transpose(0, 2, 1)
        out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(device)
    return out


# the streams of one step's draws (``seeded``)
NOISE_G, NOISE_D, STARTS_ADV, STARTS_REAL, STARTS_FAKE, NOISE_EVAL, STARTS_EVAL = range(7)


def seeded(device, *keys: int) -> torch.Generator:
    """A generator on ``device`` seeded by ``keys`` alone, e.g. (seed,
    step, stream)."""
    state = np.random.SeedSequence([int(k) for k in keys]).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed(
        int(state[0]) << 32 | int(state[1]))


def vq_input(criterion: Criterion, batch: dict) -> dict:
    """The batch with the VQ-VAE encoder's input ``y_in``: the wave, or its
    PQMF analysis (B, S, T / S) by ``criterion.encoder_pqmf``."""
    y = batch["y"]
    if criterion.encoder_pqmf is not None:
        y = criterion.encoder_pqmf.analysis(y.transpose(1, 2)).transpose(1, 2)
    return dict(batch, y_in=y)


def generator_forward(config: dict, generator, batch: dict,
                      draws: tuple = (), params: dict | None = None,
                      train: bool = True):
    """The generator's output (B, out, T) for a batch (train.py:1109-1117
    feature flags: Parallel WaveGAN takes noise and the mel, MelGAN and
    HiFi-GAN the mel alone, as JAX's step.py:83-84, the discrete HiFi-GAN
    the ids; StyleMelGAN, discrete or not, the mel or ids and ``batch["z"]``
    where the batch has it, else z drawn on the batch's device from a
    generator seeded by ``draws``, e.g. (seed, step, stream); the duration
    generator (wave, log-durations); the VQ-VAE ``batch["y_in"]`` and
    the conditioning, (x_bar, z_e, z_q); the U-Net HiFi-GAN the excitation
    and the mel, its dropout masks drawn like StyleMelGAN's noise and off
    unless ``train``, see the module docstring). ``params``
    (``precision.bf16_params``) stand in for the generator's own."""
    gen_type = config["generator_type"]
    if gen_type == "ParallelWaveGANGenerator":
        return precision.call(generator, params, batch["z"], batch["c"])
    if gen_type in ("MelGANGenerator", "HiFiGANGenerator",
                    "DiscreteSymbolHiFiGANGenerator"):
        return precision.call(generator, params, batch["c"])
    if gen_type in ("StyleMelGANGenerator", "DiscreteSymbolStyleMelGANGenerator"):
        z = batch.get("z")
        noise = None if z is not None else seeded(batch["c"].device, *draws)
        return precision.call(generator, params, batch["c"], z, generator=noise)
    if gen_type == "DiscreteSymbolDurationGenerator":
        factor = math.prod(config["generator_params"].get("upsample_scales", (8, 8, 2, 2)))
        return precision.call(generator, params, batch["c"], batch["ds"],
                              batch["y"].shape[-1] // factor,
                              generator=seeded(batch["c"].device, *draws))
    if gen_type == "VQVAE":
        return precision.call(generator, params, batch["y_in"], batch.get("local"),
                              batch.get("global"))
    if gen_type == "UHiFiGANGenerator":
        return precision.call(generator, params, batch["excitation"], batch["c"],
                              generator=seeded(batch["c"].device, *draws),
                              deterministic=not train)
    raise NotImplementedError(
        f"training {gen_type} is not ported to parallelwavegan_tpu_torch yet; "
        "see ROADMAP.md")


def discriminator_forward(config: dict, discriminator, y, batch: dict, key: str,
                          draws: tuple = (), params: dict | None = None):
    """The discriminator's output for y; StyleMelGAN's windows start at
    ``batch["rwd_starts_" + key]`` where the batch has it, else are drawn
    from a CPU generator seeded by ``draws``. ``params``
    (``precision.bf16_params``) stand in for the discriminator's own."""
    if config["discriminator_type"] == "StyleMelGANDiscriminator":
        starts = batch.get(f"rwd_starts_{key}")
        if starts is not None:
            return precision.call(discriminator, params, y, starts.tolist())
        return precision.call(discriminator, params, y, generator=seeded("cpu", *draws))
    return precision.call(discriminator, params, y)


def wave_of(out) -> torch.Tensor:
    """The wave of a generator's output: the duration generator's and the
    VQ-VAE's first output, any other's output."""
    return out[0] if isinstance(out, tuple) else out


def own_loss(config: dict, criterion: Criterion, out, batch: dict, metrics: dict):
    """(the wave, the generator's own loss before the auxiliary losses): the
    duration generator's duration loss mean((ds_ - log(ds + 1))^2) over
    every position (JAX step.py:261-268), the VQ-VAE's quantization loss
    plus ``lambda_commit`` times its commitment loss (:240-260), 0 for any
    other generator."""
    gen_type = config["generator_type"]
    if gen_type == "DiscreteSymbolDurationGenerator":
        y_, ds_ = out
        loss = torch.mean((ds_ - torch.log(batch["ds"].float() + 1.0)) ** 2)
        metrics["duration_loss"] = loss
        return y_, loss
    if gen_type == "VQVAE":
        y_, z_e, z_q = out
        quantize = torch.mean((z_q - z_e.detach()) ** 2)
        commit = torch.mean((z_e - z_q.detach()) ** 2)
        metrics["quantization_loss"] = quantize
        metrics["commitment_loss"] = commit
        return y_, quantize + criterion.lambda_commit * commit
    return out, 0.0


def full_band(criterion: Criterion, y_) -> torch.Tensor:
    """The generator's output as a wave (B, 1, T): a multi-band output (B,
    S, T / S) synthesised by ``criterion.pqmf``, any other as it is."""
    if criterion.pqmf is None:
        return y_
    return criterion.pqmf.synthesis(y_.transpose(1, 2)).transpose(1, 2)


def aux_losses(criterion: Criterion, y_, y, metrics: dict):
    """(the auxiliary losses of the generator's output ``y_`` against the
    target (B, 1, T), the full-band wave of ``y_``) (JAX step.py:125-150):
    the STFT and mel losses of the full band and, with the sub-band STFT
    loss, half the STFT loss plus half the sub-band loss of the sub-bands
    against the target's analysis (the sub-band loss takes (B, T, S))."""
    y_full = full_band(criterion, y_)
    gen_loss = 0.0
    if criterion.stft is not None:
        sc_loss, mag_loss = criterion.stft(y_full[:, 0], y[:, 0])
        gen_loss = gen_loss + sc_loss + mag_loss
        metrics["spectral_convergence_loss"] = sc_loss
        metrics["log_stft_magnitude_loss"] = mag_loss
    if criterion.sub_stft is not None:
        gen_loss = gen_loss * 0.5  # the balance of upstream's train.py:242-247
        y_mb = criterion.pqmf.analysis(y.transpose(1, 2))
        sub_sc, sub_mag = criterion.sub_stft(y_.transpose(1, 2), y_mb)
        gen_loss = gen_loss + 0.5 * (sub_sc + sub_mag)
        metrics["sub_spectral_convergence_loss"] = sub_sc
        metrics["sub_log_stft_magnitude_loss"] = sub_mag
    if criterion.mel is not None:
        mel_loss = criterion.mel(y_full[:, 0], y[:, 0])
        gen_loss = gen_loss + mel_loss
        metrics["mel_loss"] = mel_loss
    return gen_loss, y_full


def adv_losses(criterion: Criterion, p_, real_features, metrics: dict):
    """The adversarial loss of D's output ``p_`` on the generated wave plus,
    with the feature-matching loss, ``lambda_feat_match`` times it against
    ``real_features()`` (D's output on the real wave)."""
    adv_loss = criterion.gen_adv(p_)
    metrics["adversarial_loss"] = adv_loss
    if criterion.feat_match is not None:
        fm_loss = criterion.feat_match(p_, real_features())
        metrics["feature_matching_loss"] = fm_loss
        adv_loss = adv_loss + criterion.lambda_feat_match * fm_loss
    return adv_loss


def _update(optimizer, params, loss) -> None:
    """One optimizer step on the gradients of ``loss`` w.r.t. ``params``."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    for p, g in zip(params, grads):
        p.grad = torch.zeros_like(p) if g is None else g
    optimizer.step()
    for p in params:
        p.grad = None


class TrainStep:
    """(batch, train_g, train_d, step) -> metrics (0-d tensors on the
    device); ``step`` (the steps done before this one) and the config's
    ``seed`` seed StyleMelGAN's draws."""

    def __init__(self, config: dict, generator, discriminator,
                 criterion: Criterion, opt_g, opt_d):
        self.config = config
        self.generator = generator
        self.discriminator = discriminator
        self.criterion = criterion
        self.opt_g = opt_g
        self.opt_d = opt_d
        self.g_params = [p for p in generator.parameters() if p.requires_grad]
        self.d_params = [p for p in discriminator.parameters() if p.requires_grad]
        self.update_prediction = config.get(
            "update_prediction_after_generator_update", True)
        self.seed = config.get("seed", 0)
        self.mixed = bool(config.get("mixed_precision", False))

    def _cast(self, module, grad: bool = True):
        """The module's bf16 parameters under mixed precision, else None
        (its own); made without grad where no gradient of them is taken."""
        if not self.mixed:
            return None
        with torch.set_grad_enabled(grad and torch.is_grad_enabled()):
            return precision.bf16_params(module)

    def __call__(self, batch: dict, train_g: bool, train_d: bool, step: int = 0) -> dict:
        crit, metrics, cfg = self.criterion, {}, self.config
        y, y_ = batch["y"], None
        if cfg["generator_type"] == "VQVAE":
            batch = vq_input(crit, batch)
        mixed = self.mixed
        batch_c = precision.to_bf16(batch) if mixed else batch

        def dis(v, key, stream, params):
            out = discriminator_forward(cfg, self.discriminator,
                                        precision.to_bf16(v) if mixed else v, batch, key,
                                        (self.seed, step, stream), params)
            return precision.to_f32(out) if mixed else out

        def gen(stream, params, train=True):
            out = generator_forward(cfg, self.generator, batch_c, (self.seed, step, stream),
                                    params, train)
            return precision.to_f32(out) if mixed else out

        if train_g:
            y_, gen_loss = own_loss(cfg, crit, gen(NOISE_G, self._cast(self.generator)),
                                    batch, metrics)
            aux_loss, y_ = aux_losses(crit, y_, y, metrics)
            gen_loss = (gen_loss + aux_loss) * crit.lambda_aux
            if train_d:
                p_d = self._cast(self.discriminator, grad=False)

                def real_features():  # detached by the loss: no graph needed
                    with torch.no_grad():  # the same windows, as JAX's rng_gd
                        return dis(y, "fm", STARTS_ADV, p_d)

                adv_loss = adv_losses(crit, dis(y_, "adv", STARTS_ADV, p_d),
                                       real_features, metrics)
                gen_loss = gen_loss + crit.lambda_adv * adv_loss
            metrics["generator_loss"] = gen_loss
            _update(self.opt_g, self.g_params, gen_loss)
            y_ = y_.detach()
        if train_d:
            if self.update_prediction or not train_g:
                with torch.no_grad():
                    y_ = full_band(crit, wave_of(
                        gen(NOISE_D, self._cast(self.generator), train=False)))
            p_d = self._cast(self.discriminator)
            p = dis(y, "real", STARTS_REAL, p_d)
            p_ = dis(y_, "fake", STARTS_FAKE, p_d)
            real_loss, fake_loss = crit.dis_adv(p_, p)
            dis_loss = real_loss + fake_loss
            _update(self.opt_d, self.d_params, dis_loss)
            metrics["real_loss"] = real_loss
            metrics["fake_loss"] = fake_loss
            metrics["discriminator_loss"] = dis_loss
        return {k: v.detach() for k, v in metrics.items()}


@torch.no_grad()
def eval_step(config: dict, generator, discriminator, criterion: Criterion,
              batch: dict, draws: tuple = (0,)) -> dict:
    """Every loss of a batch, no update (step.py:368-425); run the models in
    eval mode, so that a spectral norm's (u, v) stay. StyleMelGAN
    draws its noise and windows from generators seeded by ``draws`` (e.g.
    (seed, step, batch index)); the real and fake waves share the windows,
    as JAX's one key gives both."""
    metrics = {}
    y = batch["y"]
    if config["generator_type"] == "VQVAE":
        batch = vq_input(criterion, batch)
    y_, gen_loss = own_loss(config, criterion, generator_forward(
        config, generator, batch, (*draws, NOISE_EVAL), train=False), batch, metrics)
    aux_loss, y_ = aux_losses(criterion, y_, y, metrics)
    gen_loss = (gen_loss + aux_loss) * criterion.lambda_aux
    p_, p = (discriminator_forward(config, discriminator, v, batch, "eval",
                                   (*draws, STARTS_EVAL)) for v in (y_, y))
    adv_loss = adv_losses(criterion, p_, lambda: p, metrics)
    metrics["generator_loss"] = gen_loss + criterion.lambda_adv * adv_loss
    real_loss, fake_loss = criterion.dis_adv(p_, p)
    metrics["real_loss"] = real_loss
    metrics["fake_loss"] = fake_loss
    metrics["discriminator_loss"] = real_loss + fake_loss
    return metrics
