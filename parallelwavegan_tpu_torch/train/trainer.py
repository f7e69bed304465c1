"""Steps-driven GAN trainer (counterpart of
parallelwavegan_tpu/train/trainer.py:37-385).

A host loop around ``TrainStep``: the phase of each step from
``generator_train_start_steps`` / ``discriminator_train_start_steps``
(:191-198), metrics averaged over ``log_interval_steps`` and logged
through ``logging`` (and to TensorBoard when ``tensorboardX`` or
``torch.utils.tensorboard`` imports), an eval pass over the dev set every
``eval_interval_steps`` with WAV dumps of the first batch (plots only when
matplotlib imports), a checkpoint every ``save_interval_steps`` and one
when the loop ends, however it ends.

SIGTERM sets a flag that the loop reads after each step and, unlike the
JAX trainer (:146, ADVICE r5), also before the eval and save hooks, so a
preempted run goes straight to the final checkpoint.

Random draws (StyleMelGAN's noise and windows) are seeded by the config's
``seed`` and the step count: the train step by its step, each dev batch
by (step, its index), the dumps by the step, so every dev batch sees fresh
noise and windows (JAX :275-278) and a resumed run repeats the draws.
"""

from __future__ import annotations

import itertools
import logging
import os
import signal
import time
from collections import defaultdict

import numpy as np
import torch

from parallelwavegan_tpu_torch.train.step import (
    NOISE_EVAL,
    TrainStep,
    batch_to_device,
    eval_step,
    full_band,
    generator_forward,
    vq_input,
    wave_of,
)
from parallelwavegan_tpu_torch.utils.checkpoint import (
    load_training_checkpoint,
    save_training_checkpoint,
)
from parallelwavegan_tpu_torch.utils.io import write_wav


def _summary_writer(outdir: str):
    """A TensorBoard writer where one of the two packages imports, else None."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return None
    return SummaryWriter(outdir)


class Trainer:
    """Config-driven training loop of one generator and discriminator."""

    def __init__(self, config: dict, generator, discriminator, criterion,
                 opt_g, opt_d, train_loader, dev_loader=None,
                 outdir: str = "exp", device="cuda", writer=None):
        self.config = config
        self.generator = generator
        self.discriminator = discriminator
        self.criterion = criterion
        self.opt_g = opt_g
        self.opt_d = opt_d
        self.train_loader = train_loader
        self.dev_loader = dev_loader
        self.outdir = outdir
        self.device = torch.device(device)
        self.step_fn = TrainStep(config, generator, discriminator, criterion,
                                 opt_g, opt_d)
        # writer=False turns TensorBoard off
        self.writer = writer if writer is not None else _summary_writer(outdir)
        self.steps = 0
        self.epochs = 0
        self.finish_train = False
        self.preempted = False
        # (steps, {name: mean}) of every log interval, train/ and eval/
        self.history: list = []
        self._pending: list = []
        self._last_log_time = time.time()

    # ------------------------------------------------------------------
    def run(self) -> None:
        """Train until ``train_max_steps`` or SIGTERM; the last checkpoint
        is written in any case."""

        def _term(signum, frame):
            self.preempted = True

        try:
            prev_term = signal.signal(signal.SIGTERM, _term)
        except ValueError:  # not the main thread
            prev_term = None
        try:
            for batch in self.train_loader:
                self._train_step(batch)
                self._check_log_interval()
                if not self.preempted:
                    self._check_eval_interval()
                if not self.preempted:
                    self._check_save_interval()
                if self.finish_train:
                    break
                if self.preempted:
                    logging.info("SIGTERM received: stopping at step %d "
                                 "(checkpoint follows).", self.steps)
                    break
        finally:
            if prev_term is not None:
                signal.signal(signal.SIGTERM, prev_term)
            self.save_checkpoint(
                os.path.join(self.outdir, f"checkpoint-{self.steps}steps.pkl"))
            if self.writer:
                self.writer.flush()
        logging.info("Finished training (%d steps).", self.steps)

    def _phase_flags(self) -> tuple[bool, bool]:
        train_g = self.steps > self.config.get("generator_train_start_steps", 0)
        train_d = self.steps > self.config.get("discriminator_train_start_steps", 0)
        if not train_g and not train_d:
            # nothing trains this step upstream either; run G so the step
            # counter and the data stream advance as in the JAX package
            return True, False
        return train_g, train_d

    def _train_step(self, batch) -> None:
        train_g, train_d = self._phase_flags()
        batch = batch_to_device(batch, self.device)
        self._pending.append(self.step_fn(batch, train_g, train_d, self.steps))
        self.steps += 1
        if self.steps >= self.config["train_max_steps"]:
            self.finish_train = True

    def _log(self, prefix: str, totals: dict, n: int) -> dict:
        means = {}
        for key in sorted(totals):
            means[f"{prefix}/{key}"] = totals[key] / max(n, 1)
            logging.info("(Steps: %d) %s/%s = %.4f.", self.steps, prefix, key,
                         means[f"{prefix}/{key}"])
            if self.writer:
                self.writer.add_scalar(f"{prefix}/{key}", means[f"{prefix}/{key}"],
                                       self.steps)
        self.history.append((self.steps, means))
        return means

    # ------------------------------------------------------------------
    def _check_log_interval(self) -> None:
        interval = self.config.get("log_interval_steps", 100)
        if self.steps % interval != 0 or self.steps == 0:
            return
        totals = defaultdict(float)
        for m in self._pending:  # one device-to-host copy per interval
            for k, v in m.items():
                totals[k] += float(v)
        self._pending = []
        self._log("train", totals, interval)
        elapsed = time.time() - self._last_log_time
        self._last_log_time = time.time()
        logging.info("(Steps: %d) train/steps_per_sec = %.3f.", self.steps,
                     interval / max(elapsed, 1e-9))

    def _check_eval_interval(self) -> None:
        interval = self.config.get("eval_interval_steps", 1000)
        if self.steps % interval != 0 or self.steps == 0 or self.dev_loader is None:
            return
        limit = self.dev_loader.min_batches_across_shards
        if limit == 0:
            logging.warning("(Steps: %d) dev set too small for one batch; "
                            "evaluation is skipped.", self.steps)
            return
        logging.info("(Steps: %d) Start evaluation.", self.steps)
        self.generator.eval()
        self.discriminator.eval()
        totals, first = defaultdict(float), None
        seed = self.config.get("seed", 0)
        for i, batch in enumerate(itertools.islice(self.dev_loader.epoch_batches(0),
                                                   limit)):
            first = first or batch
            m = eval_step(self.config, self.generator, self.discriminator,
                          self.criterion, batch_to_device(batch, self.device),
                          (seed, self.steps, i))
            for k, v in m.items():
                totals[k] += float(v)
        self._log("eval", totals, limit)
        self._save_intermediate_result(first)
        self.generator.train()
        self.discriminator.train()
        logging.info("(Steps: %d) Finished evaluation (%d batches).", self.steps, limit)

    @torch.no_grad()
    def _save_intermediate_result(self, batch) -> None:
        """WAVs (and, where matplotlib imports, plots) of a few dev items;
        a multi-band generator's sub-bands synthesised first (JAX :328-329)."""
        n = self.config.get("num_save_intermediate_results", 4)
        dirname = os.path.join(self.outdir, "predictions", f"{self.steps}steps")
        os.makedirs(dirname, exist_ok=True)
        small = batch_to_device({k: v[:n] for k, v in batch.items()}, self.device)
        if self.config["generator_type"] == "VQVAE":
            small = vq_input(self.criterion, small)
        draws = (self.config.get("seed", 0), self.steps, NOISE_EVAL)
        y_ = full_band(self.criterion, wave_of(generator_forward(
            self.config, self.generator, small, draws, train=False))).cpu().numpy()
        y = small["y"].cpu().numpy()
        fs = self.config["sampling_rate"]
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            plt = None
        for idx in range(y_.shape[0]):
            ref, gen = y[idx, 0], y_[idx, 0]
            write_wav(os.path.join(dirname, f"{idx}_ref.wav"), fs, ref)
            write_wav(os.path.join(dirname, f"{idx}_gen.wav"), fs, gen)
            if plt is not None:
                fig = plt.figure(figsize=(6, 4))
                for i, (sig, title) in enumerate(
                        [(ref, "groundtruth speech"), (gen, "generated speech")], 1):
                    ax = fig.add_subplot(2, 1, i)
                    ax.plot(sig)
                    ax.set_title(f"{title} @ {self.steps} steps")
                fig.tight_layout()
                fig.savefig(os.path.join(dirname, f"{idx}.png"))
                plt.close(fig)

    def _check_save_interval(self) -> None:
        interval = self.config.get("save_interval_steps", 10000)
        if self.steps % interval != 0 or self.steps == 0:
            return
        self.save_checkpoint(
            os.path.join(self.outdir, f"checkpoint-{self.steps}steps.pkl"))
        logging.info("Saved checkpoint @ %d steps.", self.steps)

    # ------------------------------------------------------------------
    def save_checkpoint(self, path: str) -> None:
        save_training_checkpoint(path, self.generator, self.discriminator,
                                 self.opt_g, self.opt_d, self.steps, self.epochs)

    def load_checkpoint(self, path: str, load_only_params: bool = False) -> None:
        self.steps, self.epochs = load_training_checkpoint(
            path, self.generator, self.discriminator, self.opt_g, self.opt_d,
            load_only_params)


def seed_everything(seed: int) -> None:
    """numpy's and torch's global generators, for the model init."""
    np.random.seed(seed)
    torch.manual_seed(seed)
