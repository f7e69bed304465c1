"""Adversarial losses over (possibly nested) discriminator outputs
(counterpart of parallelwavegan_tpu/losses/adversarial_loss.py): mse and
hinge criteria, the last entry of a feature list taken as the output, and
the optional average over discriminators.
"""

from __future__ import annotations

import torch


def _final_outputs(outputs):
    """Discriminator outputs -> a flat list of final-layer tensors."""
    if not isinstance(outputs, (tuple, list)):
        return [outputs]
    return [o[-1] if isinstance(o, (tuple, list)) else o for o in outputs]


def _check(loss_type: str) -> None:
    if loss_type not in ("mse", "hinge"):
        raise ValueError(f"{loss_type} unsupported")


class GeneratorAdversarialLoss:
    def __init__(self, average_by_discriminators: bool = True,
                 loss_type: str = "mse"):
        _check(loss_type)
        self.average_by_discriminators = average_by_discriminators
        self.loss_type = loss_type

    def __call__(self, outputs):
        finals = _final_outputs(outputs)
        loss = 0.0
        for x in finals:
            if self.loss_type == "mse":
                loss = loss + torch.mean((x - 1.0) ** 2)
            else:
                loss = loss - torch.mean(x)
        if self.average_by_discriminators:
            loss = loss / len(finals)
        return loss


class DiscriminatorAdversarialLoss:
    def __init__(self, average_by_discriminators: bool = True,
                 loss_type: str = "mse"):
        _check(loss_type)
        self.average_by_discriminators = average_by_discriminators
        self.loss_type = loss_type

    def __call__(self, outputs_hat, outputs):
        """-> (real_loss, fake_loss)."""
        fakes, reals = _final_outputs(outputs_hat), _final_outputs(outputs)
        real_loss = fake_loss = 0.0
        for x_hat, x in zip(fakes, reals):
            if self.loss_type == "mse":
                real_loss = real_loss + torch.mean((x - 1.0) ** 2)
                fake_loss = fake_loss + torch.mean(x_hat ** 2)
            else:
                real_loss = real_loss - torch.mean(torch.clamp(x - 1.0, max=0.0))
                fake_loss = fake_loss - torch.mean(torch.clamp(-x_hat - 1.0, max=0.0))
        if self.average_by_discriminators:
            real_loss = real_loss / len(reals)
            fake_loss = fake_loss / len(fakes)
        return real_loss, fake_loss
