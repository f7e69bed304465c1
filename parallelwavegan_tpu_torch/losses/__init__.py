"""Losses of the port (counterpart of parallelwavegan_tpu/losses/): the
multi-resolution STFT loss and the adversarial losses. The mel,
feature-matching and duration losses are not ported yet (ROADMAP.md)."""

from parallelwavegan_tpu_torch.losses.adversarial_loss import (  # noqa: F401
    DiscriminatorAdversarialLoss,
    GeneratorAdversarialLoss,
)
from parallelwavegan_tpu_torch.losses.stft_loss import (  # noqa: F401
    MultiResolutionSTFTLoss,
    STFTLoss,
    log_stft_magnitude_loss,
    spectral_convergence_loss,
)
