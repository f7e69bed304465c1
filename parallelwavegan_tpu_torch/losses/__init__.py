"""Losses of the port (counterpart of parallelwavegan_tpu/losses/): the
multi-resolution STFT loss, the adversarial losses, the mel loss and the
feature-matching loss. The duration loss is not ported yet (ROADMAP.md)."""

from parallelwavegan_tpu_torch.losses.adversarial_loss import (  # noqa: F401
    DiscriminatorAdversarialLoss,
    GeneratorAdversarialLoss,
)
from parallelwavegan_tpu_torch.losses.feat_match_loss import (  # noqa: F401
    FeatureMatchLoss,
)
from parallelwavegan_tpu_torch.losses.mel_loss import (  # noqa: F401
    MelSpectrogram,
    MelSpectrogramLoss,
)
from parallelwavegan_tpu_torch.losses.stft_loss import (  # noqa: F401
    MultiResolutionSTFTLoss,
    STFTLoss,
    log_stft_magnitude_loss,
    spectral_convergence_loss,
)
