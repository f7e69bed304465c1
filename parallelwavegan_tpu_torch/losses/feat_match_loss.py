"""Feature-matching loss (counterpart of
parallelwavegan_tpu/losses/feat_match_loss.py): L1 between the generated
and the real wave's discriminator features, the real ones detached; the
final outputs left out unless ``include_final_outputs``, averaged over the
layers and over the discriminators where the flags say so.
"""

from __future__ import annotations


class FeatureMatchLoss:
    def __init__(self, average_by_layers: bool = True,
                 average_by_discriminators: bool = True,
                 include_final_outputs: bool = False):
        self.average_by_layers = average_by_layers
        self.average_by_discriminators = average_by_discriminators
        self.include_final_outputs = include_final_outputs

    def __call__(self, feats_hat, feats):
        total = 0.0
        for feats_hat_d, feats_d in zip(feats_hat, feats):
            if not self.include_final_outputs:
                feats_hat_d, feats_d = feats_hat_d[:-1], feats_d[:-1]
            d_loss = 0.0
            for f_hat, f in zip(feats_hat_d, feats_d):
                d_loss = d_loss + (f_hat - f.detach()).abs().mean()
            if self.average_by_layers:
                d_loss = d_loss / len(feats_d)
            total = total + d_loss
        if self.average_by_discriminators:
            total = total / len(feats)
        return total
