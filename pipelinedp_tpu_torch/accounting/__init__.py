"""Native privacy accounting (privacy loss distributions, composition)."""

from pipelinedp_tpu_torch.accounting.pld import (
    PrivacyLossDistribution,
    from_gaussian_mechanism,
    from_laplace_mechanism,
    from_privacy_parameters,
)
