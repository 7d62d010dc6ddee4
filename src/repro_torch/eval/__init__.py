"""Posterior-quality evaluation: calibration of the served ensemble."""
from repro_torch.eval.calibration import (  # noqa: F401
    ece_binary,
    ece_from_probs,
    interval_coverage,
    nll_categorical,
    nll_gaussian_mixture,
)
