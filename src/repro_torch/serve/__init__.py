"""Ensemble posterior serving (Bayesian model averaging over K draws)."""
from repro_torch.serve.ensemble import (  # noqa: F401
    StepStats,
    ensemble_prefill,
    predictive_stats,
)
from repro_torch.serve.server import EnsembleServer, ServeResult  # noqa: F401
