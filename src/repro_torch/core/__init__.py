"""Conducive gradients + FSGLD in PyTorch."""
from repro_torch.core.conducive import (  # noqa: F401
    conducive_gradient,
    conducive_gradient_from_bank,
)
from repro_torch.core.diagnostics import ess, rhat, summarize  # noqa: F401
from repro_torch.core.engine import (  # noqa: F401
    MeshChainEngine,
    RoundDraws,
    draw_round,
    make_chain_round_fn,
    make_packed_round_fn,
    make_round_fn,
    pack_bank,
    pad_shards,
)
from repro_torch.core.federated import (  # noqa: F401
    FederatedSampler,
    fit_bank_fisher,
    fit_bank_from_samples,
    fit_bank_linear,
    refresh_bank,
    sample_local_likelihood,
)
from repro_torch.core.sampler import (  # noqa: F401
    ShardScheme,
    chain_scales,
    kernel_step_operands,
    langevin_update,
    make_drift_fn,
    make_step_fn,
    prior_grad,
)
from repro_torch.core.surrogate import (  # noqa: F401
    Gaussian,
    SurrogateBank,
    analytic_gaussian_likelihood_surrogate,
    fit_gaussian,
    fit_scalar_tree,
    make_bank,
)
