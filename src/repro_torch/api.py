"""One FSGLD front door in PyTorch (counterpart of ``repro.api``).

Four declarative pieces — :class:`Posterior`, :class:`SurrogateSpec`,
:class:`Schedule`, :class:`Execution` — and one verb (plus
:class:`Serving` and :meth:`FSGLD.serve` for the posterior's draws)::

    fsgld = FSGLD(posterior, data, minibatch=10, surrogate=spec,
                  schedule=Schedule(rounds=300, local_steps=100),
                  execution=Execution(device="cpu"))
    samples = fsgld.sample(torch.Generator().manual_seed(0), theta0)

Runs on CUDA unless ``Execution(device="cpu")`` asks for the CPU; with no
card and no CPU request, ``Execution()`` raises instead of carrying on on
the CPU. ``executor='auto'`` is the packed single-launch kernel executor
on CUDA and the plain ``vmap`` executor on the CPU; FSGLD with a 'linear'
or 'full' bank, which no kernel variant takes, runs on ``vmap`` under
'auto' and is refused by 'packed' and 'per_leaf'.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch import tree as tu
from repro_torch.configs.base import SamplerConfig
from repro_torch.core.engine import (MeshChainEngine, check_kernel_kind,
                                     pad_shards)
from repro_torch.core.federated import (fit_bank_fisher, local_sgld_moments,
                                        refresh_bank, sample_local_likelihood)
from repro_torch.core.health import Recovery, RunHealth
from repro_torch.core.sghmc import SGHMCConfig
from repro_torch.core.surrogate import (Gaussian, SurrogateBank,
                                        fit_scalar_tree, make_bank)
from repro_torch.fed.partition import is_client_source
from repro_torch.fed.partition import partition as partition_clients
from repro_torch.fed.partition import resolve_shard_probs
from repro_torch.fed.registry import get_scenario
from repro_torch.fed.spec import Stream
from repro_torch.kernels.ops import make_packed_layout
from repro_torch.obs.telemetry import MetricsFrame, Telemetry
from repro_torch.rivals.methods import get_method

PyTree = Any
LogLikFn = Callable[[PyTree, PyTree], torch.Tensor]

__all__ = ["Posterior", "SurrogateSpec", "Schedule", "Execution", "Serving",
           "FSGLD", "fit_bank_local_sgld", "Recovery", "RunHealth",
           "Stream", "Telemetry", "MetricsFrame"]

_EXECUTORS = ("auto", "vmap", "per_leaf", "packed")
_FIT_SEED_SALT = 0x5357
_COLLECT_SIGNALS = ("mean", "entropy", "mutual_info", "variance")


def _device(device) -> torch.device:
    """None -> 'cuda', which must be available (no quiet CPU run)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


@dataclasses.dataclass(frozen=True)
class Posterior:
    """log p(theta | x) ∝ prior * likelihood. ``log_lik(theta, batch)``
    is the minibatch log-likelihood (summed); the prior is
    N(0, prior_precision^-1 I); ``temperature`` scales the noise."""
    log_lik: LogLikFn
    prior_precision: float = 1.0
    temperature: float = 1.0


@dataclasses.dataclass(frozen=True)
class SurrogateSpec:
    """How the conducive-gradient surrogates q_s are built.

    kind: 'none' (DSGLD/SGLD), 'diag' (flat-vector params), 'scalar'
    (per-tensor isotropic, pytree params), 'linear' (control-variate
    surrogates, a bounded conducive term; ``core.fit_bank_linear``) or
    'full' (dense precision, paper-scale models;
    ``core.fit_bank_from_samples``). 'linear' and 'full' need a prefit
    ``bank`` and run on the plain 'vmap' executor. fit (when ``bank`` is
    None): 'auto' ('refresh' for diag, 'local_sgld' for scalar),
    'refresh' (gradient-matching Fisher fit at theta0), 'fisher'
    (Fisher-Laplace at theta0, diag) or 'local_sgld' (short per-client
    SGLD runs + moment fits, using fit_steps / fit_minibatch /
    fit_step_size). ``refresh_every`` re-fits the bank every that many
    rounds at the current chain mean (adaptive refresh: flat-vector
    'diag' banks only)."""
    kind: str = "diag"
    bank: Optional[SurrogateBank] = None
    fit: str = "auto"
    refresh_every: Optional[int] = None
    fit_steps: int = 200
    fit_minibatch: int = 32
    fit_step_size: Optional[float] = None

    def __post_init__(self):
        if self.kind not in ("none", "diag", "scalar", "linear", "full"):
            raise ValueError(f"unknown surrogate kind {self.kind!r}")
        if self.fit not in ("auto", "refresh", "fisher", "local_sgld"):
            raise ValueError(f"unknown surrogate fit {self.fit!r}")


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Algorithm 1's schedule: rounds x local_steps updates per chain;
    ``reassign`` 'categorical' (i.i.d. draw) or 'permutation'
    (collision-free); ``thin`` keeps every thin-th local step."""
    rounds: int
    local_steps: int = 40
    n_chains: int = 1
    reassign: str = "categorical"
    thin: int = 1

    def __post_init__(self):
        if self.reassign not in ("categorical", "permutation"):
            raise ValueError(f"unknown reassign {self.reassign!r}")


@dataclasses.dataclass(frozen=True)
class Execution:
    """Where and how the chains run.

    device: None -> 'cuda', which must be available (no quiet CPU run);
      pass 'cpu' to run on the CPU. On a mesh, this rank's device.
    mesh: a ('data', 'model') ``torch.distributed`` DeviceMesh
      (``repro_torch.launch.mesh``), every rank calling ``sample`` alike:
      the chains ride 'data' (odd counts padded; each rank's chains
      bitwise the one-device run's), the refresh's clients 'model'; each
      rank returns the gathered result. None: this one device.
    executor: 'vmap' (plain reference), 'per_leaf' (one kernel launch per
      leaf per step), 'packed' (one launch per step for the whole chain
      block) or 'auto' (packed on CUDA, vmap on the CPU, and vmap for
      FSGLD with a 'linear' or 'full' bank, which no kernel takes).
    collect: False returns final chain states instead of a trace.
    dtype: surrogate-mean STORAGE dtype (e.g. torch.bfloat16).
    bank_device: where the surrogate means are stored (None: the run's
      device). 'cpu' keeps them on the host, the server's side of the
      federation: each round brings only the chains' clients' rows to the
      device (at qwen3-1.7b's width the 4 clients' bf16 means are 16 GB).
    recovery: a :class:`Recovery` policy (``core.health``): the per-round
      chain health check; ``sample`` then returns ``(result, RunHealth)``.
      None: no health tracking (a fault-free run is bitwise the same
      either way).
    snapshot_every / snapshot_path: atomically save the run's whole carry
      every that many rounds into the directory (preemption-safe).
      resume: continue from the newest valid snapshot in
      ``snapshot_path``, bitwise the uninterrupted run.
    stream: a :class:`repro_torch.fed.Stream` — the streamed client axis:
      only ``stream.resident`` clients live on device, the next window's
      rows staged on a side stream while the current one runs. Fault-free
      streamed runs are bitwise the resident path; requires
      ``Schedule(reassign='permutation')`` and does not compose with
      snapshots / recovery / telemetry (the engine refuses loudly).
    telemetry: a :class:`repro_torch.obs.Telemetry` spec — per-round
      per-chain metric rows (grad/drift/conducive norms, noise scale,
      participation, wire bytes, health words) computed by the round
      loop; ``sample`` then additionally returns a
      :class:`repro_torch.obs.MetricsFrame`. Telemetry-off runs stay
      bitwise identical, and telemetry probes draw from a generator of
      their own, so telemetry-on runs are bitwise identical too. Does not
      compose with ``stream``."""
    device: Any = None
    executor: str = "auto"
    collect: bool = True
    dtype: Any = None
    bank_device: Any = None
    recovery: Optional[Recovery] = None
    snapshot_every: Optional[int] = None
    snapshot_path: Optional[str] = None
    resume: bool = False
    stream: Optional[Stream] = None
    telemetry: Optional[Telemetry] = None
    mesh: Any = None

    def __post_init__(self):
        _check_mesh(self.mesh)
        if self.executor not in _EXECUTORS:
            raise ValueError(f"unknown executor {self.executor!r}; pick "
                             f"from {_EXECUTORS}")
        if (self.snapshot_every or self.resume) and not self.snapshot_path:
            raise ValueError(
                "Execution.snapshot_every/resume need snapshot_path")
        object.__setattr__(self, "device", _device(self.device))


@dataclasses.dataclass(frozen=True)
class Serving:
    """How the posterior is SERVED: K draws as one Bayesian ensemble.

    :meth:`FSGLD.serve` turns this spec plus a draw source into a
    :class:`repro_torch.serve.EnsembleServer`: one shared prefill per
    request, a per-token decode fan-out over the ``draws`` axis, the next
    token from the predictive mean. ``draws=1`` gives the plain
    single-draw path's tokens and logits, bitwise.

    arch / smoke: which transformer config the draws parameterize
    (``repro_torch.configs``). batch / prompt_len / gen: the request shape
    launchers default to. collect: which per-token uncertainty signals
    launchers report, a subset of ('mean', 'entropy', 'mutual_info',
    'variance') (all are computed). device: None -> 'cuda', which must be
    available; pass 'cpu' to serve on the CPU (on a mesh, this rank's
    device). mesh: a ``launch.mesh`` DeviceMesh: the K draws ride its
    'data' axis when K divides it (replicated otherwise), and each decode
    step gathers the per-draw logits before they are combined, so every
    rank serves the one-device tokens and statistics.
    """
    draws: int = 1
    arch: str = "qwen3-1.7b"
    smoke: bool = True
    batch: int = 4
    prompt_len: int = 32
    gen: int = 16
    mesh: Any = None
    collect: tuple = _COLLECT_SIGNALS
    device: Any = None

    def __post_init__(self):
        if self.draws < 1:
            raise ValueError(f"draws must be >= 1, got {self.draws}")
        bad = [c for c in self.collect if c not in _COLLECT_SIGNALS]
        if bad:
            raise ValueError(f"unknown collect signals {bad}; pick from "
                             f"{_COLLECT_SIGNALS}")
        _check_mesh(self.mesh)
        object.__setattr__(self, "device", _device(self.device))


def _check_mesh(mesh) -> None:
    """A mesh must be a DeviceMesh with a 'data' axis (None: one
    device)."""
    if mesh is not None and "data" not in (
            getattr(mesh, "mesh_dim_names", None) or ()):
        raise ValueError("mesh must be a torch.distributed DeviceMesh with "
                         "a 'data' axis (repro_torch.launch.mesh)")


def _to(tree: PyTree, device) -> PyTree:
    return tu.tree_map(lambda t: torch.as_tensor(t).to(device), tree)


class FSGLD:
    """The sampler: one constructor, one ``sample``.

    data: client shards — a pytree with stacked (S, n, ...) leaves or a
    list of per-client pytrees (ragged clients are NaN-padded by
    ``pad_shards``; minibatches never touch the pad). ``method`` comes
    from the ``repro_torch.rivals`` table: 'fsgld' (needs a surrogate kind
    other than 'none'), 'dsgld', 'sgld' or 'fald' (FA-LD: DSGLD clients
    server-averaged at every communication round, each client's noise
    amplified sqrt(C); Langevin only). ``kernel``: 'sgld' (Langevin) or
    'sghmc' (federated SGHMC with the same estimator stack, ``friction``
    its alpha_f); both run on every executor.

    ``federation``: a ``repro_torch.fed.Federation`` or a registry name.
    With a partition spec ``data`` is POOLED (N, ...) data, which the
    partitioner splits onto clients; the schedule and compression apply
    to the rounds (the identity scenario is the run without one,
    bitwise).

    ``data`` may also be a lazy client source
    (``repro_torch.fed.SyntheticClientSource``, ``PartitionedSource``):
    the engine then materialises only the clients a run touches (every
    client for a resident run, each window's under ``stream``). It
    carries its own sizes, takes no partition spec and no surrogate fit
    (pass a prefit bank or a surrogate-free method). ``shard_probs``: the
    per-client selection probabilities f_s, or a preset name
    ('uniform', 'size-proportional', 'sqrt-size';
    ``fed.resolve_shard_probs``) normalised against the true sizes.
    """

    def __init__(self, posterior: Posterior, data: PyTree, *,
                 minibatch: int, step_size: float = 1e-4,
                 method: str = "fsgld", kernel: str = "sgld",
                 alpha: float = 1.0, friction: float = 0.1,
                 surrogate: Optional[SurrogateSpec] = None,
                 schedule: Optional[Schedule] = None,
                 execution: Optional[Execution] = None,
                 shard_probs: Optional[tuple] = None,
                 sizes: Optional[tuple] = None,
                 federation: Any = None):
        meth = get_method(method)
        if kernel not in ("sgld", "sghmc"):
            raise ValueError(f"unknown kernel {kernel!r}; pick 'sgld' or "
                             "'sghmc'")
        if meth.aggregation == "fald" and kernel == "sghmc":
            raise ValueError(
                "method='fald' is a Langevin algorithm (FA-LD averages "
                "overdamped clients); it does not compose with "
                "kernel='sghmc'")
        self.method = meth
        self.kernel = kernel
        self.friction = friction
        self.posterior = posterior
        self.federation = (get_scenario(federation)
                           if federation is not None else None)
        self.surrogate = surrogate if surrogate is not None \
            else (SurrogateSpec() if meth.needs_surrogate
                  else SurrogateSpec(kind="none"))
        if meth.needs_surrogate and self.surrogate.kind == "none":
            raise ValueError("method='fsgld' needs a surrogate kind other "
                             "than 'none' (that's DSGLD)")
        self.schedule = schedule if schedule is not None \
            else Schedule(rounds=100)
        self.execution = execution if execution is not None else Execution()
        dev = self.execution.device
        if is_client_source(data):
            if self.federation is not None and \
                    self.federation.partition is not None:
                raise ValueError(
                    "a ClientSource is already partitioned per client; "
                    "it does not compose with a Federation partition "
                    "spec (wrap the pooled data in PartitionedSource "
                    "instead)")
            if sizes is not None:
                raise ValueError("a ClientSource carries its own sizes")
            self.data = data
            num_shards = int(data.num_clients)
        else:
            if self.federation is not None and \
                    self.federation.partition is not None:
                # the partition's own seed drives the split: changing the
                # scenario never perturbs the sampling stream
                data, sizes = partition_clients(
                    None, data, self.federation.partition, dev)
            elif isinstance(data, (list, tuple)):
                data, inferred = pad_shards([_to(d, dev) for d in data])
                sizes = sizes if sizes is not None else inferred
            self.data = _to(data, dev)
            num_shards = tu.leaves(self.data)[0].shape[0]
        self.sizes = sizes
        if isinstance(shard_probs, str):
            # a partition-aware preset, resolved against the true client
            # sizes through the host-tier (cross-silo) reductions
            if is_client_source(self.data):
                true_sizes = np.asarray(self.data.sizes)
            elif sizes is not None:
                true_sizes = np.asarray(sizes)
            else:
                true_sizes = np.full((num_shards,),
                                     tu.leaves(self.data)[0].shape[1])
            shard_probs = tuple(float(p) for p in resolve_shard_probs(
                shard_probs, true_sizes))
        self.cfg = SamplerConfig(
            method=meth.cfg_method, step_size=step_size,
            num_shards=num_shards,
            shard_probs=shard_probs, local_updates=self.schedule.local_steps,
            alpha=alpha,
            surrogate=(self.surrogate.kind
                       if self.surrogate.kind != "none" else "diag"),
            prior_precision=posterior.prior_precision,
            temperature=posterior.temperature)
        self.minibatch = minibatch
        bank = self.surrogate.bank
        self.bank = None if bank is None else self._install(bank)
        self._engine = None
        self._resolve_executor()  # refuse a kernel executor now, not later

    def _install(self, bank: SurrogateBank) -> SurrogateBank:
        bank = bank.to(self.execution.device,
                       means_device=self.execution.bank_device)
        return bank if self.execution.dtype is None \
            else bank.astype(self.execution.dtype)

    # -- surrogate fitting (phase 1: computed once, communicated once) ----

    def fit(self, generator: torch.Generator, theta0: PyTree
            ) -> SurrogateBank:
        """Fit the surrogate bank per the spec and install it. The
        generator feeds only the stochastic fit ('local_sgld')."""
        spec = self.surrogate
        if spec.kind == "none":
            raise ValueError("surrogate kind 'none': nothing to fit")
        if spec.kind in ("linear", "full"):
            raise ValueError(
                f"surrogate kind {spec.kind!r} has no fit here: pass a "
                "prefit bank (core.fit_bank_linear / "
                "core.fit_bank_from_samples)")
        if is_client_source(self.data):
            raise ValueError(
                "surrogate fitting needs materialized (S, n, ...) shard "
                "data; with a ClientSource pass a prefit bank "
                "(SurrogateSpec(bank=...)) or a surrogate-free method "
                "('dsgld')")
        theta0 = _to(theta0, self.execution.device)
        fit = spec.fit
        if fit == "auto":
            fit = "local_sgld" if spec.kind == "scalar" else "refresh"
        if fit == "refresh":
            bank = refresh_bank(self.posterior.log_lik, self.data, theta0)
        elif fit == "fisher":
            S = self.cfg.num_shards
            means = torch.broadcast_to(theta0, (S,) + theta0.shape)
            bank = fit_bank_fisher(self.posterior.log_lik, self.data,
                                   means.clone())
        else:
            bank = fit_bank_local_sgld(
                self.posterior.log_lik, self.data, theta0, generator,
                fit_steps=spec.fit_steps, minibatch=spec.fit_minibatch,
                step_size=(spec.fit_step_size if spec.fit_step_size
                           is not None else self.cfg.step_size),
                kind=spec.kind, store_dtype=self.execution.dtype,
                store_device=self.execution.bank_device)
        self.bank = self._install(bank)
        self._engine = None
        return self.bank

    # -- engine resolution -------------------------------------------------

    def _resolve_executor(self) -> tuple[bool, Optional[bool]]:
        """executor name -> (use_kernel, packed) engine knobs. FSGLD with
        a 'linear' or 'full' bank resolves 'auto' to 'vmap' (no kernel
        variant takes them, in this port or the reference) and refuses
        the kernel executors."""
        ex = self.execution.executor
        kind = None
        if self.cfg.method == "fsgld":
            kind = self.bank.kind if self.bank is not None \
                else self.surrogate.kind
        plain_only = kind in ("linear", "full")
        if ex == "auto":
            if self.execution.device.type == "cuda" and not plain_only:
                return True, None  # packed; per-leaf for non-float leaves
            ex = "vmap"
        if ex == "vmap":
            return False, None
        if plain_only:
            check_kernel_kind(kind)
        if ex == "per_leaf":
            return True, False
        return True, True

    @property
    def engine(self) -> MeshChainEngine:
        if self._engine is None:
            use_kernel, packed = self._resolve_executor()
            self._engine = MeshChainEngine(
                self.posterior.log_lik, self.cfg, self.data, self.minibatch,
                bank=self.bank if self.cfg.method == "fsgld" else None,
                use_kernel=use_kernel, sizes=self.sizes, packed=packed,
                dynamics="sghmc" if self.kernel == "sghmc" else "langevin",
                sghmc=(SGHMCConfig(friction=self.friction,
                                   temperature=self.posterior.temperature)
                       if self.kernel == "sghmc" else None),
                aggregation=self.method.aggregation,
                device=self.execution.device, mesh=self.execution.mesh)
        return self._engine

    # -- phase 2: sampling -------------------------------------------------

    def sample(self, generator: torch.Generator, theta0: PyTree, *,
               rounds: Optional[int] = None,
               n_chains: Optional[int] = None, federation: Any = None,
               stream: Optional[Stream] = None,
               telemetry: Optional[Telemetry] = None):
        """Run the schedule; returns samples with leading axes
        (n_chains, rounds * ceil(local_steps / thin), ...), or the final
        chain states when ``Execution.collect`` is False ((theta,
        momentum) pairs for SGHMC); ``(result, RunHealth)`` under
        ``Execution.recovery``. ``theta0`` may lie on the host: the
        engine copies it into its state on the run's device and never
        writes it. ``generator`` (on the run's device)
        drives sampling; a surrogate fit still needed draws from a
        generator seeded from it, so a prefit-bank run consumes exactly
        the same stream.

        ``federation`` (a Federation or a registry name) overrides the
        constructor's scenario for this run. Only its schedule and
        compression may change: the data was split at construction, so
        an override with another partition is refused.

        ``stream`` (a ``fed.Stream``) overrides ``Execution.stream`` for
        this run (only ``resident`` clients on device, the next window
        staged while the current one runs, bitwise the resident path).
        ``telemetry`` (an ``obs.Telemetry``) overrides
        ``Execution.telemetry`` for this run; the return value then gains
        a trailing ``obs.MetricsFrame`` of per-round per-chain metric
        rows."""
        if self.cfg.method == "fsgld" and self.bank is None:
            fit_gen = torch.Generator(device=generator.device)
            fit_gen.manual_seed(generator.initial_seed() ^ _FIT_SEED_SALT)
            self.fit(fit_gen, theta0)
        fed = self.federation
        if federation is not None:
            fed = get_scenario(federation)
            base = (self.federation.partition
                    if self.federation is not None else None)
            if fed.partition is not None and fed.partition != base:
                raise ValueError(
                    "sample(federation=...) cannot re-partition: the data "
                    "was split at construction; pass the partition "
                    "scenario to the FSGLD constructor instead")
        sched, exe = self.schedule, self.execution
        return self.engine.run(
            generator, tu.tree_map(torch.as_tensor, theta0),
            rounds if rounds is not None else sched.rounds,
            n_chains=n_chains if n_chains is not None else sched.n_chains,
            reassign=sched.reassign, collect_every=sched.thin,
            refresh_every=self.surrogate.refresh_every,
            collect=exe.collect, federation=fed, recovery=exe.recovery,
            snapshot_every=exe.snapshot_every,
            snapshot_path=exe.snapshot_path, resume=exe.resume,
            stream=stream if stream is not None else exe.stream,
            telemetry=(telemetry if telemetry is not None
                       else exe.telemetry))

    # -- phase 3: serving the posterior ------------------------------------

    @staticmethod
    def serve(spec: Serving, *, bank: Optional[str] = None,
              draws: Any = None, seed: int = 0):
        """Stand up an ensemble server for this posterior (phase 3) on
        ``spec.device``. One draw source: ``bank=`` a draw-bank directory
        written by ``repro_torch.launch.train --draw-bank`` (or by the
        JAX package's; a legacy single-checkpoint dir serves as one
        draw), whose freshest ``spec.draws`` are served and which
        ``refresh()`` keeps tracking; ``draws=`` an already-stacked
        (K, ...) parameter tree (from :meth:`load_bank`, say); or neither
        — ``spec.draws`` fresh inits from ``seed`` (shape smoke, no
        posterior)."""
        from repro_torch.configs import get_config, get_smoke_config
        from repro_torch.serve import EnsembleServer
        cfg = (get_smoke_config(spec.arch) if spec.smoke
               else get_config(spec.arch))
        n = None if (bank is None and draws is not None) else spec.draws
        return EnsembleServer(cfg, bank=bank, draws=draws, n_draws=n,
                              seed=seed, device=spec.device, mesh=spec.mesh)

    @staticmethod
    def load_bank(path: str, like: PyTree, *, k: Optional[int] = None,
                  expect_arch: Optional[str] = None):
        """The freshest ``k`` draws of a draw bank as one stacked (K, ...)
        tree on the host, plus their ``checkpoint.DrawMeta`` provenance.
        Every draw is fingerprint-checked against ``like`` (meta tensors
        do; and against ``expect_arch`` when given): a mismatched bank is
        refused with a ValueError, never a shape error."""
        from repro_torch import checkpoint
        return checkpoint.load_bank(path, like, k=k, expect_arch=expect_arch)


# ---------------------------------------------------------------------------
# per-client local-SGLD surrogate fitting (paper Sec 3.1 phase 1)
# ---------------------------------------------------------------------------

# The traces of every client's kept steps, above which the fit streams
# one client at a time.
FIT_TRACE_BYTES = 1 << 30


def fit_bank_local_sgld(log_lik_fn: LogLikFn, shard_data: PyTree,
                        theta0: PyTree, generator: torch.Generator, *,
                        fit_steps: int, minibatch: int, step_size: float,
                        kind: str = "scalar", lam_floor: float = 1e-8,
                        store_dtype=None, store_device=None) -> SurrogateBank:
    """Short SGLD runs per client against the LOCAL likelihood, then
    moment fits over the second half of each trace (steps fit_steps // 2
    on): per-tensor isotropic ('scalar', the reference's
    ``fit_scalar_tree``) or per-dimension ('diag', flat-vector params).
    Means are stored at ``store_dtype`` (default: theta0's dtype) on
    ``store_device`` (default: theta0's); the global product is computed
    in fp32 from the fp32 means before that cast, as the reference
    computes it before ``astype``.

    Where the kept traces of all S clients fit in ``FIT_TRACE_BYTES``,
    all clients run at once (``sample_local_likelihood``, batched over S:
    per step the (S, minibatch) rows, then each leaf's normals) and the
    traces are kept, so small models make one launch per step, not S.
    Above it, one client at a time (``core.federated.local_sgld_moments``),
    keeping running moments, not traces. The generator's draws: client 0's
    ``fit_steps`` steps (each its minibatch rows, then its normals leaf by
    leaf), then client 1's, and so on. Each client's fp32 means are
    written straight into one stack (pinned when it is on the host and
    theta0 lies on a card), laid out as the packed executor's (S,
    rows_total, 128) buffer whose views are the bank's (S, ...) means, so
    packing the bank copies nothing; the global product is accumulated
    client by client."""
    if kind not in ("scalar", "diag"):
        raise ValueError(kind)
    if kind == "diag" and (len(tu.leaves(theta0)) != 1
                           or tu.leaves(theta0)[0].ndim != 1):
        raise ValueError("diag fits need flat-vector parameters")
    S = tu.leaves(shard_data)[0].shape[0]
    dev = tu.leaves(theta0)[0].device
    sdev = torch.device(store_device) if store_device is not None else dev
    trace_bytes = S * (fit_steps - fit_steps // 2) * sum(
        t.numel() * t.element_size() for t in tu.leaves(theta0))
    if trace_bytes <= FIT_TRACE_BYTES:
        bank = _fit_from_traces(
            log_lik_fn, shard_data, theta0, generator, fit_steps=fit_steps,
            minibatch=minibatch, step_size=step_size, kind=kind,
            lam_floor=lam_floor)
        bank = bank if store_dtype is None else bank.astype(store_dtype)
        return bank.to(dev, means_device=sdev)
    layout = make_packed_layout(theta0)
    stack = torch.zeros(S * layout.rows_total, 128, device=sdev,
                        dtype=store_dtype or tu.leaves(theta0)[0].dtype,
                        pin_memory=sdev.type == "cpu" and dev.type == "cuda")
    means = layout.views(stack)
    precs, nat, prec_g = [], None, None
    for s in range(S):
        mu, lam = local_sgld_moments(
            log_lik_fn, tu.tree_map(lambda d: d[s], shard_data), theta0,
            generator, minibatch=minibatch, step_size=step_size,
            num_steps=fit_steps, burn_in=fit_steps // 2,
            kind=kind).finish(jitter=lam_floor)
        # cast where the mean lies, then copy (to the host, say)
        tu.tree_map(lambda dst, m: dst[s].copy_(m.to(dst.dtype)), means, mu)
        if nat is None:
            nat = tu.tree_map(lambda m, lm: lm * m, mu, lam)
            prec_g = lam
        else:
            tu.tree_map(lambda acc, m, lm: acc.add_(lm * m), nat, mu, lam)
            prec_g = tu.tree_map(torch.add, prec_g, lam)
        precs.append(lam)
        del mu
    mean_g = tu.tree_map(
        lambda a, lg: (a / torch.clamp(lg, min=1e-12)).to(
            store_dtype or a.dtype).to(sdev), nat, prec_g)
    precs = tu.tree_map(lambda *ls: torch.stack(ls), *precs)
    return SurrogateBank(means, precs, Gaussian(mean_g, prec_g, kind), kind)


def _fit_from_traces(log_lik_fn, shard_data, theta0, generator, *,
                     fit_steps, minibatch, step_size, kind, lam_floor):
    """All clients at once, traces kept: the fp32 bank."""
    traces = sample_local_likelihood(
        log_lik_fn, shard_data, theta0, generator, minibatch=minibatch,
        step_size=step_size, num_steps=fit_steps, burn_in=fit_steps // 2,
        thin=1)
    if kind == "diag":
        flat = tu.leaves(traces)[0]
        return make_bank(flat.mean(1), 1.0 / (flat.var(1, unbiased=False)
                                              + lam_floor), "diag")
    fits = [fit_scalar_tree(tu.tree_map(lambda t: t[s], traces),
                            jitter=lam_floor)
            for s in range(tu.leaves(traces)[0].shape[0])]
    stack = lambda *xs: torch.stack(xs)  # noqa: E731
    return make_bank(tu.tree_map(stack, *[m for m, _ in fits]),
                     tu.tree_map(stack, *[p for _, p in fits]), "scalar")
