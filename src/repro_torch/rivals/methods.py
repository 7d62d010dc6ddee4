"""The facade's method table: every sampler the ``method=`` axis names
(counterpart of ``repro.rivals.methods``).

``cfg_method`` is the :class:`SamplerConfig` drift family a method lowers
to (FA-LD shares DSGLD's unbiased local-gradient drift; what sets it apart
is the server-side averaging and the noise calibration, the engine's
``aggregation`` axis).
"""
from __future__ import annotations

import dataclasses
import difflib


@dataclasses.dataclass(frozen=True)
class Method:
    """One facade-level sampling method.

    name: the facade spelling (``api.FSGLD(method=name)``).
    cfg_method: the SamplerConfig drift family it lowers to.
    aggregation: the engine aggregation mode ('none' | 'fald').
    needs_surrogate: whether it carries the conducive-gradient correction
      (FSGLD only; the others drop the surrogate bank).
    paper: the reference the implementation follows.
    """
    name: str
    cfg_method: str
    aggregation: str = "none"
    needs_surrogate: bool = False
    paper: str = ""
    description: str = ""


METHODS = {
    "sgld": Method(
        name="sgld", cfg_method="sgld",
        paper="Welling & Teh 2011",
        description="centralized SGLD over the pooled data (baseline)"),
    "dsgld": Method(
        name="dsgld", cfg_method="dsgld",
        paper="Ahn et al. 2014",
        description="distributed SGLD: chains hop clients, local "
                    "unbiased gradients, no correction"),
    "fsgld": Method(
        name="fsgld", cfg_method="fsgld", needs_surrogate=True,
        paper="arXiv:2004.11231",
        description="DSGLD + conducive-gradient surrogate correction "
                    "(the source paper)"),
    "fald": Method(
        name="fald", cfg_method="dsgld", aggregation="fald",
        paper="arXiv:2112.05120",
        description="federated averaging Langevin: server-averaged "
                    "clients, noise amplified sqrt(C) per client"),
}


def method_names() -> tuple:
    """All method names, in a stable order."""
    return tuple(METHODS)


def get_method(name: str) -> Method:
    """Resolve a method name, with an actionable error on a miss."""
    try:
        return METHODS[name]
    except (KeyError, TypeError):
        near = difflib.get_close_matches(str(name), method_names(), n=1)
        hint = f" (did you mean {near[0]!r}?)" if near else ""
        raise ValueError(
            f"unknown sampling method {name!r}{hint}; available: "
            f"{', '.join(method_names())}") from None
