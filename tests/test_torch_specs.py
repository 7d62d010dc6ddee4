"""Meta-device input stand-ins (``repro_torch.launch.specs``) against the
JAX package's ``ShapeDtypeStruct``s (``repro.launch.specs``): for every
architecture at its full config and every input shape, the parameter,
train / prefill batch and decode (cache, token, positions, encoder
stream) stand-ins have the reference's shapes and dtypes leaf by leaf,
and ``long_context_eligible`` agrees. Shapes only: nothing allocates."""
import jax
import numpy as np
import pytest

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jax_config
from repro.launch import specs as jspecs
from repro_torch import tree as tu
from repro_torch.configs import ARCH_NAMES, SHAPES
from repro_torch.configs import get_config as torch_config
from repro_torch.launch import specs as tspecs
import _torch_threads  # noqa: F401  (the cores each xdist worker uses)


def _same(t_tree, j_tree):
    tl = [(n, l) for n, l in tu.leaves_with_names(t_tree)]
    jl = jax.tree.leaves(j_tree)
    assert len(tl) == len(jl)
    for (name, t), j in zip(tl, jl):
        assert t.device.type == "meta", name
        assert tuple(t.shape) == tuple(j.shape), (name, t.shape, j.shape)
        assert str(t.dtype).split(".")[-1] == np.dtype(j.dtype).name, (
            name, t.dtype, j.dtype)


@pytest.mark.parametrize("arch", sorted(ARCH_NAMES))
def test_specs_match_the_references(arch):
    tcfg, jcfg = torch_config(arch), jax_config(arch)
    _same(tspecs.params_shape(tcfg), jspecs.params_shape(jcfg))
    for name in SHAPES:
        ts, js = SHAPES[name], JSHAPES[name]
        _same(tspecs.input_specs(tcfg, ts), jspecs.input_specs(jcfg, js))
        if ts.kind != "decode":
            _same(tspecs.prefill_batch_specs(tcfg, ts),
                  jspecs.prefill_batch_specs(jcfg, js))
    assert tspecs.long_context_eligible(tcfg) == \
        jspecs.long_context_eligible(jcfg)
