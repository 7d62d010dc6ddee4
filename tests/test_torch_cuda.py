"""The CUDA kernel on the card: held against its plain PyTorch version,
launched once per step by the packed executor, and refusing operands it
cannot take. Needs a CUDA card and nvcc; elsewhere every test here skips
(the decision is made in a fixture, at run time). Run on the card with

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance 1e-5 absolute + relative: the kernel and the plain version
evaluate the same float32 expressions, but nvcc contracts multiply-adds
into FMAs and CUDA's logf/cosf may differ from torch's in the last ulp.
"""
import pytest
import torch

from repro_torch import api
from repro_torch import tree as tu
from repro_torch.kernels import fsgld_update as fk
from repro_torch.kernels import ops as kops
from repro_torch.workloads import mlp_log_lik, mlp_problem

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _operands(dev, rows, shared, variant, dynamics, L, C):
    g = torch.Generator(device=dev).manual_seed(0)
    rn = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
    ops = {}
    if variant != "plain":
        ops.update(mu_g=rn(shared, 128), mu_s=rn(rows, 128))
    if variant == "diag":
        ops.update(lam_g=rn(shared, 128).abs(), lam_s=rn(rows, 128).abs())
    if dynamics == "sghmc":
        ops["r2d"] = rn(rows, 128)
    seeds = torch.randint(0, 2**31 - 1, (C, L), generator=g, device=dev)
    return rn(rows, 128), rn(rows, 128), seeds, rn(C, L, 9).abs() * 0.1, ops


def _pair(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.parametrize("variant", fk.VARIANTS)
@pytest.mark.parametrize("dynamics", fk.DYNAMICS)
def test_kernel_matches_plain_version(dev, variant, dynamics):
    layout = kops.make_packed_layout({"a": torch.zeros(1500),
                                      "b": torch.zeros(7, 11),
                                      "c": torch.zeros(3)})
    C = 3
    th, g, seeds, sc, ops = _operands(dev, C * layout.rows_total,
                                      layout.rows_total, variant, dynamics,
                                      layout.num_leaves, C)
    sl, sb = layout.tables(dev)
    kw = dict(variant=variant, dynamics=dynamics, seg_leaf=sl, seg_base=sb,
              chains=C, block_rows=layout.block_rows, **ops)
    fk.reset_launches()
    out = fk.fsgld_update_packed(th, g, seeds, sc, **kw)
    ref = fk.fsgld_update_packed_plain(th, g, seeds, sc, **kw)
    assert fk.LAUNCHES["fsgld_update_packed"] == 1
    for a, b in zip(_pair(out), _pair(ref)):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)

    rows_c = 512
    th, g, seeds, sc, ops = _operands(dev, C * rows_c, rows_c, variant,
                                      dynamics, 1, C)
    kw = dict(variant=variant, dynamics=dynamics, chains=C, **ops)
    out = fk.fsgld_update_2d(th, g, seeds[:, 0], sc[:, 0], **kw)
    ref = fk.fsgld_update_2d_plain(th, g, seeds[:, 0], sc[:, 0], **kw)
    assert fk.LAUNCHES["fsgld_update_2d"] == 1
    for a, b in zip(_pair(out), _pair(ref)):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_kernel_refuses_misaligned_and_cpu_operands(dev):
    x = torch.zeros(16 * 128 + 1, device=dev)[1:].reshape(16, 128)
    seeds = torch.zeros(2, dtype=torch.int64, device=dev)
    sc = torch.zeros(2, 9, device=dev)
    with pytest.raises(ValueError, match="aligned"):
        fk.fsgld_update_2d(x, x, seeds, sc, chains=2)
    y = torch.zeros(16, 128, device=dev)
    with pytest.raises(ValueError, match="g2d is on cpu"):
        fk.fsgld_update_2d(y, torch.zeros(16, 128), seeds, sc, chains=2)


def test_packed_executor_one_launch_per_step_and_equals_per_leaf(dev):
    assert api.Execution().device.type == "cuda"
    out = {}
    for ex in ("packed", "per_leaf"):
        g = torch.Generator(device=dev).manual_seed(3)
        data, bank, theta0 = mlp_problem(g, S=3, n=64, din=6, hid=9,
                                         dout=2)
        s = api.FSGLD(api.Posterior(mlp_log_lik), data, minibatch=8,
                      step_size=1e-4,
                      surrogate=api.SurrogateSpec(kind="scalar", bank=bank),
                      schedule=api.Schedule(rounds=2, local_steps=5,
                                            n_chains=4,
                                            reassign="permutation"),
                      execution=api.Execution(executor=ex))
        fk.reset_launches()
        out[ex] = s.sample(torch.Generator(device=dev).manual_seed(1),
                           theta0)
        torch.cuda.synchronize()
        if ex == "packed":
            assert fk.LAUNCHES == {"fsgld_update_packed": 10,
                                   "fsgld_update_2d": 0}
        else:
            assert fk.LAUNCHES == {"fsgld_update_packed": 0,
                                   "fsgld_update_2d": 10 * 4}
    for a, b in zip(tu.leaves(out["packed"]), tu.leaves(out["per_leaf"])):
        assert torch.isfinite(a).all()
        assert torch.equal(a, b)
