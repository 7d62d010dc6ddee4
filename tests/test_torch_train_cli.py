"""(h) The port's train CLI (``repro_torch.launch.train``) on the CPU at
the smoke configs: finite ll per chain on every decoder family, the
reference driver's flags and their refusals, and the refusal to run
without a card unless asked for the CPU.
"""
import numpy as np
import pytest
import torch

from repro_torch.launch import train as ttrain
import _torch_threads  # noqa: F401  (the cores each xdist worker uses)


# ---------------------------------------------------------------------------
# (h) the train CLI
# ---------------------------------------------------------------------------

SMALL = ["--device", "cpu", "--smoke", "--rounds", "1", "--local-updates",
         "2", "--fit-steps", "2", "--num-shards", "2", "--shard-size", "4",
         "--batch", "2", "--seq", "16"]


@pytest.mark.parametrize("extra", [[], ["--chains", "2", "--no-packed",
                                         "--use-kernel"]])
def test_train_cli_on_the_cpu_prints_finite_ll_per_chain(extra, capsys):
    assert ttrain.main(SMALL + extra) == 0
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("chain ")]
    chains = 2 if extra else 1
    assert len(lines) == chains
    for ln in lines:
        assert np.isfinite(float(ln.split("ll/token=")[1]))
    assert "params: 1.44M" in out and "surrogates fitted" in out
    assert f"executor={'per_leaf' if extra else 'auto'}" in out


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "grok-1-314b",
                                  "recurrentgemma-2b", "rwkv6-7b"])
def test_train_cli_samples_every_decoder_family(arch, capsys):
    """The MoE, hybrid and ssm smoke configs through the driver's fit and
    the packed executor: finite ll per chain."""
    assert ttrain.main(SMALL + ["--arch", arch, "--chains", "2",
                                "--use-kernel"]) == 0
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("chain ")]
    assert len(lines) == 2 and f"arch={arch}" in out
    for ln in lines:
        assert np.isfinite(float(ln.split("ll/token=")[1]))


@pytest.mark.parametrize("flag,match", [(["--multi-pod"], "even world")])
def test_train_cli_refuses_flags_naming_their_item(flag, match):
    """Every flag of the reference's driver is ported; ``--multi-pod``
    outside torchrun (one rank) is refused before any process group
    starts: one rank is not two pods (its run on two ranks:
    tests/test_torch_mesh.py)."""
    with pytest.raises(ValueError, match=match):
        ttrain.main(SMALL + flag)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("flag,match", [
    (["--snapshot-every", "2"], "need --snapshot-dir"),
    (["--resume"], "need --snapshot-dir"),
    (["--draw-bank", "d", "--snapshot-every", "2", "--snapshot-dir", "s"],
     "pick one"),
    (["--draw-bank", "d", "--resume", "--snapshot-dir", "s"], "pick one")])
def test_train_cli_refuses_the_reference_combinations(flag, match):
    """The reference driver's combination refusals of the fault-tolerance
    flags (which themselves run: ``tests/test_torch_resume.py``)."""
    with pytest.raises(SystemExit, match=match):
        ttrain.parse_args(SMALL + flag)


def test_train_cli_runs_with_bank_every_one_the_reference_default():
    assert ttrain.parse_args(SMALL).bank_every == 1
    assert ttrain.main(SMALL + ["--bank-every", "1"]) == 0


def test_train_cli_needs_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.main(SMALL[2:])
