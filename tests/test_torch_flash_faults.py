"""The planted faults of ``tools/flash_planted_faults.py`` stay armed.

The tool plants each fault by replacing a piece of text of
``csrc/flash_attention.cu`` in a copy, and then holds every faulty build
against the kernel's tolerance on the card. If an edit of the kernel
changes that text, the fault can no longer be planted. This checks, on
the CPU, that every anchor of every fault occurs in the source exactly
once and that its replacement differs from it; and that the tool reads
ptxas's report (a bf16 spill fails it).
"""
import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src/repro_torch/kernels/csrc/flash_attention.cu"


def _tool(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  ROOT / f"tools/{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = _tool("flash_planted_faults")
FAULTS = TOOL.FAULTS


def test_the_four_faults_are_planted():
    assert sorted(FAULTS) == ["last_keys", "last_tile", "misweight",
                              "self_key"]


@pytest.mark.parametrize("name", sorted(FAULTS))
def test_fault_anchor_occurs_once_in_the_kernel(name):
    what, edits = FAULTS[name]
    assert what and edits
    text = SOURCE.read_text()
    for old, new in edits:
        assert old != new
        assert text.count(old) == 1


def test_plant_refuses_an_anchor_that_is_not_there_once():
    assert TOOL.plant("a b c", "x", [("b", "B")]) == "a B c"
    for text in ("a c", "b b"):
        with pytest.raises(RuntimeError, match="exactly once"):
            TOOL.plant(text, "x", [("b", "B")])


PTXAS = """\
ptxas warning : (C7514) Potential Performance Loss: wgmma.mma_async \
instructions are serialized due to ... in the function \
'_Z14flash_fwd_bf16ILi128EEv'
ptxas info    : Compiling entry function '_Z14flash_fwd_bf16ILi64EEv' \
for 'sm_90a'
ptxas info    : Function properties for _Z14flash_fwd_bf16ILi64EEv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers
ptxas info    : Compiling entry function '_Z14flash_fwd_bf16ILi256EEv' \
for 'sm_90a'
ptxas info    : Function properties for _Z14flash_fwd_bf16ILi256EEv
    48 bytes stack frame, 40 bytes spill stores, 40 bytes spill loads
ptxas info    : Compiling entry function '_Z12fsgld_updatev' for 'sm_90a'
ptxas info    : Function properties for _Z12fsgld_updatev
    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
"""


def test_ptxas_report_reads_spills_and_wgmma_warnings():
    rows = TOOL.ptxas_report(PTXAS)
    assert rows[0][0] == "" and "C7514" in rows[0][1]
    assert [(k, n) for k, _, n in rows[1:]] == [
        ("_Z14flash_fwd_bf16ILi64EEv", 0), ("_Z14flash_fwd_bf16ILi64EEv", 0),
        ("_Z14flash_fwd_bf16ILi256EEv", 40)]
