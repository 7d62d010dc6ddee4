"""The port stands alone: no file of ``src/repro_torch/`` or ``tools/``
and not ``chip_smoke.py`` imports JAX or anything of the JAX package
``repro`` (an AST scan, so a lazy import inside a function counts too).
The one exception is ``tools/ref_dryrun.py``, the reference's own dry run
on Auto mesh axes, which the port's dry run is compared with on the CPU:
it imports the JAX package, and nothing of the port imports it."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
# harnesses that run the JAX package itself, on the CPU only
REFERENCE_HARNESSES = (ROOT / "tools" / "ref_dryrun.py",)
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + sorted(p for p in (ROOT / "tools").glob("*.py")
             if p not in REFERENCE_HARNESSES) + [ROOT / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_nothing_of_repro(path):
    assert path.exists(), path
    bad = sorted(set(_imported_roots(path)) & set(BANNED))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_sees_the_whole_port():
    names = {p.name for p in FILES}
    assert {"api.py", "engine.py", "fsgld_update.py", "ops.py",
            "chip_smoke.py", "flash_planted_faults.py", "sghmc.py",
            "methods.py", "fald.py", "schedule.py", "compress.py",
            "partition.py", "spec.py", "registry.py", "train.py",
            "serve.py", "model.py", "layers.py", "flash_attention.py",
            "federated.py", "surrogate.py", "synthetic.py",
            "convert.py", "calibration.py", "workloads.py",
            "paper_runs.py", "np_checkpoint.py", "snapshot.py",
            "draw_bank.py", "health.py", "chaos.py", "trace.py",
            "telemetry.py", "exporters.py", "hierarchy.py",
            "divergence_depth.py", "dryrun.py", "steps.py", "specs.py",
            "pipeline.py", "hlo_analysis.py", "report.py",
            "compare.py"} <= names


def test_no_file_of_the_port_imports_a_reference_harness():
    names = {p.stem for p in REFERENCE_HARNESSES}
    for harness in REFERENCE_HARNESSES:
        assert "repro" in set(_imported_roots(harness)), harness
    for path in FILES:
        assert not set(_imported_roots(path)) & names, path
