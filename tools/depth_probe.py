"""How deep does each family sample on one card, and with how many rows?

    python3 tools/depth_probe.py moe=2 rwkv=7 rwkv=9 whisper=32:8 ...

Each argument is TAG=LAYERS[:ROWS] for a family of ``chip_smoke.py``'s
``FAMILIES`` (moe, rg, rwkv, whisper): its ``[train-TAG]`` phase
(``chip_smoke.train_family``: the train driver's defaults at the
family's published width, cut to LAYERS layers, minibatches of ROWS
rows, every check of the phase) is run once per argument, in order.
Prints each run's phase seconds and, from the phase's own lines, the fit
and sampling peaks of device memory; a run that runs out of card memory
is reported and the next one still runs. The last line is one JSON
object of the runs, with the card's name and power limit.
"""
from __future__ import annotations

import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("depth_probe: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    cs.log(cs.card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build()
    dev = torch.device("cuda")
    tags = {f["tag"]: a for a, f in cs.FAMILIES.items()}
    runs = []
    for spec in argv:
        tag, _, rest = spec.partition("=")
        layers, _, rows = rest.partition(":")
        arch = tags[tag]
        fam = cs.FAMILIES[arch]
        saved = dict(fam)
        fam["train"] = int(layers)
        if rows:
            fam["batch"] = int(rows)
        cs.phase(f"[probe] {arch}, {layers} layers, "
                 f"{fam.get('batch', 8)} rows")
        failures, t0 = [], time.perf_counter()
        try:
            cs.train_family(dev, arch, failures)
            ok, err = not failures, "; ".join(failures) or None
        except torch.cuda.OutOfMemoryError as e:
            ok, err = False, "out of memory: " + str(e).splitlines()[0]
        runs.append({"arch": arch, "layers": int(layers),
                     "rows": fam.get("batch", 8), "ok": ok, "error": err,
                     "seconds": time.perf_counter() - t0,
                     "max_allocated_gb":
                         torch.cuda.max_memory_allocated() / 1e9})
        cs.log(json.dumps(runs[-1]))
        fam.clear()
        fam.update(saved)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    print(json.dumps({"card": cs.card_line(), "runs": runs}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
