"""The dry run on a fake (2, 2) world, for ``tests/test_torch_dryrun.py``
(a fake world is process-global, so it runs in a process of its own):

    python tests/_dryrun_worker.py OUT.json

Traces qwen3's smoke config (d 64, one layer) at small train, prefill and
decode shapes and the long-context shape's skip, and writes each combination's
info (or 'skip') as JSON."""
from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import SamplerConfig, get_smoke_config  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

CFG = dict(d_model=64, num_heads=2, num_kv_heads=2, head_dim=32, d_ff=128,
           vocab_size=128, num_layers=1)
SHAPES = {"train": InputShape("train", seq_len=32, global_batch=4,
                              kind="train"),
          "prefill": InputShape("prefill", seq_len=32, global_batch=4,
                                kind="prefill"),
          "decode": InputShape("decode", seq_len=32, global_batch=4,
                               kind="decode"),
          "long_500k": "long_500k"}


def main() -> int:
    cfg = dataclasses.replace(get_smoke_config("qwen3-1.7b"), **CFG)
    mesh = dryrun.make_pod_mesh((2, 2), ("data", "model"))
    sampler = SamplerConfig(method="fsgld", num_shards=16)
    out = {}
    for name, shape in SHAPES.items():
        info = dryrun.lower_one("qwen3-1.7b", shape, mesh, sampler, cfg=cfg)
        out[name] = info
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
