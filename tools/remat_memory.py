"""Device memory of one gradient pass of the sampling path, per family
and depth, with and without per-layer recompute (``cfg.remat``).

    python3 tools/remat_memory.py [--src DIR] [--label NAME]
        [--archs qwen3-1.7b phi3.5-moe-42b-a6.6b rwkv6-7b whisper-large-v3]
        [--layers 1 2] [--variants remat plain] [--out chiprun_out/remat]

On the card: each arch at its published width, cut to each of
``--layers`` decoder layers (whisper's encoder cut alike), random fp32
parameters from a seed, one chain's ``vmap(grad(log_lik_fn))`` on one
minibatch of the train driver's shape (8 rows x 128 tokens; whisper 4
rows and 1,500 frames per row, as chip_smoke's [train-whisper] samples
it). Prints per (arch, layers, variant) the pass's peak device memory
above what was allocated before it (``max_memory_allocated`` after
``reset_peak_memory_stats``) and its seconds; the saved bytes per layer
are the difference of two depths. Variants: 'remat' (cfg.remat=True),
'plain' (cfg.remat=False), and for a tree without the recompute
(``--src`` an older checkout) 'plain' and 'rwkv_nograd' (its RWKV score
backward run under ``torch.no_grad``). ``--src DIR`` imports
``repro_torch`` from DIR/src (default: this checkout). The last line is
one JSON object of the rows, also written to OUT/<label>.json.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROWS = {"whisper-large-v3": 4}
SEQ, BATCH, FRAMES = 128, 8, 1500


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def _rwkv_nograd(layers_mod) -> None:
    """An older tree's RWKV score backward, run under no_grad (the values
    are the same; nothing is recorded for a second derivative)."""
    import torch
    cls = layers_mod._RwkvScores
    inner = cls.backward

    def backward(ctx, g):
        with torch.no_grad():
            return inner(ctx, g)

    cls.backward = staticmethod(backward)


def one_pass(arch: str, layers: int, variant: str, seed: int = 0) -> dict:
    import torch
    from torch.func import grad, vmap
    from repro_torch import tree as tu
    from repro_torch.configs import get_config
    from repro_torch.models import model as TM
    cfg = get_config(arch)
    kw = {"num_layers": layers}
    if cfg.encoder_layers:
        kw["encoder_layers"] = layers
    if hasattr(cfg, "remat"):
        kw["remat"] = variant == "remat"
    cfg = dataclasses.replace(cfg, **kw)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = tu.tree_map(lambda t: t[None],
                         TM.init_params(cfg, gen, device=dev))
    B = ROWS.get(arch, BATCH)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, B, SEQ),
                                     generator=gen, device=dev),
             "labels": torch.randint(0, cfg.vocab_size, (1, B, SEQ),
                                     generator=gen, device=dev)}
    if cfg.family in ("vlm", "audio"):
        T = cfg.num_patches if cfg.family == "vlm" else FRAMES
        batch["enc_embeds"] = torch.randn((1, B, T, cfg.d_model),
                                          generator=gen, device=dev)
    fn = vmap(grad(lambda p, b: TM.log_lik_fn(p, cfg, b)))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        g = fn(params, batch)
        torch.cuda.synchronize()
        ok = all(bool(torch.isfinite(t).all()) for t in tu.leaves(g))
        del g
        peak = torch.cuda.max_memory_allocated() - base
        err = None
    except torch.cuda.OutOfMemoryError as e:
        peak, ok, err = None, False, str(e).splitlines()[0]
    dt = time.perf_counter() - t0
    n = sum(t.numel() for t in tu.leaves(params))
    del params, batch
    torch.cuda.empty_cache()
    return {"arch": arch, "layers": layers, "variant": variant,
            "rows": B, "params": n, "peak_gb": (None if peak is None
                                                else peak / 1e9),
            "params_gb": n * 4 / 1e9, "seconds": dt, "finite": ok,
            "error": err}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--archs", nargs="+",
                    default=["qwen3-1.7b", "phi3.5-moe-42b-a6.6b",
                             "rwkv6-7b", "whisper-large-v3"])
    ap.add_argument("--layers", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--variants", nargs="+", default=["remat", "plain"])
    ap.add_argument("--out", default="chiprun_out/remat")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src) / "src"))
    import torch
    if not torch.cuda.is_available():
        print("remat_memory: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.models import layers as TL
    print(f"card: {card()}; torch {torch.__version__}; repro_torch from "
          f"{args.src} ({args.label})", flush=True)
    rows = []
    for variant in args.variants:
        if variant == "rwkv_nograd":
            _rwkv_nograd(TL)
        for arch in args.archs:
            for L in args.layers:
                r = one_pass(arch, L, variant)
                r["label"] = args.label
                rows.append(r)
                print(json.dumps(r), flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"{args.label}.json"), "w") as f:
        json.dump({"card": card(), "rows": rows}, f, indent=1)
    print(json.dumps({"card": card(), "label": args.label, "rows": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
