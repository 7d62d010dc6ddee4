"""Checkpoints, run snapshots and draw banks (counterpart of
``repro.checkpoint``; the files are interchangeable with its)."""
from repro_torch.checkpoint.np_checkpoint import (  # noqa: F401
    CorruptCheckpointError,
    DrawMeta,
    dtype_name,
    read_meta,
    restore,
    save,
    tree_fingerprint,
)
from repro_torch.checkpoint.draw_bank import (  # noqa: F401
    iter_bank,
    list_draws,
    load_bank,
    save_draw,
)
from repro_torch.checkpoint.snapshot import (  # noqa: F401
    latest_snapshot,
    list_snapshots,
    save_snapshot,
)
