"""Fault injection for tests and smoke runs (counterpart of
``repro.testing``)."""
from repro_torch.testing.chaos import (  # noqa: F401
    ChaosSpec,
    corrupt_draw,
    flaky_io,
    truncate_file,
)
