"""The port's tests in pytest-xdist workers: each worker's torch takes its
share of the CPU cores for its intra-op threads.

Left at torch's default (a thread per core), N workers start N threads
per core, and a test of a small model waits on its threads more than it
computes: whisper's facade round in ``test_torch_models.py`` took 112 s
on 8 threads and 11 s on one, each beside one other busy process on an
8-core CPU. The ``tests/test_torch_*.py`` files that run torch import
this module; the setting is process-wide and made once. A run without
xdist keeps torch's default."""
import os

import torch


def share_cores() -> None:
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers:
        cores = len(os.sched_getaffinity(0))
        torch.set_num_threads(max(1, cores // int(workers)))


share_cores()
