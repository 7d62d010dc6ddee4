"""Host-side federated input pipeline (counterpart of
``repro.data.pipeline``): per-client token streams with epoch
shuffling, a client schedule that follows the sampler's shard draws,
and batches staged on the device one step ahead of use.

The host side is numpy, as the reference's: with the same seeds
``ClientDataset``, ``round_robin`` and ``categorical_schedule`` give the
reference's batches and client ids bitwise. On a CUDA device each batch
is copied from pinned host memory with ``non_blocking=True`` on a side
stream, and the consumer's stream waits on the copy's event when it
takes the batch (no ``synchronize`` per batch). With a mesh each batch
becomes a ``torch.distributed.tensor.DTensor`` placed by
``sharding.rules.batch_specs`` (the reference's ``jax.device_put(v,
sharding)``). On the CPU the copy is plain.
"""
from __future__ import annotations

import collections
from typing import Iterator

import numpy as np
import torch


class ClientDataset:
    """One client's examples: a dict of (N, ...) numpy arrays."""

    def __init__(self, data: dict, seed: int = 0):
        self.data = {k: np.asarray(v) for k, v in data.items()}
        self.n = next(iter(self.data.values())).shape[0]
        self.rng = np.random.default_rng(seed)
        self._order = self.rng.permutation(self.n)
        self._cursor = 0

    def next_batch(self, m: int) -> dict:
        """Batches without replacement, reshuffled at each epoch."""
        if self._cursor + m > self.n:
            self._order = self.rng.permutation(self.n)
            self._cursor = 0
        idx = self._order[self._cursor:self._cursor + m]
        self._cursor += m
        return {k: v[idx] for k, v in self.data.items()}


class FederatedPipeline:
    """Client-scheduled, prefetching batch stream.

    ``schedule`` yields client ids (the server's Categorical(f) draws);
    ``prefetch`` batches are staged on ``device`` ahead of use (None:
    'cuda', which must be available; no quiet CPU run). ``mesh``
    (a DeviceMesh) places every batch as a DTensor by ``spec`` (a
    ``sharding.rules.P``; default the batch specs of the batch's
    leaves). ``next(pipe)`` returns (client id, {name: tensor})."""

    def __init__(self, clients: list, batch_size: int,
                 schedule: Iterator[int], prefetch: int = 2, *,
                 device=None, mesh=None, spec=None):
        self.clients = clients
        self.m = batch_size
        self.schedule = schedule
        if device is None and not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        self.device = torch.device("cuda" if device is None else device)
        self.mesh, self.spec = mesh, spec
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._q = collections.deque()
        self._prefetch = prefetch
        self._fill()

    def _place(self, batch: dict) -> dict:
        from torch.distributed.tensor import distribute_tensor
        from repro_torch.sharding import rules
        specs = (rules.batch_specs(batch, self.mesh) if self.spec is None
                 else {k: self.spec for k in batch})
        # every rank reads the same batch: each keeps its own slice
        return {k: distribute_tensor(v, self.mesh,
                                     rules.placements(specs[k], self.mesh),
                                     src_data_rank=None)
                for k, v in batch.items()}

    def _produce(self):
        s = next(self.schedule)
        host = self.clients[s].next_batch(self.m)
        ready = None
        if self._stream is not None:
            with torch.cuda.stream(self._stream):
                dev = {k: torch.from_numpy(np.ascontiguousarray(v))
                       .pin_memory().to(self.device, non_blocking=True)
                       for k, v in host.items()}
                ready = torch.cuda.Event()
                ready.record(self._stream)
        else:
            dev = {k: torch.from_numpy(np.array(v)).to(self.device)
                   for k, v in host.items()}
        return s, dev, ready

    def _fill(self):
        while len(self._q) < self._prefetch:
            self._q.append(self._produce())

    def __next__(self):
        s, batch, ready = self._q.popleft()
        if ready is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(ready)
            for t in batch.values():   # made on the side stream
                t.record_stream(cur)
        if self.mesh is not None:
            batch = self._place(batch)
        self._fill()
        return s, batch

    def __iter__(self):
        return self


def round_robin(num_clients: int) -> Iterator[int]:
    i = 0
    while True:
        yield i % num_clients
        i += 1


def categorical_schedule(probs, seed: int = 0) -> Iterator[int]:
    rng = np.random.default_rng(seed)
    probs = np.asarray(probs)
    while True:
        yield int(rng.choice(len(probs), p=probs))
