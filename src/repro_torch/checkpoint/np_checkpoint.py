"""Pytree checkpoints as npz + key-path manifest (counterpart of
``repro.checkpoint.np_checkpoint``; the files are interchangeable with
the JAX package's, both ways).

Every checkpoint is a versioned envelope (``schema: repro-ckpt-v2``)
carrying a :class:`DrawMeta` (which sampler produced the draw, at which
round, under which federation scenario, from which seed, at what storage
dtype) and a structural ``config_hash`` of the parameter tree (key
paths, shapes, dtype names). The hash lets a server refuse a draw bank
of another architecture instead of failing halfway through a prefill.
Legacy checkpoints (no envelope) restore with ``meta`` None.

Leaves are named by their '/'-joined key paths (``tree.leaves_with_names``)
and stored as ``a0.npy``, ``a1.npy``, ... in ``arrays.npz``, written as
``np.savez`` writes them (the same bytes for the same arrays). A bf16
tensor is stored as its raw 2-byte words under the descr ``'<V2'``, which
is what ``np.savez`` writes for an ml_dtypes bfloat16 array, and reads
back as bf16. The npz is streamed to the staged file one leaf at a time
(a device tensor comes to the host leaf by leaf), so a checkpoint never
needs a second in-memory copy of itself. Its sha256 is taken from the
file by a worker thread (``_FileHash``), behind the writer as each leaf's
bytes become final, and beside the parser on a restore.

Every write is ATOMIC: staged under a dot-prefixed temp directory and
renamed into place (fresh target), or its files ``os.replace``d one by
one (existing target), and the manifest carries a content hash of the
array file (``arrays_sha256``), so a write preempted between the two
replaces surfaces at restore time as a :class:`CorruptCheckpointError`.
Readers tell *corruption* (torn or garbled bytes: retryable, skippable
in a bank) from *refusal* (wrong arch or config: a ValueError that must
stop the caller).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import struct
import zipfile
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import tree as tu

PyTree = Any

SCHEMA = "repro-ckpt-v2"

# bytes per write call while streaming the npz, and per read while
# hashing it (one reused buffer)
_CHUNK = 1 << 26
_HASH_CHUNK = 1 << 24


class CorruptCheckpointError(ValueError):
    """The checkpoint's bytes are unreadable or torn (preempted write,
    truncated file, content-hash mismatch), as opposed to a REFUSAL
    (wrong arch or config), which stays a plain ValueError. Bank readers
    skip corrupt draws; resume loaders fall back to the previous
    snapshot."""


@dataclasses.dataclass(frozen=True)
class DrawMeta:
    """Provenance envelope of one posterior draw.

    ``config_hash`` is filled at save time when left None (it is a pure
    function of the parameter tree's structure); ``scenario`` is the
    federation registry name ('identity' without one); ``dtype`` the
    storage dtype's numpy name ('float32', 'bfloat16')."""
    method: str = "fsgld"
    round: int = 0
    scenario: str = "identity"
    seed: int = 0
    dtype: str = "float32"
    arch: Optional[str] = None
    chain: int = 0
    config_hash: Optional[str] = None


def dtype_name(dtype) -> str:
    """The numpy name of a torch or numpy dtype: 'float32', 'bfloat16',
    'int32' (what the JAX package writes), never 'torch.float32'."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return str(np.dtype(dtype))


def tree_fingerprint(tree: PyTree) -> str:
    """Structural hash of a parameter tree: key paths + shapes + dtype
    names (values excluded: two draws of one model share it, two archs
    never do). This is the ``DrawMeta.config_hash``. Meta tensors work,
    so a skeleton needs no memory."""
    desc = [[n, [int(s) for s in l.shape], dtype_name(l.dtype)]
            for n, l in tu.leaves_with_names(tree)]
    blob = json.dumps(desc, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def _write_leaf(fid, leaf) -> None:
    """One leaf as an .npy member, the bytes ``np.savez`` writes: its
    header, then a tensor's bytes straight from its host copy."""
    if not isinstance(leaf, torch.Tensor):
        np.lib.format.write_array(fid, np.asarray(leaf), allow_pickle=False)
        return
    t = leaf.detach().cpu().contiguous()
    header = {"descr": "<V2", "fortran_order": False,
              "shape": tuple(t.shape)}
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    else:
        header = np.lib.format.header_data_from_array_1_0(t.numpy())
    np.lib.format.write_array_header_1_0(fid, header)
    raw = memoryview(t.numpy().reshape(-1).view(np.uint8))
    for i in range(0, len(raw), _CHUNK):
        fid.write(raw[i:i + _CHUNK])


class _FileHash:
    """The sha256 of an open file's bytes, read with ``os.pread`` (which
    leaves the file's offset alone) on one worker thread, in order:
    ``feed(end)`` queues the bytes up to ``end``, which must be final;
    ``hexdigest(end)`` hashes up to ``end`` and waits. ``close`` stops
    the worker."""

    def __init__(self, fd: int):
        self.fd, self.done = fd, 0
        self.h = hashlib.sha256()
        self.buf = memoryview(bytearray(_HASH_CHUNK))
        self.pool = ThreadPoolExecutor(1)
        self.futures = []

    def _hash(self, start: int, end: int) -> None:
        while start < end:
            n = os.preadv(self.fd, [self.buf[:min(_HASH_CHUNK, end - start)]],
                          start)
            if not n:
                break
            self.h.update(self.buf[:n])
            start += n

    def feed(self, end: int) -> None:
        self.futures.append(self.pool.submit(self._hash, self.done, end))
        self.done = end

    def hexdigest(self, end: int) -> str:
        self.feed(end)
        for fut in self.futures:
            fut.result()
        return self.h.hexdigest()

    def close(self) -> None:
        self.pool.shutdown(wait=True, cancel_futures=True)


def _write_npz(path: str, leaves: list) -> str:
    """Stream the leaves into ``path`` as ``np.savez`` lays them out;
    returns the file's sha256, hashed behind the writer: a member's bytes
    are final once it is closed (zipfile patches its header then)."""
    with open(path, "w+b") as f:
        hasher = _FileHash(f.fileno())
        try:
            with zipfile.ZipFile(f, mode="w", compression=zipfile.ZIP_STORED,
                                 allowZip64=True) as zipf:
                for i, leaf in enumerate(leaves):
                    # always force zip64, as np.savez does
                    with zipf.open(f"a{i}.npy", "w",
                                   force_zip64=True) as fid:
                        _write_leaf(fid, leaf)
                    f.flush()
                    hasher.feed(f.tell())
            f.flush()
            os.fsync(f.fileno())
            return hasher.hexdigest(os.fstat(f.fileno()).st_size)
        finally:
            hasher.close()


def _write_file(path: str, blob: bytes):
    with open(path, "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())


def save(path: str, tree: PyTree, *, step: int = 0, extra: dict = None,
         meta: Optional[DrawMeta] = None):
    """Write the tree + v2 envelope ATOMICALLY (staged under a
    dot-prefixed temp dir, then renamed or replaced into place: a
    preemption mid-save never leaves a half-written checkpoint where a
    reader expects a whole one). Leaves may lie on any device. ``meta``
    records draw provenance; its config_hash is computed here when
    unset."""
    named = tu.leaves_with_names(tree)
    names = [n for n, _ in named]
    if meta is not None and meta.config_hash is None:
        meta = dataclasses.replace(meta, config_hash=tree_fingerprint(tree))

    abspath = os.path.abspath(path)
    parent, base = os.path.split(abspath)
    os.makedirs(parent, exist_ok=True)
    tmp = os.path.join(parent, f".tmp-{base}-{os.getpid()}")
    os.makedirs(tmp, exist_ok=True)
    sha = _write_npz(os.path.join(tmp, "arrays.npz"),
                     [l for _, l in named])
    manifest = {"schema": SCHEMA, "names": names, "step": step,
                "extra": extra or {},
                "fingerprint": tree_fingerprint(tree),
                "arrays_sha256": sha,
                "meta": dataclasses.asdict(meta) if meta is not None
                else None}
    _write_file(os.path.join(tmp, "manifest.json"),
                json.dumps(manifest).encode())
    if not os.path.exists(abspath):
        # fresh target: publishing is ONE rename, fully atomic
        os.rename(tmp, abspath)
    else:
        # in-place overwrite: replace file by file (arrays first). A
        # preemption between the two replaces leaves a mixed pair, which
        # restore() detects via arrays_sha256 and refuses as corrupt.
        os.replace(os.path.join(tmp, "arrays.npz"),
                   os.path.join(abspath, "arrays.npz"))
        os.replace(os.path.join(tmp, "manifest.json"),
                   os.path.join(abspath, "manifest.json"))
        os.rmdir(tmp)


def _read_manifest(path: str) -> dict:
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            return json.load(f)
    except json.JSONDecodeError as e:
        raise CorruptCheckpointError(
            f"checkpoint manifest at {path!r} is not valid JSON "
            f"(torn write?): {e}") from e


def read_meta(path: str) -> Optional[DrawMeta]:
    """The checkpoint's DrawMeta, or None for legacy (v1) checkpoints."""
    m = _read_manifest(path).get("meta")
    if m is None:
        return None
    known = {f.name for f in dataclasses.fields(DrawMeta)}
    return DrawMeta(**{k: v for k, v in m.items() if k in known})


def _read_member(f, zipf: zipfile.ZipFile, name: str,
                 check_crc: bool) -> np.ndarray:
    """One stored .npy member of ``zipf`` (open on ``f``) read straight
    into its array: the local header, the .npy header, then one
    ``readinto``. ``check_crc`` checks the member's CRC-32 (for
    checkpoints whose manifest carries no content hash)."""
    info = zipf.getinfo(name)
    if info.compress_type != zipfile.ZIP_STORED:
        raise zipfile.BadZipFile(f"{name} is compressed")
    f.seek(info.header_offset)
    head = f.read(30)
    if len(head) != 30 or head[:4] != b"PK\x03\x04":
        raise zipfile.BadZipFile(f"{name} has no local file header")
    start = info.header_offset + 30 + sum(struct.unpack("<HH", head[26:]))
    f.seek(start)
    version = np.lib.format.read_magic(f)
    if version not in ((1, 0), (2, 0)):
        raise zipfile.BadZipFile(f"{name}: .npy version {version}")
    read_header = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                   else np.lib.format.read_array_header_2_0)
    shape, fortran, dtype = read_header(f)
    if dtype.hasobject:
        raise ValueError(f"{name} holds Python objects")
    body = f.tell()
    arr = np.empty(shape[::-1] if fortran else shape, dtype)
    raw = memoryview(arr.reshape(-1).view(np.uint8))
    if f.readinto(raw) != len(raw) or f.tell() - start != info.file_size:
        raise zipfile.BadZipFile(f"{name} is truncated")
    if check_crc:
        f.seek(start)
        if zlib.crc32(raw, zlib.crc32(f.read(body - start))) != info.CRC:
            raise zipfile.BadZipFile(f"{name} fails its CRC-32")
    return arr.T if fortran else arr


def _to_torch(arr: np.ndarray) -> torch.Tensor:
    """A loaded .npy array as a host tensor; 2-byte voids are bf16."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore(path: str, like: PyTree):
    """Restore into the structure of ``like`` (names must match; its
    leaves may be meta tensors). Reads the v2 envelope and legacy
    manifests. Returns (tree of host tensors, step, extra); use
    :func:`read_meta` for the provenance envelope.

    Unreadable or torn bytes (missing or garbled arrays.npz, an
    ``arrays_sha256`` that no longer matches) raise
    :class:`CorruptCheckpointError`; a key-path mismatch (wrong model)
    stays a plain ValueError refusal. The array file is read through
    ``open()``, each leaf straight into its array, while a worker thread
    hashes it; the hash's verdict comes first, as if it had been checked
    before the parse."""
    manifest = _read_manifest(path)
    apath = os.path.join(path, "arrays.npz")
    try:
        f = open(apath, "rb")
    except OSError as e:
        raise CorruptCheckpointError(
            f"checkpoint at {path!r} has no readable arrays.npz: "
            f"{e}") from e
    names = [n for n, _ in tu.leaves_with_names(like)]
    want_sha = manifest.get("arrays_sha256")
    with f:
        hasher = _FileHash(f.fileno())
        try:
            if want_sha is not None:
                hasher.feed(os.fstat(f.fileno()).st_size)
            new = err = None
            try:
                if names != manifest["names"]:
                    raise ValueError(
                        f"checkpoint/skeleton mismatch at {path}: the "
                        "stored tree has different key paths than the "
                        "restore target")
                with zipfile.ZipFile(f) as zipf:
                    new = [_to_torch(_read_member(f, zipf, f"a{i}.npy",
                                                  want_sha is None))
                           for i in range(len(names))]
            except Exception as e:  # noqa: BLE001 - the hash rules first
                err = e
            if want_sha is not None and \
                    hasher.hexdigest(hasher.done) != want_sha:
                raise CorruptCheckpointError(
                    f"checkpoint at {path!r} is torn: arrays.npz content "
                    "hash does not match its manifest (write preempted "
                    "mid-replace?)") from err
        finally:
            hasher.close()
    if isinstance(err, ValueError):
        raise err
    if err is not None:  # truncated/garbled archive, missing entries
        raise CorruptCheckpointError(
            f"checkpoint arrays at {path!r} are unreadable "
            f"({type(err).__name__}: {err})") from err
    tree = tu.unflatten(tu.flatten(like)[1], new)
    return tree, manifest["step"], manifest["extra"]
