"""Checkpoint integrity: sha256 payload digests, verified reads, and
corrupt-tolerant discovery (the port's own copy of
`repro.core.integrity`, the same digest recipe and member name).

Stdlib and numpy only, so the cluster supervisor (`cluster.local`), a
parent process that never touches a device, can verify checkpoints
before deciding which epoch to restart a gang from.  `core.checkpoint`
routes every write and load through here, so every checkpoint path (the
SNN launcher, the cluster worker's periodic epochs) shares one integrity
contract:

  * writes are atomic (tmp + `os.replace`) and embed a sha256 digest of
    the payload arrays as an extra npz member (`_SHA_KEY`);
  * loads re-derive the digest and raise `CheckpointCorrupt` (never
    deserialize garbage) on a truncated file, an undecodable zip, or a
    digest mismatch;
  * `latest_valid` walks a checkpoint directory newest-first and returns
    the newest checkpoint that VERIFIES, falling back past corrupted
    epochs (the supervisor's restart-from-last-good-epoch primitive).

A file without a digest member loads with verification skipped (the
structural zip checks still apply).  Files written by either package
verify in the other: the digest hashes each array's name, `dtype.str`,
shape and raw bytes.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import tempfile
import zipfile
import zlib
from typing import Dict, Optional

import numpy as np

#: npz member holding the hex digest; excluded from its own digest.
_SHA_KEY = "payload_sha256"


class CheckpointCorrupt(RuntimeError):
    """A checkpoint file is truncated, undecodable, or fails its sha256
    payload digest.  Callers fall back to an earlier epoch (supervisor)
    or surface the path and reason (everything else)."""

    def __init__(self, path: str, reason: str):
        self.path = path
        self.reason = reason
        super().__init__(f"corrupt checkpoint {path}: {reason}")


def payload_digest(arrays: Dict[str, np.ndarray]) -> str:
    """Canonical sha256 over named arrays: sorted by name, each hashed as
    (name, dtype, shape, raw bytes).  np.savez round-trips dtype/shape
    exactly, so the digest recomputed from a loaded npz matches the one
    computed at save time iff every payload byte survived."""
    h = hashlib.sha256()
    for name in sorted(arrays):
        if name == _SHA_KEY:
            continue
        a = np.asarray(arrays[name])
        h.update(name.encode())
        h.update(str(a.dtype.str).encode())
        h.update(json.dumps(list(a.shape)).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


#: zlib level of the npz members.  The JAX package's np.savez_compressed
#: deflates at zlib's default (6); np.load reads either, and neither the
#: members nor the digest depend on it.  Level 1 writes a 4x4 full-width
#: state (3.2 M synapses) several times faster, for somewhat larger files.
COMPRESS_LEVEL = 1


def _write_npz(f, arrays: Dict[str, np.ndarray]) -> None:
    """np.savez_compressed(f, **arrays), deflated at COMPRESS_LEVEL."""
    with zipfile.ZipFile(f, mode="w", compression=zipfile.ZIP_DEFLATED,
                         compresslevel=COMPRESS_LEVEL) as z:
        for name, a in arrays.items():
            with z.open(name + ".npy", "w", force_zip64=True) as fh:
                np.lib.format.write_array(fh, np.asanyarray(a),
                                          allow_pickle=False)


def write_verified(path: str, arrays: Dict[str, np.ndarray]) -> str:
    """Atomic npz write with the payload digest embedded; returns `path`.

    tmp + `os.replace` in the destination directory, so a crash at ANY
    point leaves either the previous complete file or none — no torn
    writes are ever visible under the final name."""
    digest = payload_digest(arrays)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            _write_npz(f, dict(arrays, **{_SHA_KEY: np.array(digest)}))
        os.replace(tmp, path)                      # atomic
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return path


def read_verified(path: str) -> Dict[str, np.ndarray]:
    """Load an npz and verify its embedded digest.

    Raises `CheckpointCorrupt` on truncation (bad zip / short reads), on any
    member that fails to decompress, and on a digest mismatch.  Files
    written before digests existed (no `_SHA_KEY` member) load with a
    structural check only."""
    try:
        with np.load(path, allow_pickle=False) as z:
            arrays = {name: z[name] for name in z.files}
    except FileNotFoundError:
        raise
    except (zipfile.BadZipFile, zlib.error, ValueError, OSError, EOFError,
            KeyError) as e:
        raise CheckpointCorrupt(path, f"unreadable npz ({e})") from e
    if _SHA_KEY in arrays:
        want = str(arrays.pop(_SHA_KEY))
        got = payload_digest(arrays)
        if got != want:
            raise CheckpointCorrupt(
                path, f"payload sha256 mismatch (stored {want[:16]}..., "
                      f"recomputed {got[:16]}...)")
    return arrays


def verify(path: str) -> bool:
    """True iff `path` reads back cleanly under `read_verified`."""
    try:
        read_verified(path)
        return True
    except CheckpointCorrupt:
        return False


_STEP_RE = re.compile(r"^(?P<prefix>.+?)(?P<step>\d+)\.npz$")


def checkpoint_steps(directory: str, prefix: str = "ckpt_"):
    """[(step, path)] for every `<prefix><step>.npz` in `directory`,
    ascending by step; [] when the directory is absent."""
    if not os.path.isdir(directory):
        return []
    out = []
    for f in os.listdir(directory):
        if f.startswith(prefix) and f.endswith(".npz"):
            try:
                step = int(f[len(prefix):-4])
            except ValueError:
                continue
            out.append((step, os.path.join(directory, f)))
    return sorted(out)


def latest_valid(directory: str, prefix: str = "ckpt_"
                 ) -> Optional[str]:
    """Newest checkpoint in `directory` that passes verification,
    falling back past corrupted epochs; None when no valid one exists.
    This is the supervisor's restart anchor: a corrupted newest epoch
    costs one epoch of replay, never the run."""
    for _, path in reversed(checkpoint_steps(directory, prefix)):
        if verify(path):
            return path
    return None
