"""Artifact integrity sidecars — the LAcheck role.

The reference runs LAcheck after every daligner/merge and silently drops
corrupt `.las` inputs before (re)processing (reference:
falcon_kit/mains/LAsort.py:42-47, falcon_kit/functional.py:90,
falcon_kit/mains/dazzler.py:430-473 perfect-square las-count assertion).
falcon_tpu_torch's checkpoints are text/npz artifacts, so the analog is a
size+CRC32 sidecar (`<artifact>.check`) written atomically next to each
resumable artifact and verified on resume:

  * verified OK        -> artifact consumed as a checkpoint
  * sidecar mismatch   -> artifact quarantined to `<name>.corrupt` and
                          recomputed (never consumed silently)
  * no sidecar         -> legacy artifact: accepted with a warning (the
                          file was fully written under tmp+rename, but
                          cannot be distinguished from an external copy
                          that was truncated in transfer)
"""
import json
import logging
import os
import zlib

LOG = logging.getLogger(__name__)


def sidecar_path(path):
    return str(path) + ".check"


def checksum(path, chunk=1 << 22):
    crc = 0
    with open(path, "rb") as f:
        for b in iter(lambda: f.read(chunk), b""):
            crc = zlib.crc32(b, crc)
    return crc & 0xFFFFFFFF


def write_sidecar(path, rows=None):
    """Record size + CRC32 (+ optional logical row count) of `path`."""
    meta = {"size": os.path.getsize(path), "crc32": checksum(path)}
    if rows is not None:
        meta["rows"] = int(rows)
    tmp = sidecar_path(path) + ".tmp"
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.rename(tmp, sidecar_path(path))


def verify(path):
    """Tri-state: True = sidecar matches; False = missing file or
    mismatch (corrupt); None = file exists but has no sidecar."""
    if not os.path.exists(path):
        return False
    side = sidecar_path(path)
    if not os.path.exists(side):
        return None
    try:
        with open(side) as f:
            meta = json.load(f)
    except (OSError, ValueError):
        return False
    if os.path.getsize(path) != meta.get("size"):
        return False
    if checksum(path) != meta.get("crc32"):
        return False
    return True


def check_resume(path, what="artifact"):
    """Resume gate: True if `path` may be consumed as a checkpoint.
    Mismatching artifacts are quarantined to `<path>.corrupt` so the
    caller's recompute path can run (and a later inspection can still
    see the bad bytes)."""
    v = verify(path)
    if v is None:
        LOG.warning("%s: %s has no integrity sidecar; accepting "
                    "(written by an older version?)", what, path)
        return True
    if v:
        return True
    if os.path.exists(path):
        quarantine = path + ".corrupt"
        try:
            os.replace(path, quarantine)
            LOG.error("%s: integrity check FAILED for %s; quarantined to "
                      "%s and recomputing", what, path, quarantine)
        except OSError:
            LOG.exception("%s: integrity check FAILED for %s and "
                          "quarantine failed; recomputing", what, path)
    return False
