"""Leadership fencing, the file helpers a single daemon reads.

The port's copy of the fence-marker and epoch-file helpers of
``g2vec_tpu/serve/leader.py``. A daemon checks its state dir's fence
marker on every admission and at every trainer boundary, and keeps the
highest router epoch it has seen in ``<state>/router_epoch`` so that a
mutating op stamped with an older epoch is refused as ``stale_epoch``.
The lease itself (``LeaderLease``) belongs to the router and comes with
the multi-replica half of serve (not ported yet).
"""
from __future__ import annotations

import json
import os
import time
import uuid
from typing import Optional

FENCE_MARKER = "fenced"
ROUTER_EPOCH_FILE = "router_epoch"


def _write_atomic(path: str, data: str) -> None:
    tmp = f"{path}.tmp.{os.getpid()}.{uuid.uuid4().hex[:8]}"
    with open(tmp, "w", encoding="utf-8") as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


# ---- fence markers ------------------------------------------------------


def fence_marker_path(state_dir: str) -> str:
    return os.path.join(state_dir, FENCE_MARKER)


def write_fence_marker(state_dir: str, epoch: int) -> None:
    """Drop the per-replica quarantine marker.  Written by the leader
    *before* it migrates an unreachable replica's journal, so by the
    time duplicated work could exist the original has a kill order on
    disk."""
    _write_atomic(fence_marker_path(state_dir),
                  json.dumps({"epoch": int(epoch),
                              "fenced_at": time.time()}))


def read_fence_marker(state_dir: str) -> Optional[int]:
    """Fencing epoch from the marker; None when absent.  A torn marker
    reads as epoch 0 — still fenced: the marker only exists because a
    migration started, so the conservative parse is the safe one."""
    path = fence_marker_path(state_dir)
    try:
        with open(path, "r", encoding="utf-8") as fh:
            raw = fh.read()
    except OSError:
        return None
    try:
        return int(json.loads(raw)["epoch"])
    except (ValueError, KeyError, TypeError):
        return 0


def clear_fence_marker(state_dir: str) -> None:
    try:
        os.unlink(fence_marker_path(state_dir))
    except OSError:
        pass


# ---- persisted router-epoch (daemon side) -------------------------------


def read_epoch_file(path: str) -> int:
    """Highest router epoch a daemon has ever witnessed (0 on absent or
    torn — a torn epoch file must not manufacture a high epoch that
    would reject the *real* leader)."""
    try:
        with open(path, "r", encoding="utf-8") as fh:
            return int(fh.read().strip())
    except (OSError, ValueError):
        return 0


def write_epoch_file(path: str, epoch: int) -> None:
    _write_atomic(path, str(int(epoch)))
