"""Shared-disk router leadership lease with fencing epochs.

The port's copy of ``g2vec_tpu/serve/leader.py``. It imports neither
torch nor jax: a standby router spends its life watching one file, and
only the replicas own the card. Three small disk protocols, each built
on an atomic tmp + ``os.replace`` publication:

1. **The leadership lease** (``<fleet_dir>/leader.json``): ``(epoch,
   holder, renewed_at, ttl_s)``. A lease is expired when ``now`` passes
   either ``renewed_at + ttl`` or the file's mtime plus ttl (the mtime
   backstops a writer whose clock runs ahead). A leader renews at
   ttl/3. Acquisition is claim-then-confirm: write an ``epoch + 1``
   claim, wait ``settle_s``, re-read, and hold only if our claim
   survived the rename race.
2. **The epoch hint** (``<fleet_dir>/leader.epoch``), written before
   every lease write, keeps the fencing epoch monotone when the lease
   file itself is torn.
3. **Fence markers** (``<state_dir>/fenced``). Before migrating the
   journal of a replica whose death it cannot verify locally, the
   leader bumps its epoch and drops a marker in the replica's state
   dir; the daemon checks it at every admission and trainer boundary
   and quarantines itself. A torn marker reads as fenced.

Epoch 0 everywhere means "no leadership machinery": a single router
never writes a lease and sends its commands without an epoch.
"""
from __future__ import annotations

import dataclasses
import json
import os
import socket
import threading
import time
import uuid
from typing import Callable, Optional, Tuple

LEASE_FILE = "leader.json"
EPOCH_HINT_FILE = "leader.epoch"
FENCE_MARKER = "fenced"
ROUTER_EPOCH_FILE = "router_epoch"

#: Default lease TTL when HA mode is enabled without an explicit value.
DEFAULT_TTL_S = 5.0


@dataclasses.dataclass(frozen=True)
class LeaseState:
    """A parsed lease file; ``expired`` is computed by the reader."""
    epoch: int
    holder: str
    renewed_at: float
    ttl_s: float


def _write_atomic(path: str, data: str) -> None:
    tmp = f"{path}.tmp.{os.getpid()}.{uuid.uuid4().hex[:8]}"
    with open(tmp, "w", encoding="utf-8") as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def read_lease(path: str) -> Optional[LeaseState]:
    """Parse the lease file; ``None`` for absent *or torn* files.

    Torn lease files do not block takeover (expiry falls back to the
    epoch hint for monotonicity), and they do not grant leadership.
    """
    try:
        with open(path, "r", encoding="utf-8") as fh:
            raw = json.load(fh)
        return LeaseState(epoch=int(raw["epoch"]),
                          holder=str(raw["holder"]),
                          renewed_at=float(raw["renewed_at"]),
                          ttl_s=float(raw["ttl_s"]))
    except (OSError, ValueError, KeyError, TypeError):
        return None


def _lease_expired(path: str, st: Optional[LeaseState],
                   now: float) -> bool:
    if st is None:
        return True
    try:
        mtime = os.stat(path).st_mtime
    except OSError:
        return True
    # Expired when EITHER clock says so: the filesystem mtime backstops
    # a writer whose own clock is skewed into the future (its
    # renewed_at would otherwise never age out), and vice versa. A
    # renewing leader keeps both fresh; a wrong steal is epoch-fenced.
    return now > st.renewed_at + st.ttl_s or now > mtime + st.ttl_s


class LeaderLease:
    """One router's handle on the shared-disk lease.

    ``held`` and ``epoch`` are deliberately separate: when the lease is
    lost, ``held`` drops to False but ``epoch`` KEEPS its last value —
    a zombie ex-leader must go on stamping its (now stale) epoch on
    every mutating command so the daemons' ``stale_epoch`` check can
    reject it.  Zeroing the epoch on loss would make the zombie's
    commands arrive epoch-less, which daemons accept for single-router
    compatibility — exactly the hole fencing exists to close.  All
    mutation happens under ``_lock``; callers read ``.epoch`` freely
    (int reads are atomic).
    """

    def __init__(self, fleet_dir: str, ttl_s: float = DEFAULT_TTL_S,
                 holder: Optional[str] = None,
                 settle_s: float = 0.05) -> None:
        self.fleet_dir = fleet_dir
        self.path = os.path.join(fleet_dir, LEASE_FILE)
        self.hint_path = os.path.join(fleet_dir, EPOCH_HINT_FILE)
        self.ttl_s = float(ttl_s)
        self.settle_s = float(settle_s)
        self.holder = holder or (
            f"{socket.gethostname()}:{os.getpid()}:"
            f"{uuid.uuid4().hex[:8]}")
        self._lock = threading.Lock()
        #: guarded-by: _lock
        self.epoch = 0
        #: guarded-by: _lock
        self._held = False

    # ---- epoch hint -----------------------------------------------------

    def _read_hint(self) -> int:
        try:
            with open(self.hint_path, "r", encoding="utf-8") as fh:
                return int(fh.read().strip())
        except (OSError, ValueError):
            return 0

    def _write_hint(self, epoch: int) -> None:
        _write_atomic(self.hint_path,
                      str(max(epoch, self._read_hint())))

    # ---- lease I/O ------------------------------------------------------

    def _write_lease(self, epoch: int, now: float) -> None:
        self._write_hint(epoch)
        _write_atomic(self.path, json.dumps({
            "epoch": epoch, "holder": self.holder,
            "renewed_at": now, "ttl_s": self.ttl_s}))

    def peek(self) -> Tuple[Optional[LeaseState], bool]:
        """(lease state, expired). Torn files read as (None, True)."""
        st = read_lease(self.path)
        return st, _lease_expired(self.path, st, time.time())

    @property
    def held(self) -> bool:
        return self._held

    # ---- protocol -------------------------------------------------------

    def acquire(self) -> bool:
        """Claim leadership if the lease is absent, ours, or expired.

        Claim-then-confirm: the rename race between two concurrent
        claimants has exactly one survivor, and only the claimant whose
        (holder, epoch) survives the settle window holds the lease.
        """
        with self._lock:
            now = time.time()
            st = read_lease(self.path)
            expired = _lease_expired(self.path, st, now)
            if st is not None and not expired and \
                    st.holder != self.holder:
                self._held = False
                return False
            if st is not None and not expired and \
                    st.holder == self.holder:
                self.epoch = st.epoch
                self._held = True
                return True
            prev = max(st.epoch if st else 0, self._read_hint())
            claim = prev + 1
            self._write_lease(claim, now)
            time.sleep(self.settle_s)
            cur = read_lease(self.path)
            if cur is not None and cur.holder == self.holder and \
                    cur.epoch == claim:
                self.epoch = claim
                self._held = True
                return True
            self._held = False
            return False

    def renew(self) -> bool:
        """Refresh the ttl; returns False (dropping ``held``, KEEPING
        the stale epoch) if the lease was taken over — the caller is
        now a zombie whose stamped commands must fail the daemons'
        stale-epoch check."""
        with self._lock:
            if not self._held:
                return False
            cur = read_lease(self.path)
            if cur is None or cur.holder != self.holder or \
                    cur.epoch != self.epoch:
                self._held = False
                return False
            self._write_lease(self.epoch, time.time())
            return True

    def bump(self) -> int:
        """Advance the fencing epoch while holding the lease (used
        before a false-dead journal migration).  Returns the new epoch,
        or 0 if the lease is not held / was lost (the stale epoch is
        kept for stamping, per the class contract)."""
        with self._lock:
            if not self._held:
                return 0
            cur = read_lease(self.path)
            if cur is None or cur.holder != self.holder:
                self._held = False
                return 0
            self.epoch = cur.epoch + 1
            self._write_lease(self.epoch, time.time())
            return self.epoch

    def release(self) -> None:
        """Drop the lease file (best-effort) so a standby can take over
        without waiting out the ttl.  The epoch hint stays behind —
        epochs never go backwards."""
        with self._lock:
            if not self._held:
                return
            cur = read_lease(self.path)
            if cur is not None and cur.holder == self.holder:
                try:
                    os.unlink(self.path)
                except OSError:
                    pass
            self._held = False


def wait_for_leadership(lease: LeaderLease, poll_s: float = 0.25,
                        stop: Optional[threading.Event] = None,
                        on_wait: Optional[Callable[[], None]] = None,
                        ) -> bool:
    """Standby loop: watch the lease until it expires, then take over.

    Returns True once ``lease.acquire()`` confirms, False if ``stop``
    was set first.  ``on_wait`` (if given) is invoked once per poll —
    the router uses it to keep its adopted view of the fleet warm.
    """
    while stop is None or not stop.is_set():
        st, expired = lease.peek()
        if expired or (st is not None and st.holder == lease.holder):
            if lease.acquire():
                return True
        if on_wait is not None:
            on_wait()
        if stop is not None:
            if stop.wait(poll_s):
                return False
        else:
            time.sleep(poll_s)
    return False


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
