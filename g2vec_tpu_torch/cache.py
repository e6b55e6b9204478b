"""The walk cache: stage 3's path sets as verified on-disk artifacts.

The port's copy of the walk tier of ``g2vec_tpu/cache.py``. A group's
path set is a pure function of its thresholded edge list and the walk
parameters, so ``--cache-dir DIR`` stores it under ``DIR/walks`` as a
content-addressed artifact: the key is the sha256 of the exact edge
arrays, ``n_genes``, the walk parameters and a versioned PRNG-family tag.
A repeat run at the same inputs skips the walks; any drift misses.

The key and the artifact format are the reference's byte for byte, so an
entry written by either package loads in the other. Both samplers of the
port (the C++ one and the card's kernel) draw the same splitmix64 walks
and key under :data:`NATIVE_FAMILY`: a device run hits an entry a native
run wrote, and the other way round.

Every store writes ``walks-<key[:32]>.npz`` and then a manifest holding
its sha256; a load whose bytes do not match (a torn write, bitrot) warns
with a ``RuntimeWarning`` and misses, and the recompute's store
overwrites the bad entry. A cache can make a run faster, never wrong.

The port has no compile cache, so :func:`resolve_cache_tiers` returns
the walk tier only. The batch engine stacks :class:`SharedWalkTier`, an
in-process memo, above it. ``--kernel-autotune`` keeps its measured tile
plans beside the walks, in a file of the port's own
(:func:`autotune_cache_path`).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
import warnings
from typing import Dict, Optional, Set

import numpy as np

from g2vec_tpu_torch.resilience.faults import fault_point
from g2vec_tpu_torch.utils.integrity import sha256_file, write_json_atomic

SCHEMA_VERSION = 1
MANIFEST_SUFFIX = ".manifest.json"

#: PRNG-family tags baked into every key; versioned on any change to a
#: sampler's stream derivation, so that a stale artifact misses. Both of
#: the port's samplers key under NATIVE_FAMILY (it names the splitmix64
#: stream family, not a host); DEVICE_FAMILY is the reference's legacy
#: jax.random walker's tag, kept so that its entries never collide.
NATIVE_FAMILY = "native-splitmix64-v1"
DEVICE_FAMILY = "device-jaxrandom-v1"

_STATS_LOCK = threading.Lock()
_TIER_STATS: Dict[str, Dict[str, int]] = {}


def record_cache_event(tier: str, outcome: str, n: int = 1) -> None:
    """Count one cache outcome, e.g. ``("walk", "disk_hit")``."""
    with _STATS_LOCK:
        counts = _TIER_STATS.setdefault(tier, {})
        counts[outcome] = counts.get(outcome, 0) + n


def cache_stats() -> Dict[str, Dict[str, int]]:
    """Every tier's counters since the process started (the walk tier's
    outcomes: disk_hit, miss, verify_failed, store; the autotune tier's:
    hit, miss, sweep)."""
    with _STATS_LOCK:
        snap = {t: dict(c) for t, c in _TIER_STATS.items()}
    snap.setdefault("walk", {})
    snap.setdefault("autotune", {})
    return snap


def walk_cache_key(src: np.ndarray, dst: np.ndarray, w: np.ndarray,
                   n_genes: int, *, len_path: int, reps: int, seed: int,
                   family: str) -> str:
    """Content hash of everything the walk output is a function of."""
    h = hashlib.sha256()
    h.update(f"schema={SCHEMA_VERSION};family={family};"
             f"n_genes={n_genes};len_path={len_path};reps={reps};"
             f"seed={seed};".encode())
    for arr, dtype in ((src, np.int32), (dst, np.int32), (w, np.float32)):
        a = np.ascontiguousarray(np.asarray(arr), dtype=dtype)
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


@dataclasses.dataclass
class WalkCache:
    """The walk tier rooted at one directory. A path set (np.packbits rows
    as bytes) is stored as the sorted [n_unique, ceil(G/8)] uint8 matrix,
    so that the artifact's bytes, and its sha256, are deterministic."""

    directory: str

    def _paths(self, key: str) -> tuple:
        art = os.path.join(self.directory, f"walks-{key[:32]}.npz")
        return art, art + MANIFEST_SUFFIX

    def _refuse(self, message: str) -> None:
        warnings.warn(message + "; recomputing walks", RuntimeWarning)
        record_cache_event("walk", "verify_failed")

    def load(self, key: str) -> Optional[Set[bytes]]:
        """The cached path set for ``key``, or None: a miss, or an entry
        that failed verification (with a warning)."""
        art, man_path = self._paths(key)
        if not os.path.exists(art) or not os.path.exists(man_path):
            record_cache_event("walk", "miss")
            return None
        try:
            with open(man_path) as f:
                manifest = json.load(f)
        except (OSError, ValueError) as e:
            self._refuse(f"walk cache manifest {man_path} unreadable ({e!r})")
            return None
        if manifest.get("schema") != SCHEMA_VERSION \
                or manifest.get("key") != key:
            self._refuse(f"walk cache entry {art} is stale (schema/key "
                         f"mismatch: a truncated key collision or an older "
                         f"cache layout)")
            return None
        actual = sha256_file(art)
        if actual != manifest.get("sha256"):
            self._refuse(
                f"walk cache entry {art} failed sha256 verification "
                f"(manifest {str(manifest.get('sha256'))[:12]}... vs file "
                f"{actual[:12]}...): corrupt or torn entry")
            return None
        try:
            with np.load(art) as z:
                rows = z["rows"]
        except Exception as e:  # noqa: BLE001 — any unreadable npz misses
            self._refuse(f"walk cache entry {art} unreadable ({e!r})")
            return None
        record_cache_event("walk", "disk_hit")
        return {row.tobytes() for row in rows}

    def store(self, key: str, path_set: Set[bytes], n_genes: int,
              meta: Optional[Dict] = None) -> str:
        """Write ``path_set`` under ``key``: the artifact through a
        temporary name, then the manifest (a crash between the two leaves
        an artifact without a manifest, which loads as a miss). Returns
        the artifact's path."""
        os.makedirs(self.directory, exist_ok=True)
        art, man_path = self._paths(key)
        nbytes = (n_genes + 7) // 8
        rows = np.frombuffer(b"".join(sorted(path_set)), dtype=np.uint8)
        rows = rows.reshape(len(path_set), nbytes) if path_set \
            else np.zeros((0, nbytes), dtype=np.uint8)
        tmp = f"{art}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            np.savez_compressed(f, rows=rows)
        os.replace(tmp, art)
        write_json_atomic(man_path, {
            "schema": SCHEMA_VERSION, "key": key,
            "sha256": sha256_file(art), "n_rows": int(rows.shape[0]),
            "n_genes": int(n_genes), **(meta or {})})
        # Fault seam: corrupt flips bytes in the artifact after the
        # manifest recorded the good hash (post-save bitrot, which only
        # the verification on load can catch).
        fault_point("walk_cache", path=art)
        record_cache_event("walk", "store")
        return art


@dataclasses.dataclass
class SharedWalkTier:
    """An in-process memo above the on-disk :class:`WalkCache` (the
    reference's ``SharedWalkTier``).

    The batch engine (``batch/engine.py``) runs many lanes in one process;
    lanes whose walk inputs coincide (a seed sweep shares both groups'
    products, cohorts of their own share nothing) pay each distinct
    product once. The memo holds products under the disk tier's
    content-addressed key, so a memo hit needs no verification (the object
    never left the process); the disk tier underneath serves hits across
    processes and receives every store. ``memo_hits``, ``disk_hits`` and
    ``walked`` count the three outcomes.
    """

    disk: Optional[WalkCache] = None
    memo: Dict[str, Set[bytes]] = dataclasses.field(default_factory=dict)
    memo_hits: int = 0
    disk_hits: int = 0
    walked: int = 0

    def load(self, key: str) -> Optional[Set[bytes]]:
        hit = self.memo.get(key)
        if hit is not None:
            self.memo_hits += 1
            record_cache_event("walk", "memo_hit")
            return hit
        if self.disk is not None:
            hit = self.disk.load(key)
            if hit is not None:
                self.disk_hits += 1
                self.memo[key] = hit
                return hit
        else:
            record_cache_event("walk", "miss")
        return None

    def store(self, key: str, path_set: Set[bytes], n_genes: int,
              meta: Optional[Dict] = None) -> None:
        self.walked += 1
        self.memo[key] = path_set
        if self.disk is not None:
            self.disk.store(key, path_set, n_genes, meta=meta)

    def stats(self) -> Dict[str, int]:
        return {"memo_hits": self.memo_hits, "disk_hits": self.disk_hits,
                "walked": self.walked}


def resolve_cache_tiers(cache_dir: Optional[str]) -> Optional[WalkCache]:
    """The walk tier for a run's flags: ``DIR/walks`` under
    ``--cache-dir DIR``; None without one."""
    if cache_dir:
        return WalkCache(os.path.join(cache_dir, "walks"))
    return None


def autotune_cache_path(cache_dir: Optional[str]) -> Optional[str]:
    """The kernel-autotune tier's record under ``--cache-dir``: measured
    tile plans of the packed kernels, keyed inside the file by exact shape,
    backend and schema (``ops/packed_matmul.py`` owns the format and its
    staleness rules). A file of the port's own, so a cache root shared
    with the reference keeps the reference's ``packed_matmul.json`` as it
    is. None without a cache root: a sweep then lives in memory only."""
    if not cache_dir:
        return None
    return os.path.join(cache_dir, "autotune", "packed_matmul_cuda.json")
