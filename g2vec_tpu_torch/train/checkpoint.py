"""Checkpoint / resume for the port's trainers (single-file layout).

The port's copy of ``g2vec_tpu/train/checkpoint.py``'s single layout,
on one process. The full-batch trainer's state (params, Adam state, the
early-stop snapshot and accuracy pair, the epoch) round-trips through
one atomic ``cbow_state.npz`` (:func:`save_state`, :func:`load_state`);
the streaming trainer's through ``stream_state.npz`` with its (epoch,
shard) cursor (:func:`save_stream_state`, :func:`load_stream_state`).

The files and manifests are the JAX package's:

- the leaves are stored flat by index as ``leaf_i`` in the order in which
  the JAX package flattens ``(params, opt_state, snapshot)``: ``w_ih,
  w_ho, count, mu.w_ih, mu.w_ho, nu.w_ih, nu.w_ho, snap.w_ih,
  snap.w_ho`` (``optax.adam``'s state: the step count, a 0-d int32, then
  the two moments), with ``meta = [epoch, before_val, before_tr, done]``;
- every save writes a sidecar ``<file>.manifest.json``: schema version,
  the whole file's sha256, each leaf's sha256, shape and dtype, the
  ``meta`` or the ``cursor``, and the config ``fingerprint``;
- the previous generation is kept as the ``.prev`` twin; a load verifies
  the manifest before it trusts the file, falls back to ``.prev`` with a
  ``RuntimeWarning`` when the latest fails, and raises ``ValueError``
  when every generation is corrupt;
- a fingerprint that differs from the resuming run's raises
  ``ValueError``: two runs are never blended.

bfloat16 leaves are stored as their uint16 bit patterns (numpy has no
bfloat16, and the port does not depend on ``ml_dtypes``); the manifest's
dtype string says ``bfloat16``, as the JAX package's does, and the bytes
and their sha256 are the same as the JAX package's. The port checks the
fingerprint before the leaf shapes, so a checkpoint the JAX package wrote
at a padded gene width is refused by the fingerprint's ``n_genes_pad``.

The seams ``checkpoint_write`` (before the write), ``checkpoint_finalize``
(after the manifest commits) and, for the stream, ``stream_ckpt`` fire
where the JAX package fires them.
"""
from __future__ import annotations

import json
import os
import time
import warnings
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from g2vec_tpu_torch.resilience.faults import fault_point
from g2vec_tpu_torch.utils.integrity import (sha256_array as _sha256_array,
                                             sha256_file as _sha256_file,
                                             write_json_atomic as _write_json_atomic)

CKPT_NAME = "cbow_state.npz"
STREAM_NAME = "stream_state.npz"
MANIFEST_SUFFIX = ".manifest.json"
PREV_SUFFIX = ".prev"
SCHEMA_VERSION = 1

# ``done`` codes in the meta record: a finished run is not continued on
# --resume (after an early stop the saved params are post-dip and the
# snapshot pre-dip; stepping on would re-apply the dip's update).
RUN_IN_PROGRESS = 0
RUN_COMPLETED = 1      # reached max_epochs
RUN_EARLY_STOPPED = 2  # the early stop fired

#: The number of leaves of one trainer state.
N_LEAVES = 9


def flatten_state(params: Sequence, opt_state, snapshot: Sequence) -> list:
    """``(params, opt_state, snapshot)`` -> the 9 leaves in the JAX
    package's flatten order. ``params``/``snapshot`` are ``(w_ih, w_ho)``,
    ``opt_state`` is ``(count, (mu.w_ih, mu.w_ho), (nu.w_ih, nu.w_ho))``."""
    count, mu, nu = opt_state
    return [*params, count, *mu, *nu, *snapshot]


def unflatten_state(leaves: Sequence):
    """The inverse of :func:`flatten_state`."""
    if len(leaves) != N_LEAVES:
        raise ValueError(f"a trainer state has {N_LEAVES} leaves, got "
                         f"{len(leaves)}")
    return ((leaves[0], leaves[1]),
            (leaves[2], (leaves[3], leaves[4]), (leaves[5], leaves[6])),
            (leaves[7], leaves[8]))


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """A leaf -> (host array to store, manifest dtype string)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    elif isinstance(leaf, (int, np.integer)):
        arr = np.asarray(leaf, dtype=np.int32)
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _state_arrays(leaves) -> Tuple[dict, List[str]]:
    arrays, dtypes = {}, []
    for i, leaf in enumerate(leaves):
        arrays[f"leaf_{i}"], dtype = _to_host(leaf)
        dtypes.append(dtype)
    return arrays, dtypes


def to_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A stored leaf -> a CPU tensor of its manifest ``dtype``: bfloat16
    bits (stored as uint16, or as the JAX package's raw 2-byte voids)
    become a bfloat16 tensor."""
    if dtype == "bfloat16":
        if arr.dtype.itemsize != 2:
            raise ValueError(f"a bfloat16 leaf needs 2-byte items, got "
                             f"{arr.dtype}")
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, dtype=np.dtype(dtype)))


def _manifest_leaves(arrays: dict, dtypes: List[str]) -> list:
    return [{"name": k, "sha256": _sha256_array(v), "shape": list(v.shape),
             "dtype": d} for (k, v), d in zip(arrays.items(), dtypes)]


def _commit(path: str, written: str, manifest: dict) -> None:
    """Keep the last committed checkpoint (and its manifest) as ``.prev``
    until the new one is in place, then rename the new one in."""
    if os.path.exists(path):
        os.replace(path, path + PREV_SUFFIX)
        if os.path.exists(path + MANIFEST_SUFFIX):
            os.replace(path + MANIFEST_SUFFIX,
                       path + PREV_SUFFIX + MANIFEST_SUFFIX)
    os.replace(written, path)
    _write_json_atomic(path + MANIFEST_SUFFIX, manifest)


def _savez(path: str, arrays: dict) -> str:
    tmp = path + ".tmp"
    np.savez(tmp, **arrays)
    # np.savez appends .npz to names without it.
    return tmp + ".npz" if os.path.exists(tmp + ".npz") else tmp


def save_state(directory: str, params: Sequence, opt_state, snapshot: Sequence,
               epoch: int, before_val: float, before_tr: float,
               done: int = RUN_IN_PROGRESS,
               fingerprint: Optional[dict] = None) -> str:
    """Atomically write the full-batch trainer's state under
    ``directory``; returns the checkpoint's path. ``fingerprint`` (a flat
    dict of config scalars) is recorded in the manifest and checked on
    resume."""
    meta = np.array([float(epoch), before_val, before_tr, float(done)])
    arrays, dtypes = _state_arrays(flatten_state(params, opt_state, snapshot))
    arrays["meta"] = meta
    path = os.path.join(directory, CKPT_NAME)
    os.makedirs(directory, exist_ok=True)
    fault_point("checkpoint_write", path=path, epoch=epoch)
    written = _savez(path, arrays)
    manifest = {
        "schema": SCHEMA_VERSION, "layout": "single",
        "file_sha256": _sha256_file(written),
        "leaves": _manifest_leaves(
            {k: arrays[k] for k in arrays if k != "meta"}, dtypes),
        "meta": [float(x) for x in meta],
        "fingerprint": fingerprint,
        "written_unix": int(time.time()),
    }
    _commit(path, written, manifest)
    fault_point("checkpoint_finalize", path=path, epoch=epoch)
    return path


def save_stream_state(directory: str, arrays: dict, cursor: dict,
                      fingerprint: Optional[dict] = None) -> str:
    """Atomically write the streaming trainer's durable state.

    ``arrays`` is a flat name -> leaf dict (the state's ``leaf_i`` and the
    host-side byproducts); ``cursor`` is the JSON (epoch, shard, spool)
    record that makes a mid-epoch resume possible. It rides in the
    manifest, next to the integrity data. The ``stream_ckpt`` seam fires
    after the manifest commits: a sigkill there is a death with a fully
    durable checkpoint whose progress must not be repeated.
    """
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, STREAM_NAME)
    epoch = int(cursor.get("epoch", 0))
    fault_point("checkpoint_write", path=path, epoch=epoch)
    host, dtypes = {}, []
    for k, v in arrays.items():
        host[k], dtype = _to_host(v)
        dtypes.append(dtype)
    written = _savez(path, host)
    manifest = {
        "schema": SCHEMA_VERSION, "layout": "stream",
        "file_sha256": _sha256_file(written),
        "leaves": _manifest_leaves(host, dtypes),
        "cursor": cursor,
        "fingerprint": fingerprint,
        "written_unix": int(time.time()),
    }
    _commit(path, written, manifest)
    fault_point("checkpoint_finalize", path=path, epoch=epoch)
    fault_point("stream_ckpt", path=path, epoch=epoch)
    return path


def _load_manifest(ckpt_path: str) -> Optional[dict]:
    """The sidecar manifest for ``ckpt_path``, or None (missing or
    unreadable: :func:`_verify_single` reports the latter)."""
    try:
        with open(ckpt_path + MANIFEST_SUFFIX) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _check_fingerprint(ckpt_path: str, manifest: Optional[dict],
                       fingerprint: Optional[dict]) -> None:
    """Raise when the manifest records a different config fingerprint than
    the resuming run's: same-shape drift (a changed learning rate, seed,
    dtype) would otherwise silently blend two runs."""
    stored = (manifest or {}).get("fingerprint")
    if not stored or not fingerprint:
        return      # a manifest-less checkpoint, or a caller without one
    diffs = {k: (stored.get(k), fingerprint.get(k))
             for k in set(stored) | set(fingerprint)
             if stored.get(k) != fingerprint.get(k)}
    if diffs:
        shapes = " (these change the checkpoint leaf shapes)" \
            if {"hidden", "n_genes_pad"} & set(diffs) else ""
        raise ValueError(
            f"checkpoint {ckpt_path} was written under a different config — "
            + "; ".join(f"{k}: checkpoint={a!r} vs current={b!r}"
                        for k, (a, b) in sorted(diffs.items()))
            + f"{shapes} — restore the original flags or point "
              "--checkpoint-dir at a fresh directory")


def _verify_single(ckpt_path: str, mpath: Optional[str] = None
                   ) -> Optional[str]:
    """None when ``ckpt_path`` passes verification against the manifest
    ``mpath`` (by default its own; or it has none); else the
    human-readable failure reason."""
    mpath = mpath or ckpt_path + MANIFEST_SUFFIX
    if not os.path.exists(mpath):
        return None     # no manifest: nothing to verify against
    try:
        with open(mpath) as f:
            man = json.load(f)
    except (OSError, ValueError) as e:
        return f"manifest unreadable ({type(e).__name__}: {e})"
    if man.get("schema") != SCHEMA_VERSION:
        return f"unknown manifest schema {man.get('schema')!r}"
    want = man.get("file_sha256")
    if want and _sha256_file(ckpt_path) != want:
        return "file sha256 mismatch (truncated or corrupted write)"
    return None


def _verify_generation(cand: str, path: str
                       ) -> Tuple[Optional[str], Optional[dict]]:
    """``(reason, manifest)`` of the kept generation ``cand`` (``path`` or
    its ``.prev`` twin): verified against its own manifest, else against
    the other generation's. A death between :func:`_commit`'s two renames
    leaves generation N's file at ``.prev`` beside N-1's manifest, while
    N's manifest still has the latest's name; the file's sha256 picks the
    manifest that describes it, so that death loses no generation."""
    reason = _verify_single(cand)
    if reason is None:
        return None, _load_manifest(cand)
    other = (path if cand != path else path + PREV_SUFFIX) + MANIFEST_SUFFIX
    if os.path.exists(other) and _verify_single(cand, other) is None:
        with open(other) as f:
            return None, json.load(f)
    return reason, None


def _verify_leaves(man: Optional[dict], leaves: list) -> Optional[str]:
    """Per-leaf hash check against the manifest (behind the whole-file
    hash: it catches a stale manifest paired with the wrong npz)."""
    if man is None:
        return None
    records = man.get("leaves", [])
    if len(records) != len(leaves):
        return (f"manifest lists {len(records)} leaves, checkpoint holds "
                f"{len(leaves)}")
    for rec, leaf in zip(records, leaves):
        if rec.get("sha256") and _sha256_array(leaf) != rec["sha256"]:
            return f"{rec.get('name', 'leaf')} sha256 mismatch"
    return None


def _read_leaves(path: str, like_leaves) -> Tuple[list, np.ndarray]:
    """Read the npz and check it against the expected leaf shapes."""
    with np.load(path) as data:
        leaves = [data[f"leaf_{i}"] for i in range(len(like_leaves))]
        meta = data["meta"]
    if meta.shape[0] == 3:      # pre-`done` meta: normalize the shape
        meta = np.append(meta, float(RUN_IN_PROGRESS))
    for i, (got, want) in enumerate(zip(leaves, like_leaves)):
        if tuple(got.shape) != tuple(np.shape(want)):
            raise ValueError(
                f"checkpoint {path}: leaf {i} has shape {got.shape}, current "
                f"model expects {tuple(np.shape(want))} — was the config "
                "changed between save and resume?")
    return leaves, meta


def _read_single(directory: str, like_leaves,
                 fingerprint: Optional[dict] = None
                 ) -> Optional[Tuple[list, np.ndarray, Optional[dict]]]:
    """Read with integrity verification and the ``.prev`` fallback: a
    latest checkpoint that fails its manifest (or is an unreadable zip)
    is skipped with a warning and the ``.prev`` twin restored; only when
    every kept generation is bad does this raise, with the reasons."""
    path = os.path.join(directory, CKPT_NAME)
    failures = []
    for cand in (path, path + PREV_SUFFIX):
        if not os.path.exists(cand):
            continue
        reason, man = _verify_generation(cand, path)
        if reason is None:
            # Config drift is structural, not corruption: the .prev twin
            # was written under the same config, so it propagates.
            _check_fingerprint(cand, man, fingerprint)
            try:
                leaves, meta = _read_leaves(cand, like_leaves)
            except ValueError:
                raise           # shape mismatch: structural as well
            except Exception as e:  # noqa: BLE001 — corrupt zip
                reason = f"unreadable ({type(e).__name__}: {e})"
            else:
                reason = _verify_leaves(man, leaves)
                if reason is None:
                    if cand != path:
                        warnings.warn(
                            f"resuming from the previous checkpoint {cand} "
                            "(the latest failed verification) — at most one "
                            "checkpoint interval of progress is repeated",
                            RuntimeWarning)
                    return leaves, meta, man
        failures.append(f"{os.path.basename(cand)}: {reason}")
        warnings.warn(
            f"checkpoint {cand} failed integrity verification ({reason}); "
            "falling back to the previous checkpoint", RuntimeWarning)
    if failures:
        raise ValueError(
            f"no intact checkpoint under {directory} — " + "; ".join(failures)
            + " — every kept generation is corrupt; restart without "
              "--resume to retrain from scratch")
    return None


def _leaf_tensor(arr: np.ndarray, like: torch.Tensor, man: Optional[dict],
                 i: int) -> torch.Tensor:
    records = (man or {}).get("leaves", [])
    stored = records[i].get("dtype") if i < len(records) else str(arr.dtype)
    want = "bfloat16" if like.dtype == torch.bfloat16 else \
        str(like.dtype).replace("torch.", "")
    if stored != want:
        raise ValueError(f"checkpoint leaf {i} is {stored}, the current "
                         f"model expects {want}")
    return to_tensor(arr, want)


def load_state(directory: str, params_like: Sequence, opt_state_like,
               fingerprint: Optional[dict] = None):
    """Restore ``(params, opt_state, snapshot, epoch, before_val,
    before_tr, done)`` as CPU tensors, in the shapes of
    :func:`flatten_state`'s arguments (``params_like``/``opt_state_like``
    are the fresh init's tensors: their shapes and dtypes are checked).
    Returns None when no checkpoint exists; raises ``ValueError`` on a
    fingerprint, shape or dtype mismatch and when every generation is
    corrupt."""
    like = flatten_state(params_like, opt_state_like, params_like)
    like = [torch.as_tensor(x) if not isinstance(x, torch.Tensor) else x
            for x in like]
    like[2] = torch.zeros((), dtype=torch.int32)     # the step count
    loaded = _read_single(directory, like, fingerprint)
    if loaded is None:
        return None
    leaves, meta, man = loaded
    tensors = [_leaf_tensor(a, w, man, i)
               for i, (a, w) in enumerate(zip(leaves, like))]
    params, opt_state, snapshot = unflatten_state(tensors)
    done = int(meta[3]) if meta.shape[0] > 3 else RUN_IN_PROGRESS
    return (params, opt_state, snapshot,
            int(meta[0]), float(meta[1]), float(meta[2]), done)


def load_stream_state(directory: str,
                      fingerprint: Optional[dict] = None
                      ) -> Optional[Tuple[dict, dict]]:
    """Restore ``(arrays, cursor)`` written by :func:`save_stream_state`.

    Verification order: the whole file's sha256, the manifest's cursor,
    each leaf's sha256, then the fingerprint. A latest checkpoint that
    fails any of the first three falls back to the ``.prev`` twin with a
    warning (at most one checkpoint interval is repeated). bfloat16
    leaves come back as bfloat16 tensors, every other leaf as a numpy
    array. Returns None when no stream checkpoint exists; raises when
    every kept generation is corrupt.
    """
    path = os.path.join(directory, STREAM_NAME)
    failures = []
    for cand in (path, path + PREV_SUFFIX):
        if not os.path.exists(cand):
            continue
        reason, man = _verify_generation(cand, path)
        if reason is None and (man is None or "cursor" not in man):
            reason = "missing or cursor-less manifest"
        if reason is None:
            try:
                with np.load(cand) as data:
                    arrays = {k: data[k] for k in data.files}
            except Exception as e:  # noqa: BLE001 — corrupt zip
                reason = f"unreadable ({type(e).__name__}: {e})"
        if reason is None:
            records = {r["name"]: r for r in man.get("leaves", [])}
            if set(records) != set(arrays):
                reason = (f"manifest names {sorted(records)} but checkpoint "
                          f"holds {sorted(arrays)}")
            else:
                for k, arr in arrays.items():
                    if records[k].get("sha256") and \
                            _sha256_array(arr) != records[k]["sha256"]:
                        reason = f"{k} sha256 mismatch"
                        break
        if reason is None:
            _check_fingerprint(cand, man, fingerprint)
            for k, arr in arrays.items():
                if records[k].get("dtype") == "bfloat16":
                    arrays[k] = to_tensor(arr, "bfloat16")
            if cand != path:
                warnings.warn(
                    f"resuming from the previous checkpoint {cand} (the "
                    "latest failed verification) — at most one checkpoint "
                    "interval of progress is repeated", RuntimeWarning)
            return arrays, man["cursor"]
        failures.append(f"{os.path.basename(cand)}: {reason}")
        warnings.warn(
            f"checkpoint {cand} failed integrity verification ({reason}); "
            "falling back to the previous checkpoint", RuntimeWarning)
    if failures:
        raise ValueError(
            f"no intact stream checkpoint under {directory} — "
            + "; ".join(failures)
            + " — every kept generation is corrupt; restart without "
              "--resume to retrain from scratch")
    return None
