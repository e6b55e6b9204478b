"""Checkpoint / resume for the port's trainers.

The port's copy of ``g2vec_tpu/train/checkpoint.py``. The full-batch
trainer's state (params, Adam state, the early-stop snapshot and accuracy
pair, the epoch) round-trips through :func:`save_state`/
:func:`load_state` in one of two layouts; the streaming trainer's through
``stream_state.npz`` with its (epoch, shard) cursor
(:func:`save_stream_state`, :func:`load_stream_state`).

- ``layout="single"``: one atomic ``cbow_state.npz``. In a multi-process
  run rank 0 writes it, and a restore is rank 0's read broadcast over the
  store (:func:`_broadcast_from_coordinator`): every rank gets the same
  leaves, or the same refusal.
- ``layout="sharded"`` (the fleet's resume layout,
  ``g2vec_tpu/train/checkpoint.py:291-563``): each save goes to a fresh
  numbered directory ``cbow_state_sharded.N`` and a ``.LATEST`` pointer
  flips to it atomically; the previous generation is kept and older ones
  pruned; a sibling ``<dir>.manifest.json`` holds each file's size and
  sha256. A load verifies the pointed directory and falls back to the kept
  one. The reference's leaves are orbax OCDBT shards; the port imports no
  orbax, so its leaves are an npz of host arrays, and a reference
  ``cbow_state_ocdbt.*`` directory is refused by name. The port's ranks
  share one card and hold the whole replicated state, so in a
  multi-process run rank 0 writes and the others wait at a store barrier
  (:func:`_save_sharded_fleet`); every rank reads the shared directory
  itself. A resume in the other layout than the checkpoint's is refused.

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
#: The sharded layout's numbered directories (the port's own name).
SHARDED_NAME = "cbow_state_sharded"
#: The JAX package's orbax OCDBT directories, which the port cannot read.
REFERENCE_SHARDED_NAME = "cbow_state_ocdbt"
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
               fingerprint: Optional[dict] = None,
               layout: str = "single") -> str:
    """Atomically write the full-batch trainer's state under
    ``directory`` in ``layout``; returns the checkpoint's path.
    ``fingerprint`` (a flat dict of config scalars) is recorded in the
    manifest and checked on resume. Every rank of a multi-process run
    calls it; rank 0 writes."""
    from g2vec_tpu_torch.parallel import distributed

    meta = np.array([float(epoch), before_val, before_tr, float(done)])
    # Only rank 0 writes: the others skip the copy to the host.
    arrays, dtypes = (
        _state_arrays(flatten_state(params, opt_state, snapshot))
        if distributed.process_index() == 0 else ({}, []))
    if layout == "sharded":
        if distributed.shared_card_fleet():
            return _save_sharded_fleet(directory, arrays, dtypes, meta,
                                       fingerprint)
        return _save_sharded(directory, arrays, dtypes, meta, fingerprint)
    if layout != "single":
        raise ValueError(f"unknown checkpoint layout {layout!r}")
    arrays["meta"] = meta
    path = os.path.join(directory, CKPT_NAME)
    if distributed.process_index() != 0:
        return path
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


# ---------------------------------------------------------------------------
# The sharded layout
# ---------------------------------------------------------------------------

_LATEST_NAME = SHARDED_NAME + ".LATEST"
#: The npz inside a numbered directory: leaf_i, meta, and the manifest
#: dtype of each leaf (bfloat16 leaves are stored as their uint16 bits).
SHARDED_LEAVES = "state.npz"


def _numbered(base: str) -> List[int]:
    if not os.path.isdir(base):
        return []
    return [int(n.rsplit(".", 1)[1]) for n in os.listdir(base)
            if n.startswith(SHARDED_NAME + ".")
            and n.rsplit(".", 1)[1].isdigit()]


def _write_sharded_manifest(path: str, meta: np.ndarray,
                            fingerprint: Optional[dict]) -> None:
    """The manifest of one numbered directory: every file with its size
    and sha256, beside the directory as ``<dir>.manifest.json``."""
    files = {}
    for root, _, names in os.walk(path):
        for n in sorted(names):
            fp = os.path.join(root, n)
            files[os.path.relpath(fp, path)] = {
                "size": os.path.getsize(fp), "sha256": _sha256_file(fp)}
    _write_json_atomic(path + MANIFEST_SUFFIX, {
        "schema": SCHEMA_VERSION, "layout": "sharded", "files": files,
        "meta": [float(x) for x in meta], "fingerprint": fingerprint,
        "written_unix": int(time.time())})


def _save_sharded(directory: str, arrays: dict, dtypes: List[str],
                  meta: np.ndarray, fingerprint: Optional[dict] = None
                  ) -> str:
    """Keep-previous atomic save: the leaves go to a fresh numbered
    directory (written under ``.tmp`` and renamed in), its manifest is
    written, the LATEST pointer flips atomically, and every generation
    but the new one and the newest previous is pruned. A death mid-save
    leaves the previous checkpoint whole."""
    import shutil

    base = os.path.abspath(directory)
    os.makedirs(base, exist_ok=True)
    existing = _numbered(base)
    name = f"{SHARDED_NAME}.{max(existing, default=-1) + 1}"
    path = os.path.join(base, name)
    fault_point("checkpoint_write", path=path, epoch=int(meta[0]))
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, SHARDED_LEAVES), meta=meta,
             dtypes=np.array(dtypes), **arrays)
    os.replace(tmp, path)
    _write_sharded_manifest(path, meta, fingerprint)
    pointer = os.path.join(base, _LATEST_NAME)
    with open(pointer + ".tmp", "w") as f:
        f.write(name)
    os.replace(pointer + ".tmp", pointer)
    for idx in sorted(existing)[:-1]:
        stale = os.path.join(base, f"{SHARDED_NAME}.{idx}")
        shutil.rmtree(stale, ignore_errors=True)
        if os.path.exists(stale + MANIFEST_SUFFIX):
            os.unlink(stale + MANIFEST_SUFFIX)
    fault_point("checkpoint_finalize", path=_largest_file(path),
                epoch=int(meta[0]))
    return path


def _save_sharded_fleet(directory: str, arrays: dict, dtypes: List[str],
                        meta: np.ndarray,
                        fingerprint: Optional[dict] = None) -> str:
    """The sharded save of a multi-process run. The ranks hold the same
    replicated state, so rank 0 alone writes it into the shared
    directory and the others wait at a store barrier, so that none runs
    ahead of a durable save. Every rank then passes the
    ``checkpoint_finalize`` seam (rank 0 inside :func:`_save_sharded`):
    a ``process=K`` fault there lands after the save committed."""
    from g2vec_tpu_torch.parallel import distributed, hostcomm
    from g2vec_tpu_torch.resilience import fleet

    path = directory
    if distributed.process_index() == 0:
        path = _save_sharded(directory, arrays, dtypes, meta, fingerprint)
    hostcomm.barrier("checkpoint_save",
                     deadline=fleet.config().watchdog_deadline or None)
    if distributed.process_index() != 0:
        fault_point("checkpoint_finalize", epoch=int(meta[0]))
    return path


def _largest_file(dirpath: str) -> Optional[str]:
    """The biggest file under ``dirpath``: the ``corrupt`` fault's target
    in the sharded layout."""
    best, best_size = None, -1
    for root, _, names in os.walk(dirpath):
        for n in names:
            fp = os.path.join(root, n)
            size = os.path.getsize(fp)
            if size > best_size:
                best, best_size = fp, size
    return best


def _verify_sharded(dirpath: str) -> Optional[str]:
    """None when ``dirpath`` passes its manifest (or has none); else the
    reason it fails."""
    mpath = dirpath + MANIFEST_SUFFIX
    if not os.path.exists(mpath):
        return None
    try:
        with open(mpath) as f:
            man = json.load(f)
    except (OSError, ValueError) as e:
        return f"manifest unreadable ({type(e).__name__}: {e})"
    if man.get("schema") != SCHEMA_VERSION:
        return f"unknown manifest schema {man.get('schema')!r}"
    for rel, want in man.get("files", {}).items():
        fp = os.path.join(dirpath, rel)
        if not os.path.exists(fp):
            return f"missing shard file {rel}"
        if os.path.getsize(fp) != want.get("size"):
            return (f"shard file {rel} is {os.path.getsize(fp)} bytes, "
                    f"manifest says {want.get('size')} (torn write)")
        if want.get("sha256") and _sha256_file(fp) != want["sha256"]:
            return f"shard file {rel} sha256 mismatch (corrupted bytes)"
    return None


def _latest_sharded_dir(directory: str) -> Optional[str]:
    pointer = os.path.join(os.path.abspath(directory), _LATEST_NAME)
    if not os.path.exists(pointer):
        return None
    with open(pointer) as f:
        target = f.read().strip()
    path = os.path.join(os.path.abspath(directory), target)
    return path if os.path.isdir(path) else None


def _reference_sharded(directory: str) -> Optional[str]:
    """The newest entry of the JAX package's orbax OCDBT layout (its
    numbered directories or their pointer) under ``directory``, or None."""
    base = os.path.abspath(directory)
    if not os.path.isdir(base):
        return None
    names = sorted(n for n in os.listdir(base)
                   if n.startswith(REFERENCE_SHARDED_NAME + "."))
    return os.path.join(base, names[-1]) if names else None


def _sharded_candidates(directory: str) -> List[str]:
    """Restore candidates, best first: the LATEST pointer's directory,
    then the other numbered directories newest first."""
    base = os.path.abspath(directory)
    ordered = []
    pointed = _latest_sharded_dir(directory)
    if pointed is not None:
        ordered.append(pointed)
    for idx in sorted(_numbered(base), reverse=True):
        p = os.path.join(base, f"{SHARDED_NAME}.{idx}")
        if p != pointed and os.path.isdir(p):
            ordered.append(p)
    found = None if ordered else _reference_sharded(directory)
    if found:
        raise ValueError(
            f"{found} is of {REFERENCE_SHARDED_NAME!r}: the JAX package's "
            f"orbax OCDBT sharded layout, which g2vec_tpu_torch does not "
            f"read (its sharded leaves are npz files under "
            f"{SHARDED_NAME}.N) — point --checkpoint-dir at a fresh "
            f"directory")
    return ordered


def _load_sharded(directory: str, like_leaves,
                  fingerprint: Optional[dict] = None
                  ) -> Optional[Tuple[list, np.ndarray, List[str]]]:
    """Restore the newest numbered directory that verifies: a candidate
    failing its manifest is skipped with a warning and the previous one
    tried; every candidate failing raises."""
    candidates = _sharded_candidates(directory)
    if not candidates:
        return None
    path, failures = None, []
    for cand in candidates:
        reason = _verify_sharded(cand)
        if reason is None:
            path = cand
            break
        failures.append(f"{os.path.basename(cand)}: {reason}")
        warnings.warn(
            f"checkpoint {cand} failed integrity verification ({reason}); "
            "trying the previous numbered checkpoint", RuntimeWarning)
    if path is None:
        raise ValueError(
            f"no intact sharded checkpoint under {directory} — "
            + "; ".join(failures)
            + " — every kept generation is corrupt; restart without "
              "--resume to retrain from scratch")
    if path != candidates[0]:
        warnings.warn(
            f"resuming from the previous checkpoint {path} (the latest "
            "failed verification) — at most one checkpoint interval of "
            "progress is repeated", RuntimeWarning)
    _check_fingerprint(path, _load_manifest(path), fingerprint)
    return _restore_sharded_dir(path, like_leaves)


def _restore_sharded_dir(path: str, like_leaves
                         ) -> Tuple[list, np.ndarray, List[str]]:
    with np.load(os.path.join(path, SHARDED_LEAVES)) as data:
        leaves = [data[f"leaf_{i}"] for i in range(len(like_leaves))]
        meta, dtypes = data["meta"], [str(d) for d in data["dtypes"]]
    for i, (got, want) in enumerate(zip(leaves, like_leaves)):
        if tuple(got.shape) != tuple(np.shape(want)):
            raise ValueError(
                f"checkpoint {path}: leaf {i} has shape {got.shape}, "
                f"current model expects {tuple(np.shape(want))} — was the "
                "config changed between save and resume?")
    return leaves, meta, dtypes


def _refuse_other_layout(directory: str, layout: str) -> None:
    """A resume that finds the other layout's checkpoint (and none of its
    own) raises: starting over would skip the terminal guard."""
    if layout == "single" and (_latest_sharded_dir(directory)
                               or _reference_sharded(directory)):
        raise ValueError(
            f"{directory} holds a 'sharded' checkpoint but the resume "
            "asked for layout 'single' — pass --checkpoint-layout "
            "sharded (or the matching checkpoint_layout argument)")
    if layout == "sharded" and os.path.exists(os.path.join(directory,
                                                           CKPT_NAME)):
        raise ValueError(
            f"{directory} holds a 'single' checkpoint but the resume "
            "asked for layout 'sharded' — pass --checkpoint-layout "
            "single (or the matching checkpoint_layout argument)")


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


def _manifest_dtypes(man: Optional[dict], leaves: list) -> List[str]:
    """Each leaf's stored dtype: the manifest's, else the array's own."""
    records = (man or {}).get("leaves", [])
    return [records[i].get("dtype") if i < len(records) else str(a.dtype)
            for i, a in enumerate(leaves)]


def _leaf_tensor(arr: np.ndarray, like: torch.Tensor, stored: str,
                 i: int) -> torch.Tensor:
    want = "bfloat16" if like.dtype == torch.bfloat16 else \
        str(like.dtype).replace("torch.", "")
    if stored != want:
        raise ValueError(f"checkpoint leaf {i} is {stored}, the current "
                         f"model expects {want}")
    return to_tensor(arr, want)


def _broadcast_from_coordinator(directory: str, like_leaves,
                                fingerprint: Optional[dict] = None
                                ) -> Optional[Tuple[list, np.ndarray,
                                                    List[str]]]:
    """Rank 0 reads the single layout (verification and the ``.prev``
    fallback included) and every rank receives the same state over the
    store: status 0 (no checkpoint), 1 (the leaves) or 2 (rank 0's
    error, which every rank then raises), so a failed read never leaves
    the other ranks in a half-entered collective."""
    import io

    from g2vec_tpu_torch.parallel import distributed, hostcomm
    from g2vec_tpu_torch.resilience import fleet

    payload = None
    if distributed.process_index() == 0:
        status, arrays, err = 0, {}, ""
        try:
            loaded = _read_single(directory, like_leaves, fingerprint)
            if loaded is not None:
                leaves, meta, man = loaded
                status = 1
                arrays = {f"leaf_{i}": a for i, a in enumerate(leaves)}
                arrays.update(meta=meta, dtypes=np.array(
                    _manifest_dtypes(man, leaves)))
        # Broad on purpose: any failed read must reach the broadcast.
        except Exception as e:  # noqa: BLE001
            status, arrays, err = 2, {}, f"{type(e).__name__}: {e}"
        buf = io.BytesIO()
        np.savez(buf, status=np.int32(status), err=np.array(err), **arrays)
        payload = buf.getvalue()
    payload = hostcomm.broadcast_bytes(
        "checkpoint_restore", payload,
        deadline=fleet.config().watchdog_deadline or None)
    with np.load(io.BytesIO(payload)) as data:
        status, err = int(data["status"]), str(data["err"])
        if status == 0:
            return None
        if status == 2:
            raise ValueError(f"checkpoint restore failed on the "
                             f"coordinator: {err or '(see rank 0 logs)'}")
        leaves = [data[f"leaf_{i}"] for i in range(len(like_leaves))]
        return leaves, data["meta"], [str(d) for d in data["dtypes"]]


def load_state(directory: str, params_like: Sequence, opt_state_like,
               fingerprint: Optional[dict] = None, layout: str = "single"):
    """Restore ``(params, opt_state, snapshot, epoch, before_val,
    before_tr, done)`` as CPU tensors, in the shapes of
    :func:`flatten_state`'s arguments (``params_like``/``opt_state_like``
    are the fresh init's tensors: their shapes and dtypes are checked).
    Returns None when no checkpoint exists; raises ``ValueError`` on a
    fingerprint, shape or dtype mismatch, when every generation is
    corrupt, and when the directory holds the other layout's checkpoint.
    Every rank of a multi-process run calls it."""
    from g2vec_tpu_torch.parallel import distributed

    like = flatten_state(params_like, opt_state_like, params_like)
    like = [torch.as_tensor(x) if not isinstance(x, torch.Tensor) else x
            for x in like]
    like[2] = torch.zeros((), dtype=torch.int32)     # the step count
    if layout == "sharded":
        loaded = _load_sharded(directory, like, fingerprint)
    elif layout != "single":
        raise ValueError(f"unknown checkpoint layout {layout!r}")
    elif distributed.process_count() > 1:
        loaded = _broadcast_from_coordinator(directory, like, fingerprint)
    else:
        loaded = _read_single(directory, like, fingerprint)
        if loaded is not None:
            leaves, meta, man = loaded
            loaded = leaves, meta, _manifest_dtypes(man, leaves)
    if loaded is None:
        _refuse_other_layout(directory, layout)
        return None
    leaves, meta, dtypes = loaded
    tensors = [_leaf_tensor(a, w, d, i)
               for i, (a, w, d) in enumerate(zip(leaves, like, dtypes))]
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
