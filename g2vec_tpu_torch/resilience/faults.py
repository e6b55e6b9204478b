"""Config/env-driven fault injection at the port's failure seams.

The port's copy of ``g2vec_tpu/resilience/faults.py``: the same plan
grammar, environment variables, kinds, state file and error messages. A
fault plan is one or more ``;``-separated entries of ``,``-separated
``key=value`` pairs::

    G2VEC_FAULT_PLAN="stage=train,epoch=40,kind=crash"
    --fault-plan "stage=paths,kind=sigkill;stage=checkpoint_finalize,kind=corrupt"

Keys:

- ``stage`` (required): the seam name, one of :data:`SEAMS`. Pipeline
  stage boundaries: ``load``, ``preprocess``, ``paths``, ``train``,
  ``lgroups``, ``biomarkers``, ``save``. Trainer epoch loops: ``train``
  with ``epoch=N``. Checkpointing: ``checkpoint_write`` (before the
  write), ``checkpoint_finalize`` (after the atomic rename: the seam for
  ``corrupt``), ``stream_ckpt`` (after a streaming cursor commits; epoch =
  the cursor's epoch). Native libraries: ``native_load`` (TSV parser),
  ``native_walker_load`` (walk sampler). The card's walker:
  ``device_walk`` (between a shard's state init and the kernel launch;
  epoch = shard index). Walk cache: ``walk_cache`` (after a store
  finalizes). Streaming: ``shard_ring`` (the producer, after a shard
  spools; epoch = shard index), ``prefetch`` (the consumer, as it asks
  for the next shard). Serve: ``drain`` (as the daemon begins a drain,
  before its stop flag is set). Query plane: ``ann_build`` (after a
  bundle's manifest is written and before its generation is renamed in;
  ``path`` = the index's postings file, the seam for ``corrupt``).
  Incremental updates: ``update_publish`` (after a bundle's new
  generation is renamed in and before the pointer flips; ``path`` = the
  pointer file). The sharded streaming run: ``allgather`` (a host
  collective, before this rank publishes), ``shard_exchange`` (a walk
  shard's owner, after the walk and before the publish; epoch = shard
  index), ``embed_allreduce`` (before a split step's allreduce; epoch =
  the step count). The edge partition: ``walk_handoff`` (each round of
  the collective walk, before this rank publishes its suspended states;
  epoch = shard index), ``halo_build`` (between the halo want lists and
  the row payloads; epoch = group index).
- ``epoch``: fire only once the hook reports an epoch >= this value.
- ``kind``: ``crash`` (default) raises :class:`InjectedFault`
  (retryable); ``fatal`` raises :class:`InjectedFatal` (fatal);
  ``sigkill`` SIGKILLs the process (no Python cleanup runs: the shape of
  a preemption); ``stall`` sleeps ``seconds`` (default 300) and then
  raises :class:`InjectedFault`; ``corrupt`` flips bytes in the middle of
  the file the seam passes as ``path`` and returns (a torn write the
  writer believes succeeded, found only by verification).
- ``process``: fire only on this rank; the rank is ``G2VEC_PROCESS_ID``,
  else the rank of an initialized multi-process run, else 0.
- ``times``: fire at most this many times (default 1).
- ``skip``: let the first N matching hits pass (default 0).
- ``seconds``: the stall's duration.

The port calls every seam of the JAX package. Fired entries are
recorded in ``G2VEC_FAULT_STATE`` (a JSON file) when that variable is
set, so a one-shot fault stays one shot across process restarts; the supervisor sets it when it sees a plan
and no state path. With no plan installed and none in the environment,
:func:`fault_point` is one falsy check and a return.
"""
from __future__ import annotations

import dataclasses
import json
import os
import signal
import sys
import time
from typing import List, Optional

ENV_PLAN = "G2VEC_FAULT_PLAN"
ENV_STATE = "G2VEC_FAULT_STATE"

KINDS = ("crash", "fatal", "sigkill", "stall", "corrupt")

#: The seams the port calls: the JAX package's.
SEAMS = ("load", "preprocess", "paths", "train", "lgroups", "biomarkers",
         "save", "checkpoint_write", "checkpoint_finalize",
         "native_load", "native_walker_load", "device_walk", "walk_cache",
         "shard_ring", "prefetch", "stream_ckpt", "drain", "ann_build",
         "update_publish", "allgather", "shard_exchange", "embed_allreduce",
         "walk_handoff", "halo_build", "stage_barrier", "heartbeat")


class FaultPlanError(ValueError):
    """A malformed --fault-plan / G2VEC_FAULT_PLAN spec."""


class InjectedFault(RuntimeError):
    """An injected retryable failure (preemption-shaped). A RuntimeError,
    so every layer that degrades on RuntimeError (the native readers fall
    back to Python, the supervisor retries) treats it like the real
    faults it stands in for."""


class InjectedFatal(ValueError):
    """An injected fatal failure (bad-input-shaped): a ValueError, the
    type the readers and the config raise."""


@dataclasses.dataclass
class _Entry:
    stage: str
    kind: str = "crash"
    epoch: Optional[int] = None
    times: int = 1
    skip: int = 0
    seconds: float = 300.0
    process: Optional[int] = None   # only fire on this rank (None = any)
    seen: int = 0       # matching hits so far (this process; drives skip)

    @property
    def key(self) -> str:
        return f"{self.stage}:{self.epoch}:{self.kind}"


# None = environment not consulted yet; [] = consulted, no plan.
_plan: Optional[List[_Entry]] = None
_state_path: Optional[str] = None
_fired: dict = {}          # entry.key -> count, this process
_INJECTED_NOTE = "injected by the G2VEC fault plan"


def parse_plan(spec: str) -> List[_Entry]:
    """Parse a plan spec; raises FaultPlanError with the offending token."""
    entries = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        fields = {}
        for tok in part.split(","):
            if "=" not in tok:
                raise FaultPlanError(
                    f"fault plan token {tok!r} is not key=value (in {part!r})")
            k, v = tok.split("=", 1)
            fields[k.strip()] = v.strip()
        unknown = set(fields) - {"stage", "kind", "epoch", "times", "skip",
                                 "seconds", "process"}
        if unknown:
            raise FaultPlanError(
                f"unknown fault plan keys {sorted(unknown)} in {part!r} "
                "(want stage/kind/epoch/times/skip/seconds/process)")
        if "stage" not in fields:
            raise FaultPlanError(f"fault plan entry {part!r} needs stage=")
        if fields["stage"] not in SEAMS:
            raise FaultPlanError(
                f"unknown fault seam {fields['stage']!r}; seams: "
                f"{', '.join(SEAMS)}")
        kind = fields.get("kind", "crash")
        if kind not in KINDS:
            raise FaultPlanError(
                f"unknown fault kind {kind!r}; kinds: {', '.join(KINDS)}")
        try:
            entries.append(_Entry(
                stage=fields["stage"], kind=kind,
                epoch=int(fields["epoch"]) if "epoch" in fields else None,
                times=int(fields.get("times", 1)),
                skip=int(fields.get("skip", 0)),
                seconds=float(fields.get("seconds", 300.0)),
                process=(int(fields["process"]) if "process" in fields
                         else None)))
        except ValueError as e:
            raise FaultPlanError(
                f"non-numeric epoch/times/skip/seconds/process in {part!r}: "
                f"{e}") from e
    return entries


def install_plan(spec: Optional[str], state_path: Optional[str] = None) -> None:
    """Install (or with ``None``/empty spec, clear) the process fault plan.

    Re-installing the same plan does not reset which entries already fired
    in this process: an in-process supervisor retry must not re-trip a
    once-only fault.
    """
    global _plan, _state_path
    _plan = parse_plan(spec) if spec else []
    if state_path is not None:
        _state_path = state_path


def _load_state() -> dict:
    path = _state_path or os.environ.get(ENV_STATE)
    if not path or not os.path.exists(path):
        return {}
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _record_fired(entry: _Entry) -> None:
    _fired[entry.key] = _fired.get(entry.key, 0) + 1
    path = _state_path or os.environ.get(ENV_STATE)
    if not path:
        return
    state = _load_state()
    state[entry.key] = state.get(entry.key, 0) + 1
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(state, f)
    os.replace(tmp, path)


def _corrupt_file(path: str) -> None:
    """Flip a byte run in the middle of ``path``: a torn write the writer
    never notices. The file length is preserved."""
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        if size < 128:
            f.write(b"\xff" * max(size, 1))
            return
        f.seek(size // 2)
        chunk = f.read(64)
        f.seek(size // 2)
        f.write(bytes(b ^ 0xFF for b in chunk))


def _fire(entry: _Entry, seam: str, epoch: Optional[int],
          path: Optional[str]) -> None:
    where = f"seam={seam}" + (f" epoch={epoch}" if epoch is not None else "")
    # State is recorded before the action: a sigkill leaves no later
    # chance, and a crash must not re-fire on the supervised retry.
    _record_fired(entry)
    if entry.kind == "crash":
        raise InjectedFault(f"injected crash at {where} ({_INJECTED_NOTE})")
    if entry.kind == "fatal":
        raise InjectedFatal(f"injected fatal error at {where} "
                            f"({_INJECTED_NOTE})")
    if entry.kind == "sigkill":
        os.kill(os.getpid(), signal.SIGKILL)
        time.sleep(30)     # unreachable; belt for exotic signal handling
        raise InjectedFault(f"sigkill at {where} did not terminate")
    if entry.kind == "stall":
        time.sleep(entry.seconds)
        raise InjectedFault(
            f"injected stall at {where} expired after {entry.seconds}s "
            f"({_INJECTED_NOTE})")
    if entry.kind == "corrupt":
        if not path or not os.path.exists(path):
            raise InjectedFault(
                f"kind=corrupt at {where} needs a seam that passes a file "
                f"path (checkpoint_write/checkpoint_finalize); got "
                f"path={path!r}")
        _corrupt_file(path)    # silent: the torn write "succeeds"


def current_rank() -> int:
    """The process's rank for ``process=K`` entries: ``G2VEC_PROCESS_ID``,
    else the rank of an initialized multi-process run (never imported for
    the purpose), else 0."""
    pid = os.environ.get("G2VEC_PROCESS_ID")
    if pid is not None:
        try:
            return int(pid)
        except ValueError:
            pass
    dist = sys.modules.get("g2vec_tpu_torch.parallel.distributed")
    return dist.process_index() if dist is not None else 0


def fault_point(seam: str, *, epoch: Optional[int] = None,
                path: Optional[str] = None) -> None:
    """Hook called at every named seam. No-op unless a plan entry matches.

    ``epoch`` qualifies the ``train`` seam and the checkpoint seams;
    ``path`` hands ``corrupt`` faults their target file.
    """
    global _plan
    if _plan is None:
        _plan = parse_plan(os.environ.get(ENV_PLAN, ""))
    if not _plan:
        return
    persisted = _load_state()
    for entry in _plan:
        if entry.stage != seam:
            continue
        if entry.process is not None and entry.process != current_rank():
            continue
        if entry.epoch is not None and (epoch is None or epoch < entry.epoch):
            continue
        fired = max(_fired.get(entry.key, 0), persisted.get(entry.key, 0))
        if fired >= entry.times:
            continue
        entry.seen += 1
        if entry.seen <= entry.skip:
            continue
        _fire(entry, seam, epoch, path)


def _reset_for_tests() -> None:
    """Forget the installed plan, fired counts, and state path."""
    global _plan, _state_path
    _plan = None
    _state_path = None
    _fired.clear()
