"""L0 — configuration and CLI of the port's solo run.

The reference CLI (ref: G2Vec.py:505-518): four positional arguments plus
``-p/-r/-s/-e/-l/-n`` with the same defaults, and the framework flags the
port's solo run reads: the full-batch and streaming trainers, the stage
overlap, the native reader, the metrics stream, the walker backend and
the walk cache, checkpoint/resume, fault injection and the supervisor,
the patient cohort and permutation flags, the batch engine's
``--manifest``/``--seeds``/``--lanes``, the scenario engine's
``--scenario``/``--replicates``/``--folds``/``--scenario-seed``, and the
query plane's
``--emit-inventory``/``--ann-nlist``, and the streaming run's scale
flags: ``--walk-starts`` and the sharded run over R processes
(``--graph-shards``/``--embed-shards``, ``--distributed`` with
``--coordinator``/``--process-id``/``--num-processes``, and
``--fleet-watchdog-deadline``, the collectives' deadline), with the edge
partition of its graph (``--edge-partition off|handoff|halo``), and the
fleet: ``--mesh DATAxMODEL`` over ranks that share the card,
``--checkpoint-layout single|sharded``, and the launcher and liveness
flags ``--fleet-size``, ``--fleet-devices-per-rank``,
``--fleet-liveness-dir``, ``--fleet-heartbeat-interval`` and
``--fleet-straggler-factor``. It also
holds
the serve daemon's
job schema (:data:`SERVE_JOB_KEYS`, :func:`config_from_job`,
:func:`serve_join_key`).
Defaults and validation are those of ``g2vec_tpu/config.py``; ``--device``
is the port's own (``cuda`` unless the caller asks for ``cpu``), and a
fleet's ranks inherit it.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass
class G2VecConfig:
    """Configuration of one run of the port (or the base of a batch).

    Reference-compatible options keep the reference's camelCase names.
    """

    # ---- positional (ref: G2Vec.py:508-511) ----
    expression_file: str = ""
    clinical_file: str = ""
    network_file: str = ""
    result_name: str = "result"

    # ---- reference options (ref: G2Vec.py:512-517) ----
    lenPath: int = 80                # max random-walk length
    numRepetition: int = 10          # walks started from every gene, per group
    sizeHiddenlayer: int = 128       # embedding width
    epoch: int = 500                 # max epochs (honored, unlike the reference)
    learningRate: float = 0.005      # Adam lr
    numBiomarker: int = 50           # top-N per L-group

    # ---- silent constants promoted to config ----
    pcc_threshold: float = 0.5       # edge kept iff |PCC| > threshold (ref: G2Vec.py:389)
    val_fraction: float = 0.2        # hold-out fraction (ref: G2Vec.py:220)
    display_step: int = 5            # epoch log cadence (ref: G2Vec.py:254)
    n_lgroups: int = 3               # k-means k (ref: G2Vec.py:169)
    kmeans_seed: int = 0             # ref: random_state=0 (G2Vec.py:169)
    kmeans_iters: int = 300          # Lloyd iterations (sklearn's cap)
    decision_threshold: float = 0.5  # sigmoid(O) > t (ref: G2Vec.py:249)
    score_mix: float = 0.5           # gene score = mix*d + (1-mix)*t (ref: G2Vec.py:102)

    # ---- framework flags ----
    seed: int = 0                    # walk seed (the reference is unseeded)
    train_seed: Optional[int] = None  # split/init seed; None = seed
    patient_subsample: float = 0.0   # fraction of patients kept per label
                                     # class (stratified, seeded; 0 = off)
    subsample_seed: int = 0          # seed of the patient cohort draws
    subsample_mode: str = "fraction"  # cohort: "fraction" keeps a seeded
                                     # stratified subset; "bootstrap" draws
                                     # the same count per class with
                                     # replacement (fraction 0 = the full
                                     # class size); "fold" trains on every
                                     # fold but cv_fold of a seeded
                                     # stratified cv_folds partition
    cv_folds: int = 0                # partition size for subsample_mode
                                     # "fold" (0 otherwise)
    cv_fold: int = 0                 # held-out fold in [0, cv_folds)
    permute_seed: Optional[int] = None  # permutation null: stage 6 scores
                                     # against labels shuffled with this
                                     # seed; walks and training keep the
                                     # observed labels (None = off)
    compat_lgroup_tiebreak: bool = False
    compute_dtype: str = "bfloat16"  # bf16 runs the packed kernels; float32
                                     # runs the dense torch.matmul path
    param_dtype: str = "float32"
    walker_backend: str = "auto"     # "auto": the C++ sampler when it
                                     # builds, else the card's walker;
                                     # "native"/"device" pin one. Both walk
                                     # the same splitmix64 streams: rows,
                                     # outputs and walk-cache entries are
                                     # byte-identical
                                     # (ops/device_walker.py). Streaming
                                     # on "device" walks epoch 0's shards
                                     # in the training loop and trains on
                                     # them where they lie (train/stream.py)
    sampler_threads: int = 0         # host threads of the C++ sampler
                                     # (0 = all cores; walks are identical
                                     # at any count)
    overlap: bool = True             # stage overlap (parallel/overlap.py):
                                     # both groups' walks at once, the
                                     # card's first use warmed in the
                                     # background; never changes results
    train_mode: str = "full"         # "full": the reference's full-batch
                                     # trainer. "streaming": walk shards
                                     # stream from the sampler through a
                                     # bounded ring into minibatch SGD
                                     # (train/stream.py); statistical
                                     # contract against full, not bitwise
    shard_paths: int = 0             # rows per streaming walk shard, both
                                     # groups (0 = auto, 4096); also the
                                     # minibatch size
    prefetch_depth: int = 2          # bounded shard-ring depth; the
                                     # producer blocks when this many
                                     # shards wait unconsumed
    stream_patience: int = 5         # streaming early stop: epochs without
                                     # a strict val-ACC gain (1 = the
                                     # full-batch first-dip rule)
    stream_eval_rows: int = 0        # streaming val/probe buffer row cap
                                     # (0 = 4096)
    graph_shards: int = 0            # cut the streaming shard sequence into
                                     # this many start-gene partitions, each
                                     # walked by one rank and exchanged to
                                     # the rest over the store (0 = every
                                     # rank walks everything)
    embed_shards: int = 0            # split the [G, H] embedding by a
                                     # byte-aligned gene range per rank
                                     # (must equal the process count; 0 =
                                     # off)
    walk_starts: int = 0             # cap the start genes a group at an
                                     # evenly spaced subset (0 = every
                                     # gene, the reference's walk volume)
    edge_partition: str = "off"      # partition the CSR itself by gene
                                     # range (parallel/shard.py): a rank
                                     # reads and holds only its own rows'
                                     # edges. Walks that leave the range:
                                     # "handoff" ships the suspended walk
                                     # state to the rank holding the row;
                                     # "halo" also replicates the 1-hop
                                     # boundary rows. The same bytes either
                                     # way; "off" = every rank holds all
    metrics_jsonl: Optional[str] = None  # structured per-stage/epoch records
    profile_dir: Optional[str] = None  # torch.profiler trace of the run
                                     # (CPU + CUDA) as DIR/trace.json
    debug_nans: bool = False         # raise at the first non-finite loss
                                     # or gradient, naming it
    cache_dir: Optional[str] = None  # walk cache root: stage-3 path sets
                                     # under <dir>/walks (cache.py)
    kernel_autotune: bool = False    # measure the packed kernels' tile
                                     # plans (forward layout, backward
                                     # slice count) at this run's exact
                                     # shapes on the card instead of
                                     # trusting the heuristic (persisted
                                     # under --cache-dir's autotune tier)
    emit_inventory: bool = False     # also publish the binary query-plane
                                     # bundle <RESULT_NAME>_inventory/
                                     # (float32 embeddings + norms +
                                     # scores + gene table + sha256
                                     # manifest: io/writers.py), so an
                                     # offline run is servable by
                                     # pointing `serve --inventory-dir`
                                     # at its directory
    ann_nlist: int = 0               # IVF list count for the bundle's ANN
                                     # index: 0 auto (~sqrt(G) past the
                                     # row floor), >0 forced, <0 disabled
                                     # (ops/ann.resolve_nlist)
    use_native_io: bool = True       # the C++ expression and network
                                     # readers (fall back to Python with
                                     # a warning when they cannot be
                                     # built or loaded)
    device: str = "cuda"             # cuda unless the caller asks for cpu
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 25       # full-batch: epochs between trainer
                                     # checkpoints; streaming: shard updates
                                     # between cursor checkpoints (and one
                                     # at every epoch boundary)
    resume: bool = False             # restore the newest verified
                                     # checkpoint under checkpoint_dir

    # ---- multi-process (parallel/distributed.py) ----
    distributed: bool = False        # join the multi-process run (rank 0
                                     # hosts the store the collectives use)
    coordinator: Optional[str] = None  # host:port of rank 0 (or env)
    process_id: Optional[int] = None
    num_processes: Optional[int] = None
    fleet_watchdog_deadline: float = 0.0  # collective deadline, seconds
                                     # (0 = block); a missed one names
                                     # the rank that never published
    mesh_shape: Optional[Tuple[int, int]] = None  # (data, model); None =
                                     # no mesh. Over R processes the
                                     # global plan holds R devices (the
                                     # ranks share the card), each rank a
                                     # replicated 1x1 local mesh
    # "single": one npz (rank 0 writes; a multi-process restore is rank 0's
    # read, broadcast). "sharded": numbered directories of npz leaves with
    # a LATEST pointer and the previous generation kept (the fleet's
    # resume layout).
    checkpoint_layout: str = "single"

    # ---- fleet (resilience/fleet.py) ----
    fleet_size: int = 0              # >0: launch and supervise this many
                                     # ranks with degraded-mesh resume
    fleet_devices_per_rank: int = 0  # devices each rank holds (0 = mesh
                                     # size / fleet size; at most what one
                                     # rank sees)
    fleet_liveness_dir: Optional[str] = None  # heartbeat/liveness files
    fleet_heartbeat_interval: float = 1.0  # seconds between beats
    fleet_straggler_factor: float = 0.0    # warn when a rank exceeds this
                                     # x the median stage time (0 = off)

    # ---- resilience (resilience/) ----
    supervise: bool = False          # wrap the run in the auto-resume
                                     # supervisor (bounded retries, backoff,
                                     # re-enter via --resume)
    supervise_retries: int = 3       # retries after the first failure
    supervise_backoff: float = 1.0   # backoff base seconds (doubles/retry)
    fault_plan: Optional[str] = None  # injection spec, e.g.
                                     # "stage=train,epoch=40,kind=crash"
                                     # (resilience/faults.py docstring)

    # ---- batch engine (batch/engine.py) ----
    manifest: Optional[str] = None   # JSON list of variant objects over
                                     # this base config, run as lanes
    batch_seeds: int = 0             # --seeds N: an N-variant seed sweep
                                     # (train and k-means seeds vary, the
                                     # walk seed stays; 0 = off)
    lanes: int = 8                   # most lanes trained in one bucket
                                     # (a larger bucket splits)

    # ---- scenario engine (stats/) ----
    scenario: Optional[str] = None   # bootstrap|permutation|cv: a seeded
                                     # replicate manifest over this base
                                     # config, run as lanes and reduced
                                     # into <RESULT_NAME>_stability.txt
    replicates: int = 0              # replicates of bootstrap/permutation
    folds: int = 0                   # folds of cv (K >= 2)
    scenario_seed: int = 0           # root of the seed tree
                                     # (stats/plan.py derive_seed)

    def validate(self) -> None:
        if self.lenPath < 1:
            raise ValueError(f"lenPath must be >= 1, got {self.lenPath}")
        if self.numRepetition < 1:
            raise ValueError(f"numRepetition must be >= 1, got {self.numRepetition}")
        if self.sizeHiddenlayer < 1:
            raise ValueError(f"sizeHiddenlayer must be >= 1, got {self.sizeHiddenlayer}")
        if self.epoch < 1:
            raise ValueError(f"epoch must be >= 1, got {self.epoch}")
        if self.learningRate <= 0.0:
            raise ValueError(f"learningRate must be > 0, got {self.learningRate}")
        if self.numBiomarker < 1:
            raise ValueError(f"numBiomarker must be >= 1, got {self.numBiomarker}")
        if self.mesh_shape is not None and any(d < 1 for d in self.mesh_shape):
            raise ValueError(f"mesh axes must be >= 1, got {self.mesh_shape}")
        if self.n_lgroups < 3:
            raise ValueError(
                f"n_lgroups must be >= 3 (good/poor/other), got {self.n_lgroups}")
        if self.display_step < 1:
            raise ValueError(f"display_step must be >= 1, got {self.display_step}")
        if not (0.0 < self.decision_threshold < 1.0):
            raise ValueError(
                f"decision_threshold must be in (0,1), got {self.decision_threshold}")
        if not (0.0 < self.val_fraction < 1.0):
            raise ValueError(f"val_fraction must be in (0,1), got {self.val_fraction}")
        if not (0.0 <= self.pcc_threshold < 1.0):
            raise ValueError(f"pcc_threshold must be in [0,1), got {self.pcc_threshold}")
        if self.compute_dtype not in ("bfloat16", "float32"):
            raise ValueError(f"compute_dtype must be bfloat16|float32, got {self.compute_dtype}")
        if self.param_dtype not in ("bfloat16", "float32"):
            raise ValueError(f"param_dtype must be bfloat16|float32, got {self.param_dtype}")
        if self.walker_backend not in ("auto", "device", "native"):
            raise ValueError(
                f"walker_backend must be auto|device|native, "
                f"got {self.walker_backend}")
        if self.sampler_threads < 0:
            raise ValueError(
                f"sampler_threads must be >= 0 (0 = all cores), "
                f"got {self.sampler_threads}")
        if self.train_mode not in ("full", "streaming"):
            raise ValueError(
                f"train_mode must be full|streaming, got {self.train_mode}")
        if self.shard_paths < 0:
            raise ValueError(
                f"shard_paths must be >= 0 (0 = auto), got {self.shard_paths}")
        if 0 < self.shard_paths < 4:
            raise ValueError(
                f"shard_paths must be >= 4 (2 per group, and the per-shard "
                f"split needs both sides non-empty), got {self.shard_paths}")
        if self.prefetch_depth < 1:
            raise ValueError(
                f"prefetch_depth must be >= 1, got {self.prefetch_depth}")
        if self.stream_patience < 1:
            raise ValueError(
                f"stream_patience must be >= 1, got {self.stream_patience}")
        if self.stream_eval_rows < 0:
            raise ValueError(
                f"stream_eval_rows must be >= 0 (0 = default), "
                f"got {self.stream_eval_rows}")
        if self.device.split(":")[0] not in ("cuda", "cpu"):
            raise ValueError(f"device must be cuda[:N] or cpu, got {self.device}")
        if self.train_mode == "streaming" and self.resume \
                and not self.checkpoint_dir:
            raise ValueError(
                "--resume with --train-mode streaming needs "
                "--checkpoint-dir: the streaming cursor lives there")
        if self.checkpoint_every < 1:
            raise ValueError(
                f"checkpoint_every must be >= 1, got {self.checkpoint_every}")
        if self.train_mode == "streaming":
            if self.walker_backend == "device" and (
                    self.graph_shards or self.embed_shards):
                raise ValueError(
                    "sharded streaming (--graph-shards/--embed-shards) "
                    "needs the native sampler's thread pool per rank; "
                    "--walker-backend device does not compose")
            # The sharded mode is streaming x distributed: --graph-shards/
            # --embed-shards open that gate; fleet and mesh stay closed.
            gates = [(self.fleet_size, "--fleet-size"),
                     (self.mesh_shape, "--mesh")]
            if not (self.graph_shards or self.embed_shards):
                gates.insert(0, (self.distributed, "--distributed"))
            for flag, name in gates:
                if flag:
                    raise ValueError(
                        f"--train-mode streaming does not compose with "
                        f"{name} yet — the streaming trainer is a "
                        f"single-device minibatch loop per rank "
                        f"(--graph-shards/--embed-shards is the "
                        f"multi-process form)")
            if self.checkpoint_dir and self.checkpoint_layout != "single":
                raise ValueError(
                    "--train-mode streaming checkpoints use the single-file "
                    "layout only (--checkpoint-layout single)")
        for field in ("graph_shards", "embed_shards", "walk_starts"):
            if getattr(self, field) < 0:
                raise ValueError(
                    f"{field} must be >= 0 (0 = off/default), "
                    f"got {getattr(self, field)}")
        if self.graph_shards or self.embed_shards:
            if self.train_mode != "streaming":
                raise ValueError(
                    "--graph-shards/--embed-shards shard the STREAMING "
                    "trainer; add --train-mode streaming")
            if self.checkpoint_dir or self.resume:
                raise ValueError(
                    "sharded streaming does not compose with "
                    "--checkpoint-dir/--resume yet — the cursor would have "
                    "to be a consistent distributed snapshot")
            if self.manifest or self.batch_seeds:
                raise ValueError(
                    "sharded streaming does not compose with the batch "
                    "engine (--manifest/--seeds)")
            if self.supervise:
                raise ValueError(
                    "sharded streaming does not compose with --supervise "
                    "yet — a retried rank cannot rejoin the fleet's "
                    "collectives mid-run")
            if self.embed_shards and self.num_processes \
                    and self.embed_shards != self.num_processes:
                raise ValueError(
                    f"--embed-shards ({self.embed_shards}) must equal "
                    f"--num-processes ({self.num_processes}): the gene "
                    f"range is split 1:1 across ranks")
        if self.edge_partition not in ("off", "handoff", "halo"):
            raise ValueError(
                f"edge_partition must be off|handoff|halo, "
                f"got {self.edge_partition}")
        if self.edge_partition != "off":
            if self.train_mode != "streaming":
                raise ValueError(
                    "--edge-partition partitions the STREAMING trainer's "
                    "walk graph; add --train-mode streaming")
            if self.walker_backend == "device":
                raise ValueError(
                    "--edge-partition's owner-range handoff transport "
                    "still drives the native partial walker; "
                    "--walker-backend device (and --device-feed) are "
                    "refused until the handoff transport is ported to "
                    "the device sampler's suspend/resume states")
            if self.num_processes and self.num_processes > 1 \
                    and not self.graph_shards:
                raise ValueError(
                    "multi-rank --edge-partition rides the graph-sharded "
                    "producer's shard exchange; add --graph-shards")
            if self.checkpoint_dir or self.resume:
                raise ValueError(
                    "--edge-partition does not compose with "
                    "--checkpoint-dir/--resume yet — suspended cross-rank "
                    "walk state is not checkpointable")
        if self.checkpoint_layout not in ("single", "sharded"):
            raise ValueError(
                f"checkpoint_layout must be single|sharded, "
                f"got {self.checkpoint_layout}")
        if self.supervise_retries < 0:
            raise ValueError(
                f"supervise_retries must be >= 0, got {self.supervise_retries}")
        if self.supervise_backoff < 0.0:
            raise ValueError(
                f"supervise_backoff must be >= 0, got {self.supervise_backoff}")
        if self.fleet_size < 0 or self.fleet_size == 1:
            raise ValueError(
                f"fleet_size must be 0 (off) or >= 2, got {self.fleet_size}")
        if self.fleet_devices_per_rank < 0:
            raise ValueError(
                f"fleet_devices_per_rank must be >= 0, "
                f"got {self.fleet_devices_per_rank}")
        if self.fleet_heartbeat_interval <= 0.0:
            raise ValueError(
                f"fleet_heartbeat_interval must be > 0, "
                f"got {self.fleet_heartbeat_interval}")
        if self.fleet_watchdog_deadline < 0.0:
            raise ValueError(
                f"fleet_watchdog_deadline must be >= 0, "
                f"got {self.fleet_watchdog_deadline}")
        if self.fleet_straggler_factor < 0.0:
            raise ValueError(
                f"fleet_straggler_factor must be >= 0, "
                f"got {self.fleet_straggler_factor}")
        if self.fleet_size and self.checkpoint_dir \
                and self.checkpoint_layout != "sharded":
            raise ValueError(
                "--fleet-size with --checkpoint-dir requires "
                "--checkpoint-layout sharded: degraded-mesh resume reads the "
                "sharded layout (rank 0 reads, the survivors receive its "
                "leaves)")
        if self.fleet_size and self.mesh_shape:
            total = self.mesh_shape[0] * self.mesh_shape[1]
            per = self.fleet_devices_per_rank or total // self.fleet_size
            if per * self.fleet_size != total:
                raise ValueError(
                    f"--fleet-size {self.fleet_size} cannot evenly host the "
                    f"{total}-device mesh {self.mesh_shape} "
                    f"({per} devices/rank)")
        if not (0.0 <= self.patient_subsample <= 1.0):
            raise ValueError(
                f"patient_subsample must be 0 (off) or in (0,1], "
                f"got {self.patient_subsample}")
        if self.subsample_mode not in ("fraction", "bootstrap", "fold"):
            raise ValueError(
                f"subsample_mode must be fraction|bootstrap|fold, "
                f"got {self.subsample_mode}")
        if self.subsample_mode == "fold":
            if self.cv_folds < 2:
                raise ValueError(
                    f"--subsample-mode fold needs --cv-folds >= 2, "
                    f"got {self.cv_folds}")
            if not (0 <= self.cv_fold < self.cv_folds):
                raise ValueError(
                    f"--cv-fold must be in [0, {self.cv_folds}), "
                    f"got {self.cv_fold}")
            if self.patient_subsample:
                raise ValueError(
                    "--subsample-mode fold derives the cohort from the fold "
                    "partition; --patient-subsample must be 0")
        elif self.cv_folds or self.cv_fold:
            raise ValueError(
                "--cv-folds/--cv-fold are only meaningful with "
                "--subsample-mode fold")
        if self.permute_seed is not None and self.permute_seed < 0:
            raise ValueError(
                f"--permute-seed must be >= 0, got {self.permute_seed}")
        if self.replicates < 0:
            raise ValueError(
                f"--replicates must be >= 0, got {self.replicates}")
        if self.folds < 0:
            raise ValueError(f"--folds must be >= 0, got {self.folds}")
        if self.scenario is not None:
            if self.scenario not in ("bootstrap", "permutation", "cv"):
                raise ValueError(
                    f"--scenario must be bootstrap|permutation|cv, "
                    f"got {self.scenario}")
            if self.manifest or self.batch_seeds:
                raise ValueError(
                    "--scenario IS a generated manifest; it is mutually "
                    "exclusive with --manifest/--seeds")
            if self.train_mode != "full":
                raise ValueError(
                    "--scenario executes replicates as batched full-mode "
                    "lanes; --train-mode streaming does not compose")
            if self.subsample_mode != "fraction" \
                    or self.permute_seed is not None:
                raise ValueError(
                    "--scenario derives the per-replicate cohort/"
                    "permutation axes itself; leave --subsample-mode/"
                    "--permute-seed at their defaults")
            if self.scenario == "cv":
                if self.folds < 2:
                    raise ValueError(
                        f"--scenario cv needs --folds >= 2, "
                        f"got {self.folds}")
                if self.replicates:
                    raise ValueError(
                        "--scenario cv sizes itself with --folds, not "
                        "--replicates")
                if self.patient_subsample:
                    raise ValueError(
                        "--scenario cv derives each cohort from the fold "
                        "partition; --patient-subsample must be 0")
            else:
                if self.replicates < 1:
                    raise ValueError(
                        f"--scenario {self.scenario} needs "
                        f"--replicates >= 1, got {self.replicates}")
                if self.folds:
                    raise ValueError(
                        "--folds is only meaningful with --scenario cv")
        elif self.replicates or self.folds:
            raise ValueError("--replicates/--folds need --scenario")
        if self.batch_seeds < 0:
            raise ValueError(
                f"--seeds must be >= 0, got {self.batch_seeds}")
        if self.lanes < 1:
            raise ValueError(f"--lanes must be >= 1, got {self.lanes}")
        if self.manifest and self.batch_seeds:
            raise ValueError(
                "--manifest and --seeds are mutually exclusive (a manifest "
                "already enumerates its variants)")
        if self.manifest or self.batch_seeds or self.scenario:
            for flag, name in ((self.distributed, "--distributed"),
                               (self.fleet_size, "--fleet-size"),
                               (self.supervise, "--supervise"),
                               (self.checkpoint_dir, "--checkpoint-dir"),
                               (self.resume, "--resume"),
                               (self.profile_dir, "--profile-dir"),
                               (self.debug_nans, "--debug-nans")):
                if flag:
                    raise ValueError(
                        f"the batch engine (--manifest/--seeds/--scenario) "
                        f"does not compose with {name} yet — run lanes as "
                        f"separate supervised jobs instead")
        if self.fault_plan:
            # Fail at config time with the offending token, not mid-run.
            from g2vec_tpu_torch.resilience.faults import parse_plan

            parse_plan(self.fault_plan)


#: G2VecConfig fields a serve job's ``base`` object may set: the JAX
#: package's list (``g2vec_tpu/config.py``) without the fields the port
#: has no counterpart for (``walker_batch``, ``walker_hbm_budget``,
#: ``fused_eval``, ``epoch_superstep``, ``donate_state``, ``device_feed``).
#: Everything else (the device, cache roots, checkpointing, supervision)
#: is daemon infrastructure a tenant must not reach through a job
#: submission: serve/daemon.py builds the execution config from its own
#: flags plus exactly these per-job fields.
SERVE_JOB_KEYS = (
    "expression_file", "clinical_file", "network_file", "result_name",
    "lenPath", "numRepetition", "sizeHiddenlayer", "epoch", "learningRate",
    "numBiomarker", "pcc_threshold", "val_fraction", "display_step",
    "n_lgroups", "kmeans_seed", "kmeans_iters", "decision_threshold",
    "score_mix", "seed", "train_seed", "patient_subsample",
    "subsample_seed", "subsample_mode", "cv_folds", "cv_fold",
    "permute_seed", "compat_lgroup_tiebreak", "compute_dtype",
    "param_dtype", "walker_backend", "sampler_threads", "use_native_io",
    "lanes",
    # Streaming trainer: a tenant may pick the mode and its shard/ring
    # geometry; the daemon still owns the device. Jobs with different
    # train_mode never join (serve_join_key), so a streaming job cannot
    # be folded into a full-batch bucket. graph_shards/embed_shards/
    # walk_starts/edge_partition/stream_eval_rows are absent on purpose:
    # the sharded mode spans processes, and the fleet's shape is the
    # daemon's infrastructure, not a job's knob.
    "train_mode", "shard_paths", "prefetch_depth", "stream_patience",
    # Streaming checkpoint cadence (shards between cursor writes). The
    # daemon owns where checkpoints go (its state dir); a job may only
    # tune how often its own cursor is cut.
    "checkpoint_every")

_SERVE_JOB_REQUIRED = ("expression_file", "clinical_file", "network_file",
                       "result_name")

#: Config fields left out of the serve job-join key: per-lane variant
#: axes (concrete on each LaneVariant by plan time), output locations and
#: daemon-owned infrastructure. Everything else must coincide for two
#: jobs to share one engine batch.
SERVE_JOIN_EXCLUDE = frozenset({
    "result_name", "metrics_jsonl", "manifest", "batch_seeds",
    "seed", "train_seed", "kmeans_seed", "learningRate", "epoch",
    "patient_subsample", "subsample_seed",
    "subsample_mode", "cv_folds", "cv_fold", "permute_seed",
    "cache_dir", "profile_dir", "fault_plan"})


def serve_join_key(cfg: G2VecConfig) -> Tuple:
    """The batch-compatibility key of a serve job's config: the daemon
    merges queued jobs whose keys are equal into one engine batch."""
    return tuple((f.name, repr(getattr(cfg, f.name)))
                 for f in dataclasses.fields(cfg)
                 if f.name not in SERVE_JOIN_EXCLUDE)


def config_from_job(base: dict, defaults: Optional[G2VecConfig] = None
                    ) -> G2VecConfig:
    """A validated :class:`G2VecConfig` from a serve job's ``base`` dict.

    Only :data:`SERVE_JOB_KEYS` may appear; an unknown or infrastructure
    key raises ``ValueError`` naming it (a job typo must be rejected at
    admission, not die mid-batch). ``defaults`` seeds the non-job fields
    (the daemon passes its own config, the device among them).
    """
    if not isinstance(base, dict):
        raise ValueError(
            f"job base must be an object, got {type(base).__name__}")
    unknown = sorted(set(base) - set(SERVE_JOB_KEYS))
    if unknown:
        raise ValueError(
            f"job base has unknown/forbidden key(s) {unknown}; "
            f"allowed: {sorted(SERVE_JOB_KEYS)}")
    missing = [k for k in _SERVE_JOB_REQUIRED
               if not base.get(k) or not isinstance(base.get(k), str)]
    if missing:
        raise ValueError(
            f"job base must set non-empty string(s) for {missing}")
    cfg = dataclasses.replace(defaults if defaults is not None
                              else G2VecConfig(), **base)
    cfg.validate()
    return cfg


def build_parser() -> argparse.ArgumentParser:
    """CLI mirroring the reference parser (ref: G2Vec.py:505-518)."""
    from g2vec_tpu_torch import __version__

    parser = argparse.ArgumentParser(
        prog="g2vec-tpu-torch",
        description=(
            "g2vec_tpu_torch: the PyTorch/CUDA port of g2vec_tpu, a "
            "network-based deep learning framework for identifying "
            "prognostic gene signatures (biomarkers). Reference "
            "capabilities: mathcom/G2Vec (Sci. Reports 8.1, 2018)."),
    )
    parser.add_argument("EXPRESSION_FILE", type=str,
                        help="Tab-delimited file for gene expression profiles.")
    parser.add_argument("CLINICAL_FILE", type=str,
                        help="Tab-delimited file for patient's clinical data. "
                             "LABEL=0:good prognosis and 1:poor prognosis.")
    parser.add_argument("NETWORK_FILE", type=str,
                        help="Tab-delimited file for gene interaction network.")
    parser.add_argument("RESULT_NAME", type=str,
                        help="Results are saved as 1) *_biomarkers.txt, "
                             "2) *_lgroups.txt, and 3) *_vectors.txt")
    parser.add_argument("-p", "--lenPath", type=int, default=80)
    parser.add_argument("-r", "--numRepetition", type=int, default=10)
    parser.add_argument("-s", "--sizeHiddenlayer", type=int, default=128)
    parser.add_argument("-e", "--epoch", type=int, default=500)
    parser.add_argument("-l", "--learningRate", type=float, default=0.005)
    parser.add_argument("-n", "--numBiomarker", type=int, default=50)
    parser.add_argument("--version", action="version",
                        version=f"%(prog)s {__version__}")
    parser.add_argument("--seed", type=int, default=0,
                        help="Walk seed (the reference is unseeded).")
    parser.add_argument("--train-seed", type=int, default=None,
                        help="Trainer split/init seed (default: --seed).")
    parser.add_argument("--kmeans-seed", type=int, default=0,
                        help="Stage-5 k-means seed (ref: random_state=0).")
    parser.add_argument("--patient-subsample", type=float, default=0.0,
                        metavar="FRAC",
                        help="Keep this fraction of patients per label "
                             "class (stratified, seeded by "
                             "--subsample-seed; 0 = off).")
    parser.add_argument("--subsample-seed", type=int, default=0)
    parser.add_argument("--subsample-mode", type=str, default="fraction",
                        choices=("fraction", "bootstrap", "fold"),
                        help="Cohort derivation. 'fraction' (default): a "
                             "seeded stratified --patient-subsample subset "
                             "without replacement. 'bootstrap': the same "
                             "count per label class drawn with replacement "
                             "(fraction 0 means the full class size). "
                             "'fold': train on every fold except --cv-fold "
                             "of a seeded stratified --cv-folds partition.")
    parser.add_argument("--cv-folds", type=int, default=0, metavar="K",
                        help="Stratified partition size for "
                             "--subsample-mode fold (K >= 2).")
    parser.add_argument("--cv-fold", type=int, default=0, metavar="I",
                        help="Held-out fold index in [0, K) for "
                             "--subsample-mode fold.")
    parser.add_argument("--permute-seed", type=int, default=None,
                        help="Permutation null: shuffle the patient labels "
                             "with this seed for the stage-6 scoring only; "
                             "walks and training keep the observed labels.")
    parser.add_argument("--manifest", type=str, default=None, metavar="JSON",
                        help="Batch run manifest: a JSON list of variant "
                             "objects (name/seed/train_seed/kmeans_seed/"
                             "learningRate/epoch/patient_subsample/"
                             "subsample_seed/subsample_mode/cv_folds/"
                             "cv_fold/permute_seed overrides of this base "
                             "config), run as lanes; each lane writes the "
                             "files its solo run writes.")
    parser.add_argument("--seeds", type=int, default=0, metavar="N",
                        dest="batch_seeds",
                        help="Run an N-lane seed sweep (train and k-means "
                             "seeds vary; the walk seed stays, so all lanes "
                             "share one walk product per group).")
    parser.add_argument("--lanes", type=int, default=8, metavar="B",
                        help="Most lanes trained in one bucket, on one "
                             "launch of each kernel a step (default 8); a "
                             "larger bucket splits.")
    parser.add_argument("--scenario", type=str, default=None,
                        choices=("bootstrap", "permutation", "cv"),
                        help="Scenario engine: expand this base config into "
                             "a seeded replicate manifest (bootstrap patient "
                             "resamples, label-permutation nulls or "
                             "stratified CV folds), run it as lanes and "
                             "reduce the replicates' outputs into "
                             "RESULT_NAME_stability.txt.")
    parser.add_argument("--replicates", type=int, default=0, metavar="N",
                        help="Replicates of --scenario bootstrap|permutation.")
    parser.add_argument("--folds", type=int, default=0, metavar="K",
                        help="Folds of --scenario cv (K >= 2; one lane a "
                             "held-out fold).")
    parser.add_argument("--scenario-seed", type=int, default=0,
                        help="Root of the scenario's seed tree: every "
                             "replicate's seed is a hash of (root, index, "
                             "role), so a rerun is byte-identical.")
    parser.add_argument("--kmeans-iters", type=int, default=300,
                        help="Lloyd iterations per k-means restart.")
    parser.add_argument("--pcc-threshold", type=float, default=0.5)
    parser.add_argument("--val-fraction", type=float, default=0.2)
    parser.add_argument("--decision-threshold", type=float, default=0.5)
    parser.add_argument("--display-step", type=int, default=5)
    parser.add_argument("--n-lgroups", type=int, default=3)
    parser.add_argument("--compat-lgroup-tiebreak", action="store_true",
                        help="Reproduce the reference's degenerate L-group vote.")
    parser.add_argument("--score-mix", type=float, default=0.5)
    parser.add_argument("--compute-dtype", type=str, default="bfloat16",
                        choices=["bfloat16", "float32"])
    parser.add_argument("--param-dtype", type=str, default="float32",
                        choices=["bfloat16", "float32"])
    parser.add_argument("--walker-backend", type=str, default="auto",
                        choices=("auto", "device", "native"),
                        help="Path sampler. 'auto' (default): the threaded "
                             "C++ CSR sampler when it builds on this host, "
                             "else the card's walker kernel. "
                             "'device'/'native' pin one; both walk the same "
                             "splitmix64 streams, so their rows and outputs "
                             "are byte-identical. With --train-mode "
                             "streaming, 'device' walks each shard of epoch "
                             "0 on the card and trains on it there: no host "
                             "ring, no upload of training rows.")
    parser.add_argument("--sampler-threads", type=int, default=0,
                        help="Host threads of the C++ walk sampler (0 = all "
                             "cores); walks are bit-identical at any count.")
    parser.add_argument("--train-mode", type=str, default="full",
                        choices=("full", "streaming"),
                        help="full (default): the reference's full-batch "
                             "trainer. streaming: walk shards stream from "
                             "the sampler through a bounded ring into "
                             "minibatch SGD; training starts before "
                             "sampling ends (statistical parity with full, "
                             "bitwise deterministic within the mode).")
    parser.add_argument("--shard-paths", type=int, default=0, metavar="N",
                        help="Rows per streaming walk shard / minibatch "
                             "(both groups; 0 = auto, 4096).")
    parser.add_argument("--prefetch-depth", type=int, default=2,
                        metavar="D",
                        help="Bounded shard-ring depth for --train-mode "
                             "streaming (default 2); the sampler blocks "
                             "when D shards wait unconsumed.")
    parser.add_argument("--stream-patience", type=int, default=5,
                        metavar="K",
                        help="Streaming early stop: stop after K epochs "
                             "without a strict val-ACC gain and return the "
                             "best epoch's snapshot (default 5).")
    parser.add_argument("--stream-eval-rows", type=int, default=0,
                        metavar="M",
                        help="Rows kept for the streaming val and probe "
                             "buffers (0 = 4096).")
    parser.add_argument("--walk-starts", type=int, default=0, metavar="W",
                        help="Cap the walk volume to W evenly spaced start "
                             "genes instead of all G (0 = all genes, the "
                             "previous behavior exactly). Graphs of 10^5+ "
                             "genes need this: the full walk volume scales "
                             "with G x reps x len.")
    parser.add_argument("--edge-partition", type=str, default="off",
                        choices=("off", "handoff", "halo"),
                        help="Partition the CSR itself by owner gene range: "
                             "each rank streams only its own rows' edges "
                             "from disk (never the full edge list; the "
                             "network may be a --partitions manifest). "
                             "Boundary-crossing walks: 'handoff' ships the "
                             "suspended walk state to the owner rank; "
                             "'halo' also replicates 1-hop boundary rows "
                             "so most walks finish locally. Outputs are "
                             "byte-identical either way. Requires "
                             "--train-mode streaming; multi-rank runs also "
                             "need --graph-shards (default off).")
    parser.add_argument("--graph-shards", type=int, default=0, metavar="N",
                        help="Scale-out: partition walk sampling into N "
                             "start-gene ranges; each walk shard is sampled "
                             "once by its owner rank and published to peers "
                             "over the store (0 = off, every rank samples "
                             "everything). Requires --train-mode streaming; "
                             "multi-rank runs also need --distributed.")
    parser.add_argument("--embed-shards", type=int, default=0, metavar="R",
                        help="Scale-out: shard the [G, H] embedding table "
                             "across R ranks by byte-aligned gene range; "
                             "the hidden activation is allreduced once per "
                             "step and stages 5-6 run on the local slice "
                             "(0 = off). R must equal the process count; "
                             "single-rank sharded runs are byte-identical "
                             "to unsharded ones.")
    parser.add_argument("--distributed", action="store_true",
                        help="Join a multi-process run: rank 0 hosts the "
                             "store at --coordinator, the others connect "
                             "(also from G2VEC_COORDINATOR, "
                             "G2VEC_PROCESS_ID, G2VEC_NUM_PROCESSES). Only "
                             "rank 0 writes the files.")
    parser.add_argument("--coordinator", type=str, default=None,
                        metavar="HOST:PORT",
                        help="Address of rank 0's store for --distributed.")
    parser.add_argument("--process-id", type=int, default=None,
                        help="This process's rank for --distributed.")
    parser.add_argument("--num-processes", type=int, default=None,
                        help="The rank count for --distributed.")
    parser.add_argument("--fleet-watchdog-deadline", type=float, default=0.0,
                        metavar="SECONDS",
                        help="Deadline of each host collective (0 = block); "
                             "a missed one raises PeerTimeoutError naming "
                             "the rank that never published.")
    parser.add_argument("--mesh", type=str, default=None,
                        metavar="DATAxMODEL",
                        help="Device mesh shape, e.g. 2x1 (data x model). "
                             "With --distributed over R processes that "
                             "share the card the global plan holds R "
                             "devices; each rank trains replicated on a 1x1 "
                             "local mesh and the native walks are split "
                             "over the ranks.")
    parser.add_argument("--checkpoint-layout", type=str, default="single",
                        choices=("single", "sharded"),
                        help="single: one npz (rank 0 writes, a "
                             "multi-process restore is rank 0's read "
                             "broadcast); sharded: numbered directories of "
                             "npz leaves with a LATEST pointer (dir shared "
                             "by the ranks).")
    parser.add_argument("--fleet-size", type=int, default=0, metavar="N",
                        help="Launch and supervise an N-rank fleet with "
                             "degraded-mesh resume: on peer death the mesh "
                             "is re-planned over the surviving devices and "
                             "the fleet relaunches with --resume from the "
                             "sharded checkpoint (0 = off).")
    parser.add_argument("--fleet-devices-per-rank", type=int, default=0,
                        help="Devices each fleet rank holds (0 = mesh size "
                             "/ fleet size); refused above what one rank "
                             "sees (the ranks share this host's card).")
    parser.add_argument("--fleet-liveness-dir", type=str, default=None,
                        metavar="DIR",
                        help="Shared dir for per-rank heartbeat/liveness "
                             "files; enables the heartbeat thread and "
                             "names a timed-out peer's phase and last "
                             "collective (the fleet launcher creates one "
                             "when unset).")
    parser.add_argument("--fleet-heartbeat-interval", type=float,
                        default=1.0,
                        help="Seconds between liveness beats (default 1).")
    parser.add_argument("--fleet-straggler-factor", type=float, default=0.0,
                        help="Warn (straggler_warning metrics event) when "
                             "a rank's stage time exceeds this multiple of "
                             "the fleet median; 0 disables.")
    parser.add_argument("--no-overlap", action="store_true",
                        help="Run the stages one after the other: walk the "
                             "groups in turn and warm nothing in the "
                             "background. Results are identical either "
                             "way.")
    parser.add_argument("--cache-dir", type=str, default=None, metavar="DIR",
                        help="Walk cache root: sha256-verified stage-3 path "
                             "sets under DIR/walks; a repeat run at the "
                             "same inputs and walk parameters skips the "
                             "walks.")
    parser.add_argument("--kernel-autotune", action="store_true",
                        help="Time the packed kernels' candidate plans (the "
                             "forward's layouts, the backward's slice "
                             "counts) on the card at this run's exact "
                             "matmul shapes and launch the fastest instead "
                             "of the heuristic plan (persisted under "
                             "--cache-dir/autotune so repeat runs skip the "
                             "sweep). A run on the CPU or at float32 runs "
                             "no packed kernel and skips it.")
    parser.add_argument("--metrics-jsonl", type=str, default=None,
                        help="Write structured per-stage/per-epoch metrics "
                             "here.")
    parser.add_argument("--profile-dir", type=str, default=None,
                        help="Write a torch.profiler trace of the run (CPU "
                             "and CUDA activity, one range per stage) to "
                             "DIR/trace.json.")
    parser.add_argument("--debug-nans", action="store_true",
                        help="Raise at the first non-finite loss or "
                             "gradient and name it (autograd anomaly mode "
                             "names the backward op that made a NaN); the "
                             "default run does no such check.")
    parser.add_argument("--emit-inventory", action="store_true",
                        help="Also publish RESULT_NAME_inventory/, the "
                             "query plane's binary bundle (float32 "
                             "embeddings + row norms + prognostic scores "
                             "+ gene table, sha256-manifested), the bytes "
                             "the serve daemon publishes for the same "
                             "config; `serve --inventory-dir` makes it "
                             "queryable.")
    parser.add_argument("--ann-nlist", type=int, default=0, metavar="N",
                        help="IVF list count for --emit-inventory's ANN "
                             "index: 0 (default) auto-sizes to ~sqrt(G) "
                             "once the bundle clears the row floor, N>0 "
                             "forces N lists, N<0 disables the build. "
                             "Seeded from the run's k-means centroids "
                             "when shapes permit.")
    parser.add_argument("--no-native-io", action="store_true",
                        help="Parse the expression and network files in "
                             "Python, not with the C++ readers.")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu. Without a card, a cuda "
                             "run raises instead of falling back.")
    parser.add_argument("--checkpoint-dir", type=str, default=None,
                        metavar="DIR",
                        help="Save the trainer's state under DIR (one "
                             "sha256-manifested npz, the previous one kept "
                             "as .prev); streaming also keeps its shard "
                             "spool there.")
    parser.add_argument("--checkpoint-every", type=int, default=25,
                        help="Epochs between full-batch checkpoints, shard "
                             "updates between streaming cursor checkpoints "
                             "(default 25).")
    parser.add_argument("--resume", action="store_true",
                        help="Continue from the newest verified checkpoint "
                             "under --checkpoint-dir; the outputs are the "
                             "uninterrupted run's bytes.")
    parser.add_argument("--supervise", action="store_true",
                        help="Run under the auto-resume supervisor: bounded "
                             "retries with exponential backoff; retryable "
                             "failures (preemption, OOM, worker death, a "
                             "killed process, a CUDA error) re-run with "
                             "--resume in a fresh process, fatal ones (bad "
                             "input, config errors) stop at once.")
    parser.add_argument("--supervise-retries", type=int, default=3,
                        help="Retry budget for --supervise (default 3).")
    parser.add_argument("--supervise-backoff", type=float, default=1.0,
                        help="Backoff base seconds for --supervise; doubles "
                             "per retry, jittered (default 1.0).")
    parser.add_argument("--fault-plan", type=str, default=None,
                        metavar="SPEC",
                        help="Inject faults at named seams, e.g. "
                             "'stage=train,epoch=40,kind=crash' "
                             "(kinds: crash|fatal|sigkill|stall|corrupt; "
                             "equivalently env G2VEC_FAULT_PLAN).")
    return parser


def parse_mesh(spec: Optional[str]) -> Optional[Tuple[int, int]]:
    if spec is None:
        return None
    try:
        d, m = spec.lower().split("x")
        return (int(d), int(m))
    except Exception as e:
        raise ValueError(f"--mesh must look like 4x2, got {spec!r}") from e


def config_from_args(argv=None) -> G2VecConfig:
    args = build_parser().parse_args(argv)
    cfg = G2VecConfig(
        expression_file=args.EXPRESSION_FILE,
        clinical_file=args.CLINICAL_FILE,
        network_file=args.NETWORK_FILE,
        result_name=args.RESULT_NAME,
        lenPath=args.lenPath,
        numRepetition=args.numRepetition,
        sizeHiddenlayer=args.sizeHiddenlayer,
        epoch=args.epoch,
        learningRate=args.learningRate,
        numBiomarker=args.numBiomarker,
        pcc_threshold=args.pcc_threshold,
        val_fraction=args.val_fraction,
        display_step=args.display_step,
        n_lgroups=args.n_lgroups,
        kmeans_seed=args.kmeans_seed,
        kmeans_iters=args.kmeans_iters,
        decision_threshold=args.decision_threshold,
        score_mix=args.score_mix,
        seed=args.seed,
        train_seed=args.train_seed,
        patient_subsample=args.patient_subsample,
        subsample_seed=args.subsample_seed,
        subsample_mode=args.subsample_mode,
        cv_folds=args.cv_folds,
        cv_fold=args.cv_fold,
        permute_seed=args.permute_seed,
        manifest=args.manifest,
        batch_seeds=args.batch_seeds,
        lanes=args.lanes,
        scenario=args.scenario,
        replicates=args.replicates,
        folds=args.folds,
        scenario_seed=args.scenario_seed,
        compat_lgroup_tiebreak=args.compat_lgroup_tiebreak,
        compute_dtype=args.compute_dtype,
        param_dtype=args.param_dtype,
        walker_backend=args.walker_backend,
        sampler_threads=args.sampler_threads,
        overlap=not args.no_overlap,
        train_mode=args.train_mode,
        shard_paths=args.shard_paths,
        prefetch_depth=args.prefetch_depth,
        stream_patience=args.stream_patience,
        stream_eval_rows=args.stream_eval_rows,
        graph_shards=args.graph_shards,
        embed_shards=args.embed_shards,
        walk_starts=args.walk_starts,
        edge_partition=args.edge_partition,
        distributed=args.distributed,
        coordinator=args.coordinator,
        process_id=args.process_id,
        num_processes=args.num_processes,
        fleet_watchdog_deadline=args.fleet_watchdog_deadline,
        mesh_shape=parse_mesh(args.mesh),
        checkpoint_layout=args.checkpoint_layout,
        fleet_size=args.fleet_size,
        fleet_devices_per_rank=args.fleet_devices_per_rank,
        fleet_liveness_dir=args.fleet_liveness_dir,
        fleet_heartbeat_interval=args.fleet_heartbeat_interval,
        fleet_straggler_factor=args.fleet_straggler_factor,
        cache_dir=args.cache_dir,
        kernel_autotune=args.kernel_autotune,
        metrics_jsonl=args.metrics_jsonl,
        profile_dir=args.profile_dir,
        debug_nans=args.debug_nans,
        emit_inventory=args.emit_inventory,
        ann_nlist=args.ann_nlist,
        use_native_io=not args.no_native_io,
        device=args.device,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        resume=args.resume,
        supervise=args.supervise,
        supervise_retries=args.supervise_retries,
        supervise_backoff=args.supervise_backoff,
        fault_plan=args.fault_plan,
    )
    cfg.validate()
    return cfg
