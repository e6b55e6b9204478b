"""The seven-stage solo run of the port.

Drives L0-L6 in the reference's order (ref: main, G2Vec.py:11-120) with
the reference's console transcript (README.md:21-49) — the same lines as
``g2vec_tpu/pipeline.py``: stage banners ``>>> N. ...``, the indented
preprocessing counts, the epoch log cadence and the saved-file listing.
Stages 3 (edge weights), 4 (trainer, on the packed Hopper kernels in
bf16) and 5-6 (k-means, scores) run on ``cfg.device``; the walks run on
the host's C++ sampler or, with ``--walker-backend device``, on the
card's walker kernel (``ops/device_walker.py``; the same rows, byte for
byte); the embedding stays on the device from the trainer through stage
6. With ``--cache-dir`` each group's path set is looked up in the walk
cache (``cache.py``) and stored there on a miss.

``cfg.train_mode == "streaming"`` merges stages 3 and 4 as the JAX
package does (``g2vec_tpu/pipeline.py:400-597``): the sampler emits walk
shards into the streaming trainer (:mod:`.train.stream`) on the overlap
scheduler, and stage 4's byproducts replace stage 3's path set.

With ``cfg.overlap`` (the default) native work that releases the
interpreter lock runs on the overlap scheduler's threads: the kernel
library's nvcc build and, with ``--kernel-autotune``, the tiles library's
(each joined before its first launch, where its error is raised), the C++
parse of the expression file (the foreground creates the CUDA context
meanwhile), the streaming producer. The card's other first
use (each op's first launch) is paid where it falls: a torch op holds the
interpreter lock while it launches, so a warm-up on one thread only takes
turns with the Python on another, and one in the foreground cost more
than it saved (``first_use_probe.py``, PERF.md). The outputs are the same
bytes either way.

A run's patient cohort (``--patient-subsample``, ``--subsample-mode
bootstrap|fold``) is drawn at stage 2 from the matched labels, as the JAX
package draws it (``g2vec_tpu/pipeline.py:281-307``); a permutation null
(``--permute-seed``) shuffles the labels stage 6 scores against, and
nothing else (``:893-900``). The batch engine (``batch/engine.py``) runs
many such configs as lanes and writes each one's solo bytes.

Durable runs (the JAX package's ``pipeline.py:160-221``): ``--fault-plan``
is installed at entry and the stage seams (``load`` ... ``save``) fire at
the start of each stage; ``--checkpoint-dir``/``--resume``/
``--checkpoint-every`` pass to the trainer, so a resumed run walks stage 3
again (or hits ``--cache-dir``) and then restores training; a resumed
run's metrics stream is appended to, so the supervisor's ``retry`` and
``resume`` events and every attempt's records form one stream.

Scale (``g2vec_tpu/pipeline.py:166-240, 399-440, 543, 819-935``):
``--walk-starts`` caps a streaming run's start genes; ``--distributed``
joins a multi-process run (:mod:`.parallel.distributed`) in which only
rank 0 narrates, streams metrics and writes files; ``--graph-shards``/
``--embed-shards`` build the shard context the streaming trainer takes
(:mod:`.parallel.shard`). Under an embed split stages 5-6 run on the
rank's gene range (``analysis.find_lgroups_sharded``/
``biomarker_scores_sharded``), the score and L-group vectors are
gathered at the writers, and the vectors file is written by rank 0 from
every rank's slice (``io.writers.write_vectors_sharded``); the
``[G, H]`` table never exists on one rank, so ``--emit-inventory`` is
skipped there.

The fleet (``g2vec_tpu/pipeline.py:166-239, 345-366, 644-656``): the
``--fleet-*`` flags configure ``resilience/fleet.py``; the heartbeat runs
for the whole run, each stage notes its phase, and under
``--distributed`` a stage barrier follows each stage, so a rank that
died mid-stage is named at the next stage edge. ``--distributed --mesh``
over R processes that share the card trains replicated, one 1x1 local
mesh a rank (:func:`_mesh_context`), splits the native walks over the
ranks (``parallel.distributed.sharded_native_path_set``), and writes the
single-process run's bytes from rank 0; the trainer then runs without
fused eval, and ``--checkpoint-layout`` picks its checkpoints' layout.

The edge partition (``--edge-partition handoff|halo``, streaming only;
``g2vec_tpu/pipeline.py:261-339, 450-508``): stage 1 reads the network's
gene names alone, stage 2 reads the edges whose source lies in this
rank's range of the common genes (:func:`preprocess_range`), and stage 3
builds each group's partial CSR from its thresholded owned edges, with
the halo rows in halo mode (:func:`build_edge_partition`). At more than
one rank the streaming trainer walks every shard as a collective over
them; at one rank the range is the whole graph and the run writes the
plain run's bytes. The ``edge_partition``, ``halo`` and ``handoff``
events report it.

The result carries stage 5's k-means centres and stage 6's ``[2, G]``
score matrix for the query plane: ``--emit-inventory`` publishes them
with the embeddings as ``<result_name>_inventory/`` at stage 7
(``io/writers.write_inventory_bundle``), as ``g2vec_tpu/pipeline.py:
947-975`` does, and the serve daemon publishes a served lane's bundle
from them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from g2vec_tpu_torch.config import G2VecConfig
from g2vec_tpu_torch.device import resolve_device
from g2vec_tpu_torch.io.readers import (load_clinical, load_expression,
                                        load_network, load_network_range,
                                        scan_network_genes)
from g2vec_tpu_torch.preprocess import (find_common_genes, make_gene2idx,
                                        match_labels, permute_labels,
                                        restrict_data, restrict_network,
                                        select_cohort)
from g2vec_tpu_torch.resilience import fleet
from g2vec_tpu_torch.resilience.faults import fault_point, install_plan
from g2vec_tpu_torch.utils.timing import StageTimer, span


@dataclasses.dataclass
class PipelineResult:
    genes: np.ndarray            # [G] str — global sorted-intersection order
    embeddings: np.ndarray       # [G, hidden] float32
    lgroup_idx: np.ndarray       # [G] int32 in {0 good, 1 poor, 2 other}
    biomarkers: List[str]
    output_files: List[str]
    n_samples: int = 0
    n_genes: int = 0
    n_edges: int = 0
    n_paths: int = 0
    n_path_genes: int = 0
    train_history: List[dict] = dataclasses.field(default_factory=list)
    stop_epoch: int = 0
    acc_val: float = 0.0
    stage_seconds: Dict[str, float] = dataclasses.field(default_factory=dict)
    stage_extras: Dict[str, Dict] = dataclasses.field(default_factory=dict)
    overlap_saved_s: Dict[str, float] = dataclasses.field(default_factory=dict)
    stream_stats: Dict = dataclasses.field(default_factory=dict)
    device: str = ""
    walker_backend: str = ""     # the resolved stage-3 sampler, "native" or
                                 # "device" (the config may say "auto")
    sampler_threads: int = 0     # the C++ sampler's threads (0: device)
    walk_cache_hits: List[str] = dataclasses.field(default_factory=list)
                                 # groups whose walks the cache served
    paths: Optional[np.ndarray] = None   # [n_paths, ceil(G/8)] uint8 stage-3
                                         # rows (full-batch mode only)
    labels: Optional[np.ndarray] = None  # [n_paths] 0 good / 1 poor
    biomarker_scores: Optional[np.ndarray] = None
                                 # [2, G] float32 prognostic scores (good
                                 # row 0, poor row 1): the query plane's
                                 # topk_biomarkers vector, kept so the
                                 # serve daemon publishes the bundle
                                 # without recomputing stage 6
    km_centers: Optional[np.ndarray] = None
                                 # [k, hidden] float32 stage-5 k-means
                                 # centres (winning restart): they seed
                                 # the bundle's IVF coarse quantiser


def _emit_inventory(cfg: G2VecConfig, w_ih: np.ndarray, genes, scores2,
                    km_centers, metrics, console) -> str:
    """``--emit-inventory``: publish ``<result_name>_inventory/`` and its
    ``inventory`` and ``ann_build`` metrics events, as the JAX package's
    solo run does."""
    from g2vec_tpu_torch.io.writers import write_inventory_bundle

    bundle_root = cfg.result_name + "_inventory"
    gen_dir = write_inventory_bundle(
        bundle_root, np.asarray(w_ih, dtype=np.float32), list(genes),
        scores2, {"source": "solo",
                  "result_name": os.path.basename(cfg.result_name)},
        ann_nlist=cfg.ann_nlist, seed_centroids=km_centers)
    console("    %s" % gen_dir)
    name = os.path.basename(bundle_root)
    metrics.emit("inventory", bundle=name,
                 bytes=sum(os.path.getsize(os.path.join(gen_dir, f))
                           for f in os.listdir(gen_dir)),
                 outcome="published")
    with open(os.path.join(gen_dir, "meta.json")) as mf:
        ann_meta = json.load(mf).get("ann")
    if ann_meta:
        metrics.emit("ann_build", bundle=name, nlist=ann_meta.get("nlist"),
                     outcome="built", ms=ann_meta.get("build_ms"),
                     seeded=ann_meta.get("seeded"), postings=len(genes))
    else:
        metrics.emit("ann_build", bundle=name, nlist=0, outcome="skipped")
    return gen_dir


class _EpochReporter:
    """The reference's epoch log cadence (ref: G2Vec.py:269-278): a line
    whenever ``step % display_step == 0`` with the wall time since the
    previous printed line; on early stop ``Epoch(stop)`` reports the
    PREVIOUS epoch's accuracies."""

    def __init__(self, console: Callable[[str], None], display_step: int):
        self.console = console
        self.display_step = display_step
        self.block_secs = 0.0

    def on_epoch(self, step: int, acc_val: float, acc_tr: float, secs: float) -> None:
        self.block_secs += secs
        if step % self.display_step == 0:
            self.console("    - Epoch: %03d\tACC[val]=%.4f\tACC[tr]=%.4f (%.3f sec)"
                         % (step, acc_val, acc_tr, self.block_secs))
            self.block_secs = 0.0

    def on_stop(self, stop_epoch: int, acc_val: float, acc_tr: float) -> None:
        self.console("    - Epoch(stop): %03d\tACC[val]=%.4f\tACC[tr]=%.4f (%.3f sec)"
                     % (stop_epoch, acc_val, acc_tr, self.block_secs))


def read_inputs(cfg: G2VecConfig, overlap=None,
                while_parsing: Optional[Callable[[], None]] = None,
                genes_only: bool = False):
    """Stage 1: the expression, clinical and network files. With an
    overlap scheduler and the native reader, the C++ parse of the
    expression file runs on a scheduler thread while this thread runs
    ``while_parsing()`` and reads the other two files (the network's C++
    parse releases the interpreter lock, so the two parses run at once).
    ``genes_only``
    (``--edge-partition``) reads only the network's endpoint names, as a
    set: the edges are read at stage 2, range-filtered. Each read is a
    span of the active stage."""
    def expression():
        with span("read_expression"):
            return load_expression(cfg.expression_file,
                                   use_native=cfg.use_native_io)

    background = overlap is not None and cfg.use_native_io
    if background:
        overlap.submit("read_expression", expression)
    if while_parsing is not None:
        while_parsing()
    with span("read_clinical"):
        clinical = load_clinical(cfg.clinical_file)
    with span("read_network"):
        network = (scan_network_genes(cfg.network_file) if genes_only
                   else load_network(cfg.network_file,
                                     use_native=cfg.use_native_io))
    data = overlap.result("read_expression") if background else expression()
    return data, clinical, network


def preprocess_inputs(data, clinical, network):
    """Stage 2: labels matched to samples, both inputs restricted to the
    common genes; returns ``(data, src, dst)`` with the edges as indices
    into ``data.gene``."""
    data.label = match_labels(clinical, data.sample)
    common = find_common_genes(network.genes, data.gene)
    network = restrict_network(network, common)
    data = restrict_data(data, common)
    return data, network.src, network.dst


def preprocess_range(data, clinical, genes: set, network_file: str,
                     rank: int, n_ranks: int):
    """Stage 2 under ``--edge-partition`` (``g2vec_tpu/pipeline.py:
    308-323``): labels matched, the expression restricted to the common
    genes, and only the edges whose source lies in this rank's range of
    them read from ``network_file``. Returns ``(data, src, dst, (lo,
    hi))``; the edges are the same arrays :func:`preprocess_inputs`
    gives, restricted to that range (the readers' order contract)."""
    from g2vec_tpu_torch.parallel.shard import edge_range

    data.label = match_labels(clinical, data.sample)
    common = find_common_genes(genes, data.gene)
    data = restrict_data(data, common)
    lo, hi = edge_range(rank, n_ranks, len(common))
    src, dst = load_network_range(network_file, make_gene2idx(data.gene),
                                  lo, hi)
    return data, src, dst, (lo, hi)


def build_edge_partition(cfg, group_edges, n_genes: int, rank: int,
                         n_ranks: int, gene_range, shard_ctx, metrics,
                         console):
    """Stage 3's edge partition (``g2vec_tpu/pipeline.py:450-508``): each
    group's owned-range CSR from its thresholded edges, and in halo mode
    the halo rows, a collective of the ranks. Emits the ``edge_partition``
    (and ``halo``) events; returns the edge context, or None at one
    rank: one rank's range is the whole graph, so its trainer takes the
    plain paths."""
    from g2vec_tpu_torch.parallel.shard import (EdgeContext, EdgeWalkStats,
                                                build_halo_csr,
                                                build_partitioned_csr)

    if n_ranks > 1 and (shard_ctx is None or not shard_ctx.spec.graph_shards):
        raise ValueError(
            "multi-rank --edge-partition needs --graph-shards "
            "(the shard exchange distributes finished rows)")
    lo, hi = gene_range
    pcsrs = []
    for gi, (s_k, d_k, w_k) in enumerate(group_edges):
        p = build_partitioned_csr(s_k, d_k, w_k, n_genes, lo, hi)
        if cfg.edge_partition == "halo" and n_ranks > 1:
            p = build_halo_csr(
                p, rank=rank, n_ranks=n_ranks, group=gi,
                deadline=(cfg.fleet_watchdog_deadline or None))
        pcsrs.append(p)
    csr_bytes = sum(p.csr_bytes for p in pcsrs)
    owned_edges = sum(p.owned_edges for p in pcsrs)
    halo_edges = sum(p.halo_edges for p in pcsrs)
    halo_bytes = sum(p.halo_bytes for p in pcsrs)
    console(f"    [edge] {cfg.edge_partition}: rank {rank}/{n_ranks} owns "
            f"genes [{lo}, {hi}) — {owned_edges} owned edges, {csr_bytes} "
            f"CSR bytes"
            + (f", {halo_edges} halo edges"
               if cfg.edge_partition == "halo" else ""))
    metrics.emit("edge_partition", mode=cfg.edge_partition, rank=rank,
                 n_ranks=n_ranks, gene_lo=lo, gene_hi=hi,
                 owned_edges=owned_edges, csr_bytes=csr_bytes)
    if cfg.edge_partition == "halo":
        metrics.emit("halo", halo_edges=halo_edges, halo_bytes=halo_bytes,
                     halo_genes=sum(len(p.halo_genes) for p in pcsrs),
                     overhead_ratio=halo_bytes / max(1, 8 * owned_edges))
    return (EdgeContext(mode=cfg.edge_partition, pcsrs=pcsrs,
                        stats=EdgeWalkStats()) if n_ranks > 1 else None)


def cohort_line(cfg, n_kept: int, n_before: int) -> Optional[str]:
    """The stage-2 transcript line of a run's patient cohort (the JAX
    package's wording), or None for the full cohort."""
    if cfg.subsample_mode == "bootstrap":
        return ("    patient bootstrap: drew %d/%d samples with replacement "
                "(fraction=%.3f, seed=%d)"
                % (n_kept, n_before, cfg.patient_subsample or 1.0,
                   cfg.subsample_seed))
    if cfg.subsample_mode == "fold":
        return ("    patient folds: training on %d/%d samples (held-out "
                "fold %d/%d, seed=%d)"
                % (n_kept, n_before, cfg.cv_fold, cfg.cv_folds,
                   cfg.subsample_seed))
    if cfg.patient_subsample:
        return ("    patient subsample: kept %d/%d samples (fraction=%.3f, "
                "seed=%d)" % (n_kept, n_before, cfg.patient_subsample,
                              cfg.subsample_seed))
    return None


def scoring_labels(labels: np.ndarray, permute_seed: Optional[int]
                   ) -> np.ndarray:
    """Stage 6's labels: the observed ones, or under a permutation null
    (``permute_seed``) the seeded shuffle of them. Walks and training
    always see the observed labels."""
    labels = np.asarray(labels)
    return labels if permute_seed is None else permute_labels(labels,
                                                              permute_seed)


def _start_profile(on_card: bool):
    """``--profile-dir``: a ``torch.profiler`` trace of the run, CPU
    activity and, on the card, CUDA activity, started where the JAX
    package starts its ``jax.profiler`` trace (before stage 0)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _stop_profile(prof, profile_dir: str) -> None:
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))


def _nan_watch(on: bool):
    """``--debug-nans`` over the training stage: autograd anomaly mode, so
    a backward op that makes a NaN raises naming itself (the trainers
    check the loss and the gradients for infinities too). Off, nothing."""
    return (torch.autograd.detect_anomaly(check_nan=True) if on
            else contextlib.nullcontext())


def _mesh_context(cfg: G2VecConfig, dev, console):
    """The run's ``--mesh`` context (``g2vec_tpu/pipeline.py:345-366``):
    None without ``--mesh``; over R > 1 processes, the global plan held
    to R devices and each rank's replicated 1x1 local mesh on its one
    device (the ranks share the card); otherwise the mesh over this
    process's visible devices."""
    if not cfg.mesh_shape:
        return None
    from g2vec_tpu_torch.parallel.mesh import (make_mesh_context,
                                               visible_devices)

    if not cfg.distributed:
        return make_mesh_context(cfg.mesh_shape,
                                 devices=visible_devices(dev))
    from g2vec_tpu_torch.parallel import distributed

    global_ctx = distributed.make_global_mesh(cfg.mesh_shape, dev)
    if not distributed.shared_card_fleet():
        return global_ctx
    local = fleet.plan_mesh(1, prefer_model=cfg.mesh_shape[1])
    console(f"    [fleet] shared card: replicated local mesh "
            f"{local[0]}x{local[1]} per rank (global plan "
            f"{tuple(cfg.mesh_shape)})")
    return make_mesh_context(local, devices=[dev])


def _join_kernel_build(overlap, name: str = "build_kernels") -> None:
    """Wait for the background nvcc build ``name`` (if one was started),
    re-raising its error, before the first launch of its kernels."""
    if overlap.has(name):
        overlap.result(name)


def run(cfg: G2VecConfig, console: Callable[[str], None] = print, *,
        init: Optional[Tuple[np.ndarray, np.ndarray]] = None,
        kmeans_centers0: Optional[np.ndarray] = None,
        check: Optional[Callable[[], None]] = None,
        lifecycle: Optional[Callable[[str, dict], None]] = None,
        ) -> PipelineResult:
    """Execute the full pipeline; returns all artifacts plus run stats.

    ``init = (w_ih [G, H], w_ho [H, 1])`` replaces the trainer's seeded
    draw and ``kmeans_centers0 [10, k, H]`` the k-means++ draws; the tests
    inject the same values into the JAX package's stage functions.
    ``check()`` runs at the trainers' epoch (and streaming shard)
    boundaries, where an exception it raises stops the run;
    ``lifecycle(state, info)`` observes the streaming trainer's
    ``"checkpointed"`` and ``"resumed"`` transitions.
    """
    from g2vec_tpu_torch.analysis import (biomarker_scores,
                                          biomarker_scores_sharded,
                                          find_lgroups, find_lgroups_sharded,
                                          freq_index, top_biomarkers)
    from g2vec_tpu_torch.cache import (NATIVE_FAMILY, autotune_cache_path,
                                       cache_stats, resolve_cache_tiers,
                                       walk_cache_key)
    from g2vec_tpu_torch.io.writers import (write_biomarkers, write_lgroups,
                                            write_vectors,
                                            write_vectors_sharded)
    from g2vec_tpu_torch.ops.backend import resolve_walker_backend
    from g2vec_tpu_torch.ops.device_walker import (build_walk_kernel,
                                                   generate_path_set_device)
    from g2vec_tpu_torch.ops.graph import thresholded_edges
    from g2vec_tpu_torch.ops.host_walker import (generate_path_set_native,
                                                 resolve_sampler_threads)
    from g2vec_tpu_torch.ops.packed_matmul import (build_kernels,
                                                   build_tile_kernels)
    from g2vec_tpu_torch.ops.paths import count_gene_freq, integrate_path_sets
    from g2vec_tpu_torch.parallel.overlap import OverlapScheduler
    from g2vec_tpu_torch.train.stream import (EVAL_ROWS_CAP,
                                              train_cbow_streaming)
    from g2vec_tpu_torch.train.trainer import train_cbow
    from g2vec_tpu_torch.utils.metrics import MetricsWriter
    from g2vec_tpu_torch.weights import params_from_jax

    cfg.validate()
    if cfg.fault_plan:
        # Re-installing on an in-process retry keeps the once-only
        # entries that already fired fired.
        install_plan(cfg.fault_plan)
    fleet.configure(liveness_dir=cfg.fleet_liveness_dir,
                    heartbeat_interval=cfg.fleet_heartbeat_interval,
                    watchdog_deadline=cfg.fleet_watchdog_deadline,
                    straggler_factor=cfg.fleet_straggler_factor)
    write_outputs = True
    if cfg.distributed:
        from g2vec_tpu_torch.parallel import distributed

        # Idempotent when __main__ joined already.
        distributed.initialize(cfg.coordinator, cfg.process_id,
                               cfg.num_processes)
        if distributed.process_count() > 1 and not cfg.mesh_shape \
                and not (cfg.graph_shards or cfg.embed_shards):
            raise ValueError(
                f"--distributed with {distributed.process_count()} "
                "processes needs --mesh (e.g. --mesh 8x1) or "
                "--graph-shards/--embed-shards; without either every "
                "process would redundantly train the full model on one "
                "local device")
        write_outputs = distributed.is_coordinator()
        if not write_outputs:
            # The other ranks compute and hold shards, but neither narrate
            # nor write: transcript, metrics, trace and files are rank 0's.
            console = lambda s: None  # noqa: E731
            cfg = dataclasses.replace(cfg, metrics_jsonl=None,
                                      profile_dir=None)
    dev = resolve_device(cfg.device)
    on_card = dev.type == "cuda"
    # A resumed run appends: its records continue the interrupted
    # attempt's stream, with the supervisor's events in between.
    metrics = MetricsWriter(cfg.metrics_jsonl, append=cfg.resume)
    overlap = OverlapScheduler(max_workers=2)
    train_seed = cfg.seed if cfg.train_seed is None else cfg.train_seed
    init_model = None if init is None else params_from_jax(*init)
    walker_backend = resolve_walker_backend(cfg)
    sampler_threads = (resolve_sampler_threads(cfg.sampler_threads)
                       if walker_backend == "native" else 0)
    # The walk cache is per-host files: ranks would race identical writes,
    # so a multi-process run walks uncached.
    walk_cache = None if cfg.distributed else resolve_cache_tiers(
        cfg.cache_dir)
    walk_cache_hits: List[str] = []
    profiler = _start_profile(on_card) if cfg.profile_dir else None
    timer = StageTimer(sync=(lambda: torch.cuda.synchronize(dev))
                       if on_card else None)
    if cfg.distributed:
        for ev in distributed.drain_pending_events():
            metrics.emit(ev.pop("event"), **ev)
    # The liveness beacon and the stage barriers: no-ops unless the
    # --fleet-* flags turn them on (resilience/fleet.py).
    fleet.start_heartbeat(metrics)

    def _stage_edge(name: str) -> None:
        # A rank that died mid-stage is named here, at the stage edge.
        if cfg.distributed:
            fleet.stage_barrier(name, timer.as_dict().get(name, 0.0),
                                metrics, console)

    shard_ctx = None
    # The edge partition: this rank's place on its axis.
    edge_on = cfg.edge_partition != "off"
    ep_rank, ep_ranks = ((distributed.process_index(),
                          distributed.process_count())
                         if cfg.distributed else (0, 1))
    edge_ctx = None
    try:
        console(">>> 0. Arguments")
        console(str(cfg))
        metrics.emit("config", **{f.name: str(getattr(cfg, f.name))
                                  for f in dataclasses.fields(cfg)})
        if cfg.overlap and on_card and cfg.compute_dtype == "bfloat16":
            overlap.submit("build_kernels", build_kernels)
            if cfg.kernel_autotune and cfg.train_mode != "streaming":
                # The sweep launches the tiles library's layouts.
                overlap.submit("build_tile_kernels", build_tile_kernels)
        if cfg.overlap and on_card and walker_backend == "device":
            overlap.submit("build_walk_kernel", build_walk_kernel)

        def cuda_context():
            with span("cuda_context"):
                torch.empty(1, device=dev)

        console(">>> 1. Load data")
        fault_point("load")
        fleet.note_phase("load")
        with timer.stage("load"):
            data, clinical, network = read_inputs(
                cfg, overlap if cfg.overlap else None,
                cuda_context if cfg.overlap and on_card else None,
                genes_only=edge_on)
        timer.annotate("load", expression_parser=data.parser,
                       network_parser="python" if edge_on
                       else network.parser)
        _stage_edge("load")

        console(">>> 2. Preprocess data")
        fault_point("preprocess")
        fleet.note_phase("preprocess")
        with timer.stage("preprocess"):
            if edge_on:
                data, src, dst, ep_range = preprocess_range(
                    data, clinical, network, cfg.network_file, ep_rank,
                    ep_ranks)
            else:
                data, src, dst = preprocess_inputs(data, clinical, network)
            n_before = data.expr.shape[0]
            data = select_cohort(data, cfg)
        _stage_edge("preprocess")
        line = cohort_line(cfg, data.expr.shape[0], n_before)
        if line:
            console(line)
        n_samples, n_genes = data.expr.shape
        n_edges = len(src)
        console("    n_samples: %d" % n_samples)
        console("    n_genes  : %d\t(common genes in both EXPRESSION and NETWORK)" % n_genes)
        console("    n_edges  : %d\t(%s)" % (
            n_edges, "edges of this rank's owned gene range" if edge_on
            else "edges with the common genes"))
        metrics.emit("preprocess", n_samples=n_samples, n_genes=n_genes,
                     n_edges=n_edges)

        console(">>> 3. Generate random paths from each group")
        console("    *** most time consuming step ***")
        mesh_ctx = _mesh_context(cfg, dev, console)
        if walker_backend == "native":
            console(f"    [sampler] native C++ CSR sampler, "
                    f"{sampler_threads} host thread(s)")
        reporter = _EpochReporter(console, cfg.display_step)

        def on_epoch(step, acc_val, acc_tr, secs):
            reporter.on_epoch(step, acc_val, acc_tr, secs)
            metrics.emit("epoch", step=step, acc_val=acc_val, acc_tr=acc_tr,
                         secs=secs)

        if cfg.train_mode == "streaming":
            # ---- stages 3-4 merged: walk shards stream into the trainer ----
            from g2vec_tpu_torch.parallel.shard import make_shard_context

            # None with both axes off; one rank's context runs the plain
            # code (byte identity).
            shard_ctx = make_shard_context(
                cfg.graph_shards, cfg.embed_shards, n_genes,
                deadline=(cfg.fleet_watchdog_deadline or None))
            if shard_ctx is not None:
                console(f"    [shard] rank {shard_ctx.spec.rank}/"
                        f"{shard_ctx.spec.n_ranks}: graph_shards="
                        f"{cfg.graph_shards} embed_shards="
                        f"{cfg.embed_shards} gene range "
                        f"[{shard_ctx.spec.lo}, {shard_ctx.spec.hi})")
            fault_point("paths")
            fleet.note_phase("paths")
            with timer.stage("paths"):
                group_edges = [thresholded_edges(
                    data.expr[data.label == i], src, dst,
                    threshold=cfg.pcc_threshold, device=dev)
                    for i in range(2)]
                if edge_on:
                    edge_ctx = build_edge_partition(
                        cfg, group_edges, n_genes, ep_rank, ep_ranks,
                        ep_range, shard_ctx, metrics, console)
            _stage_edge("paths")
            console("    [stream] walk shards stream from the sampler; "
                    "stage 4 overlaps stage 3")
            console(">>> 4. Compute distributed representations using "
                    "modified CBOW")
            console("     Start training the modified CBOW with early "
                    "stopping")
            fault_point("train")
            fleet.note_phase("train")
            with timer.stage("train"), _nan_watch(cfg.debug_nans):
                _join_kernel_build(overlap)
                _join_kernel_build(overlap, "build_walk_kernel")
                sres = train_cbow_streaming(
                    groups=group_edges, n_genes=n_genes, genes=data.gene,
                    hidden=cfg.sizeHiddenlayer,
                    learning_rate=cfg.learningRate, max_epochs=cfg.epoch,
                    len_path=cfg.lenPath, reps=cfg.numRepetition,
                    val_fraction=cfg.val_fraction,
                    decision_threshold=cfg.decision_threshold,
                    compute_dtype=cfg.compute_dtype,
                    param_dtype=cfg.param_dtype, seed=train_seed,
                    walk_seed=cfg.seed, shard_paths=cfg.shard_paths,
                    prefetch_depth=cfg.prefetch_depth,
                    patience=cfg.stream_patience,
                    sampler_threads=cfg.sampler_threads, overlap=overlap,
                    walker_backend=walker_backend,
                    eval_rows_cap=(cfg.stream_eval_rows or EVAL_ROWS_CAP),
                    device=dev, init=init_model, on_epoch=on_epoch,
                    checkpoint_dir=cfg.checkpoint_dir, resume=cfg.resume,
                    checkpoint_every=cfg.checkpoint_every, console=console,
                    check=check, lifecycle=lifecycle,
                    debug_nans=cfg.debug_nans, shard_ctx=shard_ctx,
                    walk_starts=cfg.walk_starts, edge_ctx=edge_ctx)
            if edge_ctx is not None:
                st = edge_ctx.stats
                metrics.emit("handoff", mode=edge_ctx.mode,
                             shards=st.shards, rounds=st.rounds,
                             states_sent=st.states_sent, batches=st.batches,
                             peak_in_flight=st.peak_in_flight)
            _stage_edge("train")
            result = sres.train
            gene_freq = sres.gene_freq
            n_paths = sres.n_paths
            paths = labels = None
            stream_stats = sres.stats.as_dict()
            console("    n_paths : %d\t(streamed, %d shard(s))"
                    % (n_paths, sres.stats.n_shards))
            console("    n_genes : %d\t(genes in good or poor random paths)"
                    % len(gene_freq))
            console("    [stream] first update %.0f ms in; sampling wall "
                    "%.2f s; ring high-water %d/%d shard(s)"
                    % (sres.stats.time_to_first_update_ms,
                       sres.stats.sampling_wall_s,
                       sres.stats.ring_occupancy_hw, cfg.prefetch_depth))
            metrics.emit("paths", n_paths=n_paths,
                         n_path_genes=len(gene_freq),
                         walker_backend=walker_backend,
                         sampler_threads=sampler_threads,
                         walk_cache_hits=walk_cache_hits)
            metrics.emit("stream", **stream_stats)
            if walker_backend == "device":
                wall = sres.stats.sampling_wall_s
                metrics.emit("device_walk",
                             paths_per_s=(n_paths / wall if wall > 0 else 0.0),
                             h2d_bytes_saved=sres.stats.h2d_bytes_saved,
                             feed_mode=sres.stats.feed_mode)
        else:
            fault_point("paths")
            fleet.note_phase("paths")
            with timer.stage("paths"):
                path_sets = []
                for i, group in enumerate(("g", "p")):
                    with span(f"pcc_{group}"):
                        s_k, d_k, w_k = thresholded_edges(
                            data.expr[data.label == i], src, dst,
                            threshold=cfg.pcc_threshold, device=dev)
                    seed = (cfg.seed << 1) | i
                    ckey = None
                    if walk_cache is not None:
                        # One family for both backends: their rows are
                        # the same bytes (cache.NATIVE_FAMILY).
                        ckey = walk_cache_key(
                            s_k, d_k, w_k, n_genes, len_path=cfg.lenPath,
                            reps=cfg.numRepetition, seed=seed,
                            family=NATIVE_FAMILY)
                        cached = walk_cache.load(ckey)
                        if cached is not None:
                            path_sets.append(cached)
                            walk_cache_hits.append(group)
                            console(f"    [cache] group {group!r}: verified "
                                    f"walk artifact hit ({len(cached)} "
                                    f"unique paths); walks skipped")
                            metrics.emit("walk_cache", group=group,
                                         outcome="hit", n_rows=len(cached))
                            continue
                        metrics.emit("walk_cache", group=group,
                                     outcome="miss")
                    # On this thread: on a scheduler thread, with nothing
                    # left to overlap, the walks ran 3-4x slower on the
                    # card's host (PERF.md §6, PR 6).
                    with span(f"walk_{group}"):
                        if walker_backend == "device":
                            _join_kernel_build(overlap, "build_walk_kernel")
                            path_sets.append(generate_path_set_device(
                                s_k, d_k, w_k, n_genes, len_path=cfg.lenPath,
                                reps=cfg.numRepetition, seed=seed,
                                device=dev))
                        elif cfg.distributed:
                            # Each rank walks its range of the walker
                            # axis; the rows are allgathered (a
                            # collective; one process: the plain call).
                            path_sets.append(
                                distributed.sharded_native_path_set(
                                    s_k, d_k, w_k, n_genes,
                                    len_path=cfg.lenPath,
                                    reps=cfg.numRepetition, seed=seed,
                                    n_threads=sampler_threads))
                        else:
                            path_sets.append(generate_path_set_native(
                                s_k, d_k, w_k, n_genes, len_path=cfg.lenPath,
                                reps=cfg.numRepetition, seed=seed,
                                n_threads=sampler_threads))
                    if ckey is not None:
                        walk_cache.store(ckey, path_sets[i], n_genes,
                                         meta={"group": group})
                with span("integrate"):
                    paths, labels = integrate_path_sets(
                        path_sets[0], path_sets[1], n_genes)
                with span("gene_freq"):
                    gene_freq = count_gene_freq(paths, labels, data.gene)
            _stage_edge("paths")
            n_paths = paths.shape[0]
            if n_paths < 2:
                raise ValueError(
                    "fewer than 2 distinct group-specific paths were "
                    "generated — the |PCC| > %.2f graphs are too sparse for "
                    "this dataset; try lowering --pcc-threshold or raising "
                    "-r/--numRepetition" % cfg.pcc_threshold)
            console("    n_paths : %d" % n_paths)
            console("    n_genes : %d\t(genes in good or poor random paths)"
                    % len(gene_freq))
            metrics.emit("paths", n_paths=n_paths,
                         n_path_genes=len(gene_freq),
                         walker_backend=walker_backend,
                         sampler_threads=sampler_threads,
                         walk_cache_hits=walk_cache_hits)
            stream_stats = {}

            console(">>> 4. Compute distributed representations using "
                    "modified CBOW")
            console("     Start training the modified CBOW with early "
                    "stopping")
            fault_point("train")
            fleet.note_phase("train")
            with timer.stage("train"), _nan_watch(cfg.debug_nans):
                _join_kernel_build(overlap)
                _join_kernel_build(overlap, "build_tile_kernels")
                tuned_before = cache_stats()["autotune"]
                result = train_cbow(
                    paths, labels, n_genes=n_genes,
                    hidden=cfg.sizeHiddenlayer,
                    learning_rate=cfg.learningRate, max_epochs=cfg.epoch,
                    val_fraction=cfg.val_fraction,
                    decision_threshold=cfg.decision_threshold,
                    compute_dtype=cfg.compute_dtype,
                    param_dtype=cfg.param_dtype, seed=train_seed,
                    device=dev, on_epoch=on_epoch, init=init_model,
                    checkpoint_dir=cfg.checkpoint_dir, resume=cfg.resume,
                    checkpoint_every=cfg.checkpoint_every, check=check,
                    debug_nans=cfg.debug_nans, mesh_ctx=mesh_ctx,
                    checkpoint_layout=cfg.checkpoint_layout,
                    kernel_autotune=cfg.kernel_autotune,
                    autotune_cache_path=autotune_cache_path(cfg.cache_dir))
            if result.tile_plans is not None:
                tuned = cache_stats()["autotune"]
                timer.annotate("train", autotune={
                    "plans": result.tile_plans,
                    "events": {k: n - tuned_before.get(k, 0)
                               for k, n in tuned.items()
                               if n != tuned_before.get(k, 0)}})
            _stage_edge("train")
        if result.stopped_early:
            reporter.on_stop(result.stop_epoch, result.acc_val, result.acc_tr)
        console("    Optimization Finish")
        metrics.emit("train_done", stop_epoch=result.stop_epoch,
                     acc_val=result.acc_val, acc_tr=result.acc_tr,
                     stopped_early=result.stopped_early)

        console(">>> 5. Find L-groups")
        fault_point("lgroups")
        fleet.note_phase("lgroups")
        embed_sharded = shard_ctx is not None and shard_ctx.spec.embed_split
        kmeans_gen = torch.Generator().manual_seed(cfg.kmeans_seed)
        if embed_sharded:
            # Stages 5-6 on this rank's gene range: only per-cluster
            # statistics and masked extrema cross ranks, and the [G]
            # score and L-group vectors exist only at the writers' gathers.
            spec = shard_ctx.spec
            emb = result.model.w_ih.detach()[:spec.g_local].float()
            with timer.stage("lgroups"):
                lgroup_dev = find_lgroups_sharded(
                    emb, freq_index(data.gene, gene_freq)[spec.lo:spec.hi],
                    shard_ctx, generator=kmeans_gen, k=cfg.n_lgroups,
                    compat_tiebreak=cfg.compat_lgroup_tiebreak,
                    iters=cfg.kmeans_iters, centers0=kmeans_centers0)
            km_centers = None
            expr = data.expr[:, spec.lo:spec.hi]
        else:
            emb = result.model.w_ih.detach().float()
            with timer.stage("lgroups"):
                lgroup_dev, km_centers = find_lgroups(
                    emb, freq_index(data.gene, gene_freq),
                    generator=kmeans_gen, k=cfg.n_lgroups,
                    compat_tiebreak=cfg.compat_lgroup_tiebreak,
                    iters=cfg.kmeans_iters, centers0=kmeans_centers0)
                km_centers = km_centers.cpu().numpy().astype(np.float32)
            expr = data.expr

        _stage_edge("lgroups")

        console(">>> 6. Select biomarkers with gene scores")
        fault_point("biomarkers")
        fleet.note_phase("biomarkers")
        with timer.stage("biomarkers"):
            label = scoring_labels(data.label, cfg.permute_seed)
            if cfg.permute_seed is not None:
                console("    permutation null: stage-6 labels shuffled "
                        "(permute_seed=%d)" % cfg.permute_seed)
            expr_good = torch.as_tensor(expr[label == 0], device=dev)
            expr_poor = torch.as_tensor(expr[label == 1], device=dev)
            if embed_sharded:
                scores2 = shard_ctx.gather_concat(
                    "bm_scores", biomarker_scores_sharded(
                        emb, expr_good, expr_poor, lgroup_dev, shard_ctx,
                        cfg.score_mix).cpu().numpy(), axis=1)
                lgroup_idx = shard_ctx.gather_concat(
                    "lgroups", lgroup_dev.cpu().numpy(), axis=0)
            else:
                scores2 = biomarker_scores(
                    emb, expr_good, expr_poor, lgroup_dev,
                    cfg.score_mix).cpu().numpy()
                lgroup_idx = lgroup_dev.cpu().numpy()
            biomarkers, _ = top_biomarkers(scores2, lgroup_idx, data.gene,
                                           cfg.numBiomarker)

        _stage_edge("biomarkers")

        console(">>> 7. Save results")
        fault_point("save")
        fleet.note_phase("save")
        with timer.stage("save"):
            outputs = []
            if embed_sharded:
                # Collective: every rank publishes its slice, rank 0
                # writes them; biomarkers and L-groups are replicated.
                vec_path = write_vectors_sharded(
                    cfg.result_name, result.w_ih, data.gene, shard_ctx)
                if write_outputs:
                    outputs = [
                        write_biomarkers(cfg.result_name, biomarkers),
                        write_lgroups(cfg.result_name, lgroup_idx,
                                      data.gene),
                        vec_path,
                    ]
            elif write_outputs:
                outputs = [
                    write_biomarkers(cfg.result_name, biomarkers),
                    write_lgroups(cfg.result_name, lgroup_idx, data.gene),
                    write_vectors(cfg.result_name, result.w_ih, data.gene),
                ]
            if cfg.emit_inventory and write_outputs:
                if embed_sharded:
                    console("    --emit-inventory skipped: embedding is "
                            "gene-range sharded")
                else:
                    _emit_inventory(cfg, result.w_ih, data.gene, scores2,
                                    km_centers, metrics, console)
        _stage_edge("save")
        for path in outputs:
            console("    %s" % path)
        overlap_saved = overlap.saved_seconds() if cfg.overlap else {}
        if overlap_saved:
            console("    [overlap] background time hidden under foreground "
                    "stages: " + ", ".join(
                        f"{k}={v:.2f}s" for k, v in sorted(overlap_saved.items())))
        metrics.emit("done", outputs=outputs, stage_seconds=timer.as_dict(),
                     stage_extras=timer.extras_dict(),
                     walker_backend=walker_backend,
                     sampler_threads=sampler_threads,
                     overlap_saved_s=overlap_saved,
                     walk_cache_hits=walk_cache_hits)

        return PipelineResult(
            genes=data.gene, embeddings=result.w_ih, lgroup_idx=lgroup_idx,
            biomarkers=biomarkers, output_files=outputs, n_samples=n_samples,
            n_genes=n_genes, n_edges=n_edges, n_paths=n_paths,
            n_path_genes=len(gene_freq), train_history=result.history,
            stop_epoch=result.stop_epoch, acc_val=result.acc_val,
            stage_seconds=timer.as_dict(), stage_extras=timer.extras_dict(),
            overlap_saved_s=overlap_saved, stream_stats=stream_stats,
            device=str(dev), walker_backend=walker_backend,
            sampler_threads=sampler_threads,
            walk_cache_hits=list(walk_cache_hits), paths=paths,
            labels=labels, biomarker_scores=scores2, km_centers=km_centers)
    finally:
        # Drain, never raise: the exception in flight (if any) is the one
        # the caller must see; a background failure either surfaced at a
        # join already or belongs to a stage the run never reached.
        overlap.close()
        fleet.stop_heartbeat()
        if profiler is not None:
            _stop_profile(profiler, cfg.profile_dir)
        metrics.close()
