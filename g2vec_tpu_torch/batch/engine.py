"""The batch engine: many runs of one dataset as lanes, on the card.

G2Vec's users never run it once: biomarkers are validated over seeds and
patient resamples. The reference's engine (``g2vec_tpu/batch/engine.py``)
runs such repeats as one batched program, and this is its port:

- A **manifest** lists variants of one base config: seeds, k-means
  seeds, learning rate, epochs, patient cohorts, a permutation null
  (``--manifest`` JSON, or ``--seeds N`` for the seed sweep).
- Everything the variants share runs once: stages 1-2 (kept resident by
  :class:`ResidentEngine` across batches), each cohort's edge weights,
  and each distinct walk product (a cohort's group under a walk seed),
  through :class:`~g2vec_tpu_torch.cache.SharedWalkTier` over the walk
  cache; lanes with the same two products share their integrated paths.
- Lanes whose path matrices have one shape and whose learning rate and
  epoch cap agree form a **bucket** of at most ``--lanes`` lanes, trained
  by :func:`~g2vec_tpu_torch.train.trainer.train_cbow_lanes`: on the bf16
  path one launch of each packed kernel a step for the whole bucket, each
  lane stopping on its own. A bucket of one lane runs the solo
  ``train_cbow``.
- Stages 5-6 run over all lanes (``analysis.py``'s lane variants), the
  t-scores once for the lanes that share a cohort and label view. Each
  lane's result carries its k-means centres and ``[2, G]`` scores, which
  the serve daemon publishes in the lane's query-plane bundle.

Contract: every lane's three output files are the bytes that
``pipeline.run(lane_config(cfg, v))`` writes solo on the same device.

The distinct walk products are walked in turn on the calling thread: the
C++ sampler uses every core itself, and on the card's host the mixed
manifest's products took longer on a scheduler pool than in turn
(PERF.md §6, PR 9). ``--train-mode streaming`` runs each lane's solo
streaming pipeline in turn (the path matrix never exists whole there).

What the reference has and the port does not: the background compile
warm-ups and the XLA compilation cache (the port compiles no programs;
its kernels are built once per checkout), and the mesh's lane cap.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from g2vec_tpu_torch.config import G2VecConfig


class ManifestError(ValueError):
    """A malformed run manifest; the message names the variant and key."""


#: Per-variant override keys a manifest may set; any other key is refused.
_VARIANT_KEYS = ("name", "seed", "train_seed", "kmeans_seed",
                 "learningRate", "epoch", "patient_subsample",
                 "subsample_seed", "subsample_mode", "cv_folds", "cv_fold",
                 "permute_seed")
_NAME_RE = re.compile(r"^[A-Za-z0-9._-]{1,64}$")


@dataclasses.dataclass(frozen=True)
class LaneVariant:
    """One manifest lane: the variant axes over the base config."""

    index: int
    name: str
    seed: int
    train_seed: int
    kmeans_seed: int
    learningRate: float
    epoch: int
    patient_subsample: float
    subsample_seed: int
    subsample_mode: str = "fraction"
    cv_folds: int = 0
    cv_fold: int = 0
    permute_seed: Optional[int] = None

    def fingerprint(self) -> str:
        payload = json.dumps({k: getattr(self, k) for k in _VARIANT_KEYS},
                             sort_keys=True)
        return hashlib.sha256(payload.encode()).hexdigest()[:8]

    def tag(self) -> str:
        """The metrics ``lane`` field: manifest index and fingerprint."""
        return f"{self.index}:{self.fingerprint()}"

    def expr_key(self) -> Optional[Tuple]:
        """The cohort's identity: lanes that share it see the same
        expression rows (None: the full cohort). ``permute_seed`` is not
        part of it: a permutation null shuffles only stage 6's labels, so
        it shares its cohort's graphs and walks."""
        if self.subsample_mode == "bootstrap":
            return ("bootstrap", self.patient_subsample,
                    self.subsample_seed)
        if self.subsample_mode == "fold":
            return ("fold", self.cv_folds, self.cv_fold,
                    self.subsample_seed)
        if not self.patient_subsample:
            return None
        return (self.patient_subsample, self.subsample_seed)


def _variant_from_dict(index: int, obj, cfg: G2VecConfig,
                       origin: Optional[str] = None) -> LaneVariant:
    """Validate one variant object against the base config. ``origin``
    names where a generated variant came from (a scenario's replicate:
    "manifest variant 3 (scenario ab12cd, replicate 3)")."""
    who = f"manifest variant {index}" + (f" ({origin})" if origin else "")
    if not isinstance(obj, dict):
        raise ManifestError(
            f"{who} must be an object, got {type(obj).__name__}")
    unknown = sorted(set(obj) - set(_VARIANT_KEYS))
    if unknown:
        raise ManifestError(
            f"{who} has unknown key(s) {unknown}; "
            f"allowed: {sorted(_VARIANT_KEYS)}")

    def _int(k, default, lo=0):
        v = obj.get(k, default)
        if not isinstance(v, int) or isinstance(v, bool) or v < lo:
            raise ManifestError(
                f"{who}: {k!r} must be an int >= {lo}, got {v!r}")
        return v

    lr = obj.get("learningRate", cfg.learningRate)
    if not isinstance(lr, (int, float)) or isinstance(lr, bool) or lr <= 0:
        raise ManifestError(
            f"{who}: 'learningRate' must be > 0, got {lr!r}")
    sub = obj.get("patient_subsample", cfg.patient_subsample)
    if not isinstance(sub, (int, float)) or isinstance(sub, bool) \
            or not (0.0 <= float(sub) <= 1.0):
        raise ManifestError(
            f"{who}: 'patient_subsample' must be 0 "
            f"(off) or in (0,1], got {sub!r}")
    mode = obj.get("subsample_mode", cfg.subsample_mode)
    if mode not in ("fraction", "bootstrap", "fold"):
        raise ManifestError(
            f"{who}: 'subsample_mode' must be "
            f"fraction|bootstrap|fold, got {mode!r}")
    cv_folds = _int("cv_folds", cfg.cv_folds)
    cv_fold = _int("cv_fold", cfg.cv_fold)
    if mode == "fold":
        if cv_folds < 2:
            raise ManifestError(
                f"{who}: subsample_mode 'fold' needs 'cv_folds' >= 2, "
                f"got {cv_folds}")
        if cv_fold >= cv_folds:
            raise ManifestError(
                f"{who}: 'cv_fold' must be in [0, {cv_folds}), "
                f"got {cv_fold}")
        if float(sub):
            raise ManifestError(
                f"{who}: subsample_mode 'fold' derives the cohort from "
                f"the fold partition; 'patient_subsample' must be 0")
    elif cv_folds or cv_fold:
        raise ManifestError(
            f"{who}: 'cv_folds'/'cv_fold' are only meaningful with "
            f"subsample_mode 'fold'")
    pseed = obj.get("permute_seed", cfg.permute_seed)
    if pseed is not None and (not isinstance(pseed, int)
                              or isinstance(pseed, bool) or pseed < 0):
        raise ManifestError(
            f"{who}: 'permute_seed' must be null or an int >= 0, "
            f"got {pseed!r}")
    name = obj.get("name", f"lane{index}")
    if not isinstance(name, str) or not _NAME_RE.match(name):
        raise ManifestError(
            f"{who}: 'name' must match {_NAME_RE.pattern}, got {name!r}")
    seed = _int("seed", cfg.seed)
    return LaneVariant(
        index=index, name=name, seed=seed,
        train_seed=_int("train_seed",
                        cfg.train_seed if cfg.train_seed is not None
                        else seed),
        kmeans_seed=_int("kmeans_seed", cfg.kmeans_seed),
        learningRate=float(lr),
        epoch=_int("epoch", cfg.epoch, lo=1),
        patient_subsample=float(sub),
        subsample_seed=_int("subsample_seed", cfg.subsample_seed),
        subsample_mode=mode, cv_folds=cv_folds, cv_fold=cv_fold,
        permute_seed=pseed)


def load_manifest(path: str, cfg: G2VecConfig) -> List[LaneVariant]:
    """Parse and validate a JSON manifest against the base config: a
    non-empty JSON list of variant objects (keys ``_VARIANT_KEYS``, each
    optional, defaults from the base config). A bad manifest raises
    :class:`ManifestError` before anything runs."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except OSError as e:
        raise ManifestError(f"cannot read manifest {path!r}: {e}") from e
    except ValueError as e:
        raise ManifestError(f"manifest {path!r} is not valid JSON: {e}") from e
    if not isinstance(doc, list) or not doc:
        raise ManifestError(
            f"manifest {path!r} must be a non-empty JSON list of variant "
            f"objects, got {type(doc).__name__}")
    variants = [_variant_from_dict(i, obj, cfg) for i, obj in enumerate(doc)]
    names = [v.name for v in variants]
    dupes = sorted({n for n in names if names.count(n) > 1})
    if dupes:
        raise ManifestError(
            f"manifest {path!r} has duplicate variant name(s) {dupes} — "
            f"lane outputs would overwrite each other")
    return variants


def seed_sweep_variants(cfg: G2VecConfig, n: int) -> List[LaneVariant]:
    """The seed sweep of ``--seeds N``: lane k trains with train seed
    (base + k) and k-means seed (base + k); the walk seed stays the base
    config's, so all lanes share one walk product per group."""
    base_train = cfg.train_seed if cfg.train_seed is not None else cfg.seed
    return [_variant_from_dict(
        k, {"name": f"s{k}", "train_seed": base_train + k,
            "kmeans_seed": cfg.kmeans_seed + k}, cfg)
        for k in range(n)]


def plan_variants(cfg: G2VecConfig) -> List[LaneVariant]:
    """The run's lanes from whichever batch flag is set."""
    if cfg.manifest and cfg.batch_seeds:
        raise ManifestError("--manifest and --seeds are mutually exclusive")
    if cfg.manifest:
        return load_manifest(cfg.manifest, cfg)
    if cfg.batch_seeds:
        return seed_sweep_variants(cfg, cfg.batch_seeds)
    raise ManifestError("batch engine needs --manifest or --seeds")


def lane_config(cfg: G2VecConfig, v: LaneVariant) -> G2VecConfig:
    """The solo config of lane ``v``: ``pipeline.run(lane_config(cfg, v))``
    writes the lane's files, byte for byte."""
    lane = dataclasses.replace(
        cfg, seed=v.seed, train_seed=v.train_seed,
        kmeans_seed=v.kmeans_seed, learningRate=v.learningRate,
        epoch=v.epoch, patient_subsample=v.patient_subsample,
        subsample_seed=v.subsample_seed,
        subsample_mode=v.subsample_mode, cv_folds=v.cv_folds,
        cv_fold=v.cv_fold, permute_seed=v.permute_seed,
        result_name=f"{cfg.result_name}.{v.name}",
        manifest=None, batch_seeds=0, metrics_jsonl=None,
        scenario=None, replicates=0, folds=0)
    lane.validate()
    return lane


def _lane_cohort(data, v: LaneVariant):
    """Lane ``v``'s patient cohort: the derivation the solo run applies
    at stage 2 (``preprocess.select_cohort``)."""
    from g2vec_tpu_torch.preprocess import select_cohort

    return select_cohort(data, v)


@dataclasses.dataclass
class BatchResult:
    """All lanes' results and the batch's own accounting."""

    lanes: List                       # per-lane pipeline.PipelineResult
    variants: List[LaneVariant]
    wall_seconds: float
    runs_per_hour: float
    walk_stats: Dict[str, int]        # memo_hits / disk_hits / walked /
                                      # lane_shared
    buckets: List[Dict]               # per bucket: n_paths, lanes, mode
    stage_seconds: Dict[str, float]
    # Per stage: the spans of its parts (StageTimer.extras_dict).
    stage_extras: Dict[str, Dict] = dataclasses.field(default_factory=dict)


def run_batch(cfg: G2VecConfig,
              console: Callable[[str], None] = print) -> BatchResult:
    """The one-shot CLI: plan the lanes from ``cfg`` and execute them on
    an engine that lives for this call."""
    cfg.validate()
    variants = plan_variants(cfg)
    with ResidentEngine(cache_dir=cfg.cache_dir) as engine:
        return engine.execute(cfg, variants, console=console)


class ResidentEngine:
    """The lane executor with its warm state kept across batches:

    - the walk tier's memo (:class:`~g2vec_tpu_torch.cache.SharedWalkTier`
      over the walk cache of ``cache_dir``): a later batch over the same
      cohort and walk seed walks nothing;
    - the dataset memo: stages 1-2's result keyed on the input files'
      identity (path, mtime, size), so an edited input is read again;
    - one overlap scheduler for the background kernel builds, each
      batch's tasks under a prefix of their own.

    The serve daemon (``serve/daemon.py``) keeps one for its lifetime,
    and publishes each lane's query-plane bundle from the lane's result
    (its embeddings, ``biomarker_scores`` and ``km_centers``);
    :func:`run_batch` makes one per call.
    """

    #: Datasets kept resident, least recently used dropped first.
    DATASET_CAP = 4

    def __init__(self, *, cache_dir: Optional[str] = None):
        from g2vec_tpu_torch.cache import SharedWalkTier, resolve_cache_tiers
        from g2vec_tpu_torch.parallel.overlap import OverlapScheduler

        self.walk_tier = SharedWalkTier(disk=resolve_cache_tiers(cache_dir))
        self.overlap = OverlapScheduler(max_workers=2)
        self._datasets: "OrderedDict" = OrderedDict()
        self._serial = 0
        self.batches_executed = 0
        self.lanes_executed = 0
        self.warm_shapes: List[Dict] = []

    def execute(self, cfg: G2VecConfig,
                variants: Optional[List[LaneVariant]] = None, *,
                console: Callable[[str], None] = print, metrics=None,
                lane_jobs: Optional[List[str]] = None,
                check: Optional[Callable[[], None]] = None,
                lifecycle=None) -> BatchResult:
        """Run ``variants`` (default: planned from ``cfg``) as one batch.
        ``metrics`` may be a caller's MetricsWriter or bound view (None:
        one from ``cfg.metrics_jsonl`` for this call); ``lane_jobs``
        stamps lane i's records with ``job_id``. ``check()`` runs at the
        trainers' epoch (and shard) boundaries; ``lifecycle(job_id, state,
        info)`` observes a streaming lane's ``"checkpointed"`` and
        ``"resumed"`` transitions (job_id from ``lane_jobs``, else the
        lane's tag). Each lane's result carries its embeddings, its
        ``[2, G]`` ``biomarker_scores`` and its ``km_centers``, which the
        serve daemon publishes as the lane's query-plane bundle."""
        kw = dict(console=console, metrics=metrics, lane_jobs=lane_jobs,
                  check=check)
        if cfg.train_mode == "streaming":
            return _execute_streaming(self, cfg, variants,
                                      lifecycle=lifecycle, **kw)
        return _execute_lanes(self, cfg, variants, **kw)

    def status(self) -> Dict:
        """The warm state's inventory, with the process's kernel launch
        counts (each wrapper's ``.launches``) so that a caller of a
        resident process sees which kernels its jobs ran."""
        from g2vec_tpu_torch.ops import device_walker, packed_matmul
        from g2vec_tpu_torch.train.stream import stream_stats

        return {
            "batches_executed": self.batches_executed,
            "lanes_executed": self.lanes_executed,
            "datasets_resident": len(self._datasets),
            "walk_tier": self.walk_tier.stats(),
            "walk_products_resident": len(self.walk_tier.memo),
            "warm_shapes": [dict(s) for s in self.warm_shapes],
            # Streaming runs' totals; empty until the first one.
            "stream": stream_stats(),
            "kernel_launches": {
                name: getattr(packed_matmul, name).launches
                for name in ("packed_matmul_fwd", "packed_matmul_bwd",
                             "packed_matmul_lanes_fwd",
                             "packed_matmul_lanes_bwd")}
            | {"device_walk": device_walker.device_walk.launches},
        }

    def _dataset_key(self, cfg: G2VecConfig) -> Tuple:
        def ident(path):
            st = os.stat(path)
            return (os.path.abspath(path), st.st_mtime_ns, st.st_size)
        return (ident(cfg.expression_file), ident(cfg.clinical_file),
                ident(cfg.network_file), cfg.use_native_io)

    def dataset(self, cfg: G2VecConfig) -> Tuple[Dict, bool]:
        """Stages 1-2 for ``cfg``'s input files, memoized on their
        identity; returns ``(bundle, was_resident)``."""
        from g2vec_tpu_torch.pipeline import preprocess_inputs, read_inputs

        key = self._dataset_key(cfg)
        hit = self._datasets.get(key)
        if hit is not None:
            self._datasets.move_to_end(key)
            return hit, True
        data, src, dst = preprocess_inputs(*read_inputs(cfg))
        bundle = {"data": data, "src": src, "dst": dst,
                  "n_genes": int(data.expr.shape[1]), "n_edges": len(src)}
        self._datasets[key] = bundle
        while len(self._datasets) > self.DATASET_CAP:
            self._datasets.popitem(last=False)
        return bundle, False

    def close(self) -> None:
        self.overlap.close()

    def __enter__(self) -> "ResidentEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _lane_views(metrics, variants, lane_jobs):
    if lane_jobs is not None and len(lane_jobs) != len(variants):
        raise ValueError(f"lane_jobs has {len(lane_jobs)} entries for "
                         f"{len(variants)} lane(s)")
    if lane_jobs is not None:
        return [metrics.bind_job(lane_jobs[i]).bind_lane(v.tag())
                for i, v in enumerate(variants)]
    return [metrics.bind_lane(v.tag()) for v in variants]


def _execute_streaming(engine: ResidentEngine, cfg: G2VecConfig,
                       variants: Optional[List[LaneVariant]], *,
                       console: Callable[[str], None], metrics,
                       lane_jobs: Optional[List[str]],
                       check: Optional[Callable[[], None]] = None,
                       lifecycle=None) -> BatchResult:
    """Streaming lanes: each variant runs the solo streaming pipeline, one
    after the other. Lane batching would hold every lane's whole path
    matrix, which is what streaming exists to avoid."""
    from g2vec_tpu_torch.pipeline import run as run_pipeline
    from g2vec_tpu_torch.train.stream import stream_stats
    from g2vec_tpu_torch.utils.metrics import MetricsWriter

    cfg.validate()
    if variants is None:
        variants = plan_variants(cfg)
    n_lanes = len(variants)
    own_metrics = None
    if metrics is None:
        own_metrics = metrics = MetricsWriter(cfg.metrics_jsonl)
    t_start = time.time()
    parent = os.path.dirname(cfg.result_name)
    if parent:
        os.makedirs(parent, exist_ok=True)
    console(f">>> [batch] streaming mode: {n_lanes} lane(s), each the solo "
            f"streaming pipeline (no lane batching — the path matrix "
            f"never materializes)")
    results: List = []
    try:
        lane_metrics = _lane_views(metrics, variants, lane_jobs)
        for i, (v, lm) in enumerate(zip(variants, lane_metrics)):
            lm.emit("lane_variant", **dataclasses.asdict(v))
            lane_cfg = lane_config(cfg, v)
            if cfg.checkpoint_dir:
                # A cursor directory per lane, named by the variant, so a
                # relaunched job resumes its own cursor.
                lane_cfg = dataclasses.replace(
                    lane_cfg,
                    checkpoint_dir=os.path.join(cfg.checkpoint_dir, v.name),
                    resume=cfg.resume)
            jid = lane_jobs[i] if lane_jobs is not None else v.tag()
            lane_lifecycle = (
                (lambda state, info, _jid=jid: lifecycle(_jid, state, info))
                if lifecycle is not None else None)
            res = run_pipeline(lane_cfg, console=console, check=check,
                               lifecycle=lane_lifecycle)
            lm.emit("stream", **res.stream_stats)
            lm.emit("done", outputs=res.output_files, acc_val=res.acc_val,
                    n_paths=res.n_paths)
            results.append(res)
        wall = time.time() - t_start
        rph = n_lanes / wall * 3600.0
        metrics.emit("done", n_lanes=n_lanes, wall_seconds=round(wall, 3),
                     runs_per_hour=round(rph, 2), train_mode="streaming",
                     stream_totals=stream_stats())
        engine.batches_executed += 1
        engine.lanes_executed += n_lanes
        return BatchResult(
            lanes=results, variants=variants, wall_seconds=wall,
            runs_per_hour=rph, walk_stats={},
            buckets=[{"n_paths": r.n_paths, "lanes": 1,
                      "mode": "stream-solo"} for r in results],
            stage_seconds={})
    finally:
        if own_metrics is not None:
            own_metrics.close()


def _execute_lanes(engine: ResidentEngine, cfg: G2VecConfig,
                   variants: Optional[List[LaneVariant]], *,
                   console: Callable[[str], None], metrics,
                   lane_jobs: Optional[List[str]],
                   check: Optional[Callable[[], None]] = None
                   ) -> BatchResult:
    """Full-batch lanes: module docstring."""
    from g2vec_tpu_torch.analysis import (biomarker_scores_lanes,
                                          find_lgroups_lanes, freq_index,
                                          top_biomarkers)
    from g2vec_tpu_torch.cache import NATIVE_FAMILY, walk_cache_key
    from g2vec_tpu_torch.device import resolve_device
    from g2vec_tpu_torch.io.writers import (write_biomarkers, write_lgroups,
                                            write_vectors)
    from g2vec_tpu_torch.ops.backend import resolve_walker_backend
    from g2vec_tpu_torch.ops.device_walker import build_walk_kernel
    from g2vec_tpu_torch.ops.graph import thresholded_edges
    from g2vec_tpu_torch.ops.host_walker import resolve_sampler_threads
    from g2vec_tpu_torch.ops.packed_matmul import build_kernels
    from g2vec_tpu_torch.ops.paths import count_gene_freq, integrate_path_sets
    from g2vec_tpu_torch.pipeline import PipelineResult, scoring_labels
    from g2vec_tpu_torch.resilience.faults import fault_point, install_plan
    from g2vec_tpu_torch.train.trainer import (LaneTrainSpec, train_cbow,
                                               train_cbow_lanes)
    from g2vec_tpu_torch.utils.metrics import MetricsWriter
    from g2vec_tpu_torch.utils.timing import StageTimer

    cfg.validate()
    if variants is None:
        variants = plan_variants(cfg)
    n_lanes = len(variants)
    if cfg.fault_plan:
        install_plan(cfg.fault_plan)
    dev = resolve_device(cfg.device)
    on_card = dev.type == "cuda"
    walk_tier = engine.walk_tier
    tier_stats0 = walk_tier.stats()
    engine._serial += 1
    pfx = f"b{engine._serial}:"       # this batch's scheduler tasks

    # A batch fans one result_name into 3 files a lane: make the parent
    # directories first (the metrics stream opens before stage 7).
    for parent in {os.path.dirname(cfg.result_name),
                   os.path.dirname(cfg.metrics_jsonl or "")}:
        if parent:
            os.makedirs(parent, exist_ok=True)
    timer = StageTimer(sync=(lambda: torch.cuda.synchronize(dev))
                       if on_card else None)
    own_metrics = None
    if metrics is None:
        own_metrics = metrics = MetricsWriter(cfg.metrics_jsonl)
    t_start = time.time()
    overlap = engine.overlap
    try:
        lane_metrics = _lane_views(metrics, variants, lane_jobs)
        console(">>> [batch] 0. Manifest")
        console(f"    {n_lanes} lane(s) over base config "
                f"{os.path.basename(cfg.expression_file)!r}; "
                f"lanes/bucket cap {cfg.lanes}")
        metrics.emit("batch_config", n_lanes=n_lanes, lanes_cap=cfg.lanes,
                     batch_serial=engine._serial,
                     variants=[dataclasses.asdict(v) for v in variants])
        for v, lm in zip(variants, lane_metrics):
            lm.emit("lane_variant", **dataclasses.asdict(v))
        walker_backend = resolve_walker_backend(cfg)
        sampler_threads = (resolve_sampler_threads(cfg.sampler_threads)
                           if walker_backend == "native" else 0)
        builds = []
        if cfg.overlap and on_card:
            # nvcc releases the interpreter lock: the builds run under
            # stages 1-3 and are joined before the first launch.
            for name, fn, wanted in (
                    ("build_kernels", build_kernels,
                     cfg.compute_dtype == "bfloat16"),
                    ("build_walk_kernel", build_walk_kernel,
                     walker_backend == "device")):
                if wanted:
                    overlap.submit(pfx + name, fn)
                    builds.append(pfx + name)

        console(">>> [batch] 1-2. Load + preprocess (shared, resident)")
        fault_point("load")
        fault_point("preprocess")
        with timer.stage("load"):
            bundle, was_resident = engine.dataset(cfg)
        data, src, dst = bundle["data"], bundle["src"], bundle["dst"]
        n_genes, n_edges = bundle["n_genes"], bundle["n_edges"]
        if was_resident:
            console("    dataset resident (stages 1-2 served from memo)")
        console(f"    n_genes {n_genes}, n_edges {n_edges}, "
                f"n_samples {data.expr.shape[0]} (base)")
        # Each lane's cohort (its rows; the genes, and so every shape on
        # the card, are the base's).
        lane_data: Dict = {}
        for v in variants:
            ek = v.expr_key()
            if ek not in lane_data:
                lane_data[ek] = data if ek is None else _lane_cohort(data, v)

        console(">>> [batch] 3. Plan + sample walks (amortized)")
        fault_point("paths")
        edges_memo: Dict = {}     # (expr_key, group) -> (src, dst, |PCC|)
        product: Dict[str, set] = {}       # cache key -> its path set
        lane_keys: List[Tuple[str, str]] = []
        with timer.stage("paths"):
            for v in variants:
                ldata = lane_data[v.expr_key()]
                keys = []
                for gi, group in enumerate(("g", "p")):
                    ekey = (v.expr_key(), gi)
                    if ekey not in edges_memo:
                        edges_memo[ekey] = thresholded_edges(
                            ldata.expr[ldata.label == gi], src, dst,
                            threshold=cfg.pcc_threshold, device=dev)
                    s_k, d_k, w_k = edges_memo[ekey]
                    seed = (v.seed << 1) | gi
                    # One key family for both walkers: their rows are the
                    # same bytes (cache.NATIVE_FAMILY).
                    ckey = walk_cache_key(
                        s_k, d_k, w_k, n_genes, len_path=cfg.lenPath,
                        reps=cfg.numRepetition, seed=seed,
                        family=NATIVE_FAMILY)
                    if ckey not in product:
                        product[ckey] = _make_walk_task(
                            cfg, s_k, d_k, w_k, n_genes, seed=seed,
                            backend=walker_backend, tier=walk_tier,
                            ckey=ckey, group=group, device=dev,
                            n_threads=sampler_threads,
                            join=lambda: _join(overlap, builds,
                                               "build_walk_kernel"))()
                    keys.append(ckey)
                lane_keys.append(tuple(keys))
            n_walk_tasks = len(product)
            console(f"    {2 * n_lanes} lane-walks -> {n_walk_tasks} "
                    f"distinct product(s) ({walker_backend}, "
                    f"{sampler_threads} sampler thread(s))")
            # Lanes with the same two products share their paths.
            integrated: Dict[Tuple[str, str], Tuple] = {}
            payloads: List = []
            for li, keys in enumerate(lane_keys):
                if keys not in integrated:
                    sets = [product[k] for k in keys]
                    paths, labels = integrate_path_sets(sets[0], sets[1],
                                                        n_genes)
                    if paths.shape[0] < 2:
                        raise ValueError(
                            f"lane {variants[li].name!r}: fewer than 2 "
                            f"distinct group-specific paths — the |PCC| > "
                            f"{cfg.pcc_threshold:.2f} graphs are too "
                            f"sparse; lower --pcc-threshold or raise -r")
                    integrated[keys] = (paths, labels, count_gene_freq(
                        paths, labels, data.gene))
                payloads.append(integrated[keys])
                paths, _, gene_freq = payloads[li]
                lane_metrics[li].emit(
                    "paths", n_paths=int(paths.shape[0]),
                    n_path_genes=len(gene_freq),
                    walker_backend=walker_backend,
                    sampler_threads=sampler_threads)
        # Deltas of this batch: the tier lives as long as the engine.
        walk_stats = {k: n - tier_stats0[k]
                      for k, n in walk_tier.stats().items()}
        walk_stats["lane_shared"] = 2 * n_lanes - n_walk_tasks
        metrics.emit("batch_walks", n_walk_tasks=n_walk_tasks,
                     lane_walks=2 * n_lanes, **walk_stats)

        console(">>> [batch] 4. Train (shape-bucketed lanes)")
        fault_point("train")
        buckets: Dict[Tuple, List[int]] = {}
        for li, v in enumerate(variants):
            bkey = (payloads[li][0].shape, v.learningRate, v.epoch)
            buckets.setdefault(bkey, []).append(li)
        bucket_list: List[Tuple[Tuple, List[int]]] = []
        for bkey in sorted(buckets, key=lambda k: min(buckets[k])):
            lis = sorted(buckets[bkey])
            for lo in range(0, len(lis), cfg.lanes):
                bucket_list.append((bkey, lis[lo:lo + cfg.lanes]))
        console("    " + ", ".join(
            f"bucket[{i}]: {len(lis)} lane(s) @ n_paths={bkey[0][0]}"
            for i, (bkey, lis) in enumerate(bucket_list)))

        lane_results: List = [None] * n_lanes
        lane_emb: List = [None] * n_lanes     # [G, H] f32 on the device
        bucket_report = []
        with timer.stage("train"):
            _join(overlap, builds, "build_kernels")
            for bi, (bkey, lis) in enumerate(bucket_list):
                shape, lr, epochs = bkey
                wshape = {"n_paths": int(shape[0]), "lanes": len(lis),
                          "hidden": cfg.sizeHiddenlayer,
                          "learning_rate": lr, "max_epochs": epochs}
                if wshape not in engine.warm_shapes:
                    engine.warm_shapes.append(wshape)
                common = dict(
                    n_genes=n_genes, hidden=cfg.sizeHiddenlayer,
                    learning_rate=lr, max_epochs=epochs,
                    val_fraction=cfg.val_fraction,
                    decision_threshold=cfg.decision_threshold,
                    compute_dtype=cfg.compute_dtype,
                    param_dtype=cfg.param_dtype, device=dev, check=check)
                if len(lis) == 1:
                    li = lis[0]
                    paths, labels, _ = payloads[li]
                    lm = lane_metrics[li]
                    res = train_cbow(
                        paths, labels, seed=variants[li].train_seed,
                        on_epoch=lambda s, av, at, secs, lm=lm: lm.emit(
                            "epoch", step=s, acc_val=av, acc_tr=at,
                            secs=secs), **common)
                    lane_results[li] = res
                    lane_emb[li] = res.model.w_ih.detach().float()
                    mode = "solo"
                else:
                    specs = [LaneTrainSpec(paths=payloads[li][0],
                                           labels=payloads[li][1],
                                           seed=variants[li].train_seed)
                             for li in lis]

                    def on_epoch(b, s, av, at, secs, lis=lis):
                        lane_metrics[lis[b]].emit(
                            "epoch", step=s, acc_val=av, acc_tr=at,
                            secs=secs)

                    results, emb_stack = train_cbow_lanes(
                        specs, on_epoch=on_epoch, **common)
                    for b, li in enumerate(lis):
                        lane_results[li] = results[b]
                        lane_emb[li] = emb_stack[b]
                    mode = "lanes"
                bucket_report.append({"n_paths": int(shape[0]),
                                      "lanes": len(lis), "mode": mode,
                                      "learning_rate": lr,
                                      "max_epochs": epochs})
                for li in lis:
                    r = lane_results[li]
                    lane_metrics[li].emit(
                        "train_done", stop_epoch=r.stop_epoch,
                        acc_val=r.acc_val, acc_tr=r.acc_tr,
                        stopped_early=r.stopped_early, bucket=bi,
                        bucket_mode=mode)
                    console(f"    [lane {variants[li].name}] "
                            f"stop epoch {r.stop_epoch:3d}  "
                            f"ACC[val]={r.acc_val:.4f}  "
                            f"ACC[tr]={r.acc_tr:.4f}"
                            + ("  (early)" if r.stopped_early else ""))

        console(">>> [batch] 5. Find L-groups (across lanes)")
        fault_point("lgroups")
        freq_stack = np.stack([freq_index(data.gene, payloads[li][2])
                               for li in range(n_lanes)])
        lg_dev: List = [None] * n_lanes
        km_centers: List = [None] * n_lanes   # per lane [k, H], IVF seeds
        with timer.stage("lgroups"):
            for lo in range(0, n_lanes, cfg.lanes):
                idx = list(range(lo, min(lo + cfg.lanes, n_lanes)))
                lg, kc = find_lgroups_lanes(
                    torch.stack([lane_emb[li] for li in idx]),
                    freq_stack[idx], [variants[li].kmeans_seed for li in idx],
                    k=cfg.n_lgroups,
                    compat_tiebreak=cfg.compat_lgroup_tiebreak,
                    iters=cfg.kmeans_iters)
                kc_host = kc.cpu().numpy().astype(np.float32)
                for b, li in enumerate(idx):
                    lg_dev[li] = lg[b]
                    km_centers[li] = kc_host[b]

        console(">>> [batch] 6. Select biomarkers (per cohort)")
        fault_point("biomarkers")
        scores_host: List = [None] * n_lanes
        with timer.stage("biomarkers"):
            # Lanes score together by (cohort, label view): a permutation
            # null shares its cohort's walks but scores against its own
            # shuffled labels, as its solo run does.
            by_view: Dict = {}
            for li, v in enumerate(variants):
                by_view.setdefault((v.expr_key(), v.permute_seed),
                                   []).append(li)
            for (ek, pseed), lis in by_view.items():
                ldata = lane_data[ek]
                labels = scoring_labels(ldata.label, pseed)
                expr_good = torch.as_tensor(ldata.expr[labels == 0],
                                            device=dev)
                expr_poor = torch.as_tensor(ldata.expr[labels == 1],
                                            device=dev)
                for lo in range(0, len(lis), cfg.lanes):
                    idx = lis[lo:lo + cfg.lanes]
                    scores = biomarker_scores_lanes(
                        torch.stack([lane_emb[li] for li in idx]),
                        expr_good, expr_poor,
                        torch.stack([lg_dev[li] for li in idx]),
                        cfg.score_mix).cpu().numpy()
                    for b, li in enumerate(idx):
                        scores_host[li] = scores[b]

        console(">>> [batch] 7. Save results (per lane)")
        fault_point("save")
        results_out: List = []
        with timer.stage("save"):
            for li, v in enumerate(variants):
                lgroup_idx = lg_dev[li].cpu().numpy()
                biomarkers, _ = top_biomarkers(
                    scores_host[li], lgroup_idx, data.gene, cfg.numBiomarker)
                name = f"{cfg.result_name}.{v.name}"
                r = lane_results[li]
                outputs = [
                    write_biomarkers(name, biomarkers),
                    write_lgroups(name, lgroup_idx, data.gene),
                    write_vectors(name, r.w_ih, data.gene),
                ]
                paths, labels, gene_freq = payloads[li]
                results_out.append(PipelineResult(
                    genes=data.gene, embeddings=r.w_ih,
                    lgroup_idx=lgroup_idx, biomarkers=biomarkers,
                    output_files=outputs,
                    n_samples=int(lane_data[v.expr_key()].expr.shape[0]),
                    n_genes=n_genes, n_edges=n_edges,
                    n_paths=int(paths.shape[0]),
                    n_path_genes=len(gene_freq), train_history=r.history,
                    stop_epoch=r.stop_epoch, acc_val=r.acc_val,
                    device=str(dev), walker_backend=walker_backend,
                    sampler_threads=sampler_threads, paths=paths,
                    labels=labels, biomarker_scores=scores_host[li],
                    km_centers=km_centers[li]))
                lane_metrics[li].emit("done", outputs=outputs,
                                      stop_epoch=r.stop_epoch)
                for path in outputs:
                    console(f"    {path}")

        wall = time.time() - t_start
        rph = n_lanes / wall * 3600.0
        console(f"    [batch] {n_lanes} run(s) in {wall:.2f}s = "
                f"{rph:.1f} runs/hour  "
                f"(walks: {walk_stats['walked']} sampled, "
                f"{walk_stats['lane_shared']} lane-shared, "
                f"{walk_stats['disk_hits']} cache hits; "
                f"buckets: {[b['lanes'] for b in bucket_report]})")
        metrics.emit(
            "done", n_lanes=n_lanes, wall_seconds=round(wall, 3),
            runs_per_hour=round(rph, 2),
            stop_epochs={variants[li].tag(): lane_results[li].stop_epoch
                         for li in range(n_lanes)},
            walk_stats=walk_stats, buckets=bucket_report,
            stage_seconds=timer.as_dict())
        engine.batches_executed += 1
        engine.lanes_executed += n_lanes
        return BatchResult(
            lanes=results_out, variants=variants, wall_seconds=wall,
            runs_per_hour=rph, walk_stats=walk_stats,
            buckets=bucket_report, stage_seconds=timer.as_dict(),
            stage_extras=timer.extras_dict())
    finally:
        # The engine outlives this batch: wait out and forget only its
        # tasks, so a failed batch leaves a quiet scheduler behind.
        overlap.prune(pfx)
        if own_metrics is not None:
            own_metrics.close()


def _join(overlap, builds: List[str], name: str) -> None:
    """Join this batch's background build ``name`` if one was started
    (re-raising its error) before the first launch of its kernel."""
    for task in builds:
        if task.endswith(":" + name):
            overlap.result(task)


def _make_walk_task(cfg, s, d, w, n_genes, *, seed, backend, tier, ckey,
                    group, device, n_threads, join):
    """One distinct walk product as a task: the tier (memo, then the
    verified disk cache), else a walk on ``backend`` stored back into the
    tier, in the span ``walk_<group>`` as the solo run's. ``join()`` waits
    for the walker kernel's background build."""
    from g2vec_tpu_torch.utils.timing import span

    def task():
        cached = tier.load(ckey)
        if cached is not None:
            return cached
        with span(f"walk_{group}"):
            if backend == "native":
                from g2vec_tpu_torch.ops.host_walker import (
                    generate_path_set_native)

                ps = generate_path_set_native(
                    s, d, w, n_genes, len_path=cfg.lenPath,
                    reps=cfg.numRepetition, seed=seed, n_threads=n_threads)
            else:
                # The card's walker: the C++ sampler's rows, byte for
                # byte, so one cache key serves both.
                from g2vec_tpu_torch.ops.device_walker import (
                    generate_path_set_device)

                join()
                ps = generate_path_set_device(
                    s, d, w, n_genes, len_path=cfg.lenPath,
                    reps=cfg.numRepetition, seed=seed, device=device)
        tier.store(ckey, ps, n_genes, meta={"group": group})
        return ps

    return task
