"""Incremental updates: delta re-walk and warm-start fine-tune.

The port of ``g2vec_tpu/incremental.py``, the engine of the serve
daemon's ``update`` op. A cold run walks the whole graph and trains from
a seeded draw even when the inputs barely moved. An update diffs the new
inputs against the fingerprints the prior bundle generation recorded,
per owner range of genes; walks again only the changed ranges and their
1-hop frontier, on the C++ sampler; starts training from the prior
embedding; and returns what the daemon needs to publish the next
generation (io/writers.py flips the pointer).

The delta model, as the JAX package pins it:

- The gene axis splits into at most :data:`RANGE_CAP` contiguous owner
  ranges. Each (group, range) is fingerprinted over the range's outgoing
  thresholded edges and the walk parameters; the whole thresholded graph
  keeps its walk-cache key too, so an untouched group is one cache hit.
- A changed range is walked again, and so is its 1-hop frontier (every
  range that holds a neighbour of a changed range's genes). Unchanged
  ranges load their rows from the walk cache under :data:`RANGE_FAMILY`
  keys.
- This is an approximation by design (a cached range's walks wandered
  the old graph), held statistically: against a cold retrain on the same
  new inputs, |dACC| <= :data:`BAND_DACC` and top-N overlap >=
  :data:`BAND_OVERLAP` (:func:`within_band`), never bitwise.
- A change of expression or labels alone that leaves both thresholded
  graphs as they were walks nothing; inputs identical to the prior's
  fingerprints republish the prior arrays byte for byte (walked 0).

Warm start: the port's seeded draw (``models/cbow.init_params``) is
taken at the new gene count, so a new gene's row is what a cold run of
the new inputs would draw for it; the carried genes' rows are then
overwritten with the prior embedding, matched by symbol. The fine-tune is
the full-batch ``train_cbow`` (on the card, the packed kernels), with no
row bucket: the JAX package pads its fine-tune rows to a multiple of 512
only to spare XLA recompiles, and those rows are inert.

Fingerprints travel in the bundle as ``delta_fingerprints.json`` on the
manifest's lenient ``delta_`` tier: a damaged file costs one full
re-walk, never a wrong answer. The keys, fingerprints and file are the
JAX package's, so a bundle either package wrote can be updated by the
other. A cold bundle has none: its first update "bootstraps" (walks
every range and records the fingerprints), and the next update with no
delta walks nothing.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

#: Most owner ranges of the delta plan: small enough that the per-range
#: fingerprints and artifacts cost little, large enough that a 1% edge
#: delta dirties a few percent of the ranges.
RANGE_CAP = 32
#: Walk-cache family of the per-range artifacts (apart from the whole
#: graph's NATIVE_FAMILY entries).
RANGE_FAMILY = "incremental-range-v1"
#: delta_fingerprints.json format tag.
DELTA_FORMAT = "g2vec-delta-v1"
#: The statistical band an update is held to against a cold retrain.
BAND_DACC = 0.20
BAND_OVERLAP = 0.6


def resolve_ranges(n_genes: int, cap: int = RANGE_CAP
                   ) -> List[Tuple[int, int]]:
    """Contiguous owner ranges over the gene axis."""
    n_genes = int(n_genes)
    if n_genes <= 0:
        return []
    n = min(int(cap), n_genes)
    step = -(-n_genes // n)
    return [(lo, min(lo + step, n_genes))
            for lo in range(0, n_genes, step)]


def _params_tag(cfg) -> str:
    """Everything besides the graph that a group's walks depend on."""
    return (f"len_path={cfg.lenPath};reps={cfg.numRepetition};"
            f"seed={cfg.seed};threshold={cfg.pcc_threshold};"
            f"backend=native")


def range_fingerprint(s: np.ndarray, d: np.ndarray, w: np.ndarray,
                      lo: int, hi: int, params_tag: str) -> str:
    """sha256 of one owner range's outgoing thresholded edges and the
    walk parameters, in the order ``thresholded_edges`` returns them."""
    mask = (s >= lo) & (s < hi)
    h = hashlib.sha256()
    h.update(f"fmt={DELTA_FORMAT};range={lo}:{hi};"
             f"{params_tag};".encode())
    for arr, dtype in ((s[mask], np.int32), (d[mask], np.int32),
                       (w[mask], np.float32)):
        a = np.ascontiguousarray(np.asarray(arr), dtype=dtype)
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _range_walk_key(fp: str, lo: int, hi: int, n_genes: int,
                    params_tag: str) -> str:
    """Walk-cache key of one (group, range) artifact, keyed by the range's
    fingerprint and not the whole graph's (the approximation the band
    covers)."""
    h = hashlib.sha256()
    h.update(f"family={RANGE_FAMILY};range={lo}:{hi};"
             f"n_genes={n_genes};{params_tag};fp={fp}".encode())
    return h.hexdigest()


def _sha(*chunks: bytes) -> str:
    h = hashlib.sha256()
    for c in chunks:
        h.update(c)
    return h.hexdigest()


def compute_fingerprints(cfg, genes: Sequence[str], expr: np.ndarray,
                         labels: np.ndarray,
                         group_csrs: Sequence[Tuple[np.ndarray,
                                                    np.ndarray,
                                                    np.ndarray]],
                         group_ckeys: Sequence[str]) -> dict:
    """The ``delta_fingerprints.json`` payload of one publication."""
    n_genes = len(genes)
    tag = _params_tag(cfg)
    ranges = resolve_ranges(n_genes)
    groups = []
    for (s, d, w), ckey in zip(group_csrs, group_ckeys):
        s = np.asarray(s)
        groups.append({
            "ckey": ckey,
            "ranges": [range_fingerprint(s, np.asarray(d),
                                         np.asarray(w), lo, hi, tag)
                       for lo, hi in ranges]})
    return {
        "format": DELTA_FORMAT,
        "n_genes": n_genes,
        "n_ranges": len(ranges),
        "params": tag,
        "genes_sha256": _sha("\n".join(genes).encode()),
        "expr_sha256": _sha(
            np.ascontiguousarray(expr, dtype=np.float32).tobytes(),
            np.ascontiguousarray(labels, dtype=np.int32).tobytes()),
        "groups": groups,
    }


def frontier_ranges(changed: Set[int], ranges: List[Tuple[int, int]],
                    s: np.ndarray, d: np.ndarray) -> Set[int]:
    """Ranges that hold a 1-hop neighbour of a changed range's genes, over
    both edge directions."""
    if not changed or not ranges:
        return set()
    bounds = np.asarray([r[0] for r in ranges] + [ranges[-1][1]])
    in_changed = np.zeros(int(bounds[-1]), dtype=bool)
    for ri in changed:
        lo, hi = ranges[ri]
        in_changed[lo:hi] = True
    s = np.asarray(s)
    d = np.asarray(d)
    neigh = np.concatenate([d[in_changed[s]], s[in_changed[d]]]) \
        if s.size else np.empty(0, dtype=np.int64)
    if neigh.size == 0:
        return set()
    owners = np.searchsorted(bounds, np.unique(neigh), side="right") - 1
    return {int(o) for o in owners if 0 <= o < len(ranges)}


@dataclasses.dataclass
class UpdateResult:
    """What the daemon publishes and reports for one update."""
    genes: List[str]
    embeddings: np.ndarray              # float32 [G, H]
    biomarker_scores: Optional[np.ndarray]   # float32 [2, G]
    biomarkers: List[str]
    km_centers: Optional[np.ndarray]    # stage 5's centres (ANN seed)
    fingerprints: dict                  # delta_fingerprints.json payload
    acc_val: float
    stats: dict                         # mode/walked/ranges/cache_hits


def _load_inputs(cfg):
    """Stages 1-2 of the solo run: read, match labels, restrict to the
    common genes, index the edges."""
    from g2vec_tpu_torch.pipeline import preprocess_inputs, read_inputs

    return preprocess_inputs(*read_inputs(cfg))


def _group_walks(cfg, i: int, s: np.ndarray, d: np.ndarray,
                 w: np.ndarray, n_genes: int, ckey: str,
                 prior_group: Optional[dict], new_ranges_fp: List[str],
                 walk_cache, emit: Callable, group: str,
                 force_all: bool) -> Tuple[Set[bytes], dict]:
    """One group's path set under the delta plan, and its stats. Ranges
    are walked on the C++ sampler whatever ``walker_backend`` says, so
    the union over the ranges is the whole-graph call's set."""
    from g2vec_tpu_torch.ops.host_walker import (ShardPlan, edges_to_csr,
                                                 walk_shard)

    tag = _params_tag(cfg)
    ranges = resolve_ranges(n_genes)
    # The owner ranges are the shards of this plan (equal steps from 0),
    # so a range's walks are walk_shard's: each walker keyed by its global
    # index, the whole-graph call's rows byte for byte.
    plan = ShardPlan(n_starts=n_genes, reps=cfg.numRepetition,
                     starts_per_shard=ranges[0][1] - ranges[0][0],
                     len_path=cfg.lenPath)
    stats = {"ranges_total": len(ranges), "ranges_rewalked": 0,
             "walked_rows": 0, "cache_hits": 0, "outcome": "delta"}

    # A group whose graph fingerprints as before is one whole-graph cache
    # read (a cold run with this cache stored the entry).
    prior_ranges = (prior_group or {}).get("ranges")
    group_unchanged = (not force_all and prior_group is not None
                       and prior_group.get("ckey") == ckey
                       and prior_ranges == new_ranges_fp)
    if group_unchanged and walk_cache is not None:
        cached = walk_cache.load(ckey)
        if cached is not None:
            stats["outcome"] = "cache"
            stats["cache_hits"] = len(ranges)
            emit("delta_walk", group=group, **stats)
            return cached, stats

    if force_all or prior_group is None \
            or prior_group.get("ranges") is None \
            or len(prior_ranges or []) != len(ranges):
        rewalk = set(range(len(ranges)))
        stats["outcome"] = "bootstrap" if not force_all else "full"
    else:
        changed = {ri for ri, fp in enumerate(new_ranges_fp)
                   if fp != prior_ranges[ri]}
        rewalk = changed | frontier_ranges(changed, ranges, s, d)

    csr = edges_to_csr(s, d, w, n_genes)
    seed = (cfg.seed << 1) | i
    ps: Set[bytes] = set()
    for ri, (lo, hi) in enumerate(ranges):
        rkey = _range_walk_key(new_ranges_fp[ri], lo, hi, n_genes, tag)
        if ri not in rewalk and walk_cache is not None:
            cached = walk_cache.load(rkey)
            if cached is not None:
                ps |= cached
                stats["cache_hits"] += 1
                continue
            # A range artifact that is missing (a cold prior, an evicted
            # cache) is walked and counted, so "walked 0" stays honest.
        rows = walk_shard(s, d, w, n_genes, plan, ri, seed=seed,
                          n_threads=cfg.sampler_threads, csr=csr)
        rset = {row.tobytes() for row in rows}
        stats["ranges_rewalked"] += 1
        stats["walked_rows"] += int(rows.shape[0])
        if walk_cache is not None:
            walk_cache.store(rkey, rset, n_genes,
                             meta={"group": group, "range": [lo, hi]})
        ps |= rset
    if walk_cache is not None and stats["ranges_rewalked"]:
        # The whole-graph entry stays current too: the next update of an
        # unchanged group (or a cold run of these inputs) is one read.
        walk_cache.store(ckey, ps, n_genes, meta={"group": group})
    emit("delta_walk", group=group, **stats)
    return ps, stats


def run_update(cfg, prior_dir: str, *, walk_cache=None,
               epochs: int = 0, console: Callable = lambda *_: None,
               check: Optional[Callable] = None,
               emit: Optional[Callable] = None,
               init: Optional[Tuple[np.ndarray, np.ndarray]] = None,
               kmeans_centers0: Optional[np.ndarray] = None
               ) -> UpdateResult:
    """Find the delta, walk it, fine-tune from the prior, score again.

    ``cfg`` is the config of the NEW inputs (the validated job config a
    cold submit of them would run); it runs on ``cfg.device``.
    ``prior_dir`` is the prior bundle's root (its live generation is read
    through the pointer). ``epochs`` bounds the fine-tune (0:
    ``max(3, cfg.epoch // 4)``); the early stop applies within it.
    ``walk_cache`` is a ``cache.WalkCache`` (``resolve_cache_tiers``) or
    None. Publishing is the caller's: the daemon writes the returned
    arrays and fingerprints with ``write_inventory_bundle``.

    Test hooks, as ``pipeline.run`` has them: ``init = (w_ih [G, H],
    w_ho [H, 1])`` replaces the seeded draw at the new gene count (the
    carried rows are still overwritten from the prior), and
    ``kmeans_centers0 [10, k, H]`` the k-means++ draws.
    """
    import torch

    from g2vec_tpu_torch.cache import NATIVE_FAMILY, walk_cache_key
    from g2vec_tpu_torch.device import resolve_device
    from g2vec_tpu_torch.ops.graph import thresholded_edges
    from g2vec_tpu_torch.serve.inventory import _Bundle

    emit = emit or (lambda *_a, **_k: None)
    t0 = time.perf_counter()
    dev = resolve_device(cfg.device)
    prior = _Bundle(os.path.abspath(prior_dir))
    data, src, dst = _load_inputs(cfg)
    n_genes = len(data.gene)
    if n_genes == 0:
        raise ValueError("update: no common genes between the updated "
                         "network and expression inputs")
    tag = _params_tag(cfg)
    ranges = resolve_ranges(n_genes)

    # ---- fingerprint the new inputs ---------------------------------
    group_csrs, group_ckeys = [], []
    for i in range(2):
        s_k, d_k, w_k = thresholded_edges(
            data.expr[data.label == i], src, dst,
            threshold=cfg.pcc_threshold, device=dev)
        group_csrs.append((s_k, d_k, w_k))
        group_ckeys.append(walk_cache_key(
            s_k, d_k, w_k, n_genes, len_path=cfg.lenPath,
            reps=cfg.numRepetition, seed=(cfg.seed << 1) | i,
            family=NATIVE_FAMILY))
    new_fp = compute_fingerprints(cfg, list(data.gene), data.expr,
                                  data.label, group_csrs, group_ckeys)
    group_fps = [g["ranges"] for g in new_fp["groups"]]

    prior_fp = prior.fingerprints
    fp_ok = bool(prior_fp and prior_fp.get("format") == DELTA_FORMAT
                 and prior_fp.get("params") == tag)
    same_genes = list(prior.genes) == list(data.gene)

    # ---- no delta: republish the prior arrays -----------------------
    if fp_ok and same_genes \
            and prior_fp.get("genes_sha256") == new_fp["genes_sha256"] \
            and prior_fp.get("expr_sha256") == new_fp["expr_sha256"] \
            and [g.get("ckey") for g in prior_fp.get("groups", [])] \
            == group_ckeys:
        console("    [update] no delta: inputs fingerprint-identical — "
                "republishing prior arrays byte-for-byte")
        stats = {"mode": "noop", "walked_rows": 0, "ranges_rewalked": 0,
                 "ranges_total": len(ranges) * 2,
                 "cache_hits": len(ranges) * 2,
                 "prior_generation": prior.generation,
                 "wall_s": round(time.perf_counter() - t0, 3)}
        for group in ("g", "p"):
            emit("delta_walk", group=group, outcome="noop",
                 ranges_total=len(ranges), ranges_rewalked=0,
                 walked_rows=0, cache_hits=len(ranges))
        return UpdateResult(
            genes=list(prior.genes),
            embeddings=np.array(prior.embeddings, dtype=np.float32),
            biomarker_scores=(None if prior.scores is None
                              else np.array(prior.scores,
                                            dtype=np.float32)),
            biomarkers=[], km_centers=None, fingerprints=new_fp,
            acc_val=float("nan"), stats=stats)

    # ---- stage 3 under the delta plan -------------------------------
    from g2vec_tpu_torch.ops.paths import (count_gene_freq,
                                           integrate_path_sets)

    force_all = not (fp_ok and same_genes)
    path_sets, gstats = [], []
    for i, group in enumerate(("g", "p")):
        s_k, d_k, w_k = group_csrs[i]
        prior_group = None
        if fp_ok and same_genes:
            groups = prior_fp.get("groups", [])
            prior_group = groups[i] if i < len(groups) else None
        ps, st = _group_walks(cfg, i, s_k, d_k, w_k, n_genes,
                              group_ckeys[i], prior_group, group_fps[i],
                              walk_cache, emit, group,
                              force_all=force_all)
        path_sets.append(ps)
        gstats.append(st)
        if check is not None:
            check()
    paths, labels = integrate_path_sets(path_sets[0], path_sets[1], n_genes)
    if paths.shape[0] < 2:
        raise ValueError(
            "update: fewer than 2 distinct group-specific paths — the "
            "updated |PCC| graphs are too sparse")
    gene_freq = count_gene_freq(paths, labels, data.gene)

    # ---- warm-start fine-tune ---------------------------------------
    from g2vec_tpu_torch.models.cbow import CBOW, init_params
    from g2vec_tpu_torch.train.trainer import train_cbow

    hidden = cfg.sizeHiddenlayer
    train_seed = cfg.seed if cfg.train_seed is None else cfg.train_seed
    if init is None:
        base = init_params(n_genes, hidden,
                           torch.Generator().manual_seed(train_seed))
        w_ih = base.w_ih.detach().numpy().astype(np.float32)
        w_ho = base.w_ho.detach().numpy().astype(np.float32)
    else:
        w_ih = np.array(init[0], dtype=np.float32)
        w_ho = np.array(init[1], dtype=np.float32).reshape(-1, 1)
    carried = 0
    if int(prior.embeddings.shape[1]) == hidden:
        prior_idx = prior.gene_index
        old_rows = np.fromiter(
            (prior_idx.get(g, -1) for g in data.gene),
            dtype=np.int64, count=n_genes)
        have = old_rows >= 0
        w_ih[have] = np.asarray(prior.embeddings, dtype=np.float32)[
            old_rows[have]]
        carried = int(np.count_nonzero(have))
    eff_epochs = int(epochs) if epochs else max(3, cfg.epoch // 4)
    console(f"    [update] warm start: {carried}/{n_genes} rows carried "
            f"from {prior.generation or 'flat bundle'}; fine-tune "
            f"{eff_epochs} epochs")
    result = train_cbow(
        paths, labels, n_genes=n_genes, hidden=hidden,
        learning_rate=cfg.learningRate, max_epochs=eff_epochs,
        val_fraction=cfg.val_fraction,
        decision_threshold=cfg.decision_threshold,
        compute_dtype=cfg.compute_dtype, param_dtype=cfg.param_dtype,
        seed=train_seed, device=dev, check=check,
        init=CBOW(torch.from_numpy(w_ih), torch.from_numpy(w_ho)))

    # ---- stages 5-6: L-groups and the prognostic scores -------------
    from g2vec_tpu_torch.analysis import (biomarker_scores, find_lgroups,
                                          freq_index, top_biomarkers)

    emb = result.model.w_ih.detach().float()
    lgroup_dev, km_centers = find_lgroups(
        emb, freq_index(data.gene, gene_freq),
        generator=torch.Generator().manual_seed(cfg.kmeans_seed),
        k=cfg.n_lgroups, compat_tiebreak=cfg.compat_lgroup_tiebreak,
        iters=cfg.kmeans_iters, centers0=kmeans_centers0)
    label = np.asarray(data.label)
    scores2 = biomarker_scores(
        emb, torch.as_tensor(data.expr[label == 0], device=dev),
        torch.as_tensor(data.expr[label == 1], device=dev),
        lgroup_dev, cfg.score_mix).cpu().numpy()
    lgroup_idx = lgroup_dev.cpu().numpy()
    biomarkers, _ = top_biomarkers(scores2, lgroup_idx, data.gene,
                                   cfg.numBiomarker)

    walked = sum(st["walked_rows"] for st in gstats)
    rewalked = sum(st["ranges_rewalked"] for st in gstats)
    mode = "bootstrap" if any(st["outcome"] in ("bootstrap", "full")
                              for st in gstats) else (
        "expr_only" if rewalked == 0 else "delta")
    stats = {"mode": mode, "walked_rows": walked,
             "ranges_rewalked": rewalked,
             "ranges_total": sum(st["ranges_total"] for st in gstats),
             "cache_hits": sum(st["cache_hits"] for st in gstats),
             "carried_rows": carried, "n_genes": n_genes,
             "epochs": eff_epochs, "stop_epoch": result.stop_epoch,
             "prior_generation": prior.generation,
             "wall_s": round(time.perf_counter() - t0, 3)}
    return UpdateResult(
        genes=list(data.gene), embeddings=np.asarray(result.w_ih,
                                                     dtype=np.float32),
        biomarker_scores=np.asarray(scores2, dtype=np.float32),
        biomarkers=list(biomarkers),
        km_centers=km_centers.cpu().numpy().astype(np.float32),
        fingerprints=new_fp, acc_val=float(result.acc_val),
        stats=stats)


def within_band(acc_a: float, acc_b: float,
                biomarkers_a: Sequence[str],
                biomarkers_b: Sequence[str]) -> Tuple[bool, Dict]:
    """The band an update is held to against a cold retrain: |dACC| <=
    BAND_DACC and top-N biomarker overlap >= BAND_OVERLAP."""
    a, b = set(biomarkers_a), set(biomarkers_b)
    overlap = len(a & b) / max(len(a), 1)
    dacc = abs(float(acc_a) - float(acc_b))
    return (dacc <= BAND_DACC and overlap >= BAND_OVERLAP), \
        {"dacc": round(dacc, 4), "overlap": round(overlap, 4)}
