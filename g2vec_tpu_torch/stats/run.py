"""Scenarios on the lane engine, and the reducer both paths share.

The port of ``g2vec_tpu/stats/run.py``. :func:`run_scenario` is what
``--scenario`` dispatches to: plan, expand, run the variants as one batch
on a :class:`~g2vec_tpu_torch.batch.engine.ResidentEngine` (replicates
share stages 1-2 and the walk products, and a bucket of lanes trains on
one launch of each packed kernel a step), then reduce the replicates'
biomarker lists into ``<NAME>_stability.txt``.

The reduction (:func:`reduce_scenario`, :func:`write_scenario_artifact`)
takes (variant, biomarker list) pairs and the preprocessed dataset, so
stats/serve.py reduces the lists of a serve fleet's result records with
the same code: one reducer, one artifact format, both substrates.

A replicate's CBOW init and k-means centres come from ``torch.Generator``
draws (the port's own), so its biomarker list is not the JAX package's;
everything before the draws (the plan, the cohorts, the permuted labels,
the fold partition, the walks, ``t_obs``/``t_null``) is, and so is the
reduction of the same lists.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from g2vec_tpu_torch.config import G2VecConfig
from g2vec_tpu_torch.io.writers import write_stability
from g2vec_tpu_torch.stats import reduce as red
from g2vec_tpu_torch.stats.plan import (ScenarioPlan, derive_seed,
                                        plan_from_config, scenario_variants)
from g2vec_tpu_torch.utils.metrics import MetricsWriter


@dataclasses.dataclass
class ScenarioResult:
    scenario: str
    scenario_id: str
    output: str                   # path of <NAME>_stability.txt
    columns: List[str]
    n_variants: int
    extras: Dict                  # reducer extras (n_replicates, acc_*...)
    walk_stats: Dict[str, int]    # the engine's walk accounting ({} on serve)
    batch: Optional[object] = None  # the lane path's engine BatchResult


def reduce_scenario(plan: ScenarioPlan, cfg: G2VecConfig, data,
                    variants: Sequence,
                    lists_by_name: Dict[str, List[str]]
                    ) -> Tuple[List[str], List[str], List[List[str]], Dict]:
    """Fold the replicates' biomarker lists into the stability table.

    ``data`` is the preprocessed full cohort (the engine's
    ``dataset(cfg)[0]["data"]``), ``variants`` the plan's LaneVariants in
    manifest order, ``lists_by_name`` each replicate's biomarker file
    lines by variant name. Returns (genes, columns, rows, extras).
    """
    genes = [str(g) for g in data.gene]
    if plan.scenario == "bootstrap":
        columns, rows, extras = red.reduce_selection(
            genes, [lists_by_name[v.name] for v in variants])
    elif plan.scenario == "permutation":
        from g2vec_tpu_torch.batch.engine import _lane_cohort
        from g2vec_tpu_torch.preprocess import permute_labels

        # The null t-statistics are recomputed on the host from the
        # cohort and permute seeds the lanes scored under: the reducer
        # needs the whole [R, G] null table, not only the selections.
        obs, nulls = variants[0], variants[1:]
        cohort = data if obs.expr_key() is None else _lane_cohort(data, obs)
        labels = np.asarray(cohort.label)
        expr = np.asarray(cohort.expr)
        t_obs = red.np_tscores(expr[labels == 0], expr[labels == 1])
        t_null = np.stack([red.np_tscores(expr[pl == 0], expr[pl == 1])
                           for pl in (permute_labels(labels, v.permute_seed)
                                      for v in nulls)])
        columns, rows, extras = red.reduce_permutation(
            genes, t_obs, t_null, lists_by_name[obs.name])
    elif plan.scenario == "cv":
        from g2vec_tpu_torch.preprocess import fold_assignments

        labels = np.asarray(data.label)
        folds = fold_assignments(labels, plan.folds,
                                 derive_seed(plan.scenario_seed, 0, "folds"))
        gene_pos = {g: i for i, g in enumerate(genes)}
        expr = np.asarray(data.expr, dtype=np.float64)
        accs = []
        for k, v in enumerate(variants):
            sel, seen = [], set()
            for g in lists_by_name[v.name]:
                if g not in seen:
                    seen.add(g)
                    sel.append(gene_pos[g])
            cols = np.asarray(sel, dtype=np.int64)
            train, test = folds != k, folds == k
            accs.append(red.centroid_accuracy(
                expr[train][:, cols], labels[train],
                expr[test][:, cols], labels[test]))
        columns, rows, extras = red.reduce_cv(
            genes, [lists_by_name[v.name] for v in variants], accs)
    else:
        raise ValueError(f"unknown scenario {plan.scenario!r}")
    return genes, columns, rows, extras


def write_scenario_artifact(plan: ScenarioPlan, sid: str,
                            cfg: G2VecConfig, data, variants: Sequence,
                            lists_by_name: Dict[str, List[str]],
                            metrics: Optional[MetricsWriter] = None
                            ) -> Tuple[str, List[str], Dict]:
    """Reduce, write ``<NAME>_stability.txt`` and emit the ``stability``
    event. The meta lines carry the run's identity and never a path, so
    a rerun into another directory writes the same bytes."""
    genes, columns, rows, extras = reduce_scenario(
        plan, cfg, data, variants, lists_by_name)
    meta: List[Tuple[str, object]] = [
        ("scenario_id", sid), ("scenario_seed", plan.scenario_seed),
        ("n_variants", len(variants))]
    if plan.scenario == "cv":
        meta.append(("folds", plan.folds))
        meta.append(("acc_mean", "%.6f" % extras["acc_mean"]))
        meta.append(("acc_ci95", "%.6f,%.6f" % (extras["ci_lo"],
                                                extras["ci_hi"])))
        meta.append(("fold_acc", ",".join(extras["fold_acc"])))
    else:
        meta.append(("replicates", plan.replicates))
    path = write_stability(cfg.result_name, plan.scenario, meta, columns,
                           genes, rows)
    if metrics is not None:
        ev = {"scenario_id": sid, "output": path, "n_genes": len(genes),
              "columns": columns, "n_replicates": extras["n_replicates"]}
        if plan.scenario == "cv":
            ev.update(acc_mean=extras["acc_mean"], ci_lo=extras["ci_lo"],
                      ci_hi=extras["ci_hi"])
        metrics.emit("stability", **ev)
    return path, columns, extras


def scenario_event(plan: ScenarioPlan, sid: str, n_variants: int,
                   via: str) -> Dict:
    """The ``scenario`` event's fields (both paths emit it)."""
    ev = {"scenario": plan.scenario, "scenario_id": sid,
          "scenario_seed": plan.scenario_seed, "n_variants": n_variants,
          "via": via}
    if plan.scenario == "cv":
        ev["folds"] = plan.folds
    else:
        ev["replicates"] = plan.replicates
    return ev


def run_scenario(cfg: G2VecConfig,
                 console: Callable[[str], None] = print,
                 check: Optional[Callable[[], None]] = None
                 ) -> ScenarioResult:
    """Run ``cfg``'s scenario end to end on the lane engine, on
    ``cfg.device`` (the card unless ``cpu``)."""
    from g2vec_tpu_torch.batch.engine import ResidentEngine

    cfg.validate()
    plan = plan_from_config(cfg)
    sid, variants = scenario_variants(plan, cfg)
    metrics = MetricsWriter(cfg.metrics_jsonl)
    try:
        metrics.emit("scenario", **scenario_event(plan, sid, len(variants),
                                                  "lanes"))
        console(f"scenario {plan.scenario} ({sid}): "
                f"{len(variants)} variants as one lane batch")
        with ResidentEngine(cache_dir=cfg.cache_dir) as engine:
            batch = engine.execute(cfg, variants, console=console,
                                   metrics=metrics, check=check)
            bundle, _ = engine.dataset(cfg)
        lists_by_name = {}
        for i, (v, lane) in enumerate(zip(batch.variants, batch.lanes)):
            lists_by_name[v.name] = list(lane.biomarkers)
            metrics.emit("replicate", name=v.name, index=i,
                         n_selected=len(set(lane.biomarkers)),
                         acc_val=float(lane.acc_val))
        path, columns, extras = write_scenario_artifact(
            plan, sid, cfg, bundle["data"], batch.variants, lists_by_name,
            metrics)
        console(f"scenario {sid}: wrote {path} "
                f"(walked={batch.walk_stats.get('walked', 0)}, "
                f"memo_hits={batch.walk_stats.get('memo_hits', 0)})")
        return ScenarioResult(scenario=plan.scenario, scenario_id=sid,
                              output=path, columns=columns,
                              n_variants=len(variants), extras=extras,
                              walk_stats=dict(batch.walk_stats),
                              batch=batch)
    finally:
        metrics.close()
