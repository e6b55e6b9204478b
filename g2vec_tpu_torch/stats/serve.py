"""Scenarios over a serve daemon or fleet: one job a replicate, one
idempotency key each.

The port of ``g2vec_tpu/stats/serve.py``. A scenario on the lane path
dies with its process. Here every replicate is a durable job whose id is
``idem_job_id("scn-<scenario_id>-<name>")``: after a daemon's SIGKILL, a
drain or a replica's failover the caller submits again, finished
replicates dedup to their result records (exactly once), running ones
resume, and the stability file is the lane path's bytes (both paths run
:func:`~g2vec_tpu_torch.stats.run.write_scenario_artifact` and every
replicate writes its solo run's bytes).

The daemon needs no scenario concept: a replicate's variant rides the
manifest schema inside its job, and the reducer reads the biomarker
lists back through the result records' ``variants`` map.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

from g2vec_tpu_torch.config import config_from_job
from g2vec_tpu_torch.stats.plan import (expand_plan, plan_from_config,
                                        scenario_variants)
from g2vec_tpu_torch.stats.run import (ScenarioResult, scenario_event,
                                       write_scenario_artifact)
from g2vec_tpu_torch.utils.metrics import MetricsWriter


def _load_reduction_dataset(cfg):
    """The preprocessed full cohort, as the engine's ``dataset`` makes it:
    the reducer runs on the client, which need not be a serve replica."""
    from g2vec_tpu_torch.pipeline import preprocess_inputs, read_inputs

    data, _, _ = preprocess_inputs(*read_inputs(cfg))
    return data


def _read_biomarkers(path: str) -> List[str]:
    with open(path) as f:
        lines = [ln.rstrip("\n") for ln in f]
    if not lines or lines[0] != "GeneSymbol":
        raise ValueError(f"{path}: not a biomarkers file")
    return [ln for ln in lines[1:] if ln]


def run_scenario_serve(socket_path, base_job: dict, *,
                       scenario: str, replicates: int = 0, folds: int = 0,
                       scenario_seed: int = 0, state_dir: str,
                       tenant: str = "default",
                       timeout: Optional[float] = 10.0,
                       poll_deadline_s: float = 300.0, retries: int = 3,
                       priority: Optional[str] = None,
                       deadline_s: Optional[float] = None,
                       auth_token: Optional[str] = None,
                       metrics_jsonl: Optional[str] = None,
                       console: Callable[[str], None] = print
                       ) -> ScenarioResult:
    """Run a scenario as one serve job a replicate and reduce here.

    ``base_job`` is an ordinary serve job (``SERVE_JOB_KEYS`` only); the
    scenario's axes are passed as arguments and expanded here. The jobs
    go in one after the other, each under a key that is a function of the
    scenario id and the replicate's name, so calling this again after any
    failure converges on the same jobs and the same artifact.
    """
    from g2vec_tpu_torch.serve import client

    cfg = config_from_job(dict(base_job))
    cfg = dataclasses.replace(cfg, scenario=scenario, replicates=replicates,
                              folds=folds, scenario_seed=scenario_seed)
    cfg.validate()
    plan = plan_from_config(cfg)
    # The whole expansion is validated before any job reaches the fleet
    # (an error names "scenario <id>, replicate <i>").
    sid, variants = scenario_variants(plan, cfg)
    metrics = MetricsWriter(metrics_jsonl)
    try:
        metrics.emit("scenario", **scenario_event(plan, sid, len(variants),
                                                  "serve"))
        console(f"scenario {plan.scenario} ({sid}): {len(variants)} "
                f"replicate jobs via {socket_path}")
        lists_by_name: Dict[str, List[str]] = {}
        for i, (obj, origin) in enumerate(expand_plan(plan, cfg)):
            name = obj["name"]
            job = dict(base_job)
            job.pop("seeds", None)
            job["variants"] = [obj]
            idem = f"scn-{sid}-{name}"
            try:
                rec = client.submit_and_wait(
                    socket_path, job, tenant=tenant, state_dir=state_dir,
                    timeout=timeout, poll_deadline_s=poll_deadline_s,
                    retries=retries, priority=priority,
                    deadline_s=deadline_s, idem_key=idem,
                    auth_token=auth_token)
            except Exception as exc:
                raise RuntimeError(
                    f"scenario {sid}, {origin}: {exc}") from exc
            if rec.get("status") != "done":
                raise RuntimeError(
                    f"scenario {sid}, {origin}: job {rec.get('job_id')} "
                    f"ended with {rec.get('event')}")
            vrec = rec["variants"][name]
            bio_paths = [p for p in vrec["outputs"]
                         if p.endswith("_biomarkers.txt")]
            if len(bio_paths) != 1:
                raise RuntimeError(
                    f"scenario {sid}, {origin}: expected one biomarkers "
                    f"output, got {vrec['outputs']}")
            lists_by_name[name] = _read_biomarkers(bio_paths[0])
            metrics.emit("replicate", name=name, index=i,
                         n_selected=len(set(lists_by_name[name])),
                         acc_val=float(vrec.get("acc_val") or 0.0))
            console(f"scenario {sid}: {origin} done "
                    f"({len(lists_by_name[name])} biomarker lines)")
        data = _load_reduction_dataset(cfg)
        path, columns, extras = write_scenario_artifact(
            plan, sid, cfg, data, variants, lists_by_name, metrics)
        console(f"scenario {sid}: wrote {path}")
        return ScenarioResult(scenario=plan.scenario, scenario_id=sid,
                              output=path, columns=columns,
                              n_variants=len(variants), extras=extras,
                              walk_stats={})
    finally:
        metrics.close()
