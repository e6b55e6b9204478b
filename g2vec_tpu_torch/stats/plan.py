"""Scenario planning: ``--scenario`` into a seeded, deterministic manifest.

The port's copy of ``g2vec_tpu/stats/plan.py``. A :class:`ScenarioPlan`
is the protocol, its size and a root seed. Every per-replicate seed
(subsample draws, permutations, the fold partition) comes from
``scenario_seed`` through one hash tree (:func:`derive_seed`), so a
scenario is a function of its plan and its inputs. ``_ID_FIELDS``,
:func:`derive_seed` and :func:`scenario_id` are the JAX package's
exactly: one config gets one scenario id and the same replicate seeds in
both packages, and so the same cohorts, permutations and folds.

A scenario is a generated manifest (``batch/engine.py``
``_variant_from_dict``): it excludes ``--manifest``/``--seeds``, and the
lane path (stats/run.py) and the serve path (stats/serve.py) run the
same variants.
"""
from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass
from typing import Dict, List, Tuple

from g2vec_tpu_torch.config import G2VecConfig

# Config axes that change a replicate's outputs. scenario_id hashes
# these, the plan and the input files' basenames, never result_name or a
# directory: a rerun elsewhere keeps its id and its stability file.
_ID_FIELDS = ("lenPath", "numRepetition", "sizeHiddenlayer", "epoch",
              "learningRate", "numBiomarker", "pcc_threshold", "score_mix",
              "seed", "train_seed", "kmeans_seed", "patient_subsample",
              "subsample_seed", "compute_dtype", "walker_backend")


@dataclass(frozen=True)
class ScenarioPlan:
    scenario: str        # "bootstrap" | "permutation" | "cv"
    replicates: int = 0  # bootstrap/permutation replicate count
    folds: int = 0       # cv fold count
    scenario_seed: int = 0

    @property
    def n_variants(self) -> int:
        if self.scenario == "bootstrap":
            return self.replicates
        if self.scenario == "permutation":
            return self.replicates + 1  # + the observed lane
        return self.folds


def plan_from_config(cfg: G2VecConfig) -> ScenarioPlan:
    if not cfg.scenario:
        raise ValueError("plan_from_config: config has no --scenario")
    return ScenarioPlan(scenario=cfg.scenario, replicates=cfg.replicates,
                        folds=cfg.folds, scenario_seed=cfg.scenario_seed)


def derive_seed(scenario_seed: int, index: int, role: str) -> int:
    """One node of the seed tree: a stable 31-bit seed per (root, role,
    index), from SHA-256, so neighbouring indices are uncorrelated and
    the tree is the same on every platform."""
    digest = hashlib.sha256(
        f"g2vec-scenario:{scenario_seed}:{role}:{index}".encode()).digest()
    return int.from_bytes(digest[:4], "big") & 0x7FFFFFFF


def scenario_id(plan: ScenarioPlan, cfg: G2VecConfig) -> str:
    """12-hex fingerprint naming the scenario in its artifact, its
    metrics events and its serve idempotency keys
    (``scn-<id>-<replicate>``)."""
    payload = {
        "scenario": plan.scenario,
        "replicates": plan.replicates,
        "folds": plan.folds,
        "scenario_seed": plan.scenario_seed,
        "inputs": [os.path.basename(cfg.expression_file),
                   os.path.basename(cfg.clinical_file),
                   os.path.basename(cfg.network_file)],
        "config": {k: getattr(cfg, k) for k in _ID_FIELDS},
    }
    blob = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


def expand_plan(plan: ScenarioPlan, cfg: G2VecConfig
                ) -> List[Tuple[Dict, str]]:
    """The plan as (variant dict, origin) pairs in manifest order. The
    dicts use the engine's manifest schema; ``origin`` names the
    replicate in validation errors."""
    out: List[Tuple[Dict, str]] = []
    if plan.scenario == "bootstrap":
        if plan.replicates < 1:
            raise ValueError("bootstrap scenario needs --replicates >= 1")
        frac = cfg.patient_subsample or 1.0
        for r in range(plan.replicates):
            out.append(({"name": "b%03d" % r,
                         "subsample_mode": "bootstrap",
                         "patient_subsample": frac,
                         "subsample_seed": derive_seed(
                             plan.scenario_seed, r, "bootstrap")},
                        "replicate %d" % r))
    elif plan.scenario == "permutation":
        if plan.replicates < 1:
            raise ValueError("permutation scenario needs --replicates >= 1")
        # Lane 0 is the observed run. The nulls differ from it only in
        # permute_seed, which LaneVariant.expr_key() leaves out: all R+1
        # lanes share one walk product per group.
        out.append(({"name": "obs"}, "observed"))
        for r in range(plan.replicates):
            out.append(({"name": "p%03d" % r,
                         "permute_seed": derive_seed(
                             plan.scenario_seed, r, "permutation")},
                        "replicate %d" % r))
    elif plan.scenario == "cv":
        if plan.folds < 2:
            raise ValueError("cv scenario needs --folds >= 2")
        # One stratified partition for all folds (one seed), so the
        # held-out sets cover every patient exactly once.
        part_seed = derive_seed(plan.scenario_seed, 0, "folds")
        for k in range(plan.folds):
            out.append(({"name": "f%02d" % k,
                         "subsample_mode": "fold",
                         "cv_folds": plan.folds,
                         "cv_fold": k,
                         "subsample_seed": part_seed},
                        "fold %d" % k))
    else:
        raise ValueError(f"unknown scenario {plan.scenario!r}")
    return out


def scenario_variants(plan: ScenarioPlan, cfg: G2VecConfig):
    """Expand and validate through the engine's manifest validator, so a
    generated variant obeys what a hand-written one does, and an error
    names its scenario and replicate."""
    from g2vec_tpu_torch.batch.engine import _variant_from_dict

    sid = scenario_id(plan, cfg)
    variants = []
    for i, (obj, origin) in enumerate(expand_plan(plan, cfg)):
        variants.append(_variant_from_dict(
            i, obj, cfg, origin=f"scenario {sid}, {origin}"))
    return sid, variants
