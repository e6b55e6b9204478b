"""The scenario engine: one biomarker run made into a study.

The port of ``g2vec_tpu/stats/``. A gene ranking from one run weighs
little until it is shown stable under patient resampling, set against a
label-shuffled null and scored on held-out patients. Three protocols do
that, each a generated manifest over one base config:

- ``plan.py``: ``--scenario bootstrap|permutation|cv`` expands into a
  seeded variant manifest; every replicate's seed is a hash of
  ``--scenario-seed``, so the plans, ids and seeds are the JAX
  package's, bit for bit;
- ``run.py``: the manifest runs as lanes on the port's
  :class:`~g2vec_tpu_torch.batch.engine.ResidentEngine` (the lane
  kernels on the card), and the replicates' lists are reduced;
- ``serve.py``: or each replicate is one serve job with an idempotency
  key of its own, so a scenario survives a daemon's death;
- ``reduce.py``: numpy reducers into ``<NAME>_stability.txt``
  (``io/writers.write_stability``).

Every replicate writes its solo run's bytes (``batch.engine.lane_config``),
and a permutation scenario walks each (cohort, group) product once: the
null lanes differ only in stage 6's labels.
"""
from g2vec_tpu_torch.stats.plan import (ScenarioPlan, derive_seed,  # noqa: F401
                                        expand_plan, plan_from_config,
                                        scenario_id, scenario_variants)
