"""The port's static-analysis suite (``python -m g2vec_tpu_torch analyze``).

The port's copy of ``g2vec_tpu/analyze/``, aimed at ``g2vec_tpu_torch/``.
The port states its invariants in prose and comments, as the JAX package
does: the exactly-once argument leans on ``_idem_lock`` discipline, the
router is torch-free by contract, the fault-seam vocabulary is a registry
kept in sync by grep. These AST checkers hold them:

- ``lock-discipline`` (locks.py): ``# guarded-by:`` annotations on
  attributes of threaded classes; mutations outside the named lock,
  check-then-act across a lock release, ``holds[...]`` contracts,
  lock-order cycles.
- ``torch-purity`` (purity.py): declared torch-free modules never reach
  torch/triton through the module-level import graph, nor import them
  lazily; no module of the port imports jax, jaxlib, optax, ml_dtypes or
  the JAX package.
- ``fault-seams`` (seams.py): every ``fault_point`` literal is a
  declared seam, every declared seam has a call site and a test.
- ``metrics-schema`` (events.py): every ``MetricsWriter`` emission
  matches the declared event schema (utils/metrics_schema.py).
- ``config-doc-drift`` (configdoc.py): CLI flags vs README.md,
  SERVE_JOB_KEYS vs real config fields, serve envelope keys vs the
  protocol whitelists.
- ``epoch-stamp`` (epochs.py): every mutating router→daemon payload
  literal carries ``router_epoch``.

Checkers are pure AST + text — they never import the code under
analysis, so the suite runs in well under a second with no torch import.
Known findings live in ``g2vec_tpu_torch/analyze/baseline.json``
(shrink-only: new entries fail CI); deliberate exceptions carry an inline
``# analyze: allow[<checker-id>] <reason>`` waiver.
"""
from g2vec_tpu_torch.analyze.core import (AnalysisContext, Checker, Finding,
                                          load_baseline, run_analysis)

__all__ = ["AnalysisContext", "Checker", "Finding", "load_baseline",
           "run_analysis"]
