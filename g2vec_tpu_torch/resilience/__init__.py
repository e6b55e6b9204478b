"""The durable-run layer of the port: fault injection, auto-resume and
the multi-process fleet (the port's copy of ``g2vec_tpu/resilience``).

- :mod:`g2vec_tpu_torch.resilience.faults`: a config/env-driven fault
  plan that raises, SIGKILLs, stalls or corrupts bytes at named seams.
- :mod:`g2vec_tpu_torch.resilience.supervisor`: bounded retries around
  ``pipeline.run``, in process or by re-running a child with
  ``--resume``, and the serve daemon's relaunch watchdog.
- :mod:`g2vec_tpu_torch.resilience.fleet`: heartbeats, collective
  watchdogs, stage barriers and the ``--fleet-size`` launcher that
  re-plans the mesh over the surviving ranks.
- :mod:`g2vec_tpu_torch.resilience.lifecycle`: the cooperative job
  interruptions (cancel, deadline, drain) and the admission SLOs.

Checkpoint integrity lives with the checkpoints
(:mod:`g2vec_tpu_torch.train.checkpoint`). Nothing here imports torch:
the supervisor process holds no CUDA context.
"""
