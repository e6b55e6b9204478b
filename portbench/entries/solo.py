"""Entry ``solo``: one run through ``g2vec_tpu_torch.pipeline.run``, with
a traced job's trace written by the port's own ``--profile-dir`` (its
``stage:<name>`` ranges)."""
from jobs import Unit, packed_work

#: Jobs of a ``--trace 1`` window that run under the profiler.
TRACED_JOBS = 1


def run(cfg, seed, profile_dir):
    """(units, stage seconds) of one run of ``cfg``."""
    import dataclasses

    from g2vec_tpu_torch.pipeline import run as pipeline_run

    cfg = dataclasses.replace(cfg, profile_dir=profile_dir)
    res = pipeline_run(cfg, console=lambda s: None)
    return ([Unit(seed, seed, seed, cfg.result_name, res)],
            dict(res.stage_seconds))


def work(rec, config):
    """The traced run's packed-kernel bounds: ``pm_fwd_kernel`` and
    ``pm_bwd_kernel`` launches as counted (``launches["fwd"]``,
    ``["bwd"]``)."""
    return packed_work(rec, config, "fwd", "bwd")
