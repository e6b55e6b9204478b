"""Entry ``batch``: one batch through
``g2vec_tpu_torch.batch.engine.run_batch`` (its lanes from the mix's
``batch_seeds`` and ``lanes`` flags), traced in the benchmark's own
``portbench:job`` range: the batch engine has no stage ranges."""
import os

from jobs import Unit, packed_work

#: Jobs of a ``--trace 1`` window that run under the profiler.
TRACED_JOBS = 1


def run(cfg, seed, profile_dir):
    """(units, stage seconds) of one batch of ``cfg``: a unit a lane."""
    import torch

    from g2vec_tpu_torch.batch.engine import run_batch

    if profile_dir is None:
        res = run_batch(cfg, console=lambda s: None)
    else:
        from torch.profiler import ProfilerActivity, profile

        from tracing import JOB_RANGE

        acts = [ProfilerActivity.CPU]
        if cfg.device == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            with torch.profiler.record_function(JOB_RANGE):
                res = run_batch(cfg, console=lambda s: None)
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
    units = [Unit(seed, v.train_seed, v.kmeans_seed,
                  f"{cfg.result_name}.{v.name}", r)
             for v, r in zip(res.variants, res.lanes)]
    return units, dict(res.stage_seconds)


def work(rec, config):
    """The traced batch's lane-kernel bounds: ``pm_fwd_lanes_kernel`` and
    the lane backward's launches as counted (``launches["lanes_fwd"]``,
    ``["lanes_bwd"]``), each over the lanes still training in it."""
    return packed_work(rec, config, "lanes_fwd", "lanes_bwd")
