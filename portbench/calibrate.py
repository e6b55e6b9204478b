"""The readings that a cell's limits are set from.

    python3 portbench/calibrate.py --workload <cell> --seeds 1 2 3 ... \
        [--jobs 0 6] [--faults none half_batch ...] \
        [--control-seeds 1 2 3] [--out chiprun_out/calib.jsonl]

For each seed it makes the cell's inputs, runs the cell's timed path
(the same job driver, one warm-up job first) for each of ``--jobs``
(default job 0: job k of a run uses seed ``--seed + k * seed_stride``
over the inputs of ``--seed``), and judges what it produced: with the
fault ``none``, the lower readings; with a fault of ``faults.FAULTS``
planted in the port underneath the jobs, the readings of that fault.
Beside each sound reading it reads the control of stage 5: the
reference's k-means of the program's embeddings in bfloat16, judged as
the program's clustering would be (``detail.control_kmeans``,
``detail.control_centres``). For each control seed it puts the whole
reference in the program's place, computed a precision lower than the
configuration states (``reference.plain.Precision.control``: |PCC|,
k-means and scores in bfloat16, the trainer's products in float8 e4m3),
and judges that the same way: the upper readings. One line of JSON a
reading. The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))

import harness  # noqa: E402
from faults import FAULTS  # noqa: E402

#: Lanes of a batch cell that the control stands in for, a seed.
CONTROL_LANES = 1


def _control_kmeans(out, run, kmeans_seed, device):
    """The reference's k-means of the program's embeddings in bfloat16,
    judged as the program's clustering would be."""
    import torch

    from reference import judge, plain

    _, centres, _ = plain.kmeans(out.w_ih, run["n_lgroups"],
                                 run["kmeans_iters"], kmeans_seed,
                                 dtype=torch.bfloat16, device=device)
    return judge.kmeans_gaps(out.w_ih, centres, run, kmeans_seed, device)


def readings(ns, seeds, control_seeds, device="cuda", emit=print,
             job_indices=(0,), fault_names=("none",)):
    import faults
    import gen
    import jobs
    from reference import judge, plain

    config, run = ns.config, ns.config["run"]
    warm = False
    for seed, control in ([(s, False) for s in seeds]
                          + [(s, True) for s in control_seeds]):
        t0 = time.perf_counter()
        ds = gen.make_dataset(config["data"], seed)
        graph = plain.common_graph(ds.names, ds.samples, ds.labels,
                                   ds.expr_rows, ds.expr_values(), ds.src,
                                   ds.dst)
        stage3 = {seed: plain.stage3(graph, run, seed)}
        judged = []                 # (fault, job, judgement)
        if control:
            prec = plain.Precision.control()
            c3 = plain.stage3(graph, run, seed, prec)
            lanes = ns.mix.get("flags", {}).get("batch_seeds", 1) or 1
            for lane in range(min(lanes, CONTROL_LANES)):
                out = plain.run_reference(graph, run, seed, seed + lane,
                                          seed + lane, device, prec,
                                          stage3_out=c3)
                judged.append(("control", 0, judge.judge_run(
                    out, graph, run, seed + lane, seed + lane, device,
                    stage3[seed])))
        else:
            with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
                files = gen.write_tsvs(ds, os.path.join(tmp, "data"))
                driver = jobs.Driver(config, ns.mix, files, tmp, device)
                if not warm:
                    driver.load_kernels()
                    driver.job(0, seed + harness.WARMUP_OFFSET)
                    warm = True
                for name in fault_names:
                    patch = faults.Patch()
                    if name != "none":
                        FAULTS[name](patch)
                    try:
                        for k in job_indices:
                            try:
                                rec = driver.job(k, seed)
                            except Exception as exc:  # a fault may crash
                                if name == "none":
                                    raise
                                emit(json.dumps({
                                    "workload": ns.cell["name"],
                                    "seed": seed, "job": k, "fault": name,
                                    "crashed": repr(exc)[:500]}))
                                continue
                            for u in rec.units:
                                if u.walk_seed not in stage3:
                                    stage3[u.walk_seed] = plain.stage3(
                                        graph, run, u.walk_seed)
                                out = jobs.run_output(u)
                                j = judge.judge_run(
                                    out, graph, run, u.train_seed,
                                    u.kmeans_seed, device,
                                    stage3[u.walk_seed])
                                if name == "none":
                                    (j["detail"]["control_kmeans"],
                                     j["detail"]["control_centres"]) = \
                                        _control_kmeans(out, run,
                                                        u.kmeans_seed,
                                                        device)
                                judged.append((name, k, j))
                    finally:
                        patch.undo()
        for i, (name, k, j) in enumerate(judged):
            emit(json.dumps({"workload": ns.cell["name"], "seed": seed,
                             "job": k, "fault": name,
                             "control": name == "control", "unit": i,
                             "correct": judge.verdict(j["numbers"],
                                                      ns.limits),
                             "numbers": j["numbers"],
                             "failed": j["failed"],
                             "detail": j.get("detail"),
                             "seconds": time.perf_counter() - t0}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--jobs", type=int, nargs="*", default=[0])
    ap.add_argument("--faults", nargs="*", default=["none"],
                    choices=["none"] + sorted(FAULTS))
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    ns = harness.resolve(args.workload)
    sink = open(args.out, "a") if args.out else None

    def emit(line):
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    readings(ns, args.seeds, args.control_seeds, emit=emit,
             job_indices=args.jobs, fault_names=args.faults)
    return 0


if __name__ == "__main__":
    sys.exit(main())
