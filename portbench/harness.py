"""One run of one benchmark cell: set-up, the measured window, the
per-layer readings of a traced run, and the check against the reference.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` prints one JSON line last on standard output. The cell
names a configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<mix>.json``, whose ``entry`` names ``entries/<entry>.py``)
in ``BENCHMARK.json``; its limits are in ``limits/<cell>.json``; each
end-to-end metric is read by ``end_to_end/<metric>.py`` and each
per-layer metric by ``metrics/<metric>.py``.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
import traceback
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

#: The warm-up job's base seed is this far past the run's, outside the
#: window's sequence.
WARMUP_OFFSET = 1_000_003
#: Top-level module names that the run's process may not hold.
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "g2vec_tpu")


def load_json(*parts: str) -> Dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def resolve(workload: str) -> SimpleNamespace:
    """The cell's entries: benchmark, cell, config, mix, limits."""
    bench = load_json(ROOT, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; "
                         f"cells: {sorted(cells)}")
    cell = cells[workload]
    return SimpleNamespace(
        bench=bench, cell=cell,
        config=load_json(HERE, "configs", cell["config"] + ".json"),
        mix=load_json(HERE, "traffic", cell["traffic"] + ".json"),
        limits=load_json(HERE, "limits", workload + ".json"))


def forbidden_modules() -> List[str]:
    """Modules of the JAX stack or the JAX package in this process,
    compared by whole top-level name."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def read_metric(name: str, ctx, folder: str = "metrics") -> Optional[float]:
    """``<folder>/<name>.py``'s ``read(ctx)``: a number, or None when the
    run gave it nothing to read. End-to-end metrics are read from
    ``end_to_end/``, per-layer ones from ``metrics/``."""
    path = os.path.join(HERE, folder, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{folder}_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def _walk_work(config: Dict, graph) -> float:
    """One job's walker launches' bound (seconds): a launch a group."""
    from roofline import HBM_BYTES_PER_S, walk_bytes
    from reference.plain import group_csr

    run = config["run"]
    g = graph.genes.size
    total = 0
    for group in (0, 1):
        _, indices, _ = group_csr(graph, group, run["pcc_threshold"])
        total += walk_bytes(g, indices.size, g * run["numRepetition"])
    return total / HBM_BYTES_PER_S


def run_cell(ns: SimpleNamespace, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             log=lambda s: print(s, file=sys.stderr)) -> Dict:
    """Set-up, window, readings and check; returns the result line."""
    import torch

    import gen
    import jobs
    import tracing
    from reference import judge, plain

    t_start = time.perf_counter() if t_start is None else t_start
    config, mix = ns.config, ns.mix
    tmp = tempfile.mkdtemp(prefix="portbench-")
    try:
        if device == "cuda":
            torch.cuda.init()
            torch.empty(1, device="cuda")
        ds = gen.make_dataset(config["data"], seed)
        files = gen.write_tsvs(ds, os.path.join(tmp, "data"))
        driver = jobs.Driver(config, mix, files, tmp, device)
        driver.load_kernels()
        driver.job(0, seed + WARMUP_OFFSET)
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - t_start

        # The window: whole jobs back to back until one ends past it.
        pick = int(np.random.default_rng([seed, 20]).integers(0, 2))
        # The first jobs of a traced window run under the profiler, the
        # same ones on every commit; the others time the stages.
        n_traced = driver.entry.TRACED_JOBS if trace else 0
        records, failed, kept, last = [], 0, {}, None
        t0 = time.perf_counter()
        while True:
            k = len(records) + failed
            pdir = os.path.join(tmp, f"trace{k}") if k < n_traced else None
            try:
                rec = driver.job(k, seed, pdir)
            except Exception:  # an answer that never comes
                failed += 1
                log(f"[portbench] job {k} failed:\n{traceback.format_exc()}")
                rec = None
            if rec is not None:
                h = config["run"]["sizeHiddenlayer"]
                frac = config["run"]["val_fraction"]
                rec.shapes = [
                    (len(u.result.genes), h, u.result.paths.shape[0],
                     int(u.result.paths.shape[0] * (1.0 - frac)),
                     len(u.result.train_history)) for u in rec.units]
                if pdir is not None:
                    rec.traced = tracing.summarize(
                        os.path.join(pdir, "trace.json"))
                    rec.traced.update(driver.entry.work(rec, config))
                    shutil.rmtree(pdir, ignore_errors=True)
                if k == pick:
                    driver.keep_files(rec)
                    kept[k] = rec
                elif last is not None and last.index not in kept:
                    for u in last.units:
                        u.result = None
                records.append(rec)
                last = rec
                log(f"[portbench] job {k}: {rec.seconds:.3f} s "
                    + json.dumps({n: round(v, 4) for n, v
                                  in rec.stage_seconds.items()}))
            if time.perf_counter() - t0 >= seconds or failed > 3:
                break
        window_s = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() if device == "cuda"
                else 0)
        found = forbidden_modules()
        if found:
            raise SystemExit(f"[portbench] the run imported {found}")

        e2e = SimpleNamespace(records=records, window_s=window_s,
                              setup_s=setup_s)
        metrics = {}
        for m in ns.bench["end_to_end"]:
            if ns.cell["name"] in m.get("workloads", [ns.cell["name"]]):
                v = read_metric(m["name"], e2e, "end_to_end")
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        out = {"correct": False, "attempted": len(records) + failed,
               "failed": failed}
        dev_info = {"platform": "gpu" if device == "cuda" else "cpu",
                    "kind": (torch.cuda.get_device_name(0)
                             if device == "cuda" else "cpu"),
                    "count": 1, "memory_peak_bytes": int(peak)}

        graph = plain.common_graph(ds.names, ds.samples, ds.labels,
                                   ds.expr_rows, ds.expr_values(), ds.src,
                                   ds.dst)
        if trace:
            walker = mix.get("flags", {}).get("walker_backend", "auto")
            traced = [r.traced for r in records if r.traced is not None]
            merged = tracing.merge(traced)
            timed = [r for r in records if r.traced is None] or records
            ctx = SimpleNamespace(
                kind=mix["entry"], walker=walker,
                jobs=timed, traced=traced, trace=merged,
                walk_bound_s=(_walk_work(config, graph) * len(traced)
                              if walker == "device"
                              else 0.0))
            metrics = {}
            for m in ns.bench["per_layer"]:
                if ns.cell["name"] not in m.get("workloads",
                                                [ns.cell["name"]]):
                    continue
                v = read_metric(m["name"], ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            dev_info.update(busy_s=merged["busy_s"],
                            window_s=merged["window_s"])
            out["breakdown"] = tracing.breakdown(merged)

        # The check, once the program's state is freed.
        torch.cuda.empty_cache() if device == "cuda" else None
        judged = []
        units = [u for k, r in kept.items() for u in r.units]
        if last is not None and last.index not in kept:
            units += last.units
        stage3 = {}
        for u in units:
            if u.walk_seed not in stage3:
                stage3[u.walk_seed] = plain.stage3(graph, config["run"],
                                                   u.walk_seed)
            judged.append(judge.judge_run(
                jobs.run_output(u), graph, config["run"], u.train_seed,
                u.kmeans_seed, device, stage3[u.walk_seed]))
        verdict = (judge.combine(judged) if judged else
                   {"numbers": {k: float("inf") for k in judge.NUMBERS},
                    "failed": ["nothing judged"]})
        out["correct"] = judge.verdict(verdict["numbers"], ns.limits,
                                       failed, len(judged))
        out["metrics"] = metrics
        out["device"] = dev_info
        checks = {k: {"value": verdict["numbers"][k],
                      "limit": ns.limits[k]} for k in judge.NUMBERS}
        checks["judged"] = {"value": len(judged), "limit": 1}
        if verdict["failed"]:
            log("[portbench] failed exact checks: "
                + ", ".join(verdict["failed"]))
        for k, v in checks.items():
            log(f"[portbench] check {k}: {v['value']!r} limit {v['limit']!r}")
        out["checks"] = checks
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None, t_start: Optional[float] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    ns = resolve(args.workload)
    import torch

    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < ns.cell["chips"]:
        print(f"[portbench] {args.workload} needs {ns.cell['chips']} CUDA "
              f"device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(ns, args.seed, args.seconds, bool(args.trace),
                   t_start=t_start)
    sys.stdout.flush()
    print(json.dumps(out))
    return 0
