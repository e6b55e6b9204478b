"""Reading a ``torch.profiler`` Chrome trace of whole jobs.

The device-time arithmetic is a frozen copy of ``chip_smoke.py``'s
``_trace_breakdown`` (:2330-2359): CUDA kernels, copies and memsets are
the device's work, their union over a range is its busy time, the rest
is idle. Here the range is a job: the port's ``stage:<name>`` ranges of
a solo run (``--profile-dir``), or the benchmark's own ``portbench:job``
range around a batch. Each idle gap is named by the stage range it falls
in and by the longest host operation under it, if any.
"""
from __future__ import annotations

import json
import re
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
JOB_RANGE = "portbench:job"
_IDENT = re.compile(r"(?:void\s+)?([A-Za-z_][A-Za-z_0-9:]*)")


def kernel_ident(name: str) -> str:
    """A kernel's identifier without its namespaces, signature or
    template arguments: ``(anonymous namespace)::pm_fwd_kernel(unsigned
    char const*, ...)`` -> ``pm_fwd_kernel``."""
    m = _IDENT.match(name.replace("(anonymous namespace)::", "").strip())
    return m.group(1).split("::")[-1] if m else name


def _ranges(events, name_pred) -> List[Tuple[float, float, str]]:
    return [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
            if e.get("ph") == "X" and e.get("cat") != "gpu_user_annotation"
            and name_pred(e.get("name", ""))]


def summarize(path: str) -> Dict:
    """One job's trace -> {"window_s", "busy_s", "kernels": {ident:
    [seconds, count]}, "ops": {name: seconds} (kernels, copies and memsets
    by name), "gaps": [[seconds, label], ...]}."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    stages = _ranges(events, lambda n: n.startswith("stage:"))
    job = _ranges(events, lambda n: n == JOB_RANGE)
    spans = job or stages
    if not spans:
        raise RuntimeError(f"{path}: no job or stage range in the trace")
    t0 = min(s[0] for s in spans)
    t1 = max(s[1] for s in spans)
    device = [e for e in events if e.get("ph") == "X"
              and e.get("cat") in DEVICE_CATS]
    kernels: Dict[str, List[float]] = {}
    ops: Dict[str, float] = {}
    for e in device:
        ident = kernel_ident(e["name"]) if e["cat"] == "kernel" \
            else e["name"]
        if e["cat"] == "kernel":
            k = kernels.setdefault(ident, [0.0, 0])
            k[0] += e["dur"] / 1e6
            k[1] += 1
        ops[ident] = ops.get(ident, 0.0) + e["dur"] / 1e6
    busy, end, gaps_us = 0.0, t0, []
    for a, b in sorted((max(e["ts"], t0), min(e["ts"] + e["dur"], t1))
                       for e in device):
        if b <= a:
            continue
        if a > end:
            gaps_us.append((end, a))
        if b > end:
            busy += b - max(a, end)
            end = b
    if t1 > end:
        gaps_us.append((end, t1))
    host = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
            if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    gaps = []
    for a, b in sorted(gaps_us, key=lambda g: g[0] - g[1])[:10]:
        mid = (a + b) / 2
        stage = next((n for s, t, n in stages if s <= mid <= t), "job")
        under = [h for h in host if h[0] < b and h[1] > a]
        label = stage
        if under:
            label += " | " + max(under, key=lambda h: min(h[1], b)
                                 - max(h[0], a))[2]
        gaps.append([(b - a) / 1e6, label])
    return {"window_s": (t1 - t0) / 1e6, "busy_s": busy / 1e6,
            "kernels": kernels, "ops": ops, "gaps": gaps}


def merge(summaries: List[Dict]) -> Dict:
    """The traced jobs together: windows, busy time, kernels and ops
    summed; the ten longest gaps."""
    out = {"window_s": 0.0, "busy_s": 0.0, "kernels": {}, "ops": {},
           "gaps": []}
    for s in summaries:
        out["window_s"] += s["window_s"]
        out["busy_s"] += s["busy_s"]
        for k, (sec, n) in s["kernels"].items():
            acc = out["kernels"].setdefault(k, [0.0, 0])
            acc[0] += sec
            acc[1] += n
        for k, sec in s["ops"].items():
            out["ops"][k] = out["ops"].get(k, 0.0) + sec
        out["gaps"] += s["gaps"]
    out["gaps"] = sorted(out["gaps"], key=lambda g: -g[0])[:10]
    return out


def breakdown(merged: Dict) -> Dict:
    """The result line's ``breakdown``: the ten device operations that
    took the most time and the ten longest idle gaps, in seconds."""
    top = sorted(merged["ops"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[label, sec] for sec, label in merged["gaps"]]}
