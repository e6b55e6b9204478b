"""Edited copies of the device walker's kernels, timed beside them.

``csrc/device_walker.cu`` walks each walker with a group of lanes, 8
(``kNarrow``) where every row of the CSR fits 8 slots and 16 (``kWide``)
where one does not. This module builds copies of that source with both
set to each of :data:`GROUPS` (groups wider than 8 also with the chunk's
float64 sum as a loop over the eligible slots, :data:`LOOP_SUM`), loads
each as a library of its own and launches it, and the source as it is
("the plan"), through the wrapper (``device_walker.device_walk`` and
``device_walk_states``) on:

- the example's group g (G 5,850, out-degree at most 7): all 58,500
  walkers, and one shard of the streaming plan (2,040 walkers);
- the G 20,000 scale-free graph of ``data/synth.py`` (seed 0), its edges
  weighted by group g's |PCC| and kept above 0.5, directed as the network
  lists them (out-degree at most 3): 40,000 walkers and 2,000;
- the same edges listed both ways, as a network that lists each
  interaction in both directions gives them: the hubs' in-edges become
  out-edges (out-degree up to about 420);
- the both-ways graph with each row cut to its first ``k`` slots, ``k``
  in :data:`CAPS` (where the widest row crosses from one group to the
  next), under the groups of :data:`CAP_GROUPS`;
- the states kernel's first advance of the example's and the both-ways
  graph's walkers from their first states, over the first half of the
  genes (and of the cut graphs').

Every copy's rows are held byte-equal to the C++ walker's and its states
to the C++ advance's. Times are CUDA events, median of 10 launches after a
256 MiB L2 flush, in two rounds of opposite order.

Run on a machine with an NVIDIA Hopper card, from the repository root:

    python -m g2vec_tpu_torch.ops.device_walker_probe

It prints the card's name and power limit first and last.
"""
from __future__ import annotations

import contextlib
import copy
import ctypes
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from g2vec_tpu_torch.native._build import build
from g2vec_tpu_torch.ops import device_walker as dw

#: The groups timed side by side.
GROUPS = (4, 8, 16, 32)
#: The source as it is: the wrapper's choice of group.
PLAN = "the plan"
#: The chunk's sum for groups wider than 8: the lanes walk the eligible
#: slots in order, one shuffle and one add each, instead of every lane
#: adding every slot up to its own.
LOOP_SUM = """    {
        unsigned b = s.bits;
        for (int i = Group<T>::max(__popc(b)); i > 0; --i) {
            const int j = b ? __ffs(b) - 1 : 0;
            const float v = g.shfl(wk, j);
            if (b) {
                run = __dadd_rn(run, static_cast<double>(v));
                if (j == static_cast<int>(g.rank)) s.cum = run;
                b &= b - 1u;
            }
        }
    }
"""
SUM_BEGIN = "    // Each lane sums the slots up to its own"
SUM_END = "    run = g.shfl(cum, T - 1);\n"
#: The widest rows of the cut both-ways graphs, and the groups timed there.
CAPS = (8, 12, 16, 24, 32, 64, 128)
CAP_GROUPS = (8, 16, 32)
#: The example's streaming shard timed (the slowest of the 29 in the
#: smoke run that first timed them).
SHARD = 11
N_TIMED = 10


def source() -> str:
    with open(dw.SRC) as f:
        return f.read()


def with_group(src: str, group: int, loop_sum: bool) -> str:
    """``src`` with every walker walked by ``group`` lanes."""
    for key in ("kNarrow", "kWide"):
        src, n = re.subn(rf"^constexpr int {key} = \d+;",
                         f"constexpr int {key} = {group};", src, flags=re.M)
        if n != 1:
            raise RuntimeError(f"{key} is not one constexpr of the source")
    if loop_sum:
        begin, end = src.index(SUM_BEGIN), src.index(SUM_END)
        src = src[:begin] + LOOP_SUM + src[end + len(SUM_END):]
    return src


def name_of(variant) -> str:
    if variant == PLAN:
        return PLAN
    group, loop_sum = variant
    return f"{group} lanes" + (", loop sum" if loop_sum else "")


def kernel_of(line: str) -> str:
    """The walker kernel a ptxas "Compiling entry function" line names,
    with its template arguments (lanes; masks in shared memory or in the
    rows), or None."""
    m = re.search(r"g2v_walk_kernelILi(\d+)ELb([01])E", line)
    if m:
        return f"walk<{m[1]}, {('rows', 'shared')[int(m[2])]}>"
    m = re.search(r"g2v_walk_states_kernelILi(\d+)E", line)
    return f"states<{m[1]}>" if m else None


def ptxas_report(log: str) -> str:
    """The walker kernels' register and spill lines of a build's report."""
    out, kernel = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            kernel = kernel_of(line)
        elif kernel and "registers" in line:
            out.append(f"{kernel}: {line.split(' : ')[-1].strip()}")
    return "; ".join(out)


def build_all(sources: dict) -> dict:
    """``{name: (library, ptxas report)}``, each source built in parallel."""
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for i, (name, text) in enumerate(sources.items()):
            paths[name] = os.path.join(tmp, f"device_walker_copy{i}.cu")
            with open(paths[name], "w") as f:
                f.write(text)
        with ThreadPoolExecutor(min(len(paths), os.cpu_count() or 1)
                                ) as pool:
            built = dict(zip(paths, pool.map(
                lambda p: build(p, dw.nvcc_command()), paths.values())))
    libs = {}
    for name, (so, log) in built.items():
        lib = ctypes.CDLL(so)
        dw._configure(lib)
        libs[name] = (lib, ptxas_report(log))
    return libs


@contextlib.contextmanager
def using(lib):
    """The wrapper launches ``lib``'s kernels inside the block."""
    saved = dw._lib
    dw._lib = lambda: lib
    try:
        yield
    finally:
        dw._lib = saved


def time_ms(fn, flush, restore=(), n=N_TIMED):
    """(median, min, max) device ms of ``fn`` over ``n`` launches, each
    after ``restore`` (pairs of tensors: the first set from the second,
    outside the events), an L2 flush and a sleep kernel that keeps the
    card busy while the host enqueues ``fn`` (which must not wait for the
    card)."""
    times = []
    for _ in range(n + 1):
        for dst, src in restore:
            dst.copy_(src)
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    times = sorted(times[1:])
    return times[len(times) // 2], times[0], times[-1]


def example_csr():
    """The example's group g as the pipeline weights it: ``(G, CSR)``."""
    from g2vec_tpu_torch.data.synthetic import SCALES, write_synthetic_tsv
    from g2vec_tpu_torch.io.readers import (load_clinical, load_expression,
                                            load_network)
    from g2vec_tpu_torch.ops.graph import thresholded_edges
    from g2vec_tpu_torch.ops.host_walker import edges_to_csr
    from g2vec_tpu_torch.pipeline import preprocess_inputs

    with tempfile.TemporaryDirectory() as tmp:
        files = write_synthetic_tsv(SCALES["example"], tmp, prefix="example")
        data, src, dst = preprocess_inputs(
            load_expression(files["expression"]),
            load_clinical(files["clinical"]), load_network(files["network"]))
    g = data.expr.shape[1]
    return g, edges_to_csr(*thresholded_edges(
        data.expr[data.label == 0], src, dst, device="cuda"), g)


def synth_csrs():
    """The G 20,000 graph's group-g edges: ``(G, directed CSR, both-ways
    CSR)``."""
    from g2vec_tpu_torch.data.synth import SynthGraphSpec, make_synth_graph
    from g2vec_tpu_torch.ops.graph import thresholded_edges
    from g2vec_tpu_torch.ops.host_walker import edges_to_csr

    _, _, labels, expr, (src, dst) = make_synth_graph(
        SynthGraphSpec(n_genes=20_000, seed=0))
    g = expr.shape[1]
    s, t, w = thresholded_edges(expr[labels == 0], src.astype(np.int32),
                                dst.astype(np.int32), device="cuda")
    both = (np.concatenate([s, t]), np.concatenate([t, s]),
            np.concatenate([w, w]))
    return g, edges_to_csr(s, t, w, g), edges_to_csr(*both, g)


def capped(csr, k):
    """``csr`` with each row cut to its first ``k`` slots."""
    indptr, indices, weights = csr
    deg = np.diff(indptr)
    keep = (np.arange(indices.size) - np.repeat(indptr[:-1], deg)) < k
    new = np.concatenate([[0], np.cumsum(np.minimum(deg, k))])
    return new.astype(np.int32), indices[keep], weights[keep]


def walk_case(name, g, csr, starts, ids, seed):
    """A one-shot walk case: the wrapper's arguments on the card and the
    C++ walker's rows."""
    from g2vec_tpu_torch.native.walker_bindings import walk_paths_packed

    dev = dw.upload_csr(csr, g, "cuda")
    args = (dev.indptr, dev.indices, dev.weights,
            torch.from_numpy(np.ascontiguousarray(starts, np.int32)).cuda(),
            torch.from_numpy(np.ascontiguousarray(ids, np.uint64)
                             .view(np.int64)).cuda(), 80, seed, g)
    want = walk_paths_packed(*csr, g, starts, ids, 80, seed)
    return {"name": name, "args": args, "want": want,
            "degree": int(np.diff(csr[0]).max())}


def states_case(name, g, csr, n_walkers, seed):
    """A states case: walkers from their first states at every gene in
    turn, advanced over genes [0, G/2); the card's inputs and the C++
    advance's states and status."""
    from g2vec_tpu_torch.native.walker_bindings import init_walk_state
    from g2vec_tpu_torch.ops.host_walker import (WalkStateBatch,
                                                 advance_walk_states)

    starts = (np.arange(n_walkers) % g).astype(np.int32)
    paths = np.full((n_walkers, 80), -1, np.int32)
    paths[:, 0] = starts
    states = WalkStateBatch(
        row=np.arange(n_walkers, dtype=np.int32), cur=starts.copy(),
        rng=init_walk_state(seed, np.arange(n_walkers, dtype=np.uint64)),
        pos=np.ones(n_walkers, np.int32), paths=paths)
    avail = (np.arange(g) < g // 2).astype(np.uint8)
    dev = dw.upload_csr(csr, g, "cuda")
    pristine = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in (
        states.cur, states.rng.view(np.int64), states.pos, states.paths)]
    want = copy.deepcopy(states)
    status = advance_walk_states(want, csr, g, avail, 80, n_threads=8)
    return {"name": name, "csr": (dev.indptr, dev.indices, dev.weights,
                                  torch.from_numpy(avail).cuda()),
            "pristine": pristine, "want": want, "status": status,
            "degree": dev.max_degree}


def hold_walk(case, lib) -> None:
    with using(lib):
        got = dw.device_walk(*case["args"],
                             max_degree=case["degree"]).cpu().numpy()
    if got.tobytes() != case["want"].tobytes():
        raise RuntimeError(f"{case['name']}: rows differ from the C++ "
                           f"walker's")


def hold_states(case, lib) -> None:
    work = [t.clone() for t in case["pristine"]]
    with using(lib):
        status = dw.device_walk_states(*case["csr"], *work, 80,
                                       max_degree=case["degree"])
    want = case["want"]
    for field, t in zip(("cur", "rng", "pos", "paths"), work):
        arr = t.cpu().numpy()
        arr = arr.view(np.uint64) if field == "rng" else arr
        if not np.array_equal(arr, getattr(want, field)):
            raise RuntimeError(f"{case['name']}: {field} differs from the "
                               f"C++ advance's")
    if not np.array_equal(status.cpu().numpy(), case["status"]):
        raise RuntimeError(f"{case['name']}: status differs")


def spread(t) -> str:
    return f"{t[0]:.4f} [{t[1]:.4f}, {t[2]:.4f}]"


def main() -> int:
    if not torch.cuda.is_available():
        print("device_walker_probe: torch sees no CUDA device",
              file=sys.stderr)
        return 2
    from g2vec_tpu_torch.ops.host_walker import plan_shards

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    src = source()
    variants = [PLAN] + [(k, False) for k in GROUPS] + [
        (k, True) for k in GROUPS if k > 8]
    t0 = time.perf_counter()
    libs = build_all({v: src if v == PLAN else with_group(src, *v)
                      for v in variants})
    print(f"built {len(libs)} copies in {time.perf_counter() - t0:.1f} s")
    for v in variants:
        print(f"  {name_of(v)}: ptxas {libs[v][1]}")

    g5, ex = example_csr()
    g20, directed, both = synth_csrs()
    plan = plan_shards(g5, 10, 0, len_path=80)
    sh_starts, sh_ids = dw._shard_init(plan, min(SHARD, plan.n_shards - 1))
    walks = [
        walk_case("example group g, 58,500 walkers", g5, ex,
                  np.tile(np.arange(g5, dtype=np.int32), 10),
                  np.arange(10 * g5, dtype=np.uint64), 6),
        walk_case(f"example group g, streaming shard {SHARD} "
                  f"({sh_starts.size} walkers)", g5, ex, sh_starts, sh_ids,
                  6),
    ]
    for label, csr in (("directed", directed), ("both ways", both)):
        for n in (40_000, 2_000):
            walks.append(walk_case(
                f"G 20,000 {label}, {n:,} walkers", g20, csr,
                np.tile(np.arange(n // 2, dtype=np.int32), 2),
                np.arange(n, dtype=np.uint64), 9))
    states = [states_case("states, example group g, 58,500 walkers", g5, ex,
                          58_500, 3),
              states_case("states, G 20,000 both ways, 40,000 walkers", g20,
                          both, 40_000, 3)]
    cap_groups = [PLAN] + [(k, False) for k in CAP_GROUPS]
    for k in CAPS:
        cut = capped(both, k)
        for n in (40_000, 2_000):
            walks.append(walk_case(
                f"G 20,000 both ways cut to {k} slots, {n:,} walkers", g20,
                cut, np.tile(np.arange(n // 2, dtype=np.int32), 2),
                np.arange(n, dtype=np.uint64), 9))
            walks[-1]["variants"] = cap_groups
        states.append(states_case(
            f"states, G 20,000 both ways cut to {k} slots, 40,000 walkers",
            g20, cut, 40_000, 3))
        states[-1]["variants"] = cap_groups
    for case in walks:
        print(f"  {case['name']}: largest out-degree {case['degree']} "
              f"(the plan: {dw.group_for(case['degree'])} lanes)")
    for case in walks:
        for v in case.get("variants", variants):
            hold_walk(case, libs[v][0])
    for case in states:
        for v in case.get("variants", variants):
            hold_states(case, libs[v][0])
    print(f"every copy's rows = the C++ walker's and states = the C++ "
          f"advance's, on all {len(walks)} walk and {len(states)} states "
          f"cases")

    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    times = {}
    for rnd, order in enumerate((variants, variants[::-1])):
        for v in order:
            lib = libs[v][0]
            with using(lib):
                for case in walks:
                    if v not in case.get("variants", variants):
                        continue
                    t = time_ms(lambda: dw.device_walk(
                        *case["args"], max_degree=case["degree"]), flush)
                    times.setdefault((case["name"], v), []).append(t)
                for case in states:
                    if v not in case.get("variants", variants):
                        continue
                    work = [t.clone() for t in case["pristine"]]
                    t = time_ms(lambda: dw.device_walk_states(
                        *case["csr"], *work, 80, max_degree=case["degree"]),
                        flush,
                        restore=list(zip(work, case["pristine"])))
                    times.setdefault((case["name"], v), []).append(t)
    del flush
    print("median ms of 10 [min, max], round 1 | round 2:")
    for case in walks + states:
        print(f"  {case['name']}:")
        for v in case.get("variants", variants):
            r1, r2 = times[(case["name"], v)]
            print(f"    {name_of(v)}: {spread(r1)} | {spread(r2)}")
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
