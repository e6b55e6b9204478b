#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (g2vec_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

It builds the port's kernels from the sources in this checkout, drives the
port's seven-stage solo run (``g2vec_tpu_torch.pipeline.run``) on the
example-scale synthetic dataset on ``cuda`` and checks what comes out,
then holds each kernel against its plain PyTorch version on the card on
the ``[train | val]`` rows that run produced (built by the trainer's own
helper, rows padded once to a multiple of 4 bytes) and times both.

Phase 3 runs with the stage overlap and the native reader on (their
defaults) and with ``--metrics-jsonl``: it checks that the stream's
``done`` record holds the run's stage seconds and that the native parser
read the input (a fallback warning fails it), then runs the CLI once in a
fresh interpreter (defaults), and the run again in process with
``--no-overlap`` (the sequential stage schedule) and with ``--no-overlap
--no-native-io`` (the Python parser), prints each run's stage seconds
(and the CLI's spans), and checks that all of them wrote byte-identical
files;
one more CLI run with ``--profile-dir`` (the same bytes) prints the
trace's CUDA kernel time by kernel name and the device's idle share over
stage ``train``.
Phase 4 goes on with: the forward's grid, its waves, the bytes of W it
streams from L2 and its tensor-core ceiling beside the backward's split;
the tile planner's sweep there (``--kernel-autotune``): every forward
layout of the tiles library (``csrc/packed_matmul_tiles.cu``), bitwise
the shipped kernel, and every backward slice count, each held against the
plain version and timed beside the dense library call, and the planner's
own entries at the trainer's two launch shapes, each in the direction the
trainer launches there (the table is reset
after, so the later phases run the heuristic plan); both kernels at the
reference's 7,523 genes; one ragged shape; the
ragged edges of both kernels; and the forward's M-invariance, bitwise,
across the edges of a wave. Phase 5 runs a small input at hidden width 10
on ``cuda`` and on the CPU. Phase 6 runs the example with ``--train-mode
streaming`` (bf16, both kernels on every shard): it checks the val
accuracy and its gap to phase 3's full-batch run, and prints their
biomarker overlap; that a rerun at ring depth 1 and one sampler thread
gives byte-identical embeddings; the whole parity band of
tests/test_stream.py (val accuracy gap and biomarker overlap) on the
medium scale (at the example scale the full-batch run stops after one
update and its k-means cuts the genes into near-equal thirds, which the
streaming run's L-groups do not follow: the overlap there is printed, not
held); and holds both kernels against their plain versions and times
them at the streaming launch shapes (the widest shard's train rows, the
full eval buffer). Phase 7 holds the device walker's kernel
(``csrc/device_walker.cu``) against its plain version on the card and the
C++ walker, byte for byte: on both example groups over all their
walkers, on every shard of the example's streaming plan, on a ragged set
(``len_path`` 1 and 2, a subset of the starts, a walker range not at 0, a
graph with duplicate edges, zero and negative weights and dead ends) and
on hub graphs (rows of 1 to 1,000 slots) under every instance its launch
plan can choose from the shapes (8 or 16 lanes a walker by the widest
row; the masks in shared memory, or in the rows at G 262,144); prints
each plan's shared memory (the ptxas lines give each instance's
registers); times the kernel (CUDA events, median of 10 after an L2
flush), its plain version, the copy of its rows to the host and the C++
walker on the same inputs, and each streaming shard's launch, the
slowest also by the host clock; runs the example in process with
``walker_backend="device"`` (the counts read after it are the kernel
line's launches, and the packed kernels' counts must be phase 3's) and
through the CLI with and without ``--walker-backend device``, once each,
both writing phase 3's bytes; runs the CLI three times with one
``--cache-dir`` (the second run and a ``--walker-backend device`` run hit
both groups' entries); and streams the example with the device walker, which trains
epoch 0 where it walks: ``W_ih`` must be phase 6's bytes and the packed
kernels' counts phase 6's, with no shard through the ring. Phase 8 runs
the durable-run drills, each under a fault plan that must fire (the
fault state file says so) and each writing its unfaulted run's bytes:
the CLI under ``--supervise`` SIGKILLed just after a streaming cursor
commits inside epoch 1 (against phase 6: files and ``W_ih``), the same
on the device feed inside epoch 0 (against phase 7; the resumed
attempt's walker launches are those of the shards from the cursor on),
the full-batch example SIGKILLed at ``lgroups`` after its final
checkpoint (against phase 3; the resumed attempt trains nothing), and
phase 5's small input at ``-l 0.002`` SIGKILLed at epoch 10 with a
checkpoint every 4 epochs; each metrics stream holds ``retry``,
``resume`` and ``supervised_done``. In process, one ``device_walk``
fault is a relaunch of the kernel (``device_recomputes`` 1, phase 7's
bytes) and two raise, and the plain walker is never called. Last, it
times ``save_state``, ``load_state`` and ``save_stream_state`` at the
example's shapes and the streaming run's ``checkpoint_wall_s`` at the
default cadence (``W_ih`` still phase 6's). Phase 9 runs the batch
engine: both lane launches (``g2v_pm_fwd_lanes``/``g2v_pm_bwd_lanes``) at
8 lanes of the example (the ``--seeds 8`` sweep's rows) and at ragged
shapes (odd M, G not a multiple of 8, odd H, a subset of the lanes),
each lane held against the plain version and, bitwise, against its solo
launch, timed beside 8 solo launches and ``torch.bmm`` on the dense bf16
stack; ``--seeds 8 --lanes 8`` in process on one ``ResidentEngine``
(the lane kernels' launch counts are read over this run; a second
``execute`` must find the dataset resident, hit the walk memo and write
the same bytes); the same through the CLI, and every lane's solo run in
process, byte for byte, with both runs/hour; a mixed manifest (two
subsamples, a CV fold, a permutation null: several buckets, one-lane
buckets among them), each lane against its solo run, and its distinct
walk products timed in turn (as the engine walks them) and on a pool;
and ``--train-mode streaming --seeds 2``
against the lanes' solo streaming runs. Phase 10 drives the serve daemon
(``python -m g2vec_tpu_torch serve``) as a child process: started with
``CUDA_VISIBLE_DEVICES=`` it must exit nonzero naming the missing card;
started on the card (``--cache-dir``, ``--metrics-jsonl``, ``--ann-nlist
16``, a TCP listener whose HTTP ``/status`` is read) it runs a first
small f32 job, during which Alice's and Bob's jobs (4 variants each: the
train and k-means seeds of phase 9's ``--seeds 8`` lanes) are admitted
and must join one batch of 8 lanes (the metrics' ``batch_start``, one
lane launch of each packed kernel a step and no solo launch, read from
the daemon's ``status``), every variant's files byte-identical to phase
9's lane of that seed; a warm job with new seeds must hit the dataset
memo and both walk products; one ``--query neighbors`` through the CLI,
then 200 queries through the client (exact and IVF ``neighbors``,
``topk_biomarkers``, ``list``, ``fquery gene_rank``) over bundles whose
manifests are verified file by file, each exact answer equal to a numpy
full sort of the bundle's table, with p50/p99 latencies printed; a
streaming job on phase 5's input is drained mid-training (the daemon
exits 0, the job journaled, a cursor saved), the daemon relaunched under
``--supervise`` resumes it from the cursor to its uninterrupted solo
run's bytes, and ``--shutdown`` ends the daemon and its supervisor with
exit 0. The lane kernels' records in the kernel line carry the joined
batch's launches (``served_launches``). Phase 11 drives the router
(``serve --replicas 2 --listen``) as a child process: started with
``CUDA_VISIBLE_DEVICES=`` it must exit nonzero, its first replica dead
during boot; then over two card replicas: the router's RSS and that it
maps no CUDA or torch library; each replica's first job (a small f32 one
sent to it straight) and the card's ``memory.used`` it added; Alice's
and Bob's jobs (phase 10's) routed behind an f32 job to the ring's owner
of their join key, joined into one 8-lane batch (3 lane forward and 2
lane backward launches, no solo launch, read through that replica's
``status``), each variant phase 9's lane's bytes; phase 10's streaming
job routed and its replica SIGKILLed at its first cursor: the router
fences it, the card's memory drops, the journal moves to the survivor,
which resumes from the cursor and writes the job's solo bytes; the
killed replica is relaunched and healthy again and runs a job sent to it
straight; one exact ``neighbors`` query through the router equals the
numpy full sort; one ``job_done`` per job id over both replicas'
metrics; ``--shutdown`` ends the fleet with exit 0. It fails past 120 s.
Phase 12 runs the scenario engine and incremental updates at the example:
``--scenario bootstrap --replicates 8`` (replicates b000 and b005 against
their solo runs, byte for byte, and a rerun's stability file against the
first's), ``--scenario permutation --replicates 8`` (``walked=2`` on a
cold cache, the lane kernels launched, the t/p/q columns against a numpy
recomputation from the lanes' labels) and ``--scenario cv --folds 5``
(the held-out sets cover every patient once), each with its wall, runs
per hour and launches; then, on a card daemon served on a UNIX socket, a
cold job and its bootstrap, no-op (the arrays the prior generation's
bytes, no launch), expression-only (no range walked) and edge-delta
(some ranges walked) updates through ``client.update_job``, each update's
wall beside the cold job's and its fine-tune's launches, an exact
``neighbors`` query from the new generation against the numpy full sort,
the same delta in process (the daemon's bytes) with its band against a
cold retrain printed; and on tests/test_update.py's spec, for seeds 0-3,
the edge delta's accuracy held within 0.20 of a cold retrain's, its list
overlap printed beside the two cold runs' own, and seed 0's update on
the card held against the CPU's.
The lane kernels' records carry the scenarios'
launches (``scenario_launches``), the solo ones the updates'
(``update_launches``).
Phase 13 runs the scale paths: a G 20,000 graph streamed with
``--walk-starts`` on one rank (and ``--graph-shards 1 --embed-shards 1``
writing its bytes), the scale-out spec (G 262,144) plain and on two ranks
sharing the card, a SIGKILL drill at ``embed_allreduce``, and the packed
kernels at the split step's shapes. Phase 14 runs the edge partition: the
resumable walk kernel (``g2v_walk_states_kernel``) on one example group's
walkers as walk states, advanced over half the genes and resumed over the
other half and back until every walk ends, each advance bitwise the C++
advance's and the plain version's and the packed rows ``walk_shard``'s,
timed beside both; then the scale-out spec written partitioned
(``write_synth_graph_streamed(..., partitions=2)``) and run with
``--edge-partition handoff`` and ``halo`` on two ranks under
``G2VEC_FORBID_FULL_NETWORK=1`` beside a plain run on the flat file: the
two write the same bytes, hold the band against the plain run, and each
rank holds fewer CSR bytes than the plain run; a rank SIGKILLed at
``walk_handoff`` is named by the survivor. Phase 15 runs the fleet at
the example: ``--distributed --mesh 2x1`` on two ranks sharing the card
writes phase 3's bytes, each rank launching twice phase 3's forwards
(fused eval is off under a mesh) and its backwards; a ``--fleet-size 2
--checkpoint-layout sharded`` run whose rank 1 is SIGKILLed at
``checkpoint_finalize`` at epoch 5 (at ``-l 0.0002``, where the example
trains 16 epochs) re-plans 2x1 to 1x1, resumes and writes its unfaulted
run's bytes (the launcher's children run through a wrapper that records
when the fault fired and, at exit, the launches), beside one sharded and
one single save's host time; and a rank SIGKILLed mid-stage under
``--fleet-watchdog-deadline 5`` is named by its peer with its phase and
last collective. Phase 16 runs the tile planner: its sweep (as in phase
4) at the launch shapes where the forward loses to the library (the
streaming shard and eval buffer, the G 20,000 shard, the split rank),
beside the library's time; two CLI runs with ``--kernel-autotune
--cache-dir D``, the first sweeping both launch shapes and the second
loading the plan (no sweep) and writing the first's bytes, val accuracy
above 0.5; a run in process under a plan installed by hand (the forward
on a layout that is not the shipped one, the backward at an S off the
heuristic's); and a ``--mesh 2x1 --kernel-autotune`` run whose two ranks
launch rank 0's plan, only rank 0 sweeping and writing. Each of these
runs is held against phase 3's untuned run: its files byte for byte where
its backward S is the heuristic's (every forward layout is bitwise the
shipped one), else ``W_ih`` within 1e-4.
Phases 12, 13, 14, 15 and 16 each fail past 150 s. Phase 17 runs the
port's static-analysis suite, ``python -m g2vec_tpu_torch analyze
--json``, in a fresh interpreter from this checkout: exit code 0, the six
checkers, no finding and no stale baseline entry, and no torch or triton
among the modules the interpreter imported (``-X importtime``); it fails
past 30 s.

Any failure raises and the script exits nonzero without printing a
result. The last three lines of standard output are: one JSON object with
a record per kernel (its ``streaming`` entry holds phase 6's launches and
times), the card's name and power limit as ``nvidia-smi`` reports them,
and the result line ``{"ok": true, "device": {...}}``. Without a CUDA
device, or outside a checkout of the repository, it exits nonzero at once.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, and f32 adds on the
# CUDA cores, where the kernels sum. The sheet's 67 TFLOP/s float32 counts
# an FMA as two operations; a plain add takes one FMA slot, so adds run at
# half that rate.
HBM_BYTES_PER_S = 3.35e12
F32_ADDS_PER_S = 33.5e12
# Dense bf16 on the tensor cores (same sheet): the ceiling of a backward
# that does the dense 2*M*G*H operations, as pm_bwd_kernel does.
BF16_TC_OPS_PER_S = 989e12
# Tolerance of a kernel against its plain version: both take f32 sums of
# the same bf16 values in different orders, so an element may differ by a
# few f32 rounding steps of its sum of absolute terms S (the sum of |term|
# over the set bits): |kernel - plain| <= RTOL*|plain| + ULPS * 2^-24 * S.
# One term dropped or added moves an element by ~S/n_terms, far above it.
RTOL, ULPS = 1e-5, 256


def _nvidia_smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def _ptxas_kernel(line) -> str:
    """The kernel a ptxas "Compiling entry function" line names; for the
    walker's kernels, with their template arguments (lanes; the masks in
    shared memory or in the rows)."""
    from g2vec_tpu_torch.ops.device_walker_probe import kernel_of

    walker = kernel_of(line)
    if walker:
        return walker
    return next((w for w in ("pm_fwd_kernel", "pm_fwd_lanes_kernel",
                             "pm_bwd_kernel", "pm_bwd_sum_kernel")
                 if w in line), line.split("'")[1] if "'" in line else "?")


def _timed(fn):
    t0 = time.perf_counter()
    return fn(), time.perf_counter() - t0


def _time_ms(fn, flush):
    """(median, min, max) device time of ``fn`` over 10 launches, each
    timed with CUDA events after the 50 MB L2 was flushed (the trainer's
    launches follow other kernels, so they find the cache cold), behind a
    sleep kernel so that the events bracket device time only."""
    from g2vec_tpu_torch.ops.packed_matmul_probe import time_ms

    return time_ms(fn, flush)


def _host_ms(torch, fn, n=20) -> float:
    """The median host time of ``fn()`` over ``n`` calls, each made while
    a sleep kernel keeps the card busy (so that the host never waits for
    it): what a launch costs the calling thread."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        torch.cuda._sleep(2_000_000)
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    times.sort()
    return times[n // 2]


def _spread(t) -> str:
    return f"{t[0]:.4f} ms [{t[1]:.4f}, {t[2]:.4f}]"


def _check_close(torch, name, got, want, abs_sum, verbose=True) -> float:
    err = (got - want).abs()
    tol = RTOL * want.abs() + ULPS * 2.0 ** -24 * abs_sum
    bad = int((err > tol).sum())
    max_err = float(err.max()) if err.numel() else 0.0
    if verbose or bad:
        print(f"    {name}: max_abs_err={max_err:.3e} "
              f"max_tol={float(tol.max()) if tol.numel() else 0.0:.3e} "
              f"violations={bad}")
    if bad or not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"{name}: kernel disagrees with its plain version")
    return max_err


def _random_packed(torch, m, g, density, gen):
    bits = torch.rand((m, g), device="cuda", generator=gen) < density
    nb = (g + 7) // 8
    padded = torch.zeros((m, nb * 8), dtype=torch.uint8, device="cuda")
    padded[:, :g] = bits
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8,
                           device="cuda")
    return (padded.view(m, nb, 8) * weights).sum(-1, dtype=torch.uint8)


def _compare_kernels(torch, pm, packed_all, n_tr, g, h, gen, flush, timed,
                     names=("packed_matmul_fwd", "packed_matmul_bwd")):
    """Each kernel of ``names`` against its plain version on these inputs
    (the forward on all rows, the backward on the first ``n_tr``); with
    ``timed``, also the kernel's, the plain version's and the library
    yardstick's times and the bound. Returns the per-kernel records."""
    w = (torch.randn((g, h), device="cuda", generator=gen) * 0.09
         ).to(torch.bfloat16)
    packed_tr = packed_all[:n_tr]
    g_out = torch.randn((n_tr, h), device="cuda",
                        generator=gen).to(torch.bfloat16)
    x_all = pm.unpack_bits(packed_all, g).float()
    records = {}
    tag = f"M={packed_all.shape[0]} G={g} H={h}"

    if "packed_matmul_fwd" in names:
        out = pm.packed_matmul_fwd(packed_all, w)
        want = pm.packed_matmul_fwd_plain(packed_all, w)
        err = _check_close(torch, f"packed_matmul_fwd {tag}", out, want,
                           x_all @ w.float().abs())
        # M-invariance: the train rows' bits do not depend on the val rows.
        if not torch.equal(pm.packed_matmul_fwd(packed_tr, w), out[:n_tr]):
            raise RuntimeError("packed_matmul_fwd is not M-invariant")
        records["packed_matmul_fwd"] = {"max_abs_err": err}

    if "packed_matmul_bwd" in names:
        dw = pm.packed_matmul_bwd(packed_tr, g_out, g)
        want = pm.packed_matmul_bwd_plain(packed_tr, g_out, g)
        err = _check_close(torch, f"packed_matmul_bwd M={n_tr} G={g} H={h}",
                           dw, want, x_all[:n_tr].T @ g_out.float().abs())
        if not torch.equal(pm.packed_matmul_bwd(packed_tr, g_out, g), dw):
            raise RuntimeError("packed_matmul_bwd is not bitwise "
                               "reproducible")
        records["packed_matmul_bwd"] = {"max_abs_err": err}
    if not timed:
        return records

    nnz_all = int(x_all.sum())
    nnz_tr = int(x_all[:n_tr].sum())
    x16_all = x_all.to(torch.bfloat16)
    x16_tr_t = x16_all[:n_tr].T.contiguous()
    nb = packed_all.shape[1]
    m_all = packed_all.shape[0]
    cases = {
        "packed_matmul_fwd": (
            lambda: pm.packed_matmul_fwd(packed_all, w),
            lambda: pm.packed_matmul_fwd_plain(packed_all, w),
            lambda: torch.matmul(x16_all, w),
            m_all * nb + g * h * 2 + m_all * h * 4, nnz_all * h),
        "packed_matmul_bwd": (
            lambda: pm.packed_matmul_bwd(packed_tr, g_out, g),
            lambda: pm.packed_matmul_bwd_plain(packed_tr, g_out, g),
            lambda: torch.matmul(x16_tr_t, g_out),
            n_tr * nb + n_tr * h * 2 + g * h * 4, nnz_tr * h),
    }
    for name in names:
        kernel, plain, library, nbytes, n_ops = cases[name]
        byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
        op_ms = n_ops / F32_ADDS_PER_S * 1e3
        rec = records[name]
        spread = {}
        for key, fn in (("ms", kernel), ("plain_ms", plain),
                        ("library_ms", library)):
            rec[key], lo, hi = _time_ms(fn, flush)
            spread[key] = f"{rec[key]:.4f} ms [{lo:.4f}, {hi:.4f}]"
        rec.update(bound_ms=max(byte_ms, op_ms),
                   bound_by="bytes" if byte_ms >= op_ms else "operations")
        print(f"    {name}: kernel {spread['ms']}, plain "
              f"{spread['plain_ms']}, library (dense bf16 matmul) "
              f"{spread['library_ms']}, bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']}: {nbytes} bytes, {n_ops} f32 adds)")
    return records


def _backward_edges(torch, pm, gen, n_genes):
    """The backward's ragged cases against its plain version: odd hidden
    widths, G not a multiple of 8, M of one row and below one ring stage,
    M one row over the first slice boundary the plan makes, and a forced
    split whose last slice holds one row."""
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    split_at = next(m for m in range(2, 1 << 16)
                    if pm._bwd_slices(m, n_genes, 128, n_sms).n_slices > 1)
    cases = [(3000, 1003, 10, None), (3000, 1003, 130, None),
             (1, n_genes, 128, None), (40, n_genes, 128, None),
             (split_at + 1, n_genes, 128, None), (2000, 999, 128, None),
             (129, 1003, 136, pm.BwdSlices(3, 64, 0))]
    for m, g, h, forced in cases:
        packed = _random_packed(torch, m, g, 80 / g, gen)
        g_out = torch.randn((m, h), device="cuda", generator=gen
                            ).to(torch.bfloat16)
        x = pm.unpack_bits(packed, g).float()
        if forced is None:
            plan = pm._bwd_slices(m, g, h, n_sms)
            dw = pm.packed_matmul_bwd(packed, g_out, g)
        else:
            plan = forced
            dw = pm._bwd_on_card(packed, g_out, g, forced)
        _check_close(torch, f"packed_matmul_bwd M={m} G={g} H={h} "
                     f"S={plan.n_slices} rows/slice={plan.rows}"
                     + (" (forced split)" if forced else ""), dw,
                     pm.packed_matmul_bwd_plain(packed, g_out, g),
                     x.T @ g_out.float().abs())


def _forward_plan_line(pm, m, g, h, n_sms) -> str:
    grid = pm._fwd_grid(m, h, n_sms)
    resident = pm.fwd_occupancy()
    if resident != pm.FWD_BLOCKS_PER_SM:
        raise RuntimeError(f"the forward keeps {resident} blocks resident on "
                           f"an SM, not the {pm.FWD_BLOCKS_PER_SM} its waves "
                           f"are counted in")
    w_bytes = -(-m // pm.FWD_BLOCK_ROWS) * g * (-(-h // 8) * 8) * 2
    ops = 2 * m * g * h
    return (f"forward tile: {pm.FWD_BLOCK_ROWS} rows x {pm.FWD_BLOCK_COLS} "
            f"columns; {grid.blocks} blocks = {grid.waves:.2f} waves of "
            f"{resident} resident blocks on {n_sms} SMs; W streamed from L2 "
            f"{w_bytes} bytes; dense tensor-core ceiling "
            f"{ops / BF16_TC_OPS_PER_S * 1e3:.4f} ms (2*M*G*H = {ops:.3e} "
            f"bf16 operations)")


def _backward_plan_line(pm, m, g, h, n_sms) -> str:
    plan = pm._bwd_slices(m, g, h, n_sms)
    tiles = -(-g // pm.BWD_BLOCK_GENES) * -(-h // pm.BWD_BLOCK_COLS)
    waves = plan.n_slices * tiles / (pm.BWD_BLOCKS_PER_SM * n_sms)
    ops = 2 * m * g * h
    return (f"backward split: S={plan.n_slices} slices of {plan.rows} rows "
            f"x {tiles} tiles = {waves:.2f} waves on {n_sms} SMs, workspace "
            f"{plan.workspace_bytes} bytes; dense tensor-core ceiling "
            f"{ops / BF16_TC_OPS_PER_S * 1e3:.4f} ms (2*M*G*H = {ops:.3e} "
            f"bf16 operations)")


def _read_metrics(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _check_metrics(path, result) -> None:
    """The run's ``--metrics-jsonl`` stream: the reference's events, and a
    ``done`` record holding the stage seconds the run returned."""
    records = _read_metrics(path)
    events = [r["event"] for r in records]
    for name in ("config", "preprocess", "paths", "epoch", "train_done",
                 "done"):
        if name not in events:
            raise RuntimeError(f"{path}: no {name!r} record in {events}")
    if records[-1]["event"] != "done" or \
            records[-1]["stage_seconds"] != result.stage_seconds:
        raise RuntimeError(f"{path}: the done record's stage seconds "
                           f"differ from the run's")


def _cli_runs(files, tmp, epoch, flag_sets, tag="cli"):
    """The solo run through the CLI, each in a fresh interpreter (so each
    pays the process's first CUDA use), once per entry of ``flag_sets``.
    Returns [(flags, stage seconds, overlap_saved_s, stage extras, output
    bytes, the metrics stream's done record)]."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    runs = []
    for i, flags in enumerate(flag_sets):
        out = os.path.join(tmp, f"{tag}{i}")
        metrics = out + ".jsonl"
        proc = subprocess.run(
            [sys.executable, "-m", "g2vec_tpu_torch", files["expression"],
             files["clinical"], files["network"], out, "-e", str(epoch),
             "--metrics-jsonl", metrics, *flags],
            capture_output=True, text=True, env=env, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"CLI run {flags} failed:\n"
                               f"{proc.stderr[-3000:]}")
        if "native TSV reader unavailable" in proc.stderr:
            raise RuntimeError(f"CLI run {flags} fell back to the Python "
                               f"reader:\n{proc.stderr}")
        done = _read_metrics(metrics)[-1]
        outputs = []
        for path in done["outputs"]:
            with open(path, "rb") as f:
                outputs.append(f.read())
        runs.append((flags, done["stage_seconds"], done["overlap_saved_s"],
                     done["stage_extras"], outputs, done))
    return runs


def _parity(full, stream):
    """|val acc gap| and the share of the full-batch run's biomarkers the
    streaming run also selects (tests/test_stream.py's parity band)."""
    full_bm = set(full.biomarkers)
    return (abs(stream.acc_val - full.acc_val),
            len(full_bm & set(stream.biomarkers)) / max(len(full_bm), 1))


def _lgroup_sizes(result):
    return np.bincount(result.lgroup_idx, minlength=3).tolist()


def _stage3_csr(cfg):
    """The run's stage-3 walk inputs as the pipeline makes them on cuda:
    ``(n_genes, [host CSR of group g, of group p])``."""
    from g2vec_tpu_torch.ops.graph import thresholded_edges
    from g2vec_tpu_torch.ops.host_walker import edges_to_csr
    from g2vec_tpu_torch.pipeline import preprocess_inputs, read_inputs

    data, src, dst = preprocess_inputs(*read_inputs(cfg))
    g = data.expr.shape[1]
    return g, [edges_to_csr(*thresholded_edges(
        data.expr[data.label == i], src, dst, threshold=cfg.pcc_threshold,
        device="cuda"), g) for i in range(2)]


def _stream_shapes(torch, cfg, byte_range=None):
    """The streaming trainer's launch shapes on this input, built by its
    own helpers as it builds them: the train rows of the shard that keeps
    the most (each row padded once to the kernels' 4-byte stride), every
    kept shard's train row count, and the full val buffer of the run's
    eval cap (EVAL_ROWS_CAP unless ``stream_eval_rows``) gathered from the
    shards in order. ``--walk-starts`` picks the start genes as the
    trainer does; ``byte_range`` keeps one rank's byte columns of each row
    (an embed split's rows, padded at its local width)."""
    from g2vec_tpu_torch.ops.host_walker import plan_shards, walk_shard
    from g2vec_tpu_torch.parallel.shard import subset_starts
    from g2vec_tpu_torch.train.stream import (EVAL_ROWS_CAP, _filter_rows,
                                              _shard_split)
    from g2vec_tpu_torch.train.trainer import _fused_rows

    g, csr = _stage3_csr(cfg)
    starts = subset_starts(g, cfg.walk_starts)
    plan = plan_shards(g if starts is None else len(starts),
                       cfg.numRepetition, cfg.shard_paths,
                       len_path=cfg.lenPath)
    seed = cfg.seed if cfg.train_seed is None else cfg.train_seed
    cap = cfg.stream_eval_rows or EVAL_ROWS_CAP
    blo, bhi = byte_range or (0, (g + 7) // 8)
    width = g if byte_range is None else (bhi - blo) * 8
    widest, train_rows, val, n_val = None, [], [], 0
    for si in range(plan.n_shards):
        x = np.concatenate([walk_shard(None, None, None, g, plan, si,
                                       seed=(cfg.seed << 1) | gi,
                                       csr=csr[gi], starts=starts)
                            for gi in (0, 1)])
        y = np.repeat(np.array([0, 1], np.int32), plan.group_rows(si))
        keep = _filter_rows(x, y)
        if not len(keep):
            continue
        tr, vl = _shard_split(len(keep), seed, si, cfg.val_fraction)
        train_rows.append(len(tr))
        if widest is None or len(tr) > len(widest):
            widest = x[keep][tr][:, blo:bhi]
        take = vl[:cap - n_val]
        val.append(x[keep][take][:, blo:bhi])
        n_val += len(take)
    none = widest[:0]
    return (torch.from_numpy(_fused_rows(widest, none, width)).cuda(),
            train_rows,
            torch.from_numpy(_fused_rows(np.concatenate(val), none,
                                         width)).cuda(),
            plan)


def _planner_sweep(torch, pm, packed, n_bwd, g, h, gen, flush, label):
    """The tile planner's candidates at one shape, on ``packed``'s rows:
    every forward layout (bitwise the shipped kernel, which
    ``pm.time_fwd_layouts`` checks, and within the kernel tolerance of
    the plain version) and every backward slice count on the first
    ``n_bwd`` rows (within the tolerance), each timed (median of 10 by
    CUDA events after the L2 flush) beside the dense bf16 library call.
    Returns the times and the heuristic's choices."""
    m = packed.shape[0]
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    w16 = pm._pad_cols((torch.randn((g, h), device="cuda", generator=gen)
                        * 0.09).to(torch.bfloat16), 8)
    g16 = pm._pad_cols(torch.randn((n_bwd, h), device="cuda", generator=gen
                                   ).to(torch.bfloat16), 8)
    x = pm.unpack_bits(packed, g).float()
    fwd_c = pm.tile_candidates(m, g, h)["fwd"]
    bwd_c = pm.tile_candidates(n_bwd, g, h)["bwd"]
    want = pm.packed_matmul_fwd_plain(packed, w16)
    abs_sum = x @ w16.float().abs()
    err_f = max(_check_close(torch, f"{label} forward {layout}",
                             pm.run_fwd_layout(packed, w16, layout), want,
                             abs_sum, verbose=False) for layout in fwd_c)
    want = pm.packed_matmul_bwd_plain(packed[:n_bwd], g16, g)
    abs_sum = x[:n_bwd].T @ g16.float().abs()
    err_b = max(_check_close(torch, f"{label} backward S={n}",
                             pm.run_bwd_slices(packed[:n_bwd], g16, g, n),
                             want, abs_sum, verbose=False) for n in bwd_c)
    del want, abs_sum
    fwd = pm.time_fwd_layouts(packed, w16, fwd_c, 10, flush)
    bwd = pm.time_bwd_slices(packed[:n_bwd], g16, g, bwd_c, 10, flush)
    x16 = x.to(torch.bfloat16)
    del x
    x16_t = x16[:n_bwd].T.contiguous()
    lib_f = _time_ms(lambda: torch.matmul(x16, w16), flush)
    lib_b = _time_ms(lambda: torch.matmul(x16_t, g16), flush)
    del x16, x16_t
    heur_s = pm._bwd_slices(n_bwd, g, h, n_sms).n_slices
    best_f = min(fwd, key=lambda k: fwd[k][0])
    best_b = min(bwd, key=lambda k: bwd[k][0])
    print(f"    {label}: forward M={m} G={g} H={h}, every layout bitwise "
          f"the shipped kernel, max_abs_err {err_f:.1e}:")
    for layout, t in fwd.items():
        resident = pm.fwd_occupancy(layout=layout)
        if resident != pm.fwd_layout_info(layout).blocks_per_sm:
            raise RuntimeError(f"layout {layout} keeps {resident} blocks "
                               f"resident, not the ones its waves count")
        grid = pm._fwd_grid(m, h, n_sms, layout)
        print(f"      {layout}{' shipped' if layout == pm.FWD_SHIPPED else ''}"
              f": {_spread(t)}, {resident} resident blocks an SM, "
              f"{grid.blocks} blocks ({grid.waves:.2f} waves)")
    print(f"      fastest {best_f} {fwd[best_f][0]:.4f} ms against the "
          f"heuristic's (shipped) {fwd[pm.FWD_SHIPPED][0]:.4f}; library "
          f"(dense bf16 matmul) {_spread(lib_f)}")
    print(f"    {label}: backward M={n_bwd}, S in {bwd_c[0]}..{bwd_c[-1]} "
          f"({len(bwd_c)} counts), max_abs_err {err_b:.1e}: "
          + ", ".join(f"S={n} {t[0]:.4f}" for n, t in bwd.items()))
    print(f"      fastest S={best_b} {_spread(bwd[best_b])} against the "
          f"heuristic's S={heur_s} {_spread(bwd[heur_s])}; library "
          f"{_spread(lib_b)}")
    return {"fwd": fwd, "bwd": bwd, "library_fwd": lib_f[0],
            "library_bwd": lib_b[0], "heuristic_s": heur_s,
            "best_fwd": best_f, "best_bwd": best_b}


def _planner_entries(pm, m_all, n_tr, g, tmp):
    """The planner's own sweep (median of 10 by CUDA events, no flush) at
    the trainer's two launch shapes, each in the direction the trainer
    launches there (the fused forward at ``m_all`` rows, the backward at
    ``n_tr``), written to a file of its own; prints the entries written
    and returns them. The table is reset after: the phases after this one
    run the heuristic plan, as a run without the flag does."""
    path = os.path.join(tmp, "p4_autotune", "packed_matmul_cuda.json")
    entries, t0 = {}, time.perf_counter()
    for m, direction in ((m_all, "fwd"), (n_tr, "bwd")):
        ent = pm._autotune(m, g, 128, (direction,), device="cuda", iters=10,
                           cache_path=path)
        if ent["source"] != "measured":
            raise RuntimeError(f"the planner's first sweep at M={m} was a "
                               f"{ent['source']} hit")
        entries[m] = ent
    took = time.perf_counter() - t0
    pm.reset_tuned()
    with open(path) as f:
        written = json.load(f)["entries"]
    for key, ent in written.items():
        heur, ms = ent["heuristic"], ent["ms"]
        if "fwd" in ent:
            print(f"    entry written: {key}: fwd {ent['fwd']} "
                  f"({ms['fwd:best_ms']} ms; heuristic {heur['fwd']} "
                  f"{ms['fwd:' + pm._layout_suffix(heur['fwd'])]} ms)")
        if "bwd" in ent:
            print(f"    entry written: {key}: bwd S={ent['bwd']} "
                  f"({ms['bwd:best_ms']} ms; heuristic S={heur['bwd']} "
                  f"{ms['bwd:S' + str(heur['bwd'])]} ms)")
    print(f"    the planner's two sweeps took {took:.2f} s (the tiles "
          f"library already built in [2])")
    return entries


def _forward_edges(torch, pm, gen, n_genes):
    """The forward's ragged cases against its plain version (M of 1, 15
    and 17 rows and one row past a block; G 999 and 1,003; H 1, 10 and
    130), and its M-invariance, bitwise, at one full wave of blocks and
    one row either side of it, against a launch of two waves."""
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    past = pm.FWD_BLOCK_ROWS + 1
    cases = [(1, n_genes, 128), (15, n_genes, 128), (17, n_genes, 128),
             (past, n_genes, 128), (3000, 999, 128), (3000, 1003, 128),
             (700, 1003, 1), (700, 1003, 10), (700, 1003, 130)]
    for m, g, h in cases:
        packed = _random_packed(torch, m, g, 80 / g, gen)
        w = torch.randn((g, h), device="cuda", generator=gen) * 0.09
        x = pm.unpack_bits(packed, g).float()
        _check_close(torch, f"packed_matmul_fwd M={m} G={g} H={h}",
                     pm.packed_matmul_fwd(packed, w),
                     pm.packed_matmul_fwd_plain(packed, w),
                     x @ w.bfloat16().float().abs())
    wave = pm.FWD_BLOCKS_PER_SM * n_sms * pm.FWD_BLOCK_ROWS
    packed = _random_packed(torch, 2 * wave, n_genes, 80 / n_genes, gen)
    w = torch.randn((n_genes, 128), device="cuda", generator=gen) * 0.09
    full = pm.packed_matmul_fwd(packed, w)
    for rows in (wave - 1, wave, wave + 1):
        if not torch.equal(pm.packed_matmul_fwd(packed[:rows], w),
                           full[:rows]):
            raise RuntimeError(f"packed_matmul_fwd is not M-invariant at "
                               f"M={rows}")
    print(f"    forward M-invariant, bitwise, at M = {wave - 1}, {wave} and "
          f"{wave + 1} (one wave of blocks and a row either side) against "
          f"M={2 * wave}")


def _at_reference_genes(torch, pm, n_all, n_tr, h, gen, flush):
    """Both kernels at the reference's 7,523 genes (941-byte P rows): on
    the trainer's layout (rows padded once to 944 bytes by its own
    helper), each held against the plain version and timed; and the
    backward on unpadded rows, which it pads on every launch, with that
    copy timed alone."""
    from g2vec_tpu_torch.train.trainer import _fused_rows

    g_ref = 7523
    wide = _random_packed(torch, n_all, g_ref, 80 / g_ref, gen)
    host = wide.cpu().numpy()
    padded = torch.from_numpy(_fused_rows(host[:n_tr], host[n_tr:], g_ref)
                              ).cuda()
    w16 = (torch.randn((g_ref, h), device="cuda", generator=gen) * 0.09
           ).to(torch.bfloat16)
    g16 = torch.randn((n_tr, h), device="cuda", generator=gen
                      ).to(torch.bfloat16)
    x = pm.unpack_bits(wide, g_ref).float()
    _check_close(torch, f"packed_matmul_fwd M={n_all} G={g_ref} (rows "
                 f"{padded.shape[1]} bytes)",
                 pm.packed_matmul_fwd(padded, w16),
                 pm.packed_matmul_fwd_plain(wide, w16), x @ w16.float().abs())
    _check_close(torch, f"packed_matmul_bwd M={n_tr} G={g_ref} (rows "
                 f"{padded.shape[1]} bytes)",
                 pm.packed_matmul_bwd(padded[:n_tr], g16, g_ref),
                 pm.packed_matmul_bwd_plain(wide[:n_tr], g16, g_ref),
                 x[:n_tr].T @ g16.float().abs())
    fwd = _time_ms(lambda: pm.packed_matmul_fwd(padded, w16), flush)
    bwd = _time_ms(lambda: pm.packed_matmul_bwd(padded[:n_tr], g16,
                                                       g_ref), flush)
    print(f"    G={g_ref}, P rows padded once to {padded.shape[1]} bytes: "
          f"forward M={n_all} {_spread(fwd)}, backward M={n_tr} "
          f"{_spread(bwd)}")
    narrow = wide[:n_tr]
    bwd = _time_ms(lambda: pm.packed_matmul_bwd(narrow, g16, g_ref),
                   flush)
    pad = _time_ms(lambda: pm._pad_cols(narrow, 4), flush)
    print(f"    G={g_ref}, P rows unpadded ({narrow.shape[1]} bytes): "
          f"backward M={n_tr} {_spread(bwd)}, of which the padding copy "
          f"alone {_spread(pad)}")


def _walk_args(torch, csr_dev, starts, ids, len_path, seed):
    """The walker wrapper's arguments for these walkers, on the card."""
    s_t = torch.from_numpy(np.ascontiguousarray(starts, np.int32)).cuda()
    i_t = torch.from_numpy(np.ascontiguousarray(ids, np.uint64)
                           .view(np.int64)).cuda()
    return (csr_dev.indptr, csr_dev.indices, csr_dev.weights, s_t, i_t,
            len_path, seed, csr_dev.n_genes)


def _hold_walks(torch, dw, name, csr, csr_dev, starts, ids, len_path, seed,
                plain=True):
    """The kernel's rows against the C++ walker's and, with ``plain``, the
    plain version's on the card, byte for byte; returns the kernel's
    arguments and the largest difference of a byte (0: it raises on
    any)."""
    from g2vec_tpu_torch.native.walker_bindings import walk_paths_packed

    args = _walk_args(torch, csr_dev, starts, ids, len_path, seed)
    got = dw.device_walk(*args, max_degree=csr_dev.max_degree).cpu().numpy()
    want = {"C++": walk_paths_packed(*csr, csr_dev.n_genes, starts, ids,
                                     len_path, seed)}
    if plain:
        want["plain"] = dw.device_walk_plain(*args).cpu().numpy()
    err = 0
    for who, rows in want.items():
        if got.shape != rows.shape:
            raise RuntimeError(f"device_walk {name}: the kernel's rows are "
                               f"{got.shape}, the {who} walker's "
                               f"{rows.shape}")
        err = max(err, int(np.abs(got.astype(np.int16) - rows).max(
            initial=0)))
        if err:
            raise RuntimeError(f"device_walk {name}: the kernel's rows "
                               f"differ from the {who} walker's")
    return args, err


def _ragged_walks(torch, dw):
    """The kernel against the C++ walker and its plain version on a graph
    with duplicate edges, zero and negative weights and dead ends, at
    ``len_path`` 1, 2 and 80, on a subset of the starts and on a walker
    range that does not begin at 0, then on the hub graph
    (:func:`_hub_walks`). Returns the largest byte difference."""
    from g2vec_tpu_torch.ops.host_walker import edges_to_csr

    rng = np.random.default_rng(12)
    g, e = 1003, 2400
    src = rng.integers(0, g, e).astype(np.int32)
    dst = rng.integers(0, g, e).astype(np.int32)
    w = rng.random(e, dtype=np.float32)
    dup = rng.integers(0, e, 300)
    src, dst, w = (np.concatenate([a, a[dup]]) for a in (src, dst, w))
    w[rng.random(w.shape[0]) < 0.1] = 0.0
    w[rng.random(w.shape[0]) < 0.05] *= -1.0
    dead = rng.random(g) < 0.2
    keep = ~dead[src]
    csr = edges_to_csr(src[keep], dst[keep], w[keep], g)
    csr_dev = dw.upload_csr(csr, g, "cuda")
    reps = 3
    all_starts = np.tile(np.arange(g, dtype=np.int32), reps)
    all_ids = np.arange(g * reps, dtype=np.uint64)
    subset = np.sort(rng.choice(g, 300, replace=False)).astype(np.int32)
    cases = [("len_path 1", all_starts, all_ids, 1),
             ("len_path 2", all_starts, all_ids, 2),
             ("len_path 80", all_starts, all_ids, 80),
             ("300 starts", np.tile(subset, reps),
              np.arange(300 * reps, dtype=np.uint64), 80),
             ("walkers [517, 2900)", all_starts[517:2900],
              all_ids[517:2900], 80)]
    err = 0
    for name, starts, ids, length in cases:
        err = max(err, _hold_walks(torch, dw, f"ragged {name}", csr, csr_dev,
                                   starts, ids, length, 0xC0FFEE)[1])
    print(f"    ragged: G {g} (rows of {(g + 7) // 8} bytes), "
          f"{int(keep.sum())} edges with 300 duplicates, zero and negative "
          f"weights, {int(dead.sum())} dead ends: "
          + ", ".join(c[0] for c in cases)
          + ": kernel = plain = C++, byte for byte")
    return max(err, _hub_walks(torch, dw))


def _walk_graphs():
    """``tests/walk_graphs.py``, the hub graphs the card tests walk too."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "walk_graphs.py")
    spec = importlib.util.spec_from_file_location("walk_graphs", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _hub_walks(torch, dw):
    """The kernel on hub graphs under every instance the plan can choose
    from the shapes: at G 1,003 (the masks in shared memory) and G
    262,144 (in the rows, where no block's masks fit), each with rows of
    at most 7 slots (8 lanes a walker) and of up to 1,000 (16 lanes,
    chunks), at ``len_path`` 80 (and 1 and 2 at G 1,003); each against
    the C++ walker and the plain version, byte for byte, on a ragged
    walker count. Returns the largest byte difference."""
    from g2vec_tpu_torch.ops.host_walker import edges_to_csr

    wg = _walk_graphs()
    err, seen = 0, set()
    for g, lengths in ((1003, (1, 2, 80)), (262_144, (80,))):
        for max_hub in (7, 1000):
            degrees = tuple(d for d in wg.HUB_DEGREES if d <= max_hub)
            csr = edges_to_csr(*wg.hub_graph(g, degrees, g + max_hub), g)
            csr_dev = dw.upload_csr(csr, g, "cuda")
            rng = np.random.default_rng(g)
            starts = rng.integers(0, g, 3001).astype(np.int32)
            starts[:len(degrees)] = np.arange(len(degrees))
            ids = np.arange(3001, dtype=np.uint64)
            plan = dw.walk_plan(g, csr_dev.max_degree)
            seen.add((plan.group, plan.shared))
            for length in lengths:
                err = max(err, _hold_walks(
                    torch, dw, f"hub G {g} len_path {length} {plan}", csr,
                    csr_dev, starts, ids, length, 0xB0B)[1])
    print(f"    hub graphs (out-degrees up to 7 and {wg.HUB_DEGREES}, "
          f"duplicates, zero and negative weights, dead ends; 3,001 "
          f"walkers): G 1,003 at len_path 1, 2 and 80 and G 262,144 at 80; "
          f"instances (lanes, masks in shared memory) launched: "
          f"{sorted(seen)}: kernel = plain = C++, byte for byte")
    if seen != {(k, sh) for k in dw.GROUPS for sh in (True, False)}:
        raise RuntimeError(f"the hub walks launched {sorted(seen)}")
    return err


def _walk_plan_line(plan) -> str:
    return (f"{plan.group} lanes a walker, masks "
            + (f"in shared memory ({plan.stride} bytes each, "
               f"{plan.smem_bytes} bytes a block)" if plan.shared
               else "in the rows"))


def _walk_bytes(args) -> int:
    """The bytes a walk must move through device memory on these inputs,
    each once: the CSR (indptr, indices, weights), each walker's start
    and stream id, and the packed rows written. A group's CSR is some
    130 KB and stays in the 50 MB L2 for the whole launch, so the rows
    the steps scan again and again are read from there."""
    n, nbytes = args[3].shape[0], (args[-1] + 7) // 8
    return int(sum(t.numel() * t.element_size() for t in args[:5])
               + n * nbytes)


def _time_walks(torch, dw, csr, args, flush):
    """The kernel, its plain version and the D2H of its rows by CUDA
    events (median of 10 after an L2 flush) and the C++ walker on the
    same inputs by the host clock (median of 5)."""
    from g2vec_tpu_torch.native.walker_bindings import walk_paths_packed

    max_degree = int(np.diff(csr[0]).max(initial=0))
    starts, ids = args[3].cpu().numpy(), args[4].cpu().numpy().view(
        np.uint64)
    rec = {}
    for key, fn in (("ms", lambda: dw.device_walk(*args,
                                                  max_degree=max_degree)),
                    ("plain_ms", lambda: dw.device_walk_plain(*args))):
        rec[key], lo, hi = _time_ms(fn, flush)
        rec[key + "_spread"] = [lo, hi]
    rows = dw.device_walk(*args)
    rec["d2h_ms"], lo, hi = _time_ms(lambda: rows.cpu(), flush)
    rec["d2h_ms_spread"] = [lo, hi]
    cpp = []
    for _ in range(5):
        t0 = time.perf_counter()
        walk_paths_packed(*csr, args[-1], starts, ids, args[5], args[6])
        cpp.append((time.perf_counter() - t0) * 1e3)
    cpp.sort()
    rec["cpp_ms"], rec["cpp_ms_spread"] = cpp[2], [cpp[0], cpp[-1]]
    nbytes = _walk_bytes(args)
    rec.update(bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
               bound_bytes=nbytes)
    return rec


def _outputs(result):
    out = []
    for path in result.output_files:
        with open(path, "rb") as f:
            out.append(f.read())
    return out


def _device_walker_phase(torch, dw, pm, cfg, s_cfg, files, tmp, main_outputs,
                         main_launches, stream, s_launches):
    """Phase 7. Returns the kernel line's ``device_walk`` record.
    ``main_launches`` and ``s_launches`` are the packed kernels' counts of
    phase 3's and phase 6's runs, which the device-backend runs repeat."""
    from g2vec_tpu_torch.ops.host_walker import plan_shards

    g, csrs = _stage3_csr(cfg)
    reps, length = cfg.numRepetition, cfg.lenPath
    csr_dev = [dw.upload_csr(c, g, "cuda") for c in csrs]
    n = g * reps
    starts = np.tile(np.arange(g, dtype=np.int32), reps)
    ids = np.arange(n, dtype=np.uint64)
    held = [_hold_walks(torch, dw, f"group {name}", csrs[gi], csr_dev[gi],
                        starts, ids, length, (cfg.seed << 1) | gi)
            for gi, name in enumerate("gp")]
    args = [a for a, _ in held]
    err = max(e for _, e in held)
    degs = [np.diff(c[0]) for c in csrs]
    print(f"    both groups ({len(csrs[0][1])} and {len(csrs[1][1])} edges "
          f"over {g} genes, out-degree at most {max(int(d.max()) for d in degs)}), "
          f"{n} walkers each at len_path {length}: kernel = plain = C++, "
          f"byte for byte")
    plan = plan_shards(g, reps, s_cfg.shard_paths, len_path=length)
    for si in range(plan.n_shards):
        sh_starts, sh_ids = dw._shard_init(plan, si)
        for gi in (0, 1):
            err = max(err, _hold_walks(
                torch, dw, f"shard {si} group {gi}", csrs[gi], csr_dev[gi],
                sh_starts, sh_ids, length, (s_cfg.seed << 1) | gi)[1])
    print(f"    the {plan.n_shards} shards of the streaming plan, both "
          f"groups ({plan.group_rows(0)} walkers a group in a full shard): "
          f"kernel = plain = C++, byte for byte")
    err = max(err, _ragged_walks(torch, dw))

    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    timed = [_time_walks(torch, dw, csrs[gi], args[gi], flush)
             for gi in (0, 1)]
    max_deg = csr_dev[0].max_degree
    g_plan = dw.walk_plan(g, max_deg)
    print(f"    group g's plan: " + _walk_plan_line(g_plan))
    # One streaming shard's launch: every shard of group g, each timed.
    shard_ms = []
    for si in range(plan.n_shards):
        sh_starts, sh_ids = dw._shard_init(plan, si)
        sh_args = _walk_args(torch, csr_dev[0], sh_starts, sh_ids, length,
                             s_cfg.seed << 1)
        shard_ms.append(_time_ms(lambda: dw.device_walk(
            *sh_args, max_degree=max_deg), flush)[0])
    widest = int(np.argmax(shard_ms))
    sh_starts, sh_ids = dw._shard_init(plan, widest)
    sh_args = _walk_args(torch, csr_dev[0], sh_starts, sh_ids, length,
                         s_cfg.seed << 1)
    shard = _time_walks(torch, dw, csrs[0], sh_args, flush)
    shard["host_ms"] = _host_ms(torch, lambda: dw.device_walk(
        *sh_args, max_degree=max_deg))
    del flush
    print(f"    the {plan.n_shards} streaming shards' launches of group g "
          f"(median ms of 10 each): sum {sum(shard_ms):.4f}, median "
          f"{float(np.median(shard_ms)):.4f}, the slowest (shard {widest}, "
          f"{len(sh_starts)} walkers): kernel "
          f"{_spread((shard['ms'], *shard['ms_spread']))}, bound "
          f"{shard['bound_ms']:.4f} ms ({shard['bound_bytes']} bytes), plain "
          f"{_spread((shard['plain_ms'], *shard['plain_ms_spread']))}, C++ "
          f"walker {shard['cpp_ms']:.4f} ms; the wrapper's call by the host "
          f"clock (median of 20, the card kept busy) "
          f"{shard['host_ms']:.4f} ms")
    for name, rec in zip("gp", timed):
        print(f"    group {name}: kernel {_spread((rec['ms'], *rec['ms_spread']))}"
              f", bound {rec['bound_ms']:.4f} ms ({rec['bound_bytes']} bytes), "
              f"plain on the card "
              f"{_spread((rec['plain_ms'], *rec['plain_ms_spread']))}, the "
              f"rows to the host {_spread((rec['d2h_ms'], *rec['d2h_ms_spread']))}"
              f", the C++ walker (all {os.cpu_count()} host threads, host "
              f"clock, median of 5) "
              f"{_spread((rec['cpp_ms'], *rec['cpp_ms_spread']))}")

    # The main path with the device backend, in process: the counts read
    # just after it are its launches.
    d_cfg = _config(files, tmp, "cuda", epoch=30, walker_backend="device")
    d_cfg.result_name += "_device"
    dw.reset_launch_counts()
    pm.reset_launch_counts()
    d_res, _ = _run_pipeline(d_cfg)
    launches = dw.device_walk.launches
    if launches != 2 or d_res.walker_backend != "device":
        raise RuntimeError(f"the device-backend run launched the walker "
                           f"{launches} times ({d_res.walker_backend})")
    d_launches = {"packed_matmul_fwd": pm.packed_matmul_fwd.launches,
                  "packed_matmul_bwd": pm.packed_matmul_bwd.launches}
    if d_launches != main_launches:
        raise RuntimeError(f"the device-backend run launched {d_launches}, "
                           f"[3]'s run {main_launches}")
    if _outputs(d_res) != main_outputs:
        raise RuntimeError("--walker-backend device wrote other files than "
                           "[3]'s run")
    print(f"    in process, --walker-backend device: {launches} walker "
          f"launches, {d_launches} as in [3], files byte-identical to "
          f"[3]'s; stage seconds "
          + json.dumps({k: round(v, 3) for k, v in d_res.stage_seconds.items()})
          + "; paths spans " + json.dumps(
              {k: round(v, 3) for k, v in
               d_res.stage_extras["paths"]["span_s"].items()}))

    for flags, secs, _, extras, outputs, _ in _cli_runs(
            files, tmp, 30, ([], ["--walker-backend", "device"]),
            tag="cli_walker"):
        if outputs != main_outputs:
            raise RuntimeError(f"CLI {flags}: output files differ from [3]'s")
        print(f"    CLI {' '.join(flags) or '(defaults)'}: stage seconds "
              + json.dumps({k: round(v, 3) for k, v in secs.items()})
              + f" (total {sum(secs.values()):.3f}); paths spans "
              + json.dumps({k: round(v, 3) for k, v in
                            extras["paths"]["span_s"].items()}))
    print("    the three files of both CLI runs are byte-identical to "
          "[3]'s")

    cache = os.path.join(tmp, "walk_cache")
    hits = []
    for flags, secs, _, _, outputs, done in _cli_runs(
            files, tmp, 30, (["--cache-dir", cache], ["--cache-dir", cache],
                             ["--cache-dir", cache, "--walker-backend",
                              "device"]), tag="cli_cache"):
        if outputs != main_outputs:
            raise RuntimeError(f"CLI {flags}: output files differ from [3]'s")
        hits.append(done["walk_cache_hits"])
        print(f"    CLI {' '.join(flags)}: walk cache hits "
              f"{done['walk_cache_hits']}, backend {done['walker_backend']}, "
              f"paths {secs['paths']:.3f} s")
    if hits != [[], ["g", "p"], ["g", "p"]]:
        raise RuntimeError(f"the walk cache's hits were {hits}")
    print("    the second run and the device-backend run hit both groups' "
          "entries of the first, and all three wrote [3]'s bytes")

    # Streaming with the device walker: epoch 0 walks each shard on the
    # card and trains on it there (the fused feed).
    c = _config(files, tmp, "cuda", epoch=30, train_mode="streaming",
                walker_backend="device")
    c.result_name += "_stream_device"
    dw.reset_launch_counts()
    pm.reset_launch_counts()
    r, _ = _run_pipeline(c)
    stream_walks = dw.device_walk.launches
    r_launches = {"packed_matmul_fwd": pm.packed_matmul_fwd.launches,
                  "packed_matmul_bwd": pm.packed_matmul_bwd.launches}
    st = r.stream_stats
    print(f"    streaming, --walker-backend device: walker launches "
          f"{stream_walks}, {r_launches}, stage seconds " + json.dumps(
              {k: round(v, 3) for k, v in r.stage_seconds.items()})
          + f"; feed {st['feed_mode']}, shards through the ring "
          f"{st['shards_emitted']}, bytes kept off host-to-card "
          f"{st['h2d_bytes_saved']}, sampling wall "
          f"{st['sampling_wall_s']} s (native [6]: "
          f"{stream.stream_stats['sampling_wall_s']} s)")
    if r.embeddings.tobytes() != stream.embeddings.tobytes():
        raise RuntimeError("streaming, device walker: W_ih differs from "
                           "[6]'s")
    if stream_walks != 2 * st["n_shards"]:
        raise RuntimeError(f"streaming, device walker: the walker launched "
                           f"{stream_walks} times for {st['n_shards']} "
                           f"shards")
    if r_launches != s_launches:
        raise RuntimeError(f"streaming, device walker: {r_launches}, [6]'s "
                           f"run {s_launches}")
    if (st["feed_mode"] != "device" or st["shards_emitted"] != 0
            or st["h2d_bytes_saved"] <= 0):
        raise RuntimeError(f"the device feed's stats: {st}")
    print("    W_ih is byte-identical to [6]'s native streaming run, with "
          "[6]'s launches of both packed kernels")

    rec = timed[0]
    return _outputs(r), {
        "name": "device_walk", "route": "cuda",
        "source": "g2vec_tpu_torch/csrc/device_walker.cu",
        "replaces": dw.REPLACES, "launches": launches, "max_abs_err": err,
        "ms": rec["ms"], "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
        "library_ms": None, "cpp_ms": rec["cpp_ms"], "d2h_ms": rec["d2h_ms"],
        "shape": f"{n} walkers, len_path {length}, G {g} (group g)",
        "group_p": {k: timed[1][k] for k in
                    ("ms", "plain_ms", "bound_ms", "cpp_ms", "d2h_ms")},
        "plan": g_plan._asdict(),
        "streaming": {"launches": stream_walks, "shards_ms": shard_ms,
                      "shard": {"index": widest, "walkers": len(sh_starts),
                                **{k: shard[k] for k in (
                                    "ms", "plain_ms", "bound_ms", "bound_by",
                                    "cpp_ms", "host_ms")}}}}


# A supervised child, run through this wrapper instead of ``python -m
# g2vec_tpu_torch``: at exit it records its kernel wrappers' launch counts
# (a SIGKILLed child records nothing).
_CHILD = r"""
import atexit, json, os, runpy, sys
sys.argv = ["g2vec_tpu_torch", *sys.argv[3:]]     # drop "-m g2vec_tpu_torch"


def report():
    from g2vec_tpu_torch.ops import device_walker as dw
    from g2vec_tpu_torch.ops import packed_matmul as pm

    path = os.path.join(os.environ["G2V_SMOKE_REPORTS"], f"{os.getpid()}.json")
    with open(path, "w") as f:
        json.dump({"packed_matmul_fwd": pm.packed_matmul_fwd.launches,
                   "packed_matmul_bwd": pm.packed_matmul_bwd.launches,
                   "device_walk": dw.device_walk.launches}, f)


atexit.register(report)
runpy.run_module("g2vec_tpu_torch", run_name="__main__")
"""

# The supervisor: the CLI's own entry point, with its children started
# through the wrapper above.
_SUPERVISOR = (
    "import sys; sys.executable = sys.argv[1]; "
    "from g2vec_tpu_torch.__main__ import main; sys.exit(main(sys.argv[2:]))")


def _supervised_cli(files, out, flags, plan, device="cuda", epoch=30):
    """The CLI under ``--supervise`` with a fault plan and a fault state
    file, in fresh interpreters (the supervisor and its children), with
    ``--checkpoint-dir out_ckpt`` and ``--metrics-jsonl out.jsonl``.
    Checks that it exits 0, that the plan fired, and that the metrics
    stream holds the supervisor's ``retry``, ``resume`` and
    ``supervised_done`` and one ``done``. Returns the output files' bytes,
    the kernel launches of the child that finished (the resumed attempt),
    the fault state, the epochs the resumed attempt reported, the
    processes' standard output and the wall seconds."""
    root = os.path.dirname(os.path.abspath(__file__))
    metrics, state = out + ".jsonl", out + ".fault_state.json"
    reports = out + "_launches"
    os.makedirs(reports)
    child = os.path.join(reports, "child.py")
    with open(child, "w") as f:
        f.write(_CHILD)
    wrapper = os.path.join(reports, "python-child")
    with open(wrapper, "w") as f:
        f.write(f'#!/bin/sh\nexec "{sys.executable}" "{child}" "$@"\n')
    os.chmod(wrapper, 0o755)
    env = dict(os.environ, PYTHONPATH=root, G2VEC_FAULT_STATE=state,
               G2V_SMOKE_REPORTS=reports)
    env.pop("G2VEC_FAULT_PLAN", None)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", _SUPERVISOR, wrapper, files["expression"],
         files["clinical"], files["network"], out, "-e", str(epoch),
         "--metrics-jsonl", metrics, "--checkpoint-dir", out + "_ckpt",
         "--supervise", "--supervise-backoff", "0", "--fault-plan", plan,
         "--device", device, *flags],
        capture_output=True, text=True, env=env, timeout=600)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"supervised CLI run {flags} with {plan!r} "
                           f"failed:\n{proc.stderr[-3000:]}")
    if not os.path.exists(state):
        raise RuntimeError(f"the plan {plan!r} never fired")
    with open(state) as f:
        fired = json.load(f)
    events = _read_metrics(metrics)
    names = [e["event"] for e in events]
    for name in ("retry", "resume", "supervised_done"):
        if name not in names:
            raise RuntimeError(f"{metrics}: no {name!r} record in {names}")
    if names.count("done") != 1:
        raise RuntimeError(f"{metrics}: {names.count('done')} done records")
    retry = events[names.index("retry")]
    if "sigkill" in plan and "rc=-9" not in retry["error"]:
        raise RuntimeError(f"the first attempt was not SIGKILLed: {retry}")
    done = events[names.index("done")]
    outputs = []
    for path in done["outputs"]:
        with open(path, "rb") as f:
            outputs.append(f.read())
    finished = [n for n in os.listdir(reports) if n.endswith(".json")]
    if len(finished) != 1:
        raise RuntimeError(f"{len(finished)} children exited normally, "
                           f"want the resumed attempt alone")
    with open(os.path.join(reports, finished[0])) as f:
        launches = json.load(f)
    resumed = [e["step"] for e in events[names.index("resume") + 1:]
               if e["event"] == "epoch"]
    return outputs, launches, fired, resumed, proc.stdout, secs


def _resume_cursor(stdout):
    """(epoch, shard, n_shards) of the resumed attempt's resume line."""
    for line in stdout.splitlines():
        if line.startswith("[stream] resuming from cursor epoch "):
            words = line.split()
            shard, n = words[-1].split("/")
            return int(words[-3]), int(shard), int(n)
    raise RuntimeError("the resumed attempt printed no resume line")


def _median_ms(fn, n):
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), min(times), max(times)


def _durable_phase(torch, dw, pm, files, small, small_args, tmp,
                   main_outputs, stream, stream_dev_outputs, smi,
                   device="cuda"):
    """Phase 8: each drill's plan must fire and its run must write its
    unfaulted run's bytes. ``main_outputs``, ``stream`` and
    ``stream_dev_outputs`` are phases 3, 6 and 7's runs; ``small`` and
    ``small_args`` phase 5's input and flags. On the card the in-process
    device-walk drills also check that the plain walker is never
    called."""
    from g2vec_tpu_torch.resilience import faults
    from g2vec_tpu_torch.train import checkpoint as ck

    plain_calls = []
    real_plain = dw.device_walk_plain

    def counted_plain(*args, **kwargs):
        plain_calls.append(1)
        return real_plain(*args, **kwargs)

    stream_outputs = _outputs(stream)
    dw.device_walk_plain = counted_plain
    try:
        # Streaming on the ring, SIGKILLed just after its first cursor
        # inside epoch 1 is durable (the cut at the epoch-1 boundary is
        # skipped).
        out = os.path.join(tmp, "durable_stream")
        outputs, launches, fired, _, stdout, secs = _supervised_cli(
            files, out, ["--train-mode", "streaming", "--checkpoint-every",
                         "8"], "stage=stream_ckpt,kind=sigkill,epoch=1,"
            "skip=1", device)
        epoch, shard, n_shards = _resume_cursor(stdout)
        with np.load(os.path.join(out + "_ckpt", ck.STREAM_NAME)) as z:
            w_ih = z["leaf_7"]                  # the returned snapshot
        print(f"    streaming, SIGKILL after the cursor at epoch {epoch} "
              f"shard {shard}/{n_shards} (plan fired: {fired}): resumed "
              f"under --supervise in {secs:.1f} s of two processes; "
              f"launches of the resumed attempt {launches}")
        if fired != {"stream_ckpt:1:sigkill": 1} or epoch < 1 or shard < 1:
            raise RuntimeError(f"the streaming kill landed at epoch {epoch} "
                               f"shard {shard}: {fired}")
        if outputs != stream_outputs:
            raise RuntimeError("the resumed streaming run wrote other files "
                               "than [6]'s")
        if w_ih.tobytes() != stream.embeddings.tobytes():
            raise RuntimeError("the resumed streaming W_ih differs from "
                               "[6]'s")
        print("    files and W_ih byte-identical to [6]'s uninterrupted run")

        # The device feed, SIGKILLed just after its first cursor (epoch 0).
        out = os.path.join(tmp, "durable_feed")
        outputs, launches, fired, _, stdout, secs = _supervised_cli(
            files, out, ["--train-mode", "streaming", "--walker-backend",
                         "device", "--checkpoint-every", "8"],
            "stage=stream_ckpt,kind=sigkill", device)
        epoch, shard, n_shards = _resume_cursor(stdout)
        walks = launches["device_walk"]
        print(f"    device feed, SIGKILL after the cursor at epoch {epoch} "
              f"shard {shard}/{n_shards} (plan fired: {fired}): the "
              f"resumed attempt launched the walker {walks} times (2 "
              f"groups x the {n_shards - shard} shards from the cursor "
              f"on), launches {launches}, {secs:.1f} s")
        if fired != {"stream_ckpt:None:sigkill": 1} or epoch != 0 \
                or shard < 1:
            raise RuntimeError(f"the feed's kill landed at epoch {epoch} "
                               f"shard {shard}: {fired}")
        if device == "cuda" and walks != 2 * (n_shards - shard):
            raise RuntimeError(f"the resumed feed walked {walks} times "
                               f"from shard {shard} of {n_shards}")
        if outputs != stream_dev_outputs:
            raise RuntimeError("the resumed device feed wrote other files "
                               "than [7]'s")
        print("    files byte-identical to [7]'s device-feed run")

        # device_walk in process: one fault is a relaunch, two raise.
        c = _config(files, tmp, device, epoch=30, train_mode="streaming",
                    walker_backend="device",
                    fault_plan="stage=device_walk,kind=crash")
        c.result_name += "_device_walk_fault"
        faults._reset_for_tests()
        dw.reset_launch_counts()
        r, _ = _run_pipeline(c)
        walks = dw.device_walk.launches
        faults._reset_for_tests()
        st = r.stream_stats
        print(f"    device_walk crash in process: device_recomputes "
              f"{st['device_recomputes']}, walker launches {walks} for "
              f"{st['n_shards']} shards")
        if st["device_recomputes"] != 1 or _outputs(r) != stream_dev_outputs \
                or r.embeddings.tobytes() != stream.embeddings.tobytes():
            raise RuntimeError("the device walk's relaunch changed the run")
        if device == "cuda" and walks != 2 * st["n_shards"]:
            raise RuntimeError(f"{walks} walker launches after one fault")
        c = _config(files, tmp, device, epoch=30, train_mode="streaming",
                    walker_backend="device",
                    fault_plan="stage=device_walk,kind=crash,times=2")
        c.result_name += "_device_walk_fault2"
        try:
            _run_pipeline(c)
        except faults.InjectedFault as e:
            print(f"    two device_walk faults on one walk: the run raises "
                  f"({e})")
        else:
            raise RuntimeError("a second device_walk fault did not raise")
        finally:
            faults._reset_for_tests()
        if device == "cuda" and plain_calls:
            raise RuntimeError(f"the plain walker ran {len(plain_calls)} "
                               f"times on the card")
        print(f"    files and W_ih byte-identical to [7]'s; the plain "
              f"walker was called {len(plain_calls)} times")

        # Full batch: the example's run stops after one update, so the
        # kill is at lgroups, after the final checkpoint.
        out = os.path.join(tmp, "durable_full")
        outputs, launches, fired, resumed, _, secs = _supervised_cli(
            files, out, [], "stage=lgroups,kind=sigkill", device)
        print(f"    full batch, SIGKILL at lgroups (plan fired: {fired}): "
              f"the resumed attempt reported epochs {resumed}, launches "
              f"{launches}, {secs:.1f} s")
        if fired != {"lgroups:None:sigkill": 1} or resumed:
            raise RuntimeError("the lgroups drill did not resume a "
                               "finished run")
        if device == "cuda" and (launches["packed_matmul_fwd"]
                                 or launches["packed_matmul_bwd"]):
            raise RuntimeError(f"the resumed finished run trained: "
                               f"{launches}")
        if outputs != main_outputs:
            raise RuntimeError("the lgroups drill wrote other files than "
                               "[3]'s")
        print("    files byte-identical to [3]'s; nothing retrained")

        # The train seam on [5]'s small input. At [5]'s learning rate it
        # stops after 8 epochs; at 0.002 it trains 19, so that a kill at
        # epoch 10 lands between the checkpoints at epochs 7 and 11.
        small_args = dict(small_args, learningRate=0.002)
        c = _config(small, tmp, device, **small_args)
        c.result_name += "_small_lr"
        unfaulted, _ = _run_pipeline(c)
        out = os.path.join(tmp, "durable_small")
        flags = ["-p", str(small_args["lenPath"]),
                 "-r", str(small_args["numRepetition"]),
                 "-s", str(small_args["sizeHiddenlayer"]),
                 "-l", str(small_args["learningRate"]),
                 "-n", str(small_args["numBiomarker"]),
                 "--seed", str(small_args["seed"]),
                 "--checkpoint-every", "4"]
        outputs, _, fired, resumed, _, secs = _supervised_cli(
            small, out, flags, "stage=train,epoch=10,kind=sigkill", device,
            epoch=small_args["epoch"])
        print(f"    small input at -l 0.002 ({len(unfaulted.train_history)} "
              f"epochs unfaulted), SIGKILL at train epoch 10, checkpoints "
              f"every 4 (plan fired: {fired}): the resumed attempt "
              f"reported epochs {resumed[0]}..{resumed[-1]}, {secs:.1f} s")
        if fired != {"train:10:sigkill": 1} or resumed[0] != 8:
            raise RuntimeError(f"the train drill resumed at {resumed[:1]}")
        if outputs != _outputs(unfaulted):
            raise RuntimeError("the train drill wrote other files than its "
                               "unfaulted run")
        print("    files byte-identical to the unfaulted run's")

        # Cost: the streaming example at the default cadence, and each
        # save alone at the example's shapes.
        ckpt = os.path.join(tmp, "cost_ckpt")
        c = _config(files, tmp, device, epoch=30, train_mode="streaming",
                    checkpoint_dir=ckpt)
        c.result_name += "_stream_ckpt"
        r, _ = _run_pipeline(c)
        st = r.stream_stats
        if r.embeddings.tobytes() != stream.embeddings.tobytes():
            raise RuntimeError("checkpointing changed the streaming W_ih")
        stream_bytes = os.path.getsize(os.path.join(ckpt, ck.STREAM_NAME))
        arrays, cursor = ck.load_stream_state(ckpt)
        g, h = stream.embeddings.shape
        gen = torch.Generator(device=device).manual_seed(0)
        params = [torch.randn(g, h, generator=gen, device=device),
                  torch.randn(h, 1, generator=gen, device=device)]
        opt = (3, [p * 0.1 for p in params], [p * p for p in params])
        snap = [p.clone() for p in params]
        full_dir, stream_dir = (os.path.join(tmp, "cost_full"),
                                os.path.join(tmp, "cost_stream"))

        def save_full():
            ck.save_state(full_dir, params, opt, snap, 7, 0.5, 0.5)

        full_ms = _median_ms(save_full, 7)
        full_bytes = os.path.getsize(os.path.join(full_dir, ck.CKPT_NAME))
        load_ms = _median_ms(lambda: ck.load_state(full_dir, params, opt), 5)
        stream_ms = _median_ms(
            lambda: ck.save_stream_state(stream_dir, arrays, cursor), 7)
        per_save = st["checkpoint_wall_s"] / max(st["checkpoints"], 1)
        print(f"    cost on {smi}: save_state {full_bytes} bytes, "
              f"{_spread(full_ms)} (host clock, median of 7, leaves on "
              f"the card); load_state {_spread(load_ms)}; "
              f"save_stream_state {stream_bytes} bytes, {_spread(stream_ms)} "
              f"(host arrays, median of 7)")
        print(f"    streaming at the default cadence: {st['checkpoints']} "
              f"saves, checkpoint_wall_s {st['checkpoint_wall_s']} "
              f"({per_save * 1e3:.1f} ms a save), stage train "
              f"{r.stage_seconds['train']:.3f} s against [6]'s "
              f"{stream.stage_seconds['train']:.3f} s; W_ih byte-identical "
              f"to [6]'s")
        return {"save_state_ms": full_ms[0], "save_state_bytes": full_bytes,
                "save_stream_state_ms": stream_ms[0],
                "stream_state_bytes": stream_bytes,
                "checkpoints": st["checkpoints"],
                "checkpoint_wall_s": st["checkpoint_wall_s"]}
    finally:
        dw.device_walk_plain = real_plain
        faults._reset_for_tests()


def _config(files, out_dir, device, **overrides):
    from g2vec_tpu_torch.config import G2VecConfig

    return G2VecConfig(expression_file=files["expression"],
                       clinical_file=files["clinical"],
                       network_file=files["network"],
                       result_name=os.path.join(out_dir, f"run_{device}"),
                       device=device, **overrides)


def _run_pipeline(cfg):
    from g2vec_tpu_torch.pipeline import run

    lines = []
    result = run(cfg, console=lines.append)
    return result, lines


def _edge_flips(cfg) -> int:
    """Edges whose |PCC| > 0.5 keep decision differs between the card's
    and the CPU's ``edge_weights`` on the run's own stage-2 inputs."""
    from g2vec_tpu_torch.ops.graph import edge_weights
    from g2vec_tpu_torch.pipeline import preprocess_inputs, read_inputs

    data, src, dst = preprocess_inputs(*read_inputs(cfg))
    flips = 0
    for i in range(2):
        expr = data.expr[data.label == i]
        w_gpu = edge_weights(expr, src, dst, device="cuda").cpu().numpy()
        w_cpu = edge_weights(expr, src, dst, device="cpu").numpy()
        flips += int(((w_gpu > cfg.pcc_threshold)
                      != (w_cpu > cfg.pcc_threshold)).sum())
    return flips


def _train_val_rows(torch, cfg, result):
    """The trainer's ``[train | val]`` packed matrix for this run, built
    by the trainer's own helper from the rows and labels its stage 3
    returned; and the train row count."""
    from g2vec_tpu_torch.train.trainer import (_fused_rows, _pack_split,
                                               _split_indices)

    seed = cfg.seed if cfg.train_seed is None else cfg.train_seed
    tr_idx, vl_idx = _split_indices(result.n_paths, seed, cfg.val_fraction)
    p_tr = _pack_split(result.paths, result.labels, tr_idx)[0]
    p_val = _pack_split(result.paths, result.labels, vl_idx)[0]
    rows = _fused_rows(p_tr, p_val, result.n_genes)
    return torch.from_numpy(rows).cuda(), len(p_tr)


def _lane_stack(torch, result, cfg, n_lanes):
    """The ``--seeds n_lanes`` sweep's P stack at the example, as its lane
    trainer builds it: lane k's ``[train | val]`` rows of phase 3's paths
    (the sweep walks with phase 3's seed) split by train seed base + k;
    and the train row count."""
    from g2vec_tpu_torch.train.trainer import (_fused_rows, _pack_split,
                                               _split_indices)

    base = cfg.seed if cfg.train_seed is None else cfg.train_seed
    rows = []
    for k in range(n_lanes):
        tr, vl = _split_indices(result.n_paths, base + k, cfg.val_fraction)
        rows.append(_fused_rows(
            _pack_split(result.paths, result.labels, tr)[0],
            _pack_split(result.paths, result.labels, vl)[0], result.n_genes))
    return torch.from_numpy(np.stack(rows)).cuda(), len(tr)


def _compare_lane_kernels(torch, pm, packed, n_tr, g, h, gen, flush, timed,
                          lanes=None):
    """Both lane launches against their plain versions (tolerance as in
    phase 4) and, bitwise, against one solo launch a lane on the same
    tensors: the forward on all of a lane's rows, the backward on its
    first ``n_tr``. With ``timed``, the ms of one lane launch, of the same
    work as one solo launch a lane, of the plain version and of
    ``torch.bmm`` on the dense bf16 stack, and the bound (the lanes'
    bytes, or their f32 adds). Returns the per-kernel records."""
    ids = list(range(packed.shape[0])) if lanes is None else lanes
    b = len(ids)
    w = (torch.randn((b, g, h), device="cuda", generator=gen) * 0.09
         ).to(torch.bfloat16)
    g_out = torch.randn((b, n_tr, h), device="cuda",
                        generator=gen).to(torch.bfloat16)
    tag = f"B={b} M={packed.shape[1]} G={g} H={h}"
    out = pm.packed_matmul_lanes_fwd(packed, w, lanes)
    dw = pm.packed_matmul_lanes_bwd(packed, g_out, g, lanes)
    errs = {"packed_matmul_lanes_fwd": 0.0, "packed_matmul_lanes_bwd": 0.0}
    nnz_all = nnz_tr = 0
    for i, lane in enumerate(ids):
        x = pm.unpack_bits(packed[lane], g).float()
        nnz_all += int(x.sum())
        nnz_tr += int(x[:n_tr].sum())
        errs["packed_matmul_lanes_fwd"] = max(
            errs["packed_matmul_lanes_fwd"], _check_close(
                torch, f"packed_matmul_lanes_fwd {tag} lane {lane}", out[i],
                pm.packed_matmul_fwd_plain(packed[lane], w[i]),
                x @ w[i].float().abs()))
        errs["packed_matmul_lanes_bwd"] = max(
            errs["packed_matmul_lanes_bwd"], _check_close(
                torch, f"packed_matmul_lanes_bwd {tag} lane {lane}", dw[i],
                pm.packed_matmul_bwd_plain(packed[lane, :n_tr], g_out[i], g),
                x[:n_tr].T @ g_out[i].float().abs()))
        if not torch.equal(out[i], pm.packed_matmul_fwd(packed[lane], w[i])) \
                or not torch.equal(dw[i], pm.packed_matmul_bwd(
                    packed[lane, :n_tr], g_out[i], g)):
            raise RuntimeError(f"lane {lane} of {tag}: a lane launch is not "
                               f"bitwise the solo launch")
        del x
    print(f"    {tag}: every lane bitwise its solo launches")
    records = {name: {"max_abs_err": err} for name, err in errs.items()}
    if not timed:
        return records

    m, nb = packed.shape[1], packed.shape[2]
    x16 = torch.stack([pm.unpack_bits(packed[lane], g) for lane in ids])
    x16_tr_t = x16[:, :n_tr].transpose(1, 2).contiguous()
    cases = {
        "packed_matmul_lanes_fwd": (
            lambda: pm.packed_matmul_lanes_fwd(packed, w, lanes),
            lambda: [pm.packed_matmul_fwd(packed[lane], w[i])
                     for i, lane in enumerate(ids)],
            lambda: pm.packed_matmul_lanes_fwd_plain(packed, w, lanes),
            lambda: torch.bmm(x16, w),
            b * (m * nb + g * h * 2 + m * h * 4), nnz_all * h),
        "packed_matmul_lanes_bwd": (
            lambda: pm.packed_matmul_lanes_bwd(packed, g_out, g, lanes),
            lambda: [pm.packed_matmul_bwd(packed[lane, :n_tr], g_out[i], g)
                     for i, lane in enumerate(ids)],
            lambda: pm.packed_matmul_lanes_bwd_plain(packed, g_out, g,
                                                     lanes),
            lambda: torch.bmm(x16_tr_t, g_out),
            b * (n_tr * nb + n_tr * h * 2 + g * h * 4), nnz_tr * h),
    }
    for name, (kernel, solo, plain, library, nbytes, n_ops) in cases.items():
        byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
        op_ms = n_ops / F32_ADDS_PER_S * 1e3
        rec = records[name]
        spread = {}
        for key, fn in (("ms", kernel), ("solo_ms", solo),
                        ("plain_ms", plain), ("library_ms", library)):
            rec[key], lo, hi = _time_ms(fn, flush)
            spread[key] = f"{rec[key]:.4f} ms [{lo:.4f}, {hi:.4f}]"
        rec.update(bound_ms=max(byte_ms, op_ms),
                   bound_by="bytes" if byte_ms >= op_ms else "operations")
        print(f"    {name} {tag}: one lane launch {spread['ms']}, {b} solo "
              f"launches {spread['solo_ms']}, plain {spread['plain_ms']}, "
              f"library (torch.bmm, dense bf16 stack) "
              f"{spread['library_ms']}, bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']}: {nbytes} bytes, {n_ops} f32 adds)")
    return records


def _batch_cli(files, out, flags, epoch=30):
    """The batch CLI in a fresh interpreter; returns (process seconds, the
    batch's done record, each lane's output bytes by lane tag)."""
    root = os.path.dirname(os.path.abspath(__file__))
    metrics = out + ".jsonl"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "g2vec_tpu_torch", files["expression"],
         files["clinical"], files["network"], out, "-e", str(epoch),
         "--metrics-jsonl", metrics, *flags],
        capture_output=True, text=True, env=dict(os.environ, PYTHONPATH=root),
        timeout=600)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"batch CLI {flags} failed:\n{proc.stderr[-3000:]}")
    records = _read_metrics(metrics)
    done = [r for r in records if r["event"] == "done" and "lane" not in r]
    if len(done) != 1:
        raise RuntimeError(f"{metrics}: {len(done)} batch done records")
    lanes = {}
    for r in records:
        if r["event"] == "done" and "lane" in r:
            lanes[r["lane"]] = []
            for path in r["outputs"]:
                with open(path, "rb") as f:
                    lanes[r["lane"]].append(f.read())
    return secs, done[0], lanes


def _lane_outputs(res):
    return [_outputs(lane) for lane in res.lanes]


def _solo_lane_runs(res, cfg, tmp, tag):
    """Each lane's solo run (``pipeline.run(lane_config(...))``) in
    process; fails unless its files are the lane's bytes."""
    import dataclasses

    from g2vec_tpu_torch.batch.engine import lane_config

    for v, lane in zip(res.variants, res.lanes):
        solo_cfg = lane_config(dataclasses.replace(
            cfg, manifest=None, batch_seeds=0, metrics_jsonl=None,
            result_name=os.path.join(tmp, f"{tag}_solo")), v)
        solo, _ = _run_pipeline(solo_cfg)
        if _outputs(solo) != _outputs(lane):
            raise RuntimeError(f"{tag}: lane {v.name!r} differs from its "
                               f"solo run")


def _walks_in_turn_and_on_a_pool(m_cfg):
    """The mixed manifest's distinct walk products, each walked by the
    engine's own task (``batch.engine._make_walk_task``, the C++ walker on
    every core), all in turn on this thread as the engine walks them, and
    all at once on a scheduler pool of 4 threads: twice each, in turns.
    Fails unless both give the same path sets."""
    from g2vec_tpu_torch.batch.engine import (_lane_cohort, _make_walk_task,
                                              plan_variants)
    from g2vec_tpu_torch.cache import (NATIVE_FAMILY, SharedWalkTier,
                                       walk_cache_key)
    from g2vec_tpu_torch.ops.graph import thresholded_edges
    from g2vec_tpu_torch.ops.host_walker import resolve_sampler_threads
    from g2vec_tpu_torch.parallel.overlap import OverlapScheduler
    from g2vec_tpu_torch.pipeline import preprocess_inputs, read_inputs

    data, src, dst = preprocess_inputs(*read_inputs(m_cfg))
    n_genes = data.expr.shape[1]
    products = {}
    for v in plan_variants(m_cfg):
        ldata = data if v.expr_key() is None else _lane_cohort(data, v)
        for gi in range(2):
            s, d, w = thresholded_edges(ldata.expr[ldata.label == gi], src,
                                        dst, threshold=m_cfg.pcc_threshold,
                                        device="cuda")
            seed = (v.seed << 1) | gi
            products[walk_cache_key(
                s, d, w, n_genes, len_path=m_cfg.lenPath,
                reps=m_cfg.numRepetition, seed=seed,
                family=NATIVE_FAMILY)] = (s, d, w, seed)

    def tasks():
        tier = SharedWalkTier()
        return [_make_walk_task(m_cfg, s, d, w, n_genes, seed=seed,
                                backend="native", tier=tier, ckey=key,
                                group="g", device="cuda",
                                n_threads=resolve_sampler_threads(0),
                                join=lambda: None)
                for key, (s, d, w, seed) in products.items()]

    def on_pool():
        with OverlapScheduler(max_workers=4) as pool:
            for i, task in enumerate(tasks()):
                pool.submit(f"walk{i}", task)
            return [pool.result(f"walk{i}") for i in range(len(products))]

    walked = {}
    for mode in ("in turn", "pool", "in turn", "pool"):
        sets, secs = _timed(on_pool if mode == "pool"
                            else lambda: [task() for task in tasks()])
        walked.setdefault(mode, []).append(secs)
        if sets != walked.setdefault("sets", sets):
            raise RuntimeError("walks on the pool gave other path sets")
    print(f"    its {len(products)} distinct walk products: in turn "
          f"{walked['in turn'][0]:.3f}, {walked['in turn'][1]:.3f} s; on a "
          f"pool of 4 threads {walked['pool'][0]:.3f}, "
          f"{walked['pool'][1]:.3f} s (the same path sets)")


def _lanes_phase(torch, pm, result, cfg, files, tmp, smi):
    """Phase 9: the batch engine on the card. Returns the two lane
    kernels' records for the kernel line."""
    import dataclasses

    from g2vec_tpu_torch.batch.engine import (ResidentEngine, lane_config,
                                              plan_variants)

    n_lanes = 8
    gen = torch.Generator(device="cuda").manual_seed(9)
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    print(f"    lane kernels at the example, B={n_lanes} (the --seeds "
          f"{n_lanes} sweep's [train | val] rows):")
    packed, n_tr = _lane_stack(torch, result, cfg, n_lanes)
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = pm._bwd_slices(n_tr, result.n_genes, 128, n_sms)
    print(f"    backward: the solo plan a lane, S={plan.n_slices} slices of "
          f"{plan.rows} rows; workspace {n_lanes} x {plan.workspace_bytes} "
          f"= {n_lanes * plan.workspace_bytes} bytes (cap "
          f"{pm.BWD_LANES_WORKSPACE_CAP}); forward grid "
          f"{pm._fwd_grid(packed.shape[1], 128, n_sms).blocks} x {n_lanes} "
          f"blocks")
    records = _compare_lane_kernels(torch, pm, packed, n_tr, result.n_genes,
                                    128, gen, flush, timed=True)
    del packed, flush
    print("    lane kernels at ragged shapes:")
    for b, m, g, h, lanes in ((3, 1001, 1003, 131, None),
                              (3, 777, 999, 7, [2, 0]),
                              (4, 65, 5850, 128, [3])):
        stack = torch.stack([_random_packed(torch, m, g, 0.02, gen)
                             for _ in range(b)])
        for name, rec in _compare_lane_kernels(
                torch, pm, stack, m - 2, g, h, gen, None, timed=False,
                lanes=lanes).items():
            records[name]["max_abs_err"] = max(records[name]["max_abs_err"],
                                               rec["max_abs_err"])

    print(f"    --seeds {n_lanes} --lanes {n_lanes} in process on one "
          f"ResidentEngine, twice (counts read over the first):")
    b_cfg = _config(files, tmp, "cuda", epoch=30, batch_seeds=n_lanes,
                    lanes=n_lanes)
    b_cfg.result_name = os.path.join(tmp, "lanes", "run")
    with ResidentEngine() as engine:
        pm.reset_launch_counts()
        first = engine.execute(b_cfg, console=lambda s: None)
        launches = {k: getattr(pm, k).launches for k in (
            "packed_matmul_lanes_fwd", "packed_matmul_lanes_bwd",
            "packed_matmul_fwd", "packed_matmul_bwd")}
        again_cfg = dataclasses.replace(
            b_cfg, result_name=os.path.join(tmp, "lanes2", "run"))
        lines = []
        again = engine.execute(again_cfg, console=lines.append)
        status = engine.status()
    epochs = [len(lane.train_history) for lane in first.lanes]
    print(f"    buckets {first.buckets}; epochs run {epochs}; stop epochs "
          f"{[lane.stop_epoch for lane in first.lanes]}; launches "
          f"{launches}; stage seconds " + json.dumps(
              {k: round(v, 3) for k, v in first.stage_seconds.items()})
          + f"; {first.runs_per_hour:.1f} runs/hour in process")
    if launches["packed_matmul_lanes_fwd"] != max(epochs) + 1 \
            or launches["packed_matmul_lanes_bwd"] != max(epochs) \
            or launches["packed_matmul_fwd"] or launches["packed_matmul_bwd"]:
        raise RuntimeError(f"the {n_lanes}-lane bucket launched {launches} "
                           f"for {max(epochs)} epochs")
    print(f"    second execute: walk_stats {again.walk_stats}; status "
          + json.dumps({k: status[k] for k in (
              "batches_executed", "lanes_executed", "datasets_resident",
              "walk_tier", "walk_products_resident")}))
    if not any("dataset resident" in line for line in lines) \
            or again.walk_stats["memo_hits"] != 2 \
            or again.walk_stats["walked"] != 0 \
            or _lane_outputs(again) != _lane_outputs(first):
        raise RuntimeError("the resident engine's second execute was not "
                           "served from memory with the same bytes")

    # The batch through the CLI; every lane against its solo run in
    # process (a fresh interpreter a run costs several seconds, and the
    # script's time is budgeted).
    print(f"    the batch CLI, a fresh interpreter; the {n_lanes} lanes' solo "
          f"runs in process:")
    batch_secs, done, cli_lanes = _batch_cli(
        files, os.path.join(tmp, "cli_lanes", "run"),
        ["--seeds", str(n_lanes), "--lanes", str(n_lanes)])
    for v, lane in zip(plan_variants(b_cfg), first.lanes):
        if cli_lanes[v.tag()] != _outputs(lane):
            raise RuntimeError(f"lane {v.name!r}: the batch CLI's files "
                               f"differ from the in-process batch's")
    _, solo_secs = _timed(lambda: _solo_lane_runs(first, b_cfg, tmp,
                                                  "lanes_solo"))
    print(f"    batch CLI: {batch_secs:.3f} s process wall, engine "
          f"{done['wall_seconds']} s, {done['runs_per_hour']} runs/hour "
          f"(engine wall), {n_lanes / batch_secs * 3600:.1f} runs/hour "
          f"(process wall); stage seconds {done['stage_seconds']}")
    print(f"    {n_lanes} solo runs in process: {solo_secs:.3f} s wall "
          f"({n_lanes / solo_secs * 3600:.1f} runs/hour); every lane's "
          f"three files byte-identical to the batch CLI's and to its solo "
          f"run; {smi}")

    print("    a mixed manifest (two subsamples, a CV fold, a permutation "
          "null):")
    manifest = os.path.join(tmp, "mixed.json")
    with open(manifest, "w") as f:
        json.dump([{"name": "full"},
                   {"name": "subA", "patient_subsample": 0.8,
                    "subsample_seed": 3},
                   {"name": "subB", "patient_subsample": 0.8,
                    "subsample_seed": 9},
                   {"name": "fold2", "subsample_mode": "fold",
                    "cv_folds": 5, "cv_fold": 2},
                   {"name": "null", "permute_seed": 5, "train_seed": 1}], f)
    m_cfg = _config(files, tmp, "cuda", epoch=30, manifest=manifest)
    m_cfg.result_name = os.path.join(tmp, "mixed", "run")
    with ResidentEngine() as engine:
        res = engine.execute(m_cfg, console=lambda s: None)
    print(f"    stage seconds " + json.dumps(
        {k: round(v, 3) for k, v in res.stage_seconds.items()})
        + f"; walk_stats {res.walk_stats}; buckets (lanes, mode, n_paths) "
        f"{[(b['lanes'], b['mode'], b['n_paths']) for b in res.buckets]}")
    if len(res.buckets) < 2 or not any(b["lanes"] == 1 for b in res.buckets) \
            or res.walk_stats["walked"] != 8 \
            or res.walk_stats["lane_shared"] != 2:
        raise RuntimeError(f"the mixed manifest planned {res.buckets} with "
                           f"{res.walk_stats}")
    _solo_lane_runs(res, m_cfg, tmp, "mixed")
    _walks_in_turn_and_on_a_pool(m_cfg)
    print("    every lane's files byte-identical to its solo run")

    print("    --train-mode streaming --seeds 2:")
    s_cfg = _config(files, tmp, "cuda", epoch=30, batch_seeds=2,
                    train_mode="streaming")
    s_cfg.result_name = os.path.join(tmp, "stream_lanes", "run")
    from g2vec_tpu_torch.batch.engine import run_batch

    s_res, s_secs = _timed(lambda: run_batch(s_cfg, console=lambda s: None))
    _solo_lane_runs(s_res, s_cfg, tmp, "stream_lanes")
    print(f"    {s_secs:.3f} s for 2 lanes, buckets {s_res.buckets}; each "
          f"lane's files byte-identical to its solo streaming run")
    for name, rec in records.items():
        rec["launches"] = launches[name]
    lane_bytes = {v.name: (v.train_seed, v.kmeans_seed, _outputs(lane))
                  for v, lane in zip(first.variants, first.lanes)}
    return records, lane_bytes


def _serve_args(sock, state, cache, metrics, *extra):
    return ["--socket", sock, "--state-dir", state, "--cache-dir", cache,
            "--metrics-jsonl", metrics, "--ann-nlist", "16", *extra]


def _serve_proc(args, log, env=None):
    """``python -m g2vec_tpu_torch serve ARGS`` as a child of this script,
    its output appended to ``log``."""
    root = os.path.dirname(os.path.abspath(__file__))
    with open(log, "ab") as f:
        return subprocess.Popen(
            [sys.executable, "-m", "g2vec_tpu_torch", "serve", *args],
            stdout=f, stderr=subprocess.STDOUT,
            env=dict(os.environ, PYTHONPATH=root, **(env or {})))


def _serve_cli(args, timeout=120):
    """One client op through the CLI; returns (rc, stdout)."""
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(
        [sys.executable, "-m", "g2vec_tpu_torch", "serve", *args],
        capture_output=True, text=True, timeout=timeout,
        env=dict(os.environ, PYTHONPATH=root))
    return proc.returncode, proc.stdout + proc.stderr


def _serve_job(files, out, **fields):
    return dict(expression_file=files["expression"],
                clinical_file=files["clinical"],
                network_file=files["network"], result_name=out, **fields)


def _job_events(metrics, job_id, event):
    return [r for r in _read_metrics(metrics)
            if r.get("job_id") == job_id and r["event"] == event]


def _wait_for(cond, what, deadline_s=120.0, proc=None):
    t0 = time.perf_counter()
    while not cond():
        if proc is not None and proc.poll() is not None:
            raise RuntimeError(f"the daemon exited (rc {proc.returncode}) "
                               f"while waiting for {what}")
        if time.perf_counter() - t0 > deadline_s:
            raise RuntimeError(f"no {what} within {deadline_s:.0f} s")
        time.sleep(0.05)


def _bundle_arrays(state, key):
    """A published bundle's live generation, read with numpy after its
    manifest is verified file by file (sha256 and size)."""
    import hashlib

    from g2vec_tpu_torch.io.writers import (INVENTORY_MANIFEST,
                                            read_generation)

    root = os.path.join(state, "inventory", key)
    gen = os.path.join(root, read_generation(root))
    with open(os.path.join(gen, INVENTORY_MANIFEST)) as f:
        manifest = json.load(f)
    listed = set(manifest["files"])
    present = set(os.listdir(gen)) - {INVENTORY_MANIFEST}
    if listed != present:
        raise RuntimeError(f"bundle {key}: manifest lists {sorted(listed)}, "
                           f"the generation holds {sorted(present)}")
    for name, rec in manifest["files"].items():
        with open(os.path.join(gen, name), "rb") as f:
            data = f.read()
        if hashlib.sha256(data).hexdigest() != rec["sha256"] \
                or len(data) != rec["bytes"]:
            raise RuntimeError(f"bundle {key}: {name} fails its manifest")
    with open(os.path.join(gen, "genes.txt")) as f:
        genes = f.read().split("\n")[:-1]
    return (genes, np.load(os.path.join(gen, "embeddings.npy")),
            np.load(os.path.join(gen, "norms.npy")),
            np.load(os.path.join(gen, "scores.npy")))


def _full_sort_neighbors(emb, norms, gi, k):
    """The exact answer by a full stable sort over the whole table (ties
    by ascending index), with the query plane's cosine arithmetic."""
    q = emb[gi]
    sims = emb @ q
    denom = norms * np.sqrt(np.dot(q, q))
    ok = denom > 0
    sims = np.where(ok, sims / np.where(ok, denom, 1), np.float32(-2.0))
    sims[gi] = -np.inf
    order = np.lexsort((np.arange(emb.shape[0]), -sims))[:k]
    return order, sims[order]


def _full_sort_scores(row, k):
    order = np.lexsort((np.arange(row.shape[0]), -row))[:k]
    return order, row[order]


def _percentiles(ms):
    ms = np.sort(np.asarray(ms))
    return (f"p50 {np.percentile(ms, 50):.3f} ms, p99 "
            f"{np.percentile(ms, 99):.3f} ms (n {len(ms)})")


def _check_queries(sock, state, all_keys, keys, rng):
    """200 queries through the client on the bundles ``keys``, each exact
    answer held against a numpy full sort of the bundle's table (every
    bundle's manifest verified first); returns latencies by op."""
    from g2vec_tpu_torch.serve import client

    tables = {key: _bundle_arrays(state, key) for key in all_keys}
    lat = {}

    def timed(kind, fn):
        t0 = time.perf_counter()
        ev = fn()
        lat.setdefault(kind, []).append((time.perf_counter() - t0) * 1e3)
        if ev.get("event") not in ("query_result", "fquery_result"):
            raise RuntimeError(f"{kind}: {ev}")
        return ev

    for i in range(40):
        key = keys[int(rng.integers(len(keys)))]
        job_id, variant = key.split("/")
        genes, emb, norms, scores = tables[key]
        gi = int(rng.integers(len(genes)))
        k = int(rng.integers(1, 51))
        ev = timed("neighbors exact", lambda: client.query(
            sock, "neighbors", job_id=job_id, variant=variant,
            gene=genes[gi], k=k, mode="exact"))
        idx, sims = _full_sort_neighbors(emb, norms, gi, k)
        if ev["neighbors"] != [genes[j] for j in idx] \
                or ev["sims"] != [float(x) for x in sims]:
            raise RuntimeError(f"exact neighbors of {genes[gi]} in {key} "
                               f"differ from the full sort")
        nprobe = 16 if i % 4 == 0 else 4
        ev = timed("neighbors ivf", lambda: client.query(
            sock, "neighbors", job_id=job_id, variant=variant,
            gene=genes[gi], k=k, nprobe=nprobe))
        if ev["recall_mode"] != "approx" or ev["nlist"] != 16 \
                or ev["nprobe"] != nprobe:
            raise RuntimeError(f"IVF neighbors: {ev}")
        if nprobe >= ev["nlist"] and (
                ev["neighbors"] != [genes[j] for j in idx]
                or ev["sims"] != [float(x) for x in sims]):
            raise RuntimeError("IVF neighbors probing every list differ "
                               "from the full sort")
        ev = timed("topk_biomarkers", lambda: client.query(
            sock, "topk_biomarkers", job_id=job_id, variant=variant, k=k,
            mode="exact"))
        for row, group in enumerate(("good", "poor")):
            idx, sc = _full_sort_scores(scores[row], k)
            if ev[group]["genes"] != [genes[j] for j in idx] \
                    or ev[group]["scores"] != [float(x) for x in sc]:
                raise RuntimeError(f"topk_biomarkers {group} of {key} "
                                   f"differ from the full sort")
        ev = timed("list", lambda: client.query(sock, "list"))
        if sorted(b["bundle"] for b in ev["bundles"]) != sorted(all_keys):
            raise RuntimeError(f"list: {ev['bundles']}")
        ev = timed("fquery gene_rank", lambda: client.fquery(
            sock, "gene_rank", genes[gi], k=k))
        parts = {p["bundle"]: p for p in ev["bundles"]}
        if sorted(parts) != sorted(all_keys):
            raise RuntimeError(f"gene_rank answered for {sorted(parts)}")
        for other, (o_genes, _, _, o_scores) in tables.items():
            if genes[gi] not in o_genes:
                continue
            oi = o_genes.index(genes[gi])
            for row, group in enumerate(("good", "poor")):
                order = np.lexsort((np.arange(len(o_genes)),
                                    -o_scores[row]))
                rank = int(np.flatnonzero(order == oi)[0]) + 1
                if parts[other][group]["rank"] != rank:
                    raise RuntimeError(f"gene_rank of {genes[gi]} in "
                                       f"{other}: {parts[other][group]} "
                                       f"vs full-sort rank {rank}")
    return lat


def _serve_phase(files, small, small_args, tmp, lane_bytes, smi):
    """Phase 10: the port's serve daemon on the card, as a child process
    driven through its CLI and client. Returns the served batches' kernel
    launch counts."""
    from g2vec_tpu_torch.batch.engine import _variant_from_dict, lane_config
    from g2vec_tpu_torch.config import G2VecConfig, config_from_job
    from g2vec_tpu_torch.serve import client

    wd = os.path.join(tmp, "serve")
    os.makedirs(wd)
    sock, state = os.path.join(wd, "g.sock"), os.path.join(wd, "state")
    cache, metrics = os.path.join(wd, "cache"), os.path.join(wd, "mj.jsonl")
    log, out = os.path.join(wd, "serve.log"), os.path.join(wd, "out")
    procs = []
    try:
        # 1. No card visible: the daemon refuses to start.
        proc = _serve_proc(_serve_args(os.path.join(wd, "nocard.sock"),
                                       os.path.join(wd, "nocard"), cache,
                                       os.path.join(wd, "nocard.jsonl")),
                           os.path.join(wd, "nocard.log"),
                           env={"CUDA_VISIBLE_DEVICES": ""})
        procs.append(proc)
        rc = proc.wait(timeout=120)
        with open(os.path.join(wd, "nocard.log")) as f:
            text = f.read()
        if rc == 0 or "no CUDA device" not in text:
            raise RuntimeError(f"a card-less start exited {rc}: "
                               f"{text[-500:]}")
        print(f"    with CUDA_VISIBLE_DEVICES= the daemon exits {rc}: "
              + [ln for ln in text.splitlines() if "no CUDA" in ln][0][:160])

        # 2. The daemon on the card.
        t0 = time.perf_counter()
        daemon = _serve_proc(_serve_args(sock, state, cache, metrics,
                                         "--listen", "127.0.0.1:0"), log)
        procs.append(daemon)
        if not client.wait_ready(sock, deadline_s=120.0):
            raise RuntimeError("the daemon did not answer ping in 120 s")
        status = client.status(sock)
        with open(os.path.join(state, "tcp_addr")) as f:
            host, port = f.read().strip().split(":")
        import socket as _socket

        with _socket.create_connection((host, int(port)), timeout=10) as c:
            c.sendall(b"GET /status HTTP/1.0\r\n\r\n")
            http = b""
            while chunk := c.recv(65536):
                http += chunk
        if not http.startswith(b"HTTP/1.0 200") \
                or json.loads(http.split(b"\r\n\r\n", 1)[1])["pid"] \
                != status["pid"]:
            raise RuntimeError(f"HTTP /status over TCP: {http[:200]!r}")
        print(f"    daemon pid {status['pid']} ready in "
              f"{time.perf_counter() - t0:.1f} s on {status['device']} "
              f"(UNIX socket and tcp {host}:{port}, HTTP /status read)")
        base = status["engine"]["kernel_launches"]

        # 3. Two tenants' compatible jobs, admitted while the daemon runs
        # a first small job (f32, no packed kernel), so that the
        # scheduler finds both queued and joins them.
        first = _serve_job(small, os.path.join(out, "first"),
                           compute_dtype="float32", **small_args)
        first_events = client.request(sock, {"op": "submit", "job": first,
                                             "tenant": "carol"})
        ack = next(first_events)
        if ack.get("event") != "accepted":
            raise RuntimeError(f"first job: {ack}")
        for ev in first_events:
            if ev["event"] == "started":
                break
        sweep = [(name, ts, ks) for name, (ts, ks, _) in
                 sorted(lane_bytes.items(), key=lambda kv: kv[1][0])]
        joined = {}

        def submit(tenant, lanes):
            t_submit = time.time()
            events = client.submit_job(sock, _serve_job(
                files, os.path.join(out, tenant), epoch=30, variants=[
                    {"name": n, "train_seed": ts, "kmeans_seed": ks}
                    for n, ts, ks in lanes]), tenant=tenant)
            joined[tenant] = (events, time.time() - t_submit)

        with ThreadPoolExecutor(2) as pool:
            futs = [pool.submit(submit, "alice", sweep[:4]),
                    pool.submit(submit, "bob", sweep[4:])]
            first_done = [ev for ev in first_events][-1]
            for fut in futs:
                fut.result()
        if first_done["event"] != "job_done":
            raise RuntimeError(f"first job: {first_done}")
        records = {t: ev[-1] for t, (ev, _) in joined.items()}
        for tenant, rec in records.items():
            if rec["event"] != "job_done":
                raise RuntimeError(f"{tenant}'s job: {rec}")
        status = client.status(sock)
        after_joined = status["engine"]["kernel_launches"]
        launches = {k: after_joined[k] - base[k] for k in base}
        batches = [r for r in _read_metrics(metrics)
                   if r["event"] == "batch_start"]
        ids = {records[t]["job_id"] for t in records}
        joined_batch = [b for b in batches if set(b["jobs"]) == ids]
        if len(joined_batch) != 1 or joined_batch[0]["n_lanes"] != 8 \
                or {records[t]["batch"] for t in records} \
                != {joined_batch[0]["batch"]} \
                or any(records[t]["joined_jobs"] != 2 for t in records):
            raise RuntimeError(f"alice's and bob's jobs did not join one "
                               f"batch: {batches}, {records}")
        epochs = max(v["stop_epoch"] for rec in records.values()
                     for v in rec["variants"].values())
        if launches["packed_matmul_lanes_fwd"] != epochs + 1 \
                or launches["packed_matmul_lanes_bwd"] != epochs \
                or launches["packed_matmul_fwd"] \
                or launches["packed_matmul_bwd"]:
            raise RuntimeError(f"the joined 8-lane batch launched "
                               f"{launches} for {epochs} epochs")
        for rec in records.values():
            for name, v in rec["variants"].items():
                got = []
                for path in v["outputs"]:
                    with open(path, "rb") as f:
                        got.append(f.read())
                if got != lane_bytes[name][2]:
                    raise RuntimeError(f"served variant {name} differs "
                                       f"from phase 9's lane {name}")
        wall = records["alice"]["batch_wall_seconds"]
        print(f"    first job (small input, f32; the daemon's first use of "
              f"the card): latency {first_done['latency_seconds']} s")
        print(f"    alice's and bob's jobs (4 train seeds each, phase 9's "
              f"--seeds 8 lanes): one batch ({joined_batch[0]['batch']}) "
              f"of 8 lanes, batch wall {wall} s = "
              f"{8 / wall * 3600:.1f} runs/hour; submit-to-job_done "
              f"latency alice {records['alice']['latency_seconds']} s, bob "
              f"{records['bob']['latency_seconds']} s (both queued behind "
              f"the first job); launches {launches} over {epochs} epochs; "
              f"every variant's three files byte-identical to phase 9's "
              f"lane of that seed")

        # 4. A warm job: the same inputs, new seeds.
        warm = client.submit_job(sock, _serve_job(
            files, os.path.join(out, "warm"), epoch=30, variants=[
                {"name": f"w{k}", "train_seed": 8 + k,
                 "kmeans_seed": 8 + k} for k in range(4)]),
            tenant="alice")[-1]
        if warm["event"] != "job_done":
            raise RuntimeError(f"warm job: {warm}")
        status = client.status(sock)
        after_warm = status["engine"]["kernel_launches"]
        warm_launches = {k: after_warm[k] - after_joined[k] for k in base}
        dones = [r for r in _read_metrics(metrics)
                 if r["event"] == "done" and "walk_stats" in r]
        with open(log) as f:
            resident = f.read().count("dataset resident")
        if dones[-1]["walk_stats"]["memo_hits"] != 2 \
                or dones[-1]["walk_stats"]["walked"] != 0 or resident != 1 \
                or not warm_launches["packed_matmul_lanes_fwd"]:
            raise RuntimeError(f"the warm job: walk_stats "
                               f"{dones[-1]['walk_stats']}, 'dataset "
                               f"resident' {resident} time(s), launches "
                               f"{warm_launches}")
        print(f"    warm job (4 new seeds): latency "
              f"{warm['latency_seconds']} s, batch wall "
              f"{warm['batch_wall_seconds']} s; dataset memo hit, "
              f"walk_stats {dones[-1]['walk_stats']}; engine walk_tier "
              f"{status['engine']['walk_tier']}; launches {warm_launches}")

        # 5. The query plane.
        keys = sorted(b["bundle"] for b in client.query(sock, "list")[
            "bundles"])
        example_keys = [k for k in keys
                        if k.split("/")[0] != first_done["job_id"]]
        if len(keys) != 13 or len(example_keys) != 12:
            raise RuntimeError(f"published bundles: {keys}")
        genes = _bundle_arrays(state, example_keys[0])[0]
        t0 = time.perf_counter()
        rc, text = _serve_cli(["--socket", sock, "--query", "neighbors",
                               "--query-job", example_keys[0].split("/")[0],
                               "--query-variant",
                               example_keys[0].split("/")[1],
                               "--query-gene", genes[0], "--query-k", "5"])
        if rc != 0 or json.loads(text)["event"] != "query_result":
            raise RuntimeError(f"--query neighbors exited {rc}: {text}")
        print(f"    --query neighbors through the CLI: rc 0 in "
              f"{time.perf_counter() - t0:.2f} s (a fresh interpreter)")
        lat = _check_queries(sock, state, keys, example_keys,
                             np.random.default_rng(10))
        for kind, ms in lat.items():
            print(f"    {kind}: {_percentiles(ms)}")
        print(f"    200 queries over the example's {len(example_keys)} "
              f"bundles (all {len(keys)} manifests verified): exact neighbors, IVF neighbors at "
              f"nprobe 16 and topk_biomarkers equal the numpy full sort; "
              f"gene_rank equals each bundle's full-sort rank; {smi}")

        # 6. Drain a streaming job mid-training, recover under --supervise.
        drain_job = _serve_job(
            small, os.path.join(out, "drain"), train_mode="streaming",
            shard_paths=16, checkpoint_every=4, stream_patience=30,
            **small_args)
        sub = {}

        def submit_drain():
            sub["events"] = list(client.request(
                sock, {"op": "submit", "job": drain_job, "tenant": "dave"},
                timeout=300))

        with ThreadPoolExecutor(1) as pool:
            fut = pool.submit(submit_drain)
            ids_before = set()

            def checkpointed():
                for r in _read_metrics(metrics):
                    if r["event"] == "job_state" \
                            and r.get("state") == "checkpointed":
                        ids_before.add(r["job_id"])
                return bool(ids_before)
            _wait_for(checkpointed, "streaming cursor", proc=daemon)
            rc, text = _serve_cli(["--socket", sock, "--drain"])
            if rc != 0:
                raise RuntimeError(f"--drain exited {rc}: {text}")
            rc = daemon.wait(timeout=300)
            fut.result()
        jid = sub["events"][0]["job_id"]
        last = sub["events"][-1]
        ckpt = os.path.join(state, "ckpt", f"{jid}.v")
        if rc != 0 or last["event"] != "job_drained" \
                or not os.path.exists(os.path.join(state, "jobs",
                                                   f"{jid}.json")) \
                or not os.path.isdir(ckpt) or not os.listdir(ckpt):
            raise RuntimeError(f"drain: daemon rc {rc}, last event {last}, "
                               f"journal/cursor missing")
        drained = _job_events(metrics, jid, "job_state")
        cursor = [r for r in drained if r["state"] == "checkpointed"][-1]
        print(f"    streaming job {jid} drained at epoch {cursor['epoch']} "
              f"shard {cursor['shard']}: daemon exit 0, job journaled, "
              f"cursor under {os.path.relpath(ckpt, wd)}")
        supervisor = _serve_proc(_serve_args(sock, state, cache, metrics,
                                             "--supervise"), log)
        procs.append(supervisor)
        if not client.wait_ready(sock, deadline_s=120.0):
            raise RuntimeError("the supervised daemon did not answer ping")
        rec = client.poll_result(state, jid, deadline_s=300.0)
        states = [r["state"] for r in _job_events(metrics, jid, "job_state")]
        runs = []
        for state in states:
            if runs and runs[-1][0] == state:
                runs[-1][1] += 1
            else:
                runs.append([state, 1])
        if rec["status"] != "done" or "resumed" not in states:
            raise RuntimeError(f"recovered job: {rec}, states {states}")
        job_cfg = config_from_job(
            dict(drain_job, result_name=os.path.join(out, "drain_solo")),
            G2VecConfig(device="cuda"))
        solo_cfg = lane_config(job_cfg, _variant_from_dict(
            0, {"name": "v"}, job_cfg))
        solo, _ = _run_pipeline(solo_cfg)
        served_bytes = []
        for path in rec["variants"]["v"]["outputs"]:
            with open(path, "rb") as f:
                served_bytes.append(f.read())
        if served_bytes != _outputs(solo):
            raise RuntimeError("the drained-and-recovered streaming job's "
                               "files differ from its uninterrupted solo "
                               "run")
        print(f"    relaunched under --supervise: the journal re-queued "
              f"{jid}, which resumed from its cursor (states "
              + ", ".join(st if n == 1 else f"{st} x{n}" for st, n in runs)
              + ") and "
              f"wrote its uninterrupted solo run's bytes; latency "
              f"{rec['latency_seconds']} s from the first submit")

        # 7. Shut down.
        rc, text = _serve_cli(["--socket", sock, "--shutdown"])
        if rc != 0:
            raise RuntimeError(f"--shutdown exited {rc}: {text}")
        rc = supervisor.wait(timeout=300)
        if rc != 0:
            raise RuntimeError(f"the supervised daemon exited {rc}")
        print("    --shutdown: the daemon and its supervisor exit 0")
        return {"joined": launches, "warm": warm_launches,
                "stream_solo": _outputs(solo)}
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _trace_breakdown(path, stage):
    """From a ``--profile-dir`` Chrome trace: CUDA kernel time by name over
    the whole run ({name: (ms, count)}, most first), and the share of the
    ``stage`` range (the CPU span of ``stage:<name>``) during which the
    card ran no kernel, copy or memset."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    span = [e for e in events if e.get("name") == stage
            and e.get("ph") == "X" and e.get("cat") != "gpu_user_annotation"]
    if len(span) != 1:
        raise RuntimeError(f"{len(span)} {stage} ranges in the trace")
    t0, t1 = span[0]["ts"], span[0]["ts"] + span[0]["dur"]
    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in (
        "kernel", "gpu_memcpy", "gpu_memset")]
    kernels = [e for e in device if e["cat"] == "kernel"]
    if not kernels:
        raise RuntimeError("the trace holds no CUDA kernel")
    by_name = {}
    for e in kernels:
        ms, n = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (ms + e["dur"] / 1e3, n + 1)
    busy, end = 0.0, t0
    for a, b in sorted((max(e["ts"], t0), min(e["ts"] + e["dur"], t1))
                       for e in device):
        if b > max(a, end):
            busy += b - max(a, end)
            end = b
    ordered = dict(sorted(by_name.items(), key=lambda kv: -kv[1][0]))
    return ordered, 1.0 - busy / (t1 - t0), (t1 - t0) / 1e3


def _compute_apps():
    """{pid: used MiB} of the card's compute processes, as
    ``nvidia-smi --query-compute-apps=pid,used_memory`` lists them."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True)
    apps = {}
    for line in proc.stdout.strip().splitlines():
        pid, mem = (x.strip() for x in line.split(","))
        apps[int(pid)] = int(mem) if mem.isdigit() else mem
    return apps


def _gpu_used_mib() -> int:
    """The card's used memory, MiB (``nvidia-smi --query-gpu=memory.used``)."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True)
    return int(proc.stdout.split()[0])


def _rss_mib(pid) -> float:
    with open(f"/proc/{pid}/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    raise RuntimeError(f"no VmRSS for pid {pid}")


def _ring_owner(job, names):
    """The replica the router's ring places ``job`` on (its placement
    key is the daemon's join key under the router's defaults)."""
    from g2vec_tpu_torch.config import (G2VecConfig, config_from_job,
                                        serve_join_key)
    from g2vec_tpu_torch.serve.router import HashRing

    ring = HashRing()
    for name in names:
        ring.add(name)
    base = {k: v for k, v in job.items() if k not in ("variants", "seeds")}
    return ring.lookup(repr(serve_join_key(config_from_job(
        base, G2VecConfig()))))


def _job_done_counts(fleet, names):
    counts = {}
    for name in names:
        path = os.path.join(fleet, name, "metrics.jsonl")
        for rec in (_read_metrics(path) if os.path.exists(path) else []):
            if rec["event"] == "job_done":
                counts[rec["job_id"]] = counts.get(rec["job_id"], 0) + 1
    return counts


def _router_phase(files, small, small_args, tmp, lane_bytes, stream_solo,
                  smi):
    """Phase 11: ``serve --replicas 2`` on the card, as a child process:
    two card replicas behind the router, a joined routed batch, a
    SIGKILLed replica failed over, an exact query through the router."""
    from g2vec_tpu_torch.serve import client, protocol

    t_phase = time.perf_counter()
    wd = os.path.join(tmp, "fleet11")
    fleet, out = os.path.join(wd, "fleet"), os.path.join(wd, "out")
    os.makedirs(wd)
    names = ["r0", "r1"]
    procs = []
    try:
        # 0. No card visible to the replicas: the first one fails its
        # boot, and the router exits non-zero naming it (no CPU serving).
        t0 = time.perf_counter()
        nocard_log = os.path.join(wd, "nocard.log")
        nocard = _serve_proc(["--replicas", "2", "--listen", "127.0.0.1:0",
                              "--state-dir", os.path.join(wd, "nocard")],
                             nocard_log, env={"CUDA_VISIBLE_DEVICES": ""})
        procs.append(nocard)
        rc = nocard.wait(timeout=120)
        with open(nocard_log) as f:
            text = f.read()
        line = next((ln for ln in text.splitlines()
                     if "cannot start" in ln), "")
        if rc == 0 or "died during boot" not in line \
                or "no CUDA device" not in text:
            raise RuntimeError(f"a card-less fleet's router exited {rc}: "
                               f"{text[-800:]}")
        print(f"    with CUDA_VISIBLE_DEVICES= the router exits {rc} after "
              f"{time.perf_counter() - t0:.1f} s: {line[:150]}")

        # 1. The router and its two replicas; both used once, straight.
        t0 = time.perf_counter()
        router = _serve_proc(["--replicas", "2", "--listen", "127.0.0.1:0",
                              "--state-dir", fleet, "--cache-dir",
                              os.path.join(wd, "cache"), "--ann-nlist",
                              "16", "--probe-interval", "0.3"],
                             os.path.join(wd, "router.log"))
        procs.append(router)
        addr_file = os.path.join(fleet, "router_addr")
        _wait_for(lambda: os.path.exists(addr_file), "router_addr",
                  deadline_s=100.0, proc=router)
        with open(addr_file) as f:
            addr = f.read().strip()
        boot_s = time.perf_counter() - t0
        st = client.status(addr)
        reps = st["replicas"]
        if st["role"] != "router" or st["active"] != names or any(
                reps[n]["state"] != "healthy" for n in names):
            raise RuntimeError(f"router status: {st}")
        warm = {}

        def warm_up(name):
            warm[name] = client.submit_job(reps[name]["addr"], _serve_job(
                small, os.path.join(out, f"warm_{name}"),
                compute_dtype="float32", **dict(small_args, epoch=5)),
                tenant="ops")[-1]

        # One at a time: the card's used memory grows by each replica's
        # context as its first job makes it.
        mem, used = {}, _gpu_used_mib()
        for name in names:
            warm_up(name)
            now = _gpu_used_mib()
            mem[name], used = now - used, now
        if any(ev["event"] != "job_done" for ev in warm.values()) \
                or min(mem.values()) <= 0:
            raise RuntimeError(f"warm-up jobs: {warm}, memory {mem}")
        apps = _compute_apps()
        pids = {n: reps[n]["pid"] for n in names}
        by_pid = all(pid in apps for pid in pids.values())
        router_pid = st["pid"]
        with open(f"/proc/{router_pid}/maps") as f:
            maps = f.read()
        if router_pid in apps or "libcuda" in maps or "libtorch" in maps:
            raise RuntimeError("the router process holds a CUDA context "
                               "or loaded torch")
        print(f"    router pid {router_pid} up with both replicas in "
              f"{boot_s:.1f} s (the replicas boot one after the other); "
              f"router RSS {_rss_mib(router_pid):.1f} MiB, no CUDA "
              f"context (no libcuda or libtorch mapped in its address "
              f"space)")
        print(f"    --query-compute-apps (pid: MiB) {apps}; "
              + ", ".join(f"{n} pid {pids[n]}: "
                          + (f"{apps[pids[n]]} MiB listed, "
                             if pids[n] in apps else "")
                          + f"memory.used +{mem[n]} MiB with its first job"
                          for n in names)
              + ("" if by_pid else " (nvidia-smi does not list this "
                 "container's pids: the kill is read from memory.used)"))

        # 2. Alice's and Bob's jobs (phase 9's seeds) share one join key:
        # the ring puts both on one replica, behind a float32 job (no
        # packed kernel) that keeps its scheduler busy until both queue.
        sweep = [(name, ts, ks) for name, (ts, ks, _) in
                 sorted(lane_bytes.items(), key=lambda kv: kv[1][0])]

        def tenant_job(tenant, lanes):
            return _serve_job(files, os.path.join(out, tenant), epoch=30,
                              variants=[{"name": n, "train_seed": ts,
                                         "kmeans_seed": ks}
                                        for n, ts, ks in lanes])

        alice, bob = tenant_job("alice", sweep[:4]), tenant_job("bob",
                                                                sweep[4:])
        owner = _ring_owner(alice, names)
        if _ring_owner(bob, names) != owner:
            raise RuntimeError("alice's and bob's jobs hash apart")
        blocker = next(
            job for job in (_serve_job(
                small, os.path.join(out, f"block{nb}"),
                compute_dtype="float32", **dict(small_args, numBiomarker=nb))
                for nb in range(5, 60))
            if _ring_owner(job, names) == owner)
        owner_addr = reps[owner]["addr"]
        base = client.status(owner_addr)["engine"]["kernel_launches"]
        t2 = time.perf_counter()
        first = client.request(addr, {"op": "submit", "job": blocker,
                                      "tenant": "carol"})
        ack = next(first)
        if ack.get("replica") != owner:
            raise RuntimeError(f"the blocker went to {ack}, not {owner}")
        for ev in first:
            if ev["event"] == "started":
                break
        joined = {}

        def submit(tenant, job):
            joined[tenant] = client.submit_job(addr, job, tenant=tenant)

        with ThreadPoolExecutor(2) as pool:
            futs = [pool.submit(submit, "alice", alice),
                    pool.submit(submit, "bob", bob)]
            blocked = [ev for ev in first][-1]
            for fut in futs:
                fut.result()
        recs = {t: ev[-1] for t, ev in joined.items()}
        if blocked["event"] != "job_done" or any(
                r["event"] != "job_done" for r in recs.values()) or {
                ev[0]["replica"] for ev in joined.values()} != {owner}:
            raise RuntimeError(f"routed jobs: {blocked}, {joined}")
        after = client.status(owner_addr)["engine"]["kernel_launches"]
        launches = {k: after[k] - base[k] for k in base}
        epochs = max(v["stop_epoch"] for r in recs.values()
                     for v in r["variants"].values())
        if len({r["batch"] for r in recs.values()}) != 1 \
                or any(r["joined_jobs"] != 2 for r in recs.values()) \
                or launches["packed_matmul_lanes_fwd"] != epochs + 1 \
                or launches["packed_matmul_lanes_bwd"] != epochs \
                or launches["packed_matmul_fwd"] \
                or launches["packed_matmul_bwd"]:
            raise RuntimeError(f"the routed jobs did not join one lane "
                               f"batch: {recs}, launches {launches}")
        for rec in recs.values():
            for name, v in rec["variants"].items():
                got = []
                for path in v["outputs"]:
                    with open(path, "rb") as f:
                        got.append(f.read())
                if got != lane_bytes[name][2]:
                    raise RuntimeError(f"routed variant {name} differs from "
                                       f"phase 9's lane {name}")
        wall = recs["alice"]["batch_wall_seconds"]
        print(f"    alice's and bob's jobs routed to {owner} (the ring's "
              f"owner of their join key) behind a float32 job: one batch "
              f"of 8 lanes, wall {wall} s = {8 / wall * 3600:.1f} "
              f"runs/hour; launches read through {owner}'s status "
              f"{launches} over {epochs} epochs; every variant "
              f"byte-identical to phase 9's lane ({time.perf_counter() - t2:.1f} s)")

        # 3. A streaming job; SIGKILL its replica once its cursor exists.
        stream_job = _serve_job(
            small, os.path.join(out, "stream"), train_mode="streaming",
            shard_paths=16, checkpoint_every=4, stream_patience=30,
            **small_args)
        jid = protocol.idem_job_id("phase11-stream")
        got = {}

        def stream_submit():
            got["rec"] = client.submit_and_wait(
                addr, stream_job, idem_key="phase11-stream", timeout=300,
                poll_deadline_s=300)
            got["t"] = time.perf_counter()

        with ThreadPoolExecutor(1) as pool:
            fut = pool.submit(stream_submit)
            victim = []

            def cursor():
                for n in names:
                    path = os.path.join(fleet, n, "metrics.jsonl")
                    if any(r.get("job_id") == jid
                           and r.get("state") == "checkpointed"
                           for r in _read_metrics(path)):
                        victim.append(n)
                        return True
                return False
            _wait_for(cursor, "the streaming job's cursor", proc=router)
            victim = victim[0]
            survivor = next(n for n in names if n != victim)
            v_pid = pids[victim]
            if os.path.exists(os.path.join(fleet, victim, "state",
                                           "results", f"{jid}.json")):
                raise RuntimeError("the streaming job ended before the "
                                   "kill")
            surv_base = client.status(reps[survivor]["addr"])[
                "engine"]["kernel_launches"]
            before = _gpu_used_mib()
            t_kill, t_kill_wall = time.perf_counter(), time.time()
            os.kill(v_pid, 9)

            def gone():
                if by_pid:
                    return v_pid not in _compute_apps()
                return before - _gpu_used_mib() >= mem[victim] // 2
            _wait_for(gone, "the killed replica to leave the card", 60.0)
            t_gone = time.perf_counter()
            freed = before - _gpu_used_mib()
            fut.result()
        t_done = got["t"]
        rec = got["rec"]
        if rec["event"] != "job_done" or rec["job_id"] != jid:
            raise RuntimeError(f"the failed-over streaming job: {rec}")
        rmetrics = _read_metrics(os.path.join(fleet,
                                              "router-metrics.jsonl"))
        fo = [r for r in rmetrics if r["event"] == "failover"
              and r["job_id"] == jid]
        if len(fo) != 1 or fo[0]["from_replica"] != victim \
                or fo[0]["to_replica"] != survivor:
            raise RuntimeError(f"failover events: {fo}")
        states = [r["state"] for r in _read_metrics(os.path.join(
            fleet, survivor, "metrics.jsonl"))
            if r.get("job_id") == jid and r["event"] == "job_state"]
        surv_after = client.status(reps[survivor]["addr"])[
            "engine"]["kernel_launches"]
        surv_launches = {k: surv_after[k] - surv_base[k]
                         for k in surv_base}
        if "resumed" not in states or not surv_launches["packed_matmul_fwd"]:
            raise RuntimeError(f"the survivor's states {states}, launches "
                               f"{surv_launches}")
        served = []
        for path in rec["variants"]["v"]["outputs"]:
            with open(path, "rb") as f:
                served.append(f.read())
        if served != stream_solo:
            raise RuntimeError("the failed-over streaming job's files "
                               "differ from its solo run's")

        def healthy():
            r = client.status(addr)["replicas"][victim]
            return r["state"] == "healthy" and r["boots"] == 2
        _wait_for(healthy, f"{victim} healthy again", 120.0, proc=router)
        t_healthy = time.perf_counter()
        relaunched = [r for r in _read_metrics(os.path.join(
            fleet, "router-metrics.jsonl"))
            if r["event"] == "replica_relaunched"
            and r["replica"] == victim]
        if len(relaunched) != 1:
            raise RuntimeError(f"relaunch events: {relaunched}")
        # The event is written once the relaunched listener is up (wall
        # clocks of one host).
        up_after_kill = relaunched[0]["ts"] - t_kill_wall
        new = client.status(addr)["replicas"][victim]
        direct = client.submit_job(new["addr"], _serve_job(
            small, os.path.join(out, "relaunched"), **small_args),
            tenant="ops")[-1]
        status_new = client.status(new["addr"])
        if direct["event"] != "job_done" \
                or not status_new["engine"]["kernel_launches"][
                    "packed_matmul_fwd"]:
            raise RuntimeError(f"a job on the relaunched {victim}: {direct}")
        apps = _compute_apps()
        runs = []
        for state in states:
            if runs and runs[-1][0] == state:
                runs[-1][1] += 1
            else:
                runs.append([state, 1])
        print(f"    streaming job {jid} on {victim}, SIGKILLed (pid {v_pid}) "
              f"at its first cursor: the router fenced it and moved the "
              f"journal to {survivor}, which resumed from the cursor "
              f"(states " + ", ".join(st if n == 1 else f"{st} x{n}"
                                      for st, n in runs)
              + f"; launches {surv_launches}); the files are "
              f"its solo run's bytes; kill to job_done "
              f"{t_done - t_kill:.2f} s; its context left the card "
              f"{t_gone - t_kill:.2f} s after the kill (memory.used "
              f"-{freed} MiB)")
        print(f"    {victim} relaunched (listener up {up_after_kill:.2f} s "
              f"after the kill), healthy {t_healthy - t_kill:.2f} s after "
              f"the kill, i.e. {t_healthy - t_kill - up_after_kill:.2f} s "
              f"from its relaunch to healthy; a job sent straight to it "
              f"ran on the card (new pid {new['pid']}); memory.used "
              f"{_gpu_used_mib()} MiB, compute apps {apps}")

        # 4. One exact query through the router.
        key = f"{recs['alice']['job_id']}/{sweep[0][0]}"
        genes, emb, norms, _ = _bundle_arrays(
            os.path.join(fleet, owner, "state"), key)
        ev = client.query(addr, "neighbors", job_id=key.split("/")[0],
                          variant=key.split("/")[1], gene=genes[3], k=10,
                          mode="exact")
        idx, sims = _full_sort_neighbors(emb, norms, 3, 10)
        if ev.get("event") != "query_result" \
                or ev["neighbors"] != [genes[j] for j in idx] \
                or ev["sims"] != [float(x) for x in sims]:
            raise RuntimeError(f"the routed exact query: {ev}")
        counts = _job_done_counts(fleet, names)
        ids = [blocked["job_id"], recs["alice"]["job_id"],
               recs["bob"]["job_id"], jid]
        if any(counts.get(i) != 1 for i in ids):
            raise RuntimeError(f"job_done events by job id: {counts}")
        print(f"    exact neighbors of {genes[3]} in {key} through the "
              f"router equal the numpy full sort; one job_done per job id "
              f"across both replicas' metrics")

        # 5. Shut the fleet down.
        client.shutdown(addr)
        rc = router.wait(timeout=120)
        if rc != 0:
            raise RuntimeError(f"the router exited {rc}")
        took = time.perf_counter() - t_phase
        print(f"    --shutdown: the router and its replicas exit 0; phase "
              f"11 took {took:.1f} s; {smi}")
        if took > 120.0:
            raise RuntimeError(f"phase 11 took {took:.1f} s (bound 120 s)")
        return {"boot_s": boot_s, "runs_per_hour": 8 / wall * 3600,
                "kill_to_done_s": t_done - t_kill,
                "relaunch_to_healthy_s": t_healthy - t_kill - up_after_kill}
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for name in ("r0", "r1"):
            # A replica the router left behind (it was killed itself):
            # its pidfile, checked against its command line.
            try:
                with open(os.path.join(fleet, name, "state",
                                       "serve.pid")) as f:
                    pid = int(f.read())
                with open(f"/proc/{pid}/cmdline", "rb") as f:
                    if fleet.encode() in f.read():
                        os.kill(pid, 9)
            except (OSError, ValueError):
                pass


#: The launch counters of the packed kernels, solo and lane.
_PM_NAMES = ("packed_matmul_fwd", "packed_matmul_bwd",
             "packed_matmul_lanes_fwd", "packed_matmul_lanes_bwd")


def _pm_counts(pm):
    return {name: getattr(pm, name).launches for name in _PM_NAMES}


def _stability_rows(path):
    """``<NAME>_stability.txt`` -> (meta dict, header cells, rows)."""
    with open(path) as f:
        lines = f.read().splitlines()
    meta = dict(ln[2:].split("\t", 1) for ln in lines
                if ln.startswith("# ") and "\t" in ln[2:])
    body = [ln.split("\t") for ln in lines if not ln.startswith("#")]
    return meta, body[0], body[1:]


def _plain_permutation_columns(expr, labels, nulls, selected, genes):
    """The permutation table's cells from numpy alone: |t| with the pooled
    variance, the add-one p-value over the nulls' label draws, BH q by a
    sort, and the observed lane's selection."""
    def abs_t(lab):
        a = expr[lab == 0].astype(np.float64)
        b = expr[lab == 1].astype(np.float64)
        na, nb = len(a), len(b)
        pooled = ((na - 1) * a.var(axis=0, ddof=1)
                  + (nb - 1) * b.var(axis=0, ddof=1)) / (na + nb - 2)
        den = np.sqrt(pooled) * np.sqrt(1.0 / na + 1.0 / nb)
        diff = a.mean(axis=0) - b.mean(axis=0)
        return np.abs(np.divide(diff, den, out=np.zeros_like(diff),
                                where=den > 0))

    t_obs = abs_t(labels)
    t_null = np.stack([abs_t(lab) for lab in nulls])
    p = (1.0 + (t_null >= t_obs).sum(axis=0)) / (1.0 + len(nulls))
    order = np.argsort(p, kind="stable")
    m = len(p)
    q_sorted = np.minimum(1.0, np.minimum.accumulate(
        (p[order] * m / np.arange(1, m + 1))[::-1])[::-1])
    q = np.empty(m)
    q[order] = q_sorted
    sel = set(selected)
    return [["%.6f" % t_obs[i], "%.6f" % p[i], "%.6f" % q[i],
             "1" if g in sel else "0"] for i, g in enumerate(genes)]


def _scenario_runs(pm, files, tmp):
    """Phase 12a: the three scenarios at the example on the card."""
    import dataclasses

    from g2vec_tpu_torch.batch.engine import _lane_cohort, lane_config
    from g2vec_tpu_torch.pipeline import preprocess_inputs, read_inputs
    from g2vec_tpu_torch.preprocess import permute_labels
    from g2vec_tpu_torch.stats.run import run_scenario

    def scenario(kind, sub, **kw):
        out = os.path.join(tmp, "scn", sub)
        os.makedirs(out, exist_ok=True)
        cfg = _config(files, out, "cuda", epoch=30, scenario=kind,
                      scenario_seed=12, **kw)
        pm.reset_launch_counts()
        t0 = time.perf_counter()
        res = run_scenario(cfg, console=lambda s: None)
        wall = time.perf_counter() - t0
        counts = _pm_counts(pm)
        b = res.batch
        print(f"    {kind} ({res.n_variants} lanes, scenario "
              f"{res.scenario_id}): {wall:.3f} s = "
              f"{res.n_variants / wall * 3600:.1f} runs/hour (engine "
              f"{b.wall_seconds:.3f} s, {b.runs_per_hour:.1f}); walks "
              + json.dumps(res.walk_stats) + "; buckets "
              + json.dumps([(x["lanes"], x["mode"]) for x in b.buckets])
              + "; launches " + json.dumps(counts) + "; stage seconds "
              + json.dumps({k: round(v, 3)
                            for k, v in b.stage_seconds.items()}))
        return cfg, res, wall, counts

    runs = {}
    cfg, res, wall, counts = scenario("bootstrap", "b1", replicates=8)
    runs["bootstrap"] = (res, wall, counts)
    for name in ("b000", "b005"):
        v = next(v for v in res.batch.variants if v.name == name)
        lane = res.batch.lanes[res.batch.variants.index(v)]
        solo, _ = _run_pipeline(lane_config(dataclasses.replace(
            cfg, result_name=os.path.join(tmp, "scn", "solo")), v))
        if _outputs(solo) != _outputs(lane):
            raise RuntimeError(f"bootstrap replicate {name} differs from "
                               f"its solo run")
    again = scenario("bootstrap", "b2", replicates=8)[1]
    with open(res.output, "rb") as a, open(again.output, "rb") as b:
        if a.read() != b.read():
            raise RuntimeError("a rerun's stability file differs")
    print("    replicates b000 and b005 are their solo runs' bytes; a rerun "
          "writes the same stability file")

    cfg, res, wall, counts = scenario("permutation", "p1", replicates=8)
    runs["permutation"] = (res, wall, counts)
    if res.walk_stats["walked"] != 2:
        raise RuntimeError(f"a cold permutation scenario walked "
                           f"{res.walk_stats['walked']} products, not 2")
    if not counts["packed_matmul_lanes_fwd"] \
            or not counts["packed_matmul_lanes_bwd"]:
        raise RuntimeError(f"the permutation lanes launched {counts}")
    data, _, _ = preprocess_inputs(*read_inputs(cfg))
    obs, nulls = res.batch.variants[0], res.batch.variants[1:]
    cohort = data if obs.expr_key() is None else _lane_cohort(data, obs)
    want = _plain_permutation_columns(
        cohort.expr, cohort.label,
        [permute_labels(cohort.label, v.permute_seed) for v in nulls],
        res.batch.lanes[0].biomarkers, list(data.gene))
    _, header, rows = _stability_rows(res.output)
    if header[1:] != ["t_obs", "p_value", "q_value", "selected_obs"] \
            or [r[1:] for r in rows] != want:
        raise RuntimeError("the permutation table differs from its numpy "
                           "recomputation")
    print("    permutation: walked=2 on a cold cache; the t/p/q/selected "
          "columns equal a numpy recomputation from the lanes' labels "
          "and the observed lane's list")

    cfg, res, wall, counts = scenario("cv", "c1", folds=5)
    runs["cv"] = (res, wall, counts)
    held = [set(data.sample) - set(_lane_cohort(data, v).sample)
            for v in res.batch.variants]
    if set().union(*held) != set(data.sample) \
            or sum(map(len, held)) != len(data.sample):
        raise RuntimeError("the CV held-out sets do not cover every "
                           "patient once")
    meta = _stability_rows(res.output)[0]
    print(f"    cv: the 5 held-out sets cover the {len(data.sample)} "
          f"patients once; acc_mean {meta['acc_mean']}, acc_ci95 "
          f"{meta['acc_ci95']}")
    return runs


def _edited_inputs(files, tmp, gene_prefix="GMOD"):
    """The inputs of the edit drills: the expression file with one gene
    that keeps no edge in either group nudged, and the network with three
    module edges added."""
    from g2vec_tpu_torch.incremental import _load_inputs
    from g2vec_tpu_torch.ops.graph import thresholded_edges

    cfg = _config(files, tmp, "cpu")
    data, src, dst = _load_inputs(cfg)
    kept = set()
    for i in range(2):
        s, d, _ = thresholded_edges(data.expr[data.label == i], src, dst,
                                    device="cpu")
        kept |= set(s.tolist()) | set(d.tolist())
    quiet = next(g for gi, g in enumerate(data.gene) if gi not in kept)
    with open(files["expression"]) as f:
        lines = f.readlines()
    for i, line in enumerate(lines):
        parts = line.rstrip("\n").split("\t")
        if parts[0] == quiet:
            parts[1] = repr(float(parts[1]) + 0.005)
            lines[i] = "\t".join(parts) + "\n"
    expr = os.path.join(tmp, "expr_nudged.tsv")
    with open(expr, "w") as f:
        f.writelines(lines)
    with open(files["network"]) as f:
        net_lines = f.readlines()
    have = set()
    for line in net_lines[1:]:
        a, b = line.split("\t")[0], line.split("\t")[1].strip()
        have |= {(a, b), (b, a)}
    added = [(f"{gene_prefix}{i:04d}", f"{gene_prefix}{j:04d}")
             for i in range(12) for j in range(i + 1, 12)
             if (f"{gene_prefix}{i:04d}", f"{gene_prefix}{j:04d}")
             not in have][:3]
    net = os.path.join(tmp, "net_delta.tsv")
    with open(net, "w") as f:
        f.writelines(net_lines)
        for a, b in added:
            f.write(f"{a}\t{b}\n")
    return expr, net, quiet, added


def _band_on_the_test_spec(tmp):
    """tests/test_update.py's spec (f32): cold run, bootstrap, an edge
    delta and a cold retrain on the new network, for walk/train seeds 0-3
    on the card and seed 0 on the CPU too. Held: |dACC| <= 0.20 for every
    seed, and the card's update against the CPU's (acc within 0.05, lists
    overlapping >= 0.9). Printed: the overlap half of the band beside the
    overlap of the two cold runs (how far a cold retrain itself moves)."""
    import dataclasses

    from g2vec_tpu_torch.cache import resolve_cache_tiers
    from g2vec_tpu_torch.data.synthetic import (SyntheticSpec,
                                                write_synthetic_tsv)
    from g2vec_tpu_torch.incremental import run_update, within_band
    from g2vec_tpu_torch.io.writers import write_inventory_bundle

    root = os.path.join(tmp, "band")
    os.makedirs(root)
    files = write_synthetic_tsv(SyntheticSpec(
        n_good=48, n_poor=40, module_size=12, n_background=24,
        n_expr_only=4, n_net_only=4, module_chords=2, background_edges=40,
        seed=7), root, prefix="band")
    _, net, _, _ = _edited_inputs(files, root)

    def one(device, seed):
        out = os.path.join(root, f"{device}{seed}")
        cfg = _config(files, out, device, lenPath=12, numRepetition=6,
                      sizeHiddenlayer=16, epoch=40, learningRate=0.05,
                      numBiomarker=10, compute_dtype="float32",
                      walker_backend="native", seed=seed,
                      cache_dir=os.path.join(out, "cache"))
        cold, _ = _run_pipeline(cfg)
        bundle = os.path.join(out, "bundle")
        write_inventory_bundle(bundle, cold.embeddings, list(cold.genes),
                               cold.biomarker_scores, {})
        wc = resolve_cache_tiers(cfg.cache_dir)
        up = run_update(cfg, bundle, walk_cache=wc)
        write_inventory_bundle(bundle, up.embeddings, up.genes,
                               up.biomarker_scores, {}, extra_files={
                                   "delta_fingerprints.json":
                                   up.fingerprints})
        cfg3 = dataclasses.replace(cfg, network_file=net)
        up3 = run_update(cfg3, bundle, walk_cache=wc)
        cold3, _ = _run_pipeline(dataclasses.replace(
            cfg3, result_name=os.path.join(out, "cold3")))
        ok, detail = within_band(up3.acc_val, cold3.acc_val,
                                 up3.biomarkers, cold3.biomarkers)
        colds = within_band(cold.acc_val, cold3.acc_val, cold.biomarkers,
                            cold3.biomarkers)[1]
        print(f"    {device} seed {seed}: edge delta {up3.stats['mode']} "
              f"{up3.stats['ranges_rewalked']}/{up3.stats['ranges_total']}"
              f" ranges; against the cold retrain " + json.dumps(
                  dict(detail, within=ok)) + "; the two cold runs "
              + json.dumps(colds))
        if up3.stats["mode"] != "delta" or detail["dacc"] > 0.20:
            raise RuntimeError(f"{device} seed {seed}: the edge delta left "
                               f"the accuracy band: {detail}")
        return up3, detail

    print("    the band on tests/test_update.py's spec (48/40, -p 12 -r 6, "
          "hidden 16, f32; |dACC| <= 0.20 held, overlap >= 0.6 printed):")
    details = [one("cuda", seed) for seed in range(4)]
    card = details[0][0]
    cpu = one("cpu", 0)[0]
    same = len(set(card.biomarkers) & set(cpu.biomarkers)) \
        / max(len(set(cpu.biomarkers)), 1)
    print(f"    seed 0, card against CPU: update acc {card.acc_val:.4f} and "
          f"{cpu.acc_val:.4f}, biomarker overlap {same:.3f}")
    if abs(card.acc_val - cpu.acc_val) > 0.05 or same < 0.9:
        raise RuntimeError("the card's update disagrees with the CPU's")
    return [d for _, d in details]


def _update_drills(torch, pm, files, tmp):
    """Phase 12b: the update op on a card daemon at the example."""
    import dataclasses
    import shutil
    import threading

    from g2vec_tpu_torch.cache import resolve_cache_tiers
    from g2vec_tpu_torch.incremental import run_update, within_band
    from g2vec_tpu_torch.io.writers import GENERATION_FILE, read_generation
    from g2vec_tpu_torch.serve import client
    from g2vec_tpu_torch.serve.daemon import ServeDaemon, ServeOptions

    root = os.path.join(tmp, "upd")
    os.makedirs(os.path.join(root, "out"))
    sock, state = os.path.join(root, "g.sock"), os.path.join(root, "state")
    d = ServeDaemon(ServeOptions(socket_path=sock, state_dir=state,
                                 device="cuda", ann_nlist=16,
                                 cache_dir=os.path.join(root, "cache"),
                                 metrics_jsonl=os.path.join(root,
                                                            "m.jsonl")),
                    console=lambda s: None)
    th = threading.Thread(target=d.serve_forever, daemon=True)
    th.start()
    expr, net, quiet, added = _edited_inputs(files, root)
    base = dict(expression_file=files["expression"],
                clinical_file=files["clinical"],
                network_file=files["network"], epoch=30)
    walls, launches, stats = {}, {}, {}
    try:
        if not client.wait_ready(sock, deadline_s=60):
            raise RuntimeError("the card daemon never became ready")
        t0 = time.perf_counter()
        events = client.submit_job(sock, dict(
            base, result_name=os.path.join(root, "out", "cold"),
            variants=[{"name": "v0"}]), timeout=300)
        walls["cold"] = time.perf_counter() - t0
        if events[-1]["event"] != "job_done":
            raise RuntimeError(f"the cold job ended {events[-1]}")
        jid = events[-1]["job_id"]
        key = f"{jid}/v0"
        gen_root = os.path.join(state, "inventory", jid, "v0")

        def arrays(gen):
            out = []
            for fn in ("embeddings.npy", "norms.npy", "scores.npy",
                       "genes.txt"):
                with open(os.path.join(gen_root, gen, fn), "rb") as f:
                    out.append(f.read())
            return out

        drills = (("bootstrap", base), ("noop", base),
                  ("expr_only", dict(base, expression_file=expr)),
                  ("delta", dict(base, network_file=net)))
        for i, (mode, job) in enumerate(drills):
            pm.reset_launch_counts()
            t0 = time.perf_counter()
            evs = client.update_job(
                sock, jid, dict(job, result_name=os.path.join(
                    root, "out", f"u{i}")), idem_key=f"upd-{mode}",
                variant="v0", timeout=300)
            walls[mode] = time.perf_counter() - t0
            launches[mode] = _pm_counts(pm)
            rec = evs[-1]
            if rec["event"] != "job_done" or rec["stats"]["mode"] != mode:
                raise RuntimeError(f"update {mode}: {rec}")
            stats[mode] = rec
            if rec["generation"] != read_generation(gen_root) \
                    or rec["generation"] != "gen-%06d" % (i + 2):
                raise RuntimeError(f"update {mode} published "
                                   f"{rec['generation']}")
            trained = launches[mode]["packed_matmul_fwd"] \
                + launches[mode]["packed_matmul_bwd"]
            if (mode == "noop") != (trained == 0) \
                    or launches[mode]["packed_matmul_lanes_fwd"]:
                raise RuntimeError(f"update {mode} launched "
                                   f"{launches[mode]}")
            s = rec["stats"]
            print(f"    update {mode}: {walls[mode]:.3f} s (cold job "
                  f"{walls['cold']:.3f} s; {walls[mode] / walls['cold']:.3f}"
                  f"x), wall_s {s['wall_s']}, walked_rows "
                  f"{s['walked_rows']}, ranges {s['ranges_rewalked']}/"
                  f"{s['ranges_total']}, cache hits {s['cache_hits']}, "
                  f"epochs {s.get('epochs')}, stop {s.get('stop_epoch')}, "
                  f"acc_val {rec['acc_val']}, {rec['generation']}; "
                  f"fine-tune launches " + json.dumps(
                      {k: v for k, v in launches[mode].items() if v}))
            if mode == "noop" and arrays("gen-000002") != arrays(
                    "gen-000003"):
                raise RuntimeError("the no-op update's arrays differ from "
                                   "the prior generation's")
            if mode == "expr_only" and s["ranges_rewalked"]:
                raise RuntimeError("an expression-only change re-walked")
            if mode == "delta" and not (0 < s["ranges_rewalked"]
                                        < s["ranges_total"]):
                raise RuntimeError(f"the edge delta re-walked "
                                   f"{s['ranges_rewalked']} ranges")
        print(f"    (nudged {quiet}, added edges {added}); the no-op's "
              f"arrays are the prior generation's bytes")
        genes, emb, norms, _ = _bundle_arrays(state, key)
        gi = genes.index(added[0][0])
        ev = client.query(sock, "neighbors", job_id=jid, variant="v0",
                          gene=genes[gi], k=10, mode="exact")
        idx, sims = _full_sort_neighbors(emb, norms, gi, 10)
        if ev.get("generation") != "gen-000005" \
                or ev["neighbors"] != [genes[j] for j in idx] \
                or ev["sims"] != [float(x) for x in sims]:
            raise RuntimeError(f"the exact query after the republish: {ev}")
        print(f"    an exact neighbors query of {genes[gi]} answers from "
              f"gen-000005, equal to the numpy full sort")
        # The band at the example: the same delta in process, from a copy
        # of the bundle pointed back at the generation the daemon's delta
        # started from. It must publish the daemon's arrays, byte for
        # byte; its biomarker list goes against a cold retrain.
        copy = os.path.join(root, "bundle_copy")
        shutil.copytree(gen_root, copy)
        with open(os.path.join(copy, GENERATION_FILE), "w") as f:
            f.write("gen-000004\n")
        cfg_d = _config(dict(files, network=net), os.path.join(root, "out"),
                        "cuda", epoch=30)
        up = run_update(cfg_d, copy, walk_cache=resolve_cache_tiers(
            os.path.join(root, "cache")))
        if up.embeddings.tobytes() != emb.tobytes():
            raise RuntimeError("the in-process delta update's embeddings "
                               "differ from the daemon's republished ones")
        cold_d, _ = _run_pipeline(dataclasses.replace(
            cfg_d, result_name=os.path.join(root, "out", "cold_delta")))
        ok, detail = within_band(up.acc_val, cold_d.acc_val,
                                 up.biomarkers, cold_d.biomarkers)
        print("    the band at the example (printed, not held): the edge "
              "delta (in process, the daemon's bytes) against a cold "
              "retrain on the card: " + json.dumps(dict(detail, within=ok))
              + f"; cold retrain {cold_d.acc_val:.4f}, update "
              f"{up.acc_val:.4f}")
    finally:
        d._stop.set()
        th.join(timeout=60)
        d.close()
    if th.is_alive():
        raise RuntimeError("the card daemon did not stop")
    return walls, launches, stats


# A rank (or the plain run) of phases 13 and 14, run through this wrapper
# instead of ``python -m g2vec_tpu_torch``: the CLI's own entry point, with
# the pipeline's result kept, the edge partition's metrics events as the
# rank emits them (a rank other than 0 writes no metrics file), and the
# edges and bytes of every whole-graph CSR the streaming trainer builds.
# At exit it records those, its selections, its kernel wrappers' launch
# counts (the forward's by tuned layout too), the tile planner's table and
# autotune events, and its peak device memory, and with
# G2V_SMOKE_KEEP_W_IH set its embeddings (a SIGKILLed rank, or one that
# exits through its failure path, records nothing).
_RANK = r"""
import atexit, hashlib, json, os, runpy, sys
sys.argv = ["g2vec_tpu_torch", *sys.argv[1:]]
import g2vec_tpu_torch.pipeline as pipeline
import g2vec_tpu_torch.train.stream as stream
from g2vec_tpu_torch.utils.metrics import MetricsWriter
kept = {"events": {}, "csrs": []}
_run, _emit, _edges_to_csr = pipeline.run, MetricsWriter.emit, \
    stream.edges_to_csr


def run(cfg, *args, **kwargs):
    kept["result"] = res = _run(cfg, *args, **kwargs)
    return res


def emit(self, event, **fields):
    if event in ("edge_partition", "halo", "handoff"):
        kept["events"][event] = fields
    return _emit(self, event, **fields)


def edges_to_csr(*args, **kwargs):
    csr = _edges_to_csr(*args, **kwargs)
    kept["csrs"].append([len(csr[1]), sum(a.nbytes for a in csr)])
    return csr


pipeline.run, MetricsWriter.emit, stream.edges_to_csr = (run, emit,
                                                         edges_to_csr)


def report():
    import numpy as np
    import torch
    from g2vec_tpu_torch.cache import cache_stats
    from g2vec_tpu_torch.ops import packed_matmul as pm

    res = kept.get("result")
    path = os.path.join(os.environ["G2V_SMOKE_REPORTS"], f"{os.getpid()}.json")
    if res is not None and os.environ.get("G2V_SMOKE_KEEP_W_IH"):
        np.save(path[:-5] + "_w_ih.npy", res.embeddings)
    with open(path, "w") as f:
        json.dump({
            "rank": int(os.environ.get("G2VEC_PROCESS_ID", "0")),
            "packed_matmul_fwd": pm.packed_matmul_fwd.launches,
            "packed_matmul_bwd": pm.packed_matmul_bwd.launches,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "acc_val": None if res is None else float(res.acc_val),
            "biomarkers": None if res is None else list(res.biomarkers),
            "lgroups_sha": None if res is None else hashlib.sha256(
                res.lgroup_idx.tobytes()).hexdigest(),
            "n_paths": None if res is None else int(res.n_paths),
            "epochs": None if res is None else len(res.train_history),
            "rows": None if res is None else int(res.embeddings.shape[0]),
            "output_files": None if res is None else list(res.output_files),
            "stage_seconds": None if res is None else res.stage_seconds,
            "stage_extras": None if res is None else res.stage_extras,
            "edge_events": kept["events"], "csrs": kept["csrs"],
            "tuned": {",".join(map(str, k)): {
                d: list(p) if d == "fwd" else p for d, p in v.items()}
                for k, v in pm._TUNED.items()},
            "autotune_events": cache_stats()["autotune"],
            "fwd_layout_launches": {
                "_".join(map(str, k)): n for k, n in
                pm.packed_matmul_fwd.layout_launches.items()}}, f)


atexit.register(report)
runpy.run_module("g2vec_tpu_torch", run_name="__main__")
"""


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _start_ranks(files, out, flags, reports, n_ranks=1, port=None,
                 extra_env=None):
    """``n_ranks`` processes of the CLI (through ``_RANK``), the
    ``G2VEC_*`` environment naming each one's rank when ``n_ranks > 1``
    (and ``extra_env`` added); returns the Popen objects, their output
    going to ``out.r<rank>.log``."""
    root = os.path.dirname(os.path.abspath(__file__))
    wrapper = os.path.join(reports, "rank.py")
    if not os.path.exists(wrapper):
        with open(wrapper, "w") as f:
            f.write(_RANK)
    procs = []
    for rank in range(n_ranks):
        env = dict(os.environ, PYTHONPATH=root, G2V_SMOKE_REPORTS=reports)
        for name in ("G2VEC_COORDINATOR", "G2VEC_PROCESS_ID",
                     "G2VEC_NUM_PROCESSES", "G2VEC_FAULT_PLAN",
                     "G2VEC_FORBID_FULL_NETWORK"):
            env.pop(name, None)
        env.update(extra_env or {})
        if n_ranks > 1:
            env.update(G2VEC_COORDINATOR=f"127.0.0.1:{port}",
                       G2VEC_PROCESS_ID=str(rank),
                       G2VEC_NUM_PROCESSES=str(n_ranks))
        log = open(f"{out}.r{rank}.log", "w")
        procs.append(subprocess.Popen(
            [sys.executable, wrapper, files["expression"], files["clinical"],
             files["network"], out, *flags], env=env, cwd=root,
            stdout=log, stderr=subprocess.STDOUT))
        log.close()
    return procs


def _wait_ranks(procs, out, timeout=400):
    """Wait for every process; returns their exit codes and logs."""
    t_end = time.monotonic() + timeout
    rcs = []
    try:
        for p in procs:
            rcs.append(p.wait(timeout=max(1.0, t_end - time.monotonic())))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    logs = []
    for rank in range(len(procs)):
        with open(f"{out}.r{rank}.log") as f:
            logs.append(f.read())
    return rcs, logs


def _rank_reports(reports):
    out = []
    for name in sorted(os.listdir(reports)):
        if name.endswith(".json"):
            with open(os.path.join(reports, name)) as f:
                out.append(json.load(f))
    return sorted(out, key=lambda r: r["rank"])


def _band_of(a_acc, a_bm, b_acc, b_bm):
    return abs(a_acc - b_acc), len(set(a_bm) & set(b_bm)) / max(len(b_bm), 1)


def _scale_phase(torch, pm, tmp):
    """Phase 13: single-card scale and two ranks on the one card. Returns
    the kernel line's ``scale`` entries of the two packed kernels."""
    from g2vec_tpu_torch.data.synth import SynthGraphSpec, write_synth_graph
    from g2vec_tpu_torch.parallel.shard import ShardSpec

    t13 = time.perf_counter()
    kernels = ("packed_matmul_fwd", "packed_matmul_bwd")
    (tcga, big), secs = _timed(lambda: (
        write_synth_graph(SynthGraphSpec(n_genes=20_000, seed=0),
                          os.path.join(tmp, "tcga"), prefix="tcga"),
        write_synth_graph(SynthGraphSpec(n_genes=262_144, n_good=8, n_poor=8,
                                         seed=5),
                          os.path.join(tmp, "big"), prefix="big")))
    print(f"    inputs (data/synth.py): G {tcga['n_genes']} x "
          f"{tcga['n_edges']} edges, 40 + 40 samples, seed 0; G "
          f"{big['n_genes']} x {big['n_edges']} edges, 8 + 8 samples, seed "
          f"5 ({secs:.1f} s to write both; expression files "
          f"{os.path.getsize(tcga['expression'])} and "
          f"{os.path.getsize(big['expression'])} bytes)")

    # (a) The TCGA-scale single rank, in process.
    a_cfg = _config(tcga, tmp, "cuda", epoch=30, train_mode="streaming",
                    walk_starts=4096)
    a_cfg.result_name += "_tcga"
    pm.reset_launch_counts()
    a_run, _ = _run_pipeline(a_cfg)
    a_launches = {k: getattr(pm, k).launches for k in kernels}
    st = a_run.stream_stats
    print(f"    (a) G 20000 streaming, hidden 128, bf16, --walk-starts 4096: "
          f"{a_run.n_paths} paths in {st['n_shards']} shards of "
          f"{st['shard_rows']} rows, {len(a_run.train_history)} epochs, "
          f"stop epoch {a_run.stop_epoch}, val acc {a_run.acc_val:.4f}; "
          f"launches {a_launches}; stage seconds " + json.dumps(
              {k: round(v, 3) for k, v in a_run.stage_seconds.items()}))
    if a_run.embeddings.shape != (20_000, 128) or \
            not np.isfinite(a_run.embeddings).all():
        raise RuntimeError("(a): embeddings are not finite [G, 128]")
    if not a_run.acc_val > 0.5:
        raise RuntimeError(f"(a): val accuracy {a_run.acc_val} <= 0.5")
    if not all(a_launches.values()):
        raise RuntimeError(f"(a): a packed kernel never launched: "
                           f"{a_launches}")
    one_cfg = _config(tcga, tmp, "cuda", epoch=30, train_mode="streaming",
                      walk_starts=4096, graph_shards=1, embed_shards=1)
    one_cfg.result_name += "_tcga_1rank"
    one, _ = _run_pipeline(one_cfg)
    if _outputs(one) != _outputs(a_run):
        raise RuntimeError("(a): --graph-shards 1 --embed-shards 1 wrote "
                           "other bytes than the plain run")
    print("    --graph-shards 1 --embed-shards 1: byte-identical files")

    # (b) The scale-out spec, plain and on two ranks, and (c) the drill,
    # all started together (five processes on the one card).
    b_flags = ["-p", "12", "-r", "2", "-s", "256", "-e", "2",
               "--stream-patience", "2", "--train-mode", "streaming",
               "--walk-starts", "2048", "--shard-paths", "256",
               "--stream-eval-rows", "256"]
    fleet_flags = ["--distributed", "--graph-shards", "2", "--embed-shards",
                   "2"]
    runs = {}
    t_b = time.perf_counter()
    for name, files, flags, n in (
            ("plain", big, b_flags, 1),
            ("fleet", big, b_flags + fleet_flags
             + ["--fleet-watchdog-deadline", "300"], 2),
            ("drill", tcga, ["-e", "30", "--train-mode", "streaming",
                             "--walk-starts", "4096", *fleet_flags,
                             "--fleet-watchdog-deadline", "15",
                             "--fault-plan", "process=1,stage=embed_allreduce,"
                             "kind=sigkill,epoch=3"], 2)):
        reports = os.path.join(tmp, f"{name}_reports")
        os.makedirs(reports)
        out = os.path.join(tmp, f"big_{name}")
        runs[name] = (_start_ranks(files, out, flags, reports, n,
                                   _free_port()), out, reports)
    done = {name: _wait_ranks(procs, out) for name, (procs, out, _)
            in runs.items()}
    print(f"    (b, c) the plain run, the two ranks and the drill took "
          f"{time.perf_counter() - t_b:.1f} s together")
    for name in ("plain", "fleet"):
        rcs, logs = done[name]
        if any(rcs):
            raise RuntimeError(f"(b) {name}: exit codes {rcs}:\n"
                               + "\n".join(log[-3000:] for log in logs))
    plain, = _rank_reports(runs["plain"][2])
    ranks = _rank_reports(runs["fleet"][2])
    if [r["rank"] for r in ranks] != [0, 1]:
        raise RuntimeError(f"(b): rank reports {ranks}")
    for key in ("biomarkers", "lgroups_sha", "acc_val", "n_paths"):
        if ranks[0][key] != ranks[1][key]:
            raise RuntimeError(f"(b): the ranks' {key} differ")
    if ranks[1]["output_files"] or len(ranks[0]["output_files"]) != 3 \
            or ranks[0]["rows"] + ranks[1]["rows"] != 262_144:
        raise RuntimeError(f"(b): output files {ranks[0]['output_files']} "
                           f"and {ranks[1]['output_files']}, rows "
                           f"{ranks[0]['rows']} + {ranks[1]['rows']}")
    with open(ranks[0]["output_files"][2]) as f:
        n_lines = sum(1 for _ in f)
    if n_lines != 262_145:
        raise RuntimeError(f"(b): the vectors file has {n_lines} lines")
    acc_gap, overlap = _band_of(ranks[0]["acc_val"], ranks[0]["biomarkers"],
                                plain["acc_val"], plain["biomarkers"])
    print(f"    (b) G 262144, hidden 256, 8 + 8 samples, -p 12 -r 2, "
          f"--walk-starts 2048, --shard-paths 256, --stream-eval-rows 256, "
          f"-e 2: plain val acc {plain['acc_val']:.4f}, {plain['n_paths']} "
          f"paths, {plain['epochs']} epochs; two ranks val acc "
          f"{ranks[0]['acc_val']:.4f}, {ranks[0]['n_paths']} paths, the same "
          f"selections on both, rank 0 alone wrote; |dACC| {acc_gap:.4f} "
          f"(band 0.20), top-N overlap {overlap:.3f} (floor 0.6)")
    for r in (plain, *ranks):
        print(f"    {'plain' if r is plain else 'rank %d' % r['rank']}: "
              f"max_memory_allocated {r['max_memory_allocated']} bytes; "
              f"launches fwd {r['packed_matmul_fwd']}, bwd "
              f"{r['packed_matmul_bwd']}; stage seconds " + json.dumps(
                  {k: round(v, 3) for k, v in r["stage_seconds"].items()}))
    if acc_gap > 0.20 or overlap < 0.6:
        raise RuntimeError("(b): the two ranks left the band of the plain "
                           "run")
    for r in ranks:
        if not r["max_memory_allocated"] < plain["max_memory_allocated"]:
            raise RuntimeError(f"(b): rank {r['rank']} peaked at "
                               f"{r['max_memory_allocated']} bytes, the "
                               f"plain run at "
                               f"{plain['max_memory_allocated']}")
        if not (r["packed_matmul_fwd"] and r["packed_matmul_bwd"]):
            raise RuntimeError(f"(b): rank {r['rank']} launched {r}")
    rcs, logs = done["drill"]
    if rcs[1] != -9 or rcs[0] == 0 or "PeerTimeoutError" not in logs[0] \
            or "missing rank(s): [1]" not in logs[0]:
        raise RuntimeError(f"(c): exit codes {rcs}:\n{logs[0][-3000:]}")
    print(f"    (c) --fault-plan process=1,stage=embed_allreduce,kind="
          f"sigkill,epoch=3, --fleet-watchdog-deadline 15: rank 1 killed "
          f"by signal 9, rank 0 exit {rcs[0]}: "
          + next(ln for ln in logs[0].splitlines()
                 if "missing rank(s): [1]" in ln).strip())

    # The kernels at the scale launch shapes: (a)'s widest shard and eval
    # buffer, and one rank's split step.
    gen = torch.Generator(device="cuda").manual_seed(13)
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    records = {k: {} for k in kernels}
    shard_rows, _, val_rows, _ = _stream_shapes(torch, a_cfg)
    print(f"    kernels at (a)'s streaming shapes: train rows "
          f"M={shard_rows.shape[0]}, eval buffer M={val_rows.shape[0]}, "
          f"G 20000, hidden 128")
    rec = _compare_kernels(torch, pm, shard_rows, shard_rows.shape[0],
                           20_000, 128, gen, flush, timed=True)
    rec["eval_fwd"] = _compare_kernels(
        torch, pm, val_rows, val_rows.shape[0], 20_000, 128, gen, flush,
        timed=True, names=("packed_matmul_fwd",))["packed_matmul_fwd"]
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    for k in kernels:
        records[k]["tcga_streaming"] = {
            "launches": a_launches[k], "shard": {
                "m": int(shard_rows.shape[0]), **{x: rec[k][x] for x in keys}}}
    records["packed_matmul_fwd"]["tcga_streaming"]["eval_buffer"] = {
        "m": int(val_rows.shape[0]), **{x: rec["eval_fwd"][x] for x in keys}}
    b_cfg = _config(big, tmp, "cuda", lenPath=12, numRepetition=2,
                    sizeHiddenlayer=256, train_mode="streaming",
                    walk_starts=2048, shard_paths=256, stream_eval_rows=256)
    spec0 = ShardSpec(rank=0, n_ranks=2, n_genes=262_144, embed_shards=2)
    g_local = (spec0.byte_range()[1] - spec0.byte_range()[0]) * 8
    rows0, _, val0, _ = _stream_shapes(torch, b_cfg,
                                       byte_range=spec0.byte_range())
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"    the split step at rank 0's launch shape: train rows "
          f"M={rows0.shape[0]} of its {rows0.shape[1]}-byte rows, G_local "
          f"{g_local}, hidden 256; "
          + _forward_plan_line(pm, rows0.shape[0], g_local, 256, n_sms)
          + "; " + _backward_plan_line(pm, rows0.shape[0], g_local, 256,
                                       n_sms))
    rec = _compare_kernels(torch, pm, rows0, rows0.shape[0], g_local, 256,
                           gen, flush, timed=True)
    rec["eval_fwd"] = _compare_kernels(
        torch, pm, val0, val0.shape[0], g_local, 256, gen, flush, timed=True,
        names=("packed_matmul_fwd",))["packed_matmul_fwd"]
    for k in kernels:
        records[k]["split"] = {
            "launches": {f"rank{r['rank']}": r[k] for r in ranks},
            "plain_run_launches": plain[k], "m": int(rows0.shape[0]),
            "g_local": g_local, "h": 256, **{x: rec[k][x] for x in keys}}
    records["packed_matmul_fwd"]["split"]["eval_buffer"] = {
        "m": int(val0.shape[0]), **{x: rec["eval_fwd"][x] for x in keys}}
    del flush
    took = time.perf_counter() - t13
    print(f"[13] phase 13 took {took:.1f} s")
    if took > 150:
        raise RuntimeError(f"phase 13 took {took:.1f} s (bound 150 s)")
    return records


def _states_bytes(pos_before, pos_after, csr, n_genes) -> int:
    """The bytes one advance of these walkers needs to move through device
    memory, each once, from the run's own positions before and after it:
    a walker's cur, pos and rng read (16 B) and its path prefix
    (``4 * pos_before``), its new entries written (``4 * (pos_after -
    pos_before)``) with cur, pos, rng and status (17 B); the CSR and the
    avail mask read."""
    pos_before = pos_before.astype(np.int64)
    pos_after = pos_after.astype(np.int64)
    return int(16 * pos_before.size + 4 * pos_before.sum()
               + 4 * (pos_after - pos_before).sum() + 17 * pos_before.size
               + sum(a.nbytes for a in csr) + n_genes)


def _states_dev(torch, states):
    """A walk-state batch's four arrays as card tensors (rng as int64)."""
    return [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in (
        states.cur, states.rng.view(np.int64), states.pos, states.paths)]


def _time_states(torch, fn, pristine, work, flush, n=10):
    """(median, min, max) device ms of ``fn()`` advancing ``work`` from
    ``pristine`` (restored before each launch, outside the events), each
    launch after an L2 flush and behind a sleep kernel."""
    times = []
    for _ in range(n + 1):
        for w, p in zip(work, pristine):
            w.copy_(p)
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


def _hold_states(name, got, want, status, status_want):
    for field in ("cur", "rng", "pos", "paths"):
        if not np.array_equal(getattr(got, field), getattr(want, field)):
            raise RuntimeError(f"walk states {name}: {field} differs")
    if not np.array_equal(status, status_want):
        raise RuntimeError(f"walk states {name}: status differs")


def _walk_states_at_the_example(torch, dw, cfg):
    """Phase 14 (a): one group's walkers as walk states, advanced on the
    card over half the genes, then resumed over the other half and back
    until none is suspended; each advance against the C++ one and the
    plain version, bitwise, and the packed result against walk_shard's
    rows. Returns the kernel line's record."""
    import copy

    from g2vec_tpu_torch.ops.host_walker import (advance_walk_states,
                                                 pack_finished_paths,
                                                 plan_shards,
                                                 shard_walk_states,
                                                 walk_shard)

    g, csrs = _stage3_csr(cfg)
    csr, seed, length = csrs[0], cfg.seed << 1, cfg.lenPath
    plan = plan_shards(g, cfg.numRepetition, 2 * cfg.numRepetition * g,
                       len_path=length)
    if plan.n_shards != 1:
        raise RuntimeError(f"(a): the plan has {plan.n_shards} shards")
    first = np.zeros(g, np.uint8)
    first[:g // 2] = 1
    csr_dev = dw.upload_csr(csr, g, "cuda")
    states = shard_walk_states(plan, 0, seed=seed)
    pristine = copy.deepcopy(states)
    todo = np.arange(len(states))
    avail, advances, per_round = first, 0, []
    dw.reset_launch_counts()
    while todo.size:
        part = states.take(todo)
        native = copy.deepcopy(part)
        plain = _states_dev(torch, part)
        status = dw.advance_walk_states_device(part, csr_dev, g, avail,
                                               length)
        st_native = advance_walk_states(native, csr, g, avail, length,
                                        n_threads=8)
        st_plain = dw.walk_states_plain(
            csr_dev.indptr, csr_dev.indices, csr_dev.weights,
            torch.from_numpy(avail).cuda(), *plain, length).cpu().numpy()
        plain_host = copy.deepcopy(part)
        for field, t in zip(("cur", "rng", "pos", "paths"), plain):
            arr = t.cpu().numpy()
            getattr(plain_host, field)[:] = (arr.view(np.uint64)
                                             if field == "rng" else arr)
        _hold_states(f"advance {advances} (C++)", part, native, status,
                     st_native)
        _hold_states(f"advance {advances} (plain)", part, plain_host, status,
                     st_plain)
        if not advances:
            pos_first = part.pos.copy()
        for field in ("cur", "rng", "pos", "paths"):
            getattr(states, field)[todo] = getattr(part, field)
        per_round.append((int(todo.size), int(status.sum())))
        todo = todo[status == 1]
        avail = 1 - avail
        advances += 1
    launches = dw.device_walk_states.launches
    rows = pack_finished_paths(states.paths, g)
    want = walk_shard(None, None, None, g, plan, 0, seed=seed, csr=csr)
    if rows.tobytes() != want.tobytes():
        raise RuntimeError("(a): the resumed walks' rows are not "
                           "walk_shard's")
    print(f"    (a) group g at the example: {len(states)} walkers, len_path "
          f"{length}, G {g}, {len(csr[1])} edges; genes [0, {g // 2}) held "
          f"first, then the other half in turns: {advances} advances "
          f"(walkers, suspended) {per_round}; each advance's cur, rng, pos, "
          f"paths and status = the C++ advance's = the plain version's, "
          f"bitwise; the packed rows = walk_shard's; kernel launches "
          f"{launches}")
    if launches != advances:
        raise RuntimeError(f"(a): {launches} launches for {advances} "
                           f"advances")

    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    src = _states_dev(torch, pristine)
    work = [t.clone() for t in src]
    avail_t = torch.from_numpy(first).cuda()
    csr_args = (csr_dev.indptr, csr_dev.indices, csr_dev.weights, avail_t)
    rec = {}
    for key, fn in (("ms", lambda: dw.device_walk_states(
                        *csr_args, *work, length,
                        max_degree=csr_dev.max_degree)),
                    ("plain_ms", lambda: dw.walk_states_plain(
                        *csr_args, *work, length))):
        rec[key], lo, hi = _time_states(torch, fn, src, work, flush)
        rec[key + "_spread"] = [lo, hi]
    del flush
    group = dw.group_for(csr_dev.max_degree)
    print(f"    the states kernel: {group} lanes a walker (largest "
          f"out-degree {csr_dev.max_degree}), prefixes in `paths`")
    cpp = []
    for _ in range(5):
        part = copy.deepcopy(pristine)
        t0 = time.perf_counter()
        advance_walk_states(part, csr, g, first, length, n_threads=8)
        cpp.append((time.perf_counter() - t0) * 1e3)
    cpp.sort()
    nbytes = _states_bytes(pristine.pos, pos_first, csr, g)
    rec.update(cpp_ms=cpp[2], cpp_ms_spread=[cpp[0], cpp[-1]],
               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
               bound_bytes=nbytes)
    print(f"    the first advance: kernel {_spread((rec['ms'], *rec['ms_spread']))}"
          f", plain {_spread((rec['plain_ms'], *rec['plain_ms_spread']))}, "
          f"C++ advance (8 host threads, median of 5) {rec['cpp_ms']:.4f} ms "
          f"[{cpp[0]:.4f}, {cpp[-1]:.4f}]; byte bound {rec['bound_ms']:.6f} "
          f"ms ({nbytes} bytes: {len(pristine)} walkers from {int(pristine.pos.sum())} "
          f"to {int(pos_first.sum())} path entries in all)")
    return {"name": "device_walk_states", "route": "cuda",
            "source": "g2vec_tpu_torch/csrc/device_walker.cu",
            "replaces": dw.REPLACES_STATES, "launches": launches,
            "max_abs_err": 0, "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": "bytes",
            "bound_bytes": nbytes, "library_ms": None, "cpp_ms": rec["cpp_ms"],
            "shape": f"{len(pristine)} walkers, len_path {length}, G {g} "
                     f"(group g), first advance over genes [0, {g // 2})",
            "advances": advances, "group": group}


def _edge_phase(torch, dw, cfg, tmp):
    """Phase 14: the resumable walk kernel at the example, and the edge
    partition at the scale-out spec on two ranks sharing the card, with
    its drill. Returns the kernel line's ``device_walk_states`` record."""
    from g2vec_tpu_torch.data.synth import (SynthGraphSpec,
                                            write_synth_graph_streamed)
    from g2vec_tpu_torch.io.readers import FORBID_FULL_NETWORK_ENV

    t14 = time.perf_counter()
    rec = _walk_states_at_the_example(torch, dw, cfg)
    print(f"    (a) took {time.perf_counter() - t14:.1f} s")

    spec = SynthGraphSpec(n_genes=262_144, n_good=8, n_poor=8, seed=5)
    (part, flat), secs = _timed(lambda: (
        write_synth_graph_streamed(spec, os.path.join(tmp, "edge"),
                                   prefix="edge", partitions=2),
        write_synth_graph_streamed(spec, os.path.join(tmp, "flat"),
                                   prefix="flat")))
    print(f"    inputs (write_synth_graph_streamed, G 262144, 8 + 8 samples, "
          f"seed 5): {part['n_edges']} edges in 2 parts and the flat file "
          f"({secs:.1f} s to write both)")
    b_flags = ["-p", "12", "-r", "2", "-s", "256", "-e", "2",
               "--stream-patience", "2", "--train-mode", "streaming",
               "--walk-starts", "2048", "--shard-paths", "256",
               "--stream-eval-rows", "256"]
    fleet = b_flags + ["--distributed", "--graph-shards", "2",
                       "--embed-shards", "2"]
    pin = {FORBID_FULL_NETWORK_ENV: "1"}
    runs = {}
    t_b = time.perf_counter()
    for name, files, flags, n, env in (
            ("handoff", part, fleet + ["--edge-partition", "handoff",
                                       "--fleet-watchdog-deadline", "300"],
             2, pin),
            ("halo", part, fleet + ["--edge-partition", "halo",
                                    "--fleet-watchdog-deadline", "300"],
             2, pin),
            ("plain", flat, b_flags, 1, None),
            ("off", flat, fleet + ["--fleet-watchdog-deadline", "300"], 2,
             None),
            ("drill", part, fleet + [
                "--edge-partition", "handoff",
                "--fleet-watchdog-deadline", "15", "--fault-plan",
                "process=1,stage=walk_handoff,kind=sigkill"], 2, pin)):
        reports = os.path.join(tmp, f"edge_{name}_reports")
        os.makedirs(reports)
        out = os.path.join(tmp, f"edge_{name}")
        runs[name] = (_start_ranks(files, out, flags, reports, n,
                                   _free_port(), extra_env=env),
                      out, reports)
    done = {name: _wait_ranks(procs, out) for name, (procs, out, _)
            in runs.items()}
    print(f"    (b, c) the two partitioned runs, the same two ranks "
          f"unpartitioned, the plain run and the drill took "
          f"{time.perf_counter() - t_b:.1f} s together")
    for name in ("handoff", "halo", "off", "plain"):
        rcs, logs = done[name]
        if any(rcs):
            raise RuntimeError(f"(b) {name}: exit codes {rcs}:\n"
                               + "\n".join(log[-3000:] for log in logs))
    plain, = _rank_reports(runs["plain"][2])
    fleets = {m: _rank_reports(runs[m][2])
              for m in ("handoff", "halo", "off")}
    outputs = {}
    for mode, ranks in fleets.items():
        if [r["rank"] for r in ranks] != [0, 1]:
            raise RuntimeError(f"(b) {mode}: rank reports {ranks}")
        if ranks[1]["output_files"] or len(ranks[0]["output_files"]) != 3:
            raise RuntimeError(f"(b) {mode}: output files "
                               f"{ranks[0]['output_files']} and "
                               f"{ranks[1]['output_files']}")
        outputs[mode] = []
        for path in ranks[0]["output_files"]:
            with open(path, "rb") as f:
                outputs[mode].append(f.read())
        for key in ("biomarkers", "acc_val", "n_paths"):
            if ranks[0][key] != ranks[1][key]:
                raise RuntimeError(f"(b) {mode}: the ranks' {key} differ")
    if outputs["handoff"] != outputs["halo"]:
        raise RuntimeError("(b): handoff and halo wrote other bytes")
    if outputs["handoff"] != outputs["off"]:
        raise RuntimeError("(b): handoff wrote other bytes than the same "
                           "two ranks unpartitioned")
    h0 = fleets["handoff"][0]
    for mode in ("halo", "off"):
        if (fleets[mode][0]["acc_val"], fleets[mode][0]["n_paths"]) != \
                (h0["acc_val"], h0["n_paths"]):
            raise RuntimeError(f"(b): handoff and {mode} differ in acc_val "
                               f"or n_paths")
    acc_gap, overlap = _band_of(h0["acc_val"], h0["biomarkers"],
                                plain["acc_val"], plain["biomarkers"])
    # The plain run's two whole-graph CSRs, as its trainer built them.
    plain_edges = sum(e for e, _ in plain["csrs"])
    plain_csr = sum(b for _, b in plain["csrs"])
    if len(plain["csrs"]) != 2:
        raise RuntimeError(f"(b): the plain run built CSRs {plain['csrs']}")
    print(f"    (b) G 262144, hidden 256, -p 12 -r 2, --walk-starts 2048, "
          f"--shard-paths 256, bf16, --graph-shards 2 --embed-shards 2: "
          f"handoff and halo under {FORBID_FULL_NETWORK_ENV}=1 wrote the "
          f"same bytes as the same two ranks unpartitioned on the flat "
          f"file, val acc {h0['acc_val']:.4f}, {h0['n_paths']} paths, rank "
          f"0 alone wrote; the plain run on the flat file val acc "
          f"{plain['acc_val']:.4f}, {plain['n_paths']} paths; |dACC| "
          f"{acc_gap:.4f} (band 0.20), top-N overlap {overlap:.3f} (floor "
          f"0.6); the plain run's CSRs {plain_edges} edges, {plain_csr} "
          f"bytes (measured)")
    for r in fleets["off"]:
        if r["csrs"] != plain["csrs"]:
            raise RuntimeError(f"(b) off rank {r['rank']}: CSRs {r['csrs']}, "
                               f"the plain run's {plain['csrs']}")
    for mode in ("handoff", "halo"):
        ranks = fleets[mode]
        owned = sum(r["edge_events"]["edge_partition"]["owned_edges"]
                    for r in ranks)
        if owned != plain_edges:
            raise RuntimeError(f"(b) {mode}: the ranks own {owned} edges, "
                               f"the plain run's CSRs hold {plain_edges}")
        for r in ranks:
            ev = r["edge_events"]
            e = {**ev["edge_partition"], **ev.get("halo", {}),
                 **ev["handoff"]}
            if r["csrs"]:
                raise RuntimeError(f"(b) {mode} rank {r['rank']} built a "
                                   f"whole-graph CSR: {r['csrs']}")
            print(f"    {mode} rank {r['rank']}: genes [{e['gene_lo']}, "
                  f"{e['gene_hi']}), csr_bytes {e['csr_bytes']}, "
                  f"owned_edges {e['owned_edges']}, halo edges "
                  f"{e.get('halo_edges', 0)}, overhead_ratio "
                  f"{e.get('overhead_ratio', 0.0):.4f}; handoff rounds "
                  f"{e['rounds']}, states_sent {e['states_sent']}, batches "
                  f"{e['batches']}, peak_in_flight {e['peak_in_flight']} "
                  f"over {e['shards']} shard-groups; launches fwd "
                  f"{r['packed_matmul_fwd']}, bwd {r['packed_matmul_bwd']}; "
                  f"stage seconds " + json.dumps(
                      {k: round(v, 3) for k, v in r["stage_seconds"].items()}))
            if not e["csr_bytes"] < plain_csr:
                raise RuntimeError(f"(b) {mode} rank {r['rank']}: "
                                   f"{e['csr_bytes']} CSR bytes, the plain "
                                   f"run {plain_csr}")
            if not (r["packed_matmul_fwd"] and r["packed_matmul_bwd"]):
                raise RuntimeError(f"(b) {mode} rank {r['rank']}: "
                                   f"launches {r}")
    for name, r in (("off rank 0", fleets["off"][0]),
                    ("off rank 1", fleets["off"][1]), ("plain", plain)):
        print(f"    {name}: launches fwd {r['packed_matmul_fwd']}, bwd "
              f"{r['packed_matmul_bwd']}; stage seconds " + json.dumps(
                  {k: round(v, 3) for k, v in r["stage_seconds"].items()}))
    if acc_gap > 0.20 or overlap < 0.6:
        raise RuntimeError("(b): the partitioned runs left the band of the "
                           "plain run")
    rcs, logs = done["drill"]
    if rcs[1] != -9 or rcs[0] == 0 or "PeerTimeoutError" not in logs[0] \
            or "missing rank(s): [1]" not in logs[0]:
        raise RuntimeError(f"(c): exit codes {rcs}:\n{logs[0][-3000:]}")
    print(f"    (c) --fault-plan process=1,stage=walk_handoff,kind=sigkill, "
          f"--fleet-watchdog-deadline 15: rank 1 killed by signal 9, rank 0 "
          f"exit {rcs[0]}: " + next(ln for ln in logs[0].splitlines()
                                     if "missing rank(s): [1]" in ln).strip())
    rec["edge_partition"] = {
        mode: {f"rank{r['rank']}": {
            **{k: v for ev in r["edge_events"].values()
               for k, v in ev.items()}, "launches": {
                k: r[k] for k in ("packed_matmul_fwd", "packed_matmul_bwd")}}
            for r in fleets[mode]} for mode in ("handoff", "halo")}
    rec["edge_partition"]["plain_csr"] = {"edges": plain_edges,
                                          "bytes": plain_csr}
    took = time.perf_counter() - t14
    print(f"[14] phase 14 took {took:.1f} s")
    if took > 150:
        raise RuntimeError(f"phase 14 took {took:.1f} s (bound 150 s)")
    return rec


# A rank of phase 15's supervised fleet: started by the launcher as its
# ``sys.executable`` (a shell wrapper running this file with the launcher's
# ``-m g2vec_tpu_torch ...``). It records when a fault plan entry fires
# (before the fault acts), and at exit its rank, the packed kernels'
# launches and its peak device memory (a SIGKILLed rank, or one that exits
# through its failure path, records nothing at exit).
_FLEET_CHILD = r"""
import atexit, json, os, runpy, sys, time
sys.argv = ["g2vec_tpu_torch", *sys.argv[3:]]     # drop "-m g2vec_tpu_torch"
from g2vec_tpu_torch.resilience import faults
reports = os.environ["G2V_SMOKE_REPORTS"]
rank = int(os.environ.get("G2VEC_PROCESS_ID", "0"))
nproc = int(os.environ.get("G2VEC_NUM_PROCESSES", "1"))
_fire = faults._fire


def fire(entry, seam, epoch, path):
    with open(os.path.join(reports, f"fired.{os.getpid()}.json"), "w") as f:
        json.dump({"rank": rank, "seam": seam, "epoch": epoch,
                   "t": time.time()}, f)
    return _fire(entry, seam, epoch, path)


faults._fire = fire


def report():
    import torch
    from g2vec_tpu_torch.ops import packed_matmul as pm

    with open(os.path.join(reports, f"{os.getpid()}.json"), "w") as f:
        json.dump({"rank": rank, "ranks": nproc,
                   "packed_matmul_fwd": pm.packed_matmul_fwd.launches,
                   "packed_matmul_bwd": pm.packed_matmul_bwd.launches,
                   "max_memory_allocated": torch.cuda.max_memory_allocated(),
                   "t": time.time()}, f)


atexit.register(report)
runpy.run_module("g2vec_tpu_torch", run_name="__main__")
"""


def _ckpt_state(torch, result):
    """A trainer state at phase 3's shapes, on the card: params, Adam's
    count and moments, and the snapshot."""
    w_ih = torch.as_tensor(result.embeddings, device="cuda")
    w_ho = torch.randn(w_ih.shape[1], 1, device="cuda")
    p = [w_ih, w_ho]
    return p, (30, [x * 0.5 for x in p], [x * x for x in p]), p


def _save_times(torch, ck, result, tmp):
    """One sharded save's and one single save's host milliseconds (median
    of 5 each, in turns) and bytes on disk, at phase 3's state."""
    p, opt, snap = _ckpt_state(torch, result)
    times = {"single": [], "sharded": []}
    for i in range(5):
        for layout in ("single", "sharded"):
            d = os.path.join(tmp, f"p15_save_{layout}")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = ck.save_state(d, p, opt, snap, i, 0.5, 0.6,
                                 layout=layout)
            times[layout].append((time.perf_counter() - t0) * 1e3)
    sizes = {"single": os.path.getsize(os.path.join(
        tmp, "p15_save_single", ck.CKPT_NAME))}
    sizes["sharded"] = sum(
        os.path.getsize(os.path.join(root, n))
        for root, _, names in os.walk(path) for n in names)
    return {k: (float(np.median(v)), sizes[k]) for k, v in times.items()}


def _fleet_phase(torch, pm, ck, files, tmp, result, main_outputs,
                 main_launches):
    """Phase 15: the fleet at the example (hidden 128, bf16, epoch cap
    30). Returns the kernel line's ``fleet`` entries of the two packed
    kernels."""
    t15 = time.perf_counter()
    kernels = ("packed_matmul_fwd", "packed_matmul_bwd")
    root = os.path.dirname(os.path.abspath(__file__))

    # (a) --distributed --mesh 2x1 on two ranks sharing the card.
    reports = os.path.join(tmp, "p15_mesh_reports")
    os.makedirs(reports)
    out = os.path.join(tmp, "p15_mesh")
    t_a = time.perf_counter()
    rcs, logs = _wait_ranks(_start_ranks(
        files, out, ["-e", "30", "--distributed", "--mesh", "2x1"], reports,
        2, _free_port()), out)
    wall_a = time.perf_counter() - t_a
    if any(rcs):
        raise RuntimeError(f"(a): exit codes {rcs}:\n"
                           + "\n".join(log[-3000:] for log in logs))
    ranks = _rank_reports(reports)
    outputs = []
    for path in ranks[0]["output_files"]:
        with open(path, "rb") as f:
            outputs.append(f.read())
    if outputs != main_outputs or ranks[1]["output_files"]:
        raise RuntimeError("(a): the mesh run's files differ from phase 3's "
                           "(or rank 1 wrote)")
    print(f"    (a) --distributed --mesh 2x1, two ranks on the card "
          f"({wall_a:.1f} s wall): rank 0 wrote phase 3's three files byte "
          f"for byte; phase 3's launches {main_launches}")
    for r in ranks:
        print(f"    rank {r['rank']}: max_memory_allocated "
              f"{r['max_memory_allocated']} bytes; launches fwd "
              f"{r['packed_matmul_fwd']}, bwd {r['packed_matmul_bwd']}; "
              f"stage seconds " + json.dumps(
                  {k: round(v, 3) for k, v in r["stage_seconds"].items()}))
        # Fused eval is off under a mesh: a forward launch for the val rows.
        if r["packed_matmul_fwd"] != 2 * main_launches["packed_matmul_fwd"] \
                or r["packed_matmul_bwd"] != \
                main_launches["packed_matmul_bwd"]:
            raise RuntimeError(f"(a): rank {r['rank']} launched {r}, want "
                               f"twice phase 3's forwards and its "
                               f"backwards")
    records = {k: {"mesh_launches": {f"rank{r['rank']}": r[k]
                                     for r in ranks}} for k in kernels}

    # (b) --fleet-size 2 with a SIGKILL of rank 1 at checkpoint_finalize.
    # At the default rate the example stops at epoch 0; at -l 0.0002 it
    # trains 16 epochs, so a kill at epoch 5 leaves the resumed rank
    # epochs to train. Its unfaulted run: in process, the same flags.
    b_cfg = _config(files, tmp, "cuda", epoch=30, learningRate=0.0002)
    b_cfg.result_name += "_lr"
    pm.reset_launch_counts()
    b_solo, _ = _run_pipeline(b_cfg)
    b_launches = {k: getattr(pm, k).launches for k in kernels}
    b_outputs = _outputs(b_solo)
    print(f"    (b)'s unfaulted run (-l 0.0002, in process): "
          f"{len(b_solo.train_history)} epochs, stop epoch "
          f"{b_solo.stop_epoch}, launches {b_launches}")
    saves = _save_times(torch, ck, result, tmp)
    print("    one save at phase 3's state (w_ih [%d, %d] f32, Adam, "
          "snapshot), median of 5 host ms: single %.3f ms (%d bytes), "
          "sharded %.3f ms (%d bytes)" % (
              *result.embeddings.shape, saves["single"][0],
              saves["single"][1], saves["sharded"][0], saves["sharded"][1]))
    reports = os.path.join(tmp, "p15_fleet_reports")
    os.makedirs(reports)
    child = os.path.join(reports, "child.py")
    with open(child, "w") as f:
        f.write(_FLEET_CHILD)
    wrapper = os.path.join(reports, "python-child")
    with open(wrapper, "w") as f:
        # The ranks (-m g2vec_tpu_torch) through the recorder; anything
        # else the launcher runs (its card-count probe) as it is.
        f.write(f'#!/bin/sh\nif [ "$1" = "-m" ]; then exec '
                f'"{sys.executable}" "{child}" "$@"; fi\n'
                f'exec "{sys.executable}" "$@"\n')
    os.chmod(wrapper, 0o755)
    out = os.path.join(tmp, "p15_fleet")
    metrics = out + ".jsonl"
    env = dict(os.environ, PYTHONPATH=root, G2V_SMOKE_REPORTS=reports)
    for name in ("G2VEC_COORDINATOR", "G2VEC_PROCESS_ID",
                 "G2VEC_NUM_PROCESSES", "G2VEC_FAULT_PLAN",
                 "G2VEC_FAULT_STATE"):
        env.pop(name, None)
    t_b = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", _SUPERVISOR, wrapper, files["expression"],
         files["clinical"], files["network"], out, "-e", "30", "-l",
         "0.0002", "--fleet-size", "2", "--checkpoint-dir", out + "_ckpt",
         "--checkpoint-layout", "sharded", "--checkpoint-every", "3",
         "--fleet-watchdog-deadline", "5", "--fleet-liveness-dir",
         out + "_live", "--metrics-jsonl", metrics, "--supervise-backoff",
         "0", "--fault-plan",
         "process=1,stage=checkpoint_finalize,epoch=5,kind=sigkill"],
        capture_output=True, text=True, env=env, cwd=root, timeout=300)
    wall_b = time.perf_counter() - t_b
    if proc.returncode != 0:
        raise RuntimeError(f"(b): the fleet exited {proc.returncode}:\n"
                           f"{proc.stderr[-3000:]}")
    events = _read_metrics(metrics)
    fleet_events = [e for e in events if e["event"].startswith("fleet_")]
    names = [e["event"] for e in fleet_events]
    for name in ("fleet_peer_death", "fleet_replan", "fleet_launch",
                 "fleet_done"):
        if name not in names:
            raise RuntimeError(f"(b): no {name} in {names}")
    replan = fleet_events[names.index("fleet_replan")]
    death = fleet_events[names.index("fleet_peer_death")]
    if (replan["old_mesh"], replan["new_mesh"]) != ([2, 1], [1, 1]) \
            or death["dead_ranks"] != [1]:
        raise RuntimeError(f"(b): {death} {replan}")
    outputs = []
    for path in events[[e["event"] for e in events].index("done")][
            "outputs"]:
        with open(path, "rb") as f:
            outputs.append(f.read())
    if outputs != b_outputs:
        raise RuntimeError("(b): the fleet's files differ from its "
                           "unfaulted run's")
    fired = []
    for name in os.listdir(reports):
        if name.startswith("fired."):
            with open(os.path.join(reports, name)) as f:
                fired.append(json.load(f))
    if len(fired) != 1 or fired[0]["rank"] != 1:
        raise RuntimeError(f"(b): fired {fired}")
    done = fleet_events[names.index("fleet_done")]
    resumed = [json.load(open(os.path.join(reports, n)))
               for n in os.listdir(reports)
               if n.endswith(".json") and not n.startswith("fired.")]
    if len(resumed) != 1 or resumed[0]["ranks"] != 1 or not (
            resumed[0]["packed_matmul_fwd"]
            and resumed[0]["packed_matmul_bwd"]):
        raise RuntimeError(f"(b): reports of the ranks that exited "
                           f"normally: {resumed}")
    for e in fleet_events:
        print("    " + json.dumps({k: v for k, v in e.items()
                                   if k not in ("seq", "ts")}))
    print(f"    (b) --fleet-size 2 --checkpoint-layout sharded, rank 1 "
          f"SIGKILLed at checkpoint_finalize epoch {fired[0]['epoch']} "
          f"({wall_b:.1f} s wall): kill to fleet_done "
          f"{done['ts'] - fired[0]['t']:.2f} s, kill to fleet_peer_death "
          f"{death['ts'] - fired[0]['t']:.2f} s; the unfaulted run's three "
          f"files byte for byte; the resumed rank launched fwd "
          f"{resumed[0]['packed_matmul_fwd']}, bwd "
          f"{resumed[0]['packed_matmul_bwd']}, max_memory_allocated "
          f"{resumed[0]['max_memory_allocated']} bytes")
    for k in kernels:
        records[k]["resumed_launches"] = resumed[0][k]

    # (c) A rank SIGKILLed mid-stage under the watchdog.
    reports = os.path.join(tmp, "p15_drill_reports")
    os.makedirs(reports)
    out = os.path.join(tmp, "p15_drill")
    live = out + "_live"
    procs = _start_ranks(files, out, [
        "-e", "30", "--distributed", "--mesh", "2x1",
        "--fleet-watchdog-deadline", "5", "--fleet-liveness-dir", live,
        "--fleet-heartbeat-interval", "0.1"], reports, 2, _free_port())
    from g2vec_tpu_torch.resilience.fleet import read_liveness

    t_end = time.monotonic() + 120
    phase = None
    while time.monotonic() < t_end and procs[1].poll() is None:
        rec = read_liveness(live, 1)
        phase = rec and rec.get("phase")
        if phase in ("paths", "train", "lgroups", "biomarkers", "save"):
            break
        time.sleep(0.02)
    if procs[1].poll() is not None:
        raise RuntimeError(f"(c): rank 1 exited {procs[1].returncode} "
                           f"before the kill")
    procs[1].kill()
    t_kill = time.perf_counter()
    procs[0].wait(timeout=120)
    to_exit = time.perf_counter() - t_kill
    rcs, logs = _wait_ranks(procs, out)
    line = next((ln for ln in logs[0].splitlines()
                 if "PeerTimeoutError" in ln and "missing rank(s): [1]" in ln),
                None)
    if rcs[1] != -9 or rcs[0] != 1 or line is None \
            or "rank 1: heartbeat" not in line or "phase=" not in line \
            or "last collective=" not in line:
        raise RuntimeError(f"(c): exit codes {rcs}:\n{logs[0][-3000:]}")
    print(f"    (c) --fleet-watchdog-deadline 5: rank 1 SIGKILLed in phase "
          f"{phase!r}; rank 0 exited {rcs[0]} {to_exit:.2f} s after the "
          f"kill: " + line.strip())
    took = time.perf_counter() - t15
    print(f"[15] phase 15 took {took:.1f} s")
    if took > 150:
        raise RuntimeError(f"phase 15 took {took:.1f} s (bound 150 s)")
    records["packed_matmul_fwd"]["save_ms"] = {
        k: round(v[0], 3) for k, v in saves.items()}
    return records


def _planner_record(pm, direction, sweep, planner, entries) -> dict:
    """The kernel line's ``planner`` entry of one direction: each
    candidate's time at the full-batch shape (the forward's layouts from
    ``csrc/packed_matmul_tiles.cu``, with their launches in phase 16
    (c)'s first tuned run), the planner's choice there, and the fastest
    candidate against the library at phase 16 (b)'s shapes."""
    times = sweep[direction]
    rec = {"full_batch_ms": {("_".join(map(str, k)) if direction == "fwd"
                              else f"S{k}"): round(t[0], 4)
                             for k, t in times.items()},
           "entries": {str(m): e[direction] for m, e in entries.items()
                       if direction in e},
           "small_shapes": {label: {
               "fastest": ("_".join(map(str, r[f"best_{direction}"]))
                           if direction == "fwd"
                           else f"S{r['best_bwd']}"),
               "ms": round(r[direction][r[f"best_{direction}"]][0], 4),
               "library_ms": round(r[f"library_{direction}"], 4)}
               for label, r in planner["small"].items()}}
    if direction == "fwd":
        rec["source"] = "g2vec_tpu_torch/csrc/packed_matmul_tiles.cu"
        rec["tuned_launches"] = planner["cli_launches"]
    return rec


#: Phase 16 (b): launch shapes where the forward loses to the library
#: (PERF.md, section 6): the example's widest streaming shard and its eval
#: buffer, phase 13 (a)'s widest G 20,000 shard, and phase 13 (b)'s split
#: rank (rank 0 of 2 at G 262,144, hidden 256).
SMALL_SHAPES = (("(b) streaming shard", 2205, 5850, 128),
                ("(b) eval buffer", 4096, 5850, 128),
                ("(b) G 20,000 shard", 1818, 20000, 128),
                ("(b) split rank", 182, 131072, 256))


def _rank_w_ih(reports, rank):
    """The embeddings a rank of ``_start_ranks`` kept
    (``G2V_SMOKE_KEEP_W_IH``)."""
    for name in os.listdir(reports):
        if name.endswith(".json"):
            with open(os.path.join(reports, name)) as f:
                if json.load(f)["rank"] == rank:
                    return np.load(os.path.join(reports,
                                                name[:-5] + "_w_ih.npy"))
    raise RuntimeError(f"rank {rank} kept no embeddings")


def _held_to_phase3(pm, what, bwd_rows, s, w_ih, outputs, result,
                    main_outputs):
    """Hold a tuned run against phase 3's untuned one. Every forward
    layout is bitwise the shipped one, so where the run's backward S at
    ``bwd_rows`` is the heuristic's its three files are phase 3's byte
    for byte (the vectors file's six decimals hold W_ih to under 1e-6);
    else W_ih is within 1e-4 of phase 3's (tests/test_torch_cuda.py's
    bound for the card against the CPU; a step moves a weight by up to
    the learning rate, 50 times that). Returns the line that says which
    held."""
    n_genes = result.embeddings.shape[0]
    heur = pm._bwd_slices(bwd_rows, n_genes, 128, pm._sm_count(0)).n_slices
    gap = float(np.abs(w_ih - result.embeddings).max())
    if s == heur:
        if outputs != main_outputs:
            raise RuntimeError(f"{what}: S={s} is the heuristic's, yet the "
                               f"run's files differ from phase 3's (W_ih "
                               f"max |gap| {gap:.3e})")
        return (f"S={s} at M={bwd_rows} is the heuristic's: phase 3's three "
                f"files byte for byte, W_ih max |gap| {gap:.3e}")
    if gap > 1e-4:
        raise RuntimeError(f"{what}: W_ih {gap:.3e} from phase 3's under "
                           f"S={s} (heuristic {heur}; atol 1e-4)")
    return (f"S={s} at M={bwd_rows} against the heuristic's {heur}: W_ih "
            f"max |gap| to phase 3's {gap:.3e} (atol 1e-4)")


def _bwd_plan(plans):
    """(rows, S) of the one backward shape in a run's tile plans."""
    ((rows, s),) = [(int(m), p["bwd"]) for m, p in plans.items()
                    if "bwd" in p]
    return rows, s


def _planner_phase(torch, pm, files, tmp, result, main_outputs,
                   cli_train_s):
    """Phase 16: the tile planner. (b) the sweep at SMALL_SHAPES, measured
    only; (c) two CLI runs with ``--kernel-autotune --cache-dir D``: the
    first sweeps, the second loads the plan and writes the first's bytes,
    both held against phase 3 (:func:`_held_to_phase3`) and above 0.5 val
    accuracy, then a run in process under a plan installed by hand (a
    forward layout that is not the shipped one, an S off the heuristic's)
    held the same way; (d) a ``--mesh 2x1 --kernel-autotune`` run: both
    ranks launch rank 0's plan, only rank 0 sweeps and writes, and its
    files and W_ih are held against phase 3. Returns the kernel line's
    ``planner`` entries."""
    from g2vec_tpu_torch.cache import autotune_cache_path

    t16 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(16)
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    small = {}
    for label, m, g, h in SMALL_SHAPES:
        packed = _random_packed(torch, m, g, 80 / g, gen)
        small[label] = _planner_sweep(torch, pm, packed, m, g, h, gen, flush,
                                      label)
        del packed
    del flush
    print(f"    (b) took {time.perf_counter() - t16:.1f} s")

    # (c) two CLI runs sharing one cache root, through the rank wrapper
    # (the CLI's own entry point in a fresh interpreter) for its report.
    cache = os.path.join(tmp, "p16_cache")
    tune_file = autotune_cache_path(cache)
    runs = []
    for i in range(2):
        out = os.path.join(tmp, f"p16_cli{i}")
        reports = os.path.join(tmp, f"p16_cli{i}_reports")
        os.makedirs(reports)
        rcs, logs = _wait_ranks(_start_ranks(
            files, out, ["-e", "30", "--kernel-autotune", "--cache-dir",
                         cache], reports, 1,
            extra_env={"G2V_SMOKE_KEEP_W_IH": "1"}), out, timeout=300)
        if rcs[0]:
            raise RuntimeError(f"(c) run {i + 1} exited {rcs[0]}:\n"
                               f"{logs[0][-3000:]}")
        (rep,) = _rank_reports(reports)
        w_ih = np.load(next(os.path.join(reports, n) for n in
                            os.listdir(reports) if n.endswith("_w_ih.npy")))
        outputs = []
        for path in rep["output_files"]:
            with open(path, "rb") as f:
                outputs.append(f.read())
        with open(tune_file, "rb") as f:
            runs.append((rep, outputs, f.read(), w_ih))
    (first, out1, file1, w1), (second, out2, file2, w2) = runs
    for i, (rep, *_rest) in enumerate(runs):
        plans = rep["stage_extras"]["train"]["autotune"]
        print(f"    (c) CLI run {i + 1} --kernel-autotune --cache-dir: "
              f"autotune events {rep['autotune_events']}, plans "
              f"{json.dumps(plans['plans'])}; launches fwd "
              f"{rep['packed_matmul_fwd']} (tuned layouts "
              f"{rep['fwd_layout_launches']}), bwd "
              f"{rep['packed_matmul_bwd']}; val acc {rep['acc_val']:.4f}; "
              f"stage train {rep['stage_seconds']['train']:.3f} s (phase "
              f"3's CLI run {cli_train_s:.3f} s)")
        if not rep["acc_val"] > 0.5:
            raise RuntimeError(f"(c) run {i + 1}: val accuracy "
                               f"{rep['acc_val']} <= 0.5")
    if first["autotune_events"] != {"miss": 2, "sweep": 2} \
            or second["autotune_events"] != {"hit": 2}:
        raise RuntimeError("(c): the first run did not sweep both shapes, "
                           "or the second did not load both")
    if out2 != out1 or file2 != file1 or first["tuned"] != second["tuned"] \
            or w2.tobytes() != w1.tobytes():
        raise RuntimeError("(c): the second run's files, W_ih, plan or "
                           "record differ from the first's")
    plans = first["stage_extras"]["train"]["autotune"]["plans"]
    bwd_rows, s_tuned = _bwd_plan(plans)
    held = _held_to_phase3(pm, "(c)", bwd_rows, s_tuned, w1, out1, result,
                           main_outputs)
    print(f"    (c) the second run loaded the plan, launched it and wrote "
          f"the first run's three files and W_ih and left the record "
          f"({len(file1)} bytes) as it was; against phase 3's untuned "
          f"run: {held}")

    # A plan the sweep did not choose, installed by hand, in process: the
    # fused forward on (2, 2, 64, 4) and the backward at an S off the
    # heuristic's.
    (fwd_rows,) = [int(m) for m, p in plans.items() if "fwd" in p]
    n_genes = result.embeddings.shape[0]
    heur = pm._bwd_slices(bwd_rows, n_genes, 128, pm._sm_count(0)).n_slices
    s_hand = max(s for s in pm.tile_candidates(bwd_rows, n_genes, 128)["bwd"]
                 if s != heur and s <= 2 * heur)
    tag = pm._autotune_backend_tag("cuda")
    pm.reset_tuned()
    pm._install_tuned(fwd_rows, n_genes, 128, {"fwd": (2, 2, 64, 4)}, tag)
    pm._install_tuned(bwd_rows, n_genes, 128, {"bwd": s_hand}, tag)
    out = os.path.join(tmp, "p16_hand")
    os.makedirs(out)
    pm.reset_launch_counts()
    try:
        hand, _ = _run_pipeline(_config(files, out, "cuda", epoch=30))
        fwd_n = pm.packed_matmul_fwd.launches
        layouts = dict(pm.packed_matmul_fwd.layout_launches)
    finally:
        pm.reset_tuned()
    if layouts != {(2, 2, 64, 4): fwd_n} or fwd_n < 1:
        raise RuntimeError(f"(c) hand plan: forward launches {fwd_n}, by "
                           f"layout {layouts}")
    held = _held_to_phase3(pm, "(c) hand plan", bwd_rows, s_hand,
                           hand.embeddings, _outputs(hand), result,
                           main_outputs)
    print(f"    (c) in process under a plan installed by hand, the forward "
          f"on (2, 2, 64, 4) ({fwd_n} launches) and {held}")

    # (d) a mesh over two ranks sharing the card.
    cache = os.path.join(tmp, "p16_mesh_cache")
    reports = os.path.join(tmp, "p16_mesh_reports")
    os.makedirs(reports)
    out = os.path.join(tmp, "p16_mesh")
    rcs, logs = _wait_ranks(_start_ranks(
        files, out, ["-e", "30", "--distributed", "--mesh", "2x1",
                     "--kernel-autotune", "--cache-dir", cache], reports, 2,
        _free_port(), extra_env={"G2V_SMOKE_KEEP_W_IH": "1"}), out)
    if any(rcs):
        raise RuntimeError(f"(d): exit codes {rcs}:\n"
                           + "\n".join(log[-3000:] for log in logs))
    ranks = _rank_reports(reports)
    for r in ranks:
        print(f"    (d) --mesh 2x1 --kernel-autotune, rank {r['rank']}: "
              f"autotune events {r['autotune_events']}, plans "
              f"{r['tuned']}; launches fwd {r['packed_matmul_fwd']} (tuned "
              f"layouts {r['fwd_layout_launches']}), bwd "
              f"{r['packed_matmul_bwd']}")
    sources = {p["source"] for p in ranks[1]["stage_extras"]["train"]
               ["autotune"]["plans"].values()}
    if not ranks[0]["tuned"] or ranks[0]["tuned"] != ranks[1]["tuned"] \
            or ranks[0]["fwd_layout_launches"] != \
            ranks[1]["fwd_layout_launches"] \
            or ranks[0]["autotune_events"] != {"miss": 2, "sweep": 2} \
            or ranks[1]["autotune_events"] != {} \
            or sources != {"broadcast"} \
            or not os.path.exists(autotune_cache_path(cache)):
        raise RuntimeError("(d): the ranks did not launch rank 0's plan, "
                           "or a rank other than 0 swept or wrote")
    outputs = []
    for path in ranks[0]["output_files"]:
        with open(path, "rb") as f:
            outputs.append(f.read())
    held = _held_to_phase3(
        pm, "(d)", *_bwd_plan(ranks[0]["stage_extras"]["train"]["autotune"]
                              ["plans"]),
        _rank_w_ih(reports, 0), outputs, result, main_outputs)
    print(f"    (d) both ranks installed and launched rank 0's plan; rank 1 "
          f"swept, loaded and wrote nothing (its plans came by broadcast); "
          f"rank 0 against phase 3's untuned run: {held}")
    took = time.perf_counter() - t16
    print(f"[16] phase 16 took {took:.1f} s")
    if took > 150:
        raise RuntimeError(f"phase 16 took {took:.1f} s (bound 150 s)")
    return {"small": small, "cli_launches": first["fwd_layout_launches"],
            "cli_plans": first["tuned"]}


ANALYZE_CHECKERS = ["lock-discipline", "torch-purity", "fault-seams",
                    "metrics-schema", "config-doc-drift", "epoch-stamp"]


def _analyze_phase() -> None:
    """Phase 17: ``python -m g2vec_tpu_torch analyze --json`` in a fresh
    interpreter from the checkout this script runs in. It must exit 0
    with the six checkers run, no finding and no stale baseline entry,
    import neither torch nor triton, and finish within 30 s."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "g2vec_tpu_torch",
         "analyze", "--json"], capture_output=True, text=True, timeout=60,
        cwd=root, env=env)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"analyze exited {proc.returncode}: "
                           f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    report = json.loads(proc.stdout)
    imported = [line.rsplit("|", 1)[-1].strip()
                for line in proc.stderr.splitlines()
                if line.startswith("import time:")]
    heavy = sorted(m for m in imported
                   if m.split(".")[0] in ("torch", "triton"))
    print(f"    rc 0 in {secs:.2f} s (the suite's own {report['elapsed_s']} "
          f"s); checkers {report['checkers']}; counts "
          f"{json.dumps(report['counts'])}; {len(imported)} modules "
          f"imported, torch/triton among them: {heavy}")
    if report["checkers"] != ANALYZE_CHECKERS or not report["clean"] \
            or report["counts"]["active"] or \
            report["counts"]["stale_baseline"]:
        raise RuntimeError(f"analyze did not come back clean with the six "
                           f"checkers: {json.dumps(report)[:2000]}")
    if heavy or not imported:
        raise RuntimeError(f"analyze imported {heavy} (of {len(imported)} "
                           f"modules)")
    if secs > 30:
        raise RuntimeError(f"phase 17 took {secs:.1f} s (bound 30 s)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    # Outside a checkout this import fails and the script exits nonzero.
    from g2vec_tpu_torch.data.synthetic import (SCALES, SyntheticSpec,
                                                write_synthetic_tsv)
    from g2vec_tpu_torch.native.walker_bindings import build_walker
    from g2vec_tpu_torch.ops import device_walker as dw
    from g2vec_tpu_torch.ops import packed_matmul as pm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = _nvidia_smi()
    print(f"[1] card: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    # One build a source, all started together.
    with ThreadPoolExecutor(4) as pool:
        builds = [pool.submit(_timed, fn) for fn in
                  (pm.build_kernels, dw.build_walk_kernel, build_walker,
                   pm.build_tile_kernels)]
        ((so, log), secs), ((walk_so, walk_log), walk_secs), \
            (_, walker_secs), ((tiles_so, tiles_log), tiles_secs) = [
                f.result() for f in builds]
    print(f"[2] built at once: kernels in {secs:.1f} s ({so}), the walker "
          f"kernel in {walk_secs:.1f} s ({walk_so}), the C++ walker in "
          f"{walker_secs:.1f} s, the planner's tiles library (the forward "
          f"under {len(pm.FWD_LAYOUTS)} layouts) in {tiles_secs:.1f} s "
          f"({tiles_so})")
    kernel = "?"
    for line in (log + walk_log).splitlines():
        if "Compiling entry function" in line:
            kernel = _ptxas_kernel(line)
        elif "registers" in line or "spill" in line:
            print(f"    ptxas {kernel}: {line.split(' : ')[-1].strip()}")
    from g2vec_tpu_torch.ops.packed_matmul_probe import ptxas_report
    tiles_ptxas = ptxas_report(tiles_log)
    for layout in pm.FWD_LAYOUTS:
        print(f"    ptxas forward layout {layout}: "
              f"{tiles_ptxas.get(layout, '?')}")

    with tempfile.TemporaryDirectory() as tmp:
        print("[3] example-scale solo run on cuda (hidden 128, -p 80 -r 10, "
              "epoch cap 30; overlap and the native reader on, metrics "
              "stream)")
        files = write_synthetic_tsv(SCALES["example"], tmp, prefix="example")
        cfg = _config(files, tmp, "cuda", epoch=30,
                      metrics_jsonl=os.path.join(tmp, "run_cuda.jsonl"))
        with warnings.catch_warnings():
            warnings.filterwarnings("error", "native TSV reader unavailable")
            pm.reset_launch_counts()
            result, lines = _run_pipeline(cfg)
            launches = {"packed_matmul_fwd": pm.packed_matmul_fwd.launches,
                        "packed_matmul_bwd": pm.packed_matmul_bwd.launches}
        for line in lines:
            if line.startswith("    n_") or "Epoch" in line \
                    or "[overlap]" in line:
                print(line)
        epochs = len(result.train_history)
        print(f"    epochs run {epochs}, stop epoch {result.stop_epoch}, "
              f"val acc {result.acc_val:.4f}; launches {launches}")
        print("    stage seconds: " + json.dumps(
            {k: round(v, 3) for k, v in result.stage_seconds.items()})
            + "; overlap saved: " + json.dumps(result.overlap_saved_s))
        for kind in ("expression", "network"):
            parser = result.stage_extras["load"][kind + "_parser"]
            if parser != "native":
                raise RuntimeError(f"stage 1 read the {kind} file with the "
                                   f"{parser} parser, not the native one")
        _check_metrics(cfg.metrics_jsonl, result)
        print("    the metrics stream's done record holds these stage "
              "seconds; the expression and network files were read by the "
              "native parsers")
        with open(result.output_files[0], "rb") as f:
            main_outputs = [f.read()]
        for path in result.output_files[1:]:
            with open(path, "rb") as f:
                main_outputs.append(f.read())
        for flags, secs, saved, extras, outputs, _ in _cli_runs(
                files, tmp, 30, flag_sets=([],)):
            cli_train_s = secs["train"]
            spans = {stage: {k: round(v, 3) for k, v in e["span_s"].items()}
                     for stage, e in extras.items() if "span_s" in e}
            print(f"    CLI {' '.join(flags) or '(defaults)'}: stage seconds "
                  + json.dumps({k: round(v, 3) for k, v in secs.items()})
                  + f" (total {sum(secs.values()):.3f}); overlap saved "
                  + json.dumps(saved) + "; parser "
                  + extras["load"]["expression_parser"] + "; spans "
                  + json.dumps(spans))
            if outputs != main_outputs:
                raise RuntimeError(f"CLI {flags}: output files differ from "
                                   f"the in-process run's")
        import dataclasses
        for flags, overrides, want_parser in (
                ("--no-overlap", {"overlap": False}, "native"),
                ("--no-overlap --no-native-io",
                 {"overlap": False, "use_native_io": False}, "python")):
            seq, _ = _run_pipeline(dataclasses.replace(
                cfg, metrics_jsonl=None, **overrides,
                result_name=os.path.join(tmp, "run_" + "_".join(overrides))))
            parsers = {seq.stage_extras["load"][k + "_parser"]
                       for k in ("expression", "network")}
            print(f"    in process {flags}: stage seconds "
                  + json.dumps({k: round(v, 3)
                                for k, v in seq.stage_seconds.items()})
                  + f" (total {sum(seq.stage_seconds.values()):.3f}); "
                  f"overlap saved {json.dumps(seq.overlap_saved_s)}; "
                  f"parsers {sorted(parsers)}")
            if parsers != {want_parser}:
                raise RuntimeError(f"{flags}: stage 1 read the input files "
                                   f"with the {sorted(parsers)} parsers")
            outputs = []
            for path in seq.output_files:
                with open(path, "rb") as f:
                    outputs.append(f.read())
            if outputs != main_outputs:
                raise RuntimeError(f"in process {flags}: output files "
                                   f"differ from the defaults' run's")
        print("    the three output files are byte-identical across the "
              "in-process runs (defaults, --no-overlap, --no-overlap "
              "--no-native-io) and the CLI run")
        prof_dir = os.path.join(tmp, "profile")
        prof_run = _cli_runs(files, tmp, 30, tag="prof",
                             flag_sets=(["--profile-dir", prof_dir],))[0]
        if prof_run[4] != main_outputs:
            raise RuntimeError("the --profile-dir run's files differ")
        by_name, idle, window_ms = _trace_breakdown(
            os.path.join(prof_dir, "trace.json"), "stage:train")
        print(f"    CLI --profile-dir (torch.profiler, CPU + CUDA; same "
              f"bytes): stage train {window_ms:.3f} ms, device idle share "
              f"over it {idle:.4f}; CUDA time by kernel (ms, count): "
              + json.dumps({k: [round(ms, 4), n]
                            for k, (ms, n) in by_name.items()}))
        print(f"    edge keep decisions differing between cuda and cpu "
              f"|PCC|: {_edge_flips(cfg)}")
        for name, n in launches.items():
            if n < epochs or n == 0:
                raise RuntimeError(f"{name} launched {n} times in {epochs} "
                                   f"epochs of the main path")
        headers = ["GeneSymbol",
                   "GeneSymbol\tLgroup(0:good,1:poor,2:other)",
                   "GeneSymbol\t" + "\t".join(f"V{i}" for i in range(128))]
        for path, header in zip(result.output_files, headers):
            with open(path) as f:
                if f.readline().rstrip("\n") != header:
                    raise RuntimeError(f"{path}: wrong header")
        if not (result.acc_val > 0.5):
            raise RuntimeError(f"val accuracy {result.acc_val} <= 0.5")
        n_genes = result.n_genes
        if result.embeddings.shape != (n_genes, 128) or \
                not np.isfinite(result.embeddings).all():
            raise RuntimeError("embeddings are not finite [G, 128]")

        packed_all, n_tr = _train_val_rows(torch, cfg, result)
        print(f"[4] kernels vs plain on that run's rows ([train | val] rows "
              f"{packed_all.shape[0]}, train rows {n_tr}, genes {n_genes}, "
              f"hidden 128)")
        gen = torch.Generator(device="cuda").manual_seed(0)
        flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8,
                            device="cuda")
        n_sms = torch.cuda.get_device_properties(0).multi_processor_count
        plan = pm._bwd_slices(n_tr, n_genes, 128, n_sms)
        print(f"    backward split: S={plan.n_slices} slices of "
              f"{plan.rows} rows on {n_sms} SMs, workspace "
              f"{plan.workspace_bytes} bytes; dense tensor-core ceiling "
              f"{2 * n_tr * n_genes * 128 / BF16_TC_OPS_PER_S * 1e3:.4f} ms "
              f"(2*M*G*H = {2 * n_tr * n_genes * 128:.3e} bf16 operations)")
        print("    " + _forward_plan_line(pm, packed_all.shape[0], n_genes,
                                          128, n_sms))
        records = _compare_kernels(torch, pm, packed_all, n_tr, n_genes, 128,
                                   gen, flush, timed=True)
        print("    the tile planner (--kernel-autotune) at the full-batch "
              "shapes:")
        sweep = _planner_sweep(torch, pm, packed_all, n_tr, n_genes, 128,
                               gen, flush, "(a) full batch")
        tuned_entries = _planner_entries(pm, packed_all.shape[0], n_tr,
                                         n_genes, tmp)
        _at_reference_genes(torch, pm, packed_all.shape[0], n_tr, 128, gen,
                            flush)
        ragged = _random_packed(torch, 1001, 1003, 0.02, gen)
        print("    ragged shape:")
        _compare_kernels(torch, pm, ragged, 777, 1003, 132, gen, flush,
                         timed=False)
        print("    forward edges:")
        _forward_edges(torch, pm, gen, n_genes)
        print("    backward edges:")
        _backward_edges(torch, pm, gen, n_genes)
        del flush, packed_all, ragged

        print("[5] small input at hidden 10: the same solo run on cuda "
              "(kernels) and on cpu (plain versions)")
        small = write_synthetic_tsv(SyntheticSpec(
            n_good=24, n_poor=20, module_size=12, n_background=24,
            n_expr_only=4, n_net_only=4, module_chords=2,
            background_edges=40, seed=7), tmp, prefix="small")
        args = dict(lenPath=20, numRepetition=3, sizeHiddenlayer=10,
                    epoch=30, numBiomarker=10, seed=11)
        r_gpu, _ = _run_pipeline(_config(small, tmp, "cuda", **args))
        r_cpu, _ = _run_pipeline(_config(small, tmp, "cpu", **args))
        acc_gap = max(abs(a["acc_val"] - b["acc_val"]) for a, b in
                      zip(r_gpu.train_history, r_cpu.train_history))
        emb_gap = float(np.abs(r_gpu.embeddings - r_cpu.embeddings).max())
        same_lg = float((r_gpu.lgroup_idx == r_cpu.lgroup_idx).mean())
        print(f"    n_paths {r_gpu.n_paths}/{r_cpu.n_paths}, epochs "
              f"{len(r_gpu.train_history)}/{len(r_cpu.train_history)}, "
              f"max |acc_val gap| {acc_gap:.4f}, max |embedding gap| "
              f"{emb_gap:.3e}, L-group agreement {same_lg:.4f}")
        if (r_gpu.n_paths != r_cpu.n_paths
                or len(r_gpu.train_history) != len(r_cpu.train_history)
                or acc_gap > 0.05 or emb_gap > 1e-3 or same_lg < 0.9):
            raise RuntimeError("cuda and cpu runs of the small input disagree")

        print("[6] example-scale streaming run on cuda (--train-mode "
              "streaming, hidden 128, bf16, epoch cap 30)")
        s_cfg = _config(files, tmp, "cuda", epoch=30, train_mode="streaming")
        s_cfg.result_name += "_stream"
        pm.reset_launch_counts()
        stream, _ = _run_pipeline(s_cfg)
        s_launches = {"packed_matmul_fwd": pm.packed_matmul_fwd.launches,
                      "packed_matmul_bwd": pm.packed_matmul_bwd.launches}
        st = stream.stream_stats
        s_epochs = len(stream.train_history)
        shards = st["n_shards"]
        print(f"    {shards} shards an epoch of {st['shard_rows']} rows, "
              f"{s_epochs} epochs, stop epoch {stream.stop_epoch}, val acc "
              f"{stream.acc_val:.4f}, n_paths {stream.n_paths}; launches "
              f"{s_launches}, per epoch " + json.dumps(
                  {k: v / s_epochs for k, v in s_launches.items()}))
        print("    stage seconds: " + json.dumps(
            {k: round(v, 3) for k, v in stream.stage_seconds.items()})
            + "; stream stats: " + json.dumps(st))
        # Each epoch: one step a shard that kept rows (the same shards in
        # every epoch), forward and backward, and the two evals' forwards.
        steps, rest = divmod(s_launches["packed_matmul_bwd"], s_epochs)
        if rest or not 1 <= steps <= shards or \
                s_launches["packed_matmul_fwd"] != s_epochs * (steps + 2):
            raise RuntimeError(f"the streaming run launched {s_launches} in "
                               f"{s_epochs} epochs of {shards} shards")
        print(f"    {steps} of {shards} shards kept rows (a shard whose "
              f"rows all start at genes with no kept edge walks the same "
              f"one-gene path in both groups, and the filter drops them)")
        acc_gap, overlap_bm = _parity(result, stream)
        print(f"    against [3]'s full-batch run: |val acc gap| "
              f"{acc_gap:.4f} (band 0.20); top-N biomarker overlap "
              f"{overlap_bm:.3f}, L-group sizes {_lgroup_sizes(result)} "
              f"(full-batch, stopped after {len(result.train_history) - 1} "
              f"update(s)) and {_lgroup_sizes(stream)} (streaming)")
        if not (stream.acc_val > 0.5) or acc_gap > 0.20:
            raise RuntimeError("the streaming run's val accuracy left the "
                               "parity band")
        if stream.embeddings.shape != (n_genes, 128) or \
                not np.isfinite(stream.embeddings).all():
            raise RuntimeError("streaming embeddings are not finite [G, 128]")
        again_cfg = _config(files, tmp, "cuda", epoch=30,
                            train_mode="streaming", prefetch_depth=1,
                            sampler_threads=1)
        again_cfg.result_name += "_stream1"
        again, _ = _run_pipeline(again_cfg)
        if again.embeddings.tobytes() != stream.embeddings.tobytes():
            raise RuntimeError("streaming at prefetch depth 1 and one "
                               "sampler thread gave other embeddings")
        print("    prefetch_depth=1, sampler_threads=1: byte-identical "
              "embeddings")
        f32_cfg = _config(files, tmp, "cuda", epoch=30,
                          train_mode="streaming", compute_dtype="float32")
        f32_cfg.result_name += "_stream_f32"
        f32, _ = _run_pipeline(f32_cfg)
        print(f"    streaming at float32 (dense torch.matmul, no kernels): "
              f"top-N biomarker overlap with bf16 "
              f"{len(set(f32.biomarkers) & set(stream.biomarkers)) / len(stream.biomarkers):.3f}, "
              f"L-group agreement "
              f"{float((f32.lgroup_idx == stream.lgroup_idx).mean()):.3f}")

        print("    the parity band (tests/test_stream.py's) on the medium "
              "scale, full-batch against streaming, on cuda:")
        med = write_synthetic_tsv(SCALES["medium"], tmp, prefix="medium")
        pair = []
        for mode in ("full", "streaming"):
            m_cfg = _config(med, tmp, "cuda", epoch=30, train_mode=mode)
            m_cfg.result_name += f"_medium_{mode}"
            pair.append(_run_pipeline(m_cfg)[0])
        cpu_pair = []
        for mode in ("full", "streaming"):
            m_cfg = _config(med, tmp, "cpu", epoch=30, train_mode=mode)
            m_cfg.result_name += f"_medium_{mode}"
            cpu_pair.append(_run_pipeline(m_cfg)[0])
        emb_gap = float(np.abs(pair[1].embeddings
                               - cpu_pair[1].embeddings).max())
        print(f"    medium on the CPU (plain versions): top-N biomarker "
              f"overlap {_parity(*cpu_pair)[1]:.3f}; streaming cuda against "
              f"cpu: max |embedding gap| {emb_gap:.3e}, val acc "
              f"{pair[1].acc_val:.4f} and {cpu_pair[1].acc_val:.4f}")
        acc_gap, overlap_bm = _parity(*pair)
        print(f"    medium: val acc {pair[0].acc_val:.4f} (full) and "
              f"{pair[1].acc_val:.4f} (streaming), gap {acc_gap:.4f} (band "
              f"0.20); top-N biomarker overlap {overlap_bm:.3f} (floor 0.6); "
              f"L-group sizes {_lgroup_sizes(pair[0])} and "
              f"{_lgroup_sizes(pair[1])}")
        if acc_gap > 0.20 or overlap_bm < 0.6:
            raise RuntimeError("the medium streaming run left the parity "
                               "band")

        print("    kernels at the streaming launch shapes:")
        shard_rows, train_rows, val_rows, plan = _stream_shapes(torch, s_cfg)
        if len(train_rows) != steps:
            raise RuntimeError(f"{len(train_rows)} shards keep rows, the run "
                               f"stepped {steps} times an epoch")
        flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8,
                            device="cuda")
        m_tr, m_val = shard_rows.shape[0], val_rows.shape[0]
        print(f"    train rows of the {steps} steps of an epoch: "
              f"{sorted(train_rows)} (of {plan.rows_per_shard} walked a "
              f"shard); timed at the widest, M={m_tr}; val buffer "
              f"M={m_val}; rows {shard_rows.shape[1]} bytes")
        for m in (m_tr, m_val):
            print(f"    M={m}: " + _forward_plan_line(pm, m, n_genes, 128,
                                                      n_sms))
        print(f"    M={m_tr}: " + _backward_plan_line(pm, m_tr, n_genes, 128,
                                                       n_sms))
        s_records = _compare_kernels(torch, pm, shard_rows, m_tr, n_genes,
                                     128, gen, flush, timed=True)
        s_records["eval_fwd"] = _compare_kernels(
            torch, pm, val_rows, m_val, n_genes, 128, gen, flush, timed=True,
            names=("packed_matmul_fwd",))["packed_matmul_fwd"]
        del flush

        print("[7] the device walker: the kernel against its plain version "
              "and the C++ walker, byte for byte; timed at the example; "
              "the CLI, streaming, the device feed and the walk cache with "
              "it")
        stream_dev_outputs, walk_rec = _device_walker_phase(
            torch, dw, pm, cfg, s_cfg, files, tmp, main_outputs, launches,
            stream, s_launches)

        print("[8] durable runs: checkpoint/resume, fault plans and the "
              "supervisor (example, hidden 128, bf16, epoch cap 30; the "
              "small input at hidden 10)")
        durable = _durable_phase(torch, dw, pm, files, small, args, tmp,
                                 main_outputs, stream, stream_dev_outputs,
                                 smi)
        print("    " + json.dumps({"durable": durable}))

        print("[9] lanes: the batch engine (--seeds/--manifest, the lane "
              "kernels, stages 5-6 over the lanes, ResidentEngine) at the "
              "example, hidden 128, bf16, epoch cap 30")
        t9 = time.perf_counter()
        lane_records, lane_bytes = _lanes_phase(torch, pm, result, cfg,
                                                files, tmp, smi)
        print(f"    phase 9 took {time.perf_counter() - t9:.1f} s")

        print("[10] serve: the daemon on the card (python -m "
              "g2vec_tpu_torch serve): admission, two tenants' jobs joined "
              "into one lane batch, a warm job, the query plane, drain and "
              "journal recovery under --supervise")
        t10 = time.perf_counter()
        served = _serve_phase(files, small, args, tmp, lane_bytes, smi)
        print(f"[10] phase 10 took {time.perf_counter() - t10:.1f} s")

        print("[11] the router: python -m g2vec_tpu_torch serve "
              "--replicas 2 on the card; a joined routed batch, a "
              "SIGKILLed replica failed over, an exact query through the "
              "router")
        fleet_numbers = _router_phase(files, small, args, tmp, lane_bytes,
                                      served["stream_solo"], smi)
        print("    " + json.dumps({"router": {
            k: round(v, 3) for k, v in fleet_numbers.items()}}))

        print("[12] scenarios and incremental updates at the example "
              "(hidden 128, bf16, epoch cap 30): --scenario bootstrap|"
              "permutation|cv on the lanes; the update op on a card daemon")
        t12 = time.perf_counter()
        scenarios = _scenario_runs(pm, files, tmp)
        update_walls, update_launches, _ = _update_drills(torch, pm, files,
                                                          tmp)
        _band_on_the_test_spec(tmp)
        took = time.perf_counter() - t12
        print(f"[12] phase 12 took {took:.1f} s")
        if took > 150:
            raise RuntimeError(f"phase 12 took {took:.1f} s (bound 150 s)")

        print("[13] scale: a TCGA-width synthetic graph streamed on one "
              "rank with --walk-starts; the scale-out spec plain and on "
              "two ranks sharing the card (--distributed --graph-shards 2 "
              "--embed-shards 2); a SIGKILL drill; the split step's "
              "kernels (bf16)")
        scale = _scale_phase(torch, pm, tmp)

        print("[14] the edge partition: the resumable walk kernel at the "
              "example against the C++ advance and its plain version; "
              "--edge-partition handoff|halo at the scale-out spec on two "
              "ranks sharing the card, against a plain run; a SIGKILL "
              "drill at walk_handoff")
        states_rec = _edge_phase(torch, dw, cfg, tmp)

        print("[15] the fleet at the example (hidden 128, bf16, epoch cap "
              "30): --distributed --mesh 2x1 on two ranks sharing the card; "
              "--fleet-size 2 --checkpoint-layout sharded losing rank 1 at "
              "checkpoint_finalize; a rank SIGKILLed mid-stage under "
              "--fleet-watchdog-deadline")
        from g2vec_tpu_torch.train import checkpoint as ck

        fleet = _fleet_phase(torch, pm, ck, files, tmp, result, main_outputs,
                             launches)

        print("[16] the tile planner (--kernel-autotune) at the example "
              "(hidden 128, bf16, epoch cap 30): the sweep at the shapes "
              "where the forward loses to the library; two CLI runs sharing "
              "a --cache-dir; --mesh 2x1 on two ranks sharing the card")
        planner = _planner_phase(torch, pm, files, tmp, result, main_outputs,
                                 cli_train_s)

        print("[17] the static-analysis suite: python -m g2vec_tpu_torch "
              "analyze --json in a fresh interpreter from this checkout")
        _analyze_phase()

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    kernels = []
    for name, rec in records.items():
        streaming = {"launches": s_launches[name],
                     "shard": {"m": m_tr, **{k: s_records[name][k]
                                             for k in keys}}}
        if name == "packed_matmul_fwd":
            streaming["eval_buffer"] = {
                "m": m_val, **{k: s_records["eval_fwd"][k] for k in keys}}
        direction = "fwd" if name == "packed_matmul_fwd" else "bwd"
        kernels.append({
            "name": name, "route": "cuda",
            "source": "g2vec_tpu_torch/csrc/packed_matmul.cu",
            "replaces": pm.REPLACES[name], "launches": launches[name],
            **{k: rec[k] for k in keys}, "streaming": streaming,
            "update_launches": {mode: n[name] for mode, n in
                                update_launches.items()},
            "scale": scale[name], "fleet": fleet[name],
            "planner": _planner_record(pm, direction, sweep, planner,
                                       tuned_entries)})
    kernels.append(walk_rec)
    kernels.append(states_rec)
    for name, rec in lane_records.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": "g2vec_tpu_torch/csrc/packed_matmul.cu",
            "replaces": pm.REPLACES[name], "launches": rec["launches"],
            **{k: rec[k] for k in keys}, "lanes": 8,
            "solo_ms": rec["solo_ms"],
            "served_launches": served["joined"][name],
            "scenario_launches": {kind: run[2][name] for kind, run in
                                  scenarios.items()}})
    print(f"    total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
