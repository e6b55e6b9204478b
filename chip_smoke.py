#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (g2vec_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

It builds the port's kernels from the sources in this checkout, drives the
port's seven-stage solo run (``g2vec_tpu_torch.pipeline.run``) on the
example-scale synthetic dataset on ``cuda`` and checks what comes out,
then holds each kernel against its plain PyTorch version on the card on
the ``[train | val]`` rows that run produced (built by the trainer's own
helper, rows padded once to a multiple of 4 bytes) and times both. Phase
4 goes on with: the forward's grid, its waves, the bytes of W it streams
from L2 and its tensor-core ceiling beside the backward's split; the
forward beside the other layouts it was chosen from (built from copies of
its source with other constexprs) and the backward under several splits
of its rows, each held against the plain version and timed; both kernels
at the reference's 7,523 genes; one ragged shape; the ragged edges of
both kernels; and the forward's M-invariance, bitwise, across the edges
of a wave. Phase 5
runs a small input at hidden width 10 on ``cuda`` and on the CPU. Any
failure raises and the script exits nonzero without printing a result.
The last three lines of standard output are: one JSON object with a
record per kernel, the card's name and power limit as ``nvidia-smi``
reports them, and the result line ``{"ok": true, "device": {...}}``.
Without a CUDA device, or outside a checkout of the repository, it exits
nonzero at once.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

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


def _spread(t) -> str:
    return f"{t[0]:.4f} ms [{t[1]:.4f}, {t[2]:.4f}]"


def _check_close(torch, name, got, want, abs_sum) -> float:
    err = (got - want).abs()
    tol = RTOL * want.abs() + ULPS * 2.0 ** -24 * abs_sum
    bad = int((err > tol).sum())
    max_err = float(err.max()) if err.numel() else 0.0
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


def _compare_kernels(torch, pm, packed_all, n_tr, g, h, gen, flush, timed):
    """Each kernel against its plain version on these inputs; with
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

    out = pm.packed_matmul_fwd(packed_all, w)
    want = pm.packed_matmul_fwd_plain(packed_all, w)
    err = _check_close(torch, f"packed_matmul_fwd {tag}", out, want,
                       x_all @ w.float().abs())
    # M-invariance: the train rows' bits do not depend on the val rows.
    if not torch.equal(pm.packed_matmul_fwd(packed_tr, w), out[:n_tr]):
        raise RuntimeError("packed_matmul_fwd is not M-invariant")
    records["packed_matmul_fwd"] = {"max_abs_err": err}

    dw = pm.packed_matmul_bwd(packed_tr, g_out, g)
    want = pm.packed_matmul_bwd_plain(packed_tr, g_out, g)
    err = _check_close(torch, f"packed_matmul_bwd M={n_tr} G={g} H={h}", dw,
                       want, x_all[:n_tr].T @ g_out.float().abs())
    if not torch.equal(pm.packed_matmul_bwd(packed_tr, g_out, g), dw):
        raise RuntimeError("packed_matmul_bwd is not bitwise reproducible")
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
    for name, (kernel, plain, library, nbytes, n_ops) in cases.items():
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


def _backward_splits(torch, pm, packed, g, h, gen, flush):
    """The backward at the main path's shape under the slice counts that
    fill one, two and three waves of resident blocks, one slice past a
    wave, and no split, each held against the plain version and timed:
    the evidence for the planned count."""
    m = packed.shape[0]
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    g16 = torch.randn((m, h), device="cuda", generator=gen).to(torch.bfloat16)
    want = pm.packed_matmul_bwd_plain(packed, g16, g)
    abs_sum = pm.unpack_bits(packed, g).float().T @ g16.float().abs()
    planned = pm._bwd_slices(m, g, h, n_sms)
    tiles = -(-g // pm.BWD_BLOCK_GENES) * -(-h // pm.BWD_BLOCK_COLS)
    per_wave = pm.BWD_BLOCKS_PER_SM * n_sms // tiles
    for n in sorted({1, per_wave, per_wave + 1, 2 * per_wave + 1,
                     3 * per_wave + 2, planned.n_slices}):
        plan = pm._bwd_split(m, n, g, h)
        _check_close(torch, f"packed_matmul_bwd S={plan.n_slices}",
                     pm._bwd_on_card(packed, g16, g, plan), want, abs_sum)
        ms, lo, hi = _time_ms(lambda: pm._bwd_on_card(
            packed, g16, g, plan), flush)
        waves = plan.n_slices * tiles / (pm.BWD_BLOCKS_PER_SM * n_sms)
        print(f"    split S={plan.n_slices} ({waves:.2f} waves, "
              f"{plan.rows} rows a slice{', planned' if plan == planned else ''}"
              f"): {ms:.4f} ms [{lo:.4f}, {hi:.4f}]")


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


def _forward_layouts(torch, pm, packed, g, h, gen, flush):
    """The forward at the main path's shape beside the other layouts it
    was chosen from (``packed_matmul_probe.LAYOUTS``: warps along the
    columns and the ring, each built from a copy of the source with those
    constexprs changed), each held against the plain version and timed:
    the evidence for the shipped layout."""
    from g2vec_tpu_torch.ops import packed_matmul_probe as probe

    src = probe.source()
    shipped = probe.layout_of(src)
    libs = probe.build_all({layout: probe.with_layout(src, layout)
                            for layout in probe.LAYOUTS if layout != shipped})
    libs[shipped] = (None, "as built in [2]")
    m = packed.shape[0]
    w16 = (torch.randn((g, h), device="cuda", generator=gen) * 0.09
           ).to(torch.bfloat16)
    want = pm.packed_matmul_fwd_plain(packed, w16)
    abs_sum = pm.unpack_bits(packed, g).float() @ w16.float().abs()
    for layout in probe.LAYOUTS:
        lib, report = libs[layout]
        name = probe.layout_name(layout)
        _check_close(torch, f"packed_matmul_fwd M={m}, {name}",
                     pm._fwd_on_card(packed, w16, lib), want, abs_sum)
        t = _time_ms(lambda: pm._fwd_on_card(packed, w16, lib), flush)
        print(f"    M={m}, {name}{', shipped' if layout == shipped else ''} "
              f"({pm.fwd_occupancy(lib)} resident blocks an SM; ptxas "
              f"{report}): {_spread(t)}")


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    # Outside a checkout this import fails and the script exits nonzero.
    from g2vec_tpu_torch.data.synthetic import (SCALES, SyntheticSpec,
                                                write_synthetic_tsv)
    from g2vec_tpu_torch.native.walker_bindings import build_walker
    from g2vec_tpu_torch.ops import packed_matmul as pm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = _nvidia_smi()
    print(f"[1] card: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    (so, log), secs = _timed(pm.build_kernels)
    _, walker_secs = _timed(build_walker)
    print(f"[2] kernels built in {secs:.1f} s ({so}); walker built in "
          f"{walker_secs:.1f} s")
    kernel = "?"
    for line in log.splitlines():
        if "Compiling entry function" in line:
            kernel = next((w for w in ("pm_fwd_kernel", "pm_bwd_kernel",
                                       "pm_bwd_sum_kernel") if w in line),
                          line.split("'")[1] if "'" in line else "?")
        elif "registers" in line or "spill" in line:
            print(f"    ptxas {kernel}: {line.split(' : ')[-1].strip()}")

    with tempfile.TemporaryDirectory() as tmp:
        print("[3] example-scale solo run on cuda (hidden 128, -p 80 -r 10, "
              "epoch cap 30)")
        files = write_synthetic_tsv(SCALES["example"], tmp, prefix="example")
        cfg = _config(files, tmp, "cuda", epoch=30)
        pm.reset_launch_counts()
        result, lines = _run_pipeline(cfg)
        launches = {"packed_matmul_fwd": pm.packed_matmul_fwd.launches,
                    "packed_matmul_bwd": pm.packed_matmul_bwd.launches}
        for line in lines:
            if line.startswith("    n_") or "Epoch" in line:
                print(line)
        epochs = len(result.train_history)
        print(f"    epochs run {epochs}, stop epoch {result.stop_epoch}, "
              f"val acc {result.acc_val:.4f}; launches {launches}")
        print("    stage seconds: " + json.dumps(
            {k: round(v, 3) for k, v in result.stage_seconds.items()}))
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
        _forward_layouts(torch, pm, packed_all, n_genes, 128, gen, flush)
        _backward_splits(torch, pm, packed_all[:n_tr], n_genes, 128, gen,
                         flush)
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

    kernels = [{"name": name, "route": "cuda",
                "source": "g2vec_tpu_torch/csrc/packed_matmul.cu",
                "replaces": pm.REPLACES[name], "launches": launches[name],
                "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]}
               for name, rec in records.items()]
    print(f"    total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
