"""Edited copies of the packed-matmul forward kernel, timed beside it.

The forward (``pm_fwd_kernel`` in ``csrc/packed_matmul.cu``) is built
under one layout. This module builds copies of that source with one thing
changed, loads each as a library of its own and launches it through the
wrapper's own path (``packed_matmul._fwd_on_card``):

- :data:`LAYOUTS`: the forward under other warp layouts and rings, made by
  setting the .cu's ``kFwdWarpsN``, ``kFwdGenes`` and ``kFwdStages`` to
  other values. Each computes the same function, so each is held against
  the plain version; ``chip_smoke.py`` times them beside the shipped one.
- :data:`STRIPPED`: the forward without one part of its work, made by
  editing its body. Their outputs are meaningless; their times show what
  bounds the kernel.

Run on a machine with an NVIDIA Hopper card, from the repository root:

    python -m g2vec_tpu_torch.ops.packed_matmul_probe

At the example run's forward shape (G 5,850 x H 128) it times every
layout at the fused ``[train | val]`` row count (40,399) and at one and
two full waves of blocks, and every stripped copy of every layout at
40,399 rows, in two rounds of opposite order. It prints the card's name
and power limit first. The copies are built in parallel.
"""
from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from g2vec_tpu_torch.native._build import build
from g2vec_tpu_torch.ops import packed_matmul as pm

#: The .cu constexprs a layout sets: warps along a block's 128 columns,
#: genes a ring stage, ring stages.
LAYOUT_KEYS = ("kFwdWarpsN", "kFwdGenes", "kFwdStages")
#: The layouts timed side by side, the shipped one among them. Each keeps
#: two 128-row blocks resident on an SM (at most 110.6 KB of ring each).
LAYOUTS = [(2, 64, 4), (1, 64, 4), (1, 128, 2), (1, 128, 3), (2, 128, 2),
           (2, 128, 3)]

#: Copies of the forward without one part of its work: (pattern,
#: replacement) edits of its body.
STRIPPED = {
    "A constant (no bit unpacking)": [
        (r"(a\[j\]\[\d\]) = bits_to_bf16x2\([^;]*\);", r"\1 = 0x3F803F80u;")],
    "no ring refills (stages stay stale)": [
        (r"if \(next < n_steps\) load_stage\(next, next % kFwdStages\);", "")],
    "B constant (no ldmatrix)": [
        (r"ldmatrix_x4_trans\(\s*b, w_s[^;]*\);",
         "b[0] = b[1] = b[2] = b[3] = 0x3F803F80u;")],
    "no MMAs (A and B still consumed)": [
        (r"mma_16816\(acc\[j\]\[(n(?: \+ 1)?)\], a\[j\], "
         r"b\[(\d)\], b\[(\d)\]\);",
         r"acc[j][\1][0] += __uint_as_float(a[j][0] ^ a[j][1] ^ a[j][2] ^ "
         r"a[j][3] ^ b[\2] ^ b[\3]);")],
}

N_TIMED = 10
GENES, HIDDEN, ROWS = 5850, 128, 40399


def source() -> str:
    with open(pm.SRC) as f:
        return f.read()


def layout_of(src: str) -> tuple:
    """The layout ``src`` is written for."""
    return tuple(int(re.search(rf"^constexpr int {k} = (\d+);", src, re.M)
                     .group(1)) for k in LAYOUT_KEYS)


def layout_name(layout: tuple) -> str:
    warps_n, genes, stages = layout
    return (f"{warps_n} warp{'s' if warps_n > 1 else ''} along the columns, "
            f"{stages} stages of {genes} genes")


def with_layout(src: str, layout: tuple) -> str:
    for key, value in zip(LAYOUT_KEYS, layout):
        src, n = re.subn(rf"^constexpr int {key} = \d+;",
                         f"constexpr int {key} = {value};", src, flags=re.M)
        if n != 1:
            raise RuntimeError(f"{key} is not one constexpr of the source")
    return src


def stripped(src: str, edits) -> str:
    start = src.index("pm_fwd_kernel(const")
    end = src.index("pm_bwd_kernel(const")
    body = src[start:end]
    for pattern, repl in edits:
        body, n = re.subn(pattern, repl, body)
        if n == 0:
            raise RuntimeError(f"{pattern} matches nothing in the forward")
    return src[:start] + body + src[end:]


def ptxas_report(log: str) -> str:
    """The forward's register and spill lines of a build's ptxas report."""
    out, inside = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            inside = "pm_fwd_kernel" in line
        elif inside and ("registers" in line or "spill" in line):
            out.append(line.split(" : ")[-1].strip())
    return "; ".join(out)


def build_all(sources: dict) -> dict:
    """``{name: (library, ptxas report)}``, each source built in parallel."""
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for i, (name, text) in enumerate(sources.items()):
            paths[name] = os.path.join(tmp, f"packed_matmul_copy{i}.cu")
            with open(paths[name], "w") as f:
                f.write(text)
        with ThreadPoolExecutor(min(len(paths), os.cpu_count() or 1)
                                ) as pool:
            built = dict(zip(paths, pool.map(
                lambda p: build(p, pm.nvcc_command()), paths.values())))
    libs = {}
    for name, (so, log) in built.items():
        lib = ctypes.CDLL(so)
        pm._configure(lib)
        libs[name] = (lib, ptxas_report(log))
    return libs


def time_ms(fn, flush, n=N_TIMED):
    """(median, min, max) device time of ``fn`` over ``n`` launches, each
    timed with CUDA events after ``flush`` was written (the L2 starts
    cold) and behind a sleep kernel that keeps the card busy while the
    host enqueues ``fn``."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2], times[0], times[-1]


def spread(t) -> str:
    return f"{t[0]:.4f} ms [{t[1]:.4f}, {t[2]:.4f}]"


def random_packed(m: int, g: int, bits_per_row: float, seed: int):
    """``[m, ceil(g/8)]`` packed rows of random bits, about
    ``bits_per_row`` set, rows padded to the kernels' 4-byte stride."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    bits = torch.rand((m, g), device="cuda", generator=gen) < bits_per_row / g
    padded = torch.zeros((m, pm.padded_row_bytes(g) * 8), dtype=torch.uint8,
                         device="cuda")
    padded[:, :g] = bits
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8,
                           device="cuda")
    return (padded.view(m, -1, 8) * weights).sum(-1, dtype=torch.uint8)


def main() -> int:
    if not torch.cuda.is_available():
        print("packed_matmul_probe: torch sees no CUDA device",
              file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    src = source()
    shipped = layout_of(src)
    sources = {}
    for layout in LAYOUTS:
        text = with_layout(src, layout)
        sources[layout] = text
        for name, edits in STRIPPED.items():
            sources[(layout, name)] = stripped(text, edits)
    t0 = time.perf_counter()
    libs = build_all(sources)
    print(f"built {len(libs)} copies in {time.perf_counter() - t0:.1f} s")

    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    wave = pm.FWD_BLOCKS_PER_SM * n_sms * pm.FWD_BLOCK_ROWS
    row_counts = (ROWS, wave, 2 * wave)
    packed = random_packed(max(row_counts), GENES, 80, seed=0)
    w16 = (torch.randn((GENES, HIDDEN), device="cuda") * 0.09
           ).to(torch.bfloat16)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    want = pm.packed_matmul_fwd_plain(packed[:ROWS], w16)
    tol = 1e-5 * want.abs() + 256 * 2.0 ** -24 * (
        pm.unpack_bits(packed[:ROWS], GENES).float() @ w16.float().abs())
    for layout in LAYOUTS:
        lib, report = libs[layout]
        resident = pm.fwd_occupancy(lib)
        err = (pm._fwd_on_card(packed[:ROWS], w16, lib) - want).abs()
        bad = int((err > tol).sum())
        print(f"{layout_name(layout)}"
              f"{' (shipped)' if layout == shipped else ''}: ptxas {report}; "
              f"{resident} resident blocks an SM; max_abs_err "
              f"{float(err.max()):.3e}, violations {bad}")
        if bad or resident != pm.FWD_BLOCKS_PER_SM:
            raise RuntimeError(f"{layout_name(layout)} is not the forward "
                               f"the plan counts on")
    for rnd, order in enumerate((LAYOUTS, LAYOUTS[::-1])):
        print(f"round {rnd + 1}:")
        for layout in order:
            lib = libs[layout][0]
            cells = []
            for m in row_counts:
                grid = pm._fwd_grid(m, HIDDEN, n_sms)
                t = time_ms(lambda: pm._fwd_on_card(packed[:m], w16, lib),
                            flush)
                cells.append(f"M={m} ({grid.waves:.2f} waves) {spread(t)}")
            print(f"  {layout_name(layout)}: " + "; ".join(cells))
            for name in STRIPPED:
                lib = libs[(layout, name)][0]
                t = time_ms(lambda: pm._fwd_on_card(packed[:ROWS], w16, lib),
                            flush)
                print(f"    {name}: M={ROWS} {spread(t)}")
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
