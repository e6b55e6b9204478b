"""Stripped copies of the packed-matmul forward, timed beside it.

The forward (``fwd_block`` in ``csrc/packed_matmul.cu``) is a template
over its layout; ``csrc/packed_matmul_tiles.cu`` builds it for every
candidate of the tile planner. The planner's sweep
(``packed_matmul.time_fwd_layouts``, and ``chip_smoke.py``'s phases 4 and
16) holds and times the layouts themselves. This module adds
:data:`STRIPPED`: the forward without one part of its work, made by
editing its body in a copy of the source and built as a copy of the tiles
library (every layout stripped alike). Their outputs are meaningless;
their times show what bounds the kernel.

Run on a machine with an NVIDIA Hopper card, from the repository root:

    python -m g2vec_tpu_torch.ops.packed_matmul_probe

At the example run's forward shape (the fused ``[train | val]`` 40,399
rows, G 5,850 x H 128) it times every layout through the planner's sweep,
and beside each the stripped copies of that layout. It prints the card's
name and power limit first. The copies are built in parallel.
"""
from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from g2vec_tpu_torch.native._build import build
from g2vec_tpu_torch.ops import packed_matmul as pm

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


def layout_name(layout: tuple) -> str:
    warps_m, warps_n, genes, stages = layout
    return (f"{32 * warps_m}-row blocks, {warps_n} "
            f"warp{'s' if warps_n > 1 else ''} along the columns, "
            f"{stages} stages of {genes} genes")


def stripped(src: str, edits) -> str:
    start = src.index("pm_fwd_kernel(const")
    end = src.index("pm_bwd_kernel(const")
    body = src[start:end]
    for pattern, repl in edits:
        body, n = re.subn(pattern, repl, body)
        if n == 0:
            raise RuntimeError(f"{pattern} matches nothing in the forward")
    return src[:start] + body + src[end:]


def layout_of_entry(line: str):
    """The layout of the tiles library's forward instance that a ptxas
    "Compiling entry function" line names, or None."""
    m = re.search(r"pm_fwd_layout_kernelI\w*?FwdLayoutILi(\d+)ELi(\d+)"
                  r"ELi(\d+)ELi(\d+)E", line)
    return tuple(int(v) for v in m.groups()) if m else None


def ptxas_report(log: str) -> dict:
    """``{layout: its register and spill lines}`` of a tiles build's
    ptxas report."""
    out, layout = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            layout = layout_of_entry(line)
        elif layout and ("registers" in line or "spill" in line):
            out.setdefault(layout, []).append(line.split(" : ")[-1].strip())
    return {k: "; ".join(v) for k, v in out.items()}


def build_stripped(names) -> dict:
    """``{name: (tiles library, ptxas report)}``: for each of ``names`` of
    :data:`STRIPPED`, the tiles library built from a copy of the sources
    whose forward body has that edit, all built in parallel."""
    src = source()
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for i, name in enumerate(names):
            d = os.path.join(tmp, f"copy{i}")
            os.makedirs(d)
            with open(os.path.join(d, os.path.basename(pm.SRC)), "w") as f:
                f.write(stripped(src, STRIPPED[name]))
            paths[name] = shutil.copy(pm.TILES_SRC, d)
        deps = {name: (os.path.join(os.path.dirname(p),
                                    os.path.basename(pm.SRC)),)
                for name, p in paths.items()}
        with ThreadPoolExecutor(min(len(paths), os.cpu_count() or 1)
                                ) as pool:
            built = dict(zip(paths, pool.map(
                lambda n: build(paths[n], pm.nvcc_command(), deps=deps[n]),
                paths)))
    libs = {}
    for name, (so, log) in built.items():
        lib = ctypes.CDLL(so)
        pm._configure_tiles(lib)
        libs[name] = (lib, ptxas_report(log))
    return libs


def time_ms(fn, flush, n=N_TIMED):
    """(median, min, max) device time of ``fn`` over ``n`` launches, each
    timed with CUDA events after ``flush`` was written (the L2 starts
    cold) and behind a sleep kernel that keeps the card busy while the
    host enqueues ``fn`` (``packed_matmul.median_ms``)."""
    return pm.median_ms(fn, n, flush)


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
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        tiles = pool.submit(pm.build_tile_kernels)
        copies = pool.submit(build_stripped, list(STRIPPED))
        _, log = tiles.result()
        libs = copies.result()
    reports = ptxas_report(log)
    print(f"built the tiles library and {len(libs)} stripped copies in "
          f"{time.perf_counter() - t0:.1f} s")

    packed = random_packed(ROWS, GENES, 80, seed=0)
    w16 = (torch.randn((GENES, HIDDEN), device="cuda") * 0.09
           ).to(torch.bfloat16)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    # Every layout bitwise the shipped one (time_fwd_layouts raises if not).
    full = pm.time_fwd_layouts(packed, w16, pm.FWD_LAYOUTS, N_TIMED, flush)
    for layout, t in full.items():
        print(f"{layout_name(layout)}"
              f"{' (shipped)' if layout == pm.FWD_SHIPPED else ''}: ptxas "
              f"{reports.get(layout, '?')}; M={ROWS} {spread(t)}")
        for name in STRIPPED:
            lib = libs[name][0]
            t = time_ms(lambda: pm._fwd_on_card(packed, w16, lib, layout),
                        flush)
            print(f"    {name}: {spread(t)}")
    print(smi)
    return 0

if __name__ == "__main__":
    sys.exit(main())
