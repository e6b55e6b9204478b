"""The trainer's product over a bit-packed 0/1 matrix, on Hopper kernels.

``packed_matmul(P, W)`` computes ``unpack(P) @ bf16(W)`` in f32, where P
is ``[M, ceil(G/8)]`` uint8 in np.packbits order (gene g is bit 7-(g&7) of
byte g>>3 — the order the walker writes). It replaces the two Pallas
kernels of ``g2vec_tpu/ops/packed_matmul.py``:

- forward ``packed_matmul_fwd``: ``out [M, H] f32 = unpack(P) @ bf16(W)``
  (``_fwd_call``/``_fwd_kernel``, pallas_call at :302);
- backward ``packed_matmul_bwd``: ``dW [G, H] f32 = unpack(P)^T @
  bf16(g_out)`` (``_bwd_call``/``_bwd_kernel``, pallas_call at :323).

Each wrapper dispatches on the device of the tensors it is given: a CUDA
tensor launches the hand-written kernel of ``csrc/packed_matmul.cu``
(built with nvcc for sm_90a at first use, bound with ctypes, launched on
torch's current stream) or raises; a CPU tensor takes the plain PyTorch
version below, which unpacks the bits to a dense bf16 matrix and computes
``x.float() @ w.bfloat16().float()``. There is no fallback from one to the
other. Each wrapper counts its kernel launches in ``.launches``.

P may come with each row padded by zero bytes to a multiple of
``P_ROW_ALIGN`` (4) bytes, as the trainer builds it once per run: the
kernels copy P in 4-byte words, and take such a P as it is. An unpadded
P of a gene count that needs padding is copied to the padded width on
every launch. The plain versions read the first ``ceil(G/8)`` bytes of a
row either way.

On the card any hidden width H is taken: the wrapper zero-pads the bf16
operand's columns to a multiple of 8 (the kernels' 16-byte copies) and
slices the padding off the result; zero columns add nothing, so this is
exact. The forward launches one block per tile of rows and columns
(:func:`_fwd_grid` counts them and their waves). The backward splits M
into the slices that :func:`_bwd_slices` plans and adds their partials in
a fixed order on the card.

The tile planner (``--kernel-autotune``; the reference's tile planning,
``g2vec_tpu/ops/packed_matmul.py:214-282, :416-576``) chooses each
launch's plan by its exact (M, G, H): the forward's layout (the shipped
one, or an instance of ``csrc/packed_matmul_tiles.cu``, all bitwise the
same function) and the backward's slice count. Without a measured plan
(:func:`autotune_packed_matmul`, :func:`load_tuned`) every launch takes
the heuristic plan, the shipped layout and :func:`_bwd_slices`, and the
tiles library is never built.

The :class:`PackedMatmul` autograd function glues the two together: the
gradient reaches W only (the paths are data, ref: G2Vec.py:264), the
cotangent is cast to bf16 before the backward, dW is cast back to W's
dtype, and ``grad_rows`` restricts the backward to the first rows (the
trainer's fused [train | val] forward trains on the train rows only).

Lanes (the batch engine's trainer, ``train_cbow_lanes``): the same two
functions over a stack of B runs of one shape, P ``[B, M, nb]``, W
``[B, G, H]``, one launch of each kernel for all of them
(``packed_matmul_lanes_fwd``/``_bwd`` and the autograd function
:class:`PackedMatmulLanes`). ``lanes`` picks which lanes of the P stack
take part (the lanes still training), by a table the kernels read, so P is
never copied. Every lane's result is bitwise the solo launch's on that
lane's tensors. The backward's workspace is B times the solo plan's
(``[B, S, G, H8]`` f32: 264 MB at 8 lanes of the example, S = 11); lanes
whose workspace would pass ``BWD_LANES_WORKSPACE_CAP`` go in further
launches. The lane forward is the shipped layout; the lane backward takes
the solo launch's plan. The plain versions are per-lane loops over the
solo ones.
"""
from __future__ import annotations

import ctypes
import functools
import json
import os
import shutil
import time
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from g2vec_tpu_torch.native._build import build, load

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "csrc", "packed_matmul.cu")
#: The forward under every layout the tile planner may pick.
TILES_SRC = os.path.join(os.path.dirname(SRC), "packed_matmul_tiles.cu")

#: The TPU functions these kernels replace (file:line of the pallas_call).
REPLACES = {"packed_matmul_fwd": "g2vec_tpu/ops/packed_matmul.py:302",
            "packed_matmul_bwd": "g2vec_tpu/ops/packed_matmul.py:323",
            "packed_matmul_lanes_fwd": "g2vec_tpu/ops/packed_matmul.py:302",
            "packed_matmul_lanes_bwd": "g2vec_tpu/ops/packed_matmul.py:323"}


def nvcc_command() -> list:
    """nvcc straight to a plain-C shared library for sm_90a (seconds to
    build, where a source including PyTorch's headers takes minutes).
    ``-Xptxas -v`` keeps the register/spill report in the build log."""
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _configure(lib: ctypes.CDLL) -> None:
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.g2v_pm_fwd.argtypes = [ptr, ptr, ptr, i64, i64, i64, i64, ptr]
    lib.g2v_pm_fwd_occupancy.argtypes = []
    lib.g2v_pm_fwd_occupancy.restype = ctypes.c_int
    lib.g2v_pm_bwd.argtypes = [ptr, ptr, ptr, ptr, i64, i64, i64, i64,
                               i64, i64, ptr]
    lib.g2v_pm_fwd_lanes.argtypes = [ptr, ptr, i64, ptr, ptr, i64, i64, i64,
                                     i64, i64, ptr]
    lib.g2v_pm_bwd_lanes.argtypes = [ptr, ptr, i64, ptr, ptr, ptr, i64, i64,
                                     i64, i64, i64, i64, i64, ptr]
    for fn in (lib.g2v_pm_fwd, lib.g2v_pm_bwd, lib.g2v_pm_fwd_lanes,
               lib.g2v_pm_bwd_lanes):
        fn.restype = ctypes.c_int


def build_kernels():
    """Compile the kernels now; returns ``(library path, nvcc output)``."""
    return build(SRC, nvcc_command())


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernel library, built and loaded once per process."""
    return load(SRC, nvcc_command(), _configure)


def _layout_suffix(layout: tuple) -> str:
    return "_".join(str(v) for v in layout)


def _configure_tiles(lib: ctypes.CDLL) -> None:
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    for layout in FWD_LAYOUTS:
        fn = getattr(lib, f"g2v_pm_fwd_layout_{_layout_suffix(layout)}")
        fn.argtypes = [ptr, ptr, ptr, i64, i64, i64, i64, ptr]
        fn.restype = ctypes.c_int
        occ = getattr(lib, "g2v_pm_fwd_layout_occupancy_"
                      + _layout_suffix(layout))
        occ.argtypes = []
        occ.restype = ctypes.c_int


def build_tile_kernels():
    """Compile the tiles library (the forward under every layout of
    :data:`FWD_LAYOUTS`) now; returns ``(library path, nvcc output)``."""
    return build(TILES_SRC, nvcc_command(), deps=(SRC,))


@functools.lru_cache(maxsize=None)
def _tiles_lib() -> ctypes.CDLL:
    """The tiles library, built and loaded once per process, at the first
    sweep or launch of a layout other than the shipped one."""
    return load(TILES_SRC, nvcc_command(), _configure_tiles, deps=(SRC,))


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the card-side reference).
# ---------------------------------------------------------------------------

#: The kernels copy P in words of this many bytes: its row stride must be
#: a multiple of it.
P_ROW_ALIGN = 4


def padded_row_bytes(n_genes: int) -> int:
    """A packed row of ``n_genes`` bits padded to the kernels' row
    stride: ``ceil(G/8)`` rounded up to a multiple of ``P_ROW_ALIGN``."""
    return -(-((n_genes + 7) // 8) // P_ROW_ALIGN) * P_ROW_ALIGN


def unpack_bits(packed: torch.Tensor, n_genes: int,
                dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """[M, ceil(G/8)] uint8 np.packbits rows -> [M, G] 0/1 in ``dtype``."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed.unsqueeze(-1) >> shifts) & 1
    return bits.reshape(packed.shape[0], -1)[:, :n_genes].to(dtype)


def packed_matmul_fwd_plain(packed: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    x = unpack_bits(packed, w.shape[0])
    return x.float() @ w.bfloat16().float()


def packed_matmul_bwd_plain(packed: torch.Tensor, g_out: torch.Tensor,
                            n_genes: int) -> torch.Tensor:
    x = unpack_bits(packed, n_genes)
    return x.float().T @ g_out.bfloat16().float()


# ---------------------------------------------------------------------------
# The forward's grid.
# ---------------------------------------------------------------------------

#: The forward's layouts, FwdLayout's template arguments in
#: csrc/packed_matmul.cu: (warps along the rows, warps along the columns,
#: genes a ring stage, ring stages). FWD_SHIPPED is FwdShipped, the layout
#: of pm_fwd_kernel and the lane kernel; FWD_LAYOUTS are the tile planner's
#: candidates, the shipped one first, in the order of G2V_FWD_LAYOUTS in
#: csrc/packed_matmul_tiles.cu (tests/test_torch_autotune.py holds both
#: equal to the sources).
FWD_SHIPPED = (4, 1, 128, 2)
FWD_LAYOUTS = [(4, 1, 128, 2), (4, 2, 64, 4), (4, 1, 64, 4), (4, 1, 128, 3),
               (4, 2, 128, 2), (4, 2, 128, 3), (2, 1, 128, 2), (2, 1, 64, 3),
               (2, 1, 64, 4), (2, 2, 128, 2), (2, 2, 64, 4)]
#: Shared memory of one SM and what the card reserves of it a block
#: (kSmemPerSM, kSmemReservedPerBlock), and the most one block may take
#: (an H100's opt-in limit, 227 KB).
SMEM_PER_SM, SMEM_RESERVED_PER_BLOCK = 228 * 1024, 1024
SMEM_PER_BLOCK_MAX = 227 * 1024


class FwdLayoutInfo(NamedTuple):
    """What follows from a forward layout (FwdLayout's constexprs):
    a block's rows, columns and threads, its ring's shared memory, and the
    blocks an SM keeps resident."""

    rows: int
    cols: int
    threads: int
    smem: int
    blocks_per_sm: int


def fwd_layout_info(layout: tuple) -> FwdLayoutInfo:
    warps_m, warps_n, genes, stages = layout
    rows, cols = 32 * warps_m, 128
    smem = stages * (genes * (cols + 8) * 2 + rows * genes // 8)
    return FwdLayoutInfo(rows, cols, 32 * warps_m * warps_n, smem,
                         min(8 // warps_m,
                             SMEM_PER_SM // (smem + SMEM_RESERVED_PER_BLOCK)))


#: The shipped layout's block tile and residency (kRows, kCols and
#: kBlocksPerSM of FwdShipped).
FWD_BLOCK_ROWS, FWD_BLOCK_COLS, _, _, FWD_BLOCKS_PER_SM = fwd_layout_info(
    FWD_SHIPPED)


class FwdGrid(NamedTuple):
    """A forward launch: ``blocks`` blocks of a layout's rows x columns,
    ``waves`` times the card's resident block slots."""

    blocks: int
    waves: float


def _fwd_grid(m: int, h: int, n_sms: int,
              layout: tuple = FWD_SHIPPED) -> FwdGrid:
    """The forward's launch of ``m`` rows and ``h`` columns on ``n_sms``
    SMs under ``layout``. Every block walks every gene in one order for
    each of its rows, so a row's result depends neither on the grid nor on
    the layout."""
    info = fwd_layout_info(layout)
    blocks = -(-m // info.rows) * -(-h // info.cols)
    return FwdGrid(blocks, blocks / (info.blocks_per_sm * n_sms))


def fwd_occupancy(lib: Optional[ctypes.CDLL] = None,
                  layout: Optional[tuple] = None) -> int:
    """Blocks of the forward the card keeps resident on one SM: the
    shipped kernel's (``layout`` None; in ``lib``, by default the port's
    kernel library), or ``layout``'s instance (in ``lib``, by default the
    tiles library)."""
    if layout is None:
        n = (lib or _lib()).g2v_pm_fwd_occupancy()
    else:
        n = getattr(lib or _tiles_lib(), "g2v_pm_fwd_layout_occupancy_"
                    + _layout_suffix(layout))()
    if n < 0:
        raise RuntimeError("the forward's occupancy query failed")
    return n


# ---------------------------------------------------------------------------
# The backward's split of M.
# ---------------------------------------------------------------------------

#: The backward kernel's block tile, ring stage and residency (kBwdGenes,
#: kBwdCols, kBwdRows and kBwdBlocksPerSM in csrc/packed_matmul.cu, which
#: tests/test_torch_packed_matmul.py holds these equal to).
BWD_BLOCK_GENES, BWD_BLOCK_COLS, BWD_STAGE_ROWS = 128, 128, 64
BWD_BLOCKS_PER_SM = 2
#: The first pass is planned to fill at most this many waves of resident
#: blocks.
BWD_WAVES = 2
#: A slice is never planned below this many rows.
BWD_MIN_SLICE_ROWS = 1024
#: The planned workspace ([S, G, H8] f32) stays at or under this many bytes.
BWD_WORKSPACE_CAP = 256 * 2 ** 20


class BwdSlices(NamedTuple):
    """Slice ``s`` covers rows ``[s * rows, min(m, (s + 1) * rows))``."""

    n_slices: int
    rows: int
    workspace_bytes: int

    def bounds(self, m: int) -> list:
        return [(s * self.rows, min(m, (s + 1) * self.rows))
                for s in range(self.n_slices)]


def _bwd_split(m: int, n: int, g: int, h8: int) -> BwdSlices:
    """M rows in at most ``n`` slices of whole ring stages, ascending and
    contiguous, none empty; the workspace for ``g`` genes and ``h8``
    columns."""
    rows = -(-max(-(-m // max(n, 1)), 1) // BWD_STAGE_ROWS) * BWD_STAGE_ROWS
    n = max(-(-m // rows), 1)
    return BwdSlices(n, rows, n * g * h8 * 4 if n > 1 else 0)


def _bwd_slices(m: int, g: int, h: int, n_sms: int) -> BwdSlices:
    """How the backward splits its M rows: as many slices as fill the
    card's resident blocks in ``BWD_WAVES`` waves, none planned below
    ``BWD_MIN_SLICE_ROWS`` rows, the workspace within
    ``BWD_WORKSPACE_CAP``. Two waves leave fewer block slots idle than one
    (at the example shape 506 of 528 slots against 230 of 264), and a
    third adds more slices to sum than it fills. The plan depends on its
    arguments alone, so dW is the same bits from run to run. With one
    slice the kernel writes dW directly and needs no workspace."""
    h8 = -(-h // 8) * 8
    tiles = -(-g // BWD_BLOCK_GENES) * -(-h8 // BWD_BLOCK_COLS)
    n = max(1, min(BWD_WAVES * BWD_BLOCKS_PER_SM * n_sms // max(tiles, 1),
                   m // BWD_MIN_SLICE_ROWS,
                   BWD_WORKSPACE_CAP // max(g * h8 * 4, 1)))
    return _bwd_split(m, n, g, h8)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# ---------------------------------------------------------------------------
# Tile planning: the heuristic plan, and measured (autotuned) overrides.
# ---------------------------------------------------------------------------
#
# The port's counterpart of the reference's planner
# (g2vec_tpu/ops/packed_matmul.py:214-282, :416-576). The reference sweeps
# Pallas grids, (row_block, blocks_per_group); the port sweeps what its
# kernels can vary: the forward's layout (FWD_LAYOUTS, all bitwise the
# same function) and the backward's slice count S. The heuristic plan is
# FWD_SHIPPED and _bwd_slices. ``--kernel-autotune`` measures every
# candidate at a run's exact shapes on the card, installs the fastest
# for that (m, g, h) and persists it under ``--cache-dir``
# (cache.autotune_cache_path). Unlike the reference there is no
# ``tuned_token`` (no compiled program embeds a plan) and no padded-shape
# refusal (the kernels take any M, G and H >= 1; the key is the exact
# shape the launches see).

#: Measured overrides, keyed by the exact problem (m, g, h): {"fwd":
#: layout, "bwd": S}, either direction alone where only it was measured
#: (the other takes the heuristic), each serving only launches under the
#: backend tag it was installed for (_TUNED_BACKEND).
_TUNED: Dict[Tuple[int, int, int], Dict[str, object]] = {}
_TUNED_BACKEND: Dict[Tuple[int, int, int], str] = {}

#: Bump on any change to the kernels, the candidate space or the record's
#: format: a persisted plan of another schema is measured again.
AUTOTUNE_SCHEMA = 1


#: The two directions a plan holds.
DIRECTIONS = ("fwd", "bwd")


def _install_tuned(m: int, g: int, h: int, plans: Dict[str, object],
                   backend_tag: str) -> None:
    """Install the directions ``plans`` holds for (m, g, h) under
    ``backend_tag``, beside any other direction installed there under the
    same tag."""
    key = (m, g, h)
    ent = _TUNED.get(key) if _TUNED_BACKEND.get(key) == backend_tag else None
    ent = dict(ent or {})
    if plans.get("fwd") is not None:
        ent["fwd"] = tuple(int(v) for v in plans["fwd"])
    if plans.get("bwd") is not None:
        ent["bwd"] = int(plans["bwd"])
    _TUNED[key] = ent
    _TUNED_BACKEND[key] = backend_tag


def reset_tuned() -> None:
    """Drop every measured override (tests; heuristic-only runs)."""
    _TUNED.clear()
    _TUNED_BACKEND.clear()


def _autotune_backend_tag(device) -> str:
    """The backend a plan was measured on, baked into every key: ``cpu``
    (the plain versions: the reference's ``interpret``), or
    ``cuda:sm<major><minor>:<device name>``. A plan serves only its own
    backend, so CPU timings never serve a run on the card."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    return _card_tag(device)


@functools.lru_cache(maxsize=None)
def _card_tag_of(index: int) -> str:
    major, minor = torch.cuda.get_device_capability(index)
    return f"cuda:sm{major}{minor}:{torch.cuda.get_device_name(index)}"


def _card_tag(device) -> str:
    return _card_tag_of(_index(device))


def _index(device) -> int:
    return device.index if device.index is not None \
        else torch.cuda.current_device()


def _tile_plan(m: int, g: int, h: int, direction: str, backend: str,
               n_sms: Optional[int] = None):
    """The plan the next (m, g, h) launch under ``backend`` takes: for
    ``"fwd"`` a layout, for ``"bwd"`` a :class:`BwdSlices` (the heuristic
    needs ``n_sms``). The installed override when there is one for this
    backend, else the heuristic."""
    key = (m, g, h)
    ent = _TUNED.get(key)
    if ent is not None and _TUNED_BACKEND[key] != backend:
        ent = None
    ent = ent or {}
    if direction == "fwd":
        return ent.get("fwd", FWD_SHIPPED)
    if direction != "bwd":
        raise ValueError(f"direction must be fwd or bwd, got {direction!r}")
    if "bwd" in ent:
        return _bwd_split(m, ent["bwd"], g, -(-h // 8) * 8)
    return _bwd_slices(m, g, h, n_sms)


def tile_candidates(m: int, g: int, h: int) -> Dict[str, list]:
    """The plans a sweep at (m, g, h) times: ``"fwd"``, the layouts of
    :data:`FWD_LAYOUTS` whose ring fits a block's shared memory on the
    card; ``"bwd"``, every slice count from 1 to the most that whole
    64-row ring stages and ``BWD_WORKSPACE_CAP`` allow (each a count that
    :func:`_bwd_split` keeps, so _bwd_slices' choice is among them)."""
    if min(m, g, h) < 1:
        raise ValueError(f"no tile plan for m={m} g={g} h={h}")
    h8 = -(-h // 8) * 8
    most = max(1, min(-(-m // BWD_STAGE_ROWS),
                      BWD_WORKSPACE_CAP // (g * h8 * 4)))
    return {"fwd": [layout for layout in FWD_LAYOUTS
                    if fwd_layout_info(layout).smem <= SMEM_PER_BLOCK_MAX],
            "bwd": sorted({_bwd_split(m, n, g, h8).n_slices
                           for n in range(1, most + 1)})}


def _heuristic(m: int, g: int, h: int, device) -> dict:
    """The plan the heuristic gives (S only on the card, where it follows
    the SM count)."""
    device = torch.device(device)
    s = (_bwd_slices(m, g, h, _sm_count(_index(device))).n_slices
         if device.type == "cuda" else None)
    return {"fwd": list(FWD_SHIPPED), "bwd": s}


def _autotune_key(m: int, g: int, h: int, backend_tag: str) -> str:
    return (f"schema={AUTOTUNE_SCHEMA};m={m};g={g};h={h};"
            f"backend={backend_tag}")


def _read_tune_file(path: str) -> dict:
    try:
        with open(path) as f:
            rec = json.load(f)
    except (OSError, ValueError):
        return {}
    if not isinstance(rec, dict) or rec.get("schema") != AUTOTUNE_SCHEMA:
        return {}        # another kernel generation's record: re-tune
    entries = rec.get("entries")
    return entries if isinstance(entries, dict) else {}


def load_tuned(cache_path: Optional[str], m: int, g: int, h: int,
               device="cuda", directions=DIRECTIONS) -> Optional[dict]:
    """Install the persisted plan of ``directions`` for this exact problem
    and backend, if any. Returns the entry (``source="cache"``) on a hit;
    None on a miss or a stale, unreadable or illegal record, or one that
    lacks a direction asked, which the caller measures afresh."""
    from g2vec_tpu_torch.cache import record_cache_event

    def _miss():
        record_cache_event("autotune", "miss")
        return None

    if not cache_path or not os.path.exists(cache_path):
        return _miss()
    tag = _autotune_backend_tag(device)
    ent = _read_tune_file(cache_path).get(_autotune_key(m, g, h, tag))
    if not isinstance(ent, dict):
        return _miss()
    try:
        plans = {d: (tuple(int(v) for v in ent[d]) if d == "fwd"
                     else int(ent[d])) for d in directions}
    except (TypeError, ValueError, KeyError):
        return _miss()
    legal = tile_candidates(m, g, h)
    if any(plans[d] not in legal[d] for d in directions):
        return _miss()   # e.g. measured against another candidate space
    _install_tuned(m, g, h, plans, tag)
    record_cache_event("autotune", "hit")
    return {**ent, "source": "cache"}


def median_ms(fn, iters: int, flush: Optional[torch.Tensor] = None,
              device="cuda") -> Tuple[float, float, float]:
    """(median, min, max) milliseconds of ``fn`` over ``iters`` calls
    after a warm call. On the card each call is timed with CUDA events,
    behind a sleep kernel that keeps the card busy while the host enqueues
    it (so the events bracket device time only), after ``flush`` was
    written (the L2 starts cold) when one is given; on the CPU by the
    host clock."""
    on_card = torch.device(device).type == "cuda"
    fn()
    if on_card:
        torch.cuda.synchronize()
    times = []
    for _ in range(max(1, iters)):
        if not on_card:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
            continue
        if flush is not None:
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


def _sweep_inputs(m: int, g: int, h: int, device):
    """Random sweep operands on ``device``: P ``[m, padded_row_bytes(g)]``
    (half its bits set, none past gene g), W ``[g, h8]`` and g_out ``[m,
    h8]`` in bf16, zero columns past h (as the wrappers pad them)."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(0)
    nb = (g + 7) // 8
    packed = torch.randint(0, 256, (m, padded_row_bytes(g)),
                           dtype=torch.uint8, device=device, generator=gen)
    packed[:, nb:] = 0
    if g % 8:
        packed[:, nb - 1] &= (0xFF << (8 - g % 8)) & 0xFF
    w16 = _pad_cols(torch.randn((g, h), device=device, generator=gen)
                    .mul_(0.1).bfloat16(), 8)
    g16 = _pad_cols(torch.randn((m, h), device=device, generator=gen)
                    .bfloat16(), 8)
    return packed, w16, g16


def run_fwd_layout(packed: torch.Tensor, w16: torch.Tensor,
                   layout: tuple) -> torch.Tensor:
    """The forward under ``layout`` on sweep operands: the shipped kernel
    or ``layout``'s instance on the card, the plain version on the CPU."""
    if packed.device.type != "cuda":
        return packed_matmul_fwd_plain(packed, w16)
    return _fwd_on_card(packed, w16,
                        layout=None if layout == FWD_SHIPPED else layout)


def run_bwd_slices(packed: torch.Tensor, g16: torch.Tensor, n_genes: int,
                   n_slices: int) -> torch.Tensor:
    """The backward split in ``n_slices`` on sweep operands (the plain
    version on the CPU)."""
    if packed.device.type != "cuda":
        return packed_matmul_bwd_plain(packed, g16, n_genes)
    return _bwd_on_card(packed, g16, n_genes, _bwd_split(
        packed.shape[0], n_slices, n_genes, g16.shape[1]))


def time_fwd_layouts(packed: torch.Tensor, w16: torch.Tensor, layouts,
                     iters: int, flush: Optional[torch.Tensor] = None
                     ) -> Dict[tuple, Tuple[float, float, float]]:
    """Each layout's forward timed on these operands (:func:`median_ms`).
    Every layout must give the first one's bits: one that does not raises,
    and is no candidate."""
    times, first = {}, None
    for layout in layouts:
        out = run_fwd_layout(packed, w16, layout)
        if first is None:
            first = out
        elif not torch.equal(out.view(torch.int32), first.view(torch.int32)):
            raise RuntimeError(f"forward layout {layout} is not bitwise the "
                               f"layout {layouts[0]} at M={packed.shape[0]} "
                               f"G={w16.shape[0]}")
        times[layout] = median_ms(lambda: run_fwd_layout(packed, w16, layout),
                                  iters, flush, packed.device)
    return times


def time_bwd_slices(packed: torch.Tensor, g16: torch.Tensor, n_genes: int,
                    counts, iters: int, flush: Optional[torch.Tensor] = None
                    ) -> Dict[int, Tuple[float, float, float]]:
    """The backward under each slice count timed on these operands."""
    return {s: median_ms(lambda: run_bwd_slices(packed, g16, n_genes, s),
                         iters, flush, packed.device) for s in counts}


def autotune_packed_matmul(m: int, g: int, h: int, *, device="cuda",
                           iters: int = 5, cache_path: Optional[str] = None,
                           force: bool = False) -> dict:
    """Measure every candidate plan at (m, g, h) on ``device``, install
    and persist the fastest of each direction.

    Returns ``{"fwd": layout, "bwd": S, "ms": {...}, "heuristic": {...},
    "source": "measured"}``; an installed plan of this backend
    (``"memory"``) or a verified persisted one (``"cache"``) returns
    without a sweep unless ``force``. On the card a sweep builds the tiles
    library at its first use; a candidate that fails to build or launch
    raises.
    """
    return _autotune(m, g, h, DIRECTIONS, device=device, iters=iters,
                     cache_path=cache_path, force=force)


def _autotune(m: int, g: int, h: int, directions, *, device="cuda",
              iters: int = 5, cache_path: Optional[str] = None,
              force: bool = False) -> dict:
    """:func:`autotune_packed_matmul` for ``directions`` alone (a shape
    the trainer launches in one direction is timed in that one): the
    entry holds those directions, and a persisted entry merges them with
    what it held."""
    from g2vec_tpu_torch.cache import record_cache_event

    directions = tuple(d for d in DIRECTIONS if d in directions)
    tag = _autotune_backend_tag(device)
    if not force:
        ent = _TUNED.get((m, g, h))
        if ent is not None and _TUNED_BACKEND[(m, g, h)] == tag \
                and all(d in ent for d in directions):
            record_cache_event("autotune", "hit")
            return {**{d: (list(ent[d]) if d == "fwd" else ent[d])
                       for d in directions}, "source": "memory"}
        hit = load_tuned(cache_path, m, g, h, device, directions)
        if hit is not None:
            return hit
    record_cache_event("autotune", "sweep")
    cands = tile_candidates(m, g, h)
    packed, w16, g16 = _sweep_inputs(m, g, h, device)
    times, ms = {}, {}
    if "fwd" in directions:
        times["fwd"] = time_fwd_layouts(packed, w16, cands["fwd"], iters)
        ms.update({f"fwd:{_layout_suffix(k)}": round(v[0], 4)
                   for k, v in times["fwd"].items()})
    if "bwd" in directions:
        times["bwd"] = time_bwd_slices(packed, g16, g, cands["bwd"], iters)
        ms.update({f"bwd:S{k}": round(v[0], 4)
                   for k, v in times["bwd"].items()})
    del packed, w16, g16
    best = {d: min(t, key=lambda k: t[k][0]) for d, t in times.items()}
    for d, k in best.items():
        ms[f"{d}:best_ms"] = round(times[d][k][0], 4)
    _install_tuned(m, g, h, best, tag)
    entry = {**{d: (list(k) if d == "fwd" else k) for d, k in best.items()},
             "ms": ms, "heuristic": _heuristic(m, g, h, device),
             "source": "measured"}
    if cache_path:
        from g2vec_tpu_torch.utils.integrity import write_json_atomic

        entries = _read_tune_file(cache_path)
        key = _autotune_key(m, g, h, tag)
        kept = entries.get(key) if isinstance(entries.get(key), dict) else {}
        merged = {**kept, **{k: v for k, v in entry.items() if k != "source"}}
        merged["ms"] = {**(kept.get("ms") if isinstance(kept.get("ms"), dict)
                           else {}), **ms}
        entries[key] = merged
        os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
        write_json_atomic(cache_path,
                          {"schema": AUTOTUNE_SCHEMA, "entries": entries})
    return entry


def describe_tiles(m: int, g: int, h: int, device=None) -> dict:
    """The plan the next (m, g, h) launches on ``device`` (default: the
    card when torch sees one, else the CPU) take, and whether each
    direction's is ``"heuristic"`` or ``"autotuned"``. On the CPU, where
    no kernel runs, the heuristic S is None."""
    device = torch.device(device or ("cuda" if torch.cuda.is_available()
                                     else "cpu"))
    tag = _autotune_backend_tag(device)
    tuned = (_TUNED.get((m, g, h)) or {}) \
        if _TUNED_BACKEND.get((m, g, h)) == tag else {}
    heur = _heuristic(m, g, h, device)
    return {"fwd": {"layout": list(tuned.get("fwd", heur["fwd"])),
                    "source": "autotuned" if "fwd" in tuned
                    else "heuristic"},
            "bwd": {"n_slices": tuned.get("bwd", heur["bwd"]),
                    "source": "autotuned" if "bwd" in tuned
                    else "heuristic"}}


# ---------------------------------------------------------------------------
# Wrappers: CPU tensors -> plain version; CUDA tensors -> the kernel.
# ---------------------------------------------------------------------------

def _check(packed: torch.Tensor, dense: torch.Tensor, n_genes: int,
           dense_rows: int, what: str) -> None:
    if packed.dtype != torch.uint8 or packed.dim() != 2:
        raise ValueError(f"packed must be a 2-D uint8 tensor, got "
                         f"{packed.dtype} {tuple(packed.shape)}")
    if dense.dim() != 2 or dense.shape[0] != dense_rows:
        raise ValueError(f"{what} must be [{dense_rows}, H], got "
                         f"{tuple(dense.shape)}")
    nb = (n_genes + 7) // 8
    if packed.shape[1] not in (nb, padded_row_bytes(n_genes)):
        raise ValueError(f"packed width {packed.shape[1]} does not hold "
                         f"{n_genes} genes (want {nb}, or "
                         f"{padded_row_bytes(n_genes)} with its rows padded "
                         f"to a multiple of {P_ROW_ALIGN} bytes)")
    if packed.device != dense.device:
        raise ValueError(f"packed on {packed.device}, {what} on {dense.device}")
    if not dense.dtype.is_floating_point:
        raise ValueError(f"{what} must be floating point, got {dense.dtype}")


def _pad_cols(t: torch.Tensor, multiple: int) -> torch.Tensor:
    """``t`` with zero columns (last dimension) appended up to a multiple
    of ``multiple`` (``t`` itself when its width is one already)."""
    extra = -t.shape[-1] % multiple
    return F.pad(t, (0, extra)) if extra else t


def _check_kernel_args(packed: torch.Tensor, dense_bf16: torch.Tensor,
                       what: str, align: int) -> None:
    """What the kernels take beyond :func:`_check`: CUDA tensors, both
    contiguous, and the bf16 operand starting ``align``-byte aligned (the
    width of the kernel's loads)."""
    if packed.device.type != "cuda":
        raise ValueError(f"no kernel for device {packed.device}")
    if not packed.is_contiguous() or not dense_bf16.is_contiguous():
        raise ValueError(f"the kernel needs contiguous packed and {what}")
    if dense_bf16.data_ptr() % align:
        raise ValueError(f"the kernel needs {what} {align}-byte aligned, "
                         f"got address {dense_bf16.data_ptr():#x}")
    if max(*packed.shape, *dense_bf16.shape) * 8 >= 2 ** 31:
        raise ValueError(f"the kernel indexes rows, genes and columns as "
                         f"int32; got packed {tuple(packed.shape)}, {what} "
                         f"{tuple(dense_bf16.shape)}")


def _launch(fn, *args) -> None:
    """``fn(*args, stream)`` on torch's current stream of the device that
    ``args[0]`` lies on; tensors pass as their data pointers, None as
    NULL."""
    device = args[0].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
                  for a in args), stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {rc}")


def _padded_packed(packed: torch.Tensor) -> torch.Tensor:
    """P for the kernels' 4-byte copies: its rows padded to a multiple of
    ``P_ROW_ALIGN`` bytes (a copy only when they are not: the trainer
    pads once per run), starting 4-byte aligned or refused."""
    p4 = _pad_cols(packed, P_ROW_ALIGN)
    if p4.data_ptr() % P_ROW_ALIGN:
        raise ValueError(f"the kernels need packed {P_ROW_ALIGN}-byte "
                         f"aligned, got address {p4.data_ptr():#x}")
    return p4


def packed_matmul_fwd(packed: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``unpack(packed) @ bf16(w)`` -> [M, H] float32."""
    _check(packed, w, w.shape[0], w.shape[0], "w")
    if packed.device.type == "cpu":
        return packed_matmul_fwd_plain(packed, w)
    w16 = _pad_cols(w.to(torch.bfloat16), 8)
    _check_kernel_args(packed, w16, "w", 16)
    m, (g, h) = packed.shape[0], w.shape
    if m == 0:
        return torch.empty((0, h), dtype=torch.float32, device=packed.device)
    layout = _tile_plan(m, g, h, "fwd", _card_tag(packed.device))
    if layout == FWD_SHIPPED:
        out = _fwd_on_card(packed, w16)
    else:
        out = _fwd_on_card(packed, w16, layout=layout)
        counts = packed_matmul_fwd.layout_launches
        counts[layout] = counts.get(layout, 0) + 1
    packed_matmul_fwd.launches += 1
    return out if w16.shape[1] == h else out[:, :h].contiguous()


packed_matmul_fwd.launches = 0
#: Of those, the launches of each planned layout other than the shipped
#: one (the tiles library's instances).
packed_matmul_fwd.layout_launches = {}


def _fwd_on_card(packed: torch.Tensor, w16: torch.Tensor,
                 lib: Optional[ctypes.CDLL] = None,
                 layout: Optional[tuple] = None) -> torch.Tensor:
    """The forward kernel on checked card tensors (``w16`` padded to a
    multiple of 8 columns, at least one row): out [M, w16 width]. The
    shipped kernel (``layout`` None; in ``lib``, by default the port's
    kernel library), or ``layout``'s instance (in ``lib``, by default the
    tiles library). Counts nothing: the wrapper counts."""
    p4 = _padded_packed(packed)
    m, (g, h8) = packed.shape[0], w16.shape
    out = torch.empty((m, h8), dtype=torch.float32, device=packed.device)
    if layout is None:
        fn = (lib or _lib()).g2v_pm_fwd
    else:
        fn = getattr(lib or _tiles_lib(),
                     f"g2v_pm_fwd_layout_{_layout_suffix(layout)}")
    _launch(fn, p4, w16, out, m, g, p4.shape[1], h8)
    return out


def packed_matmul_bwd(packed: torch.Tensor, g_out: torch.Tensor,
                      n_genes: int) -> torch.Tensor:
    """``unpack(packed)^T @ bf16(g_out)`` -> [n_genes, H] float32."""
    _check(packed, g_out, n_genes, packed.shape[0], "g_out")
    if packed.device.type == "cpu":
        return packed_matmul_bwd_plain(packed, g_out, n_genes)
    g16 = _pad_cols(g_out.to(torch.bfloat16), 8)
    _check_kernel_args(packed, g16, "g_out", 16)
    m, h = packed.shape[0], g_out.shape[1]
    plan = _tile_plan(m, n_genes, h, "bwd", _card_tag(packed.device),
                      _sm_count(packed.device.index))
    out = _bwd_on_card(packed, g16, n_genes, plan)
    packed_matmul_bwd.launches += 1
    return out if g16.shape[1] == h else out[:, :h].contiguous()


packed_matmul_bwd.launches = 0


def _bwd_on_card(packed: torch.Tensor, g16: torch.Tensor, n_genes: int,
                 plan: BwdSlices) -> torch.Tensor:
    """The backward kernels on checked card tensors (``g16`` padded to a
    multiple of 8 columns) under the split ``plan``: dW [n_genes, g16
    width]. Counts nothing: the wrapper counts."""
    m, h8 = packed.shape[0], g16.shape[1]
    if plan.n_slices < 1 or plan.rows * plan.n_slices < m:
        raise ValueError(f"the split {plan} does not cover {m} rows")
    p4 = _padded_packed(packed)
    out = torch.empty((n_genes, h8), dtype=torch.float32, device=packed.device)
    work = (torch.empty((plan.n_slices, n_genes, h8), dtype=torch.float32,
                        device=packed.device) if plan.n_slices > 1 else None)
    _launch(_lib().g2v_pm_bwd, p4, g16, out, work, m, n_genes, p4.shape[1],
            h8, plan.rows, plan.n_slices)
    return out


# ---------------------------------------------------------------------------
# Lanes: B runs of one shape, one launch of each kernel for all of them.
# ---------------------------------------------------------------------------

#: The lane backward's workspace ([lanes, S, G, H8] f32) stays at or under
#: this many bytes a launch; more lanes go in further launches.
BWD_LANES_WORKSPACE_CAP = 1024 * 2 ** 20
#: A launch's grid z holds at most this many lane slots (x slices).
_GRID_Z_MAX = 65535


def _lane_ids(packed: torch.Tensor, lanes: Optional[Sequence[int]]) -> list:
    """The lanes of the P stack ``packed`` that take part, checked."""
    ids = list(range(packed.shape[0])) if lanes is None else \
        [int(i) for i in lanes]
    if any(not 0 <= i < packed.shape[0] for i in ids):
        raise ValueError(f"lanes {ids} outside the stack's "
                         f"{packed.shape[0]}")
    return ids


def _check_lanes(packed: torch.Tensor, dense: torch.Tensor, ids: list,
                 n_genes: int, max_rows: int, what: str) -> None:
    if packed.dtype != torch.uint8 or packed.dim() != 3:
        raise ValueError(f"packed must be a 3-D uint8 lane stack, got "
                         f"{packed.dtype} {tuple(packed.shape)}")
    if dense.dim() != 3 or dense.shape[0] != len(ids) \
            or not 1 <= dense.shape[1] <= max_rows:
        raise ValueError(f"{what} must be [{len(ids)} lanes, rows, H] with "
                         f"1..{max_rows} rows, got {tuple(dense.shape)}")
    _check(packed[0], dense[0], n_genes, dense.shape[1], what)


def packed_matmul_lanes_fwd_plain(packed: torch.Tensor, w: torch.Tensor,
                                  lanes: Optional[Sequence[int]] = None
                                  ) -> torch.Tensor:
    ids = _lane_ids(packed, lanes)
    return torch.stack([packed_matmul_fwd_plain(packed[lane], w[i])
                        for i, lane in enumerate(ids)])


def packed_matmul_lanes_bwd_plain(packed: torch.Tensor, g_out: torch.Tensor,
                                  n_genes: int,
                                  lanes: Optional[Sequence[int]] = None
                                  ) -> torch.Tensor:
    ids = _lane_ids(packed, lanes)
    rows = g_out.shape[1]
    return torch.stack([packed_matmul_bwd_plain(packed[lane, :rows], g_out[i],
                                                n_genes)
                        for i, lane in enumerate(ids)])


def _lane_table(ids: list, device) -> torch.Tensor:
    return torch.tensor(ids, dtype=torch.int32, device=device)


def packed_matmul_lanes_fwd(packed: torch.Tensor, w: torch.Tensor,
                            lanes: Optional[Sequence[int]] = None
                            ) -> torch.Tensor:
    """For each of ``lanes`` (default: all) of the P stack ``packed [B, M,
    nb]``: ``unpack(packed[lane]) @ bf16(w[i])``, ``w [len(lanes), G, H]``
    -> [len(lanes), M, H] float32, in one launch."""
    ids = _lane_ids(packed, lanes)
    _check_lanes(packed, w, ids, w.shape[1], w.shape[1], "w")
    if packed.device.type == "cpu":
        return packed_matmul_lanes_fwd_plain(packed, w, ids)
    w16 = _pad_cols(w.to(torch.bfloat16), 8)
    _check_kernel_args(packed, w16, "w", 16)
    b, m, h = len(ids), packed.shape[1], w.shape[2]
    if m == 0:
        return torch.empty((b, 0, h), dtype=torch.float32,
                           device=packed.device)
    if b > _GRID_Z_MAX:
        raise ValueError(f"{b} lanes exceed a launch's {_GRID_Z_MAX}")
    p4 = _padded_packed(packed)
    g, h8 = w16.shape[1], w16.shape[2]
    out = torch.empty((b, m, h8), dtype=torch.float32, device=packed.device)
    _launch(_lib().g2v_pm_fwd_lanes, p4, _lane_table(ids, packed.device),
            m * p4.shape[2], w16, out, b, m, g, p4.shape[2], h8)
    packed_matmul_lanes_fwd.launches += 1
    return out if h8 == h else out[:, :, :h].contiguous()


packed_matmul_lanes_fwd.launches = 0


def packed_matmul_lanes_bwd(packed: torch.Tensor, g_out: torch.Tensor,
                            n_genes: int,
                            lanes: Optional[Sequence[int]] = None
                            ) -> torch.Tensor:
    """For each of ``lanes`` (default: all) of the P stack ``packed [B, M,
    nb]``: ``unpack(packed[lane, :rows])^T @ bf16(g_out[i])``, ``g_out
    [len(lanes), rows, H]``, rows <= M -> [len(lanes), n_genes, H] float32.
    Each lane is split by the solo launch's plan (:func:`_tile_plan`); one
    launch for all lanes, or more where the workspace would pass
    ``BWD_LANES_WORKSPACE_CAP``."""
    ids = _lane_ids(packed, lanes)
    _check_lanes(packed, g_out, ids, n_genes, packed.shape[1], "g_out")
    if packed.device.type == "cpu":
        return packed_matmul_lanes_bwd_plain(packed, g_out, n_genes, ids)
    g16 = _pad_cols(g_out.to(torch.bfloat16), 8)
    _check_kernel_args(packed, g16, "g_out", 16)
    rows, h, h8 = g_out.shape[1], g_out.shape[2], g16.shape[2]
    plan = _tile_plan(rows, n_genes, h, "bwd", _card_tag(packed.device),
                      _sm_count(packed.device.index))
    p4 = _padded_packed(packed)
    out = torch.empty((len(ids), n_genes, h8), dtype=torch.float32,
                      device=packed.device)
    per_launch = max(1, min(BWD_LANES_WORKSPACE_CAP
                            // max(plan.workspace_bytes, 1),
                            _GRID_Z_MAX // plan.n_slices))
    for lo in range(0, len(ids), per_launch):
        chunk = ids[lo:lo + per_launch]
        work = (torch.empty((len(chunk), plan.n_slices, n_genes, h8),
                            dtype=torch.float32, device=packed.device)
                if plan.n_slices > 1 else None)
        _launch(_lib().g2v_pm_bwd_lanes, p4, _lane_table(chunk, packed.device),
                packed.shape[1] * p4.shape[2], g16[lo:lo + len(chunk)],
                out[lo:lo + len(chunk)], work, len(chunk), rows, n_genes,
                p4.shape[2], h8, plan.rows, plan.n_slices)
        packed_matmul_lanes_bwd.launches += 1
    return out if h8 == h else out[:, :, :h].contiguous()


packed_matmul_lanes_bwd.launches = 0


def reset_launch_counts() -> None:
    packed_matmul_fwd.launches = 0
    packed_matmul_fwd.layout_launches.clear()
    packed_matmul_bwd.launches = 0
    packed_matmul_lanes_fwd.launches = 0
    packed_matmul_lanes_bwd.launches = 0


class PackedMatmul(torch.autograd.Function):
    """``unpack(packed) @ bf16(w)`` with a gradient for ``w`` only."""

    @staticmethod
    def forward(ctx, packed, w, grad_rows):
        ctx.save_for_backward(packed)
        ctx.n_genes, ctx.w_dtype = w.shape[0], w.dtype
        ctx.grad_rows = packed.shape[0] if grad_rows is None else grad_rows
        return packed_matmul_fwd(packed, w)

    @staticmethod
    def backward(ctx, g_out):
        (packed,) = ctx.saved_tensors
        rows = ctx.grad_rows
        dw = packed_matmul_bwd(packed[:rows], g_out[:rows].contiguous(),
                               ctx.n_genes)
        return None, dw.to(ctx.w_dtype), None


def packed_matmul(packed: torch.Tensor, w: torch.Tensor,
                  grad_rows: Optional[int] = None) -> torch.Tensor:
    """Differentiable ``unpack(packed) @ bf16(w)`` -> [M, H] float32; the
    backward covers rows ``[0, grad_rows)`` (default: all)."""
    if grad_rows is not None and not 0 <= grad_rows <= packed.shape[0]:
        raise ValueError(f"grad_rows {grad_rows} outside [0, {packed.shape[0]}]")
    return PackedMatmul.apply(packed, w, grad_rows)


class PackedMatmulLanes(torch.autograd.Function):
    """:class:`PackedMatmul` over a lane stack: ``unpack(packed[lane]) @
    bf16(w[i])`` for each of ``lanes``, with a gradient for ``w`` only."""

    @staticmethod
    def forward(ctx, packed, w, grad_rows, lanes):
        ctx.save_for_backward(packed)
        ctx.n_genes, ctx.w_dtype, ctx.lanes = w.shape[1], w.dtype, lanes
        ctx.grad_rows = packed.shape[1] if grad_rows is None else grad_rows
        return packed_matmul_lanes_fwd(packed, w, lanes)

    @staticmethod
    def backward(ctx, g_out):
        (packed,) = ctx.saved_tensors
        rows = ctx.grad_rows
        dw = packed_matmul_lanes_bwd(packed, g_out[:, :rows].contiguous(),
                                     ctx.n_genes, ctx.lanes)
        return None, dw.to(ctx.w_dtype), None, None


def packed_matmul_lanes(packed: torch.Tensor, w: torch.Tensor,
                        grad_rows: Optional[int] = None,
                        lanes: Optional[Sequence[int]] = None
                        ) -> torch.Tensor:
    """Differentiable lane-stack product: ``packed [B, M, nb]``, ``w
    [len(lanes), G, H]`` -> [len(lanes), M, H] float32; the backward covers
    each lane's rows ``[0, grad_rows)`` (default: all)."""
    if grad_rows is not None and not 1 <= grad_rows <= packed.shape[1]:
        raise ValueError(f"grad_rows {grad_rows} outside [1, "
                         f"{packed.shape[1]}]")
    return PackedMatmulLanes.apply(packed, w, grad_rows,
                                   None if lanes is None else list(lanes))
