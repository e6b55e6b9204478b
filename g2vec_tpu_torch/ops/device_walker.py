"""Stage-3 walks on the card, bit-exact with the C++ sampler.

The port of ``g2vec_tpu/ops/device_walker.py``. The walk (ref:
G2Vec.py:328-346) and its splitmix64 streams are those of
``native/walker.cpp``: the same CSR bytes, walk parameters and seed give
byte-identical packed rows from either sampler, so goldens and walk-cache
entries (``cache.NATIVE_FAMILY``) are shared between the backends.

:func:`device_walk` is the kernel's wrapper. It dispatches on the device
of the tensors it is given: a CUDA tensor launches the hand-written kernel
of ``csrc/device_walker.cu`` (a group of lanes per walker, built with nvcc
for sm_90a at first use, bound with ctypes, launched on torch's current
stream) or raises; a CPU tensor takes :func:`device_walk_plain`, the
reference's lock-step walk in torch. There is no fallback from one to the
other. It counts its kernel launches in ``.launches``. Its launch plan,
:func:`walk_plan`, is a plain function of the shapes: 8 or 16 lanes a
walker from the CSR's largest out-degree (:func:`group_for`, which the
resumable walk's wrapper takes too), and whether a block's visited masks
fit shared memory or stay in the rows.

The plain version (the reference's ``run``, :195-275,
:func:`walk_states_plain`; the one-shot walk starts it from each walker's
first state with every row held): every walker
advances one step per trip; a step gathers each walker's CSR row at a
static width of degree slots padded to a power of two, masks the visited
targets by path replay and the weights that are not > 0, accumulates the
row's float64 mass in an explicit loop over the slots (left to right, as
the C++ sampler sums; ``torch.cumsum`` promises no order), draws, and
picks the first eligible slot whose running sum exceeds the target. The
splitmix64 state is carried as two 32-bit halves in int64 tensors (torch
has no uint64 shifts), with 16-bit limb products, so every op is exact.
The rows are packed by a bit scatter at the end.

The resumable walk of the edge partition (the reference's
``advance_walk_states_device``, :375, on ``_run_states``, :332):
:func:`device_walk_states` advances explicit walk states (current gene,
raw stream, position, path prefix) in place over an availability-masked
CSR and returns each walker's status (0 finished, 1 suspended on a gene
whose row is not held). A CUDA tensor launches ``g2v_walk_states_kernel``
of the same source, a CPU tensor takes :func:`walk_states_plain`, the
reference's lock-step advance in torch; its launches are counted in
``device_walk_states.launches``. :func:`advance_walk_states_device` is
its entry point on a host
:class:`~g2vec_tpu_torch.ops.host_walker.WalkStateBatch`: the C++
advance's states and status, bitwise. No CLI path launches it: the edge
partition refuses ``--walker-backend device``, as the reference does.

The entry points mirror the reference's signatures and byte contracts:
:func:`walk_packed_rows_device`, :func:`walk_shard_device_arrays` (the
packed shard stays on the card), :func:`walk_shard_device` and
:func:`generate_path_set_device`. Each uploads a group's CSR once
(:func:`upload_csr`; a :class:`DeviceCSR` passed as ``csr`` is reused) and
brings the rows to the host in one copy. Walker ``i`` of the flat (rep x
start) axis draws from the stream keyed by ``(seed, i)``.
"""
from __future__ import annotations

import ctypes
import functools
import os
from typing import NamedTuple, Optional, Set, Tuple

import numpy as np
import torch

from g2vec_tpu_torch.device import resolve_device
from g2vec_tpu_torch.native._build import build, load
from g2vec_tpu_torch.native.walker_bindings import check_walk_states
from g2vec_tpu_torch.ops.host_walker import ShardPlan, edges_to_csr
from g2vec_tpu_torch.resilience.faults import fault_point

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "csrc", "device_walker.cu")

#: The device computation each kernel replaces (file:line of the reference's
#: jitted step scan, which packs with ``_get_pack_fn`` at :278 for the one-
#: shot walk and which ``_run_states`` at :332 drives for the resumable one).
REPLACES = "g2vec_tpu/ops/device_walker.py:186"
REPLACES_STATES = "g2vec_tpu/ops/device_walker.py:186 (_run_states :332)"

# The splitmix64 constants (Steele et al.; native/walker.cpp uses the same).
GOLDEN = 0x9E3779B97F4A7C15
MIX1 = 0xBF58476D1CE4E5B9
MIX2 = 0x94D049BB133111EB
_MASK64 = (1 << 64) - 1
_M32 = 0xFFFFFFFF


def nvcc_command() -> list:
    """The packed-matmul kernels' nvcc command with ``-fmad=false``: the
    walk's float64 sums and draw must not be contracted, or a row could
    differ from the C++ sampler's."""
    from g2vec_tpu_torch.ops.packed_matmul import nvcc_command as base

    return [*base(), "-fmad=false"]


def _configure(lib: ctypes.CDLL) -> None:
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
    flag = ctypes.c_int
    # ... the wide group, the masks in shared memory, the walker counter,
    # the stream
    lib.g2v_walk_device.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, i32,
                                    ctypes.c_uint64, ptr, i64, flag, flag,
                                    ptr, ptr]
    lib.g2v_walk_device.restype = ctypes.c_int
    lib.g2v_walk_states_device.argtypes = [ptr] * 9 + [i64, i32, flag, ptr,
                                                       ptr]
    lib.g2v_walk_states_device.restype = ctypes.c_int


def build_walk_kernel():
    """Compile the kernel now; returns ``(library path, nvcc output)``."""
    return build(SRC, nvcc_command())


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return load(SRC, nvcc_command(), _configure)


# ---------------------------------------------------------------------------
# The launch plan: a plain function of the shapes.
# ---------------------------------------------------------------------------

#: Lanes that walk one walker: the narrow group where every row of the CSR
#: fits it, else the wide one; threads a block. The .cu's ``kNarrow``,
#: ``kWide`` and ``kThreads`` (a CPU test holds them equal).
GROUPS = (8, 16)
BLOCK_THREADS = 256
#: Shared memory one block may use on Hopper (227 KB of the SM's 256 KB).
SMEM_LIMIT = 232_448
#: A walker's mask in shared memory starts on a 16-byte boundary (it is
#: zeroed in 16-byte words).
SMEM_ALIGN = 16


class WalkPlan(NamedTuple):
    """How ``g2v_walk_kernel`` is launched for one set of shapes."""

    group: int       # lanes that walk one walker (one of GROUPS)
    shared: bool     # the visited masks in shared memory, else in the rows
    stride: int      # bytes of one walker's mask in shared memory
    smem_bytes: int  # dynamic shared memory a block (0: in the rows)


def group_for(max_degree: int) -> int:
    """The lanes a walker: 8 where every row fits 8 slots, else 16 (16
    ran faster than 8 on every graph with wider rows, and 8 faster than
    16 where every row fits 8: PERF.md section 6)."""
    return GROUPS[0] if max_degree <= GROUPS[0] else GROUPS[1]


def walk_plan(n_genes: int, max_degree: int) -> WalkPlan:
    """``g2v_walk_kernel``'s plan: the group from the CSR's largest
    out-degree; a walker's mask is its packed row, ``ceil(n_genes/8)``
    bytes, and a block's masks go to shared memory exactly where they fit
    the 227 KB, else they stay in the rows."""
    group = group_for(max_degree)
    walks = BLOCK_THREADS // group
    stride = -(-((n_genes + 7) // 8) // SMEM_ALIGN) * SMEM_ALIGN
    shared = walks * stride <= SMEM_LIMIT
    return WalkPlan(group, shared, stride, walks * stride if shared else 0)


#: One walker counter a stream: ``{(device index, stream): tensor}``.
_COUNTERS: dict = {}


def _counter(device) -> torch.Tensor:
    """The kernels' walker counter on torch's current stream of
    ``device``: the walkers the groups take after the grid's own (a launch
    zeroes it on its stream where the grid leaves any to it). Made at the
    stream's first launch and kept."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    counter = _COUNTERS.get(key)
    if counter is None:
        counter = _COUNTERS.setdefault(
            key, torch.empty(1, dtype=torch.int64, device=device))
    return counter


def _max_degree(indptr: torch.Tensor) -> int:
    return int((indptr[1:] - indptr[:-1]).max()) if indptr.numel() > 1 else 0


# ---------------------------------------------------------------------------
# The stream, in numpy (the reference's helpers, :72-105).
# ---------------------------------------------------------------------------

def splitmix64_ref(state: int) -> Tuple[int, int]:
    """One splitmix64 draw in pure Python: (new_state, output word), as
    native/walker.cpp's ``splitmix64(uint64_t&)``."""
    state = (state + GOLDEN) & _MASK64
    z = state
    z = ((z ^ (z >> 30)) * MIX1) & _MASK64
    z = ((z ^ (z >> 27)) * MIX2) & _MASK64
    return state, z ^ (z >> 31)


def uniform01_ref(state: int) -> Tuple[int, float]:
    """One uniform01 draw in pure Python: (new_state, u in [0, 1))."""
    state, z = splitmix64_ref(state)
    return state, float(z >> 11) * (2.0 ** -53)


def init_walk_state_np(seed: int, stream_ids: np.ndarray) -> np.ndarray:
    """A walker's first state: ``seed ^ (stream_id * GOLDEN)`` advanced by
    one discarded splitmix64 draw (the state advance only)."""
    sid = np.ascontiguousarray(stream_ids, dtype=np.uint64)
    seed64 = np.uint64(seed & _MASK64)
    with np.errstate(over="ignore"):
        st = (seed64 ^ (sid * np.uint64(GOLDEN))) + np.uint64(GOLDEN)
    return st


# ---------------------------------------------------------------------------
# The stream, in torch: uint64 values as (hi, lo) 32-bit halves held in
# int64 tensors. No op overflows int64: products are of 16-bit limbs.
# ---------------------------------------------------------------------------

def _mul32_lo(a, b):
    """(a * b) mod 2^32 for a, b in [0, 2^32)."""
    a0, a1 = a & 0xFFFF, a >> 16
    b0, b1 = b & 0xFFFF, b >> 16
    return (a0 * b0 + ((a0 * b1 + a1 * b0) << 16)) & _M32


def _mul32_wide(a, b):
    """a * b for a, b in [0, 2^32) as its (hi, lo) halves."""
    a0, a1 = a & 0xFFFF, a >> 16
    b0, b1 = b & 0xFFFF, b >> 16
    mid = a0 * b1 + a1 * b0
    lo = a0 * b0 + ((mid & 0xFFFF) << 16)
    return a1 * b1 + (mid >> 16) + (lo >> 32), lo & _M32


def _u64_mul(xh, xl, y: int):
    """The low 64 bits of (xh, xl) * y, y a Python int."""
    yh, yl = y >> 32, y & _M32
    hi, lo = _mul32_wide(xl, yl)
    return (hi + _mul32_lo(xl, yh) + _mul32_lo(xh, yl)) & _M32, lo


def _u64_add(xh, xl, y: int):
    lo = xl + (y & _M32)
    return (xh + (y >> 32) + (lo >> 32)) & _M32, lo & _M32


def _xorshr(h, l, k: int):
    """(h, l) ^= (h, l) >> k, for 0 < k < 32."""
    return h ^ (h >> k), l ^ (((l >> k) | (h << (32 - k))) & _M32)


def splitmix64_lanes(sh, sl):
    """One splitmix64 draw on (hi, lo) halves: (state hi, state lo, word
    hi, word lo)."""
    sh, sl = _u64_add(sh, sl, GOLDEN)
    zh, zl = _xorshr(sh, sl, 30)
    zh, zl = _u64_mul(zh, zl, MIX1)
    zh, zl = _xorshr(zh, zl, 27)
    zh, zl = _u64_mul(zh, zl, MIX2)
    zh, zl = _xorshr(zh, zl, 31)
    return sh, sl, zh, zl


def uniform01_lanes(zh, zl) -> torch.Tensor:
    """``(word >> 11) * 2^-53`` as float64: the 53-bit integer is exact in
    int64 and in float64, and the scaling is a power of two."""
    return ((zh << 21) | (zl >> 11)).to(torch.float64) * 2.0 ** -53


def init_state_lanes(seed: int, stream_ids: torch.Tensor):
    """:func:`init_walk_state_np` on the halves of ``stream_ids`` (int64
    tensors holding the uint64 bits)."""
    seed &= _MASK64
    sh, sl = _u64_mul((stream_ids >> 32) & _M32, stream_ids & _M32, GOLDEN)
    return _u64_add(sh ^ (seed >> 32), sl ^ (seed & _M32), GOLDEN)


# ---------------------------------------------------------------------------
# The plain version: the reference's lock-step walk, in torch.
# ---------------------------------------------------------------------------

def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def walk_paths_plain(indptr: torch.Tensor, indices: torch.Tensor,
                     weights: torch.Tensor, starts: torch.Tensor,
                     stream_ids: torch.Tensor, len_path: int,
                     seed: int) -> torch.Tensor:
    """Every walker's path -> [n, len_path] int64 gene ids in visit
    order, -1 past its end: :func:`walk_states_plain` from each walker's
    first state over a mask that holds every row."""
    dev = indptr.device
    n = starts.shape[0]
    cur = starts.to(torch.int32).clone()
    rng = _u64_of_halves(*init_state_lanes(seed, stream_ids))
    pos = torch.ones(n, dtype=torch.int32, device=dev)
    paths = torch.full((n, len_path), -1, dtype=torch.int32, device=dev)
    paths[:, 0] = cur
    avail = torch.ones(indptr.shape[0] - 1, dtype=torch.uint8, device=dev)
    walk_states_plain(indptr, indices, weights, avail, cur, rng, pos, paths,
                      len_path)
    return paths.long()


_BITS = (128, 64, 32, 16, 8, 4, 2, 1)


def pack_paths(paths: torch.Tensor, n_genes: int) -> torch.Tensor:
    """[n, L] gene ids (-1 pads) -> [n, ceil(G/8)] uint8 np.packbits rows,
    by a bit scatter (a walk visits a gene once, so the adds are ors);
    pads land in a dump column that is cut off."""
    n, length = paths.shape
    nbytes = (n_genes + 7) // 8
    dev = paths.device
    valid = paths >= 0
    node = paths.clamp(min=0)
    rows = torch.arange(n, device=dev)[:, None] * (nbytes + 1)
    flat = rows + torch.where(valid, node >> 3, nbytes)
    bits = torch.tensor(_BITS, dtype=torch.int32, device=dev)[node & 7]
    out = torch.zeros(n * (nbytes + 1), dtype=torch.int32, device=dev)
    out.index_add_(0, flat.reshape(-1),
                   torch.where(valid, bits, 0).reshape(-1))
    return out.view(n, nbytes + 1)[:, :nbytes].to(torch.uint8)


def device_walk_plain(indptr: torch.Tensor, indices: torch.Tensor,
                      weights: torch.Tensor, starts: torch.Tensor,
                      stream_ids: torch.Tensor, len_path: int, seed: int,
                      n_genes: int) -> torch.Tensor:
    return pack_paths(walk_paths_plain(indptr, indices, weights, starts,
                                       stream_ids, len_path, seed), n_genes)


# ---------------------------------------------------------------------------
# The wrapper: CPU tensors -> plain version; CUDA tensors -> the kernel.
# ---------------------------------------------------------------------------

def _check(indptr, indices, weights, starts, stream_ids, len_path,
           n_genes) -> None:
    want = ((indptr, torch.int32, "indptr"), (indices, torch.int32, "indices"),
            (weights, torch.float32, "weights"),
            (starts, torch.int32, "starts"),
            (stream_ids, torch.int64, "stream_ids"))
    for t, dtype, name in want:
        if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D {dtype} "
                             f"tensor, got {t.dtype} {tuple(t.shape)}")
        if t.device != indptr.device:
            raise ValueError(f"{name} on {t.device}, indptr on "
                             f"{indptr.device}")
    if indptr.shape[0] != n_genes + 1:
        raise ValueError(f"indptr has {indptr.shape[0]} entries for "
                         f"{n_genes} genes (want n_genes+1)")
    if weights.shape != indices.shape:
        raise ValueError(f"weights has {weights.shape[0]} entries for "
                         f"{indices.shape[0]} edges")
    if stream_ids.shape != starts.shape:
        raise ValueError(f"stream_ids has {stream_ids.shape[0]} entries for "
                         f"{starts.shape[0]} walkers")
    if len_path < 1:
        raise ValueError(f"len_path must be >= 1, got {len_path}")


def device_walk(indptr: torch.Tensor, indices: torch.Tensor,
                weights: torch.Tensor, starts: torch.Tensor,
                stream_ids: torch.Tensor, len_path: int, seed: int,
                n_genes: int, *,
                max_degree: Optional[int] = None) -> torch.Tensor:
    """One walk per entry of ``starts`` -> [n, ceil(n_genes/8)] uint8
    packed rows on the tensors' device. ``stream_ids`` holds each walker's
    uint64 stream id as int64 bits. The CSR must be valid and ``starts``
    and ``indices`` in [0, n_genes): :func:`upload_csr` and the entry
    points check them on the host before the upload. On the card the
    launch follows :func:`walk_plan` of the shapes and ``max_degree``,
    the CSR's largest out-degree (:class:`DeviceCSR` carries it; read
    from ``indptr`` when not given)."""
    _check(indptr, indices, weights, starts, stream_ids, len_path, n_genes)
    seed &= _MASK64
    if indptr.device.type == "cpu":
        return device_walk_plain(indptr, indices, weights, starts,
                                 stream_ids, len_path, seed, n_genes)
    if indptr.device.type != "cuda":
        raise ValueError(f"no kernel for device {indptr.device}")
    from g2vec_tpu_torch.ops.packed_matmul import _launch

    nbytes = (n_genes + 7) // 8
    n = starts.shape[0]
    # Every byte of a row is written by its walker's group.
    out = torch.empty((n, nbytes), dtype=torch.uint8, device=indptr.device)
    if n:
        plan = walk_plan(n_genes, _max_degree(indptr)
                         if max_degree is None else max_degree)
        _launch(_lib().g2v_walk_device, indptr, indices, weights, starts,
                stream_ids, n, len_path, seed, out, nbytes,
                int(plan.group == GROUPS[1]), int(plan.shared),
                _counter(indptr.device))
        device_walk.launches += 1
    return out


device_walk.launches = 0


# ---------------------------------------------------------------------------
# The resumable walk: explicit walk states over an availability-masked CSR
# (the edge partition's; the reference's advance_walk_states_device, :375).
# ---------------------------------------------------------------------------

def _u64_of_halves(h: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(hi, lo) 32-bit halves -> the uint64 bits as int64, with no op that
    overflows int64 (hi is taken as signed first)."""
    h = torch.where(h >= 2 ** 31, h - 2 ** 32, h)
    return h * 2 ** 32 + lo


def walk_states_plain(indptr: torch.Tensor, indices: torch.Tensor,
                      weights: torch.Tensor, avail: torch.Tensor,
                      cur: torch.Tensor, rng: torch.Tensor, pos: torch.Tensor,
                      paths: torch.Tensor, len_path: int) -> torch.Tensor:
    """The plain version of :func:`device_walk_states`: the reference's
    lock-step advance (``run``, :195-275) on the halves of each walker's
    stream. ``cur``/``rng``/``pos``/``paths`` are updated in place; returns
    the [n] uint8 status. Every walker takes one step a trip: a full path
    stops, an unavailable gene suspends, a row with no eligible slot ends
    the walk; only a walker that draws moves its stream."""
    dev = indptr.device
    n = cur.shape[0]
    deg = indptr[1:] - indptr[:-1]
    d_slots = _pow2(max(1, int(deg.max())) if deg.numel() else 1)
    slots = torch.arange(d_slots, device=dev)
    idx_pad = torch.cat([indices.long(),
                         torch.zeros(d_slots, dtype=torch.int64, device=dev)])
    w_pad = torch.cat([weights, torch.zeros(d_slots, dtype=weights.dtype,
                                            device=dev)])
    ptr = indptr.long()
    held = avail != 0
    sh, sl = (rng >> 32) & _M32, rng & _M32
    c, p, walked = cur.long(), pos.long(), paths.long()
    lanes = torch.arange(len_path, device=dev)
    susp = torch.zeros(n, dtype=torch.bool, device=dev)
    dead = torch.zeros(n, dtype=torch.bool, device=dev)
    for _ in range(len_path):
        live = ~susp & ~dead & (p < len_path)
        if not bool(live.any()):
            break
        here = held[c]
        susp = susp | (live & ~here)
        active = live & here
        off = ptr[c]
        cols = off[:, None] + slots
        cand = idx_pad[cols]
        wrow = w_pad[cols]
        # The visited test replays the prefix; -1 after it matches no gene.
        seen = (walked[:, :, None] == cand[:, None, :]).any(dim=1)
        elig = (slots < (ptr[c + 1] - off)[:, None]) & ~seen & (wrow > 0.0)
        mass = torch.where(elig, wrow.double(), 0.0)
        total = torch.zeros(n, dtype=torch.float64, device=dev)
        cum = []
        for j in range(d_slots):
            total = total + mass[:, j]
            cum.append(total)
        cum = torch.stack(cum, dim=1)
        m = elig.sum(dim=1)
        dead_now = active & ((m == 0) | (total <= 0.0))
        draw = active & ~dead_now
        nsh, nsl, zh, zl = splitmix64_lanes(sh, sl)
        sh, sl = torch.where(draw, nsh, sh), torch.where(draw, nsl, sl)
        target = uniform01_lanes(zh, zl) * total
        j = torch.minimum((elig & (cum <= target[:, None])).sum(dim=1),
                          (m - 1).clamp(min=0))
        sel = elig & ((elig.long().cumsum(dim=1) - 1) == j[:, None])
        nxt = torch.where(sel, cand, 0).sum(dim=1)
        walked = torch.where(draw[:, None] & (lanes == p[:, None]),
                             nxt[:, None], walked)
        p = p + draw.long()
        c = torch.where(draw, nxt, c)
        dead = dead | dead_now
    cur.copy_(c)
    rng.copy_(_u64_of_halves(sh, sl))
    pos.copy_(p)
    paths.copy_(walked)
    return susp.to(torch.uint8)


def _check_states(indptr, indices, weights, avail, cur, rng, pos, paths,
                  len_path) -> None:
    want = ((indptr, torch.int32, "indptr"), (indices, torch.int32, "indices"),
            (weights, torch.float32, "weights"), (avail, torch.uint8, "avail"),
            (cur, torch.int32, "cur"), (rng, torch.int64, "rng"),
            (pos, torch.int32, "pos"))
    for t, dtype, name in want:
        if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D {dtype} "
                             f"tensor, got {t.dtype} {tuple(t.shape)}")
        if t.device != indptr.device:
            raise ValueError(f"{name} on {t.device}, indptr on "
                             f"{indptr.device}")
    if len_path < 1:
        raise ValueError(f"len_path must be >= 1, got {len_path}")
    n = cur.shape[0]
    if paths.dtype != torch.int32 or tuple(paths.shape) != (n, len_path) \
            or not paths.is_contiguous() or paths.device != indptr.device:
        raise ValueError(f"paths must be a contiguous int32 [{n}, "
                         f"{len_path}] tensor on {indptr.device}, got "
                         f"{paths.dtype} {tuple(paths.shape)}")
    if rng.shape != cur.shape or pos.shape != cur.shape:
        raise ValueError(f"cur, rng and pos must have one entry a walker, "
                         f"got {cur.shape[0]}, {rng.shape[0]}, "
                         f"{pos.shape[0]}")
    if weights.shape != indices.shape:
        raise ValueError(f"weights has {weights.shape[0]} entries for "
                         f"{indices.shape[0]} edges")
    if avail.shape[0] != indptr.shape[0] - 1:
        raise ValueError(f"avail has {avail.shape[0]} entries for "
                         f"{indptr.shape[0] - 1} genes")


def device_walk_states(indptr: torch.Tensor, indices: torch.Tensor,
                       weights: torch.Tensor, avail: torch.Tensor,
                       cur: torch.Tensor, rng: torch.Tensor,
                       pos: torch.Tensor, paths: torch.Tensor,
                       len_path: int, *,
                       max_degree: Optional[int] = None) -> torch.Tensor:
    """Advance walk states in place over an availability-masked CSR ->
    [n] uint8 status (0 finished, 1 suspended) on the tensors' device.
    ``rng`` holds each walker's raw splitmix64 state as int64 bits. The
    CSR must be valid, ``cur`` in [0, G) and ``pos`` in [1, len_path]:
    :func:`advance_walk_states_device` checks them on the host. A CUDA
    tensor launches ``g2v_walk_states_kernel`` with the lanes of
    :func:`group_for` (``max_degree`` as in :func:`device_walk`), a CPU
    tensor takes :func:`walk_states_plain`."""
    _check_states(indptr, indices, weights, avail, cur, rng, pos, paths,
                  len_path)
    if indptr.device.type == "cpu":
        return walk_states_plain(indptr, indices, weights, avail, cur, rng,
                                 pos, paths, len_path)
    if indptr.device.type != "cuda":
        raise ValueError(f"no kernel for device {indptr.device}")
    from g2vec_tpu_torch.ops.packed_matmul import _launch

    n = cur.shape[0]
    status = torch.empty(n, dtype=torch.uint8, device=indptr.device)
    if n:
        group = group_for(_max_degree(indptr)
                          if max_degree is None else max_degree)
        _launch(_lib().g2v_walk_states_device, indptr, indices, weights,
                avail, cur, rng, pos, paths, status, n, len_path,
                int(group == GROUPS[1]), _counter(indptr.device))
        device_walk_states.launches += 1
    return status


device_walk_states.launches = 0


def reset_launch_counts() -> None:
    device_walk.launches = 0
    device_walk_states.launches = 0


# ---------------------------------------------------------------------------
# The entry points (numpy in, numpy out, the CSR uploaded once per group).
# ---------------------------------------------------------------------------

class DeviceCSR(NamedTuple):
    """A group's CSR on the walk device."""

    indptr: torch.Tensor     # [G+1] int32
    indices: torch.Tensor    # [E] int32
    weights: torch.Tensor    # [E] float32
    n_genes: int
    max_degree: int          # the largest out-degree (for the launch plan)


def upload_csr(csr, n_genes: int, device="cuda") -> DeviceCSR:
    """Check a host CSR (:func:`~g2vec_tpu_torch.ops.host_walker.
    edges_to_csr`) as the C++ binding does, and copy it to ``device``."""
    dev = resolve_device(device)
    indptr = np.ascontiguousarray(csr[0], dtype=np.int32)
    indices = np.ascontiguousarray(csr[1], dtype=np.int32)
    weights = np.ascontiguousarray(csr[2], dtype=np.float32)
    if indptr.shape[0] != n_genes + 1:
        raise ValueError(f"indptr has {indptr.shape[0]} entries for "
                         f"{n_genes} genes (want n_genes+1)")
    if weights.shape[0] != indices.shape[0]:
        raise ValueError(f"weights has {weights.shape[0]} entries for "
                         f"{indices.shape[0]} edges")
    if indices.size and (indices.min() < 0 or indices.max() >= n_genes):
        raise ValueError(f"indices contains node ids outside [0, {n_genes})")
    if indptr[0] != 0 or indptr[-1] != indices.shape[0] \
            or np.any(np.diff(indptr) < 0):
        raise ValueError("indptr is not a valid CSR row-pointer array")
    return DeviceCSR(*(torch.from_numpy(a).to(dev)
                       for a in (indptr, indices, weights)), n_genes,
                     int(np.diff(indptr).max(initial=0)))


def _group_csr(src, dst, w, n_genes: int, csr, device) -> DeviceCSR:
    if isinstance(csr, DeviceCSR):
        if csr.n_genes != n_genes:
            raise ValueError(f"csr holds {csr.n_genes} genes, not {n_genes}")
        return csr
    if csr is None:
        src, dst = np.asarray(src), np.asarray(dst)
        for name, arr in (("src", src), ("dst", dst)):
            if arr.size and (arr.min() < 0 or arr.max() >= n_genes):
                raise ValueError(
                    f"{name} contains node ids outside [0, {n_genes})")
        csr = edges_to_csr(src, dst, np.asarray(w), n_genes)
    return upload_csr(csr, n_genes, device)


def _walk(csr: DeviceCSR, starts: np.ndarray, stream_ids: np.ndarray,
          len_path: int, seed: int) -> torch.Tensor:
    starts = np.ascontiguousarray(starts, dtype=np.int32)
    if starts.size and (starts.min() < 0 or starts.max() >= csr.n_genes):
        raise ValueError(
            f"starts contains node ids outside [0, {csr.n_genes})")
    dev = csr.indptr.device
    ids = np.ascontiguousarray(stream_ids, dtype=np.uint64).view(np.int64)
    return device_walk(csr.indptr, csr.indices, csr.weights,
                       torch.from_numpy(starts).to(dev),
                       torch.from_numpy(ids).to(dev), len_path, seed,
                       csr.n_genes, max_degree=csr.max_degree)


def _shard_init(plan: ShardPlan, shard: int,
                starts: Optional[np.ndarray] = None):
    """Shard ``shard``'s walkers -> (start genes int32, stream ids uint64)
    in ``walk_shard``'s order: rep-major, each walker keyed by its global
    index on the flat (rep x start) axis."""
    lo, hi = plan.start_range(shard)
    sub = (np.arange(lo, hi, dtype=np.int32) if starts is None
           else np.ascontiguousarray(starts[lo:hi], dtype=np.int32))
    wids = (np.arange(plan.reps, dtype=np.uint64)[:, None]
            * np.uint64(plan.n_starts)
            + np.arange(lo, hi, dtype=np.uint64)[None, :]).ravel()
    return np.tile(sub, plan.reps), wids


def walk_shard_device_arrays(src, dst, w, n_genes: int, plan: ShardPlan,
                             shard: int, *, seed: int, csr=None,
                             starts: Optional[np.ndarray] = None,
                             device="cuda") -> Tuple[torch.Tensor, int]:
    """One group's rows of shard ``shard`` walked on ``device`` ->
    ``(packed [rows, ceil(G/8)] uint8 on the device, rows)``, byte for
    byte :func:`~g2vec_tpu_torch.ops.host_walker.walk_shard`'s. ``csr`` is
    the group's host CSR or its :class:`DeviceCSR` (uploaded once per
    run by the caller)."""
    if starts is not None and len(starts) != plan.n_starts:
        raise ValueError(
            f"plan.n_starts ({plan.n_starts}) must match len(starts) "
            f"({len(starts)})")
    csr = _group_csr(src, dst, w, n_genes, csr, device)
    start_col, wids = _shard_init(plan, shard, starts)
    # The fault seam between the state init and the launch: the walk is a
    # function of (plan, shard, seed), so a caller's relaunch after a
    # fault here gives the same rows.
    fault_point("device_walk", epoch=shard)
    packed = _walk(csr, start_col, wids, plan.len_path, seed)
    return packed, packed.shape[0]


def walk_shard_device(src, dst, w, n_genes: int, plan: ShardPlan,
                      shard: int, *, seed: int, n_threads: int = 0,
                      csr=None, starts: Optional[np.ndarray] = None,
                      device="cuda") -> np.ndarray:
    """:func:`~g2vec_tpu_torch.ops.host_walker.walk_shard` on ``device``
    (``n_threads`` is accepted for the same signature and ignored): the
    same rows, byte for byte, in one device-to-host copy."""
    packed, _ = walk_shard_device_arrays(src, dst, w, n_genes, plan, shard,
                                         seed=seed, csr=csr, starts=starts,
                                         device=device)
    return packed.cpu().numpy()


def walk_packed_rows_device(src, dst, w, n_genes: int, *, len_path: int,
                            reps: int, seed: int,
                            starts: Optional[np.ndarray] = None,
                            walker_lo: int = 0,
                            walker_hi: Optional[int] = None, csr=None,
                            device="cuda") -> np.ndarray:
    """Walks of the global walker range ``[walker_lo, walker_hi)`` of the
    flat (rep x start) axis on ``device`` -> packed rows, byte-identical
    to the C++ sampler's for the same walkers."""
    if len_path < 1:
        raise ValueError(f"len_path must be >= 1, got {len_path}")
    starts = (np.arange(n_genes, dtype=np.int32) if starts is None
              else np.asarray(starts, dtype=np.int32))
    total = starts.shape[0] * reps
    walker_hi = total if walker_hi is None else walker_hi
    if not 0 <= walker_lo <= walker_hi <= total:
        raise ValueError(
            f"walker range [{walker_lo}, {walker_hi}) outside [0, {total}]")
    csr = _group_csr(src, dst, w, n_genes, csr, device)
    packed = _walk(csr, np.tile(starts, reps)[walker_lo:walker_hi],
                   np.arange(walker_lo, walker_hi, dtype=np.uint64),
                   len_path, seed)
    return packed.cpu().numpy()


def generate_path_set_device(src, dst, w, n_genes: int, *, len_path: int,
                             reps: int, seed: int,
                             starts: Optional[np.ndarray] = None, csr=None,
                             device="cuda") -> Set[bytes]:
    """All-sources x reps walks on ``device`` -> the set of packed rows:
    :func:`~g2vec_tpu_torch.ops.host_walker.generate_path_set_native`'s
    set, byte for byte."""
    packed = walk_packed_rows_device(src, dst, w, n_genes, len_path=len_path,
                                     reps=reps, seed=seed, starts=starts,
                                     csr=csr, device=device)
    return {row.tobytes() for row in packed}


def advance_walk_states_device(states, csr, n_genes: int, avail: np.ndarray,
                               len_path: int, n_threads: int = 0,
                               device="cuda") -> np.ndarray:
    """:func:`~g2vec_tpu_torch.ops.host_walker.advance_walk_states` on
    ``device``: advance every walk of the
    :class:`~g2vec_tpu_torch.ops.host_walker.WalkStateBatch` in place over
    an availability-masked CSR until it finishes or suspends; returns the
    [M] uint8 status (0 finished, 1 suspended). Bitwise the C++ advance for
    the same states, the frozen stream of a suspended or dead-ended walker
    included. ``csr`` is a host CSR or a :class:`DeviceCSR` on ``device``.
    ``n_threads`` is ignored (a group of card lanes owns one walker); it is
    accepted so that a call written for the C++ advance, or for the JAX
    package's ``advance_walk_states_device``, which takes it too, runs
    here with its arguments unchanged."""
    if len_path < 1:
        raise ValueError(f"len_path must be >= 1, got {len_path}")
    csr = _group_csr(None, None, None, n_genes, csr, device)
    dev = csr.indptr.device
    avail = np.ascontiguousarray(avail, dtype=np.uint8)
    if avail.shape != (n_genes,):
        raise ValueError(
            f"avail has {avail.shape[0]} entries for {n_genes} genes")
    check_walk_states(states.cur, states.rng, states.pos, states.paths,
                      n_genes, len_path)
    t = {name: torch.from_numpy(arr).to(dev).clone() for name, arr in (
        ("cur", states.cur), ("rng", states.rng.view(np.int64)),
        ("pos", states.pos), ("paths", states.paths))}
    status = device_walk_states(
        csr.indptr, csr.indices, csr.weights,
        torch.from_numpy(avail).to(dev), t["cur"], t["rng"], t["pos"],
        t["paths"], len_path, max_degree=csr.max_degree)
    states.cur[:] = t["cur"].cpu().numpy()
    states.rng.view(np.int64)[:] = t["rng"].cpu().numpy()
    states.pos[:] = t["pos"].cpu().numpy()
    states.paths[:] = t["paths"].cpu().numpy()
    return status.cpu().numpy()
