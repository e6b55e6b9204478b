"""The device walker's launch plan and the hub graphs, on the CPU.

- The plain walk (what a CPU tensor runs, and what the card's kernels are
  held to) is byte-equal to the port's C++ walker and to ``g2vec_tpu``'s
  C++ walker on hub graphs: rows of out-degree 1, 7, 8, 9, 15, 16, 17,
  31, 32, 33, 257 and 1,000 (the edges of the kernels' lane groups and
  rows many chunks wide), with duplicate edges, zero and negative weights and dead
  ends, at ``len_path`` 1, 2 and 80.
- ``walk_states_plain`` is bitwise the C++ advance on the same graphs
  under a mask that holds half the genes, then over the other half and
  back until every walk ends; the finished paths pack to the one-shot
  walk's rows.
- The launch plan (``walk_plan``, ``group_for``): 8 lanes a walker where
  every row fits 8 slots, else 16 (rows wider than that are chunked);
  the masks of a block's walkers go to shared memory exactly where they
  fit the 232,448 bytes a block may use, and to the rows above that; the
  plan's constants are the kernel source's.
"""
import re

import numpy as np
import pytest
import torch

from g2vec_tpu.ops import host_walker as jhw
from g2vec_tpu_torch.native.walker_bindings import (init_walk_state,
                                                    walk_paths_packed)
from g2vec_tpu_torch.ops import device_walker as dw
from g2vec_tpu_torch.ops import host_walker as thw
from walk_graphs import HUB_DEGREES, hub_graph

pytestmark = pytest.mark.torch

G_HUB = 300


def _hub_case(max_hub, seed):
    """A hub graph whose hubs are those of HUB_DEGREES up to ``max_hub``,
    its host CSR, and the starts: every hub and 40 other genes."""
    degrees = tuple(d for d in HUB_DEGREES if d <= max_hub)
    src, dst, w = hub_graph(G_HUB, degrees, seed)
    csr = thw.edges_to_csr(src, dst, w, G_HUB)
    rng = np.random.default_rng(seed)
    others = rng.choice(np.arange(len(degrees), G_HUB), 40, replace=False)
    starts = np.concatenate([np.arange(len(degrees)),
                             np.sort(others)]).astype(np.int32)
    return (src, dst, w), csr, starts, len(degrees)


# ---------------------------------------------------------------------------
# The hub graphs: the plain walk and advance against the C++ walkers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("len_path", [1, 2, 80])
@pytest.mark.parametrize("max_hub", HUB_DEGREES)
def test_plain_walk_on_hub_graphs_matches_both_cpp_walkers(max_hub,
                                                           len_path):
    (src, dst, w), csr, starts, n_hubs = _hub_case(max_hub,
                                                   max_hub + len_path)
    assert int(np.diff(csr[0]).max()) == max(max_hub, 3)
    seed = 0xC0FFEE + max_hub
    got = dw.walk_packed_rows_device(src, dst, w, G_HUB, len_path=len_path,
                                     reps=2, seed=seed, starts=starts,
                                     device="cpu")
    ids = np.arange(2 * starts.size, dtype=np.uint64)
    cpp = walk_paths_packed(*csr, G_HUB, np.tile(starts, 2), ids, len_path,
                            seed)
    ref = jhw.walk_packed_rows(src, dst, w, G_HUB, len_path=len_path,
                               reps=2, seed=seed, starts=starts)
    assert got.shape == (2 * starts.size, (G_HUB + 7) // 8)
    assert got.tobytes() == cpp.tobytes() == ref.tobytes()
    if len_path == 80:
        # The walks pass through the hubs, not only start at them.
        hub_visits = np.unpackbits(got, axis=1)[:, :n_hubs].sum()
        assert hub_visits > 2 * n_hubs


@pytest.mark.parametrize("max_hub", HUB_DEGREES)
def test_plain_advance_on_hub_graphs_matches_cpp_under_half_masks(max_hub):
    _, csr, starts, _ = _hub_case(max_hub, 7 * max_hub)
    length, m = 80, starts.size
    ids = np.arange(m, dtype=np.uint64)
    paths = np.full((m, length), -1, np.int32)
    paths[:, 0] = starts
    states = thw.WalkStateBatch(
        row=np.arange(m, dtype=np.int32), cur=starts.copy(),
        rng=init_walk_state(3, ids), pos=np.ones(m, np.int32), paths=paths)
    dev = dw.upload_csr(csr, G_HUB, "cpu")
    avail = (np.arange(G_HUB) < G_HUB // 2).astype(np.uint8)
    todo, advances = np.arange(m), 0
    while todo.size:
        part = states.take(todo)
        native = thw.WalkStateBatch(*(np.copy(getattr(part, f)) for f in (
            "row", "cur", "rng", "pos", "paths")))
        t = [torch.from_numpy(np.ascontiguousarray(a)).clone() for a in (
            part.cur, part.rng.view(np.int64), part.pos, part.paths)]
        status = dw.walk_states_plain(dev.indptr, dev.indices, dev.weights,
                                      torch.from_numpy(avail), *t,
                                      length).numpy()
        want = thw.advance_walk_states(native, csr, G_HUB, avail, length)
        np.testing.assert_array_equal(status, want)
        for f, got in zip(("cur", "rng", "pos", "paths"), t):
            got = got.numpy()
            np.testing.assert_array_equal(
                got.view(np.uint64) if f == "rng" else got,
                getattr(native, f))
            getattr(states, f)[todo] = getattr(native, f)
        todo = todo[status == 1]
        avail = 1 - avail
        advances += 1
    assert advances >= 2
    want = walk_paths_packed(*csr, G_HUB, starts, ids, length, 3)
    assert thw.pack_finished_paths(states.paths, G_HUB).tobytes() == \
        want.tobytes()


# ---------------------------------------------------------------------------
# The launch plan
# ---------------------------------------------------------------------------

def test_plan_constants_match_the_kernel_source():
    with open(dw.SRC) as f:
        src = f.read()

    def constexpr(name):
        return int(re.search(rf"^constexpr int(?:64_t)? {name} = (\d+);",
                             src, re.M)[1])

    assert (constexpr("kNarrow"), constexpr("kWide")) == dw.GROUPS
    assert constexpr("kThreads") == dw.BLOCK_THREADS
    assert constexpr("kSmemLimit") == dw.SMEM_LIMIT
    assert constexpr("kAlign") == dw.SMEM_ALIGN


@pytest.mark.parametrize("degree", [0, 1, 4, 5, 7, 8, 9, 16, 17, 31, 32, 33,
                                    257, 419, 1000])
def test_plan_group_covers_the_widest_row_or_chunks(degree):
    """8 lanes where every row fits them, else 16: a row of up to 16
    slots is one chunk of the wide group, a wider one is chunked."""
    group = dw.group_for(degree)
    assert group == (8 if degree <= 8 else 16)
    for plan in (dw.walk_plan(5_850, degree), dw.walk_plan(262_144, degree)):
        assert plan.group == group
        assert plan.group >= degree or plan.group == dw.GROUPS[-1]


def _most_shared(group):
    """The most genes whose masks a block of ``group``-lane walkers holds
    in shared memory (58,112 for 8 lanes: 32 masks of 7,264 bytes fill
    232,448 bytes; 116,224 for 16 lanes)."""
    walks = dw.BLOCK_THREADS // group
    return 8 * (dw.SMEM_LIMIT // walks // dw.SMEM_ALIGN * dw.SMEM_ALIGN)


@pytest.mark.parametrize("n_genes", [1, 7, 8, 9, 1003, 5_850, 20_000,
                                     58_112, 58_113, 100_000, 116_224,
                                     116_225, 262_144, 1_000_000])
def test_plan_never_asks_for_more_shared_memory_than_a_block_has(n_genes):
    for degree in (1, 7, 8, 9, 419):
        plan = dw.walk_plan(n_genes, degree)
        walks = dw.BLOCK_THREADS // plan.group
        assert 0 <= plan.smem_bytes <= dw.SMEM_LIMIT
        assert plan.stride % dw.SMEM_ALIGN == 0
        assert 0 <= plan.stride - (n_genes + 7) // 8 < dw.SMEM_ALIGN
        assert plan.shared == (walks * plan.stride <= dw.SMEM_LIMIT)
        assert plan.smem_bytes == (walks * plan.stride if plan.shared
                                   else 0)
        # The masks leave shared memory exactly above the most a block
        # holds.
        assert plan.shared == (n_genes <= _most_shared(plan.group))
    if n_genes == 5_850:
        assert dw.walk_plan(n_genes, 7) == dw.WalkPlan(8, True, 736,
                                                       32 * 736)
    if n_genes in (58_112, 116_224):
        assert dw.walk_plan(n_genes, 1 if n_genes == 58_112 else 9
                            ).smem_bytes == dw.SMEM_LIMIT


def test_device_csr_carries_the_largest_out_degree():
    _, csr, _, _ = _hub_case(1000, 5)
    dev = dw.upload_csr(csr, G_HUB, "cpu")
    assert dev.max_degree == 1000 == dw._max_degree(dev.indptr)
    empty = dw.upload_csr((np.zeros(4, np.int32), np.zeros(0, np.int32),
                           np.zeros(0, np.float32)), 3, "cpu")
    assert empty.max_degree == 0 == dw._max_degree(empty.indptr)


def test_cpu_tensors_walk_the_plain_version_whatever_the_plan():
    """A CPU tensor takes the plain version under every plan: 8 and 16
    lanes, masks in shared memory and in the rows; no kernel is
    launched."""
    dw.reset_launch_counts()
    seen = set()
    for g, max_hub in ((G_HUB, 7), (G_HUB, 33), (58_113, 7), (116_225, 33)):
        degrees = tuple(d for d in HUB_DEGREES if d <= max_hub)
        csr = thw.edges_to_csr(*hub_graph(g, degrees, 9), g)
        starts = np.arange(0, g, g // 40, dtype=np.int32)
        dev = dw.upload_csr(csr, g, "cpu")
        plan = dw.walk_plan(g, dev.max_degree)
        seen.add((plan.group, plan.shared))
        args = (dev.indptr, dev.indices, dev.weights,
                torch.from_numpy(starts),
                torch.arange(starts.size, dtype=torch.int64), 20, 4, g)
        got = dw.device_walk(*args, max_degree=dev.max_degree)
        want = walk_paths_packed(*csr, g, starts,
                                 np.arange(starts.size, dtype=np.uint64), 20,
                                 4)
        assert got.numpy().tobytes() == want.tobytes()
    assert seen == {(8, True), (16, True), (8, False), (16, False)}
    assert dw.device_walk.launches == 0
