"""The port's edge partition against the JAX package's, on the CPU.

Bitwise on the same numpy-made inputs unless a case says otherwise:

- the partition arithmetic (``edge_range``, ``edge_bounds``,
  ``owners_of``) and ``build_partitioned_csr`` with its guards;
- ``shard_walk_states`` over plans and ``--walk-starts`` subsets;
- the resumable walk: the port's C++ ``advance_walk_states`` and the
  plain version of the card's ``advance_walk_states_device`` against the
  reference's ``advance_walk_states``, advance after advance until no
  walker is suspended, and against the reference's own
  ``advance_walk_states_device`` (its ``_x64`` imports
  ``jax.experimental.enable_x64``, which this jax no longer has; the test
  swaps in ``jax.enable_x64(True)`` with ``monkeypatch``, a test-only
  oracle);
- ``tests/test_edge.py`` section 3's four boundary cases, and
  ``run_edge_walk`` over 1-3 ranks (threads over a local exchange): handoff
  == halo == ``walk_shard`` == the reference's ``run_edge_walk``;
  ``build_halo_csr`` against the reference's; the ``walk_handoff`` and
  ``halo_build`` seams fire where they stand;
- the range readers and the partition manifest (a corrupt part is caught;
  the ``G2VEC_FORBID_FULL_NETWORK`` pin), ``write_synth_graph_streamed``
  and ``make_synth_graph --partitions``: the reference's bytes;
- the config's refusals: the reference's messages;
- a one-rank ``--edge-partition handoff|halo`` run on ``--device cpu``
  under the pin writes the plain streaming run's bytes.

The two-process runs and the SIGKILL drills are in
``tests/test_torch_edge_fleet.py``.
"""
import copy
import json
import os
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

import g2vec_tpu.ops.device_walker as jdw
from g2vec_tpu.ops import host_walker as jhw
from g2vec_tpu.parallel import shard as jshard
from g2vec_tpu_torch.ops import device_walker as dw
from g2vec_tpu_torch.ops import host_walker as thw
from g2vec_tpu_torch.parallel import shard as tshard

pytestmark = pytest.mark.torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("row", "cur", "rng", "pos", "paths")


def _graph(rng, g, e, zero=0.1, dead=0.15):
    """A directed graph with self-loops dropped, zero weights (never
    eligible), duplicate edges and genes without out-edges."""
    src = rng.integers(0, g, e).astype(np.int32)
    dst = rng.integers(0, g, e).astype(np.int32)
    w = rng.random(e, dtype=np.float32)
    extra = rng.integers(0, e, e // 10)
    src, dst, w = (np.concatenate([a, a[extra]]) for a in (src, dst, w))
    w[rng.random(w.shape[0]) < zero] = 0.0
    keep = (src != dst) & ~(rng.random(g) < dead)[src]
    return src[keep], dst[keep], w[keep]


def _same_states(a, b):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)


# ---------------------------------------------------------------------------
# The partition arithmetic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_genes,n_ranks", [(2, 2), (100, 3), (1000, 4),
                                             (9999, 7), (1 << 20, 4)])
def test_edge_ranges_tile_the_genes_as_the_reference_does(n_genes, n_ranks):
    bounds = tshard.edge_bounds(n_ranks, n_genes)
    np.testing.assert_array_equal(bounds, jshard.edge_bounds(n_ranks,
                                                             n_genes))
    ranges = [tshard.edge_range(r, n_ranks, n_genes) for r in range(n_ranks)]
    assert ranges == [jshard.edge_range(r, n_ranks, n_genes)
                      for r in range(n_ranks)]
    assert [lo for lo, _ in ranges] == list(bounds)
    assert ranges[0][0] == 0 and ranges[-1][1] == n_genes
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    genes = np.random.default_rng(n_genes).integers(0, n_genes, 500)
    owners = tshard.owners_of(genes, bounds)
    np.testing.assert_array_equal(owners, jshard.owners_of(genes, bounds))
    for r, (lo, hi) in enumerate(ranges):
        assert (owners[(genes >= lo) & (genes < hi)] == r).all()
    with pytest.raises(ValueError, match="rank"):
        tshard.edge_range(n_ranks, n_ranks, n_genes)


@pytest.mark.parametrize("case", ["ok", "src_outside", "dst_outside"])
def test_build_partitioned_csr_and_its_guards(case):
    src = np.array([2, 3, 3], np.int32)
    dst = np.array([0, 5, 1], np.int32)
    w = np.array([1.0, 0.5, 2.0], np.float32)
    lo, hi = (2, 4) if case != "src_outside" else (3, 4)
    if case == "dst_outside":
        dst = np.array([0, 9, 1], np.int32)
    if case != "ok":
        with pytest.raises(ValueError) as got:
            tshard.build_partitioned_csr(src, dst, w, 8, lo, hi)
        with pytest.raises(ValueError) as want:
            jshard.build_partitioned_csr(src, dst, w, 8, lo, hi)
        assert str(got.value) == str(want.value)
        return
    p = tshard.build_partitioned_csr(src, dst, w, 8, lo, hi)
    q = jshard.build_partitioned_csr(src, dst, w, 8, lo, hi)
    for f in ("indptr", "indices", "weights", "avail", "halo_genes"):
        np.testing.assert_array_equal(getattr(p, f), getattr(q, f))
    assert (p.owned_edges, p.halo_edges, p.csr_bytes, p.halo_bytes,
            p.halo_overhead_ratio) == (q.owned_edges, q.halo_edges,
                                       q.csr_bytes, q.halo_bytes,
                                       q.halo_overhead_ratio)
    assert p.avail[2:4].all() and not p.avail[:2].any() \
        and not p.avail[4:].any()


# ---------------------------------------------------------------------------
# Walk states and the resumable advance
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_starts,reps,shard_paths,subset", [
    (23, 4, 40, False), (23, 4, 40, True), (50, 1, 0, False),
    (7, 3, 1000, True)])
def test_shard_walk_states_are_the_reference_states(n_starts, reps,
                                                    shard_paths, subset):
    starts = (np.sort(np.random.default_rng(n_starts).choice(
        200, n_starts, replace=False)).astype(np.int32) if subset else None)
    plan = thw.plan_shards(n_starts, reps, shard_paths, len_path=6)
    jplan = jhw.plan_shards(n_starts, reps, shard_paths, len_path=6)
    for s in range(plan.n_shards):
        got = thw.shard_walk_states(plan, s, seed=5, starts=starts)
        _same_states(got, jhw.shard_walk_states(jplan, s, seed=5,
                                                starts=starts))
        assert len(got) == plan.group_rows(s)
    with pytest.raises(ValueError, match="must match len"):
        thw.shard_walk_states(plan, 0, seed=5,
                              starts=np.arange(n_starts + 1))


def _resume_to_the_end(advance, states, csr, g, avail, length):
    """Advance ``states`` over ``avail``, then the suspended ones over the
    complement, and back, until none is suspended; returns every
    advance's (status, states) and the final states."""
    todo = np.arange(len(states))
    rounds = []
    while todo.size:
        part = states.take(todo)
        status = advance(part, csr, g, avail, length)
        rounds.append((status.copy(), copy.deepcopy(part)))
        for f in FIELDS[1:]:
            getattr(states, f)[todo] = getattr(part, f)
        todo = todo[status == 1]
        avail = 1 - avail
    return rounds, states


@pytest.mark.parametrize("trial", range(5))
def test_advance_walk_states_match_the_reference(trial):
    rng = np.random.default_rng(40 + trial)
    g = int(rng.integers(6, 120))
    src, dst, w = _graph(rng, g, int(rng.integers(0, 6 * g)))
    length = (1, 2, 12, 30, 7)[trial]
    csr = thw.edges_to_csr(src, dst, w, g)
    plan = thw.plan_shards(g, 3, 0, len_path=length)
    avail = (rng.random(g) < 0.5).astype(np.uint8)
    seed = int(rng.integers(0, 2 ** 63))
    runs = {}
    for name, advance in (
            ("port", thw.advance_walk_states),
            ("plain", lambda *a: dw.advance_walk_states_device(
                *a, device="cpu")),
            ("reference", jhw.advance_walk_states)):
        states = thw.shard_walk_states(plan, 0, seed=seed)
        runs[name] = _resume_to_the_end(advance, states, csr, g,
                                        avail.copy(), length)
    want_rounds, want = runs["reference"]
    for name in ("port", "plain"):
        rounds, got = runs[name]
        assert len(rounds) == len(want_rounds)
        for (st, part), (wst, wpart) in zip(rounds, want_rounds):
            np.testing.assert_array_equal(st, wst)
            _same_states(part, wpart)
        _same_states(got, want)
    rows = thw.pack_finished_paths(want.paths, g)
    ref = thw.walk_shard(src, dst, w, g, plan, 0, seed=seed, csr=csr)
    assert rows.tobytes() == ref.tobytes()
    assert rows.tobytes() == jhw.pack_finished_paths(want.paths,
                                                     g).tobytes()


def test_plain_advance_matches_the_reference_device_advance(monkeypatch):
    monkeypatch.setattr(jdw, "_x64", lambda: jax.enable_x64(True))
    rng = np.random.default_rng(71)
    g, length = 50, 10
    csr = thw.edges_to_csr(*_graph(rng, g, 260), g)
    plan = thw.plan_shards(g, 2, 0, len_path=length)
    avail = (rng.random(g) < 0.6).astype(np.uint8)
    got = thw.shard_walk_states(plan, 0, seed=3)
    want = copy.deepcopy(got)
    st = dw.advance_walk_states_device(got, csr, g, avail, length,
                                       device="cpu")
    wst = jdw.advance_walk_states_device(want, csr, g, avail, length)
    np.testing.assert_array_equal(st, wst)
    _same_states(got, want)
    assert st.any() and not st.all()


def test_frozen_streams_and_the_length_gate():
    """A walker whose path is full finishes on an unavailable gene; one
    that suspends or dead-ends keeps its stream word."""
    g = 4
    csr = thw.edges_to_csr(np.array([0, 1], np.int32),
                           np.array([1, 2], np.int32),
                           np.ones(2, np.float32), g)
    states = thw.WalkStateBatch(
        row=np.arange(3, dtype=np.int32),
        cur=np.array([3, 2, 0], np.int32),
        rng=np.array([11, 22, 33], np.uint64),
        pos=np.array([2, 1, 1], np.int32),
        paths=np.array([[0, 3], [2, -1], [0, -1]], np.int32))
    avail = np.array([1, 1, 0, 0], np.uint8)   # 2 and 3 are not held
    plain = copy.deepcopy(states)
    st = thw.advance_walk_states(states, csr, g, avail, 2)
    np.testing.assert_array_equal(st, [0, 1, 0])
    np.testing.assert_array_equal(states.rng[:2], [11, 22])
    assert states.rng[2] != 33 and states.pos[2] == 2
    np.testing.assert_array_equal(
        dw.advance_walk_states_device(plain, csr, g, avail, 2,
                                      device="cpu"), st)
    _same_states(plain, states)


# ---------------------------------------------------------------------------
# The wrapper of the resumable walk kernel
# ---------------------------------------------------------------------------

def _state_tensors(g=12, length=5, seed=2):
    rng = np.random.default_rng(seed)
    csr = dw.upload_csr(thw.edges_to_csr(*_graph(rng, g, 50), g), g, "cpu")
    states = thw.shard_walk_states(thw.plan_shards(g, 2, 0, len_path=length),
                                   0, seed=seed)
    avail = torch.from_numpy((rng.random(g) < 0.5).astype(np.uint8))
    return (csr.indptr, csr.indices, csr.weights, avail,
            torch.from_numpy(states.cur), torch.from_numpy(
                states.rng.view(np.int64)), torch.from_numpy(states.pos),
            torch.from_numpy(states.paths), length)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    args = _state_tensors()
    want = [a.clone() for a in args[4:8]]
    dw.reset_launch_counts()
    status = dw.device_walk_states(*args)
    assert dw.device_walk_states.launches == 0
    assert status.dtype == torch.uint8 and status.shape == args[4].shape
    want_status = dw.walk_states_plain(*args[:4], *want, args[8])
    assert torch.equal(status, want_status)
    for got, w in zip(args[4:8], want):
        assert torch.equal(got, w)


@pytest.mark.parametrize("bad", ["meta", "dtype", "paths", "avail",
                                 "length"])
def test_states_wrapper_refuses_what_it_cannot_walk(bad):
    args = list(_state_tensors())
    if bad == "meta":
        args = [a.to("meta") if isinstance(a, torch.Tensor) else a
                for a in args]
        match = "no kernel"
    elif bad == "dtype":
        args[5] = args[5].to(torch.int32)
        match = "rng"
    elif bad == "paths":
        args[7] = args[7][:, :-1].contiguous()
        match = "paths"
    elif bad == "avail":
        args[3] = args[3][:-1]
        match = "avail"
    else:
        args[8] = 0
        match = "len_path"
    with pytest.raises(ValueError, match=match):
        dw.device_walk_states(*args)


def test_advance_device_checks_its_states_as_the_binding_does():
    g = 10
    csr = thw.edges_to_csr(np.array([0], np.int32), np.array([1], np.int32),
                           np.ones(1, np.float32), g)
    states = thw.shard_walk_states(thw.plan_shards(g, 1, 0, len_path=4), 0,
                                   seed=1)
    for mutate, match in ((lambda s: s.pos.__setitem__(0, 0), "pos"),
                          (lambda s: s.cur.__setitem__(0, g), "cur")):
        bad = copy.deepcopy(states)
        mutate(bad)
        with pytest.raises(ValueError, match=match):
            dw.advance_walk_states_device(bad, csr, g, np.ones(g, np.uint8),
                                          4, device="cpu")
        with pytest.raises(ValueError, match=match):
            thw.advance_walk_states(bad, csr, g, np.ones(g, np.uint8), 4)
    with pytest.raises(ValueError, match="avail"):
        dw.advance_walk_states_device(states, csr, g, np.ones(3, np.uint8),
                                      4, device="cpu")


# ---------------------------------------------------------------------------
# The collective walk, ranks as threads over a local exchange
# ---------------------------------------------------------------------------

class _LocalExchange:
    """``exchange_bytes`` in one process: a dict and a condition; a missed
    deadline raises ``error`` naming the owner, as the transports do."""

    def __init__(self, error):
        self.store, self.cv, self.error = {}, threading.Condition(), error

    def __call__(self, key, payload, owner, deadline=None, chunk_bytes=None):
        if payload is not None:
            with self.cv:
                self.store[key] = payload
                self.cv.notify_all()
            return payload
        t_end = time.monotonic() + (deadline or 30.0)
        with self.cv:
            while key not in self.store:
                left = t_end - time.monotonic()
                if left <= 0:
                    raise self.error(
                        f"local get {key!r} timed out; missing rank(s): "
                        f"[{owner}]", collective=key, suspects=(owner,))
                self.cv.wait(left)
            return self.store[key]


def _port_error():
    from g2vec_tpu_torch.parallel.hostcomm import PeerTimeoutError

    return PeerTimeoutError


def _reference_error():
    from g2vec_tpu.resilience.fleet import PeerTimeoutError

    return PeerTimeoutError


def _threads(n, fn):
    out, errs = [None] * n, []

    def worker(r):
        try:
            out[r] = fn(r)
        except Exception as e:  # noqa: BLE001 — re-raised below
            errs.append(e)

    ts = [threading.Thread(target=worker, args=(r,)) for r in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    if errs:
        raise errs[0]
    return out


def _partition(mod, src, dst, w, g, rank, n_ranks):
    lo, hi = mod.edge_range(rank, n_ranks, g)
    m = (src >= lo) & (src < hi)
    return mod.build_partitioned_csr(src[m], dst[m], w[m], g, lo, hi)


def _halos(mod, pcsrs, error):
    ex = _LocalExchange(error)
    return _threads(len(pcsrs), lambda r: mod.build_halo_csr(
        pcsrs[r], rank=r, n_ranks=len(pcsrs), group=0, exchange=ex,
        deadline=20.0))


def _fleet(mod, pcsrs, plan, si, seed, owner, error, *, starts=None,
           stats=None):
    ex = _LocalExchange(error)
    n = len(pcsrs)
    stats = stats or [None] * n
    return _threads(n, lambda r: mod.run_edge_walk(
        pcsrs[r], plan, si, seed=seed, owner=owner, rank=r, n_ranks=n,
        starts=starts, n_threads=1, exchange=ex, deadline=30.0,
        key_prefix=f"t/{seed}", stats=stats[r]))


@pytest.mark.parametrize("n_ranks", [1, 2, 3])
def test_run_edge_walk_handoff_and_halo_are_walk_shard(n_ranks):
    g, length = 160, 12
    src, dst, w = _graph(np.random.default_rng(7), g, 1800)
    plan = thw.plan_shards(g, 3, 64, len_path=length)
    jplan = jhw.plan_shards(g, 3, 64, len_path=length)
    csr = thw.edges_to_csr(src, dst, w, g)
    pcsrs = [_partition(tshard, src, dst, w, g, r, n_ranks)
             for r in range(n_ranks)]
    jpcsrs = [_partition(jshard, src, dst, w, g, r, n_ranks)
              for r in range(n_ranks)]
    halos = _halos(tshard, pcsrs, _port_error())
    for si in range(min(plan.n_shards, 3)):
        ref = thw.walk_shard(src, dst, w, g, plan, si, seed=11, csr=csr)
        owner = si % n_ranks
        for parts in (pcsrs, halos):
            res = _fleet(tshard, parts, plan, si, 11, owner, _port_error())
            assert res[owner].tobytes() == ref.tobytes()
            assert all(res[r] is None for r in range(n_ranks) if r != owner)
        jres = _fleet(jshard, jpcsrs, jplan, si, 11, owner,
                      _reference_error())
        assert jres[owner].tobytes() == ref.tobytes()


@pytest.mark.parametrize("n_ranks", [2, 3])
def test_build_halo_csr_is_the_reference_halo(n_ranks):
    g = 90
    src, dst, w = _graph(np.random.default_rng(n_ranks), g, 700)
    got = _halos(tshard, [_partition(tshard, src, dst, w, g, r, n_ranks)
                          for r in range(n_ranks)], _port_error())
    want = _halos(jshard, [_partition(jshard, src, dst, w, g, r, n_ranks)
                           for r in range(n_ranks)], _reference_error())
    for p, q in zip(got, want):
        for f in ("indptr", "indices", "weights", "avail", "halo_genes"):
            np.testing.assert_array_equal(getattr(p, f), getattr(q, f))
        assert (p.owned_edges, p.halo_edges, p.csr_bytes,
                p.halo_overhead_ratio) == (q.owned_edges, q.halo_edges,
                                           q.csr_bytes,
                                           q.halo_overhead_ratio)
        assert p.halo_bytes == 8 * p.halo_edges and p.avail[
            p.halo_genes].all()
    assert sum(p.halo_edges for p in got) > 0


# tests/test_edge.py section 3: (graph, starts, len_path, seed, the handoff
# counts expected on ranks 0 and 1, and in halo mode).
_BOUNDARY = {
    # The last slot filled by a foreign gene: the walk is done (the length
    # gate comes first), nothing is shipped, one barrier round.
    "last_step_at_boundary": (([0, 1], [1, 0]), 2, [0], 2, 5,
                              dict(sent=(0, 0), batches=0, rounds=1)),
    # Handed to the owner of a dead-end gene, which finishes the walk and
    # sends the row back; rank 1 sends nothing in round 0 but its empty
    # payload must arrive. Halo finishes it locally in one round.
    "dead_end_at_boundary": (([0], [1]), 2, [0], 6, 5,
                             dict(sent=("rows", 0), batches=1, rounds=2,
                                  halo_rounds=1)),
    # Suspended with one slot left: the receiving rank takes one step.
    "one_step_left": (([0, 1, 2], [1, 2, 0]), 3, [0], 3, 9,
                      dict(sent=("rows", 0), batches=1, rounds=2)),
    # Two closed components, every start in rank 0's range: nothing
    # crosses, yet both ranks run one all-pairs round and agree to stop.
    "zero_crossings": (([0, 1, 2, 3], [1, 0, 3, 2]), 4, [0, 1], 5, 13,
                       dict(sent=(0, 0), batches=0, rounds=1, peak=0)),
}


@pytest.mark.parametrize("case", sorted(_BOUNDARY))
def test_boundary_cases_of_the_handoff(case):
    (s, d), g, starts, length, seed, want = _BOUNDARY[case]
    src, dst = np.array(s, np.int32), np.array(d, np.int32)
    w = np.ones(src.size, np.float32)
    starts = np.array(starts, np.int32)
    plan = thw.plan_shards(len(starts), 2, 1024, len_path=length)
    jplan = jhw.plan_shards(len(starts), 2, 1024, len_path=length)
    ref = thw.walk_shard(src, dst, w, g, plan, 0, seed=seed, starts=starts)
    pcsrs = [_partition(tshard, src, dst, w, g, r, 2) for r in range(2)]
    stats = [tshard.EdgeWalkStats() for _ in range(2)]
    res = _fleet(tshard, pcsrs, plan, 0, seed, 0, _port_error(),
                 starts=starts, stats=stats)
    assert res[0].tobytes() == ref.tobytes()
    jstats = [jshard.EdgeWalkStats() for _ in range(2)]
    jres = _fleet(jshard, [_partition(jshard, src, dst, w, g, r, 2)
                           for r in range(2)], jplan, 0, seed, 0,
                  _reference_error(), starts=starts, stats=jstats)
    assert jres[0].tobytes() == ref.tobytes()
    assert [vars(x) for x in stats] == [vars(x) for x in jstats]
    rows = plan.group_rows(0)
    sent = tuple(rows if x == "rows" else x for x in want["sent"])
    assert (stats[0].states_sent, stats[1].states_sent) == sent
    assert stats[0].batches == want["batches"]
    assert stats[0].rounds == stats[1].rounds == want["rounds"]
    if "peak" in want:
        assert stats[0].peak_in_flight == want["peak"]
    halos = _halos(tshard, pcsrs, _port_error())
    hstats = [tshard.EdgeWalkStats() for _ in range(2)]
    hres = _fleet(tshard, halos, plan, 0, seed, 0, _port_error(),
                  starts=starts, stats=hstats)
    assert hres[0].tobytes() == ref.tobytes()
    if "halo_rounds" in want:
        assert hstats[0].rounds == want["halo_rounds"]
        assert hstats[0].states_sent == 0


@pytest.mark.parametrize("seam", ["walk_handoff", "halo_build"])
def test_edge_seams_fire_where_they_stand(seam, monkeypatch):
    """A crash at either seam (``process=1``) raises on rank 1 before it
    publishes what the seam guards; rank 0 waits until its deadline names
    rank 1."""
    from g2vec_tpu_torch.resilience import faults

    g = 20
    src, dst, w = _graph(np.random.default_rng(3), g, 120, dead=0.0)
    pcsrs = [_partition(tshard, src, dst, w, g, r, 2) for r in range(2)]
    plan = thw.plan_shards(g, 2, 0, len_path=6)
    ex = _LocalExchange(_port_error())
    local = threading.local()
    monkeypatch.setattr(faults, "current_rank",
                        lambda: getattr(local, "rank", 0))

    def rank(r):
        local.rank = r
        try:
            if seam == "halo_build":
                return tshard.build_halo_csr(pcsrs[r], rank=r, n_ranks=2,
                                             group=0, exchange=ex,
                                             deadline=1.0)
            return tshard.run_edge_walk(pcsrs[r], plan, 0, seed=1, owner=0,
                                        rank=r, n_ranks=2, exchange=ex,
                                        deadline=1.0)
        except Exception as e:  # noqa: BLE001 — inspected below
            return e

    faults._reset_for_tests()
    faults.install_plan(f"stage={seam},kind=crash,process=1")
    try:
        got = _threads(2, rank)
    finally:
        faults._reset_for_tests()
    assert isinstance(got[1], faults.InjectedFault)
    assert f"seam={seam}" in str(got[1])
    assert isinstance(got[0], _port_error())
    assert "missing rank(s): [1]" in str(got[0])
    assert seam in faults.SEAMS


# ---------------------------------------------------------------------------
# Readers, the manifest and the streamed writer
# ---------------------------------------------------------------------------

def _body(path):
    with open(path, "rb") as f:
        return f.read().split(b"\n", 1)[1]


def _tree(root):
    out = {}
    for name in sorted(os.listdir(root)):
        with open(os.path.join(root, name), "rb") as f:
            out[name] = f.read()
    return out


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """The streamed spec written partitioned and flat by both packages."""
    from g2vec_tpu.data.synth import SynthGraphSpec as JSpec
    from g2vec_tpu.data.synth import (
        write_synth_graph_streamed as jwrite)
    from g2vec_tpu_torch.data.synth import (SynthGraphSpec,
                                            write_synth_graph_streamed)

    root = tmp_path_factory.mktemp("edge_synth")
    kw = dict(n_genes=1200, n_good=4, n_poor=4, seed=3)
    out = {}
    for who, spec, write in (("port", SynthGraphSpec(**kw),
                              write_synth_graph_streamed),
                             ("reference", JSpec(**kw), jwrite)):
        out[who, "part"] = write(spec, str(root / who / "part"), prefix="p",
                                 partitions=3)
        out[who, "flat"] = write(spec, str(root / who / "flat"), prefix="f")
    out["chunked"] = write_synth_graph_streamed(
        SynthGraphSpec(**kw), str(root / "chunked"), prefix="p",
        partitions=3, edge_chunk=777)
    return out


def test_streamed_writer_is_the_reference_writer(written):
    for layout in ("part", "flat"):
        port, ref = written["port", layout], written["reference", layout]
        assert os.path.basename(port["network"]) == \
            os.path.basename(ref["network"])
        assert port["n_edges"] == ref["n_edges"]
        assert _tree(os.path.dirname(port["network"])) == \
            _tree(os.path.dirname(ref["network"]))
    assert _tree(os.path.dirname(written["chunked"]["network"])) == \
        _tree(os.path.dirname(written["port", "part"]["network"]))


def test_parts_concatenate_to_the_flat_file_and_reads_agree(written):
    from g2vec_tpu.io import readers as jreaders
    from g2vec_tpu_torch.io import readers

    man = written["port", "part"]["network"]
    flat = written["port", "flat"]["network"]
    m = readers.read_partition_manifest(man)
    assert m == jreaders.read_partition_manifest(man)
    base = os.path.dirname(man)
    assert b"".join(_body(os.path.join(base, e["name"]))
                    for e in m["files"]) == _body(flat)
    genes = sorted(readers.scan_network_genes(flat))
    assert readers.scan_network_genes(man) == set(genes) == \
        jreaders.scan_network_genes(man)
    g2i = {gn: i for i, gn in enumerate(genes)}
    for lo, hi in ((0, len(genes)), (0, len(genes) // 3),
                   (len(genes) // 3, len(genes)), (5, 5)):
        want = jreaders.load_network_range(flat, g2i, lo, hi)
        for path in (flat, man):
            got = readers.load_network_range(path, g2i, lo, hi)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
                assert a.dtype == np.int32


@pytest.mark.parametrize("damage", ["append", "missing_key"])
def test_a_corrupt_part_or_manifest_is_caught(written, tmp_path, damage):
    import shutil

    from g2vec_tpu_torch.io import readers

    src = os.path.dirname(written["port", "part"]["network"])
    work = tmp_path / "copy"
    shutil.copytree(src, work)
    man = str(work / "p_NETWORK.manifest.json")
    genes = sorted(readers.scan_network_genes(man))
    g2i = {gn: i for i, gn in enumerate(genes)}
    readers.load_network_range(man, g2i, 0, len(genes))
    if damage == "append":
        with open(work / readers.read_partition_manifest(man)["files"][0][
                "name"], "ab") as f:
            f.write(b"SGBOGUS\tSGBOGUS\n")
        with pytest.raises(ValueError, match="sha256"):
            readers.load_network_range(man, g2i, 0, len(genes))
        # A read of the other parts' range does not open the bad one.
        lo = genes.index("SG0000400")
        readers.load_network_range(man, g2i, lo, len(genes))
    else:
        with open(man) as f:
            m = json.load(f)
        del m["files"][1]["sha256"]
        with open(man, "w") as f:
            json.dump(m, f)
        with pytest.raises(ValueError, match="missing 'sha256'"):
            readers.read_partition_manifest(man)


def test_forbid_full_network_pin(tmp_path, monkeypatch):
    from g2vec_tpu.io import readers as jreaders
    from g2vec_tpu_torch.io import readers

    assert readers.FORBID_FULL_NETWORK_ENV == jreaders.FORBID_FULL_NETWORK_ENV
    net = tmp_path / "net.txt"
    net.write_text("src\tdest\nSGA\tSGB\nSGB\tSGC\n\n")
    assert readers.load_network(str(net)).edges == [("SGA", "SGB"),
                                                    ("SGB", "SGC")]
    monkeypatch.setenv(readers.FORBID_FULL_NETWORK_ENV, "1")
    with pytest.raises(RuntimeError) as got:
        readers.load_network(str(net))
    with pytest.raises(RuntimeError) as want:
        jreaders.load_network(str(net))
    assert str(got.value) == str(want.value)
    assert readers.scan_network_genes(str(net)) == {"SGA", "SGB", "SGC"}
    src, dst = readers.load_network_range(str(net), {"SGA": 0, "SGB": 1,
                                                     "SGC": 2}, 0, 2)
    np.testing.assert_array_equal(src, [0, 1])
    np.testing.assert_array_equal(dst, [1, 2])


def test_make_synth_graph_partitions_tool(tmp_path, written):
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "g2vec_tpu_torch.tools.make_synth_graph",
         "--nodes", "1200", "--good", "4", "--poor", "4", "--seed", "3",
         "--partitions", "3", "--out", str(tmp_path), "--prefix", "p"],
        capture_output=True, text=True, env=env, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    summary = json.loads(proc.stdout)
    assert summary["streamed"] is True
    assert summary["network"].endswith(".manifest.json")
    assert _tree(tmp_path) == _tree(os.path.dirname(
        written["port", "part"]["network"]))


# ---------------------------------------------------------------------------
# The config, and one rank through the pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("over", [
    dict(edge_partition="bogus"),
    dict(edge_partition="handoff", train_mode="full"),
    dict(edge_partition="halo", walker_backend="device"),
    dict(edge_partition="handoff", num_processes=2),
    dict(edge_partition="handoff", checkpoint_dir="ck"),
    dict(edge_partition="halo", resume=True, checkpoint_dir="ck"),
    dict(edge_partition="halo"),
])
def test_config_refusals_are_the_reference_messages(over):
    from g2vec_tpu.config import G2VecConfig as JaxConfig
    from g2vec_tpu_torch.config import G2VecConfig, config_from_args

    base = dict(dict(expression_file="e", clinical_file="c",
                     network_file="n", result_name="r",
                     train_mode="streaming", walker_backend="native"),
                **over)
    msgs = []
    for cls in (G2VecConfig, JaxConfig):
        try:
            cls(**base).validate()
            msgs.append(None)
        except ValueError as e:
            msgs.append(str(e))
    assert msgs[0] == msgs[1]
    assert (msgs[0] is None) == (over == dict(edge_partition="halo"))
    cfg = config_from_args(["e", "c", "n", "r", "--edge-partition", "halo",
                            "--train-mode", "streaming"])
    assert cfg.edge_partition == "halo"


@pytest.fixture(scope="module")
def edge_tsv(tmp_path_factory):
    from g2vec_tpu_torch.data.synthetic import (SyntheticSpec,
                                                write_synthetic_tsv)

    spec = SyntheticSpec(
        n_good=30, n_poor=26, module_size=16, shared_module_size=6,
        n_background=24, n_expr_only=4, n_net_only=4, module_chords=3,
        background_edges=40, noise=0.25, shift=1.4, seed=7)
    return write_synthetic_tsv(spec, str(tmp_path_factory.mktemp("edge")))


def _files(result_name):
    out = []
    for suffix in ("_biomarkers.txt", "_lgroups.txt", "_vectors.txt"):
        with open(result_name + suffix, "rb") as f:
            out.append(f.read())
    return out


@pytest.mark.parametrize("mode", ["handoff", "halo"])
def test_one_rank_edge_partition_writes_the_plain_bytes(edge_tsv, tmp_path,
                                                        monkeypatch, mode):
    from g2vec_tpu_torch.config import G2VecConfig
    from g2vec_tpu_torch.io.readers import FORBID_FULL_NETWORK_ENV
    from g2vec_tpu_torch.pipeline import run

    def cfg(out, **over):
        return G2VecConfig(
            expression_file=edge_tsv["expression"],
            clinical_file=edge_tsv["clinical"],
            network_file=edge_tsv["network"], result_name=str(tmp_path / out),
            lenPath=20, numRepetition=4, sizeHiddenlayer=32, epoch=8,
            numBiomarker=10, seed=11, compute_dtype="float32",
            walker_backend="native", train_mode="streaming", shard_paths=64,
            device="cpu", **over)

    ref = run(cfg("ref"), console=lambda s: None)
    monkeypatch.setenv(FORBID_FULL_NETWORK_ENV, "1")
    with pytest.raises(RuntimeError, match="scan_network_genes"):
        run(cfg("pinned"), console=lambda s: None)
    lines = []
    res = run(cfg(mode, edge_partition=mode,
                  metrics_jsonl=str(tmp_path / "m.jsonl")),
              console=lines.append)
    assert _files(str(tmp_path / mode)) == _files(str(tmp_path / "ref"))
    assert (res.acc_val, res.n_paths) == (ref.acc_val, ref.n_paths)
    assert any("edges of this rank's owned gene range" in ln for ln in lines)
    with open(tmp_path / "m.jsonl") as f:
        records = {r["event"]: r for r in map(json.loads, f)}
    e = records["edge_partition"]
    assert (e["mode"], e["rank"], e["n_ranks"], e["gene_lo"],
            e["gene_hi"]) == (mode, 0, 1, 0, ref.n_genes)
    assert e["owned_edges"] > 0
    assert "handoff" not in records
    assert ("halo" in records) == (mode == "halo")
    if mode == "halo":
        assert records["halo"]["halo_edges"] == 0
