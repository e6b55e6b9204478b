"""The port's single-process side of scale-out against the JAX package.

- ``ShardSpec`` byte and gene ranges, ``shard_owner`` and ``subset_starts``
  are exactly ``g2vec_tpu.parallel.shard``'s over a grid of (G, R,
  graph_shards), and the validation errors say the same things.
- ``hostcomm``'s chunked transport over a real ``TCPStore``: round trips
  at the chunk boundary, an empty and a many-chunk payload, and a get whose
  deadline names the owner that never published.
- The split step's four functions against ``g2vec_tpu.train.shard``'s
  ``make_split_fns`` on numpy inputs, at f32 and at bf16 (the kernels'
  plain versions against XLA's bf16 dot): rtol 1e-5, with an absolute
  term of 1e-6 for elements that cancel to near zero (the f32 sums run in
  another order); the split init is a slice of the unsharded draw with
  zero pad rows.
- ``kmeans_sharded`` over an in-process 2-way row split (two threads,
  rank-order collectives) with ``centers0`` injected, against the JAX
  package's ``_lloyd`` on the whole matrix, rtol 1e-5; stages 5-6 over a
  2-way gene split against the port's unsplit ``find_lgroups``/
  ``biomarker_scores`` (L-groups exact, scores rtol 1e-6).
- ``write_vectors`` is the JAX package's writer byte for byte, its numpy
  formatter and its Python fallback alike, and ``write_vectors_sharded``
  writes the same bytes from rank slices.
- End to end on ``--device cpu`` at tests/test_shard.py's spec: one rank
  with ``--graph-shards 1 --embed-shards 1``, and ``--walk-starts`` >= G,
  write the plain run's bytes; ``--walk-starts G/2`` walks fewer paths.
- The config's refusals are the JAX package's messages.
"""
import io
import itertools
import threading

import numpy as np
import pytest
import torch

from g2vec_tpu.parallel import shard as jshard
from g2vec_tpu_torch.parallel import distributed, hostcomm
from g2vec_tpu_torch.parallel import shard

pytestmark = pytest.mark.torch


# ---------------------------------------------------------------------------
# Partitioning arithmetic
# ---------------------------------------------------------------------------

GRID = [(64, 2, 2), (100, 3, 5), (1000, 4, 4), (9999, 7, 3),
        (1 << 20, 4, 8), (20_000, 2, 2), (262_144, 2, 2), (61, 1, 1)]


@pytest.mark.parametrize("n_genes,n_ranks,graph_shards", GRID)
def test_shard_spec_is_the_reference_arithmetic(n_genes, n_ranks,
                                                graph_shards):
    rows = np.random.default_rng(0).integers(
        0, 256, size=(3, (n_genes + 7) // 8), dtype=np.uint8)
    for r in range(n_ranks):
        kw = dict(rank=r, n_ranks=n_ranks, n_genes=n_genes,
                  graph_shards=graph_shards, embed_shards=n_ranks)
        got, want = shard.ShardSpec(**kw), jshard.ShardSpec(**kw)
        assert got.n_bytes == want.n_bytes
        assert [got.byte_range(q) for q in range(n_ranks)] == \
            [want.byte_range(q) for q in range(n_ranks)]
        assert [got.gene_range(q) for q in range(n_ranks)] == \
            [want.gene_range(q) for q in range(n_ranks)]
        assert (got.lo, got.hi, got.g_local, got.embed_split) == \
            (want.lo, want.hi, want.g_local, want.embed_split)
        np.testing.assert_array_equal(got.slice_packed(rows),
                                      want.slice_packed(rows))
        for n_shards in (1, 7, 23, 64):
            assert [got.shard_owner(si, n_shards) for si in range(n_shards)] \
                == [want.shard_owner(si, n_shards) for si in range(n_shards)]
    # The ranges tile [0, G) and every rank has work.
    specs = [shard.ShardSpec(rank=r, n_ranks=n_ranks, n_genes=n_genes,
                             embed_shards=n_ranks) for r in range(n_ranks)]
    assert sum(s.g_local for s in specs) == n_genes
    assert specs[0].lo == 0 and specs[-1].hi == n_genes


@pytest.mark.parametrize("n_genes,walk_starts", [
    (1000, 0), (1000, 1000), (1000, 2000), (1000, 100), (22, 7),
    (20_000, 4096), (262_144, 2048), (61, 30), (5, 4)])
def test_subset_starts_is_the_reference(n_genes, walk_starts):
    got = shard.subset_starts(n_genes, walk_starts)
    want = jshard.subset_starts(n_genes, walk_starts)
    if want is None:
        assert got is None
    else:
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [
    dict(rank=2, n_ranks=2, n_genes=100),
    dict(rank=0, n_ranks=2, n_genes=100, embed_shards=3),
    dict(rank=0, n_ranks=4, n_genes=16, embed_shards=4)])
def test_shard_spec_validation_is_the_reference(kw):
    with pytest.raises(ValueError) as want:
        jshard.ShardSpec(**kw)
    with pytest.raises(ValueError) as got:
        shard.ShardSpec(**kw)
    assert str(got.value) == str(want.value)


def test_shard_context_off_and_single_rank_passthrough():
    assert shard.make_shard_context(0, 0, 100) is None
    ctx = shard.make_shard_context(1, 1, 100, deadline=5.0)
    assert ctx.single and ctx.spec.byte_range() == (0, 13)
    assert not ctx.spec.embed_split and ctx.deadline == 5.0
    a = np.arange(6.0)
    np.testing.assert_array_equal(ctx.allreduce("x", a), a)
    np.testing.assert_array_equal(ctx.gather_concat("y", a), a)
    np.testing.assert_array_equal(ctx.broadcast_array("z", a), a)
    with pytest.raises(ValueError, match="rank-0 array is None"):
        ctx.broadcast_array("z", None)


# ---------------------------------------------------------------------------
# The store transport
# ---------------------------------------------------------------------------

@pytest.fixture
def store():
    import datetime

    from torch.distributed import TCPStore

    return TCPStore("127.0.0.1", 0, 1, True,
                    timeout=datetime.timedelta(seconds=30),
                    wait_for_workers=False)


@pytest.mark.parametrize("size_delta", [-1, 0, 1])
def test_chunked_roundtrip_at_chunk_boundary(store, size_delta):
    cb = 1024
    payload = (bytes(range(256)) * 8)[:cb + size_delta]
    n = hostcomm.put_bytes_chunked("t/x", payload, client=store,
                                   chunk_bytes=cb)
    assert n == (2 if size_delta == 1 else 1)
    assert store.get("t/x/n") == str(n).encode()
    assert hostcomm.get_bytes_chunked("t/x", client=store) == payload


def test_chunked_roundtrip_empty_and_multichunk(store):
    hostcomm.put_bytes_chunked("t/empty", b"", client=store, chunk_bytes=8)
    assert hostcomm.get_bytes_chunked("t/empty", client=store) == b""
    big = np.random.default_rng(1).bytes(5 * 1000 + 17)
    assert hostcomm.put_bytes_chunked("t/big", big, client=store,
                                      chunk_bytes=1000) == 6
    assert hostcomm.get_bytes_chunked("t/big", client=store) == big
    with pytest.raises(ValueError, match="chunk_bytes"):
        hostcomm.put_bytes_chunked("t/bad", b"x", client=store,
                                   chunk_bytes=0)


def test_chunked_get_deadline_names_the_owner(store):
    with pytest.raises(hostcomm.PeerTimeoutError,
                       match=r"missing rank\(s\): \[3\]") as e:
        hostcomm.get_bytes_chunked("t/absent", client=store, deadline=0.2,
                                   owner=3)
    assert e.value.suspects == (3,) and isinstance(e.value, RuntimeError)


def test_single_process_collectives_pass_through():
    assert distributed.process_count() == 1 and distributed.is_coordinator()
    assert hostcomm.allgather_bytes("a", b"x") == [b"x"]
    assert hostcomm.broadcast_bytes("b", b"y") == b"y"
    assert hostcomm.exchange_bytes("c", b"z", 0) == b"z"
    np.testing.assert_array_equal(
        distributed.host_allgather("d", np.arange(3)), [[0, 1, 2]])
    with pytest.raises(RuntimeError, match="initialize"):
        hostcomm.put_bytes_chunked("k", b"")


def test_initialize_without_a_coordinator_runs_single_and_says_so(
        monkeypatch, capsys):
    for name in ("G2VEC_COORDINATOR", "G2VEC_PROCESS_ID",
                 "G2VEC_NUM_PROCESSES"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(distributed, "_world", None)
    distributed.initialize()
    try:
        assert "SINGLE process" in capsys.readouterr().err
        assert distributed.process_info()["process_count"] == 1
        events = distributed.drain_pending_events()
        assert [e["event"] for e in events] == ["single_process_fallback"]
        assert distributed.drain_pending_events() == []
    finally:
        distributed.shutdown()
    assert not distributed.initialized()


def test_initialize_reads_the_environment_and_hosts_the_store(monkeypatch):
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("G2VEC_COORDINATOR", f"127.0.0.1:{port}")
    monkeypatch.setenv("G2VEC_PROCESS_ID", "0")
    monkeypatch.setenv("G2VEC_NUM_PROCESSES", "2")
    monkeypatch.setattr(distributed, "_world", None)
    # A fresh collective sequence: the join's barrier is collective 0.
    monkeypatch.setattr(hostcomm, "_seq", itertools.count())
    monkeypatch.setattr(hostcomm, "_own_keys", [])
    # Rank 1 joins from a thread through its own connection.
    peer = threading.Thread(target=_join_as_rank_1, args=(port,))
    peer.start()
    distributed.initialize(process_id=0)     # the argument wins over env
    try:
        peer.join(timeout=30)
        assert distributed.process_index() == 0
        assert distributed.process_count() == 2
        assert distributed.thread_store() is distributed._world.store
    finally:
        monkeypatch.setattr(distributed, "_world", None)


def _join_as_rank_1(port):
    import datetime

    from torch.distributed import TCPStore

    store = TCPStore("127.0.0.1", port, 2, False,
                     timeout=datetime.timedelta(seconds=30),
                     wait_for_workers=False)
    # Rank 1's half of the join barrier: an empty payload, framed inline.
    store.set("g2vec/ag/0/barrier/initialize/1", b"\x00")
    store.wait(["g2vec/ag/0/barrier/initialize/0"])


# ---------------------------------------------------------------------------
# The split step
# ---------------------------------------------------------------------------

def _split_inputs(seed, rows=37, n_genes=61, hidden=12, rank=1, n_ranks=2):
    rng = np.random.default_rng(seed)
    spec = shard.ShardSpec(rank=rank, n_ranks=n_ranks, n_genes=n_genes,
                           embed_shards=n_ranks)
    dense = rng.random((rows, n_genes)) < 0.2
    packed = np.packbits(dense, axis=1)
    blo, bhi = spec.byte_range()
    g_pad = (bhi - blo) * 8
    w_ih = np.zeros((g_pad, hidden), np.float32)
    w_ih[:spec.g_local] = rng.standard_normal((spec.g_local, hidden)) * 0.3
    w_ho = (rng.standard_normal((hidden, 1)) * 0.3).astype(np.float32)
    y = (rng.random((rows, 1)) < 0.5).astype(np.float32)
    w = (rng.random((rows, 1)) < 0.8).astype(np.float32)
    w[0] = 1.0
    h = (rng.standard_normal((rows, hidden)) * 0.5).astype(np.float32)
    return spec, spec.slice_packed(packed), g_pad, w_ih, w_ho, y, w, h


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 1])
def test_split_step_is_the_reference(dtype, seed):
    import jax.numpy as jnp

    from g2vec_tpu.train.shard import make_split_fns as jmake
    from g2vec_tpu_torch.ops.packed_matmul import padded_row_bytes
    from g2vec_tpu_torch.train.shard import make_split_fns

    spec, p_local, g_pad, w_ih, w_ho, y, w, h = _split_inputs(seed)
    jf = jmake(jnp.float32 if dtype == "float32" else jnp.bfloat16, 0.6)
    tf = make_split_fns(dtype, 0.6, g_pad)
    # The trainer stages a rank's rows padded to the kernels' stride.
    p_pad = np.zeros((p_local.shape[0], padded_row_bytes(g_pad)), np.uint8)
    p_pad[:, :p_local.shape[1]] = p_local
    tol = dict(rtol=1e-5, atol=1e-6)

    def close(got, want):
        np.testing.assert_allclose(np.asarray(got, np.float32),
                                   np.asarray(want, np.float32), **tol)

    want_h = jf.partial_hidden(jnp.asarray(w_ih), jnp.asarray(p_local))
    for p in (p_local, p_pad):
        close(tf.partial_hidden(torch.from_numpy(w_ih),
                                torch.from_numpy(p)), want_h)
    loss, dw_ho, dh = tf.head_grads(*map(torch.from_numpy, (w_ho, h, y, w)))
    jloss, jdw_ho, jdh = jf.head_grads(*map(jnp.asarray, (w_ho, h, y, w)))
    close(loss, jloss)
    close(dw_ho, jdw_ho)
    close(dh, jdh)
    want_dw = jf.embed_grad(jnp.asarray(p_local), jnp.asarray(h))
    for p in (p_local, p_pad):
        got = tf.embed_grad(torch.from_numpy(p), torch.from_numpy(h))
        assert tuple(got.shape) == (g_pad, h.shape[1])
        close(got, want_dw)
    close(tf.head_eval(*map(torch.from_numpy, (w_ho, h, y, w))),
          jf.head_eval(*map(jnp.asarray, (w_ho, h, y, w))))


def test_split_init_is_a_slice_of_the_unsharded_draw():
    from g2vec_tpu_torch.models.cbow import init_params
    from g2vec_tpu_torch.train.shard import init_split_params, split_params

    full = init_params(61, 9, torch.Generator().manual_seed(4))
    for rank in (0, 1):
        spec = shard.ShardSpec(rank=rank, n_ranks=2, n_genes=61,
                               embed_shards=2)
        part = init_split_params(61, 9, spec,
                                 torch.Generator().manual_seed(4))
        blo, bhi = spec.byte_range()
        assert tuple(part.w_ih.shape) == ((bhi - blo) * 8, 9)
        assert torch.equal(part.w_ih[:spec.g_local],
                           full.w_ih[spec.lo:spec.hi])
        assert not part.w_ih[spec.g_local:].any()
        assert torch.equal(part.w_ho, full.w_ho)
        assert torch.equal(split_params(full, spec).w_ih, part.w_ih)


# ---------------------------------------------------------------------------
# Stages 5-6 over a split, two ranks on threads
# ---------------------------------------------------------------------------

class _ThreadComm:
    """Rank-order collectives between in-process ranks on threads."""

    def __init__(self, n: int):
        self.n = n
        self.slots = {}
        self.seq = [0] * n
        self.cv = threading.Condition()

    def allgather(self, rank: int, arr):
        with self.cv:
            key = self.seq[rank]
            self.seq[rank] += 1
            self.slots[(key, rank)] = np.array(arr, copy=True)
            self.cv.notify_all()
            self.cv.wait_for(lambda: all((key, r) in self.slots
                                         for r in range(self.n)), timeout=60)
            return [self.slots[(key, r)] for r in range(self.n)]


class _ThreadCtx:
    """The part of a ``ShardContext`` stages 5-6 use, for one thread-rank."""

    def __init__(self, comm: _ThreadComm, spec):
        self.comm, self.spec, self.deadline = comm, spec, None

    def allreduce(self, name, arr, op="sum"):
        parts = self.comm.allgather(self.spec.rank, np.asarray(arr))
        fold = {"sum": np.add, "min": np.minimum, "max": np.maximum}[op]
        acc = parts[0]
        for p in parts[1:]:
            acc = fold(acc, p)
        return acc

    def gather_concat(self, name, arr, axis=0):
        return np.concatenate(self.comm.allgather(self.spec.rank, arr),
                              axis=axis)


def _on_ranks(n_ranks, fn):
    """``fn(rank)`` on one thread a rank; returns the results in order."""
    out, errors = [None] * n_ranks, []

    def run(r):
        try:
            out[r] = fn(r)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(r,))
               for r in range(n_ranks)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    if errors:
        raise errors[0]
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kmeans_sharded_is_the_reference_lloyd(seed):
    import jax.numpy as jnp

    from g2vec_tpu.ops.kmeans import _lloyd
    from g2vec_tpu_torch.ops.kmeans import kmeans_sharded

    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.standard_normal((20, 6)) + 3.0,
                        rng.standard_normal((17, 6)) - 2.0,
                        rng.standard_normal((13, 6))]).astype(np.float32)
    rng.shuffle(x)
    centers0 = x[rng.choice(len(x), size=(4, 3))].astype(np.float32)
    cut = 27
    comm = _ThreadComm(2)

    def rank(r):
        ctx = _ThreadCtx(comm, shard.ShardSpec(rank=r, n_ranks=2,
                                               n_genes=64, embed_shards=2))
        part = x[:cut] if r == 0 else x[cut:]
        return kmeans_sharded(torch.from_numpy(part), 3,
                              generator=torch.Generator().manual_seed(0),
                              allreduce=ctx.allreduce,
                              gather=ctx.gather_concat, n_init=4, iters=12,
                              centers0=torch.from_numpy(centers0))

    (l0, c0, i0), (l1, c1, i1) = _on_ranks(2, rank)
    assert torch.equal(c0, c1) and i0 == i1
    runs = [_lloyd(jnp.asarray(x), jnp.asarray(c), 12) for c in centers0]
    best = int(np.argmin([float(inertia) for _, inertia in runs]))
    want_c = np.asarray(runs[best][0])
    np.testing.assert_allclose(c0.numpy(), want_c, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(i0, float(runs[best][1]), rtol=1e-5)
    d2 = ((x[:, None, :] - want_c[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(torch.cat([l0, l1]).numpy(),
                                  d2.argmin(axis=1))


def test_kmeans_sharded_seeds_the_same_centres_on_every_rank():
    from g2vec_tpu_torch.ops.kmeans import kmeans_sharded

    x = np.random.default_rng(3).standard_normal((40, 5)).astype(np.float32)
    comm = _ThreadComm(2)

    def rank(r):
        ctx = _ThreadCtx(comm, shard.ShardSpec(rank=r, n_ranks=2,
                                               n_genes=64, embed_shards=2))
        return kmeans_sharded(torch.from_numpy(x[r * 20:(r + 1) * 20]), 3,
                              generator=torch.Generator().manual_seed(7),
                              allreduce=ctx.allreduce,
                              gather=ctx.gather_concat, n_init=3, iters=5)

    (_, c0, i0), (_, c1, i1) = _on_ranks(2, rank)
    assert torch.equal(c0, c1) and i0 == i1


def test_stages_5_6_over_a_split_are_the_unsplit_ones():
    from g2vec_tpu_torch.analysis import (biomarker_scores,
                                          biomarker_scores_sharded,
                                          find_lgroups, find_lgroups_sharded)

    rng = np.random.default_rng(5)
    n_genes, hidden = 70, 8
    emb = np.concatenate([rng.standard_normal((30, hidden)) * 0.1,
                          rng.standard_normal((20, hidden)) + 2.0,
                          rng.standard_normal((20, hidden)) - 2.0]
                         ).astype(np.float32)
    perm = rng.permutation(n_genes)
    emb = emb[perm]
    freq = np.where(perm < 30, 2, np.where(perm < 50, 0, 1)).astype(np.int32)
    expr = rng.standard_normal((15, n_genes)).astype(np.float32)
    labels = np.array([0] * 8 + [1] * 7)
    centers0 = emb[rng.choice(n_genes, size=(3, 3))]
    want_lg, _ = find_lgroups(torch.from_numpy(emb), freq,
                              generator=torch.Generator().manual_seed(0),
                              iters=20, n_init=3,
                              centers0=torch.from_numpy(centers0))
    want = biomarker_scores(torch.from_numpy(emb),
                            torch.from_numpy(expr[labels == 0]),
                            torch.from_numpy(expr[labels == 1]), want_lg)
    comm = _ThreadComm(2)

    def rank(r):
        spec = shard.ShardSpec(rank=r, n_ranks=2, n_genes=n_genes,
                               embed_shards=2)
        ctx = _ThreadCtx(comm, spec)
        e = torch.from_numpy(emb[spec.lo:spec.hi])
        lg = find_lgroups_sharded(
            e, freq[spec.lo:spec.hi], ctx,
            generator=torch.Generator().manual_seed(0), iters=20, n_init=3,
            centers0=torch.from_numpy(centers0))
        ex = expr[:, spec.lo:spec.hi]
        sc = biomarker_scores_sharded(e, torch.from_numpy(ex[labels == 0]),
                                      torch.from_numpy(ex[labels == 1]), lg,
                                      ctx)
        return lg, sc

    (lg0, sc0), (lg1, sc1) = _on_ranks(2, rank)
    lg = torch.cat([lg0, lg1])
    assert torch.equal(lg, want_lg)
    scores = torch.cat([sc0, sc1], dim=1)
    for group in (0, 1):
        mask = lg == group
        np.testing.assert_allclose(scores[group][mask].numpy(),
                                   want[group][mask].numpy(), rtol=1e-6)


# ---------------------------------------------------------------------------
# The vectors file
# ---------------------------------------------------------------------------

def _tricky_vectors(rng, rows, hidden):
    v = (rng.standard_normal((rows, hidden))
         * np.exp(rng.uniform(-20, 2, (rows, hidden)))).astype(np.float32)
    ties = (np.arange(rows * hidden) % 2560 - 1280) / 128.0
    v[::3] = ties.reshape(rows, hidden)[::3]
    v[1, :4] = [-0.0, 5e-7, -5e-7, 9.9999995]
    return v


@pytest.mark.parametrize("case", ["numpy", "fallback"])
def test_write_vectors_is_the_reference_bytes(case, tmp_path):
    from g2vec_tpu.io.writers import write_vectors as jwrite
    from g2vec_tpu_torch.io.writers import write_vectors

    rng = np.random.default_rng(0)
    v = _tricky_vectors(rng, 5000, 12)
    genes = [f"SG{i:07d}" for i in range(5000)]
    if case == "fallback":
        # Values past 10 (one past int64 once scaled) and a non-ASCII gene
        # send their chunks to the Python formatter.
        v[4100, 3] = 12345.678
        v[4500, 0] = -1e30
        genes[10] = "GÉNE"
    got = open(write_vectors(str(tmp_path / "p"), v, genes), "rb").read()
    want = open(jwrite(str(tmp_path / "j"), v, genes), "rb").read()
    assert got == want


def test_write_vectors_sharded_writes_the_unsplit_bytes(
        store, monkeypatch, tmp_path):
    from g2vec_tpu_torch.io.writers import (write_vectors,
                                            write_vectors_sharded)

    v = _tricky_vectors(np.random.default_rng(2), 61, 7)
    genes = [f"G{i}" for i in range(61)]
    specs = [shard.ShardSpec(rank=r, n_ranks=2, n_genes=61, embed_shards=2)
             for r in range(2)]
    # Rank 1 published its slice; this process is rank 0 of two.
    buf = io.BytesIO()
    np.save(buf, v[specs[1].lo:specs[1].hi], allow_pickle=False)
    hostcomm.put_bytes_chunked("g2vec/xc/vectors/1", buf.getvalue(),
                               client=store)
    monkeypatch.setattr(distributed, "_world", distributed._World(
        0, 2, "127.0.0.1", store.port, store))
    got = write_vectors_sharded(str(tmp_path / "sh"),
                                v[specs[0].lo:specs[0].hi], genes,
                                shard.ShardContext(specs[0], deadline=10))
    want = write_vectors(str(tmp_path / "plain"), v, genes)
    assert open(got, "rb").read() == open(want, "rb").read()


# ---------------------------------------------------------------------------
# One rank, end to end on the CPU (tests/test_shard.py's spec)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def shard_tsv(tmp_path_factory):
    from g2vec_tpu_torch.data.synthetic import (SyntheticSpec,
                                                write_synthetic_tsv)

    spec = SyntheticSpec(
        n_good=30, n_poor=26, module_size=16, shared_module_size=6,
        n_background=24, n_expr_only=4, n_net_only=4, module_chords=3,
        background_edges=40, noise=0.25, shift=1.4, seed=7)
    return write_synthetic_tsv(spec,
                               str(tmp_path_factory.mktemp("shard_data")))


def _run(paths, out, **over):
    from g2vec_tpu_torch.config import G2VecConfig
    from g2vec_tpu_torch.pipeline import run

    base = dict(
        expression_file=paths["expression"], clinical_file=paths["clinical"],
        network_file=paths["network"], result_name=out, lenPath=20,
        numRepetition=4, sizeHiddenlayer=32, epoch=8, numBiomarker=10,
        seed=11, compute_dtype="float32", walker_backend="native",
        train_mode="streaming", shard_paths=64, device="cpu")
    base.update(over)
    return run(G2VecConfig(**base), console=lambda s: None)


def _files(result_name):
    return [open(result_name + s, "rb").read()
            for s in ("_biomarkers.txt", "_lgroups.txt", "_vectors.txt")]


def test_single_rank_sharded_and_capless_walk_starts_are_the_plain_bytes(
        shard_tsv, tmp_path):
    ref = _run(shard_tsv, str(tmp_path / "ref"))
    sharded = _run(shard_tsv, str(tmp_path / "sh"), graph_shards=1,
                   embed_shards=1)
    assert _files(str(tmp_path / "sh")) == _files(str(tmp_path / "ref"))
    assert sharded.acc_val == ref.acc_val and sharded.n_paths == ref.n_paths
    _run(shard_tsv, str(tmp_path / "ws"), graph_shards=1, embed_shards=1,
         walk_starts=10 ** 6)
    assert _files(str(tmp_path / "ws")) == _files(str(tmp_path / "ref"))


def test_walk_starts_caps_the_volume_and_completes(shard_tsv, tmp_path):
    ref = _run(shard_tsv, str(tmp_path / "ref"))
    half = _run(shard_tsv, str(tmp_path / "half"),
                walk_starts=ref.n_genes // 2)
    assert 0 < half.n_paths < ref.n_paths
    assert half.stream_stats["rows_sampled"] == \
        2 * (ref.n_genes // 2) * 4
    assert len(half.biomarkers) == len(ref.biomarkers)


# ---------------------------------------------------------------------------
# The config's refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fields", [
    dict(graph_shards=2),
    dict(train_mode="streaming", embed_shards=2, checkpoint_dir="ck"),
    dict(train_mode="streaming", graph_shards=2, supervise=True),
    dict(train_mode="streaming", graph_shards=2, batch_seeds=2),
    dict(train_mode="streaming", embed_shards=2, num_processes=3),
    dict(train_mode="streaming", graph_shards=2, walker_backend="device"),
    dict(train_mode="streaming", distributed=True),
    dict(train_mode="streaming", walk_starts=-1),
    dict(fleet_watchdog_deadline=-1.0),
])
def test_config_refusals_are_the_reference_messages(fields):
    from g2vec_tpu.config import G2VecConfig as JConfig
    from g2vec_tpu_torch.config import G2VecConfig

    with pytest.raises(ValueError) as want:
        JConfig(**fields).validate()
    with pytest.raises(ValueError) as got:
        G2VecConfig(**fields).validate()
    assert str(got.value) == str(want.value)


def test_cli_parses_the_scale_flags():
    from g2vec_tpu_torch.config import build_parser, config_from_args

    cfg = config_from_args(
        ["e", "c", "n", "r", "--train-mode", "streaming", "--walk-starts",
         "4096", "--graph-shards", "2", "--embed-shards", "2",
         "--distributed", "--coordinator", "127.0.0.1:5000",
         "--process-id", "1", "--num-processes", "2",
         "--fleet-watchdog-deadline", "15"])
    assert (cfg.walk_starts, cfg.graph_shards, cfg.embed_shards,
            cfg.distributed, cfg.coordinator, cfg.process_id,
            cfg.num_processes, cfg.fleet_watchdog_deadline) == (
        4096, 2, 2, True, "127.0.0.1:5000", 1, 2, 15.0)
    for flag in ("--edge-partition", "--checkpoint-layout",
                 "--fleet-size"):
        with pytest.raises(SystemExit):
            build_parser().parse_args(["e", "c", "n", "r", flag, "x"])
    # --mesh parses as the reference's does: DATAxMODEL, else ValueError.
    with pytest.raises(ValueError, match="--mesh must look like 4x2"):
        config_from_args(["e", "c", "n", "r", "--mesh", "x"])
