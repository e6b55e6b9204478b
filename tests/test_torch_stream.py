"""The port's streaming trainer against ``g2vec_tpu.train.stream``.

- The shard ring's four edges (backpressure, slow producer, producer
  failure, consumer cancel), mirrored from tests/test_stream.py.
- ``plan_shards`` and ``walk_shard`` byte-equal to
  ``g2vec_tpu.ops.host_walker``'s on a small graph; ``_shard_split`` and
  ``_filter_rows`` equal to the reference's on the same shard (the
  reference's ``_filter_rows`` is a closure of its trainer: the test
  builds a function from its code object).
- The spool: a corrupted shard is re-walked and the outputs are the
  unfaulted run's; a re-walk that does not reproduce the bytes raises.
- Bitwise determinism across ``sampler_threads`` in {1, 3} and
  ``prefetch_depth`` in {1, 3}.
- The trainer against ``g2vec_tpu.train.stream.train_cbow_streaming`` at
  float32 (``use_pallas=False`` on the JAX side, the dense path on the
  port's), on the same groups, the port starting from the JAX package's
  own seeded init: the same ``n_paths``, gene votes and stop epoch, equal
  per-epoch accuracies, losses at rtol 1e-5 and W_ih at rtol 1e-5 / atol
  1e-7 (float32 sums in another order, compounded through Adam: the
  tolerance tests/test_torch_trainer.py uses).
"""
import threading
import time
import types

import jax
import numpy as np
import pytest

from g2vec_tpu import preprocess as jprep
from g2vec_tpu.io import readers as jreaders
from g2vec_tpu.models.cbow import init_params as jax_init_params
from g2vec_tpu.ops import graph as jgraph
from g2vec_tpu.ops import host_walker as jwalker
from g2vec_tpu.train import stream as jstream
from g2vec_tpu_torch.data.synthetic import SyntheticSpec, write_synthetic_tsv
from g2vec_tpu_torch.ops import host_walker as twalker
from g2vec_tpu_torch.train import stream as tstream
from g2vec_tpu_torch.weights import params_from_jax

pytestmark = pytest.mark.torch

SPEC = SyntheticSpec(n_good=30, n_poor=26, module_size=16,
                     shared_module_size=6, n_background=24, n_expr_only=4,
                     n_net_only=4, module_chords=3, background_edges=40,
                     noise=0.25, shift=1.4, seed=7)
TRAIN = dict(hidden=16, learning_rate=0.01, max_epochs=12,
             compute_dtype="float32", seed=3, walk_seed=11, len_path=20,
             reps=4, shard_paths=64, patience=4)


# ---------------------------------------------------------------------------
# The ring
# ---------------------------------------------------------------------------

def _shard(i, rows=4, nb=8):
    return tstream.Shard(i, np.full((rows, nb), i % 251, np.uint8),
                         np.zeros(rows, np.int32))


def test_ring_backpressure_bounds_producer():
    ring = tstream.ShardRing(2)

    def produce():
        for i in range(7):
            assert ring.put(_shard(i))
        ring.finish()

    t = threading.Thread(target=produce)
    t.start()
    time.sleep(0.3)                 # let the producer hit the full ring
    got = []
    while True:
        s = ring.get()
        if s is None:
            break
        got.append(s.index)
        time.sleep(0.02)            # slow consumer
    t.join(timeout=5)
    assert not t.is_alive()
    assert got == list(range(7))
    assert ring.occupancy_hw <= 2
    assert ring.peak_bytes <= 2 * _shard(0).nbytes
    assert ring.wait_put_s > 0.1


def test_ring_slow_producer_consumer_waits():
    ring = tstream.ShardRing(4)

    def produce():
        for i in range(3):
            time.sleep(0.05)
            ring.put(_shard(i))
        ring.finish()

    t = threading.Thread(target=produce)
    t.start()
    got = [ring.get().index for _ in range(3)]
    assert ring.get() is None
    t.join(timeout=5)
    assert not t.is_alive()
    assert got == [0, 1, 2]
    assert ring.wait_get_s > 0.05


def test_ring_producer_failure_raises_at_get():
    ring = tstream.ShardRing(2)
    ring.fail(RuntimeError("sampler died"))
    for _ in range(2):
        with pytest.raises(RuntimeError, match="sampler died"):
            ring.get()


def test_ring_cancel_unblocks_blocked_producer():
    ring = tstream.ShardRing(1)
    assert ring.put(_shard(0))
    outcome = {}

    def produce():
        outcome["second_put"] = ring.put(_shard(1))   # blocks: ring full

    t = threading.Thread(target=produce)
    t.start()
    time.sleep(0.2)
    assert t.is_alive()
    ring.cancel()
    t.join(timeout=5)
    assert not t.is_alive()
    assert outcome["second_put"] is False


def test_ring_refuses_depth_zero():
    with pytest.raises(ValueError, match="depth"):
        tstream.ShardRing(0)


# ---------------------------------------------------------------------------
# Shards against the reference
# ---------------------------------------------------------------------------

def _graph(seed=0, n_genes=37, n_edges=120):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_genes, n_edges).astype(np.int32)
    dst = rng.integers(0, n_genes, n_edges).astype(np.int32)
    w = (rng.random(n_edges) + 0.1).astype(np.float32)
    return src, dst, w


@pytest.mark.parametrize("n_genes,reps,shard_paths",
                         [(101, 3, 24), (37, 3, 10), (37, 1, 0), (5, 2, 4)])
def test_plan_shards_matches_reference(n_genes, reps, shard_paths):
    got = twalker.plan_shards(n_genes, reps, shard_paths, len_path=9)
    want = jwalker.plan_shards(n_genes, reps, shard_paths, len_path=9)
    assert (got.n_starts, got.reps, got.starts_per_shard, got.len_path) == \
        (want.n_starts, want.reps, want.starts_per_shard, want.len_path)
    assert (got.n_shards, got.rows_per_shard, got.n_walkers) == \
        (want.n_shards, want.rows_per_shard, want.n_walkers)
    assert [got.group_rows(s) for s in range(got.n_shards)] == \
        [want.group_rows(s) for s in range(want.n_shards)]
    with pytest.raises(ValueError):
        twalker.plan_shards(n_genes, reps, -1, len_path=9)


def test_walk_shard_byte_equal_to_reference_and_full_range():
    src, dst, w = _graph()
    g, reps = 37, 3
    full = twalker.walk_packed_rows(src, dst, w, g, len_path=9, reps=reps,
                                    seed=5)
    plan_t = twalker.plan_shards(g, reps, 10, len_path=9)
    plan_j = jwalker.plan_shards(g, reps, 10, len_path=9)
    csr = twalker.edges_to_csr(src, dst, w, g)
    for s in range(plan_t.n_shards):
        lo, hi = plan_t.start_range(s)
        got = twalker.walk_shard(src, dst, w, g, plan_t, s, seed=5,
                                 n_threads=2, csr=csr)
        np.testing.assert_array_equal(
            got, jwalker.walk_shard(src, dst, w, g, plan_j, s, seed=5,
                                    n_threads=3))
        np.testing.assert_array_equal(
            got, np.concatenate([full[r * g + lo:r * g + hi]
                                 for r in range(reps)]))


def _reference_filter_rows():
    """The reference trainer's ``_filter_rows`` closure, as a function."""
    code = next(c for c in jstream.train_cbow_streaming.__code__.co_consts
                if isinstance(c, types.CodeType)
                and c.co_name == "_filter_rows")
    assert not code.co_freevars
    return types.FunctionType(code, vars(jstream))


def test_shard_split_and_filter_rows_match_reference():
    src, dst, w = _graph(seed=1, n_genes=29, n_edges=40)
    plan = twalker.plan_shards(29, 4, 48, len_path=6)
    ref_filter = _reference_filter_rows()
    for s in range(plan.n_shards):
        x = np.concatenate([twalker.walk_shard(src, dst, w, 29, plan, s,
                                               seed=(9 << 1) | gi)
                            for gi in (0, 1)])
        y = np.repeat(np.array([0, 1], np.int32), plan.group_rows(s))
        keep = tstream._filter_rows(x, y)
        np.testing.assert_array_equal(keep, ref_filter(x, y))
        assert len(keep) < len(y)            # the filter drops something
        for frac in (0.2, 0.5):
            for got, want in zip(tstream._shard_split(len(keep), 3, s, frac),
                                 jstream._shard_split(len(keep), 3, s, frac)):
                np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# The trainer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    files = write_synthetic_tsv(SPEC, str(tmp_path_factory.mktemp("stream")))
    data = jreaders.load_expression(files["expression"])
    data.label = jprep.match_labels(
        jreaders.load_clinical(files["clinical"]), data.sample)
    network = jreaders.load_network(files["network"])
    common = jprep.find_common_genes(network.genes, data.gene)
    network = jprep.restrict_network(network, common)
    data = jprep.restrict_data(data, common)
    src, dst = jprep.edges_to_indices(network, jprep.make_gene2idx(data.gene))
    edges = [tuple(np.asarray(a) for a in jgraph.thresholded_edges(
        data.expr[data.label == i], src, dst, 0.5)) for i in range(2)]
    return dict(groups=edges, n_genes=len(common), genes=data.gene)


def _port_run(groups, **over):
    kw = dict(TRAIN, groups=groups["groups"], n_genes=groups["n_genes"],
              genes=groups["genes"], device="cpu")
    kw.update(over)
    return tstream.train_cbow_streaming(**kw)


@pytest.fixture(scope="module")
def both(groups):
    """The reference streaming run and the port's, from the same init."""
    ref = jstream.train_cbow_streaming(
        groups=groups["groups"], n_genes=groups["n_genes"],
        genes=groups["genes"], use_pallas=False, console=lambda s: None,
        **TRAIN)
    p = jax_init_params(jax.random.key(TRAIN["seed"]), groups["n_genes"],
                        TRAIN["hidden"])
    port = _port_run(groups, init=params_from_jax(np.asarray(p.w_ih),
                                                  np.asarray(p.w_ho)))
    return ref, port


def test_streaming_trainer_matches_jax_at_float32(both):
    ref, port = both
    assert port.n_paths == ref.n_paths
    assert port.gene_freq == ref.gene_freq
    rt, rj = port.train, ref.train
    assert len(rj.history) >= 4              # a real trajectory
    assert (rt.stop_epoch, rt.stopped_early) == (rj.stop_epoch,
                                                 rj.stopped_early)
    assert len(rt.history) == len(rj.history)
    for a, b in zip(rj.history, rt.history):
        assert b["epoch"] == a["epoch"]
        assert (b["acc_val"], b["acc_tr"]) == (a["acc_val"], a["acc_tr"])
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-5)
    assert (rt.acc_val, rt.acc_tr) == (rj.acc_val, rj.acc_tr)
    np.testing.assert_allclose(rt.w_ih, rj.w_ih, rtol=1e-5, atol=1e-7)


def test_stream_stats_match_reference(both):
    ref, port = both
    keys = ("n_shards", "shards_emitted", "n_paths", "rows_sampled",
            "shard_rows", "ring_depth", "rewalks", "epochs")
    got, want = port.stats.as_dict(), ref.stats.as_dict()
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert set(got) <= set(want)
    assert port.stats.ring_occupancy_hw <= port.stats.ring_depth


def _strip(history):
    return [{k: v for k, v in h.items() if k != "secs"} for h in history]


@pytest.fixture(scope="module")
def one_thread_depth_one(groups):
    return _port_run(groups, sampler_threads=1, prefetch_depth=1)


@pytest.mark.parametrize("threads,depth", [(3, 1), (1, 3), (3, 3)])
def test_streaming_is_bitwise_invariant_to_threads_and_depth(
        groups, one_thread_depth_one, threads, depth):
    base = one_thread_depth_one
    res = _port_run(groups, sampler_threads=threads, prefetch_depth=depth)
    assert len(base.train.history) >= 4
    assert _strip(res.train.history) == _strip(base.train.history)
    assert res.train.w_ih.tobytes() == base.train.w_ih.tobytes()
    assert res.gene_freq == base.gene_freq


# ---------------------------------------------------------------------------
# The spool
# ---------------------------------------------------------------------------

def test_spool_corruption_rewalks_and_matches_unfaulted(groups, monkeypatch):
    clean = _port_run(groups, max_epochs=3, patience=3)
    save = tstream.ShardSpool.save

    def save_then_corrupt(self, shard):
        path = save(self, shard)
        if shard.index == 1:
            with open(path, "r+b") as f:
                f.seek(-1, 2)
                byte = f.read(1)
                f.seek(-1, 2)
                f.write(bytes([byte[0] ^ 0xFF]))
        return path

    monkeypatch.setattr(tstream.ShardSpool, "save", save_then_corrupt)
    with pytest.warns(RuntimeWarning, match="re-walking"):
        faulted = _port_run(groups, max_epochs=3, patience=3)
    assert faulted.stats.rewalks >= 1
    assert _strip(faulted.train.history) == _strip(clean.train.history)
    assert faulted.train.w_ih.tobytes() == clean.train.w_ih.tobytes()


def test_spool_rewalk_that_mismatches_raises(tmp_path):
    spool = tstream.ShardSpool(str(tmp_path))
    rows = np.arange(24, dtype=np.uint8).reshape(4, 6)
    path = spool.save(tstream.Shard(0, rows, np.zeros(4, np.int32)))
    np.testing.assert_array_equal(spool.load(0, lambda i: rows), rows)
    assert spool.rewalks == 0
    np.save(path, rows + 1)                  # torn bytes on disk
    np.testing.assert_array_equal(spool.load(0, lambda i: rows), rows)
    assert spool.rewalks == 1
    np.save(path, rows + 1)
    with pytest.raises(tstream.SpoolIntegrityError, match="shard 0"):
        spool.load(0, lambda i: rows + 2)


def test_producer_failure_surfaces_and_leaves_no_thread(groups, monkeypatch):
    def boom(*args, **kwargs):
        raise OSError("sampler died")

    monkeypatch.setattr(tstream, "walk_shard", boom)
    before = threading.active_count()
    with pytest.raises(OSError, match="sampler died"):
        _port_run(groups)
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


# ---------------------------------------------------------------------------
# The device walker and the device feed
# ---------------------------------------------------------------------------

def _small_groups():
    """tests/test_device_walker.py's streaming case: 40 genes, two groups
    of 240 random edges."""
    def grp(seed):
        r = np.random.default_rng(seed)
        return (r.integers(0, 40, 240).astype(np.int32),
                r.integers(0, 40, 240).astype(np.int32),
                r.random(240, dtype=np.float32))
    return dict(groups=[grp(1), grp(2)], n_genes=40,
                genes=np.array([f"g{i}" for i in range(40)]), hidden=8,
                learning_rate=0.05, max_epochs=2, seed=3, walk_seed=5,
                len_path=5, reps=2, shard_paths=48, compute_dtype="float32",
                device="cpu")


def test_device_feed_streaming_byte_identical_zero_ring_puts():
    """The reference's device-feed contract on the port at float32: the
    device walker, which streams through the fused feed, gives W_ih
    byte-identical to the native ring feed; it makes no ring put and
    keeps the training rows' bytes off the host-to-card path."""
    kw = _small_groups()
    ref = tstream.train_cbow_streaming(**kw)
    fused = tstream.train_cbow_streaming(**kw, walker_backend="device")
    assert fused.train.w_ih.tobytes() == ref.train.w_ih.tobytes()
    assert ref.gene_freq == fused.gene_freq
    assert ref.n_paths == fused.n_paths
    assert _strip(fused.train.history) == _strip(ref.train.history)
    assert ref.stats.feed_mode == "ring"
    assert ref.stats.shards_emitted > 0
    assert fused.stats.feed_mode == "device"
    assert fused.stats.shards_emitted == 0
    assert fused.stats.h2d_bytes_saved > 0
    assert fused.stats.sampling_wall_s > 0
    assert fused.stats.device_recomputes == 0
    # The same contract on the reference's own trainer.
    jref = jstream.train_cbow_streaming(
        **{k: v for k, v in kw.items() if k != "device"})
    assert jref.stats.shards_emitted == ref.stats.shards_emitted
    assert jref.gene_freq == fused.gene_freq


def test_device_feed_spool_replays_and_survives_corruption(groups,
                                                           monkeypatch):
    """Epochs 1..N replay what the feed's writer thread spooled; a
    corrupted spooled shard is re-walked on the device walker and the
    run's bytes are the unfaulted ring run's."""
    clean = _port_run(groups, max_epochs=3, patience=3)
    save = tstream.ShardSpool.save

    def save_then_corrupt(self, shard):
        path = save(self, shard)
        if shard.index == 2:
            with open(path, "r+b") as f:
                f.seek(-1, 2)
                byte = f.read(1)
                f.seek(-1, 2)
                f.write(bytes([byte[0] ^ 0xFF]))
        return path

    monkeypatch.setattr(tstream.ShardSpool, "save", save_then_corrupt)
    with pytest.warns(RuntimeWarning, match="re-walking"):
        fed = _port_run(groups, max_epochs=3, patience=3,
                        walker_backend="device")
    assert fed.stats.rewalks >= 1 and fed.stats.shards_emitted == 0
    assert _strip(fed.train.history) == _strip(clean.train.history)
    assert fed.train.w_ih.tobytes() == clean.train.w_ih.tobytes()


def test_streaming_config_errors():
    """tests/test_stream.py's gates on the walker backend and the feed,
    on the port's config and trainer."""
    from g2vec_tpu_torch.config import G2VecConfig, config_from_args

    def cfg(**over):
        c = G2VecConfig(train_mode="streaming", **over)
        c.validate()
        return c

    cfg(walker_backend="device")
    with pytest.raises(ValueError, match="walker_backend"):
        cfg(walker_backend="jax")
    with pytest.raises(ValueError, match="shard_paths"):
        cfg(shard_paths=2)
    with pytest.raises(ValueError, match="prefetch_depth"):
        cfg(prefetch_depth=0)
    with pytest.raises(ValueError, match="stream_patience"):
        cfg(stream_patience=0)
    parsed = config_from_args(
        ["e", "c", "n", "r", "--train-mode", "streaming", "--walker-backend",
         "device", "--cache-dir", "d"])
    assert (parsed.walker_backend, parsed.cache_dir) == ("device", "d")
    # The device walker always streams through the fused feed, and the
    # reference's legacy-walker sizes steer nothing here: no such flags.
    for flag in (["--device-feed"], ["--walker-batch", "8"],
                 ["--walker-hbm-budget", "1024"], ["--no-walk-cache"]):
        with pytest.raises(SystemExit):
            config_from_args(["e", "c", "n", "r", *flag])
    kw = _small_groups()
    with pytest.raises(ValueError, match="walker_backend must be"):
        tstream.train_cbow_streaming(**kw, walker_backend="auto")
