"""The port's streaming checkpoint/resume and fault seams against
``g2vec_tpu.train.stream``.

- A run crashed right after each of its cursor checkpoints (the
  ``stream_ckpt`` seam) and resumed writes the uninterrupted run's bytes
  (W_ih, history, gene votes, path count), from every cut: mid-epoch 0,
  every epoch boundary and mid-epoch >= 1, on both feeds (the ring of
  the C++ sampler, and the device walker's fused feed: its plain version
  on the CPU).
- A finished stream resumes without training; a changed config is
  refused by the fingerprint.
- The port cuts its cursors where the JAX package cuts them at float32,
  from the same init: the same (epoch, shard, done, n_shards) sequence,
  the same ``spool_sha`` (equal in full at epoch boundaries and at the
  end; in epoch 0 the ring's producer runs ahead by a timing-dependent
  number of shards, so there both hold every shard before the cursor and
  agree on the shards they share), and the same byproduct arrays.
- ``shard_ring`` and ``prefetch`` faults fail clean: the error reaches
  the caller and no producer thread is left; a ``shard_ring`` corrupt
  tears a spooled shard, which the replay re-walks.
- ``device_walk``: one fault is recovered by relaunching the walk
  (``device_recomputes == 1``, same bytes); a second fault on the same
  walk raises.
"""
import json
import threading

import jax
import numpy as np
import pytest

from g2vec_tpu.models.cbow import init_params as jax_init_params
from g2vec_tpu.train import checkpoint as jckpt
from g2vec_tpu.train import stream as jstream
from g2vec_tpu_torch.resilience import faults
from g2vec_tpu_torch.train import checkpoint as ck
from g2vec_tpu_torch.train import stream as tstream
from g2vec_tpu_torch.weights import params_from_jax

pytestmark = pytest.mark.torch


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    monkeypatch.delenv(faults.ENV_PLAN, raising=False)
    monkeypatch.delenv(faults.ENV_STATE, raising=False)
    faults._reset_for_tests()
    yield
    faults._reset_for_tests()


def _groups(n_genes=40, n_edges=240):
    def grp(seed):
        r = np.random.default_rng(seed)
        return (r.integers(0, n_genes, n_edges).astype(np.int32),
                r.integers(0, n_genes, n_edges).astype(np.int32),
                r.random(n_edges, dtype=np.float32))
    return [grp(1), grp(2)]


KW = dict(groups=_groups(), n_genes=40,
          genes=np.array([f"g{i}" for i in range(40)]), hidden=8,
          learning_rate=0.05, max_epochs=4, seed=3, walk_seed=5, len_path=5,
          reps=6, shard_paths=24, patience=4, compute_dtype="float32",
          device="cpu", console=lambda s: None)


def _strip(history):
    return [{k: v for k, v in h.items() if k != "secs"} for h in history]


def _same(a, b):
    assert a.train.w_ih.tobytes() == b.train.w_ih.tobytes()
    assert _strip(a.train.history) == _strip(b.train.history)
    assert a.gene_freq == b.gene_freq and a.n_paths == b.n_paths
    assert (a.train.stop_epoch, a.train.stopped_early, a.train.acc_val) == (
        b.train.stop_epoch, b.train.stopped_early, b.train.acc_val)


def _record_cursors(monkeypatch, module):
    cursors = []
    real = module.save_stream_state

    def record(directory, arrays, cursor, fingerprint=None):
        cursors.append(dict(cursor))
        return real(directory, arrays, cursor, fingerprint=fingerprint)

    monkeypatch.setattr(module, "save_stream_state", record)
    return cursors


@pytest.mark.parametrize("backend", ["native", "device"])
def test_resume_from_every_cut_is_byte_identical(tmp_path, monkeypatch,
                                                 backend):
    clean = tstream.train_cbow_streaming(walker_backend=backend, **KW)
    cursors = _record_cursors(monkeypatch, tstream)
    ref = tstream.train_cbow_streaming(
        walker_backend=backend, checkpoint_dir=str(tmp_path / "ref"),
        checkpoint_every=3, **KW)
    _same(ref, clean)
    assert ref.stats.checkpoints == len(cursors)
    cuts = [(c["epoch"], c["shard"]) for c in cursors if not c["done"]]
    assert cursors[-1]["done"] == ck.RUN_COMPLETED
    assert any(e == 0 for e, s in cuts)                   # mid-epoch 0
    assert any(e >= 1 and s == 0 for e, s in cuts)        # boundaries
    assert any(e >= 1 and s > 0 for e, s in cuts)         # mid-epoch >= 1
    monkeypatch.undo()
    for k, cut in enumerate(cuts):
        d = str(tmp_path / f"cut{k}")
        faults.install_plan(f"stage=stream_ckpt,kind=crash,skip={k}")
        with pytest.raises(faults.InjectedFault, match="seam=stream_ckpt"):
            tstream.train_cbow_streaming(walker_backend=backend,
                                         checkpoint_dir=d,
                                         checkpoint_every=3, **KW)
        faults._reset_for_tests()
        lines = []
        res = tstream.train_cbow_streaming(
            walker_backend=backend, checkpoint_dir=d, checkpoint_every=3,
            resume=True, **dict(KW, console=lines.append))
        assert lines == [f"[stream] resuming from cursor epoch {cut[0]} "
                         f"shard {cut[1]}/{clean.stats.n_shards}"]
        assert res.stats.resumed == 1
        _same(res, clean)
        if cut[0] == 0 and backend == "native":
            # The producer restarted at the cursor shard.
            assert res.stats.shards_emitted == clean.stats.n_shards - cut[1]
        if cut[0] >= 1:
            assert res.stats.shards_emitted == 0


def test_finished_stream_resumes_without_training(tmp_path, monkeypatch):
    d = str(tmp_path / "ck")
    first = tstream.train_cbow_streaming(checkpoint_dir=d, **KW)

    def no_step(*a, **k):
        raise AssertionError("a finished stream trained again")

    monkeypatch.setattr(tstream._Adam, "step", no_step)
    again = tstream.train_cbow_streaming(checkpoint_dir=d, resume=True, **KW)
    _same(again, first)
    assert again.stats.shards_emitted == 0 and again.stats.resumed == 1
    with pytest.raises(ValueError, match="max_epochs: checkpoint=4"):
        tstream.train_cbow_streaming(checkpoint_dir=d, resume=True,
                                     **dict(KW, max_epochs=5))


def test_bf16_stream_resume_is_byte_identical(tmp_path):
    kw = dict(KW, compute_dtype="bfloat16", param_dtype="bfloat16")
    clean = tstream.train_cbow_streaming(**kw)
    d = str(tmp_path / "ck")
    faults.install_plan("stage=stream_ckpt,kind=crash,skip=4")
    with pytest.raises(faults.InjectedFault):
        tstream.train_cbow_streaming(checkpoint_dir=d, checkpoint_every=3,
                                     **kw)
    faults._reset_for_tests()
    res = tstream.train_cbow_streaming(checkpoint_dir=d, checkpoint_every=3,
                                       resume=True, **kw)
    _same(res, clean)


# ---------------------------------------------------------------------------
# Against the JAX package's streaming trainer
# ---------------------------------------------------------------------------

def _sha_map(path):
    man = json.load(open(path + ck.MANIFEST_SUFFIX))
    return {r["name"]: r["sha256"] for r in man["leaves"]}


def test_cursors_match_jax_at_float32(tmp_path, monkeypatch):
    kw = {k: v for k, v in KW.items() if k not in ("device", "console")}
    j_cursors = _record_cursors(monkeypatch, jckpt)
    t_cursors = _record_cursors(monkeypatch, tstream)
    ref = jstream.train_cbow_streaming(
        use_pallas=False, console=lambda s: None,
        checkpoint_dir=str(tmp_path / "j"), checkpoint_every=3, **kw)
    p = jax_init_params(jax.random.key(kw["seed"]), kw["n_genes"],
                        kw["hidden"])
    port = tstream.train_cbow_streaming(
        device="cpu", init=params_from_jax(np.asarray(p.w_ih),
                                           np.asarray(p.w_ho)),
        checkpoint_dir=str(tmp_path / "t"), checkpoint_every=3, **kw)
    assert len(ref.train.history) >= 3
    assert len(t_cursors) == len(j_cursors) >= 6
    for a, b in zip(j_cursors, t_cursors):
        assert {k: a[k] for k in ("epoch", "shard", "done", "n_shards")} == \
            {k: b[k] for k in ("epoch", "shard", "done", "n_shards")}
        if a["epoch"] >= 1 or a["done"]:
            assert b["spool_sha"] == a["spool_sha"]
        else:
            before = {str(i) for i in range(a["shard"])}
            assert before <= set(a["spool_sha"]) & set(b["spool_sha"])
            assert all(a["spool_sha"][k] == b["spool_sha"][k]
                       for k in set(a["spool_sha"]) & set(b["spool_sha"]))
    # The terminal checkpoints hold the same byproducts, byte for byte.
    j_sha = _sha_map(str(tmp_path / "j" / jckpt.STREAM_NAME))
    t_sha = _sha_map(str(tmp_path / "t" / ck.STREAM_NAME))
    for name in ("good_counts", "poor_counts", "val_x", "val_y", "probe_x",
                 "probe_y", "leaf_2"):
        assert t_sha[name] == j_sha[name], name
    assert set(t_sha) == set(j_sha)
    assert port.train.stop_epoch == ref.train.stop_epoch
    np.testing.assert_allclose(port.train.w_ih, ref.train.w_ih, rtol=1e-5,
                               atol=1e-7)


# ---------------------------------------------------------------------------
# The ring's and the device walk's seams
# ---------------------------------------------------------------------------

def _producers():
    return [t for t in threading.enumerate()
            if t.name == "g2v-stream-producer" and t.is_alive()]


@pytest.mark.parametrize("plan,exc", [
    ("stage=shard_ring,epoch=3,kind=stall,seconds=0", faults.InjectedFault),
    ("stage=shard_ring,epoch=3,kind=crash", faults.InjectedFault),
    ("stage=shard_ring,epoch=3,kind=fatal", faults.InjectedFatal),
    ("stage=prefetch,epoch=3,kind=crash", faults.InjectedFault),
    ("stage=prefetch,epoch=3,kind=stall,seconds=0", faults.InjectedFault),
], ids=["ring-stall", "ring-crash", "ring-fatal", "prefetch-crash",
        "prefetch-stall"])
def test_ring_and_prefetch_faults_fail_clean(plan, exc):
    faults.install_plan(plan)
    with pytest.raises(exc):
        tstream.train_cbow_streaming(prefetch_depth=1, **KW)
    for t in _producers():
        t.join(timeout=10)
    assert not _producers()


def test_shard_ring_corrupt_tears_the_spool_and_the_replay_rewalks():
    clean = tstream.train_cbow_streaming(**KW)
    faults.install_plan("stage=shard_ring,epoch=2,kind=corrupt")
    with pytest.warns(RuntimeWarning, match="re-walking"):
        torn = tstream.train_cbow_streaming(**KW)
    assert torn.stats.rewalks == 1
    _same(torn, clean)


def test_device_walk_fault_recomputes_once_then_raises(monkeypatch):
    clean = tstream.train_cbow_streaming(walker_backend="device", **KW)
    faults.install_plan("stage=device_walk,epoch=2,kind=crash")
    once = tstream.train_cbow_streaming(walker_backend="device", **KW)
    assert once.stats.device_recomputes == 1
    _same(once, clean)
    faults._reset_for_tests()
    faults.install_plan("stage=device_walk,epoch=2,kind=crash,times=2")
    with pytest.raises(faults.InjectedFault, match="seam=device_walk "
                                                   "epoch=2"):
        tstream.train_cbow_streaming(walker_backend="device", **KW)


def test_device_walk_retry_relaunches_the_walk(monkeypatch):
    """The retry calls the same walk again (on the card: the kernel),
    never another walker."""
    from g2vec_tpu_torch.ops import device_walker

    calls = []
    real = device_walker.walk_shard_device_arrays

    def counted(*a, **k):
        calls.append(a[5])
        return real(*a, **k)

    monkeypatch.setattr(tstream, "walk_shard_device_arrays", counted)
    faults.install_plan("stage=device_walk,epoch=1,kind=crash")
    res = tstream.train_cbow_streaming(walker_backend="device", **KW)
    n = res.stats.n_shards
    assert res.stats.device_recomputes == 1
    assert sorted(calls) == sorted([*range(n), *range(n), 1])
