"""The port's checkpoint/resume against ``g2vec_tpu.train.checkpoint`` and
``g2vec_tpu.train.train_cbow``.

- A run crashed at the ``train`` seam and resumed writes the bytes of an
  uninterrupted run, at float32 and at bfloat16 (compute, and params:
  the plain versions of the kernels on the CPU), from several boundaries.
- A finished or early-stopped run resumes without training; a completed
  run goes on when ``max_epochs`` is raised, to the bytes of a longer
  uninterrupted run.
- bfloat16 params round-trip as uint16 bits with a ``bfloat16`` manifest
  dtype, in a process where ``ml_dtypes`` cannot be imported.
- Shape, dtype and fingerprint drift raise ``ValueError``; a corrupt
  latest checkpoint falls back to ``.prev`` with a warning, and all
  generations corrupt raise.
- The port saves at the JAX package's epochs, with its ``done`` codes,
  accuracy pairs and history, for the same init, split, ``max_epochs``
  and ``checkpoint_every`` at float32.
- A checkpoint the JAX package wrote at an unpadded gene width
  (``n_genes % 8 == 0`` on its XLA path) resumes in the port, and the
  finished W_ih is within rtol 1e-5 of the JAX package's uninterrupted
  run (float32 sums in another order, as tests/test_torch_trainer.py
  allows); at a padded width the fingerprint refuses it.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from g2vec_tpu.train import checkpoint as jckpt
from g2vec_tpu.train import trainer as jtrainer
from g2vec_tpu_torch.resilience import faults
from g2vec_tpu_torch.train import checkpoint as ck
from g2vec_tpu_torch.train import trainer as ttrainer
from g2vec_tpu_torch.weights import params_from_jax

pytestmark = pytest.mark.torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    monkeypatch.delenv(faults.ENV_PLAN, raising=False)
    monkeypatch.delenv(faults.ENV_STATE, raising=False)
    faults._reset_for_tests()
    yield
    faults._reset_for_tests()


def _problem(n_paths=300, n_genes=296, hidden=16, seed=0):
    rng = np.random.default_rng(seed)
    dense = rng.random((n_paths, n_genes)) < 0.05
    labels = (dense[:, :40].sum(1) > dense[:, 40:80].sum(1)).astype(np.int32)
    wi = (np.clip(rng.standard_normal((n_genes, hidden)), -2, 2)
          / np.sqrt(hidden)).astype(np.float32)
    wo = (np.clip(rng.standard_normal((hidden, 1)), -2, 2)
          / np.sqrt(hidden)).astype(np.float32)
    return np.packbits(dense, axis=1), labels, wi, wo


def _train(packed, labels, n_genes, **kw):
    args = dict(n_genes=n_genes, hidden=16, learning_rate=0.002,
                max_epochs=20, seed=3, device="cpu")
    args.update(kw)
    return ttrainer.train_cbow(packed, labels, **args)


DTYPES = [("float32", "float32"), ("bfloat16", "float32"),
          ("bfloat16", "bfloat16")]


@pytest.mark.parametrize("crash_epoch", [1, 4, 7])
@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16", "bf16-params"])
def test_resume_matches_uninterrupted_bytes(tmp_path, dtypes, crash_epoch):
    compute, param = dtypes
    packed, labels, _, _ = _problem()
    kw = dict(compute_dtype=compute, param_dtype=param)
    clean = _train(packed, labels, 296, **kw)
    assert len(clean.history) > crash_epoch + 1
    d = str(tmp_path / "ck")
    faults.install_plan(f"stage=train,epoch={crash_epoch},kind=crash")
    with pytest.raises(faults.InjectedFault):
        _train(packed, labels, 296, checkpoint_dir=d, checkpoint_every=3,
               **kw)
    faults._reset_for_tests()
    res = _train(packed, labels, 296, checkpoint_dir=d, checkpoint_every=3,
                 resume=True, **kw)
    # The crash at epoch k never writes checkpoint k: the run resumes
    # after the last boundary before it.
    first = (crash_epoch // 3) * 3
    assert [h["epoch"] for h in res.history][0] == first
    assert res.w_ih.tobytes() == clean.w_ih.tobytes()
    assert (res.stop_epoch, res.stopped_early, res.acc_val, res.acc_tr) == (
        clean.stop_epoch, clean.stopped_early, clean.acc_val, clean.acc_tr)
    strip = [{k: v for k, v in h.items() if k != "secs"}
             for h in clean.history[first:]]
    assert [{k: v for k, v in h.items() if k != "secs"}
            for h in res.history] == strip


@pytest.mark.parametrize("case", ["early_stop", "completed"])
def test_finished_run_resumes_without_training(tmp_path, monkeypatch, case):
    packed, labels, _, _ = _problem()
    kw = (dict(learning_rate=0.02, max_epochs=40) if case == "early_stop"
          else dict(max_epochs=6))
    d = str(tmp_path / "ck")
    first = _train(packed, labels, 296, checkpoint_dir=d, **kw)
    assert first.stopped_early == (case == "early_stop")
    _, _, _, _, _, _, done = ck.load_state(
        d, [torch.zeros(296, 16), torch.zeros(16, 1)],
        (0, [torch.zeros(296, 16), torch.zeros(16, 1)],
         [torch.zeros(296, 16), torch.zeros(16, 1)]))
    assert done == (ck.RUN_EARLY_STOPPED if case == "early_stop"
                    else ck.RUN_COMPLETED)

    def no_step(*a, **k):
        raise AssertionError("a finished run trained again")

    monkeypatch.setattr(ttrainer._Adam, "step", no_step)
    again = _train(packed, labels, 296, checkpoint_dir=d, resume=True, **kw)
    assert again.history == []
    assert again.w_ih.tobytes() == first.w_ih.tobytes()
    assert (again.stop_epoch, again.stopped_early, again.acc_val) == (
        first.stop_epoch, first.stopped_early, first.acc_val)


def test_completed_run_continues_when_max_epochs_is_raised(tmp_path):
    packed, labels, _, _ = _problem()
    d = str(tmp_path / "ck")
    _train(packed, labels, 296, checkpoint_dir=d, max_epochs=5)
    longer = _train(packed, labels, 296, checkpoint_dir=d, max_epochs=12,
                    resume=True)
    clean = _train(packed, labels, 296, max_epochs=12)
    assert [h["epoch"] for h in longer.history][0] == 5
    assert longer.w_ih.tobytes() == clean.w_ih.tobytes()


def _state(dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    p = [torch.randn(12, 4, generator=g).to(dtype),
         torch.randn(4, 1, generator=g).to(dtype)]
    mu = [torch.randn(12, 4, generator=g).to(dtype),
          torch.randn(4, 1, generator=g).to(dtype)]
    nu = [torch.rand(12, 4, generator=g).to(dtype),
          torch.rand(4, 1, generator=g).to(dtype)]
    return p, (7, mu, nu), [x * 2 for x in p]


def test_leaf_order_and_manifest_are_the_jax_packages(tmp_path):
    """The JAX package reads the port's float32 checkpoint: the same leaf
    order, manifest schema and ``meta``."""
    p, opt, snap = _state(torch.float32)
    path = ck.save_state(str(tmp_path), p, opt, snap, 6, 0.75, 0.8,
                         done=ck.RUN_COMPLETED, fingerprint={"hidden": 4})
    assert os.path.basename(path) == jckpt.CKPT_NAME
    man = json.load(open(path + ck.MANIFEST_SUFFIX))
    assert [r["name"] for r in man["leaves"]] == [f"leaf_{i}"
                                                  for i in range(9)]
    assert man["meta"] == [6.0, 0.75, 0.8, 1.0]
    assert jckpt._verify_single(path) is None
    with np.load(path) as z:
        leaves = [z[f"leaf_{i}"] for i in range(9)]
    assert jckpt._verify_leaves(path, leaves) is None
    assert leaves[2].shape == () and leaves[2].dtype == np.int32
    want = [p[0], p[1], 7, *opt[1], *opt[2], *snap]
    for got, w in zip(leaves, want):
        np.testing.assert_array_equal(got, np.asarray(w))


_NO_ML_DTYPES = r"""
import sys
sys.modules["ml_dtypes"] = None          # any import of it now fails
import numpy as np, torch
from g2vec_tpu_torch.train import checkpoint as ck
d = sys.argv[1]
g = torch.Generator().manual_seed(0)
p = [torch.randn(12, 4, generator=g).bfloat16(),
     torch.randn(4, 1, generator=g).bfloat16()]
opt = (5, [x * 3 for x in p], [x * x for x in p])
snap = [x - 1 for x in p]
ck.save_state(d, p, opt, snap, 4, 0.5, 0.6)
out = ck.load_state(d, p, opt)
leaves = ck.flatten_state(out[0], out[1], out[2])
ref = ck.flatten_state(p, opt, snap)
same = all(int(a) == int(b) if not isinstance(b, torch.Tensor) else
           (a.dtype == torch.bfloat16 and
            torch.equal(a.view(torch.int16), b.view(torch.int16)))
           for a, b in zip(leaves, ref))
with np.load(d + "/cbow_state.npz") as z:
    stored = str(z["leaf_0"].dtype)
import json
man = json.load(open(d + "/cbow_state.npz.manifest.json"))
print(json.dumps({"same": same, "stored": stored,
                  "manifest": man["leaves"][0]["dtype"],
                  "ml_dtypes": sys.modules["ml_dtypes"] is not None}))
"""


def test_bf16_params_round_trip_without_ml_dtypes(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", _NO_ML_DTYPES,
                           str(tmp_path)], capture_output=True, text=True,
                          env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {
        "same": True, "stored": "uint16", "manifest": "bfloat16",
        "ml_dtypes": False}


def test_stream_state_bf16_leaves_round_trip(tmp_path):
    p, opt, snap = _state(torch.bfloat16)
    arrays = {f"leaf_{i}": x for i, x in
              enumerate(ck.flatten_state(p, opt, snap))}
    arrays["losses"] = np.array([0.5, 0.25])
    ck.save_stream_state(str(tmp_path), arrays, {"epoch": 2, "shard": 3})
    got, cursor = ck.load_stream_state(str(tmp_path))
    assert cursor == {"epoch": 2, "shard": 3}
    assert got["leaf_0"].dtype == torch.bfloat16
    assert torch.equal(got["leaf_0"].view(torch.int16),
                       p[0].view(torch.int16))
    assert int(got["leaf_2"]) == 7
    np.testing.assert_array_equal(got["losses"], arrays["losses"])


_LIKE = ([torch.zeros(12, 4), torch.zeros(4, 1)],
         (0, [torch.zeros(12, 4), torch.zeros(4, 1)],
          [torch.zeros(12, 4), torch.zeros(4, 1)]))


@pytest.mark.parametrize("drift", ["hidden", "learning_rate", "param_dtype",
                                   "shape", "dtype"])
def test_shape_and_fingerprint_drift_raise(tmp_path, drift):
    p, opt, snap = _state(torch.float32)
    fp = {"hidden": 4, "learning_rate": 0.01, "param_dtype": "float32",
          "n_genes_pad": 12}
    ck.save_state(str(tmp_path), p, opt, snap, 3, 0.5, 0.5, fingerprint=fp)
    like_p, like_opt = _LIKE
    if drift in ("hidden", "learning_rate", "param_dtype"):
        other = dict(fp, **{drift: {"hidden": 8, "learning_rate": 0.02,
                                    "param_dtype": "bfloat16"}[drift]})
        with pytest.raises(ValueError, match=f"{drift}: checkpoint="):
            ck.load_state(str(tmp_path), like_p, like_opt, fingerprint=other)
    elif drift == "shape":
        wide = [torch.zeros(12, 8), torch.zeros(8, 1)]
        with pytest.raises(ValueError, match="leaf 0 has shape"):
            ck.load_state(str(tmp_path), wide, (0, wide, wide))
    else:
        half = [x.bfloat16() for x in like_p]
        with pytest.raises(ValueError, match="is float32, the current"):
            ck.load_state(str(tmp_path), half, (0, half, half))
    # The same config loads.
    assert ck.load_state(str(tmp_path), like_p, like_opt,
                         fingerprint=fp)[3] == 3


def test_stream_fingerprint_drift_raises(tmp_path):
    ck.save_stream_state(str(tmp_path), {"x": np.zeros(3)},
                         {"epoch": 0, "shard": 1},
                         fingerprint={"max_epochs": 5})
    with pytest.raises(ValueError, match="max_epochs: checkpoint=5"):
        ck.load_stream_state(str(tmp_path), fingerprint={"max_epochs": 6})


@pytest.mark.parametrize("layout", ["full", "stream"])
def test_corrupt_latest_falls_back_to_prev_then_raises(tmp_path, layout):
    p, opt, snap = _state(torch.float32)
    d = str(tmp_path)
    if layout == "full":
        ck.save_state(d, p, opt, snap, 4, 0.5, 0.6)
        ck.save_state(d, p, opt, snap, 9, 0.7, 0.8)
        latest = os.path.join(d, ck.CKPT_NAME)

        def load():
            return ck.load_state(d, *_LIKE)[3]
    else:
        ck.save_stream_state(d, {"x": np.arange(400.0)}, {"epoch": 4})
        ck.save_stream_state(d, {"x": np.arange(400.0)}, {"epoch": 9})
        latest = os.path.join(d, ck.STREAM_NAME)

        def load():
            return ck.load_stream_state(d)[1]["epoch"]
    assert load() == 9
    faults._corrupt_file(latest)
    with pytest.warns(RuntimeWarning, match="integrity"):
        assert load() == 4                       # the .prev generation
    faults._corrupt_file(latest + ck.PREV_SUFFIX)
    with pytest.warns(RuntimeWarning):
        with pytest.raises(ValueError, match="no intact"):
            load()


@pytest.mark.parametrize("layout", ["full", "stream"])
def test_death_between_the_commit_renames_loses_no_generation(tmp_path,
                                                             layout):
    """A SIGKILL after the commit moved the latest file to ``.prev`` and
    before it moved the manifest leaves generation N's file at ``.prev``
    beside N-1's manifest and N's manifest at the latest's name, with no
    latest file: the loader pairs the file with the manifest whose sha256
    it matches and resumes at N (the reference's loader finds every kept
    generation corrupt there)."""
    p, opt, snap = _state(torch.float32)
    d = str(tmp_path)
    if layout == "full":
        for epoch in (4, 9):
            ck.save_state(d, p, opt, snap, epoch, 0.5, 0.6)
        latest = os.path.join(d, ck.CKPT_NAME)

        def load(mod):
            return mod.load_state(d, *_LIKE)[3] if mod is ck else None
    else:
        for epoch in (4, 9):
            ck.save_stream_state(d, {"x": np.arange(400.0) + epoch},
                                 {"epoch": epoch})
        latest = os.path.join(d, ck.STREAM_NAME)

        def load(mod):
            return mod.load_stream_state(d)[1]["epoch"]
    os.replace(latest, latest + ck.PREV_SUFFIX)      # the commit's rename 1
    with pytest.warns(RuntimeWarning, match="previous checkpoint"):
        assert load(ck) == 9
    if layout == "stream":
        with pytest.raises(ValueError, match="every kept generation"):
            load(jckpt)


def test_no_checkpoint_loads_none(tmp_path):
    assert ck.load_state(str(tmp_path), *_LIKE) is None
    assert ck.load_stream_state(str(tmp_path)) is None


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------

def _record_saves(monkeypatch, module, name="save_state"):
    saves = []
    real = getattr(module, name)

    def record(directory, params, opt_state, snapshot, epoch, before_val,
               before_tr, done=0, **kw):
        saves.append((epoch, before_val, before_tr, done))
        return real(directory, params, opt_state, snapshot, epoch,
                    before_val, before_tr, done=done, **kw)

    monkeypatch.setattr(module, name, record)
    return saves


@pytest.mark.parametrize("max_epochs,lr,every",
                         [(40, 0.01, 3), (11, 0.0005, 4), (7, 0.0005, 25)],
                         ids=["early_stop", "epoch_cap", "one_chunk"])
def test_saved_epochs_and_history_match_jax(tmp_path, monkeypatch,
                                            max_epochs, lr, every):
    packed, labels, wi, wo = _problem(n_genes=296, hidden=32)
    common = dict(hidden=32, compute_dtype="float32", seed=3,
                  learning_rate=lr, max_epochs=max_epochs,
                  checkpoint_every=every)
    j_saves = _record_saves(monkeypatch, jckpt)
    t_saves = _record_saves(monkeypatch, ttrainer)
    rj = jtrainer.train_cbow(packed, labels, packed_genes=296,
                             use_pallas=False, warm_start=(wi, wo),
                             checkpoint_dir=str(tmp_path / "j"), **common)
    rt = ttrainer.train_cbow(packed, labels, n_genes=296, device="cpu",
                             init=params_from_jax(wi, wo),
                             checkpoint_dir=str(tmp_path / "t"), **common)
    assert len(j_saves) >= 2
    assert t_saves == j_saves
    assert [(h["epoch"], h["acc_val"], h["acc_tr"]) for h in rt.history] == \
        [(h["epoch"], h["acc_val"], h["acc_tr"]) for h in rj.history]
    for a, b in zip(rj.history, rt.history):
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-5)
    # The two files hold the same meta and fingerprint.
    man_j = json.load(open(tmp_path / "j" / (jckpt.CKPT_NAME
                                             + jckpt.MANIFEST_SUFFIX)))
    man_t = json.load(open(tmp_path / "t" / (ck.CKPT_NAME
                                             + ck.MANIFEST_SUFFIX)))
    assert man_t["meta"] == man_j["meta"]
    assert man_t["fingerprint"] == man_j["fingerprint"]
    assert [(r["shape"], r["dtype"]) for r in man_t["leaves"]] == \
        [(r["shape"], r["dtype"]) for r in man_j["leaves"]]


def test_jax_written_checkpoint_resumes_in_the_port(tmp_path):
    packed, labels, wi, wo = _problem(n_genes=296, hidden=16)
    common = dict(hidden=16, compute_dtype="float32", seed=3,
                  learning_rate=0.0005)
    d = str(tmp_path / "ck")
    # A JAX run that completed 6 epochs; the port continues it to 14.
    jtrainer.train_cbow(packed, labels, packed_genes=296, use_pallas=False,
                        warm_start=(wi, wo), checkpoint_dir=d,
                        checkpoint_every=3, max_epochs=6, **common)
    rt = ttrainer.train_cbow(packed, labels, n_genes=296, device="cpu",
                             checkpoint_dir=d, checkpoint_every=3,
                             max_epochs=14, resume=True, **common)
    rj = jtrainer.train_cbow(packed, labels, packed_genes=296,
                             use_pallas=False, warm_start=(wi, wo),
                             max_epochs=14, **common)
    assert not rj.stopped_early and len(rj.history) == 14
    assert [h["epoch"] for h in rt.history] == list(range(6, 14))
    assert [(h["acc_val"], h["acc_tr"]) for h in rt.history] == \
        [(h["acc_val"], h["acc_tr"]) for h in rj.history[6:]]
    np.testing.assert_allclose(rt.w_ih, rj.w_ih, rtol=1e-5, atol=1e-7)


def test_jax_checkpoint_at_a_padded_width_is_refused(tmp_path):
    packed, labels, wi, wo = _problem(n_genes=299, hidden=16)
    common = dict(hidden=16, compute_dtype="float32", seed=3,
                  learning_rate=0.002, max_epochs=3)
    d = str(tmp_path / "ck")
    jtrainer.train_cbow(packed, labels, packed_genes=299, use_pallas=False,
                        warm_start=(wi, wo), checkpoint_dir=d, **common)
    with pytest.raises(ValueError, match="n_genes_pad: checkpoint=304 vs "
                                         "current=299"):
        ttrainer.train_cbow(packed, labels, n_genes=299, device="cpu",
                            checkpoint_dir=d, resume=True, **common)


# ---------------------------------------------------------------------------
# The sharded layout (``g2vec_tpu/train/checkpoint.py:291-563``)
# ---------------------------------------------------------------------------

def _sharded_like():
    like = [torch.zeros(12, 4), torch.zeros(4, 1)]
    return like, (0, like, like)


@pytest.mark.parametrize("crash_epoch", [2, 7])
def test_sharded_resume_matches_uninterrupted_bytes(tmp_path, crash_epoch):
    packed, labels, _, _ = _problem()
    clean = _train(packed, labels, 296)
    d = str(tmp_path / "ck")
    kw = dict(checkpoint_dir=d, checkpoint_every=3,
              checkpoint_layout="sharded")
    faults.install_plan(f"stage=train,epoch={crash_epoch},kind=crash")
    with pytest.raises(faults.InjectedFault):
        _train(packed, labels, 296, **kw)
    faults._reset_for_tests()
    assert not os.path.exists(os.path.join(d, ck.CKPT_NAME))
    res = _train(packed, labels, 296, resume=True, **kw)
    first = (crash_epoch // 3) * 3
    assert [h["epoch"] for h in res.history][0] == first
    assert res.w_ih.tobytes() == clean.w_ih.tobytes()
    assert (res.stop_epoch, res.stopped_early, res.acc_val) == (
        clean.stop_epoch, clean.stopped_early, clean.acc_val)


@pytest.mark.parametrize("case", ["early_stop", "completed"])
def test_sharded_terminal_state_resumes_without_training(tmp_path,
                                                        monkeypatch, case):
    packed, labels, _, _ = _problem()
    kw = (dict(learning_rate=0.02, max_epochs=40) if case == "early_stop"
          else dict(max_epochs=6))
    kw.update(checkpoint_dir=str(tmp_path / "ck"),
              checkpoint_layout="sharded")
    first = _train(packed, labels, 296, **kw)
    assert first.stopped_early == (case == "early_stop")

    def no_step(*a, **k):
        raise AssertionError("a finished run trained again")

    monkeypatch.setattr(ttrainer._Adam, "step", no_step)
    again = _train(packed, labels, 296, resume=True, **kw)
    assert again.history == []
    assert again.w_ih.tobytes() == first.w_ih.tobytes()
    assert (again.stop_epoch, again.stopped_early, again.acc_val) == (
        first.stop_epoch, first.stopped_early, first.acc_val)


def test_sharded_shape_mismatch_and_cross_layout_are_refused(tmp_path):
    packed, labels, _, _ = _problem()
    d = str(tmp_path / "ck")
    kw = dict(checkpoint_dir=d, max_epochs=3)
    _train(packed, labels, 296, checkpoint_layout="sharded", **kw)
    with pytest.raises(ValueError, match="shape"):
        _train(packed, labels, 296, hidden=8, checkpoint_layout="sharded",
               resume=True, **kw)
    with pytest.raises(ValueError, match="leaf 0 has shape"):
        ck.load_state(d, [torch.zeros(296, 8), torch.zeros(8, 1)],
                      (0, [torch.zeros(296, 8), torch.zeros(8, 1)],
                       [torch.zeros(296, 8), torch.zeros(8, 1)]),
                      layout="sharded")
    with pytest.raises(ValueError, match="checkpoint-layout sharded"):
        _train(packed, labels, 296, checkpoint_layout="single", resume=True,
               **kw)
    d2 = str(tmp_path / "ck2")
    _train(packed, labels, 296, checkpoint_dir=d2, max_epochs=3)
    with pytest.raises(ValueError, match="checkpoint-layout single"):
        _train(packed, labels, 296, checkpoint_dir=d2, max_epochs=3,
               checkpoint_layout="sharded", resume=True)


@pytest.mark.parametrize("damage", ["corrupt", "torn", "manifest"])
def test_sharded_keeps_previous_and_falls_back_to_it(tmp_path, damage):
    p, opt, snap = _state(torch.float32)
    d = str(tmp_path)
    for epoch in (3, 6, 9):
        ck.save_state(d, p, opt, snap, epoch, 0.5, 0.6, layout="sharded")
    names = sorted(os.listdir(d))
    assert names == [ck.SHARDED_NAME + ".1",
                     ck.SHARDED_NAME + ".1" + ck.MANIFEST_SUFFIX,
                     ck.SHARDED_NAME + ".2",
                     ck.SHARDED_NAME + ".2" + ck.MANIFEST_SUFFIX,
                     ck.SHARDED_NAME + ".LATEST"]
    with open(os.path.join(d, ck.SHARDED_NAME + ".LATEST")) as f:
        assert f.read() == ck.SHARDED_NAME + ".2"
    like, opt_like = _sharded_like()
    assert ck.load_state(d, like, opt_like, layout="sharded")[3] == 9
    latest = os.path.join(d, ck.SHARDED_NAME + ".2")
    leaves = os.path.join(latest, ck.SHARDED_LEAVES)
    if damage == "corrupt":
        faults._corrupt_file(leaves)
        reason = "sha256 mismatch"
    elif damage == "torn":
        with open(leaves, "r+b") as f:
            f.truncate(os.path.getsize(leaves) // 2)
        reason = "torn write"
    else:
        with open(latest + ck.MANIFEST_SUFFIX, "w") as f:
            f.write("{not json")
        reason = "manifest unreadable"
    with pytest.warns(RuntimeWarning, match=reason):
        assert ck.load_state(d, like, opt_like, layout="sharded")[3] == 6
    faults._corrupt_file(os.path.join(d, ck.SHARDED_NAME + ".1",
                                      ck.SHARDED_LEAVES))
    with pytest.warns(RuntimeWarning):
        with pytest.raises(ValueError, match="no intact sharded"):
            ck.load_state(d, like, opt_like, layout="sharded")


def test_sharded_manifest_is_the_references_and_ocdbt_is_refused(tmp_path):
    """The port's sharded manifest has the JAX package's fields; a
    directory the JAX package wrote (orbax OCDBT) is refused by name, in
    either layout."""
    import jax.numpy as jnp

    p, opt, snap = _state(torch.float32)
    port = ck.save_state(str(tmp_path / "port"), p, opt, snap, 4, 0.5, 0.6,
                         fingerprint={"hidden": 4}, layout="sharded")
    jp = [jnp.asarray(x.numpy()) for x in p]
    jdir = str(tmp_path / "jax")
    ref = jckpt.save_state(jdir, jp, (jnp.int32(7), jp, jp), jp, 4, 0.5,
                           0.6, fingerprint={"hidden": 4}, layout="sharded")
    man = [json.load(open(x + ck.MANIFEST_SUFFIX)) for x in (port, ref)]
    assert sorted(man[0]) == sorted(man[1])
    assert man[0]["layout"] == man[1]["layout"] == "sharded"
    assert man[0]["meta"] == man[1]["meta"]
    assert man[0]["fingerprint"] == man[1]["fingerprint"]
    for rec in man[0]["files"].values():
        assert sorted(rec) == ["sha256", "size"]
    assert os.path.basename(ref).startswith(ck.REFERENCE_SHARDED_NAME)
    like, opt_like = _sharded_like()
    with pytest.raises(ValueError, match="orbax OCDBT"):
        ck.load_state(jdir, like, opt_like, layout="sharded")
    with pytest.raises(ValueError, match="checkpoint-layout sharded"):
        ck.load_state(jdir, like, opt_like)
