"""The port's lane stack (the batch engine's trainer and stages 5-6).

- ``packed_matmul_lanes`` (both functions and the autograd function)
  equals the solo ``packed_matmul`` lane by lane, bitwise, on the plain
  path, including a subset of the lanes and a ragged shape (G not a
  multiple of 8, odd H);
- ``train_cbow_lanes`` equals the solo ``train_cbow`` lane by lane,
  bitwise (history, stop epoch, ``W_ih``), at float32 and on the bf16
  plain path, with lanes that stop at different epochs inside one
  bucket;
- ``train_cbow_lanes`` against the JAX package's ``train_cbow_lanes`` at
  float32 from the same per-lane init (the JAX draw
  ``init_params(jax.random.key(seed), ...)``, handed to the port through
  ``weights.params_from_jax``): equal accuracies, stop epochs and
  decisions; losses and ``W_ih`` at rtol 1e-5 (``W_ih`` with atol 1e-7
  for entries near zero), as the solo trainers' comparison allows
  (float32 sums in another order, compounded through Adam);
- ``find_lgroups_lanes``/``biomarker_scores_lanes`` equal the port's solo
  functions bitwise, and the JAX stage composition (the vmapped Lloyd
  from the same injected centres, the vote, and the JAX
  ``biomarker_scores_lanes``): equal L-groups and biomarkers, scores at
  rtol 1e-5, atol 1e-6 (tests/test_torch_analysis.py's bound).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from g2vec_tpu import analysis as janalysis
from g2vec_tpu.models.cbow import init_params as jax_init_params
from g2vec_tpu.ops import kmeans as jkmeans
from g2vec_tpu.train.trainer import LaneTrainSpec as JaxLaneSpec
from g2vec_tpu.train.trainer import train_cbow_lanes as jax_train_lanes
from g2vec_tpu_torch import analysis as tanalysis
from g2vec_tpu_torch.ops import packed_matmul as tpm
from g2vec_tpu_torch.train import trainer as ttrainer
from g2vec_tpu_torch.weights import params_from_jax

pytestmark = pytest.mark.torch


def _stack(rng, b, m, g, density=0.05):
    x = rng.random((b, m, g)) < density
    return torch.from_numpy(np.packbits(x, axis=2))


@pytest.mark.parametrize("b,m,g,h,lanes", [
    (3, 70, 64, 16, None), (4, 33, 61, 9, [3, 0]), (2, 5, 7, 1, [1])],
    ids=["all", "subset-ragged", "tiny"])
def test_lane_products_equal_the_solo_ones(rng, b, m, g, h, lanes):
    packed = _stack(rng, b, m, g)
    ids = list(range(b)) if lanes is None else lanes
    w = torch.from_numpy(rng.standard_normal((len(ids), g, h))
                         .astype(np.float32))
    rows = m - 2
    g_out = torch.from_numpy(rng.standard_normal((len(ids), rows, h))
                             .astype(np.float32))
    out = tpm.packed_matmul_lanes_fwd(packed, w, lanes)
    dw = tpm.packed_matmul_lanes_bwd(packed, g_out, g, lanes)
    assert out.shape == (len(ids), m, h) and dw.shape == (len(ids), g, h)
    for i, lane in enumerate(ids):
        assert torch.equal(out[i], tpm.packed_matmul_fwd(packed[lane], w[i]))
        assert torch.equal(dw[i], tpm.packed_matmul_bwd(
            packed[lane, :rows], g_out[i], g))
    assert torch.equal(out, tpm.packed_matmul_lanes_fwd_plain(packed, w,
                                                              lanes))
    assert torch.equal(dw, tpm.packed_matmul_lanes_bwd_plain(packed, g_out,
                                                             g, lanes))


def test_lane_autograd_equals_the_solo_autograd(rng):
    packed = _stack(rng, 3, 40, 61)
    w0 = torch.from_numpy(rng.standard_normal((3, 61, 12))
                          .astype(np.float32))
    cot = torch.from_numpy(rng.standard_normal((3, 40, 12))
                           .astype(np.float32))
    w = w0.clone().requires_grad_()
    (tpm.packed_matmul_lanes(packed, w, grad_rows=30) * cot).sum().backward()
    for b in range(3):
        wb = w0[b].clone().requires_grad_()
        (tpm.packed_matmul(packed[b], wb, grad_rows=30) * cot[b]
         ).sum().backward()
        assert torch.equal(w.grad[b], wb.grad)


def test_lane_products_reject_bad_input(rng):
    packed = _stack(rng, 2, 10, 16)
    w = torch.zeros((2, 16, 4))
    with pytest.raises(ValueError, match="3-D uint8 lane stack"):
        tpm.packed_matmul_lanes_fwd(packed[0], w)
    with pytest.raises(ValueError, match="outside the stack"):
        tpm.packed_matmul_lanes_fwd(packed, w, [0, 2])
    with pytest.raises(ValueError, match="lanes, rows, H"):
        tpm.packed_matmul_lanes_fwd(packed, w, [1])
    with pytest.raises(ValueError, match="lanes, rows, H"):
        tpm.packed_matmul_lanes_bwd(packed, torch.zeros((2, 11, 4)), 16)
    with pytest.raises(ValueError, match="grad_rows"):
        tpm.packed_matmul_lanes(packed, w, grad_rows=11)


def _lane_specs(n_paths=50, n_genes=61, seeds=(3, 7, 11, 2)):
    specs = []
    for k, seed in enumerate(seeds):
        r = np.random.default_rng(100 + k)
        dense = r.random((n_paths, n_genes)) < 0.15
        labels = r.integers(0, 2, n_paths).astype(np.int32)
        specs.append(ttrainer.LaneTrainSpec(np.packbits(dense, axis=1),
                                            labels, seed))
    return specs


def _assert_same_run(lane, solo):
    assert (lane.stop_epoch, lane.stopped_early) == (solo.stop_epoch,
                                                     solo.stopped_early)
    assert (lane.acc_val, lane.acc_tr) == (solo.acc_val, solo.acc_tr)
    assert [{k: h[k] for k in ("epoch", "acc_val", "acc_tr", "loss")}
            for h in lane.history] == \
        [{k: h[k] for k in ("epoch", "acc_val", "acc_tr", "loss")}
         for h in solo.history]
    assert lane.w_ih.tobytes() == solo.w_ih.tobytes()


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_lanes_are_bitwise_the_solo_trainer(compute_dtype):
    specs = _lane_specs()
    common = dict(n_genes=61, hidden=16, learning_rate=0.05, max_epochs=40,
                  compute_dtype=compute_dtype, device="cpu")
    reported = []
    results, emb = ttrainer.train_cbow_lanes(
        specs, on_epoch=lambda b, *rest: reported.append((b, rest[0])),
        **common)
    assert emb.shape == (4, 61, 16) and emb.dtype == torch.float32
    stops = []
    for b, (spec, lane) in enumerate(zip(specs, results)):
        solo = ttrainer.train_cbow(spec.paths, spec.labels, seed=spec.seed,
                                   **common)
        _assert_same_run(lane, solo)
        assert torch.equal(emb[b], torch.from_numpy(solo.w_ih))
        assert [s for lb, s in reported if lb == b] == \
            [h["epoch"] for h in solo.history]
        stops.append(len(lane.history))
    # One bucket whose lanes stop at different epochs: a lane that stopped
    # kept its weights while the others trained on.
    assert len(set(stops)) > 1, stops


def test_stopped_lane_leaves_the_launches(monkeypatch):
    specs = _lane_specs(seeds=(3, 7))
    calls = []
    fwd, bwd = tpm.packed_matmul_lanes_fwd, tpm.packed_matmul_lanes_bwd
    monkeypatch.setattr(ttrainer, "packed_matmul_lanes_fwd",
                        lambda p, w, lanes: calls.append(("f", list(lanes)))
                        or fwd(p, w, lanes))
    monkeypatch.setattr(ttrainer, "packed_matmul_lanes_bwd",
                        lambda p, g, n, lanes: calls.append(
                            ("b", list(lanes))) or bwd(p, g, n, lanes))
    results, _ = ttrainer.train_cbow_lanes(
        specs, n_genes=61, hidden=16, learning_rate=0.05, max_epochs=40,
        device="cpu")
    short = min(range(2), key=lambda b: len(results[b].history))
    n = len(results[short].history)
    assert n < len(results[1 - short].history)
    # Epochs 0..n-1 train both lanes; the forward of epoch n reports the
    # short lane's dip, and from then on it is in no launch.
    assert all(short in lanes for _, lanes in calls[:2 * n])
    assert calls[2 * n] == ("f", [0, 1])
    assert all(short not in lanes for _, lanes in calls[2 * n + 1:])


def test_lanes_match_jax_train_cbow_lanes():
    n_genes, hidden = 64, 16
    specs = _lane_specs(n_genes=n_genes, seeds=(3, 7, 11))
    init = [jax_init_params(jax.random.key(s.seed), n_genes, hidden)
            for s in specs]
    common = dict(hidden=hidden, learning_rate=0.05, max_epochs=40,
                  compute_dtype="float32")
    rj, emb_j = jax_train_lanes(
        [JaxLaneSpec(s.paths, s.labels, s.seed) for s in specs],
        packed_genes=n_genes, **common)
    rt, emb_t = ttrainer.train_cbow_lanes(
        specs, n_genes=n_genes, device="cpu",
        init=[params_from_jax(np.asarray(p.w_ih), np.asarray(p.w_ho))
              for p in init], **common)
    assert len({len(r.history) for r in rj}) > 1
    for a, b in zip(rj, rt):
        assert (b.stop_epoch, b.stopped_early) == (a.stop_epoch,
                                                   a.stopped_early)
        assert [(h["epoch"], h["acc_val"], h["acc_tr"]) for h in b.history] \
            == [(h["epoch"], h["acc_val"], h["acc_tr"]) for h in a.history]
        np.testing.assert_allclose([h["loss"] for h in b.history],
                                   [h["loss"] for h in a.history], rtol=1e-5)
        np.testing.assert_allclose(b.w_ih, a.w_ih, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(emb_t.numpy(), np.asarray(emb_j), rtol=1e-5,
                               atol=1e-7)


def test_train_cbow_lanes_rejects_bad_input():
    specs = _lane_specs(seeds=(1, 2))
    kw = dict(n_genes=61, hidden=8, learning_rate=0.01, max_epochs=2,
              device="cpu")
    with pytest.raises(ValueError, match="at least one lane"):
        ttrainer.train_cbow_lanes([], **kw)
    odd = ttrainer.LaneTrainSpec(specs[1].paths[:40], specs[1].labels[:40], 2)
    with pytest.raises(ValueError, match="one shape bucket"):
        ttrainer.train_cbow_lanes([specs[0], odd], **kw)
    with pytest.raises(ValueError, match="init has 1 entries"):
        ttrainer.train_cbow_lanes(specs, init=[None], **kw)
    with pytest.raises(ValueError, match="expects uint8 paths"):
        ttrainer.train_cbow_lanes(specs, **{**kw, "n_genes": 70})


def _blobs(rng, n, d, k=3):
    centers = rng.standard_normal((k, d)) * 3.0
    member = rng.integers(0, k, size=n)
    return (centers[member] + rng.standard_normal((n, d)) * 0.8
            ).astype(np.float32)


def test_stages_5_and_6_over_lanes(rng):
    n_lanes, n_genes, hidden = 3, 60, 12
    emb = np.stack([_blobs(rng, n_genes, hidden) for _ in range(n_lanes)])
    freq = rng.integers(0, 3, size=(n_lanes, n_genes)).astype(np.int32)
    c0 = np.stack([emb[b][rng.choice(n_genes, size=(10, 3))]
                   for b in range(n_lanes)])
    expr = rng.standard_normal((30, n_genes)).astype(np.float32)
    labels = (np.arange(30) % 2).astype(np.int32)
    genes = np.array([f"G{i:03d}" for i in range(n_genes)])
    good, poor = (torch.tensor(expr[labels == c]) for c in (0, 1))
    stack = torch.tensor(emb)

    # Against the port's solo functions, bitwise; seeded k-means++ draws.
    lg, centers = tanalysis.find_lgroups_lanes(stack, freq, [5, 6, 7],
                                               iters=40)
    scores = tanalysis.biomarker_scores_lanes(stack, good, poor, lg)
    assert lg.shape == (n_lanes, n_genes) and centers.shape == (n_lanes, 3,
                                                                hidden)
    for b in range(n_lanes):
        lg_s, c_s = tanalysis.find_lgroups(
            torch.tensor(emb[b]), freq[b],
            generator=torch.Generator().manual_seed(5 + b), iters=40)
        assert torch.equal(lg[b], lg_s) and torch.equal(centers[b], c_s)
        assert torch.equal(scores[b], tanalysis.biomarker_scores(
            torch.tensor(emb[b]), good, poor, lg_s))
    counts, g_counts, p_counts = tanalysis._vote_counts_lanes(
        torch.argmin(torch.cdist(stack, centers), dim=2), freq, 3)
    assert counts.shape == (n_lanes, 3) and (counts.sum(1) == n_genes).all()
    assert (g_counts.sum(1) == (freq == 0).sum(1)).all()
    assert (p_counts.sum(1) == (freq == 1).sum(1)).all()

    # Against the JAX composition from the same injected starting centres.
    lg_t, _ = tanalysis.find_lgroups_lanes(stack, freq, [0, 0, 0],
                                           iters=300, centers0=c0)
    lg_j = []
    for b in range(n_lanes):
        x = jnp.asarray(emb[b])
        c_j, i_j = jax.vmap(lambda c: jkmeans._lloyd(x, c, 300))(
            jnp.asarray(c0[b]))
        km = jnp.argmin(jkmeans._pairwise_sq_dists(
            x, c_j[int(jnp.argmin(i_j))]), axis=1)
        cnt, gd, pr = janalysis._vote_counts(km, jnp.asarray(freq[b]), 3)
        gc, pc = janalysis._pick_clusters(np.asarray(cnt), np.asarray(gd),
                                          np.asarray(pr), 3, False)
        lg_j.append(np.asarray(janalysis._renumber(km, gc, pc)))
    lg_j = np.stack(lg_j)
    assert np.array_equal(lg_t.numpy(), lg_j)
    s_t = tanalysis.biomarker_scores_lanes(stack, good, poor, lg_t).numpy()
    s_j = np.asarray(janalysis.biomarker_scores_lanes(
        jnp.asarray(emb), expr[labels == 0], expr[labels == 1],
        jnp.asarray(lg_j)))
    for b in range(n_lanes):
        assert tanalysis.top_biomarkers(s_t[b], lg_j[b], genes, 8)[0] == \
            janalysis.top_biomarkers(s_j[b], lg_j[b], genes, 8)[0]
        for group in (0, 1):
            m = lg_j[b] == group
            np.testing.assert_allclose(s_t[b][group][m], s_j[b][group][m],
                                       rtol=1e-5, atol=1e-6)
