"""The port's Hopper kernels on the card (skipped where torch sees no GPU).

Run on a machine with an H100, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest`` because tests/conftest.py configures JAX, which this
file neither needs nor imports.) Each kernel is held against its plain
PyTorch version on the same card tensors. Both take f32 sums of the same
bf16 values in different orders, so an element may differ by a few f32
rounding steps of its sum of absolute terms S:
``|kernel - plain| <= 1e-5 * |plain| + 256 * 2^-24 * S``. One term
dropped or added moves an element by about S / n_terms, far above that.
"""
import numpy as np
import pytest
import torch

from g2vec_tpu_torch.ops import packed_matmul as pm

pytestmark = pytest.mark.torch

RTOL, ULPS = 1e-5, 256


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(m, g, h, density, seed):
    rng = np.random.default_rng(seed)
    x = rng.random((m, g)) < density
    packed = torch.from_numpy(np.packbits(x, axis=1)).cuda()
    w = torch.from_numpy(rng.standard_normal((g, h)).astype(np.float32)
                         * 0.1).cuda()
    g_out = torch.from_numpy(rng.standard_normal((m, h)).astype(np.float32)
                             ).cuda()
    return torch.from_numpy(x.astype(np.float32)).cuda(), packed, w, g_out


def _assert_close(got, want, abs_sum):
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    tol = RTOL * want.abs() + ULPS * 2.0 ** -24 * abs_sum
    assert int(((got - want).abs() > tol).sum()) == 0


@pytest.mark.parametrize("m,g,h,density", [
    (512, 1024, 128, 0.05), (1001, 1003, 132, 0.02), (3, 9, 4, 0.5),
    (2000, 5850, 128, 80 / 5850)])
def test_kernels_match_plain_versions(cuda, m, g, h, density):
    x, packed, w, g_out = _inputs(m, g, h, density, seed=m + g)
    w16, g16 = w.bfloat16().float(), g_out.bfloat16().float()
    _assert_close(pm.packed_matmul_fwd(packed, w),
                  pm.packed_matmul_fwd_plain(packed, w), x @ w16.abs())
    _assert_close(pm.packed_matmul_bwd(packed, g_out, g),
                  pm.packed_matmul_bwd_plain(packed, g_out, g),
                  x.T @ g16.abs())
    torch.cuda.synchronize()


def test_forward_is_m_invariant_and_backward_reproducible(cuda):
    _, packed, w, g_out = _inputs(1500, 700, 128, 0.03, seed=1)
    full = pm.packed_matmul_fwd(packed, w)
    for rows in (1, 129, 1000):
        assert torch.equal(pm.packed_matmul_fwd(packed[:rows], w),
                           full[:rows])
    dw = pm.packed_matmul_bwd(packed, g_out, 700)
    assert torch.equal(pm.packed_matmul_bwd(packed, g_out, 700), dw)


@pytest.mark.parametrize("h", [1, 6, 10, 130])
def test_any_hidden_width_on_the_card(cuda, h):
    x, packed, w, g_out = _inputs(700, 301, h, 0.05, seed=h)
    w16, g16 = w.bfloat16().float(), g_out.bfloat16().float()
    out = pm.packed_matmul_fwd(packed, w)
    assert out.shape == (700, h) and out.is_contiguous()
    _assert_close(out, pm.packed_matmul_fwd_plain(packed, w), x @ w16.abs())
    dw = pm.packed_matmul_bwd(packed, g_out, 301)
    assert dw.shape == (301, h) and dw.is_contiguous()
    _assert_close(dw, pm.packed_matmul_bwd_plain(packed, g_out, 301),
                  x.T @ g16.abs())
    tw = w.clone().requires_grad_()
    (pm.packed_matmul(packed, tw, grad_rows=500) * g_out).sum().backward()
    _assert_close(tw.grad, pm.packed_matmul_bwd_plain(
        packed[:500], g_out[:500], 301), x[:500].T @ g16[:500].abs())


def _slice_edges(g, h):
    """M one below, at and one above each of the first two row counts at
    which the backward's planned slice count changes."""
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    edges, prev = [], pm._bwd_slices(1, g, h, n_sms).n_slices
    for m in range(2, 5000):
        n = pm._bwd_slices(m, g, h, n_sms).n_slices
        if n != prev:
            edges += [m - 1, m, m + 1]
            prev = n
        if len(edges) == 6:
            return edges
    raise AssertionError("the plan never splits below 5000 rows")


def test_backward_at_k_step_and_slice_edges(cuda):
    g, h = 700, 128
    rows = [16 * k + d for k in (1, 2, 4, 5) for d in (-1, 1)]
    for m in rows + _slice_edges(g, h):
        x, packed, _, g_out = _inputs(m, g, h, 0.05, seed=m)
        _assert_close(pm.packed_matmul_bwd(packed, g_out, g),
                      pm.packed_matmul_bwd_plain(packed, g_out, g),
                      x.T @ g_out.bfloat16().float().abs())


@pytest.mark.parametrize("m,n_slices,rows", [
    (129, 3, 64), (400, 7, 64), (1000, 2, 960), (64, 1, 64)])
def test_backward_under_forced_splits(cuda, m, n_slices, rows):
    """Slices of one stage, a last slice of one row, many slices: each
    plan the kernel may be handed gives the plain version's dW."""
    g, h = 1003, 136
    x, packed, _, g_out = _inputs(m, g, h, 0.04, seed=m + n_slices)
    g16 = g_out.bfloat16()
    plan = pm.BwdSlices(n_slices, rows, n_slices * g * h * 4)
    assert plan.bounds(m)[-1][0] < m <= plan.bounds(m)[-1][1]
    _assert_close(pm._bwd_on_card(packed, g16, g, plan),
                  pm.packed_matmul_bwd_plain(packed, g_out, g),
                  x.T @ g16.float().abs())


def test_backward_refuses_misaligned_packed_and_short_splits(cuda):
    """P reaches 4-byte cp.async copies, and a split must cover every row:
    the wrapper raises before a launch could fault or drop rows."""
    _, packed, _, g_out = _inputs(200, 64, 8, 0.1, seed=6)
    flat = torch.empty(200 * 8 + 1, dtype=torch.uint8, device="cuda")
    shifted = flat[1:].view(200, 8)
    shifted.copy_(packed)
    with pytest.raises(ValueError, match="4-byte aligned"):
        pm.packed_matmul_bwd(shifted, g_out, 64)
    with pytest.raises(ValueError, match="does not cover"):
        pm._bwd_on_card(packed, g_out.bfloat16(), 64, pm.BwdSlices(3, 64, 0))
    _assert_close(pm._bwd_on_card(packed, g_out.bfloat16(), 64,
                                  pm.BwdSlices(4, 64, 0)),
                  pm.packed_matmul_bwd_plain(packed, g_out, 64),
                  pm.unpack_bits(packed, 64).float().T
                  @ g_out.bfloat16().float().abs())


def test_backward_is_bitwise_the_same_across_calls_and_streams(cuda):
    _, packed, _, g_out = _inputs(5000, 1500, 128, 0.02, seed=9)
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert pm._bwd_slices(5000, 1500, 128, n_sms).n_slices > 1
    first = pm.packed_matmul_bwd(packed, g_out, 1500)
    assert torch.equal(pm.packed_matmul_bwd(packed, g_out, 1500), first)
    results = []
    for _ in range(2):
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            results.append(pm.packed_matmul_bwd(packed, g_out, 1500))
        torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    assert all(torch.equal(r, first) for r in results)


def test_forward_at_k_step_and_block_edges(cuda):
    """M one row off a k-step and off a block, and G one gene off a
    k-step, at 999 and at 1,003 (rows not a multiple of 4 bytes, which
    the wrapper pads on the launch)."""
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = {16 * k + d for k in (1, 2, 4, 5) for d in (-1, 1)}
    rows |= {k * pm.FWD_BLOCK_ROWS + d for k in (1, 2) for d in (-1, 1)}
    for m in sorted(rows):
        x, packed, w, _ = _inputs(m, 700, 128, 0.05, seed=m)
        _assert_close(pm.packed_matmul_fwd(packed, w),
                      pm.packed_matmul_fwd_plain(packed, w),
                      x @ w.bfloat16().float().abs())
    for g in (15, 17, 31, 33, 63, 65, 127, 129, 999, 1003):
        x, packed, w, _ = _inputs(300, g, 136, 0.05, seed=g)
        assert pm._fwd_grid(300, 136, n_sms).blocks >= 2
        _assert_close(pm.packed_matmul_fwd(packed, w),
                      pm.packed_matmul_fwd_plain(packed, w),
                      x @ w.bfloat16().float().abs())


def test_forward_keeps_its_residency_and_ragged_blocks(cuda):
    """The forward keeps the resident blocks its waves are counted in,
    and gives the plain version's result on one row, a block less and
    more one row, a ragged last block, and two column tiles."""
    rows = pm.FWD_BLOCK_ROWS
    assert pm.fwd_occupancy() == pm.FWD_BLOCKS_PER_SM
    for m in (1, rows - 1, rows + 1, 3 * rows + 5):
        x, packed, w, _ = _inputs(m, 1003, 136, 0.04, seed=m)
        w16 = pm._pad_cols(w.bfloat16(), 8)
        _assert_close(pm._fwd_on_card(packed, w16)[:, :136],
                      pm.packed_matmul_fwd_plain(packed, w),
                      x @ w.bfloat16().float().abs())


def test_forward_single_bits_hit_every_lane_of_the_a_fragment(cuda):
    """Row r holds gene r alone, for every gene of four k-steps (two
    packed words): each output row is that gene's W row, exactly. This
    reaches every thread-in-group t, both bytes of a k-step and both
    words of a ring stage, in both m-tiles of both row halves."""
    g = 64
    x = np.eye(g, dtype=bool)
    packed = torch.from_numpy(np.packbits(x, axis=1)).cuda()
    w = torch.randn((g, 128), device="cuda")
    out = pm.packed_matmul_fwd(packed, w)
    assert torch.equal(out, w.bfloat16().float())
    # The same rows shifted by one row, so row r sits at another position
    # of its m-tile.
    out = pm.packed_matmul_fwd(torch.cat([packed[-1:], packed]), w)
    assert torch.equal(out[1:], w.bfloat16().float())


def test_forward_is_m_invariant_at_the_edges_of_a_wave(cuda):
    """One full wave of resident blocks, and a row either side of it,
    against a launch of two waves: the same bits for the same rows."""
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    wave = pm.FWD_BLOCKS_PER_SM * n_sms * pm.FWD_BLOCK_ROWS
    assert pm._fwd_grid(wave, 128, n_sms).waves == 1.0
    _, packed, w, _ = _inputs(2 * wave, 700, 128, 0.03, seed=7)
    full = pm.packed_matmul_fwd(packed, w)
    for rows in (wave - 1, wave, wave + 1, wave + pm.FWD_BLOCK_ROWS + 1):
        assert torch.equal(pm.packed_matmul_fwd(packed[:rows], w),
                           full[:rows])


def test_forward_refuses_misaligned_packed(cuda):
    _, packed, w, _ = _inputs(200, 64, 8, 0.1, seed=8)
    flat = torch.empty(200 * 8 + 1, dtype=torch.uint8, device="cuda")
    shifted = flat[1:].view(200, 8)
    shifted.copy_(packed)
    with pytest.raises(ValueError, match="4-byte aligned"):
        pm.packed_matmul_fwd(shifted, w)


def test_kernel_source_has_no_atomics():
    """dW's reproducibility rests on fixed-order sums: no atomic add and
    no reduction instruction anywhere in the kernels' source."""
    import re

    with open(pm.SRC) as f:
        src = f.read()
    assert not re.search(r"\batomic[A-Z]\w*\s*\(", src)
    assert not re.search(r"\b(red|atom)\.", src)


def test_autograd_on_the_card_matches_the_cpu(cuda):
    _, packed, w, g_out = _inputs(300, 260, 16, 0.05, seed=2)
    grads = []
    for dev in ("cuda", "cpu"):
        tw = w.to(dev).bfloat16().requires_grad_()
        out = pm.packed_matmul(packed.to(dev), tw, grad_rows=200)
        (out * g_out.to(dev)).sum().backward()
        assert tw.grad.dtype == torch.bfloat16
        grads.append(tw.grad.float().cpu())
    # dW is rounded to bf16 on both sides: one bf16 ulp apart at most.
    ulp = grads[1].abs() * 2.0 ** -7
    assert bool(((grads[0] - grads[1]).abs() <= ulp).all())


def test_counters_count_card_launches_only(cuda):
    _, packed, w, g_out = _inputs(64, 100, 8, 0.1, seed=3)
    pm.reset_launch_counts()
    pm.packed_matmul_fwd(packed.cpu(), w.cpu())
    pm.packed_matmul_fwd_plain(packed, w)
    assert pm.packed_matmul_fwd.launches == 0
    pm.packed_matmul_fwd(packed, w)
    pm.packed_matmul_bwd(packed, g_out, 100)
    pm.packed_matmul_bwd(packed, g_out, 100)
    assert (pm.packed_matmul_fwd.launches,
            pm.packed_matmul_bwd.launches) == (1, 2)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    _, packed, w, g_out = _inputs(32, 64, 8, 0.1, seed=4)
    with pytest.raises(ValueError, match="contiguous"):
        pm.packed_matmul_fwd(packed.t().contiguous().t(), w)
    with pytest.raises(ValueError, match="aligned"):
        flat = torch.empty(64 * 8 + 1, dtype=torch.bfloat16, device="cuda")
        pm.packed_matmul_fwd(packed, flat[1:].view(64, 8))
    with pytest.raises(ValueError, match="16-byte aligned"):
        flat = torch.empty(32 * 8 + 4, dtype=torch.bfloat16, device="cuda")
        pm.packed_matmul_bwd(packed, flat[4:].view(32, 8), 64)
    with pytest.raises(ValueError, match="packed on"):
        pm.packed_matmul_fwd(packed, w.cpu())


def test_trainer_on_the_card_tracks_the_cpu(cuda):
    from g2vec_tpu_torch.train.trainer import train_cbow
    from g2vec_tpu_torch.weights import params_from_jax

    rng = np.random.default_rng(5)
    dense = rng.random((600, 500)) < 0.05
    labels = (dense[:, :40].sum(1) > dense[:, 40:80].sum(1)).astype(np.int32)
    wi = (np.clip(rng.standard_normal((500, 128)), -2, 2)
          / np.sqrt(128)).astype(np.float32)
    wo = (np.clip(rng.standard_normal((128, 1)), -2, 2)
          / np.sqrt(128)).astype(np.float32)
    runs = {}
    for dev in ("cuda", "cpu"):
        pm.reset_launch_counts()
        runs[dev] = train_cbow(np.packbits(dense, axis=1), labels,
                               n_genes=500, hidden=128, learning_rate=0.002,
                               max_epochs=20, seed=3, device=dev,
                               init=params_from_jax(wi, wo))
        if dev == "cuda":
            epochs = len(runs[dev].history)
            assert pm.packed_matmul_fwd.launches == epochs + 1
            assert pm.packed_matmul_bwd.launches == epochs
    a, b = runs["cuda"], runs["cpu"]
    assert (a.stop_epoch, len(a.history)) == (b.stop_epoch, len(b.history))
    for ha, hb in zip(a.history, b.history):
        assert abs(ha["acc_val"] - hb["acc_val"]) <= 0.01
        np.testing.assert_allclose(ha["loss"], hb["loss"], rtol=1e-4)
    np.testing.assert_allclose(a.w_ih, b.w_ih, rtol=0, atol=1e-4)


@pytest.mark.parametrize("layout", pm.FWD_LAYOUTS)
def test_every_planner_layout_is_bitwise_the_shipped_forward(cuda, layout):
    """Each forward candidate of the tile planner (the tiles library's
    instance) gives the shipped kernel's bits at the ragged edges (M of 1,
    15, 17 and 129 rows; G 999 and 1,003; H 1, 10 and 130), and the plain
    version's result within the tolerance; it keeps the blocks resident
    that its waves are counted in."""
    assert pm.fwd_occupancy(layout=layout) == \
        pm.fwd_layout_info(layout).blocks_per_sm
    for m in (1, 15, 17, 129):
        for g in (999, 1003):
            for h in (1, 10, 130):
                x, packed, w, _ = _inputs(m, g, h, 0.04, seed=m + g + h)
                w16 = pm._pad_cols(w.bfloat16(), 8)
                shipped = pm._fwd_on_card(packed, w16)
                got = pm._fwd_on_card(packed, w16, layout=layout)
                assert torch.equal(got.view(torch.int32),
                                   shipped.view(torch.int32)), (m, g, h)
                _assert_close(got[:, :h], pm.packed_matmul_fwd_plain(packed, w),
                              x @ w.bfloat16().float().abs())


@pytest.mark.parametrize("m,g,h", [(3000, 1003, 130), (129, 999, 10),
                                   (5000, 5850, 128)])
def test_every_planner_slice_count_is_within_tolerance(cuda, m, g, h):
    x, packed, _, g_out = _inputs(m, g, h, 0.04, seed=m)
    g16 = pm._pad_cols(g_out.bfloat16(), 8)
    want = pm.packed_matmul_bwd_plain(packed, g_out, g)
    abs_sum = x.T @ g_out.bfloat16().float().abs()
    for s in pm.tile_candidates(m, g, h)["bwd"]:
        _assert_close(pm.run_bwd_slices(packed, g16, g, s)[:, :h], want,
                      abs_sum)


def test_tuned_trainer_reloads_its_plan_and_repeats_its_bits(cuda, tmp_path):
    """train_cbow(kernel_autotune=True) on the card sweeps at its shapes
    and writes the plan; a second run (a fresh table) loads it without a
    sweep and gives the first run's bits. Each tuned run is held against
    the untuned one: the forward's layouts are all bitwise the shipped
    one, so where the plan keeps the heuristic's backward S the bits are
    the untuned run's, else W_ih is within 1e-4 of it (the bound
    test_trainer_on_the_card_tracks_the_cpu holds the card to). A plan
    installed by hand holds the same: a layout that is not the shipped
    one at the forward's rows gives the untuned bits, and an S off the
    heuristic's stays within 1e-4."""
    from g2vec_tpu_torch import cache as tcache
    from g2vec_tpu_torch.train.trainer import train_cbow

    rng = np.random.default_rng(5)
    dense = rng.random((3000, 500)) < 0.05
    labels = (dense[:, :40].sum(1) > dense[:, 40:80].sum(1)).astype(np.int32)
    path = tcache.autotune_cache_path(str(tmp_path))
    common = dict(n_genes=500, hidden=128, learning_rate=0.002,
                  max_epochs=6, seed=3, device="cuda")
    n_all, n_tr = 3000, 2400
    heur = pm._bwd_slices(n_tr, 500, 128,
                          pm._sm_count(torch.cuda.current_device())).n_slices

    def held(run, s):
        if s == heur:
            assert run.w_ih.tobytes() == base.w_ih.tobytes()
        else:
            np.testing.assert_allclose(run.w_ih, base.w_ih, rtol=0, atol=1e-4)
        assert run.stop_epoch == base.stop_epoch

    pm.reset_tuned()
    base = train_cbow(np.packbits(dense, axis=1), labels, **common)
    runs, events = [], []
    for _ in range(2):
        pm.reset_tuned()
        before = dict(tcache.cache_stats()["autotune"])
        runs.append(train_cbow(np.packbits(dense, axis=1), labels,
                               kernel_autotune=True, autotune_cache_path=path,
                               **common))
        after = tcache.cache_stats()["autotune"]
        events.append({k: after[k] - before.get(k, 0) for k in after
                       if after[k] != before.get(k, 0)})
        tiles = pm.describe_tiles(n_tr, 500, 128)
        assert tiles["bwd"]["source"] == "autotuned"
        assert tiles["fwd"]["source"] == "heuristic"
        assert pm.describe_tiles(n_all, 500, 128)["fwd"]["source"] == \
            "autotuned"
    assert events[0]["sweep"] == 2 and "hit" not in events[0]
    assert events[1] == {"hit": 2}
    assert runs[1].w_ih.tobytes() == runs[0].w_ih.tobytes()
    held(runs[0], runs[0].tile_plans[str(n_tr)]["bwd"])

    tag = pm._autotune_backend_tag("cuda")
    cands = pm.tile_candidates(n_tr, 500, 128)["bwd"]
    other = cands[-1] if cands[-1] != heur else cands[0]
    for s in (heur, other):
        pm.reset_tuned()
        pm._install_tuned(n_all, 500, 128, {"fwd": (2, 2, 64, 4)}, tag)
        pm._install_tuned(n_tr, 500, 128, {"bwd": s}, tag)
        pm.reset_launch_counts()
        run = train_cbow(np.packbits(dense, axis=1), labels, **common)
        assert pm.packed_matmul_fwd.layout_launches == {
            (2, 2, 64, 4): pm.packed_matmul_fwd.launches}
        held(run, s)
    pm.reset_tuned()


def _stream_groups(n_genes=300, n_edges=1500, seed=6):
    rng = np.random.default_rng(seed)
    groups = []
    for _ in range(2):
        src = rng.integers(0, n_genes, n_edges).astype(np.int32)
        dst = rng.integers(0, n_genes, n_edges).astype(np.int32)
        w = (rng.random(n_edges) * 0.5 + 0.5).astype(np.float32)
        groups.append((src, dst, w))
    return groups


def _stream_run(dev, compute_dtype, **kw):
    from g2vec_tpu_torch.train.stream import train_cbow_streaming

    n_genes = 300
    return train_cbow_streaming(
        groups=_stream_groups(n_genes), n_genes=n_genes,
        genes=[f"G{i}" for i in range(n_genes)], hidden=32,
        learning_rate=0.01, max_epochs=6, len_path=12, reps=4,
        shard_paths=400, patience=6, compute_dtype=compute_dtype, seed=3,
        walk_seed=5, device=dev, **kw)


def test_streaming_step_on_the_card_tracks_the_cpu_at_float32(cuda):
    """The streaming trainer's f32 dense path on the card against its CPU
    run: the same shards and votes, equal accuracies (each a count of
    exact 0/1 terms), losses and W_ih within float32 summation-order
    noise compounded through Adam (the full-batch card test's bounds)."""
    a, b = _stream_run("cuda", "float32"), _stream_run("cpu", "float32")
    assert (a.n_paths, a.gene_freq) == (b.n_paths, b.gene_freq)
    assert a.stats.n_shards > 1
    assert len(a.train.history) == len(b.train.history) == 6
    for ha, hb in zip(a.train.history, b.train.history):
        assert abs(ha["acc_val"] - hb["acc_val"]) <= 0.01
        np.testing.assert_allclose(ha["loss"], hb["loss"], rtol=1e-4)
    np.testing.assert_allclose(a.train.w_ih, b.train.w_ih, rtol=0, atol=1e-4)


def test_streaming_bf16_runs_both_kernels_on_every_shard(cuda):
    pm.reset_launch_counts()
    res = _stream_run("cuda", "bfloat16")
    epochs, shards = len(res.train.history), res.stats.n_shards
    assert pm.packed_matmul_bwd.launches == epochs * shards
    assert pm.packed_matmul_fwd.launches == epochs * (shards + 2)
    again = _stream_run("cuda", "bfloat16", prefetch_depth=1,
                        sampler_threads=1)
    assert again.train.w_ih.tobytes() == res.train.w_ih.tobytes()


def test_bf16_shard_step_dw_matches_the_plain_backward(cuda):
    """One shard's step on the card: its train rows, each padded once to
    the kernels' 4-byte stride, through the autograd op; the gradient of
    W_ih (before its bf16 rounding) against the plain backward of the same
    cotangent, within the kernels' tolerance."""
    from g2vec_tpu_torch.models.cbow import masked_bce_loss, output_logits
    from g2vec_tpu_torch.ops.host_walker import (edges_to_csr, plan_shards,
                                                 walk_shard)
    from g2vec_tpu_torch.train.stream import _filter_rows, _shard_split
    from g2vec_tpu_torch.train.trainer import _fused_rows

    n_genes, hidden = 1003, 128
    groups = _stream_groups(n_genes, 6000)
    plan = plan_shards(n_genes, 10, 0, len_path=40)
    x = np.concatenate([walk_shard(None, None, None, n_genes, plan, 0,
                                   seed=g, csr=edges_to_csr(*groups[g],
                                                            n_genes))
                        for g in (0, 1)])
    y = np.repeat(np.array([0, 1], np.int32), plan.group_rows(0))
    keep = _filter_rows(x, y)
    tr, _ = _shard_split(len(keep), 3, 0, 0.2)
    rows = _fused_rows(x[keep][tr], x[:0], n_genes)
    assert rows.shape[1] % 4 == 0 and rows.shape[1] != (n_genes + 7) // 8
    packed = torch.from_numpy(rows).cuda()
    labels = torch.from_numpy(y[keep][tr].astype(np.float32)[:, None]).cuda()
    rng = np.random.default_rng(8)
    w_ih = torch.from_numpy((rng.standard_normal((n_genes, hidden)) * 0.09)
                            .astype(np.float32)).cuda()
    w_ho = torch.from_numpy((rng.standard_normal((hidden, 1)) * 0.09)
                            .astype(np.float32)).cuda()
    w16 = w_ih.to(torch.bfloat16).requires_grad_()
    h = pm.packed_matmul(packed, w16)
    h.retain_grad()
    loss = masked_bce_loss(output_logits(h, w_ho, "bfloat16"), labels,
                           torch.ones_like(labels))
    loss.backward()
    x_dense = pm.unpack_bits(packed, n_genes).float()
    g_out = h.grad
    dw = pm.packed_matmul_bwd(packed, g_out, n_genes)
    _assert_close(dw, pm.packed_matmul_bwd_plain(packed, g_out, n_genes),
                  x_dense.T @ g_out.bfloat16().float().abs())
    assert torch.equal(w16.grad, dw.to(torch.bfloat16))


# ---------------------------------------------------------------------------
# The device walker
# ---------------------------------------------------------------------------

def _walk_graph(n_genes, n_edges, seed):
    """A graph with duplicate edges, zero and negative weights and dead
    ends, as a host CSR."""
    from g2vec_tpu_torch.ops.host_walker import edges_to_csr

    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_genes, n_edges).astype(np.int32)
    dst = rng.integers(0, n_genes, n_edges).astype(np.int32)
    w = (rng.random(n_edges, dtype=np.float32)
         * (10.0 ** rng.integers(-3, 4, n_edges)).astype(np.float32))
    dup = rng.integers(0, n_edges, n_edges // 10)
    src, dst, w = (np.concatenate([a, a[dup]]) for a in (src, dst, w))
    w[rng.random(w.shape[0]) < 0.1] = 0.0
    w[rng.random(w.shape[0]) < 0.05] *= -1.0
    keep = ~(rng.random(n_genes) < 0.2)[src]
    return edges_to_csr(src[keep], dst[keep], w[keep], n_genes)


@pytest.mark.parametrize("n_genes,n_edges,len_path,reps,lo,hi", [
    (1003, 2400, 1, 2, 0, None), (1003, 2400, 2, 2, 0, None),
    (1003, 2400, 80, 3, 517, 2900), (37, 300, 9, 5, 0, None),
    (5850, 13000, 80, 1, 0, None)])
def test_walker_kernel_matches_plain_and_cpp(cuda, n_genes, n_edges,
                                             len_path, reps, lo, hi):
    from g2vec_tpu_torch.native.walker_bindings import walk_paths_packed
    from g2vec_tpu_torch.ops import device_walker as dw

    csr = _walk_graph(n_genes, n_edges, n_genes + len_path)
    dev_csr = dw.upload_csr(csr, n_genes, cuda)
    hi = n_genes * reps if hi is None else hi
    starts = np.tile(np.arange(n_genes, dtype=np.int32), reps)[lo:hi]
    ids = np.arange(lo, hi, dtype=np.uint64)
    args = (dev_csr.indptr, dev_csr.indices, dev_csr.weights,
            torch.from_numpy(starts).to(cuda),
            torch.from_numpy(ids.view(np.int64)).to(cuda), len_path, 77,
            n_genes)
    got = dw.device_walk(*args).cpu().numpy()
    torch.cuda.synchronize()
    want = walk_paths_packed(*csr, n_genes, starts, ids, len_path, 77)
    assert got.tobytes() == want.tobytes()
    assert torch.equal(dw.device_walk_plain(*args).cpu(),
                       torch.from_numpy(got))
    packed = dw.walk_packed_rows_device(None, None, None, n_genes,
                                        len_path=len_path, reps=reps,
                                        seed=77, walker_lo=lo, walker_hi=hi,
                                        csr=dev_csr, device=cuda)
    assert packed.tobytes() == want.tobytes()


def test_walker_counts_card_launches_only(cuda):
    from g2vec_tpu_torch.ops import device_walker as dw

    csr = _walk_graph(64, 300, 1)
    dev_csr = dw.upload_csr(csr, 64, cuda)
    dw.reset_launch_counts()
    none = torch.empty(0, dtype=torch.int32, device=cuda)
    out = dw.device_walk(dev_csr.indptr, dev_csr.indices, dev_csr.weights,
                         none, none.long(), 5, 1, 64)
    assert out.shape == (0, 8) and dw.device_walk.launches == 0
    dw.walk_packed_rows_device(None, None, None, 64, len_path=5, reps=2,
                               seed=1, csr=dev_csr, device=cuda)
    assert dw.device_walk.launches == 1
    dw.walk_packed_rows_device(None, None, None, 64, len_path=5, reps=2,
                               seed=1, csr=csr, device="cpu")
    assert dw.device_walk.launches == 1


@pytest.mark.parametrize("m,len_path", [(1, 5), (257, 20), (1001, 80)])
def test_walk_states_kernel_matches_plain_and_cpp(cuda, m, len_path):
    """The resumable walk kernel against its plain version and the C++
    advance, bitwise, at a ragged walker count; the first avail mask
    holds none of the starts, so every walker suspends on its first step
    with its stream untouched, and the resumes over the other half and
    back run each walk to its end: the packed rows are the one-shot
    C++ walk's."""
    from g2vec_tpu_torch.native.walker_bindings import (init_walk_state,
                                                        walk_paths_packed)
    from g2vec_tpu_torch.ops import device_walker as dw
    from g2vec_tpu_torch.ops import host_walker as thw

    g = 300
    csr = _walk_graph(g, 2000, m + len_path)
    dev_csr = dw.upload_csr(csr, g, cuda)
    rng = np.random.default_rng(m)
    starts = rng.integers(0, g, m).astype(np.int32)
    ids = np.arange(m, dtype=np.uint64)
    paths = np.full((m, len_path), -1, np.int32)
    paths[:, 0] = starts
    states = thw.WalkStateBatch(
        row=np.arange(m, dtype=np.int32), cur=starts.copy(),
        rng=init_walk_state(7, ids), pos=np.ones(m, np.int32), paths=paths)
    avail = np.ones(g, np.uint8)
    avail[starts] = 0
    first = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in (
        states.cur, states.rng.view(np.int64), states.pos, states.paths)]
    plain = [t.clone() for t in first]
    csr_t = (dev_csr.indptr, dev_csr.indices, dev_csr.weights,
             torch.from_numpy(avail).to(cuda))
    dw.reset_launch_counts()
    status = dw.device_walk_states(*csr_t, *first, len_path)
    torch.cuda.synchronize()
    assert dw.device_walk_states.launches == 1
    assert torch.equal(status, dw.walk_states_plain(*csr_t, *plain,
                                                    len_path))
    for got, want in zip(first, plain):
        assert torch.equal(got, want)
    assert bool((status == 1).all()) and bool((first[2] == 1).all())
    assert torch.equal(first[1].cpu(),
                       torch.from_numpy(states.rng.view(np.int64)))
    todo = np.arange(m)
    while todo.size:
        part = states.take(todo)
        native = thw.WalkStateBatch(*(np.copy(getattr(part, f)) for f in (
            "row", "cur", "rng", "pos", "paths")))
        st = dw.advance_walk_states_device(part, dev_csr, g, avail,
                                           len_path)
        np.testing.assert_array_equal(
            st, thw.advance_walk_states(native, csr, g, avail, len_path))
        for f in ("cur", "rng", "pos", "paths"):
            np.testing.assert_array_equal(getattr(part, f),
                                          getattr(native, f))
            getattr(states, f)[todo] = getattr(part, f)
        todo = todo[st == 1]
        avail = 1 - avail
    want = walk_paths_packed(*csr, g, starts, ids, len_path, 7)
    assert thw.pack_finished_paths(states.paths, g).tobytes() == \
        want.tobytes()


def _hub_walk(cuda, n_genes, max_hub, n_starts, len_path, seed):
    """A hub graph (tests/walk_graphs.py) on the card and ``n_starts``
    walkers over it (every hub among the starts): the wrapper's
    arguments, the host CSR and the walkers' starts and stream ids."""
    from g2vec_tpu_torch.ops import device_walker as dw
    from g2vec_tpu_torch.ops.host_walker import edges_to_csr
    from walk_graphs import HUB_DEGREES, hub_graph

    degrees = tuple(d for d in HUB_DEGREES if d <= max_hub)
    csr = edges_to_csr(*hub_graph(n_genes, degrees, seed), n_genes)
    dev_csr = dw.upload_csr(csr, n_genes, cuda)
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, n_genes, n_starts).astype(np.int32)
    starts[:len(degrees)] = np.arange(len(degrees))
    ids = np.arange(7, 7 + n_starts, dtype=np.uint64)
    args = (dev_csr.indptr, dev_csr.indices, dev_csr.weights,
            torch.from_numpy(starts).to(cuda),
            torch.from_numpy(ids.view(np.int64)).to(cuda), len_path, seed,
            n_genes)
    return dev_csr, csr, starts, ids, args


@pytest.mark.parametrize("len_path", [1, 2, 80])
@pytest.mark.parametrize("max_hub", [1, 7, 8, 9, 15, 16, 17, 31, 32, 33,
                                     257, 1000])
def test_walk_kernel_on_hub_graphs_matches_plain_and_cpp(cuda, max_hub,
                                                         len_path):
    """The plan's own group for each largest degree (8 lanes up to 8
    slots, 16 above; one chunk or many), bitwise."""
    from g2vec_tpu_torch.native.walker_bindings import walk_paths_packed
    from g2vec_tpu_torch.ops import device_walker as dw

    dev_csr, csr, starts, ids, args = _hub_walk(cuda, 1500, max_hub, 3001,
                                                len_path, max_hub)
    plan = dw.walk_plan(1500, dev_csr.max_degree)
    assert plan.group == dw.group_for(max(max_hub, 3)) and plan.shared
    got = dw.device_walk(*args, max_degree=dev_csr.max_degree)
    torch.cuda.synchronize()
    want = walk_paths_packed(*csr, 1500, starts, ids, len_path, max_hub)
    assert got.cpu().numpy().tobytes() == want.tobytes()
    assert torch.equal(got, dw.device_walk_plain(*args))


@pytest.mark.parametrize("g, max_hub, instance", [
    (1003, 7, (8, True)), (1024, 1000, (16, True)), (58_112, 7, (8, True)),
    (58_113, 7, (8, False)), (116_224, 33, (16, True)),
    (116_225, 1000, (16, False))])
def test_every_walk_instance_matches_cpp(cuda, g, max_hub, instance):
    """Every instance the plan can choose, (lanes, masks in shared
    memory), reached through the shapes alone: 1,003 genes (rows not a
    multiple of 4 bytes: byte copies), 1,024 (16-byte copies), the most
    genes a block's masks fit for each group (58,112 and 116,224) and one
    more (the masks in the rows); on hub graphs, a ragged walker
    count."""
    from g2vec_tpu_torch.native.walker_bindings import walk_paths_packed
    from g2vec_tpu_torch.ops import device_walker as dw

    dev_csr, csr, starts, ids, args = _hub_walk(cuda, g, max_hub, 2017, 80,
                                                g)
    plan = dw.walk_plan(g, dev_csr.max_degree)
    assert (plan.group, plan.shared) == instance
    dw.reset_launch_counts()
    got = dw.device_walk(*args, max_degree=dev_csr.max_degree)
    torch.cuda.synchronize()
    assert dw.device_walk.launches == 1
    want = walk_paths_packed(*csr, g, starts, ids, 80, g)
    assert got.cpu().numpy().tobytes() == want.tobytes()


def test_walk_kernel_keeps_the_masks_in_the_rows_above_the_threshold(cuda):
    """At G 262,144 no block's masks fit shared memory: the plan keeps
    them in the rows, and the rows are the C++ sampler's and the plain
    version's."""
    from g2vec_tpu_torch.native.walker_bindings import walk_paths_packed
    from g2vec_tpu_torch.ops import device_walker as dw

    g = 262_144
    dev_csr, csr, starts, ids, args = _hub_walk(cuda, g, 1000, 2001, 80, 5)
    plan = dw.walk_plan(g, dev_csr.max_degree)
    assert not plan.shared and plan.smem_bytes == 0 and plan.group == 16
    dw.reset_launch_counts()
    got = dw.device_walk(*args)
    torch.cuda.synchronize()
    assert dw.device_walk.launches == 1
    want = walk_paths_packed(*csr, g, starts, ids, 80, 5)
    assert got.cpu().numpy().tobytes() == want.tobytes()
    assert torch.equal(got, dw.device_walk_plain(*args))


@pytest.mark.parametrize("g, max_hub", [(1003, 7), (1003, 257),
                                        (58_113, 7), (116_225, 257)])
def test_walk_kernel_hands_out_walkers_past_the_grid(cuda, g, max_hub):
    """More walkers than the card holds at once (the groups take the rest
    from the counter), twice on one stream (the counter is kept and
    zeroed again), in each instance."""
    from g2vec_tpu_torch.native.walker_bindings import walk_paths_packed
    from g2vec_tpu_torch.ops import device_walker as dw

    dev_csr, csr, starts, ids, args = _hub_walk(cuda, g, max_hub, 100_003,
                                                80, g + 1)
    want = walk_paths_packed(*csr, g, starts, ids, 80, g + 1)
    for _ in range(2):
        got = dw.device_walk(*args, max_degree=dev_csr.max_degree)
        torch.cuda.synchronize()
        assert got.cpu().numpy().tobytes() == want.tobytes()


def test_walk_kernel_refuses_masks_that_do_not_fit(cuda):
    """Masks in shared memory at a G whose block does not hold them: the
    library refuses the launch (the plan never asks for it)."""
    from g2vec_tpu_torch.ops import device_walker as dw
    from g2vec_tpu_torch.ops.packed_matmul import _launch

    g = 58_113
    _, _, _, _, args = _hub_walk(cuda, g, 1, 33, 8, 1)
    out = torch.empty((33, (g + 7) // 8), dtype=torch.uint8, device=cuda)
    with pytest.raises(RuntimeError, match="CUDA error"):
        _launch(dw._lib().g2v_walk_device, *args[:5], 33, 8, 1, out,
                (g + 7) // 8, 0, 1, dw._counter(out.device))


def _states_run(cuda, dev_csr, csr, starts, len_path):
    """Advance walk states from ``starts`` over alternate halves of the
    genes on the card until none is suspended, each advance held bitwise
    against the plain version and the C++ advance; returns the finished
    paths."""
    from g2vec_tpu_torch.native.walker_bindings import init_walk_state
    from g2vec_tpu_torch.ops import device_walker as dw
    from g2vec_tpu_torch.ops import host_walker as thw

    g, m = dev_csr.n_genes, starts.size
    paths = np.full((m, len_path), -1, np.int32)
    paths[:, 0] = starts
    states = thw.WalkStateBatch(
        row=np.arange(m, dtype=np.int32), cur=starts.copy(),
        rng=init_walk_state(11, np.arange(m, dtype=np.uint64)),
        pos=np.ones(m, np.int32), paths=paths)
    avail = (np.arange(g) < g // 2).astype(np.uint8)
    todo, advances = np.arange(m), 0
    dw.reset_launch_counts()
    while todo.size:
        part = states.take(todo)
        native = thw.WalkStateBatch(*(np.copy(getattr(part, f)) for f in (
            "row", "cur", "rng", "pos", "paths")))
        got = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in (
            part.cur, part.rng.view(np.int64), part.pos, part.paths)]
        plain = [t.clone() for t in got]
        csr_t = (dev_csr.indptr, dev_csr.indices, dev_csr.weights,
                 torch.from_numpy(avail).to(cuda))
        status = dw.device_walk_states(*csr_t, *got, len_path,
                                       max_degree=dev_csr.max_degree)
        torch.cuda.synchronize()
        assert torch.equal(status, dw.walk_states_plain(*csr_t, *plain,
                                                        len_path))
        for a, b in zip(got, plain):
            assert torch.equal(a, b)
        st = thw.advance_walk_states(native, csr, g, avail, len_path)
        np.testing.assert_array_equal(status.cpu().numpy(), st)
        for f, t in zip(("cur", "rng", "pos", "paths"), got):
            arr = t.cpu().numpy()
            np.testing.assert_array_equal(
                arr.view(np.uint64) if f == "rng" else arr,
                getattr(native, f))
            getattr(states, f)[todo] = getattr(native, f)
        todo = todo[st == 1]
        avail = 1 - avail
        advances += 1
    assert dw.device_walk_states.launches == advances >= 2
    return states.paths


@pytest.mark.parametrize("m, max_hub", [(33, 1000), (1001, 1000), (1001, 7),
                                        (60_001, 7), (60_001, 33)])
def test_every_states_instance_matches_plain_and_cpp(cuda, m, max_hub):
    """Both instances of the resumable walk kernel (8 lanes for rows up
    to 8 slots, 16 above) on hub graphs, at ragged walker counts: under
    one warp, a few blocks, and more than the card holds at once (the
    groups take the rest from the counter; rows up to 33 slots there,
    which keeps the plain version's padded rows small); the finished
    paths pack to the one-shot C++ walk's rows."""
    from g2vec_tpu_torch.native.walker_bindings import walk_paths_packed
    from g2vec_tpu_torch.ops import host_walker as thw

    dev_csr, csr, starts, ids, _ = _hub_walk(cuda, 1003, max_hub, m, 80, m)
    paths = _states_run(cuda, dev_csr, csr, starts, 80)
    want = walk_paths_packed(*csr, 1003, starts,
                             np.arange(m, dtype=np.uint64), 80, 11)
    assert thw.pack_finished_paths(paths, 1003).tobytes() == want.tobytes()


def test_states_kernel_keeps_long_prefixes_in_device_memory(cuda):
    """At len_path 1,000 each walker's prefix holds up to 4,000 bytes; the
    kernel scans it in `paths`."""
    dev_csr, csr, starts, _, _ = _hub_walk(cuda, 4000, 1, 999, 1000, 3)
    assert int(np.diff(csr[0]).max()) == 3
    _states_run(cuda, dev_csr, csr, starts, 1000)


def _lane_inputs(b, m, g, h, density, seed):
    rng = np.random.default_rng(seed)
    x = rng.random((b, m, g)) < density
    packed = torch.from_numpy(np.packbits(x, axis=2)).cuda()
    w = torch.from_numpy(rng.standard_normal((b, g, h)).astype(np.float32)
                         * 0.1).cuda()
    g_out = torch.from_numpy(rng.standard_normal((b, m, h)).astype(np.float32)
                             ).cuda()
    return torch.from_numpy(x.astype(np.float32)).cuda(), packed, w, g_out


@pytest.mark.parametrize("b,m,g,h,lanes", [
    (3, 1001, 1003, 132, None), (4, 2000, 5850, 128, [2, 0, 3]),
    (2, 77, 61, 9, [1]), (3, 5000, 700, 128, None)])
def test_lane_kernels_match_plain_and_solo_launches(cuda, b, m, g, h, lanes):
    x, packed, w, g_out = _lane_inputs(b, m, g, h, 30 / g + 0.01, seed=m)
    ids = list(range(b)) if lanes is None else lanes
    w, g_out = w[:len(ids)].contiguous(), g_out[:len(ids)].contiguous()
    rows = m - 3
    out = pm.packed_matmul_lanes_fwd(packed, w, lanes)
    dw = pm.packed_matmul_lanes_bwd(packed, g_out[:, :rows].contiguous(), g,
                                    lanes)
    for i, lane in enumerate(ids):
        w16, g16 = w[i].bfloat16().float(), g_out[i, :rows].bfloat16().float()
        _assert_close(out[i], pm.packed_matmul_fwd_plain(packed[lane], w[i]),
                      x[lane] @ w16.abs())
        _assert_close(dw[i], pm.packed_matmul_bwd_plain(
            packed[lane, :rows], g_out[i, :rows], g),
            x[lane, :rows].T @ g16.abs())
        # Bitwise the solo launch on the lane's own tensors.
        assert torch.equal(out[i], pm.packed_matmul_fwd(
            packed[lane].contiguous(), w[i]))
        assert torch.equal(dw[i], pm.packed_matmul_bwd(
            packed[lane, :rows].contiguous(),
            g_out[i, :rows].contiguous(), g))
    torch.cuda.synchronize()


def test_lane_backward_splits_lanes_over_the_workspace_cap(cuda, monkeypatch):
    _, packed, w, g_out = _lane_inputs(5, 3000, 600, 128, 0.03, seed=9)
    whole = pm.packed_matmul_lanes_bwd(packed, g_out, 600)
    plan = pm._bwd_slices(3000, 600, 128, pm._sm_count(0))
    assert plan.n_slices > 1
    monkeypatch.setattr(pm, "BWD_LANES_WORKSPACE_CAP",
                        2 * plan.workspace_bytes)
    pm.reset_launch_counts()
    assert torch.equal(pm.packed_matmul_lanes_bwd(packed, g_out, 600), whole)
    assert pm.packed_matmul_lanes_bwd.launches == 3


def test_lane_trainer_on_the_card_is_bitwise_the_solo_trainer(cuda):
    from g2vec_tpu_torch.train.trainer import (LaneTrainSpec, train_cbow,
                                               train_cbow_lanes)

    specs = []
    for k, seed in enumerate((3, 7, 11)):
        rng = np.random.default_rng(20 + k)
        dense = rng.random((700, 500)) < 0.04
        labels = (dense[:, :40].sum(1) > dense[:, 40:80].sum(1)
                  ).astype(np.int32)
        specs.append(LaneTrainSpec(np.packbits(dense, axis=1), labels, seed))
    common = dict(n_genes=500, hidden=128, learning_rate=0.01,
                  max_epochs=25, device=cuda)
    pm.reset_launch_counts()
    results, emb = train_cbow_lanes(specs, **common)
    epochs = [len(r.history) for r in results]
    assert pm.packed_matmul_lanes_fwd.launches == max(epochs) + 1
    assert pm.packed_matmul_lanes_bwd.launches == max(epochs)
    assert pm.packed_matmul_fwd.launches == pm.packed_matmul_bwd.launches == 0
    for b, spec in enumerate(specs):
        solo = train_cbow(spec.paths, spec.labels, seed=spec.seed, **common)
        assert (results[b].stop_epoch, results[b].stopped_early) == \
            (solo.stop_epoch, solo.stopped_early)
        assert [(h["acc_val"], h["acc_tr"], h["loss"])
                for h in results[b].history] == \
            [(h["acc_val"], h["acc_tr"], h["loss"]) for h in solo.history]
        assert results[b].w_ih.tobytes() == solo.w_ih.tobytes()
        assert emb[b].cpu().numpy().tobytes() == solo.w_ih.tobytes()


def test_batch_lanes_on_the_card_write_the_solo_files(cuda, tmp_path):
    import dataclasses

    from g2vec_tpu_torch.batch.engine import lane_config, run_batch
    from g2vec_tpu_torch.config import G2VecConfig
    from g2vec_tpu_torch.data.synthetic import (SyntheticSpec,
                                                write_synthetic_tsv)
    from g2vec_tpu_torch.pipeline import run

    files = write_synthetic_tsv(SyntheticSpec(
        n_good=24, n_poor=20, module_size=12, n_background=24,
        n_expr_only=4, n_net_only=4, module_chords=2, background_edges=40,
        seed=7), str(tmp_path))
    cfg = G2VecConfig(expression_file=files["expression"],
                      clinical_file=files["clinical"],
                      network_file=files["network"],
                      result_name=str(tmp_path / "b" / "out"), lenPath=20,
                      numRepetition=3, sizeHiddenlayer=16, epoch=30,
                      numBiomarker=10, seed=11, batch_seeds=3)
    pm.reset_launch_counts()
    res = run_batch(cfg, console=lambda s: None)
    assert pm.packed_matmul_lanes_fwd.launches > 0
    for v, lane in zip(res.variants, res.lanes):
        solo = run(lane_config(dataclasses.replace(
            cfg, batch_seeds=0, result_name=str(tmp_path / "solo")), v),
            console=lambda s: None)
        for a, b in zip(lane.output_files, solo.output_files):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read()


def test_served_jobs_join_on_the_card_and_write_the_solo_files(cuda,
                                                                tmp_path):
    """Two compatible jobs on an in-process daemon on the card: one lane
    batch on the lane kernels, each variant's files its solo run's."""
    import json
    import os

    from g2vec_tpu_torch.batch.engine import _variant_from_dict, lane_config
    from g2vec_tpu_torch.config import G2VecConfig, config_from_job
    from g2vec_tpu_torch.data.synthetic import (SyntheticSpec,
                                                write_synthetic_tsv)
    from g2vec_tpu_torch.pipeline import run
    from g2vec_tpu_torch.serve.daemon import ServeDaemon, ServeOptions

    files = write_synthetic_tsv(SyntheticSpec(
        n_good=24, n_poor=20, module_size=12, n_background=24,
        n_expr_only=4, n_net_only=4, module_chords=2, background_edges=40,
        seed=7), str(tmp_path))
    d = ServeDaemon(ServeOptions(socket_path=str(tmp_path / "s.sock"),
                                 state_dir=str(tmp_path / "state"),
                                 ann_nlist=4), console=lambda s: None)
    jobs = {}
    try:
        for tenant, seeds in (("alice", (0, 1)), ("bob", (2,))):
            job = dict(expression_file=files["expression"],
                       clinical_file=files["clinical"],
                       network_file=files["network"],
                       result_name=str(tmp_path / "out" / tenant),
                       lenPath=20, numRepetition=3, sizeHiddenlayer=16,
                       epoch=30, numBiomarker=10, seed=11, variants=[
                           {"name": f"s{k}", "train_seed": k,
                            "kmeans_seed": k} for k in seeds])
            jobs[d.admit({"job": job, "tenant": tenant})["job_id"]] = job
        pm.reset_launch_counts()
        assert d.step(timeout=0) == 2
        assert pm.packed_matmul_lanes_fwd.launches > 0
        assert d.status()["engine"]["kernel_launches"][
            "packed_matmul_lanes_fwd"] == pm.packed_matmul_lanes_fwd.launches
    finally:
        d.close()
    for jid, job in jobs.items():
        with open(tmp_path / "state" / "results" / f"{jid}.json") as f:
            rec = json.load(f)
        assert rec["status"] == "done" and rec["joined_jobs"] == 2
        base = {k: v for k, v in job.items() if k != "variants"}
        cfg = config_from_job(dict(base, result_name=str(tmp_path / "solo")),
                              G2VecConfig(device="cuda"))
        for obj in job["variants"]:
            solo = run(lane_config(cfg, _variant_from_dict(0, obj, cfg)),
                       console=lambda s: None)
            for a, b in zip(rec["variants"][obj["name"]]["outputs"],
                            solo.output_files):
                with open(a, "rb") as fa, open(b, "rb") as fb:
                    assert fa.read() == fb.read()
        assert os.listdir(tmp_path / "state" / "inventory" / jid)


def test_router_fails_a_job_over_between_card_replicas(cuda, tmp_path):
    """An in-process router over two card replicas: a routed job runs,
    then a streaming job's replica is SIGKILLed at its first cursor and
    the job fails over to the survivor, ending in its solo run's bytes
    with one terminal event fleet-wide."""
    import json
    import os
    import signal
    import threading
    import time

    from g2vec_tpu_torch.batch.engine import _variant_from_dict, lane_config
    from g2vec_tpu_torch.config import G2VecConfig, config_from_job
    from g2vec_tpu_torch.data.synthetic import (SyntheticSpec,
                                                write_synthetic_tsv)
    from g2vec_tpu_torch.pipeline import run
    from g2vec_tpu_torch.serve import client, protocol
    from g2vec_tpu_torch.serve.router import Router, RouterOptions

    files = write_synthetic_tsv(SyntheticSpec(
        n_good=24, n_poor=20, module_size=12, n_background=24,
        n_expr_only=4, n_net_only=4, module_chords=2, background_edges=40,
        seed=7), str(tmp_path))
    fleet = str(tmp_path / "fleet")
    r = Router(RouterOptions(fleet_dir=fleet, replicas=2,
                             listen="127.0.0.1:0", probe_interval=0.3),
               console=lambda s: None)
    th = threading.Thread(target=r.serve_forever, daemon=True)
    th.start()

    def job(name, **kw):
        return dict(expression_file=files["expression"],
                    clinical_file=files["clinical"],
                    network_file=files["network"],
                    result_name=str(tmp_path / "out" / name), lenPath=20,
                    numRepetition=3, sizeHiddenlayer=10, epoch=30,
                    numBiomarker=10, seed=11, **kw)

    stream = job("stream", train_mode="streaming", shard_paths=16,
                 checkpoint_every=4, stream_patience=30)
    jid = protocol.idem_job_id("card-drill")
    holder = {}
    try:
        deadline = time.time() + 180
        while r.tcp_addr is None and th.is_alive() \
                and time.time() < deadline:
            time.sleep(0.1)
        assert r.tcp_addr is not None, "router never bound"
        addr = f"{r.tcp_addr[0]}:{r.tcp_addr[1]}"
        assert client.submit_and_wait(addr, job("first"),
                                      timeout=300)["event"] == "job_done"
        sub = threading.Thread(target=lambda: holder.update(
            rec=client.submit_and_wait(addr, stream, idem_key="card-drill",
                                       timeout=300, poll_deadline_s=300)),
            daemon=True)
        sub.start()
        def events(name):
            path = os.path.join(fleet, name, "metrics.jsonl")
            if not os.path.exists(path):
                return []
            with open(path) as f:
                return [json.loads(line) for line in f]

        victim, deadline = None, time.time() + 120
        while victim is None and time.time() < deadline:
            for name in ("r0", "r1"):
                if any(e.get("job_id") == jid
                       and e.get("state") == "checkpointed"
                       for e in events(name)):
                    victim = name
            time.sleep(0.02)
        assert victim is not None
        os.kill(r.fleet.replica(victim).pid, signal.SIGKILL)
        sub.join(timeout=300)
        assert not sub.is_alive()
        assert holder["rec"]["event"] == "job_done"
        survivor = "r1" if victim == "r0" else "r0"
        assert "resumed" in [e.get("state") for e in events(survivor)
                             if e.get("job_id") == jid]
        assert sum(1 for name in ("r0", "r1") for e in events(name)
                   if e.get("event") == "job_done"
                   and e.get("job_id") == jid) == 1
    finally:
        r._stop.set()
        th.join(timeout=180)
    cfg = config_from_job(dict(stream, result_name=str(tmp_path / "solo")),
                          G2VecConfig(device="cuda"))
    solo = run(lane_config(cfg, _variant_from_dict(0, {"name": "v"}, cfg)),
               console=lambda s: None)
    for a, b in zip(holder["rec"]["variants"]["v"]["outputs"],
                    solo.output_files):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()


def _small_files(tmp_path):
    from g2vec_tpu_torch.data.synthetic import (SyntheticSpec,
                                                write_synthetic_tsv)

    return write_synthetic_tsv(SyntheticSpec(
        n_good=24, n_poor=20, module_size=12, n_background=24,
        n_expr_only=4, n_net_only=4, module_chords=2, background_edges=40,
        seed=7), str(tmp_path))


def test_permutation_scenario_on_the_card_runs_the_lanes(cuda, tmp_path):
    """A permutation scenario on the card: one walk product a group, the
    lane kernels launched for its bucket, and a null replicate's files
    its solo run's bytes."""
    import dataclasses

    from g2vec_tpu_torch.batch.engine import lane_config
    from g2vec_tpu_torch.config import G2VecConfig
    from g2vec_tpu_torch.pipeline import run
    from g2vec_tpu_torch.stats.run import run_scenario

    files = _small_files(tmp_path)
    cfg = G2VecConfig(expression_file=files["expression"],
                      clinical_file=files["clinical"],
                      network_file=files["network"],
                      result_name=str(tmp_path / "s" / "out"), lenPath=20,
                      numRepetition=3, sizeHiddenlayer=16, epoch=30,
                      numBiomarker=10, seed=11, scenario="permutation",
                      replicates=3)
    pm.reset_launch_counts()
    res = run_scenario(cfg, console=lambda s: None)
    assert res.walk_stats["walked"] == 2
    assert pm.packed_matmul_lanes_fwd.launches > 0
    assert pm.packed_matmul_lanes_bwd.launches > 0
    v = res.batch.variants[2]
    solo = run(lane_config(dataclasses.replace(
        cfg, result_name=str(tmp_path / "solo")), v), console=lambda s: None)
    for a, b in zip(res.batch.lanes[2].output_files, solo.output_files):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()


def test_update_fine_tune_on_the_card_runs_the_solo_kernels(cuda,
                                                            tmp_path):
    """A bootstrap update on the card launches both solo kernels in its
    fine-tune; a no-op update launches nothing and republishes the prior
    arrays."""
    from g2vec_tpu_torch.config import G2VecConfig
    from g2vec_tpu_torch.incremental import run_update
    from g2vec_tpu_torch.io.writers import write_inventory_bundle
    from g2vec_tpu_torch.pipeline import run

    files = _small_files(tmp_path)
    cfg = G2VecConfig(expression_file=files["expression"],
                      clinical_file=files["clinical"],
                      network_file=files["network"],
                      result_name=str(tmp_path / "cold"), lenPath=20,
                      numRepetition=3, sizeHiddenlayer=16, epoch=30,
                      numBiomarker=10, seed=11)
    cold = run(cfg, console=lambda s: None)
    bundle = str(tmp_path / "bundle")
    write_inventory_bundle(bundle, cold.embeddings, list(cold.genes),
                           cold.biomarker_scores, {})
    pm.reset_launch_counts()
    up = run_update(cfg, bundle)
    assert up.stats["mode"] == "bootstrap"
    assert pm.packed_matmul_fwd.launches > 0
    assert pm.packed_matmul_bwd.launches > 0
    assert np.isfinite(up.embeddings).all()
    write_inventory_bundle(bundle, up.embeddings, up.genes,
                           up.biomarker_scores, {}, extra_files={
                               "delta_fingerprints.json": up.fingerprints})
    pm.reset_launch_counts()
    noop = run_update(cfg, bundle)
    assert noop.stats["mode"] == "noop"
    assert pm.packed_matmul_fwd.launches == pm.packed_matmul_bwd.launches \
        == 0
    assert noop.embeddings.tobytes() == up.embeddings.tobytes()


# ---------------------------------------------------------------------------
# The split step of the sharded run (train/shard.py) at ranks' widths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_genes,n_ranks,rank,m,h", [
    (1003, 2, 0, 300, 32), (1003, 2, 1, 300, 32), (61, 2, 1, 37, 12),
    (20_000, 2, 1, 2048, 128), (9999, 7, 6, 513, 256)])
def test_split_step_kernels_match_plain_at_rank_widths(cuda, n_genes, n_ranks,
                                                       rank, m, h):
    """A rank's byte columns, staged as the trainer stages them (each row
    padded once to the kernels' stride), at local widths that are no
    multiple of the tiles: the split forward and backward launch the
    kernels and agree with their plain versions on the same tensors."""
    from g2vec_tpu_torch.parallel.shard import ShardSpec
    from g2vec_tpu_torch.train.shard import make_split_fns

    spec = ShardSpec(rank=rank, n_ranks=n_ranks, n_genes=n_genes,
                     embed_shards=n_ranks)
    blo, bhi = spec.byte_range()
    g_local = (bhi - blo) * 8
    rng = np.random.default_rng(n_genes + rank)
    rows = np.packbits(rng.random((m, n_genes)) < 12 / n_genes, axis=1)
    local = np.zeros((m, pm.padded_row_bytes(g_local)), np.uint8)
    local[:, :bhi - blo] = spec.slice_packed(rows)
    packed = torch.from_numpy(local).cuda()
    w = torch.from_numpy(rng.standard_normal((g_local, h)).astype(np.float32)
                         * 0.1).cuda()
    w[spec.g_local:] = 0.0
    dh = torch.from_numpy(rng.standard_normal((m, h)).astype(np.float32)
                          ).cuda()
    fns = make_split_fns("bfloat16", 0.5, g_local)
    x = pm.unpack_bits(packed, g_local).float()
    pm.reset_launch_counts()
    _assert_close(fns.partial_hidden(w, packed),
                  pm.packed_matmul_fwd_plain(packed, w),
                  x @ w.bfloat16().float().abs())
    dw = fns.embed_grad(packed, dh)
    assert tuple(dw.shape) == (g_local, h)
    _assert_close(dw, pm.packed_matmul_bwd_plain(packed, dh, g_local),
                  x.T @ dh.bfloat16().float().abs())
    assert (pm.packed_matmul_fwd.launches,
            pm.packed_matmul_bwd.launches) == (1, 1)
    assert not bool(dw[spec.g_local:].any())    # pad rows get no gradient


_FLEET_RANK = r"""
import json, os, sys
from g2vec_tpu_torch.config import G2VecConfig
from g2vec_tpu_torch.ops import packed_matmul as pm
from g2vec_tpu_torch.parallel import distributed
from g2vec_tpu_torch.pipeline import run
cfg = G2VecConfig(**json.loads(sys.argv[1]))
distributed.initialize()
rank = distributed.process_index()
res = run(cfg, console=lambda s: None)
distributed.shutdown()
print(json.dumps({"rank": rank, "acc_val": float(res.acc_val),
                  "biomarkers": list(res.biomarkers),
                  "fwd": pm.packed_matmul_fwd.launches,
                  "bwd": pm.packed_matmul_bwd.launches,
                  "files": list(res.output_files)}))
"""


def test_two_ranks_share_the_card_on_the_split_kernels(cuda, tmp_path):
    """Two processes on the one card (--distributed --graph-shards 2
    --embed-shards 2, bf16): both finish with the same selections, each
    launched both kernels a step, rank 0 alone wrote, and the run holds
    the band against the card's unsharded run."""
    import json
    import os
    import socket
    import subprocess
    import sys

    from g2vec_tpu_torch.config import G2VecConfig
    from g2vec_tpu_torch.data.synthetic import (SyntheticSpec,
                                                write_synthetic_tsv)
    from g2vec_tpu_torch.pipeline import run

    files = write_synthetic_tsv(SyntheticSpec(
        n_good=30, n_poor=26, module_size=16, shared_module_size=6,
        n_background=24, n_expr_only=4, n_net_only=4, module_chords=3,
        background_edges=40, noise=0.25, shift=1.4, seed=7), str(tmp_path))
    base = dict(expression_file=files["expression"],
                clinical_file=files["clinical"],
                network_file=files["network"], lenPath=20, numRepetition=4,
                sizeHiddenlayer=32, epoch=8, numBiomarker=10, seed=11,
                train_mode="streaming", shard_paths=64, stream_patience=8,
                walker_backend="native")
    plain = run(G2VecConfig(result_name=str(tmp_path / "plain"), **base),
                console=lambda s: None)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cfg = json.dumps(dict(base, result_name=str(tmp_path / "fleet"),
                          distributed=True, graph_shards=2, embed_shards=2,
                          fleet_watchdog_deadline=120.0))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _FLEET_RANK, cfg], text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env=dict(os.environ, PYTHONPATH=root,
                 G2VEC_COORDINATOR=f"127.0.0.1:{port}",
                 G2VEC_PROCESS_ID=str(r), G2VEC_NUM_PROCESSES="2"))
        for r in range(2)]
    out = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], out[0][1][-2000:]
    ranks = [json.loads(o.strip().splitlines()[-1]) for o, _ in out]
    assert ranks[0]["biomarkers"] == ranks[1]["biomarkers"]
    assert ranks[0]["acc_val"] == ranks[1]["acc_val"]
    assert ranks[0]["files"] and not ranks[1]["files"]
    for r in ranks:
        assert r["fwd"] > r["bwd"] > 0
    assert abs(ranks[0]["acc_val"] - plain.acc_val) <= 0.20
    overlap = len(set(ranks[0]["biomarkers"]) & set(plain.biomarkers))
    assert overlap / len(plain.biomarkers) >= 0.6
