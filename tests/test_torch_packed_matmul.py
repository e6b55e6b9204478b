"""The port's packed matmul (plain CPU path) against the JAX Pallas kernels.

The JAX side runs ``g2vec_tpu.ops.packed_matmul.packed_matmul`` in
interpret mode on ``pack_blockwise`` of the same dense 0/1 matrix; the
port gets ``np.packbits`` of it. Tolerances:

- forward: rtol 1e-5, atol 1e-5 — f32 sums of the same bf16 values, taken
  in a different order;
- gradient with W in f32: rtol 1e-5, no atol (same reason);
- gradient with W in bf16 (as the trainer passes it): both sides round dW
  to bf16, so one bf16 ulp of difference is allowed per element.

The card-side comparison of the CUDA kernels with these plain versions is
in tests/test_torch_cuda.py and chip_smoke.py.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from g2vec_tpu.ops import packed_matmul as jpm
from g2vec_tpu_torch.ops import packed_matmul as tpm
from g2vec_tpu_torch.ops import packed_matmul_probe as probe

pytestmark = pytest.mark.torch

M, G, H = 512, 1024, 128


def _inputs(rng, m, g, h, density=0.05):
    x = (rng.random((m, g)) < density).astype(np.uint8)
    w = (rng.standard_normal((g, h)) * 0.1).astype(np.float32)
    return x, w


def _bf16_ulp(a):
    """One bf16 ulp at each element of ``a`` (8 significant bits)."""
    a = np.abs(a.astype(np.float64))
    exp = np.floor(np.log2(np.where(a > 0, a, 1.0)))
    return np.where(a > 0, 2.0 ** (exp - 7), 0.0)


def test_forward_matches_jax_pallas(rng):
    x, w = _inputs(rng, M, G, H)
    ref = np.asarray(jpm.packed_matmul(jnp.asarray(jpm.pack_blockwise(x)),
                                       jnp.asarray(w), True))
    out = tpm.packed_matmul(torch.from_numpy(np.packbits(x, axis=1)),
                            torch.from_numpy(w))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("w_dtype", ["float32", "bfloat16"])
def test_gradient_matches_jax_pallas(rng, w_dtype):
    x, w = _inputs(rng, M, G, H)
    cot = rng.standard_normal((M, H)).astype(np.float32)
    p = jnp.asarray(jpm.pack_blockwise(x))
    jw = jnp.asarray(w).astype(jnp.dtype(w_dtype))
    ref = jax.grad(lambda ww: jnp.sum(jpm.packed_matmul(p, ww, True)
                                      * jnp.asarray(cot)))(jw)
    tw = torch.from_numpy(w).to(getattr(torch, w_dtype)).requires_grad_()
    out = tpm.packed_matmul(torch.from_numpy(np.packbits(x, axis=1)), tw)
    (out * torch.from_numpy(cot)).sum().backward()
    assert tw.grad.dtype == tw.dtype
    got = tw.grad.float().numpy()
    want = np.asarray(ref.astype(jnp.float32))
    if w_dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    else:
        assert np.all(np.abs(got - want) <= _bf16_ulp(want))


def test_gradient_reaches_w_only_and_grad_rows(rng):
    x, w = _inputs(rng, 96, 200, 16)
    packed = torch.from_numpy(np.packbits(x, axis=1))
    tw = torch.from_numpy(w).requires_grad_()
    cot = torch.from_numpy(rng.standard_normal((96, 16)).astype(np.float32))
    out = tpm.packed_matmul(packed, tw, grad_rows=40)
    live = [f for f, _ in out.grad_fn.next_functions if f is not None]
    assert len(live) == 1 and type(live[0]).__name__ == "AccumulateGrad"
    (out * cot).sum().backward()
    assert not packed.requires_grad and packed.grad is None
    # Rows past grad_rows carry a cotangent but contribute nothing.
    want = tpm.packed_matmul_bwd_plain(packed[:40], cot[:40], 200)
    assert torch.equal(tw.grad, want)


def test_ragged_shape_against_dense(rng):
    m, g, h = 300, 1003, 20
    x, w = _inputs(rng, m, g, h, density=0.03)
    packed = torch.from_numpy(np.packbits(x, axis=1))
    w16 = torch.from_numpy(w).bfloat16().float().numpy().astype(np.float64)
    out = tpm.packed_matmul_fwd(packed, torch.from_numpy(w))
    np.testing.assert_allclose(out.numpy(), x.astype(np.float64) @ w16,
                               rtol=1e-5, atol=1e-5)
    cot = rng.standard_normal((m, h)).astype(np.float32)
    c16 = torch.from_numpy(cot).bfloat16().float().numpy().astype(np.float64)
    dw = tpm.packed_matmul_bwd(packed, torch.from_numpy(cot), g)
    np.testing.assert_allclose(dw.numpy(), x.T.astype(np.float64) @ c16,
                               rtol=1e-5, atol=1e-5)


def test_unpack_bits_is_packbits_order(rng):
    x = (rng.random((7, 45)) < 0.3).astype(np.uint8)
    got = tpm.unpack_bits(torch.from_numpy(np.packbits(x, axis=1)), 45,
                          torch.uint8)
    assert np.array_equal(got.numpy(), x)


def test_wrappers_reject_what_no_kernel_takes(rng):
    x, w = _inputs(rng, 8, 64, 8)
    packed = torch.from_numpy(np.packbits(x, axis=1))
    with pytest.raises(ValueError, match="uint8"):
        tpm.packed_matmul_fwd(packed.int(), torch.from_numpy(w))
    with pytest.raises(ValueError, match="width"):
        tpm.packed_matmul_fwd(packed[:, :4], torch.from_numpy(w))
    with pytest.raises(ValueError, match="g_out"):
        tpm.packed_matmul_bwd(packed, torch.zeros(9, 8), 64)
    # A tensor that is neither on the CPU nor on a card reaches no plain
    # version: the wrapper raises instead.
    with pytest.raises(ValueError, match="no kernel"):
        tpm.packed_matmul_fwd(packed.to("meta"), torch.from_numpy(w).to("meta"))
    with pytest.raises(ValueError, match="grad_rows"):
        tpm.packed_matmul(packed, torch.from_numpy(w), grad_rows=9)


def test_cpu_calls_do_not_count_as_kernel_launches(rng):
    x, w = _inputs(rng, 8, 64, 8)
    fwd0, bwd0 = tpm.packed_matmul_fwd.launches, tpm.packed_matmul_bwd.launches
    packed = torch.from_numpy(np.packbits(x, axis=1))
    tpm.packed_matmul_bwd(packed, tpm.packed_matmul_fwd(packed,
                                                        torch.from_numpy(w)), 64)
    assert (tpm.packed_matmul_fwd.launches,
            tpm.packed_matmul_bwd.launches) == (fwd0, bwd0)


@pytest.mark.parametrize("g,h", [(5850, 128), (1003, 10), (60000, 1024)])
@pytest.mark.parametrize("m", [1, 15, 16, 17, 32319, 10 ** 6])
def test_backward_split_plan(m, g, h):
    n_sms = 132
    plan = tpm._bwd_slices(m, g, h, n_sms)
    assert plan == tpm._bwd_slices(m, g, h, n_sms)
    assert plan.n_slices >= 1 and plan.rows % tpm.BWD_STAGE_ROWS == 0
    bounds = plan.bounds(m)
    assert bounds[0][0] == 0 and bounds[-1][1] == m
    assert all(lo < hi for lo, hi in bounds)
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    if m < 2 * tpm.BWD_MIN_SLICE_ROWS:
        assert plan.n_slices == 1
    h8 = -(-h // 8) * 8
    assert plan.workspace_bytes <= tpm.BWD_WORKSPACE_CAP
    assert plan.workspace_bytes == (
        plan.n_slices * g * h8 * 4 if plan.n_slices > 1 else 0)
    # The first pass fits in BWD_WAVES waves of resident blocks.
    tiles = -(-g // tpm.BWD_BLOCK_GENES) * -(-h8 // tpm.BWD_BLOCK_COLS)
    assert (plan.n_slices == 1 or plan.n_slices * tiles
            <= tpm.BWD_WAVES * tpm.BWD_BLOCKS_PER_SM * n_sms)


def test_backward_split_plan_at_the_example_shape():
    # 46 gene tiles fill 506 of two waves' 528 resident blocks in 11
    # slices of 2,944 rows.
    plan = tpm._bwd_slices(32319, 5850, 128, 132)
    assert (plan.n_slices, plan.rows) == (11, 2944)
    assert plan.workspace_bytes == 11 * 5850 * 128 * 4


@pytest.mark.parametrize("m,n", [(1, 1), (64, 3), (32319, 5), (32319, 6),
                                 (32319, 17), (10 ** 6, 1000)])
def test_backward_split_of_a_given_count(m, n):
    plan = tpm._bwd_split(m, n, 5850, 128)
    assert 1 <= plan.n_slices <= n and plan.rows % tpm.BWD_STAGE_ROWS == 0
    assert plan.rows * (plan.n_slices - 1) < m <= plan.rows * plan.n_slices


def _kernel_constants():
    """The .cu's namespace-scope ``constexpr int`` constants, evaluated."""
    import re

    with open(tpm.SRC) as f:
        src = f.read()
    env = {}
    for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", src,
                                 re.M):
        env[name] = eval(expr.replace("/", "//"), {"__builtins__": {}}, env)
    return src, env


def test_backward_plan_constants_match_the_kernel_source():
    """_bwd_slices plans from the kernel's tile; the .cu's constexprs are
    its one source, and the Python copy must equal them."""
    _, env = _kernel_constants()
    assert (env["kBwdGenes"], env["kBwdCols"], env["kBwdRows"],
            env["kBwdBlocksPerSM"]) == (
        tpm.BWD_BLOCK_GENES, tpm.BWD_BLOCK_COLS, tpm.BWD_STAGE_ROWS,
        tpm.BWD_BLOCKS_PER_SM)


def test_forward_plan_constants_match_the_kernel_source():
    """_fwd_grid counts blocks and waves from the kernel's block tile and
    residency, and the forward is one instance: no template to dispatch."""
    src, env = _kernel_constants()
    assert (env["kFwdRows"], env["kFwdCols"], env["kFwdBlocksPerSM"]) == (
        tpm.FWD_BLOCK_ROWS, tpm.FWD_BLOCK_COLS, tpm.FWD_BLOCKS_PER_SM)
    assert env["kFwdWords"] * 4 % tpm.P_ROW_ALIGN == 0
    assert not re.search(r"pm_fwd_kernel<(?!<<)", src)


@pytest.mark.parametrize("h", [1, 128, 130, 1024])
@pytest.mark.parametrize("m", [1, 15, 16, 17, 33792, 33793, 32319, 40399,
                               10 ** 6])
def test_forward_tile_plan(m, h):
    n_sms = 132
    grid = tpm._fwd_grid(m, h, n_sms)
    assert grid == tpm._fwd_grid(m, h, n_sms)
    # Every row and column lies in exactly one block.
    row_blocks, col_blocks = -(-m // tpm.FWD_BLOCK_ROWS), -(-h // 128)
    assert grid.blocks == row_blocks * col_blocks
    assert (row_blocks - 1) * tpm.FWD_BLOCK_ROWS < m
    assert row_blocks * tpm.FWD_BLOCK_ROWS >= m
    assert grid.waves == grid.blocks / (tpm.FWD_BLOCKS_PER_SM * n_sms)


def test_forward_tile_plan_at_the_example_shape():
    # [train | val]: 316 blocks of 128 rows, 1.20 waves of 264 slots; one
    # full wave is 264 blocks, 33,792 rows.
    assert tpm._fwd_grid(40399, 128, 132) == (316, 316 / 264)
    assert tpm._fwd_grid(33792, 128, 132) == (264, 1.0)


def _layout_constants(src):
    env = {}
    for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", src,
                                 re.M):
        env[name] = eval(expr.replace("/", "//"), {"__builtins__": {}}, env)
    return env


@pytest.mark.parametrize("layout", probe.LAYOUTS)
def test_probe_layouts_edit_only_their_constants(layout):
    """Each layout the forward is timed beside is the source with its
    three constexprs changed, tiles whole copies over the block's threads
    and fits two blocks' rings in an SM's 228 KB of shared memory."""
    src = probe.source()
    assert probe.layout_of(src) in probe.LAYOUTS
    edited = probe.with_layout(src, layout)
    assert probe.layout_of(edited) == layout
    changed = [(a, b) for a, b in zip(src.splitlines(), edited.splitlines())
               if a != b]
    assert len(src.splitlines()) == len(edited.splitlines())
    assert all(a.startswith("constexpr int kFwd") for a, _ in changed)
    env = _layout_constants(edited)
    assert env["kFwdWChunks"] * 8 * env["kFwdThreads"] == (
        env["kFwdGenes"] * env["kFwdCols"])
    assert env["kFwdPWords"] * env["kFwdThreads"] == (
        env["kFwdRows"] * env["kFwdWords"]) and env["kFwdPWords"] > 0
    assert env["kFwdNTiles"] % 2 == 0 and env["kFwdGenes"] % 32 == 0
    assert env["kFwdBlocksPerSM"] * (env["kFwdSmem"] + 1024) <= 228 * 1024


@pytest.mark.parametrize("name", sorted(probe.STRIPPED))
def test_probe_stripped_copies_edit_the_forward_alone(name):
    """Each stripped copy's edits match the forward's body (a kernel edit
    that breaks one fails here, not on the card) and leave the rest of
    the source as it is."""
    src = probe.source()
    edited = probe.stripped(src, probe.STRIPPED[name])
    assert edited != src
    cut = src.index("pm_bwd_kernel(const")
    assert edited.endswith(src[cut:])
    assert edited.startswith(src[:src.index("pm_fwd_kernel(const")])


def test_padded_rows_give_bitwise_equal_plain_outputs(rng):
    from g2vec_tpu_torch.train.trainer import _fused_rows

    for g in (1003, 999, 1024):
        x, w = _inputs(rng, 90, g, 16, density=0.03)
        narrow = np.packbits(x, axis=1)
        padded = _fused_rows(narrow[:60], narrow[60:], g)
        assert padded.shape == (90, tpm.padded_row_bytes(g))
        assert padded.shape[1] % tpm.P_ROW_ALIGN == 0
        p, q = torch.from_numpy(narrow), torch.from_numpy(padded)
        tw = torch.from_numpy(w)
        assert torch.equal(tpm.packed_matmul_fwd(q, tw),
                           tpm.packed_matmul_fwd(p, tw))
        cot = torch.from_numpy(
            rng.standard_normal((90, 16)).astype(np.float32))
        assert torch.equal(tpm.packed_matmul_bwd(q, cot, g),
                           tpm.packed_matmul_bwd(p, cot, g))


def test_packed_width_is_the_genes_bytes_or_their_padding(rng):
    x, w = _inputs(rng, 8, 1003, 8)
    packed = torch.from_numpy(np.packbits(x, axis=1))       # 126 bytes
    tw = torch.from_numpy(w)
    wide = torch.nn.functional.pad(packed, (0, 2))           # padded: 128
    assert torch.equal(tpm.packed_matmul_fwd(wide, tw),
                       tpm.packed_matmul_fwd(packed, tw))
    for width in (125, 127, 129, 132):
        bad = torch.nn.functional.pad(packed, (0, width - 126))
        with pytest.raises(ValueError, match="width"):
            tpm.packed_matmul_fwd(bad, tw)
        with pytest.raises(ValueError, match="width"):
            tpm.packed_matmul_bwd(bad, torch.zeros(8, 8), 1003)


@pytest.mark.parametrize("width,multiple,want", [
    (6, 4, 8), (8, 4, 8), (1, 8, 8), (10, 8, 16), (130, 8, 136)])
def test_pad_cols_appends_zero_columns(rng, width, multiple, want):
    t = torch.from_numpy(rng.standard_normal((3, width)).astype(np.float32))
    padded = tpm._pad_cols(t, multiple)
    assert padded.shape == (3, want) and padded.is_contiguous()
    assert torch.equal(padded[:, :width], t)
    assert not padded[:, width:].any()
    assert (padded is t) == (want == width)
