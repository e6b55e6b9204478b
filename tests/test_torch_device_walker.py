"""The port's device walker (``g2vec_tpu_torch.ops.device_walker``) against
both of the reference's samplers, on the CPU.

- The stream: the port's numpy helpers equal the reference's
  ``splitmix64_ref``/``uniform01_ref``/``init_walk_state_np``, and the
  torch halves that the plain version carries give the same words, the
  same uniforms and the same first states.
- The plain walk (what a CPU tensor runs) is byte-equal to the port's C++
  walker and to ``g2vec_tpu.ops.host_walker.walk_packed_rows`` on seeded
  graphs with duplicate edges, zero and negative weights and dead ends,
  at ``len_path`` 1 and up, on start subsets and walker ranges;
  ``walk_shard_device`` to the reference's ``walk_shard`` across plans;
  ``generate_path_set_device`` to ``generate_path_set_native``; both
  record their parts (the kernel, the rows' copy, the row set) as spans
  nested in the caller's.
- One case against the reference's own device walker,
  ``g2vec_tpu.ops.device_walker.walk_packed_rows_device``. Its ``_x64``
  imports ``jax.experimental.enable_x64``, which this jax no longer has;
  the test swaps in ``jax.enable_x64(True)`` with ``monkeypatch`` (a
  test-only oracle: no file of the reference changes).
- The wrapper: a CPU tensor takes the plain version and counts no launch;
  a tensor on a device without a kernel raises; bad arguments raise.
"""
import os
import re

import jax
import numpy as np
import pytest
import torch

import g2vec_tpu.ops.device_walker as jdw
from g2vec_tpu.ops import host_walker as jhw
from g2vec_tpu_torch.native.walker_bindings import walk_paths_packed
from g2vec_tpu_torch.ops import device_walker as dw
from g2vec_tpu_torch.ops import host_walker as thw
from g2vec_tpu_torch.utils.timing import StageTimer, span

pytestmark = pytest.mark.torch


def _graph(rng, g, e, dup=0.1, zero=0.1, neg=0.05, dead=0.2):
    """A directed graph with duplicate edges, zero and negative weights
    (never eligible) and genes without out-edges (dead ends)."""
    src = rng.integers(0, g, e).astype(np.int32)
    dst = rng.integers(0, g, e).astype(np.int32)
    w = (rng.random(e, dtype=np.float32)
         * (10.0 ** rng.integers(-3, 4, size=e)).astype(np.float32))
    if e:
        extra = rng.integers(0, e, int(e * dup))
        src, dst, w = (np.concatenate([a, a[extra]]) for a in (src, dst, w))
    w[rng.random(w.shape[0]) < zero] = 0.0
    w[rng.random(w.shape[0]) < neg] *= -1.0
    keep = ~(rng.random(g) < dead)[src]
    return src[keep], dst[keep], w[keep]


def _lanes_to_u64(h, lo):
    return ((h.numpy().astype(np.uint64) << np.uint64(32))
            | lo.numpy().astype(np.uint64))


def _to_lanes(states):
    v = torch.from_numpy(states.view(np.int64))
    return (v >> 32) & 0xFFFFFFFF, v & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# The stream
# ---------------------------------------------------------------------------

def test_splitmix64_words_and_uniforms_match_reference():
    rng = np.random.default_rng(11)
    states = rng.integers(0, 2 ** 64, size=128, dtype=np.uint64)
    states[:3] = [0, 2 ** 64 - 1, dw.GOLDEN]
    sh, sl = _to_lanes(states)
    for _ in range(7):
        nsh, nsl, zh, zl = dw.splitmix64_lanes(sh, sl)
        new, word = _lanes_to_u64(nsh, nsl), _lanes_to_u64(zh, zl)
        u = dw.uniform01_lanes(zh, zl).numpy()
        for i, s in enumerate(states):
            want_state, want_word = jdw.splitmix64_ref(int(s))
            assert dw.splitmix64_ref(int(s)) == (want_state, want_word)
            assert dw.uniform01_ref(int(s)) == jdw.uniform01_ref(int(s))
            assert (int(new[i]), int(word[i])) == (want_state, want_word)
            assert u[i] == float(want_word >> 11) * 2.0 ** -53
        states, sh, sl = new, nsh, nsl


@pytest.mark.parametrize("seed", [0, 1, 7, 2 ** 63, 2 ** 63 + 5,
                                  2 ** 64 - 1, 0xDEADBEEF])
def test_init_state_matches_reference(seed):
    wids = np.concatenate([np.arange(64, dtype=np.uint64),
                           np.array([2 ** 64 - 1, 2 ** 40 + 3], np.uint64)])
    want = jdw.init_walk_state_np(seed, wids)
    np.testing.assert_array_equal(dw.init_walk_state_np(seed, wids), want)
    got = dw.init_state_lanes(seed, torch.from_numpy(wids.view(np.int64)))
    np.testing.assert_array_equal(_lanes_to_u64(*got), want)


# ---------------------------------------------------------------------------
# The plain walk against both of the reference's samplers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("trial", range(6))
def test_plain_walk_matches_cpp_and_reference(trial):
    rng = np.random.default_rng(100 + trial)
    g = int(rng.integers(5, 150))
    src, dst, w = _graph(rng, g, int(rng.integers(0, g * 6 + 1)))
    length = (1, 2, 80)[trial] if trial < 3 else int(rng.integers(3, 12))
    reps = int(rng.integers(1, 4))
    seed = int(rng.integers(0, 2 ** 63))
    got = dw.walk_packed_rows_device(src, dst, w, g, len_path=length,
                                     reps=reps, seed=seed, device="cpu")
    assert got.shape == (g * reps, (g + 7) // 8)
    for want in (thw.walk_packed_rows(src, dst, w, g, len_path=length,
                                      reps=reps, seed=seed),
                 jhw.walk_packed_rows(src, dst, w, g, len_path=length,
                                      reps=reps, seed=seed)):
        assert got.tobytes() == want.tobytes()


def test_start_subsets_and_walker_ranges_match():
    rng = np.random.default_rng(5)
    g = 97
    src, dst, w = _graph(rng, g, 500)
    starts = np.sort(rng.choice(g, 30, replace=False)).astype(np.int32)
    csr = thw.edges_to_csr(src, dst, w, g)
    for lo, hi in ((0, None), (7, 55), (31, 32), (40, 40)):
        got = dw.walk_packed_rows_device(src, dst, w, g, len_path=9, reps=2,
                                         seed=3, starts=starts, walker_lo=lo,
                                         walker_hi=hi, device="cpu")
        want = jhw.walk_packed_rows(src, dst, w, g, len_path=9, reps=2,
                                    seed=3, starts=starts, walker_lo=lo,
                                    walker_hi=hi)
        assert got.tobytes() == want.tobytes()
        hi = 60 if hi is None else hi
        cpp = walk_paths_packed(*csr, g, np.tile(starts, 2)[lo:hi],
                                np.arange(lo, hi, dtype=np.uint64), 9, 3)
        assert got.tobytes() == cpp.tobytes()
    with pytest.raises(ValueError, match="walker range"):
        dw.walk_packed_rows_device(src, dst, w, g, len_path=9, reps=2,
                                   seed=3, walker_lo=5, walker_hi=4,
                                   device="cpu")
    with pytest.raises(ValueError, match="outside"):
        dw.walk_packed_rows_device(src, dst, w, g, len_path=9, reps=1,
                                   seed=3, starts=np.array([g]),
                                   device="cpu")


@pytest.mark.parametrize("shard_paths", [16, 64, 0])
def test_walk_shard_device_matches_reference_walk_shard(shard_paths):
    rng = np.random.default_rng(17)
    g, reps = 61, 3
    src, dst, w = _graph(rng, g, 300)
    plan_t = thw.plan_shards(g, reps, shard_paths, len_path=7)
    plan_j = jhw.plan_shards(g, reps, shard_paths, len_path=7)
    csr = dw.upload_csr(thw.edges_to_csr(src, dst, w, g), g, "cpu")
    assert plan_t.n_shards == plan_j.n_shards
    for s in range(plan_t.n_shards):
        want = jhw.walk_shard(src, dst, w, g, plan_j, s, seed=9)
        got = dw.walk_shard_device(src, dst, w, g, plan_t, s, seed=9,
                                   device="cpu")
        np.testing.assert_array_equal(got, want)
        packed, rows = dw.walk_shard_device_arrays(None, None, None, g,
                                                   plan_t, s, seed=9,
                                                   csr=csr, device="cpu")
        assert rows == plan_t.group_rows(s)
        np.testing.assert_array_equal(packed.numpy(), want)


def test_shard_init_is_the_reference_walker_order():
    plan = thw.plan_shards(23, 4, 40, len_path=5)
    jplan = jhw.plan_shards(23, 4, 40, len_path=5)
    starts = np.arange(100, 123, dtype=np.int32)
    for s in range(plan.n_shards):
        cur, rng, _, _ = jdw._shard_init(jplan, s, 5, starts)
        got_starts, ids = dw._shard_init(plan, s, starts)
        np.testing.assert_array_equal(got_starts, cur)
        np.testing.assert_array_equal(dw.init_walk_state_np(5, ids), rng)


def test_plain_walk_matches_the_reference_device_walker(monkeypatch):
    monkeypatch.setattr(jdw, "_x64", lambda: jax.enable_x64(True))
    rng = np.random.default_rng(23)
    g = 60
    src, dst, w = _graph(rng, g, 400)
    want = jdw.walk_packed_rows_device(src, dst, w, g, len_path=12, reps=2,
                                       seed=9)
    got = dw.walk_packed_rows_device(src, dst, w, g, len_path=12, reps=2,
                                     seed=9, device="cpu")
    assert got.tobytes() == want.tobytes()


def test_generate_path_set_device_equals_native():
    rng = np.random.default_rng(31)
    g = 80
    src, dst, w = _graph(rng, g, 420)
    kw = dict(len_path=10, reps=3, seed=4)
    got = dw.generate_path_set_device(src, dst, w, g, device="cpu", **kw)
    assert got == thw.generate_path_set_native(src, dst, w, g, **kw)
    assert got == jhw.generate_path_set_native(src, dst, w, g, **kw)


def test_both_walkers_record_their_parts_as_nested_spans():
    rng = np.random.default_rng(31)
    g = 80
    src, dst, w = _graph(rng, g, 420)
    kw = dict(len_path=10, reps=3, seed=4)
    timer = StageTimer()
    with timer.stage("paths"):
        with span("walk_g"):
            dw.generate_path_set_device(src, dst, w, g, device="cpu", **kw)
        with span("walk_p"):
            thw.generate_path_set_native(src, dst, w, g, **kw)
    spans = timer.extras_dict()["paths"]
    secs = spans["span_s"]
    assert set(secs) == {"walk_g", "walk_g/walk_kernel", "walk_g/rows_copy",
                         "walk_g/row_set", "walk_p", "walk_p/row_set"}
    assert spans["span_n"] == dict.fromkeys(secs, 1)
    assert (secs["walk_g/walk_kernel"] + secs["walk_g/rows_copy"]
            + secs["walk_g/row_set"]) <= secs["walk_g"]
    assert secs["walk_p/row_set"] <= secs["walk_p"]


# ---------------------------------------------------------------------------
# The wrapper and its inputs
# ---------------------------------------------------------------------------

def _cpu_args(n_genes=20, len_path=6):
    rng = np.random.default_rng(2)
    csr = thw.edges_to_csr(*_graph(rng, n_genes, 80), n_genes)
    dev_csr = dw.upload_csr(csr, n_genes, "cpu")
    starts = torch.arange(n_genes, dtype=torch.int32)
    ids = torch.arange(n_genes, dtype=torch.int64)
    return csr, (dev_csr.indptr, dev_csr.indices, dev_csr.weights, starts,
                 ids, len_path, 5, n_genes)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    csr, args = _cpu_args()
    dw.reset_launch_counts()
    got = dw.device_walk(*args)
    assert dw.device_walk.launches == 0
    assert got.dtype == torch.uint8 and got.shape == (20, 3)
    want = walk_paths_packed(*csr, 20, np.arange(20, dtype=np.int32),
                             np.arange(20, dtype=np.uint64), 6, 5)
    assert got.numpy().tobytes() == want.tobytes()
    paths = dw.walk_paths_plain(*args[:-1])
    assert torch.equal(dw.pack_paths(paths, 20), got)


def test_wrapper_refuses_what_it_cannot_walk():
    _, args = _cpu_args()
    meta = tuple(a.to("meta") if isinstance(a, torch.Tensor) else a
                 for a in args)
    with pytest.raises(ValueError, match="no kernel for device"):
        dw.device_walk(*meta)
    bad = list(args)
    bad[3] = args[3].long()
    with pytest.raises(ValueError, match="starts must be"):
        dw.device_walk(*bad)
    bad = list(args)
    bad[4] = args[4][:-1]
    with pytest.raises(ValueError, match="stream_ids has"):
        dw.device_walk(*bad)
    with pytest.raises(ValueError, match="len_path"):
        dw.device_walk(*args[:5], 0, *args[6:])
    with pytest.raises(ValueError, match="indptr has"):
        dw.device_walk(*args[:7], 21)


def test_upload_csr_refuses_a_bad_csr():
    indptr = np.array([0, 1, 2], np.int32)
    with pytest.raises(ValueError, match="outside"):
        dw.upload_csr((indptr, np.array([0, 2], np.int32),
                       np.ones(2, np.float32)), 2, "cpu")
    with pytest.raises(ValueError, match="row-pointer"):
        dw.upload_csr((np.array([0, 2, 1], np.int32),
                       np.array([0, 1], np.int32), np.ones(2, np.float32)),
                      2, "cpu")
    with pytest.raises(ValueError, match="weights has"):
        dw.upload_csr((indptr, np.array([0, 1], np.int32),
                       np.ones(3, np.float32)), 2, "cpu")
    with pytest.raises(ValueError, match="holds 2 genes"):
        dw.walk_shard_device_arrays(None, None, None, 3,
                                    thw.plan_shards(3, 1, 4, len_path=2), 0,
                                    seed=0, csr=dw.upload_csr(
                                        (indptr, np.array([0, 1], np.int32),
                                         np.ones(2, np.float32)), 2, "cpu"),
                                    device="cpu")


def test_kernel_is_built_without_contraction():
    """The walk's float64 sums and draw must round as the C++ sampler's
    do: the build passes -fmad=false, the source adds and multiplies with
    the round-to-nearest intrinsics and writes its rows without atomics:
    its one atomic takes the next walker from the groups' counter."""
    assert "-fmad=false" in dw.nvcc_command()
    assert "sm_90a" in " ".join(dw.nvcc_command())
    with open(dw.SRC) as f:
        src = f.read()
    assert "__dadd_rn" in src and "__dmul_rn" in src
    assert re.findall(r"atomic\w*\(([^,)]*)", src) == ["next"]
    assert os.path.basename(dw.SRC) == "device_walker.cu"
