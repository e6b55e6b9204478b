"""The port's walk cache (``g2vec_tpu_torch.cache``) against
``g2vec_tpu.cache``, following tests/test_overlap_cache.py's cases.

- The key tracks every input and equals the reference's key.
- Round trip, the empty set included; a tampered artifact warns and
  misses, and the recompute's store heals it; a missing, mangled or stale
  manifest is a miss.
- ``resolve_cache_tiers`` gives the walk tier only.
- The ``walk_cache`` fault seam's corrupt drill: the next run recomputes
  the torn entry.
- Entries cross between the packages both ways, and the artifacts are the
  same bytes.
- The pipeline on ``--device cpu``: a rerun with the same ``cache_dir``
  skips both groups' walks and writes the same bytes, and a
  ``walker_backend="device"`` run hits the entries a native run wrote.
"""
import json
import os
import warnings

import numpy as np
import pytest

import g2vec_tpu.cache as jcache
from g2vec_tpu_torch import cache as tcache
from g2vec_tpu_torch.config import G2VecConfig
from g2vec_tpu_torch.data.synthetic import SyntheticSpec, write_synthetic_tsv
from g2vec_tpu_torch.utils.integrity import write_json_atomic

pytestmark = pytest.mark.torch


def _toy_edges():
    src = np.array([0, 1, 2, 2], np.int32)
    dst = np.array([1, 2, 0, 3], np.int32)
    w = np.array([0.9, 0.7, 0.6, 0.8], np.float32)
    return src, dst, w, 4


def _toy_key(module=tcache, seed=0, family=tcache.NATIVE_FAMILY, **over):
    src, dst, w, n = _toy_edges()
    args = dict(src=src, dst=dst, w=w, n_genes=n)
    args.update(over)
    return module.walk_cache_key(args["src"], args["dst"], args["w"],
                                 args["n_genes"], len_path=5, reps=2,
                                 seed=seed, family=family)


def _toy_path_set(n=4):
    return {r.tobytes() for r in np.packbits(np.eye(n, dtype=np.uint8),
                                             axis=1)}


def test_cache_key_tracks_every_input_and_is_the_reference_key():
    src, dst, w, n = _toy_edges()
    base = _toy_key()
    assert base == _toy_key()
    assert base == _toy_key(jcache, family=jcache.NATIVE_FAMILY)
    assert (tcache.NATIVE_FAMILY, tcache.DEVICE_FAMILY) == \
        (jcache.NATIVE_FAMILY, jcache.DEVICE_FAMILY)
    others = [_toy_key(seed=1), _toy_key(family=tcache.DEVICE_FAMILY),
              _toy_key(src=src[::-1].copy()), _toy_key(w=w + 1),
              _toy_key(n_genes=5),
              _toy_key(src=src[:3], dst=dst[:3], w=w[:3])]
    for len_path, reps in ((6, 2), (5, 3)):
        others.append(tcache.walk_cache_key(
            src, dst, w, n, len_path=len_path, reps=reps, seed=0,
            family=tcache.NATIVE_FAMILY))
    assert base not in others and len(set(others)) == len(others) == 8
    assert _toy_key(dst=dst.astype(np.int64)) == base   # values, not dtype


@pytest.mark.parametrize("path_set", [_toy_path_set(), set()],
                         ids=["rows", "empty"])
def test_cache_store_load_roundtrip(tmp_path, path_set):
    cache = tcache.WalkCache(str(tmp_path / "walks"))
    key = _toy_key()
    assert cache.load(key) is None
    art = cache.store(key, path_set, 4, meta={"group": "g"})
    assert os.path.exists(art + tcache.MANIFEST_SUFFIX)
    with warnings.catch_warnings():
        warnings.simplefilter("error")            # a hit is silent
        assert cache.load(key) == path_set
    manifest = json.loads(open(art + tcache.MANIFEST_SUFFIX).read())
    assert manifest["key"] == key and manifest["group"] == "g"
    assert manifest["n_rows"] == len(path_set)


def test_tampered_artifact_warns_misses_and_heals(tmp_path):
    cache = tcache.WalkCache(str(tmp_path))
    key = _toy_key()
    art = cache.store(key, _toy_path_set(), 4)
    with open(art, "r+b") as f:
        f.seek(8)
        byte = f.read(1)
        f.seek(8)
        f.write(bytes([byte[0] ^ 0xFF]))
    with pytest.warns(RuntimeWarning, match="sha256 verification"):
        assert cache.load(key) is None
    cache.store(key, _toy_path_set(), 4)
    assert cache.load(key) == _toy_path_set()


def test_missing_mangled_or_stale_manifest_is_a_miss(tmp_path):
    cache = tcache.WalkCache(str(tmp_path))
    key = _toy_key()
    art = cache.store(key, _toy_path_set(), 4)
    man = art + tcache.MANIFEST_SUFFIX
    os.remove(man)
    assert cache.load(key) is None
    cache.store(key, _toy_path_set(), 4)
    with open(man, "w") as f:
        f.write("{not json")
    with pytest.warns(RuntimeWarning, match="unreadable"):
        assert cache.load(key) is None
    cache.store(key, _toy_path_set(), 4)
    manifest = json.loads(open(man).read())
    for bad in ({**manifest, "schema": 0}, {**manifest, "key": "f" * 64}):
        write_json_atomic(man, bad)
        with pytest.warns(RuntimeWarning, match="stale"):
            assert cache.load(key) is None


def test_resolve_cache_tiers_gives_the_walk_tier_only(tmp_path):
    root = str(tmp_path / "c")
    walks = tcache.resolve_cache_tiers(root)
    assert walks.directory == os.path.join(root, "walks")
    assert walks.directory == jcache.resolve_cache_tiers(root, None)[1]\
        .directory
    assert tcache.resolve_cache_tiers(None) is None


def test_entries_cross_between_the_packages(tmp_path):
    ps = _toy_path_set(11)
    key = _toy_key()
    port = tcache.WalkCache(str(tmp_path / "port"))
    ref = jcache.WalkCache(str(tmp_path / "ref"))
    art_t = port.store(key, ps, 11, meta={"group": "p"})
    art_j = ref.store(key, ps, 11, meta={"group": "p"})
    with open(art_t, "rb") as a, open(art_j, "rb") as b:
        assert a.read() == b.read()
    assert jcache.WalkCache(port.directory).load(key) == ps
    assert tcache.WalkCache(ref.directory).load(key) == ps


def test_cache_stats_count_the_walk_tier(tmp_path):
    before = tcache.cache_stats()["walk"]
    cache = tcache.WalkCache(str(tmp_path))
    key = _toy_key()
    cache.load(key)
    cache.store(key, _toy_path_set(), 4)
    cache.load(key)
    after = tcache.cache_stats()["walk"]
    for outcome in ("miss", "store", "disk_hit"):
        assert after.get(outcome, 0) == before.get(outcome, 0) + 1


# ---------------------------------------------------------------------------
# The pipeline
# ---------------------------------------------------------------------------

SPEC = SyntheticSpec(n_good=12, n_poor=10, module_size=8, n_background=10,
                     n_expr_only=2, n_net_only=2, module_chords=2,
                     background_edges=15, seed=3)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return write_synthetic_tsv(SPEC, str(tmp_path_factory.mktemp("cache")))


def _run(files, out, cache_dir, **over):
    from g2vec_tpu_torch.pipeline import run

    cfg = G2VecConfig(expression_file=files["expression"],
                      clinical_file=files["clinical"],
                      network_file=files["network"], result_name=str(out),
                      lenPath=10, numRepetition=3, sizeHiddenlayer=8,
                      epoch=4, numBiomarker=5, kmeans_iters=20,
                      device="cpu",
                      cache_dir=None if cache_dir is None else str(cache_dir),
                      **over)
    lines = []
    result = run(cfg, console=lines.append)
    outputs = []
    for path in result.output_files:
        with open(path, "rb") as f:
            outputs.append(f.read())
    return result, outputs, lines


def _refuse(*args, **kwargs):
    raise AssertionError("a cached group was walked")


def test_pipeline_rerun_skips_the_walks(files, tmp_path, monkeypatch):
    from g2vec_tpu_torch.ops import host_walker

    first, out1, _ = _run(files, tmp_path / "a", tmp_path / "c")
    assert first.walk_cache_hits == [] and first.walker_backend == "native"
    assert len(os.listdir(tmp_path / "c" / "walks")) == 4
    monkeypatch.setattr(host_walker, "generate_path_set_native", _refuse)
    second, out2, lines = _run(files, tmp_path / "b", tmp_path / "c")
    assert second.walk_cache_hits == ["g", "p"]
    assert sum("verified walk artifact hit" in ln for ln in lines) == 2
    assert out2 == out1
    np.testing.assert_array_equal(second.paths, first.paths)


def test_device_backend_hits_native_entries(files, tmp_path, monkeypatch):
    from g2vec_tpu_torch.ops import device_walker

    native, out1, _ = _run(files, tmp_path / "a", tmp_path / "c")
    monkeypatch.setattr(device_walker, "generate_path_set_device", _refuse)
    dev, out2, _ = _run(files, tmp_path / "b", tmp_path / "c",
                        walker_backend="device")
    assert dev.walker_backend == "device"
    assert dev.walk_cache_hits == ["g", "p"] and out2 == out1


def test_no_cache_dir_reads_and_writes_nothing(files, tmp_path):
    before = tcache.cache_stats()["walk"]
    res, _, _ = _run(files, tmp_path / "a", None)
    assert res.walk_cache_hits == []
    assert tcache.cache_stats()["walk"] == before
    assert sorted(os.listdir(tmp_path)) == sorted(
        os.path.basename(p) for p in res.output_files)


def test_walk_cache_corrupt_drill_recomputes(files, tmp_path):
    """``stage=walk_cache,kind=corrupt`` flips bytes in the first stored
    artifact after its manifest recorded the good hash (post-save
    bitrot): the next run warns, misses that group, walks it again and
    heals the entry, and writes the same bytes."""
    from g2vec_tpu_torch.resilience import faults

    faults._reset_for_tests()
    try:
        first, out1, _ = _run(files, tmp_path / "a", tmp_path / "c",
                              fault_plan="stage=walk_cache,kind=corrupt")
    finally:
        faults._reset_for_tests()
    assert first.walk_cache_hits == []
    with pytest.warns(RuntimeWarning, match="failed sha256 verification"):
        second, out2, _ = _run(files, tmp_path / "b", tmp_path / "c")
    assert second.walk_cache_hits == ["p"] and out2 == out1
    third, out3, _ = _run(files, tmp_path / "d", tmp_path / "c")
    assert third.walk_cache_hits == ["g", "p"] and out3 == out1
