"""The port's tile planner (``--kernel-autotune``) on the CPU, and against
the reference's (``g2vec_tpu/ops/packed_matmul.py``; the counterparts of
tests/test_trainer_modes.py's autotune tests).

On the CPU the planner's candidates all run the plain versions, so a sweep
here exercises its bookkeeping: install, persist, the memory, cache, stale
and illegal paths, the backend tags and the ranks' broadcast. The card's
candidates are held in tests/test_torch_cuda.py and chip_smoke.py.

Tolerance against the reference's trainer: W_ih at atol 1e-4, the bound
tests/test_torch_trainer.py states for the bf16 path (dW is rounded to
bf16 on both sides, so a one-ulp difference in dW can move an Adam
update), with equal accuracies and stop epoch.
"""
import json
import os
import re

import numpy as np
import pytest
import torch

from g2vec_tpu_torch import cache as tcache
from g2vec_tpu_torch.ops import packed_matmul as pm

pytestmark = pytest.mark.torch

M, G, H = 512, 1024, 128
CARD = "cuda:sm90:NVIDIA H100 80GB HBM3"


@pytest.fixture(autouse=True)
def _fresh_tables():
    pm.reset_tuned()
    yield
    pm.reset_tuned()


def _sweep(path, **kw):
    return pm.autotune_packed_matmul(M, G, H, device="cpu", iters=1,
                                     cache_path=path, **kw)


def _counts():
    return dict(tcache.cache_stats()["autotune"])


def _delta(before):
    after = _counts()
    return {k: after.get(k, 0) - before.get(k, 0) for k in after
            if after.get(k, 0) != before.get(k, 0)}


def test_sweep_installs_and_persists_and_a_second_call_is_a_memory_hit(
        tmp_path):
    path = tcache.autotune_cache_path(str(tmp_path))
    assert path == str(tmp_path / "autotune" / "packed_matmul_cuda.json")
    before = _counts()
    ent = _sweep(path)
    assert ent["source"] == "measured"
    assert _delta(before) == {"miss": 1, "sweep": 1}
    cands = pm.tile_candidates(M, G, H)
    assert tuple(ent["fwd"]) in cands["fwd"] and ent["bwd"] in cands["bwd"]
    assert ent["heuristic"] == {"fwd": list(pm.FWD_SHIPPED), "bwd": None}
    assert set(ent["ms"]) == (
        {f"fwd:{pm._layout_suffix(c)}" for c in cands["fwd"]}
        | {f"bwd:S{s}" for s in cands["bwd"]}
        | {"fwd:best_ms", "bwd:best_ms"})
    rec = json.load(open(path))
    assert rec["schema"] == pm.AUTOTUNE_SCHEMA
    assert list(rec["entries"]) == [
        f"schema={pm.AUTOTUNE_SCHEMA};m={M};g={G};h={H};backend=cpu"]
    before = _counts()
    again = _sweep(path)
    assert again == {"fwd": ent["fwd"], "bwd": ent["bwd"],
                     "source": "memory"}
    assert _delta(before) == {"hit": 1}


def test_a_fresh_table_reads_the_file_back_as_cache(tmp_path):
    path = tcache.autotune_cache_path(str(tmp_path))
    ent = _sweep(path)
    pm.reset_tuned()           # a fresh process's table
    before = _counts()
    hit = _sweep(path)
    assert hit["source"] == "cache" and _delta(before) == {"hit": 1}
    assert (hit["fwd"], hit["bwd"]) == (ent["fwd"], ent["bwd"])
    tiles = pm.describe_tiles(M, G, H, device="cpu")
    assert tiles["fwd"] == {"layout": ent["fwd"], "source": "autotuned"}
    assert tiles["bwd"] == {"n_slices": ent["bwd"], "source": "autotuned"}


def test_a_stale_schema_is_measured_again(tmp_path):
    path = tcache.autotune_cache_path(str(tmp_path))
    _sweep(path)
    rec = json.load(open(path))
    rec["schema"] = -999       # an older kernel generation's record
    with open(path, "w") as f:
        json.dump(rec, f)
    pm.reset_tuned()
    before = _counts()
    assert pm.load_tuned(path, M, G, H, "cpu") is None
    assert _delta(before) == {"miss": 1}
    again = _sweep(path)
    assert again["source"] == "measured"
    assert json.load(open(path))["schema"] == pm.AUTOTUNE_SCHEMA


@pytest.mark.parametrize("field,value", [
    ("fwd", [4, 4, 128, 2]), ("fwd", "shipped"), ("bwd", 0),
    ("bwd", 10 ** 6), ("bwd", None)])
def test_an_illegal_persisted_plan_is_a_miss(tmp_path, field, value):
    path = tcache.autotune_cache_path(str(tmp_path))
    _sweep(path)
    rec = json.load(open(path))
    (key,) = rec["entries"]
    rec["entries"][key][field] = value
    with open(path, "w") as f:
        json.dump(rec, f)
    pm.reset_tuned()
    before = _counts()
    assert pm.load_tuned(path, M, G, H, "cpu") is None
    assert _delta(before) == {"miss": 1} and not pm._TUNED


def test_describe_tiles_reports_heuristic_then_autotuned(tmp_path):
    tiles = pm.describe_tiles(M, G, H, device="cpu")
    assert tiles == {"fwd": {"layout": list(pm.FWD_SHIPPED),
                             "source": "heuristic"},
                     "bwd": {"n_slices": None, "source": "heuristic"}}
    pm._install_tuned(M, G, H, {"fwd": (2, 1, 64, 3), "bwd": 3}, "cpu")
    tiles = pm.describe_tiles(M, G, H, device="cpu")
    assert tiles == {"fwd": {"layout": [2, 1, 64, 3], "source": "autotuned"},
                     "bwd": {"n_slices": 3, "source": "autotuned"}}
    # Another shape keeps the heuristic.
    assert pm.describe_tiles(M + 1, G, H, device="cpu")["fwd"]["source"] \
        == "heuristic"


def test_a_cpu_entry_never_serves_a_card_tag_and_the_reverse(tmp_path,
                                                              monkeypatch):
    path = tcache.autotune_cache_path(str(tmp_path))
    tag = pm._autotune_backend_tag
    monkeypatch.setattr(pm, "_autotune_backend_tag", lambda device: (
        CARD if torch.device(device).type == "cuda" else tag(device)))
    _sweep(path)
    # The card's launches take the heuristic, whatever the CPU installed.
    assert pm._tile_plan(M, G, H, "fwd", CARD) == pm.FWD_SHIPPED
    assert pm._tile_plan(M, G, H, "bwd", CARD, n_sms=132) == \
        pm._bwd_slices(M, G, H, 132)
    pm.reset_tuned()
    assert pm.load_tuned(path, M, G, H, "cuda") is None and not pm._TUNED
    # A card entry in the file serves the card and never the CPU.
    rec = json.load(open(path))
    (key,) = rec["entries"]
    card_plan = {"fwd": [2, 1, 128, 2], "bwd": 2}
    rec["entries"][key.replace("backend=cpu", f"backend={CARD}")] = card_plan
    del rec["entries"][key]
    with open(path, "w") as f:
        json.dump(rec, f)
    assert pm.load_tuned(path, M, G, H, "cpu") is None and not pm._TUNED
    hit = pm.load_tuned(path, M, G, H, "cuda")
    assert hit["source"] == "cache" and pm._TUNED_BACKEND[(M, G, H)] == CARD
    assert pm._tile_plan(M, G, H, "fwd", CARD) == (2, 1, 128, 2)
    assert pm._tile_plan(M, G, H, "bwd", CARD).n_slices == 2
    assert pm._tile_plan(M, G, H, "fwd", "cpu") == pm.FWD_SHIPPED


def test_planner_constants_match_the_kernel_sources():
    """The planner's layouts, shipped layout and shared-memory figures
    are the .cu's (read as text, as the other constant tests do)."""
    with open(pm.SRC) as f:
        src = f.read()
    with open(pm.TILES_SRC) as f:
        tiles = f.read()
    assert re.search(r"using FwdShipped = FwdLayout<(\d+), (\d+), (\d+), "
                     r"(\d+)>;", src).groups() == tuple(
        str(v) for v in pm.FWD_SHIPPED)
    listed = [tuple(int(v) for v in t) for t in re.findall(
        r"X\((\d+), (\d+), (\d+), (\d+)\)", tiles)]
    assert listed == pm.FWD_LAYOUTS and listed[0] == pm.FWD_SHIPPED
    assert f'#include "{os.path.basename(pm.SRC)}"' in tiles
    consts = dict(re.findall(r"^constexpr int (\w+) = ([^;]+);", src, re.M))
    assert eval(consts["kSmemPerSM"]) == pm.SMEM_PER_SM
    assert int(consts["kSmemReservedPerBlock"]) == pm.SMEM_RESERVED_PER_BLOCK
    assert int(consts["kBwdRows"]) == pm.BWD_STAGE_ROWS


@pytest.mark.parametrize("m,g,h", [(1, 7, 1), (64, 5850, 128),
                                   (32319, 5850, 128), (2205, 5850, 128),
                                   (182, 131072, 256), (10 ** 6, 999, 10)])
def test_candidates_hold_the_heuristic_and_stay_in_bounds(m, g, h):
    cands = pm.tile_candidates(m, g, h)
    assert cands["fwd"] == pm.FWD_LAYOUTS
    h8 = -(-h // 8) * 8
    for n_sms in (1, 114, 132):
        assert pm._bwd_slices(m, g, h, n_sms).n_slices in cands["bwd"]
    for s in cands["bwd"]:
        plan = pm._bwd_split(m, s, g, h8)
        assert plan.n_slices == s and plan.rows >= pm.BWD_STAGE_ROWS
        assert plan.rows * s >= m and plan.workspace_bytes <= \
            pm.BWD_WORKSPACE_CAP
    assert cands["bwd"][0] == 1


def test_train_cbow_on_the_cpu_skips_the_sweep_and_writes_no_file(tmp_path):
    from g2vec_tpu_torch.train.trainer import train_cbow

    rng = np.random.default_rng(0)
    dense = rng.random((300, 200)) < 0.05
    labels = (dense[:, :40].sum(1) > dense[:, 40:80].sum(1)).astype(np.int32)
    common = dict(n_genes=200, hidden=32, learning_rate=0.01, max_epochs=4,
                  seed=3, device="cpu")
    path = tcache.autotune_cache_path(str(tmp_path))
    before = _counts()
    base = train_cbow(np.packbits(dense, axis=1), labels, **common)
    tuned = train_cbow(np.packbits(dense, axis=1), labels,
                       kernel_autotune=True, autotune_cache_path=path,
                       **common)
    assert tuned.w_ih.tobytes() == base.w_ih.tobytes()
    assert tuned.history == [dict(h, secs=t["secs"]) for h, t in
                             zip(base.history, tuned.history)]
    assert not os.path.exists(os.path.dirname(path))
    assert _delta(before) == {} and not pm._TUNED


def test_ranks_launch_rank_zeros_plan_and_only_rank_zero_writes(
        tmp_path, monkeypatch):
    """Rank 0 sweeps (or loads) and writes; another rank sweeps nothing,
    writes nothing and installs the plan rank 0 broadcast."""
    from g2vec_tpu_torch.parallel import distributed, hostcomm
    from g2vec_tpu_torch.train import trainer

    path = tcache.autotune_cache_path(str(tmp_path))
    sent = {}
    monkeypatch.setattr(distributed, "initialized", lambda: True)
    monkeypatch.setattr(distributed, "process_count", lambda: 2)

    def broadcast(name, payload, **kw):
        if payload is not None:
            sent[name] = payload
        return sent[name]

    monkeypatch.setattr(hostcomm, "broadcast_bytes", broadcast)
    launches = [(M, "fwd"), (M, "bwd"), (M - 100, "fwd"), (M - 100, "bwd")]
    monkeypatch.setattr(distributed, "process_index", lambda: 0)
    trainer._autotune_packed_shapes(launches, G, H, "cpu", path)
    plans = {k: tuple(v["fwd"]) + (v["bwd"],) for k, v in
             json.loads(sent["autotune_plans"]).items()}
    assert sorted(plans) == [str(M - 100), str(M)]
    written = open(path, "rb").read()
    rank0 = dict(pm._TUNED)
    pm.reset_tuned()
    monkeypatch.setattr(distributed, "process_index", lambda: 1)
    monkeypatch.setattr(pm, "_autotune", None)   # never called
    os.unlink(path)
    trainer._autotune_packed_shapes(launches, G, H, "cpu", path)
    assert not os.path.exists(path)
    assert pm._TUNED == rank0
    assert {str(m): v["fwd"] + (v["bwd"],) for (m, _, _), v in
            pm._TUNED.items()} == plans
    assert all(t == "cpu" for t in pm._TUNED_BACKEND.values())
    assert written


def test_each_shape_is_swept_in_the_directions_it_launches(tmp_path):
    """The trainer's fused run launches the forward at [train | val] rows
    and the backward at the train rows: each shape is timed, installed
    and persisted in its own direction alone, the other keeps the
    heuristic, and a later sweep of the other direction merges into the
    same entry."""
    from g2vec_tpu_torch.train import trainer

    path = tcache.autotune_cache_path(str(tmp_path))
    before = _counts()
    plans = trainer._autotune_packed_shapes(
        [(M, "fwd"), (M - 100, "bwd")], G, H, "cpu", path)
    assert _delta(before) == {"miss": 2, "sweep": 2}
    assert set(plans[str(M)]) == {"fwd", "source"}
    assert set(plans[str(M - 100)]) == {"bwd", "source"}
    entries = json.load(open(path))["entries"]
    key = f"schema={pm.AUTOTUNE_SCHEMA};m={{}};g={G};h={H};backend=cpu"
    fwd_ent, bwd_ent = entries[key.format(M)], entries[key.format(M - 100)]
    assert "bwd" not in fwd_ent and "fwd" not in bwd_ent
    assert all(k.startswith("fwd:") for k in fwd_ent["ms"])
    assert all(k.startswith("bwd:") for k in bwd_ent["ms"])
    assert pm.describe_tiles(M, G, H, device="cpu")["bwd"]["source"] == \
        "heuristic"
    assert pm.describe_tiles(M - 100, G, H, device="cpu")["fwd"] == {
        "layout": list(pm.FWD_SHIPPED), "source": "heuristic"}
    # A fresh table: the persisted direction is a hit, the other a miss
    # and a sweep of that direction alone, merged into the entry.
    pm.reset_tuned()
    before = _counts()
    trainer._autotune_packed_shapes([(M, "fwd")], G, H, "cpu", path)
    assert _delta(before) == {"hit": 1}
    trainer._autotune_packed_shapes([(M, "bwd")], G, H, "cpu", path)
    assert _delta(before) == {"hit": 1, "miss": 1, "sweep": 1}
    merged = json.load(open(path))["entries"][key.format(M)]
    assert merged["fwd"] == fwd_ent["fwd"] and "bwd" in merged
    assert {k for k in merged["ms"] if k.startswith("fwd:")} == \
        set(fwd_ent["ms"])
    tiles = pm.describe_tiles(M, G, H, device="cpu")
    assert {d: t["source"] for d, t in tiles.items()} == {
        "fwd": "autotuned", "bwd": "autotuned"}


def test_supervise_and_fleet_size_pass_the_flag_to_their_children():
    from g2vec_tpu_torch.resilience.fleet import _scrub_fleet_argv
    from g2vec_tpu_torch.resilience.supervisor import _scrub_supervisor_argv

    argv = ["E", "C", "N", "out", "--kernel-autotune", "--cache-dir", "D",
            "--fleet-size", "2", "--supervise"]
    for child in (_scrub_fleet_argv(argv), _scrub_supervisor_argv(argv)):
        assert child[4:7] == ["--kernel-autotune", "--cache-dir", "D"]


def test_kernel_autotune_parses_to_the_same_field_in_both_packages():
    from g2vec_tpu.config import config_from_args as jax_config
    from g2vec_tpu_torch.config import config_from_args as port_config

    argv = ["E", "C", "N", "out"]
    for extra, want in (([], False), (["--kernel-autotune"], True)):
        assert jax_config(argv + extra).kernel_autotune is want
        assert port_config(argv + extra).kernel_autotune is want


@pytest.fixture(scope="module")
def reference_record(tmp_path_factory):
    """The reference's sweep at (512, 1024, 128) in interpret mode, its
    record written under a cache root; its table is reset afterwards."""
    from g2vec_tpu.cache import autotune_cache_path
    from g2vec_tpu.ops import packed_matmul as jpm

    root = str(tmp_path_factory.mktemp("shared_cache"))
    jpm.reset_tuned()
    jpm.autotune_packed_matmul(M, G, H, interpret=True, iters=1,
                               cache_path=autotune_cache_path(root))
    yield root, autotune_cache_path(root)
    jpm.reset_tuned()


def test_a_shared_cache_root_keeps_the_references_record(reference_record):
    root, ref_path = reference_record
    ref_bytes = open(ref_path, "rb").read()
    port_path = tcache.autotune_cache_path(root)
    assert port_path != ref_path
    assert pm.load_tuned(ref_path, M, G, H, "cpu") is None
    _sweep(port_path)
    assert open(ref_path, "rb").read() == ref_bytes
    assert list(json.load(open(port_path))["entries"]) == [
        f"schema={pm.AUTOTUNE_SCHEMA};m={M};g={G};h={H};backend=cpu"]
    pm.reset_tuned()
    assert pm.load_tuned(ref_path, M, G, H, "cpu") is None
    assert not pm._TUNED


def test_tuned_trainer_matches_the_references_autotuned_pallas_trainer(
        reference_record):
    """The reference's train_cbow(kernel_autotune=True) on its Pallas
    kernels (interpret mode) against the port's CPU run with the flag,
    from the same numpy init. The reference runs with its eval unfused,
    the same function: its forward and backward then launch at the train
    rows padded to 512 and its eval at the val rows padded to 512, the
    (512, 1024, 128) shape whose plan the fixture measured, so its own
    trainer sweeps nothing (a sweep in interpret mode takes seconds)."""
    from g2vec_tpu.cache import autotune_cache_path, cache_stats
    from g2vec_tpu.train.trainer import train_cbow as jax_train
    from g2vec_tpu_torch.train.trainer import train_cbow
    from g2vec_tpu_torch.weights import params_from_jax

    root, _ = reference_record
    rng = np.random.default_rng(0)
    n_paths, n_genes, hidden = 400, 1000, H
    dense = rng.random((n_paths, n_genes)) < 0.05
    labels = (dense[:, :40].sum(1) > dense[:, 40:80].sum(1)).astype(np.int32)
    wi = (np.clip(rng.standard_normal((n_genes, hidden)), -2, 2)
          / np.sqrt(hidden)).astype(np.float32)
    wo = (np.clip(rng.standard_normal((hidden, 1)), -2, 2)
          / np.sqrt(hidden)).astype(np.float32)
    packed = np.packbits(dense, axis=1)
    common = dict(hidden=hidden, compute_dtype="bfloat16", seed=3,
                  learning_rate=0.002, max_epochs=2)
    sweeps = cache_stats()["autotune"].get("sweep", 0)
    rj = jax_train(packed, labels, packed_genes=n_genes, use_pallas=True,
                   fused_eval=False, warm_start=(wi, wo), kernel_autotune=True,
                   autotune_cache_path=autotune_cache_path(root), **common)
    assert cache_stats()["autotune"].get("sweep", 0) == sweeps
    rt = train_cbow(packed, labels, n_genes=n_genes, device="cpu",
                    init=params_from_jax(wi, wo), kernel_autotune=True,
                    autotune_cache_path=tcache.autotune_cache_path(root),
                    **common)
    assert (rt.stop_epoch, rt.stopped_early) == (rj.stop_epoch,
                                                 rj.stopped_early)
    assert [(h["acc_val"], h["acc_tr"]) for h in rt.history] == \
        [(h["acc_val"], h["acc_tr"]) for h in rj.history]
    np.testing.assert_allclose(rt.w_ih, rj.w_ih, rtol=0, atol=1e-4)
