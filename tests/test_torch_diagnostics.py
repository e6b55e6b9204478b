"""The solo run's two diagnostic flags, ``--profile-dir`` and
``--debug-nans``, on the CPU.

- Both parse into the same config fields as the JAX package's flags, and
  the batch engine refuses them.
- ``--profile-dir`` writes a ``torch.profiler`` Chrome trace with one
  range per stage and the spans of its parts inside it, and the run's
  files are the bytes of a run without it.
- ``--debug-nans`` raises ``FloatingPointError`` naming the loss at the
  first non-finite value of a run made to diverge (a learning rate of
  1e30), in both trainers; the same run without the flag completes.
"""
import json
import os

import pytest

from g2vec_tpu.config import config_from_args as jax_config_from_args
from g2vec_tpu_torch.config import config_from_args
from g2vec_tpu_torch.data.synthetic import SyntheticSpec, write_synthetic_tsv
from g2vec_tpu_torch.pipeline import run

pytestmark = pytest.mark.torch

SPEC = SyntheticSpec(n_good=12, n_poor=10, module_size=8, n_background=10,
                     n_expr_only=2, n_net_only=2, module_chords=2,
                     background_edges=15, seed=3)


@pytest.fixture(scope="module")
def tsv(tmp_path_factory):
    return write_synthetic_tsv(SPEC, str(tmp_path_factory.mktemp("syn")))


def _argv(tsv, out, *extra):
    return [tsv["expression"], tsv["clinical"], tsv["network"], str(out),
            "-p", "10", "-r", "3", "-s", "8", "-e", "6", "-n", "5",
            "--compute-dtype", "float32", *extra]


def test_flags_parse_as_the_jax_flags(tsv, tmp_path):
    extra = ("--profile-dir", str(tmp_path / "prof"), "--debug-nans")
    cfg = config_from_args(_argv(tsv, tmp_path / "o", "--device", "cpu",
                                 *extra))
    ref = jax_config_from_args(_argv(tsv, tmp_path / "o", *extra))
    assert (cfg.profile_dir, cfg.debug_nans) == (ref.profile_dir,
                                                 ref.debug_nans)
    assert (cfg.profile_dir, cfg.debug_nans) == (str(tmp_path / "prof"),
                                                 True)
    plain = config_from_args(_argv(tsv, tmp_path / "o", "--device", "cpu"))
    assert (plain.profile_dir, plain.debug_nans) == (None, False)
    for flag in (["--profile-dir", "p"], ["--debug-nans"]):
        with pytest.raises(ValueError, match="batch engine"):
            config_from_args(_argv(tsv, tmp_path / "o", "--device", "cpu",
                                   "--seeds", "2", *flag))


def test_profile_dir_writes_a_trace_and_the_same_bytes(tsv, tmp_path):
    outs = []
    for name, extra in (("plain", ()),
                        ("prof", ("--profile-dir", str(tmp_path / "pd")))):
        cfg = config_from_args(_argv(tsv, tmp_path / name, "--device", "cpu",
                                     *extra))
        res = run(cfg, console=lambda s: None)
        outs.append([open(p, "rb").read() for p in res.output_files])
    assert outs[0] == outs[1]
    with open(tmp_path / "pd" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    ranges = {e["name"] for e in events
              if str(e.get("name", "")).startswith("stage:")}
    assert ranges == {f"stage:{s}" for s in (
        "load", "preprocess", "paths", "train", "lgroups", "biomarkers",
        "save")}
    # CPU ops ran inside the train range (the trainer's matmuls).
    train = next(e for e in events if e.get("name") == "stage:train")
    inside = [e for e in events if e.get("ph") == "X"
              and e.get("cat") == "cpu_op"
              and train["ts"] <= e["ts"] <= train["ts"] + train["dur"]]
    assert inside
    # The parts' spans lie inside their stages' ranges.
    for name, stage in (("span:load/read_network", "stage:load"),
                        ("span:paths/walk_g/row_set", "stage:paths")):
        got = next(e for e in events if e.get("name") == name)
        outer = next(e for e in events if e.get("name") == stage)
        assert outer["ts"] <= got["ts"]
        assert got["ts"] + got["dur"] <= outer["ts"] + outer["dur"]


@pytest.mark.parametrize("mode", ["full", "streaming"])
def test_debug_nans_raises_at_the_first_non_finite_loss(mode, tsv, tmp_path):
    extra = ["--device", "cpu", "-l", "1e30", "--train-mode", mode]
    if mode == "streaming":
        extra += ["--shard-paths", "16"]
    with pytest.raises(FloatingPointError,
                       match=r"--debug-nans: non-finite loss "
                             r"\(masked_bce_loss\)"):
        run(config_from_args(_argv(tsv, tmp_path / "nan", *extra,
                                   "--debug-nans")),
            console=lambda s: None)
    assert not os.path.exists(str(tmp_path / "nan") + "_vectors.txt")
    res = run(config_from_args(_argv(tsv, tmp_path / "nonan", *extra)),
              console=lambda s: None)
    assert all(os.path.exists(p) for p in res.output_files)
