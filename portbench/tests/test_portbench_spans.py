"""The per-layer metrics on the port's spans (``metrics/load_network_s.solo``,
``row_set_s.solo``, ``rows_copy_s.device``): the mean over the untraced
jobs' held results, None where nothing held has the span."""
import importlib.util
import os
from types import SimpleNamespace

import pytest

from pbtest import BENCH

pytestmark = pytest.mark.torch


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        "s_" + name.replace(".", "_"),
        os.path.join(BENCH, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _job(extras, traced=None, dropped=False):
    """A job record of one unit whose result holds ``extras`` as its
    ``stage_extras`` (None: the window dropped it)."""
    result = None if dropped else SimpleNamespace(stage_extras=extras)
    return SimpleNamespace(traced=traced,
                           units=[SimpleNamespace(result=result)])


def _spans(stage, seconds):
    return {stage: {"span_s": dict(seconds)}}


def _ctx(jobs, kind="solo"):
    return SimpleNamespace(kind=kind, jobs=jobs)


@pytest.mark.parametrize("name,stage,parts", [
    ("load_network_s.solo", "load", ["read_network"]),
    ("row_set_s.solo", "paths", ["walk_g/row_set", "walk_p/row_set"]),
    ("rows_copy_s.device", "paths", ["walk_g/rows_copy",
                                     "walk_p/rows_copy"]),
])
def test_mean_over_held_untraced_results(name, stage, parts):
    read = _reader(name)

    def job(x, **kw):
        # Each part of one result reads x / len(parts): the sum is x.
        seconds = {p: x / len(parts) for p in parts}
        return _job(_spans(stage, dict(seconds, other=100.0)), **kw)

    held = [job(1.0), job(3.0)]
    assert read(_ctx(held)) == pytest.approx(2.0)
    # A dropped result and a traced job are left out of the mean.
    dropped = job(50.0, dropped=True)
    traced = job(70.0, traced={"window_s": 1.0})
    assert read(_ctx([traced, dropped] + held)) == pytest.approx(2.0)
    # A result without the span (a program without it): None, not 0.
    bare = _job(_spans(stage, {"other": 1.0}))
    assert read(_ctx([bare, dropped])) is None
    assert read(_ctx([traced])) is None
    assert read(_ctx([bare, held[1]])) == pytest.approx(3.0)
    # Another entry's jobs: None.
    assert read(_ctx(held, kind="batch")) is None
