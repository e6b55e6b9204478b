"""Shared set-up of the benchmark's CPU tests: the benchmark's folder and
the repository root on ``sys.path``, and the cells at a size a test run
holds."""
import copy
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

#: A configuration's shape at a size the CPU runs in seconds.
SMALL = {"n_good": 20, "n_poor": 16, "common_genes": 600,
         "common_edges": 6000, "network_genes": 700, "network_edges": 8000,
         "expression_only_genes": 10, "module_size": 150,
         "shared_module_size": 20, "module_chords": 6, "noise": 0.25,
         "shift": 1.2}


def small_cell(workload: str):
    """``harness.resolve(workload)`` with the configuration's data cut to
    :data:`SMALL` and k-means to 50 iterations."""
    import harness

    ns = harness.resolve(workload)
    ns.config = copy.deepcopy(ns.config)
    ns.config["data"] = dict(SMALL)
    ns.config["run"]["kmeans_iters"] = 50
    return ns


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell runs only on the card")
