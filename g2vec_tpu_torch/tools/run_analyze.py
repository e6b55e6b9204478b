#!/usr/bin/env python3
"""Standalone launcher for the port's static-analysis suite.

``python g2vec_tpu_torch/tools/run_analyze.py [--json] [...]`` — the same
as ``python -m g2vec_tpu_torch analyze`` but runnable from a bare checkout
without installing the package (the repo root is put on sys.path).
Exit codes: 0 clean, 1 findings, 2 usage.
"""
import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from g2vec_tpu_torch.analyze.cli import analyze_main  # noqa: E402

if __name__ == "__main__":
    sys.exit(analyze_main(sys.argv[1:]))
