"""Operational tools of the port, run as modules: ``python -m
g2vec_tpu_torch.tools.chaos_soak`` (the serve chaos soak) and
``python g2vec_tpu_torch/tools/run_analyze.py`` (the static-analysis
suite from a bare checkout)."""
