"""Operational tools of the port, run as modules: ``python -m
g2vec_tpu_torch.tools.chaos_soak`` (the serve chaos soak)."""
