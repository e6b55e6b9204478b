"""g2vec_tpu_torch — the PyTorch/CUDA port of g2vec_tpu for NVIDIA Hopper.

The same seven-stage pipeline as :mod:`g2vec_tpu` (the reference, which
stays in the repository unchanged), rewritten on PyTorch:

- L0 config/CLI           -> :mod:`g2vec_tpu_torch.config`
- L1 data IO              -> :mod:`g2vec_tpu_torch.io`
- L2 preprocess           -> :mod:`g2vec_tpu_torch.preprocess`
- L3 graph + random walks -> :mod:`g2vec_tpu_torch.ops.graph`,
  :mod:`g2vec_tpu_torch.ops.host_walker` (C++ sampler in
  :mod:`g2vec_tpu_torch.native`), :mod:`g2vec_tpu_torch.ops.paths`
- L4 trainer (CBOW)       -> :mod:`g2vec_tpu_torch.models.cbow`,
  :mod:`g2vec_tpu_torch.train.trainer`, with the bit-packed product on
  hand-written Hopper kernels (:mod:`g2vec_tpu_torch.ops.packed_matmul`,
  ``csrc/packed_matmul.cu``)
- L5 analysis             -> :mod:`g2vec_tpu_torch.ops.kmeans`,
  :mod:`g2vec_tpu_torch.ops.stats`, :mod:`g2vec_tpu_torch.analysis`
- L6 output writers       -> :mod:`g2vec_tpu_torch.io.writers`
- batches of runs (lanes) -> :mod:`g2vec_tpu_torch.batch` (``--seeds``,
  ``--manifest``; the lane trainer ``train_cbow_lanes`` on the same
  kernels, one launch a step for a bucket of lanes)
- scenarios               -> :mod:`g2vec_tpu_torch.stats` (``--scenario
  bootstrap|permutation|cv`` as lanes, reduced into a stability table)
- incremental updates     -> :mod:`g2vec_tpu_torch.incremental` (the
  serve daemon's ``update`` op: delta re-walk, warm-start fine-tune)

The package imports ``torch`` and never ``jax``, and nothing of
``g2vec_tpu``. Entry points run on the card (``device="cuda"``) unless the
caller asks for the CPU (``device="cpu"`` / ``--device cpu``); with no card
present they raise instead of quietly falling back.
"""

__version__ = "0.1.0"
