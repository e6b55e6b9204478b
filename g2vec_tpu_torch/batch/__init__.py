"""The batch engine: many runs of one dataset as lanes (see engine.py)."""
from g2vec_tpu_torch.batch.engine import (BatchResult, LaneVariant,
                                          ManifestError, ResidentEngine,
                                          lane_config, load_manifest,
                                          plan_variants, run_batch)

__all__ = ["BatchResult", "LaneVariant", "ManifestError", "ResidentEngine",
           "lane_config", "load_manifest", "plan_variants", "run_batch"]
