"""CLI entry: ``python -m g2vec_tpu_torch EXPR CLIN NET NAME [options]``.

Same invocation shape as the reference (``python G2Vec.py ...``) and as
``python -m g2vec_tpu``; runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import sys


def main(argv=None) -> int:
    from g2vec_tpu_torch.config import config_from_args
    from g2vec_tpu_torch.pipeline import run

    run(config_from_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
