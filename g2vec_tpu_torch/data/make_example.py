"""CLI: write a synthetic reference-format dataset.

``python -m g2vec_tpu_torch.data.make_example OUT_DIR [--scale
small|medium|example] [--prefix syn] [--seed N]``

The port's copy of ``g2vec_tpu/data/make_example.py``, on the port's
:data:`~g2vec_tpu_torch.data.synthetic.SCALES`: the same flags, the same
three TSV files byte for byte, and the same lines on stdout.
``example`` approximates the reference's bundled example (135 samples,
~7.5k genes); ``small`` is a seconds-fast size.
"""
from __future__ import annotations

import argparse
import dataclasses

from g2vec_tpu_torch.data.synthetic import SCALES, write_synthetic_tsv


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m g2vec_tpu_torch.data.make_example")
    parser.add_argument("out_dir")
    parser.add_argument("--scale", choices=sorted(SCALES), default="small")
    parser.add_argument("--prefix", default="syn")
    parser.add_argument("--seed", type=int, default=None)
    args = parser.parse_args(argv)
    spec = SCALES[args.scale]
    if args.seed is not None:
        spec = dataclasses.replace(spec, seed=args.seed)
    paths = write_synthetic_tsv(spec, args.out_dir, prefix=args.prefix)
    for name, path in paths.items():
        print(f"{name}: {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
