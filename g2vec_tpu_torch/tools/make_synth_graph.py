"""Write a seeded scale-free synthetic dataset at any gene count.

The port's counterpart of ``tools/make_synth_graph.py``
(:mod:`g2vec_tpu_torch.data.synth`): the three reference-format TSVs, and
a JSON summary (paths, gene and edge counts) on standard output. The same
flags write the same bytes::

    python -m g2vec_tpu_torch.tools.make_synth_graph --genes 20000 --out big
    python -m g2vec_tpu_torch big/big_EXPRESSION.txt big/big_CLINICAL.txt \\
        big/big_NETWORK.txt RESULT --train-mode streaming --walk-starts 4096

``--stream`` (automatic from 200,000 genes) writes in bounded memory;
``--partitions R`` writes the network as R part files, a genes file and a
sha256 manifest, the input of an ``--edge-partition`` fleet::

    python -m g2vec_tpu_torch.tools.make_synth_graph --genes 262144 \\
        --partitions 2 --out big
    python -m g2vec_tpu_torch big/big_EXPRESSION.txt big/big_CLINICAL.txt \\
        big/big_NETWORK.manifest.json RESULT --train-mode streaming \\
        --edge-partition handoff ...
"""
from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="make_synth_graph",
        description="Seeded scale-free synthetic dataset generator "
                    "(expression/clinical/network TSVs).")
    p.add_argument("--genes", "--nodes", dest="genes", type=int,
                   default=20000, help="gene/node count (default 20000)")
    p.add_argument("--good", type=int, default=40,
                   help="good-prognosis samples (default 40)")
    p.add_argument("--poor", type=int, default=40,
                   help="poor-prognosis samples (default 40)")
    p.add_argument("--attach", type=int, default=3,
                   help="preferential-attachment edges per node (default 3)")
    p.add_argument("--active-prob", type=float, default=0.7,
                   help="per-(gene,group) activity probability (default .7)")
    p.add_argument("--noise", type=float, default=0.3,
                   help="in-group residual std (default 0.3; an edge keeps "
                        "|PCC|>0.5 while 1/(1+noise^2) stays above it)")
    p.add_argument("--shift", type=float, default=1.0,
                   help="mean shift of single-group-active genes")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=str, required=True, metavar="DIR",
                   help="output directory (created if missing)")
    p.add_argument("--prefix", type=str, default="big")
    p.add_argument("--stream", action="store_true",
                   help="bounded-memory writer: edges and expression "
                        "stream to disk in fixed chunks instead of "
                        "materializing [S, G] + the edge list (auto at "
                        ">= 200000 nodes; same formats, different rng "
                        "stream layout than the in-memory writer)")
    p.add_argument("--partitions", type=int, default=0, metavar="R",
                   help="write the network pre-partitioned into R "
                        "per-rank shard files + a sha256 manifest "
                        "(point --edge-partition runs at the manifest "
                        ".json; implies --stream; concatenating the "
                        "parts reproduces the unpartitioned file)")
    args = p.parse_args(argv)
    if args.genes < args.attach + 2:
        p.error(f"--genes must be >= attach+2 = {args.attach + 2}")
    if args.good < 2 or args.poor < 2:
        p.error("--good/--poor must be >= 2 (PCC needs 2+ samples/group)")
    if args.partitions < 0:
        p.error("--partitions must be >= 0")

    from g2vec_tpu_torch.data.synth import (SynthGraphSpec,
                                            write_synth_graph,
                                            write_synth_graph_streamed)

    spec = SynthGraphSpec(
        n_genes=args.genes, n_good=args.good, n_poor=args.poor,
        attach=args.attach, active_prob=args.active_prob,
        noise=args.noise, shift=args.shift, seed=args.seed)
    streamed = args.stream or args.partitions > 0 or args.genes >= 200_000
    if streamed:
        paths = write_synth_graph_streamed(spec, args.out,
                                           prefix=args.prefix,
                                           partitions=args.partitions)
    else:
        paths = write_synth_graph(spec, args.out, prefix=args.prefix)
    print(json.dumps({"spec": vars(args), "streamed": streamed, **paths},
                     indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
