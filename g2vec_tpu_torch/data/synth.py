"""Seeded scale-free synthetic inputs at any gene count.

The port's copy of ``g2vec_tpu/data/synth.py``, both writers: the
in-memory one and the streamed one (:func:`write_synth_graph_streamed`,
bounded memory at any scale, optionally pre-partitioned for
``--edge-partition``). The same spec, the same rng call order and the
same file formats, so a spec writes byte-identical files through either
package.

- **Network**: every new node attaches to ``attach`` existing nodes
  sampled in proportion to degree (the repeated-endpoint buffer), grown
  from a ring over the first ``attach + 1`` nodes: one connected
  component with power-law degree tails.
- **Expression**: each gene is active in each prognosis group with
  probability ``active_prob``; an active gene loads, with a random sign,
  on that group's per-sample latent factor plus noise, so an edge keeps
  |PCC| > 0.5 in a group iff both its ends are active there. A gene
  active in one group only is shifted in that group, which gives the
  t-scores real signal. Genes active in neither group are iid noise.

The two groups' thresholded graphs are therefore large, overlapping but
distinct subgraphs of one scale-free network, at any scale. Pure numpy.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Tuple

import numpy as np


@dataclasses.dataclass
class SynthGraphSpec:
    n_genes: int = 20_000
    n_good: int = 40
    n_poor: int = 40
    attach: int = 3              # edges per new node (mean degree ~2*attach)
    active_prob: float = 0.7     # per-(gene, group) activity
    noise: float = 0.3           # in-group residual std (corr ~ 1/(1+n^2))
    shift: float = 1.0           # mean shift of single-group-active genes
    seed: int = 0

    @property
    def n_samples(self) -> int:
        return self.n_good + self.n_poor


def iter_scale_free_edges(n_nodes: int, attach: int,
                          rng: np.random.Generator,
                          chunk_edges: int = 1 << 20):
    """Preferential-attachment edge stream: yields ``(src, dst)`` int64
    chunks of at most ``chunk_edges`` edges.

    Both ends of every accepted edge go into a repeat buffer, so a uniform
    draw from the buffer is a degree-proportional draw. Memory is the
    buffer (``2 * attach * n_nodes`` int64) plus one chunk; the chunks
    concatenated are :func:`make_scale_free_edges`'s edges (the same rng
    calls in the same order).
    """
    if n_nodes < attach + 2:
        raise ValueError(
            f"need at least attach+2={attach + 2} nodes, got {n_nodes}")
    m = attach
    rep = np.empty(2 * m * n_nodes + 4 * (m + 1), dtype=np.int64)
    buf_src = np.empty(chunk_edges, dtype=np.int64)
    buf_dst = np.empty(chunk_edges, dtype=np.int64)
    fill = count = 0
    for i in range(m + 1):
        j = (i + 1) % (m + 1)
        buf_src[fill] = i
        buf_dst[fill] = j
        fill += 1
        rep[count:count + 2] = (i, j)
        count += 2
    for v in range(m + 1, n_nodes):
        for u in np.unique(rep[rng.integers(0, count, size=m)]):
            if fill == chunk_edges:
                yield buf_src.copy(), buf_dst.copy()
                fill = 0
            buf_src[fill] = v
            buf_dst[fill] = u
            fill += 1
            rep[count:count + 2] = (v, int(u))
            count += 2
    if fill:
        yield buf_src[:fill].copy(), buf_dst[:fill].copy()


def make_scale_free_edges(n_nodes: int, attach: int,
                          rng: np.random.Generator
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`iter_scale_free_edges` as two arrays (directed as written)."""
    chunks = list(iter_scale_free_edges(n_nodes, attach, rng))
    return (np.concatenate([c[0] for c in chunks]),
            np.concatenate([c[1] for c in chunks]))


def make_synth_graph(spec: SynthGraphSpec):
    """(gene names, samples, labels, expr [S, G] f32, (src, dst) edges),
    a function of the spec alone."""
    rng = np.random.default_rng(spec.seed)
    G, S = spec.n_genes, spec.n_samples
    genes = np.array([f"SG{i:07d}" for i in range(G)])
    samples = np.array([f"SAMP-{i:05d}" for i in range(S)])
    labels = np.array([0] * spec.n_good + [1] * spec.n_poor, dtype=np.int32)

    src, dst = make_scale_free_edges(G, spec.attach, rng)

    act = rng.random((2, G)) < spec.active_prob        # per-group activity
    sign = rng.choice(np.array([-1.0, 1.0]), size=(2, G)).astype(np.float32)
    z = rng.standard_normal((2, S)).astype(np.float32)  # per-group factors

    expr = rng.standard_normal((S, G)).astype(np.float32) * spec.noise
    for gi in range(2):
        rows = labels == gi
        cols = act[gi]
        # An active gene loads on its group's factor over the background
        # noise; the rest keep the noise.
        expr[np.ix_(rows, cols)] += sign[gi, cols] * z[gi, rows][:, None]
        only = act[gi] & ~act[1 - gi]
        expr[np.ix_(rows, only)] += spec.shift
    # Genes active in neither group get unit-ish variance, so that their
    # variance does not tell them apart.
    inactive_everywhere = ~act[0] & ~act[1]
    expr[:, inactive_everywhere] += (
        rng.standard_normal((S, int(inactive_everywhere.sum())))
        .astype(np.float32))
    return genes, samples, labels, expr, (src, dst)


def write_synth_graph(spec: SynthGraphSpec, out_dir: str,
                      prefix: str = "big") -> Dict[str, str]:
    """Write the dataset as the reference's three TSVs (the layout of
    :func:`~g2vec_tpu_torch.data.synthetic.write_synthetic_tsv`); returns
    their paths and the gene and edge counts (as strings)."""
    genes, samples, labels, expr, (src, dst) = make_synth_graph(spec)
    os.makedirs(out_dir, exist_ok=True)
    paths = {
        "expression": os.path.join(out_dir, f"{prefix}_EXPRESSION.txt"),
        "clinical": os.path.join(out_dir, f"{prefix}_CLINICAL.txt"),
        "network": os.path.join(out_dir, f"{prefix}_NETWORK.txt"),
        "n_genes": str(len(genes)), "n_edges": str(len(src)),
    }
    with open(paths["expression"], "w") as f:
        f.write("PATIENT\t" + "\t".join(samples) + "\n")
        # One row a gene, "%.4f": tens of MB at 100k genes.
        for j, g in enumerate(genes):
            f.write(g + "\t" + "\t".join("%.4f" % v for v in expr[:, j])
                    + "\n")
    with open(paths["clinical"], "w") as f:
        f.write("PATIENT_BARCODE\tLABEL\n")
        for s, lab in zip(samples, labels):
            f.write(f"{s}\t{int(lab)}\n")
    with open(paths["network"], "w") as f:
        f.write("src\tdest\n")
        for a, b in zip(src, dst):
            f.write(f"{genes[a]}\t{genes[b]}\n")
    return paths


_EXPR_BLOCK = 16384   # a fixed gene block: the bytes do not depend on chunking


def _streamed_expr_block(spec: SynthGraphSpec, labels: np.ndarray,
                         z: np.ndarray, block: int, lo: int, hi: int
                         ) -> np.ndarray:
    """One ``[S, hi-lo]`` expression block of the streamed dataset. Its
    genes draw from a child stream keyed on the block's index on the
    fixed ``_EXPR_BLOCK`` grid; the group factors ``z`` are shared by all
    blocks, so the in-group correlation the threshold keys on holds across
    blocks."""
    rng = np.random.default_rng([spec.seed, 2, block])
    gb = hi - lo
    S = spec.n_samples
    act = rng.random((2, gb)) < spec.active_prob
    sign = rng.choice(np.array([-1.0, 1.0]), size=(2, gb)).astype(np.float32)
    expr = rng.standard_normal((S, gb)).astype(np.float32) * spec.noise
    for gi in range(2):
        rows = labels == gi
        cols = act[gi]
        expr[np.ix_(rows, cols)] += sign[gi, cols] * z[gi, rows][:, None]
        only = act[gi] & ~act[1 - gi]
        expr[np.ix_(rows, only)] += spec.shift
    inactive = ~act[0] & ~act[1]
    expr[:, inactive] += (
        rng.standard_normal((S, int(inactive.sum()))).astype(np.float32))
    return expr


def write_synth_graph_streamed(spec: SynthGraphSpec, out_dir: str,
                               prefix: str = "big",
                               edge_chunk: int = 1 << 20,
                               partitions: int = 0) -> Dict[str, str]:
    """:func:`write_synth_graph` in bounded memory: the edges stream to
    disk in chunks (:func:`iter_scale_free_edges`) and the expression is
    drawn a fixed ``_EXPR_BLOCK``-gene block at a time from per-block
    seeds, so memory is O(block), not O(S x G) + O(edges). The bytes are a
    function of the spec alone, whatever ``edge_chunk``; they are not
    :func:`write_synth_graph`'s (another rng layout, the same distribution
    and formats).

    ``partitions = R > 0`` writes the network pre-partitioned for
    ``--edge-partition``: R part files (each edge in the part of its
    source's owner under :func:`~g2vec_tpu_torch.parallel.shard.
    edge_range`'s split of the node ids), a genes file (the endpoint set,
    so a rank scans names without reading edges) and a manifest of the
    parts' sha256s, which the reader checks before a range read. The
    generator emits edges in non-decreasing source order, so the parts'
    bodies, concatenated in manifest order, are the flat file's body.
    """
    G, S = spec.n_genes, spec.n_samples
    if G < spec.attach + 2:
        raise ValueError(
            f"need at least attach+2={spec.attach + 2} genes, got {G}")
    labels = np.array([0] * spec.n_good + [1] * spec.n_poor, dtype=np.int32)
    samples = [f"SAMP-{i:05d}" for i in range(S)]
    os.makedirs(out_dir, exist_ok=True)
    paths = {
        "expression": os.path.join(out_dir, f"{prefix}_EXPRESSION.txt"),
        "clinical": os.path.join(out_dir, f"{prefix}_CLINICAL.txt"),
        "network": os.path.join(out_dir, f"{prefix}_NETWORK.txt"),
        "n_genes": str(G),
    }
    with open(paths["clinical"], "w") as f:
        f.write("PATIENT_BARCODE\tLABEL\n")
        for s, lab in zip(samples, labels):
            f.write(f"{s}\t{int(lab)}\n")

    z = (np.random.default_rng([spec.seed, 1])
         .standard_normal((2, S)).astype(np.float32))
    row_fmt = "\t%.4f" * S
    with open(paths["expression"], "w") as f:
        f.write("PATIENT\t" + "\t".join(samples) + "\n")
        for lo in range(0, G, _EXPR_BLOCK):
            hi = min(lo + _EXPR_BLOCK, G)
            expr = _streamed_expr_block(spec, labels, z,
                                        lo // _EXPR_BLOCK, lo, hi)
            f.write("".join(
                "SG%07d%s\n" % (lo + j, row_fmt % tuple(expr[:, j]))
                for j in range(hi - lo)))

    edge_rng = np.random.default_rng([spec.seed, 0])
    edge_iter = iter_scale_free_edges(G, spec.attach, edge_rng,
                                      chunk_edges=edge_chunk)
    if partitions <= 0:
        n_edges = 0
        with open(paths["network"], "w") as f:
            f.write("src\tdest\n")
            for src, dst in edge_iter:
                f.write("".join("SG%07d\tSG%07d\n" % (a, b)
                                for a, b in zip(src, dst)))
                n_edges += len(src)
        paths["n_edges"] = str(n_edges)
        return paths

    from g2vec_tpu_torch.utils.integrity import sha256_file, write_json_atomic

    bounds = np.array([p * G // partitions for p in range(partitions)],
                      dtype=np.int64)
    part_names = [f"{prefix}_NETWORK.part{p:03d}.txt"
                  for p in range(partitions)]
    part_edges = [0] * partitions
    seen = np.zeros(G, dtype=bool)
    files = [open(os.path.join(out_dir, name), "w") for name in part_names]
    try:
        for f in files:
            f.write("src\tdest\n")
        n_edges = 0
        for src, dst in edge_iter:
            seen[src] = True
            seen[dst] = True
            owner = np.searchsorted(bounds, src, side="right") - 1
            for p in np.unique(owner):
                sel = owner == p
                files[p].write("".join(
                    "SG%07d\tSG%07d\n" % (a, b)
                    for a, b in zip(src[sel], dst[sel])))
                part_edges[p] += int(sel.sum())
            n_edges += len(src)
    finally:
        for f in files:
            f.close()
    genes_name = f"{prefix}_NETWORK.genes.txt"
    with open(os.path.join(out_dir, genes_name), "w") as f:
        f.write("".join("SG%07d\n" % g for g in np.nonzero(seen)[0]))
    hi_bounds = [int(bounds[p + 1]) if p + 1 < partitions else G
                 for p in range(partitions)]
    manifest_path = os.path.join(out_dir, f"{prefix}_NETWORK.manifest.json")
    write_json_atomic(manifest_path, {
        "format": "g2vec-network-partitions-v1",
        "partitions": partitions,
        "n_genes": G,
        "genes_file": genes_name,
        "files": [
            {"name": part_names[p],
             "sha256": sha256_file(os.path.join(out_dir, part_names[p])),
             "n_edges": part_edges[p],
             # The part's inclusive source-name range: the reader skips
             # the parts whose range misses the one it reads.
             "gene_lo": "SG%07d" % int(bounds[p]),
             "gene_hi": "SG%07d" % (hi_bounds[p] - 1)}
            for p in range(partitions)],
    })
    paths["network"] = manifest_path
    paths["n_edges"] = str(n_edges)
    return paths
