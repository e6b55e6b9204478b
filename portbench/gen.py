"""The benchmark's input generator: expression, clinical and network TSVs
of a configuration's published shape, from a seed.

A frozen copy of ``make_synthetic`` (``g2vec_tpu_torch/data/synthetic.py``
:76-140, itself ``g2vec_tpu/data/synthetic.py``'s), vectorised, with every
size taken from the configuration file and every published count met
exactly. The planted structure is the original's:

- three gene modules: ``GMOD`` co-expressed (one latent factor) in the
  good-prognosis samples only and shifted there, so their edges pass the
  |PCC| > 0.5 threshold in the good group's graph; ``PMOD`` the same for
  the poor group; ``SMOD`` co-expressed in both groups, so identical
  walks arise in both path sets and exercise the common-path drop;
- ``BACK`` genes, noise everywhere, whose edges die at the threshold;
- ``NONL`` genes only in the network file, ``XONL`` only in the
  expression file, which exercise the intersection.

What differs from the original, so that a file has its configuration's
published counts: a module's chords are drawn without self-loops or
repeats (each module gene has exactly ``1 + chords`` out-edges), background
edges cover every background gene (a ring, then distinct random pairs),
network-only genes get distinct edges until the file holds its published
edge and gene counts, no edge appears twice, and the edge lines are
shuffled. Expression values are kept as signed micro-units, which is what
the ``%.6f`` text holds, so the reference reads the values the files hold
without parsing them.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List

import numpy as np

from reference.text import fixed6_lines


@dataclasses.dataclass
class Dataset:
    """One generated input set, as the files hold it."""

    names: np.ndarray          # [n_names] gene symbols (str)
    samples: List[str]         # expression columns, in file order
    labels: np.ndarray         # [S] 0 good / 1 poor, in sample order
    expr_rows: np.ndarray      # [G_expr] name index of each expression row
    expr_micro: np.ndarray     # [G_expr, S] int64 values in micro-units
    src: np.ndarray            # [E] name index of each edge's source, in
    dst: np.ndarray            # [E] file order; and of its destination

    def expr_values(self) -> np.ndarray:
        """[G_expr, S] float64 values, as the file's decimals."""
        return self.expr_micro / 1e6


def _unique_pairs(rng, need: int, draw, n_names: int, taken: np.ndarray):
    """``need`` new directed pairs from ``draw(k) -> (a, b)``, neither a
    self-loop nor a key already in the sorted ``taken``; returns (a, b,
    taken with them)."""
    out_a, out_b = [], []
    while need > 0:
        a, b = draw(need + need // 4 + 64)
        ok = a != b
        a, b = a[ok], b[ok]
        keys = a.astype(np.int64) * n_names + b
        _, first = np.unique(keys, return_index=True)
        first.sort()
        a, b, keys = a[first], b[first], keys[first]
        fresh = ~np.isin(keys, taken, assume_unique=True)
        a, b, keys = a[fresh][:need], b[fresh][:need], keys[fresh][:need]
        out_a.append(a)
        out_b.append(b)
        taken = np.union1d(taken, keys)
        need -= a.size
    cat = (lambda xs: np.concatenate(xs) if xs
           else np.zeros(0, np.int64))
    return cat(out_a), cat(out_b), taken


def _module_edges(rng, lo: int, size: int, chords: int):
    """A directed ring over genes [lo, lo + size) plus ``chords`` distinct
    further out-edges a gene (offsets 2 .. size-1)."""
    i = np.arange(size)
    src = [i, np.repeat(i, chords)]
    offs = np.stack([rng.choice(size - 2, chords, replace=False) + 2
                     for _ in range(size)])
    dst = [(i + 1) % size, ((i[:, None] + offs) % size).ravel()]
    return lo + np.concatenate(src), lo + np.concatenate(dst)


def make_dataset(spec: Dict, seed: int) -> Dataset:
    """The configuration's ``data`` block -> a :class:`Dataset`."""
    rng = np.random.default_rng(seed)
    n_good, n_poor = spec["n_good"], spec["n_poor"]
    m, ms, chords = (spec["module_size"], spec["shared_module_size"],
                     spec["module_chords"])
    n_common = spec["common_genes"]
    n_bg = n_common - 2 * m - ms
    n_net_only = spec["network_genes"] - n_common
    n_expr_only = spec["expression_only_genes"]
    if min(n_bg, n_net_only, n_expr_only) < 0 or m < chords + 2:
        raise ValueError(f"inconsistent data spec: {spec}")
    blocks = [("GMOD", m), ("PMOD", m), ("SMOD", ms), ("BACK", n_bg),
              ("NONL", n_net_only), ("XONL", n_expr_only)]
    names = np.array([f"{p}{i:05d}" for p, n in blocks for i in range(n)])
    n_names = names.size
    net_hi = n_common + n_net_only

    # Expression: common genes and expression-only genes.
    s = n_good + n_poor
    labels = np.array([0] * n_good + [1] * n_poor, np.int32)
    good, poor = labels == 0, labels == 1
    expr_idx = np.concatenate([np.arange(n_common),
                               np.arange(net_hi, n_names)])
    x = rng.standard_normal((n_names, s))
    z_g, z_p, z_s = rng.standard_normal((3, s))
    e = rng.standard_normal((2 * m + ms, s)) * spec["noise"]
    shift = spec["shift"]
    x[:m] = np.where(good, z_g + e[:m], x[:m]) + shift * good
    x[m:2 * m] = np.where(poor, z_p + e[m:2 * m], x[m:2 * m]) + shift * poor
    x[2 * m:2 * m + ms] = z_s + e[2 * m:]
    order = expr_idx[rng.permutation(expr_idx.size)]
    micro = np.rint(x[order] * 1e6).astype(np.int64)

    # Edges among the common genes: modules, then background.
    parts = [_module_edges(rng, lo, size, chords)
             for lo, size in ((0, m), (m, m), (2 * m, ms))]
    bg0 = 2 * m + ms
    ring = bg0 + rng.permutation(n_bg)
    parts.append((ring, np.roll(ring, -1)))
    src = np.concatenate([p[0] for p in parts]).astype(np.int64)
    dst = np.concatenate([p[1] for p in parts]).astype(np.int64)
    taken = np.unique(src * n_names + dst)
    if taken.size != src.size:
        raise ValueError("module or ring edges repeat: spec too small")
    n_bg_edges = spec["common_edges"] - src.size
    a, b, taken = _unique_pairs(
        rng, n_bg_edges, lambda k: (rng.integers(bg0, n_common, k),
                                    rng.integers(bg0, n_common, k)),
        n_names, taken)
    src, dst = np.concatenate([src, a]), np.concatenate([dst, b])

    # Network-only genes: one out-edge each, then random edges with at
    # least one network-only end.
    nonl = np.arange(n_common, net_hi)
    cover = (nonl + 1 + rng.integers(0, net_hi - 1, nonl.size)) % net_hi
    keys = nonl * n_names + cover
    if np.isin(keys, taken).any() or np.unique(keys).size != keys.size:
        raise ValueError("network-only cover edges repeat")
    taken = np.union1d(taken, keys)
    src, dst = np.concatenate([src, nonl]), np.concatenate([dst, cover])

    def draw_nonl(k):
        a = rng.integers(n_common, net_hi, k)
        b = rng.integers(0, net_hi, k)
        flip = rng.random(k) < 0.5
        return np.where(flip, b, a), np.where(flip, a, b)

    n_more = spec["network_edges"] - src.size
    a, b, taken = _unique_pairs(rng, n_more, draw_nonl, n_names, taken)
    src, dst = np.concatenate([src, a]), np.concatenate([dst, b])
    perm = rng.permutation(src.size)
    return Dataset(names=names, samples=[f"SAMP-{i:04d}" for i in range(s)],
                   labels=labels, expr_rows=order, expr_micro=micro,
                   src=src[perm], dst=dst[perm])


def write_tsvs(ds: Dataset, out_dir: str, prefix: str = "bench"
               ) -> Dict[str, str]:
    """The three reference-format TSVs; returns their paths."""
    os.makedirs(out_dir, exist_ok=True)
    paths = {k: os.path.join(out_dir, f"{prefix}_{k.upper()}.txt")
             for k in ("expression", "clinical", "network")}
    micro = ds.expr_micro
    with open(paths["expression"], "wb") as f:
        f.write(("PATIENT\t" + "\t".join(ds.samples) + "\n").encode())
        for lo in range(0, micro.shape[0], 2048):
            part = micro[lo:lo + 2048]
            f.write(fixed6_lines(ds.names[ds.expr_rows[lo:lo + 2048]],
                                 part < 0, np.abs(part)))
    with open(paths["clinical"], "w") as f:
        f.write("PATIENT_BARCODE\tLABEL\n")
        f.write("".join(f"{s}\t{int(l)}\n"
                        for s, l in zip(ds.samples, ds.labels)))
    name_b = np.array([n.encode("ascii") for n in ds.names], dtype=bytes)
    w = name_b.dtype.itemsize
    u8 = name_b.view(np.uint8).reshape(-1, w)
    line = np.empty((ds.src.size, 2 * w + 2), np.uint8)
    line[:, :w] = u8[ds.src]
    line[:, w] = ord("\t")
    line[:, w + 1:2 * w + 1] = u8[ds.dst]
    line[:, -1] = ord("\n")
    with open(paths["network"], "wb") as f:
        f.write(b"src\tdest\n")
        f.write(line.tobytes())
    return paths
