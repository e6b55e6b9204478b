"""Synthetic dataset generator with planted prognostic structure.

A copy of ``g2vec_tpu/data/synthetic.py`` (same random draws, so the same
spec writes byte-identical TSVs from either package) plus the named scales
of ``g2vec_tpu/data/make_example.py``.

- Three planted gene modules:
  * ``Mg`` — co-expressed ONLY in good-prognosis samples (so the good-group
    |PCC|>0.5 graph contains its edges) and differentially expressed
    between groups (so t-scores light up).
  * ``Mp`` — symmetric for the poor group.
  * ``Ms`` — co-expressed in BOTH groups: its edges appear in both graphs,
    so identical walk gene-sets arise in both path sets and exercise the
    common-path drop (ref: G2Vec.py:313-315).
- Background genes with iid noise; background edges get |PCC| ~ 0 and are
  dropped by the threshold.
- Extra expression-only genes and network-only genes exercise the
  intersection logic (ref: G2Vec.py:420-426).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Tuple

import numpy as np

from g2vec_tpu_torch.io.readers import ExpressionData, NetworkData


@dataclasses.dataclass
class SyntheticSpec:
    n_good: int = 40            # good-prognosis samples (label 0)
    n_poor: int = 30            # poor-prognosis samples (label 1)
    module_size: int = 24       # genes per group-specific planted module
    shared_module_size: int | None = None  # Ms size; None = module_size
    n_background: int = 60      # noise genes in both expression and network
    n_expr_only: int = 8        # genes only in the expression file
    n_net_only: int = 8         # genes only in the network file
    module_chords: int = 3      # extra random in-module edges per gene (besides the ring)
    background_edges: int = 120
    noise: float = 0.3          # in-module residual std (corr ~ 1/(1+noise^2))
    shift: float = 1.2          # between-group mean shift for Mg/Mp genes
    seed: int = 0

    @property
    def n_samples(self) -> int:
        return self.n_good + self.n_poor


#: Named scales (``g2vec_tpu/data/make_example.py``). ``example`` matches
#: the reference's bundled example (README.md:26-32): 135 samples (77/58
#: labels), ~7.5k common genes, tens of thousands of group-specific paths
#: at -p 80 -r 10.
SCALES = {
    "small": SyntheticSpec(),
    "medium": SyntheticSpec(
        n_good=77, n_poor=58, module_size=100, shared_module_size=16,
        n_background=700, n_expr_only=20, n_net_only=20, module_chords=6,
        background_edges=2000, noise=0.25, seed=0),
    "example": SyntheticSpec(
        n_good=77, n_poor=58, module_size=1700, shared_module_size=150,
        n_background=2300, n_expr_only=80, n_net_only=80,
        module_chords=6, background_edges=20000, noise=0.25, seed=0),
}


def _module_edges(genes: List[str], chords: int, rng: np.random.Generator
                  ) -> List[Tuple[str, str]]:
    """A directed ring (guarantees connectivity) plus random chords."""
    n = len(genes)
    edges = [(genes[i], genes[(i + 1) % n]) for i in range(n)]
    for i in range(n):
        for j in rng.choice(n, size=min(chords, n - 1), replace=False):
            if j != i:
                edges.append((genes[i], genes[int(j)]))
    return edges


def make_synthetic(spec: SyntheticSpec
                   ) -> Tuple[ExpressionData, Dict[str, int], NetworkData, Dict[str, List[str]]]:
    """Build (expression, clinical, network, module-membership) in memory."""
    rng = np.random.default_rng(spec.seed)
    m = spec.module_size
    ms_size = spec.shared_module_size if spec.shared_module_size is not None else m

    mg = [f"GMOD{i:04d}" for i in range(m)]              # good module
    mp = [f"PMOD{i:04d}" for i in range(m)]              # poor module
    ms = [f"SMOD{i:04d}" for i in range(ms_size)]        # shared module
    bg = [f"BACK{i:04d}" for i in range(spec.n_background)]
    expr_only = [f"XONL{i:04d}" for i in range(spec.n_expr_only)]
    net_only = [f"NONL{i:04d}" for i in range(spec.n_net_only)]

    expr_genes = mg + mp + ms + bg + expr_only
    # Shuffle so sorted order interleaves the modules (stress the index maps).
    order = rng.permutation(len(expr_genes))
    expr_genes = [expr_genes[i] for i in order]

    samples = np.array([f"SAMP-{i:04d}" for i in range(spec.n_samples)])
    labels = np.array([0] * spec.n_good + [1] * spec.n_poor, dtype=np.int32)
    clinical = {s: int(l) for s, l in zip(samples, labels)}

    good = labels == 0
    poor = labels == 1
    n = spec.n_samples

    # Per-sample latent factors.
    z_g = rng.standard_normal(n)   # drives Mg inside the good group
    z_p = rng.standard_normal(n)   # drives Mp inside the poor group
    z_s = rng.standard_normal(n)   # drives Ms everywhere

    cols: Dict[str, np.ndarray] = {}
    for g in mg:
        e = rng.standard_normal(n) * spec.noise
        col = np.where(good, z_g + e, rng.standard_normal(n))
        col = col + np.where(good, spec.shift, 0.0)       # differential expression
        cols[g] = col
    for g in mp:
        e = rng.standard_normal(n) * spec.noise
        col = np.where(poor, z_p + e, rng.standard_normal(n))
        col = col + np.where(poor, spec.shift, 0.0)
        cols[g] = col
    for g in ms:
        cols[g] = z_s + rng.standard_normal(n) * spec.noise
    for g in bg + expr_only:
        cols[g] = rng.standard_normal(n)

    expr = np.stack([cols[g] for g in expr_genes], axis=1).astype(np.float32)
    expression = ExpressionData(sample=samples, gene=np.array(expr_genes), expr=expr)

    edges: List[Tuple[str, str]] = []
    edges += _module_edges(mg, spec.module_chords, rng)
    edges += _module_edges(mp, spec.module_chords, rng)
    edges += _module_edges(ms, spec.module_chords, rng)
    pool = bg + net_only
    for _ in range(spec.background_edges):
        i, j = rng.choice(len(pool), size=2, replace=False)
        edges.append((pool[int(i)], pool[int(j)]))
    network = NetworkData.from_edges(edges)

    membership = {"good": mg, "poor": mp, "shared": ms, "background": bg}
    return expression, clinical, network, membership


def write_synthetic_tsv(spec: SyntheticSpec, out_dir: str,
                        prefix: str = "syn") -> Dict[str, str]:
    """Write the synthetic dataset as reference-format TSV files."""
    expression, clinical, network, _ = make_synthetic(spec)
    os.makedirs(out_dir, exist_ok=True)
    paths = {
        "expression": os.path.join(out_dir, f"{prefix}_EXPRESSION.txt"),
        "clinical": os.path.join(out_dir, f"{prefix}_CLINICAL.txt"),
        "network": os.path.join(out_dir, f"{prefix}_NETWORK.txt"),
    }
    with open(paths["expression"], "w") as f:
        f.write("PATIENT\t" + "\t".join(expression.sample) + "\n")
        for j, g in enumerate(expression.gene):
            vals = "\t".join("%.6f" % v for v in expression.expr[:, j])
            f.write(f"{g}\t{vals}\n")
    with open(paths["clinical"], "w") as f:
        f.write("PATIENT_BARCODE\tLABEL\n")
        for s in expression.sample:
            f.write(f"{s}\t{clinical[s]}\n")
    with open(paths["network"], "w") as f:
        f.write("src\tdest\n")
        for a, b in network.edges:
            f.write(f"{a}\t{b}\n")
    return paths
