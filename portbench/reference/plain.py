"""The plain reference of a G2Vec run, in NumPy and plain PyTorch.

Written from the reference's semantics (G2Vec.py, as its README and the
port's docstrings state them), from the inputs the benchmark generated,
and independent of the program: it imports nothing of it and takes none of
its tables. Each stage is a function; :func:`run_reference` chains them
into a whole run (used as the control, in a lower precision, and by the
CPU tests), and :mod:`reference.judge` uses them one by one to judge what
the program produced.

- Stage 2: the sorted intersection of the expression's and the network's
  genes; the edges with both ends in it, in file order.
- Stage 3: each group's |PCC| per edge (population z-scores, a constant
  gene correlates 0), kept if > threshold, repeated (src, dst) pairs
  collapsed to the first; weighted walks without revisits from every
  gene ``reps`` times, each walker on its own splitmix64 stream keyed by
  (seed, walker index), written as packed multi-hot rows; the two groups'
  row sets integrated (paths in both are dropped); per-gene votes.
- Stage 4: the modified CBOW (``X @ W_ih @ W_ho``, no bias), a seeded
  80/20 split, truncated-normal init, full-batch Adam (TF1 defaults,
  optax's order), accuracies after each update, stop at the first strict
  dip of the validation accuracy keeping the weights before it.
- Stage 5: k-means with k = 3 over the embeddings (k-means++ restarts
  drawn from a seeded CPU ``torch.Generator``, a fixed number of Lloyd
  steps, the restart of least inertia); the largest cluster is "other",
  the other two are voted good and poor by the gene votes.
- Stage 6: gene scores, ``mix * minmax(|W_ih row|) + (1 - mix) *
  minmax(|t|)`` within each L-group; the top N of each group.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_MIX1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX2 = np.uint64(0x94D049BB133111EB)
_ADAM_B1, _ADAM_B2, _ADAM_EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass(frozen=True)
class Precision:
    """Where the reference rounds. The plain reference computes in the
    precision the configurations state: |PCC|, k-means and scores in
    float64 on the host (they state float32), and the trainer's products
    with both operands rounded to bfloat16 and float32 sums, TF32 off (they
    state bfloat16 compute and float32 parameters); the control rounds each
    stage to the precision below (``control()``)."""

    pcc: Optional[torch.dtype] = None      # |PCC| rounded to this
    train: Optional[torch.dtype] = torch.bfloat16   # each product's operands
    kmeans: Optional[torch.dtype] = None   # distances' operands
    scores: Optional[torch.dtype] = None   # gene scores

    @staticmethod
    def control() -> "Precision":
        return Precision(pcc=torch.bfloat16, train=torch.float8_e4m3fn,
                         kmeans=torch.bfloat16, scores=torch.bfloat16)


PLAIN = Precision()


def _round(x: np.ndarray, dtype: Optional[torch.dtype]) -> np.ndarray:
    if dtype is None:
        return x
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        dtype).to(torch.float64).numpy()


# ----------------------------------------------------------------- stage 2

@dataclasses.dataclass
class Graph:
    genes: np.ndarray          # [G] sorted common gene symbols
    expr: np.ndarray           # [S, G] float64 in the genes' order
    labels: np.ndarray         # [S] 0 good / 1 poor
    src: np.ndarray            # [E] int64 edge sources (file order)
    dst: np.ndarray


def common_graph(names, samples, labels, expr_rows, expr_values, src, dst
                 ) -> Graph:
    """Stage 2 from the dataset's arrays (names indexed by the others)."""
    expr_set = set(int(i) for i in expr_rows)
    net_set = set(int(i) for i in src) | set(int(i) for i in dst)
    common = sorted(expr_set & net_set, key=lambda i: names[i])
    genes = np.array([names[i] for i in common])
    pos = np.full(len(names), -1, np.int64)
    pos[np.array(common, np.int64)] = np.arange(len(common))
    keep = (pos[src] >= 0) & (pos[dst] >= 0)
    row_of = np.full(len(names), -1, np.int64)
    row_of[expr_rows] = np.arange(len(expr_rows))
    expr = np.ascontiguousarray(expr_values[row_of[common]].T)
    return Graph(genes=genes, expr=expr, labels=np.asarray(labels),
                 src=pos[src[keep]], dst=pos[dst[keep]])


# ----------------------------------------------------------------- stage 3

def abs_pcc(expr_group: np.ndarray, src: np.ndarray, dst: np.ndarray
            ) -> np.ndarray:
    """|PCC| of each edge's endpoint genes over the group's samples."""
    x = np.asarray(expr_group, np.float64)
    c = x - x.mean(axis=0)
    sd = np.sqrt((c * c).mean(axis=0))
    const = x.max(axis=0) == x.min(axis=0)
    z = np.where(const | (sd == 0), 0.0, c / np.where(sd > 0, sd, 1.0))
    zt = np.ascontiguousarray(z.T)
    out = np.empty(src.size)
    for lo in range(0, src.size, 1 << 16):
        s, d = src[lo:lo + (1 << 16)], dst[lo:lo + (1 << 16)]
        out[lo:lo + s.size] = np.abs((zt[s] * zt[d]).mean(axis=1))
    return out


def group_csr(graph: Graph, group: int, threshold: float,
              prec: Precision = PLAIN):
    """One group's thresholded graph as CSR ``(indptr, indices,
    float32 weights)``, rows in source order, neighbours in file order."""
    w = _round(abs_pcc(graph.expr[graph.labels == group], graph.src,
                       graph.dst), prec.pcc)
    keep = w > threshold
    s, d, w = graph.src[keep], graph.dst[keep], w[keep]
    _, first = np.unique(s * (graph.genes.size + 1) + d, return_index=True)
    first.sort()
    s, d, w = s[first], d[first], w[first]
    order = np.argsort(s, kind="stable")
    indptr = np.zeros(graph.genes.size + 1, np.int64)
    np.cumsum(np.bincount(s, minlength=graph.genes.size), out=indptr[1:])
    return indptr, d[order], w[order].astype(np.float32)


def _splitmix(state: np.ndarray) -> np.ndarray:
    """Advance each uint64 state; return its splitmix64 output."""
    state += _GOLDEN
    z = state.copy()
    z = (z ^ (z >> np.uint64(30))) * _MIX1
    z = (z ^ (z >> np.uint64(27))) * _MIX2
    return z ^ (z >> np.uint64(31))


def walk_rows(csr, n_genes: int, len_path: int, reps: int, seed: int
              ) -> np.ndarray:
    """Every gene's ``reps`` walks -> [G * reps, ceil(G / 8)] packed rows
    (walker w starts at gene ``w % G`` on stream w). A step draws
    ``u * total`` with u the stream's next 53-bit uniform and total the
    float64 running sum of the unvisited neighbours' weights, and goes to
    the first neighbour whose running sum exceeds it; a walk ends at
    ``len_path`` genes or where no neighbour is left."""
    indptr, indices, weights = csr
    n = n_genes * reps
    nb = (n_genes + 7) // 8
    rows = np.zeros((n, nb), np.uint8)
    cur = np.tile(np.arange(n_genes, dtype=np.int64), reps)
    bit = (np.uint8(0x80) >> (np.arange(8, dtype=np.uint8)))
    rows[np.arange(n), cur >> 3] |= bit[cur & 7]
    with np.errstate(over="ignore"):
        state = np.uint64(seed) ^ (np.arange(n, dtype=np.uint64) * _GOLDEN)
        _splitmix(state)
        alive = np.arange(n)
        for _ in range(1, len_path):
            c = cur[alive]
            lo, deg = indptr[c], indptr[c + 1] - indptr[c]
            width = int(deg.max(initial=0))
            if width == 0:
                break
            col = np.arange(width)
            valid = col[None, :] < deg[:, None]
            pos = np.where(valid, lo[:, None] + col[None, :], 0)
            nbr = indices[pos] if indices.size else np.zeros_like(pos)
            w = weights[pos] if weights.size else np.zeros(pos.shape,
                                                          np.float32)
            seen = rows[alive[:, None], nbr >> 3] & bit[nbr & 7]
            elig = valid & (seen == 0) & (w > 0)
            run = np.cumsum(np.where(elig, w.astype(np.float64), 0.0),
                            axis=1)
            total = run[:, -1]
            go = elig.any(axis=1) & (total > 0)
            alive, run, elig, nbr, total = (alive[go], run[go], elig[go],
                                            nbr[go], total[go])
            if alive.size == 0:
                break
            st = state[alive]
            u = (_splitmix(st) >> np.uint64(11)).astype(np.float64) \
                * 2.0 ** -53
            state[alive] = st
            target = u * total
            hit = elig & (target[:, None] < run)
            last = width - 1 - np.argmax(elig[:, ::-1], axis=1)
            j = np.where(hit.any(axis=1), np.argmax(hit, axis=1), last)
            nxt = nbr[np.arange(alive.size), j]
            rows[alive, nxt >> 3] |= bit[nxt & 7]
            cur[alive] = nxt
    return rows


def integrate(rows_good: np.ndarray, rows_poor: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Drop rows found in both groups; (rows sorted by bytes, good block
    then poor, labels)."""
    def uniq(r):
        return set(r[i].tobytes() for i in range(r.shape[0]))

    g, p = uniq(rows_good), uniq(rows_poor)
    both = g & p
    nb = rows_good.shape[1]
    blocks = [np.frombuffer(b"".join(sorted(s - both)), np.uint8).reshape(
        -1, nb) for s in (g, p)]
    labels = np.repeat([0, 1], [blocks[0].shape[0], blocks[1].shape[0]])
    return np.concatenate(blocks), labels.astype(np.int32)


def gene_votes(rows: np.ndarray, labels: np.ndarray, n_genes: int
               ) -> np.ndarray:
    """[G] 0 where more good than poor paths hold the gene, 1 for poor, 2
    on a tie or in no path."""
    counts = []
    for lab in (0, 1):
        part = rows[labels == lab]
        tot = np.zeros(n_genes, np.int64)
        for lo in range(0, part.shape[0], 4096):
            tot += np.unpackbits(part[lo:lo + 4096], axis=1)[
                :, :n_genes].sum(axis=0, dtype=np.int64)
        counts.append(tot)
    return np.where(counts[0] > counts[1], 0,
                    np.where(counts[0] < counts[1], 1, 2)).astype(np.int32)


def stage3(graph: Graph, run: Dict, seed: int, prec: Precision = PLAIN):
    """Both groups' walks integrated: (rows, labels, csr per group)."""
    csrs, walked = [], []
    for group in (0, 1):
        csr = group_csr(graph, group, run["pcc_threshold"], prec)
        csrs.append(csr)
        walked.append(walk_rows(csr, graph.genes.size, run["lenPath"],
                                run["numRepetition"], (seed << 1) | group))
    rows, labels = integrate(*walked)
    return rows, labels, csrs


# ----------------------------------------------------------------- stage 4

def split(n: int, seed: int, val_fraction: float):
    perm = np.random.default_rng(seed).permutation(n)
    pivot = int(n * (1.0 - val_fraction))
    return perm[:pivot], perm[pivot:]


def init_weights(n_genes: int, hidden: int, seed: int):
    """Truncated normal on [-2, 2] over sqrt(hidden), W_ih then W_ho, from
    one CPU generator."""
    gen = torch.Generator().manual_seed(seed)
    w_ih = torch.empty((n_genes, hidden), dtype=torch.float32)
    w_ho = torch.empty((hidden, 1), dtype=torch.float32)
    torch.nn.init.trunc_normal_(w_ih, 0.0, 1.0, -2.0, 2.0, generator=gen)
    torch.nn.init.trunc_normal_(w_ho, 0.0, 1.0, -2.0, 2.0, generator=gen)
    scale = 1.0 / float(np.sqrt(hidden))
    return w_ih * scale, w_ho * scale


def dense_rows(rows: np.ndarray, n_genes: int, device) -> torch.Tensor:
    """Packed rows -> [N, G] 0/1 float32 on ``device``, unpacked there."""
    p = torch.from_numpy(np.ascontiguousarray(rows)).to(device)
    shifts = torch.arange(7, -1, -1, device=device, dtype=torch.uint8)
    bits = (p.unsqueeze(-1) >> shifts) & 1
    return bits.reshape(p.shape[0], -1)[:, :n_genes].to(torch.float32)


@dataclasses.dataclass
class TrainTrace:
    losses: List[float]        # loss at each update's entry weights
    acc_val: List[float]       # validation accuracy after each update
    w_ih0: np.ndarray          # the init
    snapshots: Dict[int, np.ndarray]   # W_ih after k updates, asked for
    stop_updates: int          # updates kept by the first-dip rule
    # W_ih elements whose gradient, in each of the first ``clear_after``
    # updates, stood clear of the rounding of ``clear_dtype`` products and
    # kept one sign (``direction``: the sign of their change).
    clear: Optional[np.ndarray] = None
    direction: Optional[np.ndarray] = None
    clear_after: int = 0


#: A gradient element is clear of a precision's rounding when it exceeds
#: this many times the rounding's root-sum-square estimate.
CLEAR_ROUNDOFFS = 4.0


def train(rows: np.ndarray, labels: np.ndarray, n_genes: int, run: Dict,
          seed: int, device, updates: int, keep: Sequence[int] = (),
          stop_at_dip: bool = False, prec: Precision = PLAIN,
          clear_after: int = 0, clear_dtype=torch.bfloat16) -> TrainTrace:
    """Up to ``updates`` full-batch Adam steps; W_ih after each count in
    ``keep``. With ``stop_at_dip`` training ends at the first update whose
    validation accuracy is below the one before it, and the weights kept
    (``snapshots[stop_updates]``) are those before that update. With
    ``clear_after`` k, the W_ih elements whose gradient in each of the
    first k updates exceeds ``CLEAR_ROUNDOFFS`` times the rounding that
    ``clear_dtype`` products put into it (the logits' and the backward
    operand's, root-sum-square over the rows), with one sign throughout
    (``TrainTrace.clear``): their change must have that sign in any run
    whose products are at least that precise."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tr, vl = split(rows.shape[0], seed, run["val_fraction"])
    x = dense_rows(rows, n_genes, device)
    y = torch.from_numpy(labels.astype(np.float32)).to(device)[:, None]
    w0_ih, w0_ho = init_weights(n_genes, run["sizeHiddenlayer"], seed)
    params = [w0_ih.to(device), w0_ho.to(device)]
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    tr_t = torch.from_numpy(tr).to(device)
    vl_t = torch.from_numpy(vl).to(device)
    x_tr, y_tr = x[tr_t], y[tr_t]
    lr = run["learningRate"]
    thr = float(np.log(run["decision_threshold"]
                       / (1 - run["decision_threshold"])))

    def q(t):
        if prec.train is None:
            return t
        if prec.train.itemsize > 1:
            return t.to(prec.train).to(torch.float32)
        # float8: scaled per tensor to the format's largest value, as
        # float8 products are run.
        scale = t.abs().amax().clamp(min=1e-30) / torch.finfo(
            prec.train).max
        return (t / scale).to(prec.train).to(torch.float32) * scale

    def forward(xs, w_ih, w_ho):
        h = xs @ q(w_ih)
        return h, q(h) @ q(w_ho)

    out = TrainTrace([], [], w0_ih.numpy(), {}, updates)
    if 0 in keep:
        out.snapshots[0] = w0_ih.numpy()
    before, prev_val = params[0], -1.0
    for step in range(updates):
        h, o = forward(x_tr, *params)
        loss = torch.mean(-y_tr * torch.nn.functional.logsigmoid(o)
                          - (1 - y_tr) * torch.nn.functional.logsigmoid(-o))
        out.losses.append(float(loss))
        d_o = (torch.sigmoid(o) - y_tr) / x_tr.shape[0]
        # The hidden gradient and W_ho's are rounded where the products'
        # operands are: autograd through a rounded operand rounds its
        # gradient the same way.
        d_h = q(d_o @ q(params[1]).T)
        grads = [x_tr.T @ d_h, q(q(h).T @ d_o)]
        count = step + 1
        if step < clear_after:
            # The gradient's rounding in a run of clear_dtype products: each
            # row's logit carries the rounding of W_ih, of the hidden row
            # and of W_ho (root-sum-square over its terms), which moves the
            # row's d_o by sigmoid' times it; the backward's operand d_o *
            # W_ho is rounded once more. Summed over a gene's rows.
            unit = torch.finfo(clear_dtype).eps / 2
            who2 = params[1] * params[1]
            logit_err = unit * torch.sqrt(
                x_tr @ ((params[0] * params[0]) @ who2) + 2 * (h * h) @ who2)
            sig = torch.sigmoid(o)
            d_err = sig * (1 - sig) * logit_err / x_tr.shape[0]
            noise = torch.sqrt(x_tr.T @ (d_err * d_err
                                         + (unit * d_o) ** 2)) \
                * params[1].abs().T
            now = grads[0].abs() > CLEAR_ROUNDOFFS * noise
            sign = torch.sign(grads[0])
            if step == 0:
                clear, first = now, sign
            else:
                clear &= now & (sign == first)
            if count == clear_after:
                out.clear = clear.cpu().numpy()
                out.direction = (-first).to(torch.int8).cpu().numpy()
                out.clear_after = clear_after
        bc1 = 1.0 - _ADAM_B1 ** count
        bc2 = 1.0 - _ADAM_B2 ** count
        for i, g in enumerate(grads):
            mu[i] = (1 - _ADAM_B1) * g + _ADAM_B1 * mu[i]
            nu[i] = (1 - _ADAM_B2) * (g * g) + _ADAM_B2 * nu[i]
            params[i] = params[i] - lr * ((mu[i] / bc1)
                                          / (torch.sqrt(nu[i] / bc2)
                                             + _ADAM_EPS))
        _, o_all = forward(x, *params)
        right = ((o_all > thr).float() == y).float()
        out.acc_val.append(float(right[vl_t].mean()))
        if count in keep:
            out.snapshots[count] = params[0].cpu().numpy()
        if stop_at_dip and out.acc_val[-1] < prev_val:
            out.stop_updates = step
            out.snapshots[step] = before.cpu().numpy()
            return out
        prev_val, before = out.acc_val[-1], params[0]
    if stop_at_dip:
        out.snapshots[updates] = params[0].cpu().numpy()
    return out


# ----------------------------------------------------------------- stage 5

def sq_dists(w: np.ndarray, c: np.ndarray, dtype=None) -> np.ndarray:
    """[G, k] squared distances in float64 (operands rounded to
    ``dtype``)."""
    w, c = _round(w, dtype), _round(c, dtype)
    d2 = ((w * w).sum(axis=1)[:, None] - 2.0 * (w @ c.T)
          + (c * c).sum(axis=1)[None, :])
    return np.maximum(d2, 0.0)


def kmeans(w: np.ndarray, k: int, iters: int, seed: int, n_init: int = 10,
           dtype=None, device="cpu") -> Tuple[np.ndarray, np.ndarray, float]:
    """The k-means the configuration runs, in float64 on ``device`` with
    its operands rounded to ``dtype``: ``n_init`` k-means++ restarts drawn
    from one CPU ``torch.Generator`` seeded with ``seed`` (each restart: a
    first centre by ``randint`` over the genes, then each next one by a
    Gumbel-max draw, one exponential variate a gene, over the log of its
    squared distance to the nearest centre so far, genes at distance 0
    left out); ``iters`` Lloyd steps in every restart, an empty cluster
    keeping its centre, ties to the lower index; the restart of least
    inertia, the first on a tie. Returns (labels [G], centres [k, d],
    inertia)."""
    gen = torch.Generator().manual_seed(int(seed))
    x = torch.from_numpy(_round(np.asarray(w, np.float64), dtype)).to(device)
    n = x.shape[0]

    def rounded(t):
        return t if dtype is None else t.to(dtype).to(torch.float64)

    def dists(c):                                   # [..., n, k]
        return torch.clamp((x * x).sum(1)[:, None]
                           - 2.0 * x @ c.transpose(-1, -2)
                           + (c * c).sum(-1).unsqueeze(-2), min=0.0)

    starts = []
    for _ in range(n_init):
        picked = [int(torch.randint(n, (1,), generator=gen))]
        near = ((x - x[picked[0]]) ** 2).sum(1)
        for _ in range(1, k):
            draw = torch.empty(n, dtype=torch.float32).exponential_(
                generator=gen).to(device, torch.float64)
            pos = near > 0
            score = torch.where(pos, torch.log(torch.where(pos, near, 1.0))
                                - torch.log(draw), -torch.inf)
            picked.append(int(torch.argmax(score)) if bool(pos.any())
                          else 0)
            near = torch.minimum(near, ((x - x[picked[-1]]) ** 2).sum(1))
        starts.append(x[picked])
    c = torch.stack(starts)                         # [n_init, k, d]
    for _ in range(iters):
        onehot = torch.nn.functional.one_hot(
            torch.argmin(dists(c), dim=-1), k).to(torch.float64)
        counts = onehot.sum(1)[..., None]
        c = rounded(torch.where(counts > 0, (onehot.transpose(1, 2) @ x)
                                / counts.clamp(min=1.0), c))
    inertia = dists(c).amin(-1).sum(-1)
    best = int(torch.argmin(inertia))
    return (torch.argmin(dists(c[best]), dim=1).cpu().numpy(),
            c[best].cpu().numpy(), float(inertia[best]))


def name_clusters(clusters: np.ndarray, votes: np.ndarray, k: int
                  ) -> np.ndarray:
    """Cluster id -> L-group (0 good, 1 poor, 2 other): the largest
    cluster (lowest id on a tie) is other; of the rest, the one with the
    most good-minus-poor votes (higher id on a tie) is good, the lowest
    such count (lower id on a tie) poor."""
    counts = np.bincount(clusters, minlength=k)
    largest = int(np.argmax(counts))
    rest = [i for i in range(k) if i != largest]
    diff = {i: int(((clusters == i) & (votes == 0)).sum())
            - int(((clusters == i) & (votes == 1)).sum()) for i in rest}
    good = max(rest, key=lambda i: (diff[i], i))
    poor = min((i for i in rest if i != good), key=lambda i: (diff[i], -i))
    names = np.full(k, 2, np.int32)
    names[good], names[poor] = 0, 1
    return names


# ----------------------------------------------------------------- stage 6

def tscores(expr: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """|pooled-variance two-sample t| per gene, 0 where undefined."""
    a, b = expr[labels == 0], expr[labels == 1]
    n0, n1 = a.shape[0], b.shape[0]
    pooled = ((n0 - 1) * a.var(axis=0, ddof=1)
              + (n1 - 1) * b.var(axis=0, ddof=1)) / (n0 + n1 - 2)
    d1 = np.sqrt(pooled)
    d2 = np.sqrt(1.0 / n0 + 1.0 / n1)
    t = np.where(d1 > 0, (a.mean(axis=0) - b.mean(axis=0))
                 / np.where(d1 > 0, d1, 1.0) / d2, 0.0)
    return np.abs(t)


def _minmax(x: np.ndarray, mask: np.ndarray) -> np.ndarray:
    if not mask.any():
        return np.zeros_like(x)
    lo, hi = x[mask].min(), x[mask].max()
    return (x - lo) / (hi - lo) if hi > lo else np.zeros_like(x)


def scores(w: np.ndarray, expr: np.ndarray, labels: np.ndarray,
           lgroups: np.ndarray, mix: float, dtype=None) -> np.ndarray:
    """[2, G] gene scores; row g is meaningful on L-group g's genes."""
    w = _round(np.asarray(w, np.float64), dtype)
    d = np.sqrt((w * w).sum(axis=1))
    t = tscores(expr, labels)
    out = np.stack([mix * _minmax(d, lgroups == g)
                    + (1 - mix) * _minmax(t, lgroups == g) for g in (0, 1)])
    return _round(out, dtype)


def top_biomarkers(s: np.ndarray, lgroups: np.ndarray, genes: np.ndarray,
                   n: int) -> List[str]:
    """Each group's top ``n`` genes by score (stable: gene order on ties),
    all sorted by name."""
    picked: List[str] = []
    for g in (0, 1):
        idx = np.flatnonzero(lgroups == g)
        order = idx[np.argsort(-s[g][idx], kind="stable")]
        picked += genes[order[:n]].tolist()
    return sorted(picked)


# ------------------------------------------------------------ a whole run

@dataclasses.dataclass
class RunOutput:
    """What one solo run (or one lane) produced, in the form the judge
    reads: the program's results are brought into it the same way."""

    genes: np.ndarray
    n_samples: int
    n_edges: int
    rows: np.ndarray
    labels: np.ndarray
    losses: List[float]
    acc_val: List[float]
    stop_epoch: int
    w_ih: np.ndarray
    lgroups: np.ndarray
    centres: np.ndarray
    scores: np.ndarray
    biomarkers: List[str]
    files: Dict[str, bytes]


def run_reference(graph: Graph, run: Dict, walk_seed: int, train_seed: int,
                  kmeans_seed: int, device, prec: Precision = PLAIN,
                  stage3_out=None) -> RunOutput:
    """A whole solo run by the reference (``stage3_out`` reuses rows that
    lanes share)."""
    from reference import text

    rows, labels, _ = (stage3_out if stage3_out is not None
                       else stage3(graph, run, walk_seed, prec))
    g = graph.genes.size
    t = train(rows, labels, g, run, train_seed, device, run["epoch"],
              stop_at_dip=True, prec=prec)
    w = t.snapshots[t.stop_updates]
    votes = gene_votes(rows, labels, g)
    clusters, centres, _ = kmeans(w, run["n_lgroups"], run["kmeans_iters"],
                                  kmeans_seed, dtype=prec.kmeans,
                                  device=device)
    lgroups = name_clusters(clusters, votes, run["n_lgroups"])[clusters]
    s = scores(w, graph.expr, graph.labels, lgroups, run["score_mix"],
               prec.scores)
    bm = top_biomarkers(s, lgroups, graph.genes, run["numBiomarker"])
    return RunOutput(
        genes=graph.genes, n_samples=graph.labels.size,
        n_edges=graph.src.size, rows=rows, labels=labels,
        losses=t.losses, acc_val=t.acc_val,
        stop_epoch=t.stop_updates - 1, w_ih=w.astype(np.float32),
        lgroups=lgroups, centres=centres.astype(np.float32), scores=s,
        biomarkers=bm,
        files={"biomarkers": text.biomarkers_text(bm),
               "lgroups": text.lgroups_text(graph.genes, lgroups),
               "vectors": text.vectors_text(graph.genes,
                                            w.astype(np.float32))})
