"""Graphs for the walker tests, made from a seed with numpy (no JAX, so the
card tests can use them too)."""
import numpy as np

#: The hubs' out-degrees: one slot, the edges of the walker's lane groups
#: (8 and 16 lanes) and one past each, a warp's 32 lanes and one past, and
#: rows many chunks wide.
HUB_DEGREES = (1, 7, 8, 9, 15, 16, 17, 31, 32, 33, 257, 1000)


def hub_graph(n_genes, degrees, seed):
    """Edges ``(src, dst, w)``: gene ``i < len(degrees)`` is a hub of
    out-degree ``degrees[i]`` (a tenth of its slots repeat an earlier
    target: duplicate edges); every other gene has 0 to 3 out-edges (0: a
    dead end), a third of them into the hubs, so walks pass through them.
    A tenth of all weights are 0 and a twentieth negative (never
    eligible); the others span six decades."""
    rng = np.random.default_rng(seed)
    n_hubs = len(degrees)
    src, dst = [], []
    for h, d in enumerate(degrees):
        t = rng.integers(0, n_genes, d)
        t[1::10] = t[0::10][:len(t[1::10])]
        src.append(np.full(d, h))
        dst.append(t)
    deg = rng.choice(4, n_genes - n_hubs, p=(0.2, 0.3, 0.3, 0.2))
    s = np.repeat(np.arange(n_hubs, n_genes), deg)
    t = rng.integers(0, n_genes, s.size)
    to_hub = rng.random(s.size) < 1 / 3
    t[to_hub] = rng.integers(0, n_hubs, int(to_hub.sum()))
    src = np.concatenate(src + [s]).astype(np.int32)
    dst = np.concatenate(dst + [t]).astype(np.int32)
    w = (rng.random(src.size, dtype=np.float32)
         * (10.0 ** rng.integers(-3, 3, src.size)).astype(np.float32))
    w[rng.random(src.size) < 0.1] = 0.0
    w[rng.random(src.size) < 0.05] *= -1.0
    return src, dst, w
