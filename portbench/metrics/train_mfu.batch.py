"""The training stage's share of the card's dense bf16 peak, %: the
model's dense operations (``roofline.dense_flops`` over every launch of
the window's untraced batches (every lane)) over their stage-train seconds times 989e12
(``roofline.BF16_TC_OPS_PER_S``, at a 700 W power limit)."""
from roofline import BF16_TC_OPS_PER_S, dense_flops


def read(ctx):
    if ctx.kind != "batch" or not ctx.jobs:
        return None
    flops = sum((n_upd + 1) * dense_flops(m_all, g, h, False)
                + n_upd * dense_flops(m_tr, g, h, True)
                for r in ctx.jobs for g, h, m_all, m_tr, n_upd in r.shapes)
    seconds = sum(r.stage_seconds["train"] for r in ctx.jobs)
    return 100.0 * flops / (seconds * BF16_TC_OPS_PER_S)
