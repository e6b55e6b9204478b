"""The packed forward's share of its roofline in the traced solo runs, %:
the bounds of its launches (``roofline.fwd_work``: the fused [train |
val] rows each update and once more at the stop) over the device time
of ``pm_fwd_kernel`` by name in the trace."""


def read(ctx):
    if ctx.kind != "solo" or not ctx.traced:
        return None
    seconds = sum(ctx.trace["kernels"].get(k, [0.0, 0])[0]
                  for k in ('pm_fwd_kernel',))
    if seconds <= 0:
        return None
    return 100.0 * sum(t["fwd_bound_s"] for t in ctx.traced) / seconds
