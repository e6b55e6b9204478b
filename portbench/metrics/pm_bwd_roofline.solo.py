"""The packed backward's share of its roofline in the traced solo runs, %:
the bounds of its launches (``roofline.bwd_work``: the train rows, one
launch an update) over the device time of ``pm_bwd_kernel`` and
``pm_bwd_sum_kernel`` by name in the trace."""


def read(ctx):
    if ctx.kind != "solo" or not ctx.traced:
        return None
    seconds = sum(ctx.trace["kernels"].get(k, [0.0, 0])[0]
                  for k in ('pm_bwd_kernel', 'pm_bwd_sum_kernel'))
    if seconds <= 0:
        return None
    return 100.0 * sum(t["bwd_bound_s"] for t in ctx.traced) / seconds
