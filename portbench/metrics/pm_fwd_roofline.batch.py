"""The lane forward's share of its roofline in the traced batch, %: each
launch's bound over the lanes still training in it, over the device
time of ``pm_fwd_lanes_kernel`` by name in the trace."""


def read(ctx):
    if ctx.kind != "batch" or not ctx.traced:
        return None
    seconds = sum(ctx.trace["kernels"].get(k, [0.0, 0])[0]
                  for k in ('pm_fwd_lanes_kernel',))
    if seconds <= 0:
        return None
    return 100.0 * sum(t["fwd_bound_s"] for t in ctx.traced) / seconds
