"""idle_share: the share of the profiled stretch's wall time in which no
operation ran on the device, in percent (torch.profiler's device events,
busy time the union of their intervals)."""


def read(ctx):
    p = ctx.profile
    if p is None or not p.window_s or not p.kernels:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
