"""dispatch_ms: host milliseconds a packed step spends in the engine's
device seam (`_packed_fn`, models/model.py forward as the engine calls it),
no fence: enqueueing the forward. Steps of the traced run's window outside
the profiled stretch."""


def read(ctx):
    h = ctx.host
    return h["dispatch_s"] / h["steps"] * 1e3 if h["steps"] else None
