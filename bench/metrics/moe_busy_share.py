"""moe_busy_share: device time launched inside models/moe.py apply_moe
(route, dispatch gather, the experts' products, combine) over device busy
time, in percent, over the profiled stretch. Nothing where the stretch ran
no MoE layer."""


def read(ctx):
    p = ctx.profile
    if p is None or not p.busy_s:
        return None
    inside = p.inside_s("moe")
    return None if inside is None else 100.0 * inside / p.busy_s
