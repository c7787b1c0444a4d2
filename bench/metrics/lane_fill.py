"""lane_fill: valid token lanes over the lanes the packed steps ran
(serve/paged.py schedule_step_tokens and the width ladder), in percent:
the engine's padding counters, differenced over the traced run's window
outside the profiled stretch."""


def read(ctx):
    h = ctx.host
    if not h["lanes_total"]:
        return None
    return 100.0 * h["lanes_valid"] / h["lanes_total"]
