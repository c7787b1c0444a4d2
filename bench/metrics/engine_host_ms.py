"""engine_host_ms: host milliseconds a packed step spends in the engine's
own phases other than the device call (serve/paged.py admit, schedule,
alloc_cow, sample, register, rollback), per packed step, less the time
inside sample_tokens, which holds the step's wait for the card. Timed with
no fence (bench/tracing.py PhaseClock). Steps of the traced run's window
outside the profiled stretch."""


def read(ctx):
    h = ctx.host
    if not h["steps"]:
        return None
    host = sum(v for k, v in h["phase_s"].items() if k != "device")
    return (host - h["wait_s"]) / h["steps"] * 1e3
