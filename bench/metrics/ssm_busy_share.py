"""ssm_busy_share: device time launched inside the program's `repro.ssm`
ranges (each Mamba-2 mixer of an interleaved model: in-projection, conv,
SSD, state read and write, gated norm, out-projection; models/blocks.py)
over device busy time, in percent, over the profiled stretch. Nothing where
the stretch ran no Mamba-2 layer or has no device trace (the CPU)."""

from bench import program_trace


def read(ctx):
    p = ctx.profile
    if p is None or not p.busy_s:
        return None
    prog = program_trace.of(ctx)
    inside = prog.launched_s("repro.ssm") if prog is not None else 0.0
    return 100.0 * inside / p.busy_s if inside else None
