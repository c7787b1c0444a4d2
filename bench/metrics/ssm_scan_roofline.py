"""ssm_scan_roofline: the Mamba-2 scans' share of their roofline, in
percent, over the profiled stretch: the least time the chip could take for
every scan of the stretch (the larger of its operations at the chip's top
dense rate and its bytes at the HBM rate, bench/counts.py bound_seconds;
each step's scan counted from its schedule by the model module's
`scan_call`, as many a step as its `mamba_layers`), over the device time
of the kernels launched inside the program's `repro.ssm.scan` ranges (the
conv, the SSD and the state's read and write: models/ssm.py apply_mamba).
Nothing where the stretch ran no scan or has no device trace (the CPU)."""

from bench import counts, program_trace


def read(ctx):
    if ctx.profile is None or not ctx.stretch_steps:
        return None
    prog = program_trace.of(ctx)
    spent = prog.launched_s("repro.ssm.scan") if prog is not None else 0.0
    if not spent:
        return None
    bound = sum(counts.bound_seconds(*ctx.model.scan_call(slots, ctx.cfg))
                for slots in ctx.stretch_steps)
    return 100.0 * bound * ctx.model.mamba_layers(ctx.cfg) / spent
