"""packed_attn_roofline: the packed attention kernel's share of its
roofline, in percent, over the profiled stretch: the least time the chip
could take for every hccs_packed_prefill call of the stretch (the larger
of its operations at the chip's top dense rate and its bytes at the HBM
rate, bench/counts.py), over the device time of the kernel's launches
(kernels/csrc/hccs_packed.cu, every pass: `PackedRows` in the name).
Calls are counted from each step's schedule, as many a step as the
model module's `attention_layers`, each of its `attention_shape`."""

from bench import counts

KERNEL = "PackedRows"


def read(ctx):
    p = ctx.profile
    if p is None:
        return None
    spent = p.kernel_s(KERNEL)
    if not spent or not ctx.stretch_steps:
        return None
    shape = ctx.model.attention_shape(ctx.cfg)
    bound = 0.0
    for slots in ctx.stretch_steps:
        ops, nbytes = counts.packed_call(slots, *shape, ctx.pool_bytes)
        bound += counts.bound_seconds(ops, nbytes)
    return 100.0 * bound * ctx.model.attention_layers(ctx.cfg) / spent
