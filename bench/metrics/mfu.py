"""mfu: the whole packed step's model FLOPs over the chip's bf16 dense peak
(989 TFLOP/s, the configurations' dtype), in percent, over the profiled
stretch: as the configuration's model module counts them from the tokens
processed, each token's live keys and the rows sampled (for the decoder,
2 x active non-embedding parameters per token, HCCS attention's QK and PV
over each token's live keys in every layer, and the LM head on the rows
sampled: bench/models/decoder.py model_flops)."""

from bench import counts


def read(ctx):
    p = ctx.profile
    if p is None or not p.window_s or not ctx.stretch_steps:
        return None
    tokens = sum(n for slots in ctx.stretch_steps for _, n in slots)
    keys = sum(counts.packed_keys(slots) for slots in ctx.stretch_steps)
    flops = ctx.model.model_flops(ctx.cfg, tokens, keys,
                                  ctx.stretch_sampled)
    return 100.0 * flops / (p.window_s * counts.PEAK_BF16)
