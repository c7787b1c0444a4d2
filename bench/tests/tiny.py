"""Small sizes at which the benchmark's cells run on the CPU in a test:
every width, depth, vocabulary, engine setting and prompt length cut down,
the architecture, the port's settings and the mix's kind kept. The served
dtype is float32 unless a test asks for another: at these sizes a bf16
MoE's router flips an expert choice at a few positions in twenty (logit
errors up to 0.66 against 0.02 for the dense model), which would say
nothing about the harness."""
from bench import spec

SIZES = dict(num_hidden_layers=2, hidden_size=128, intermediate_size=96,
             num_attention_heads=4, num_key_value_heads=2, vocab_size=300)
ENGINE = dict(max_batch=4, token_budget=64, max_len=256, block_size=8,
              num_blocks=4 * 12 + 2)
MIX = dict(prompt_tokens=dict(dist="log_uniform", low=16, high=48),
           new_tokens=dict(dist="uniform", low=4, high=8), check_requests=3)


def sizes(bench: spec.Bench, cell: str, dtype: str = "float32") -> dict:
    """The `sizes` argument of harness.run for `cell` at the small size,
    served in `dtype`."""
    conf = bench.config(bench.cell(cell)["config"])
    c = dict(SIZES, port=dict(conf["port"], padded_vocab=2048, dtype=dtype))
    if conf.get("num_local_experts"):
        c.update(num_local_experts=4, num_experts_per_tok=2)
    return dict(config=c, engine=dict(ENGINE), mix=dict(MIX))


def config(bench: spec.Bench, cell: str, dtype: str = "float32") -> dict:
    """The small configuration file of `cell`."""
    conf = bench.config(bench.cell(cell)["config"])
    return dict(conf, **sizes(bench, cell, dtype)["config"])
