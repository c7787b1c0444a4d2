"""Small sizes at which the benchmark's cells run on the CPU in a test:
every width, depth and vocabulary cut down by the configuration's model
module (`tiny_sizes`), and the engine settings and prompt lengths here;
the architecture, the port's settings and the mix's kind kept. The served
dtype is float32 unless a test asks for another: at these sizes a bf16
MoE's router flips an expert choice at a few positions in twenty (logit
errors up to 0.66 against 0.02 for the dense model), which would say
nothing about the harness."""
from bench import spec

ENGINE = dict(max_batch=4, token_budget=64, max_len=256, block_size=8,
              num_blocks=4 * 12 + 2)
MIX = dict(prompt_tokens=dict(dist="log_uniform", low=16, high=48),
           new_tokens=dict(dist="uniform", low=4, high=8), check_requests=3)


def sizes(bench: spec.Bench, cell: str, dtype: str = "float32") -> dict:
    """The `sizes` argument of harness.run for `cell` at the small size,
    served in `dtype`."""
    conf = bench.config(bench.cell(cell)["config"])
    return dict(config=bench.model(conf).tiny_sizes(conf, dtype),
                engine=dict(ENGINE), mix=dict(MIX))


def config(bench: spec.Bench, cell: str, dtype: str = "float32") -> dict:
    """The small configuration file of `cell`."""
    conf = bench.config(bench.cell(cell)["config"])
    return dict(conf, **sizes(bench, cell, dtype)["config"])
