"""granite-4.0-h-micro [hf:ibm-granite/granite-4.0-h-micro]: 40 layers, 36
Mamba-2 mixers and 4 NoPE GQA attention mixers (at 5, 15, 25, 35), each
followed by a SwiGLU MLP.

A port-only configuration (the JAX package has no per-layer pattern):
`InterleavedConfig` adds the pattern and the conv width to ModelConfig's
fields, which stay those of the JAX package. Its family, "interleaved",
stacks each kind's leaves apart (models/blocks.py) and is served by the
packed PagedEngine alone, with per-slot Mamba state beside the block pool.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig

MIXERS = ("mamba", "attention")


@dataclasses.dataclass(frozen=True)
class InterleavedConfig(ModelConfig):
    """A model whose layers differ by mixer: layer i mixes with Mamba-2
    (`layer_types[i] == "mamba"`: in-projection, a depthwise causal conv of
    `ssm_conv` taps with bias, the SSD, the gated norm, out-projection) or
    attention, and every layer has its MLP after the mixer."""
    layer_types: tuple[str, ...] = ()
    ssm_conv: int = 4

    def __post_init__(self):
        super().__post_init__()
        if self.family != "interleaved":
            raise ValueError(f"InterleavedConfig is family 'interleaved', "
                             f"got {self.family!r}")
        if len(self.layer_types) != self.num_layers:
            raise ValueError(f"layer_types names {len(self.layer_types)} "
                             f"layers, num_layers is {self.num_layers}")
        bad = sorted(set(self.layer_types) - set(MIXERS))
        if bad:
            raise ValueError(f"layer_types: unknown mixers {bad}; "
                             f"known: {MIXERS}")
        if self.ssm_conv != 4:
            raise ValueError(f"ssm_conv must be 4, the width the scan "
                             f"kernel takes, got {self.ssm_conv}")
        seen = {m: 0 for m in MIXERS}
        plan = []
        for kind in self.layer_types:
            plan.append((kind, seen[kind]))
            seen[kind] += 1
        # (mixer, index among that mixer's stacked leaves) of each layer
        object.__setattr__(self, "layer_plan", tuple(plan))

    def layers_of(self, kind: str) -> int:
        return self.layer_types.count(kind)


PATTERN = tuple("attention" if i in (5, 15, 25, 35) else "mamba"
                for i in range(40))

CONFIG = InterleavedConfig(
    name="granite-4.0-h-micro", family="interleaved", num_layers=40,
    d_model=2048, num_heads=32, num_kv_heads=8, d_ff=8192,
    vocab_size=100352, activation="swiglu", norm="rmsnorm", rope="none",
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_groups=1,
    ssm_chunk=256, attention_prob="hccs", dtype="bfloat16",
    layer_types=PATTERN, ssm_conv=4,
)
