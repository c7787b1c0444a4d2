"""The assigned input-shape set (identical for every LM arch); the port of
`repro/configs/shapes.py`."""
from repro_torch.configs.base import ShapeConfig

SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", seq_len=4096, global_batch=256,
                            kind="train"),
    "prefill_32k": ShapeConfig("prefill_32k", seq_len=32768, global_batch=32,
                               kind="prefill"),
    "decode_32k": ShapeConfig("decode_32k", seq_len=32768, global_batch=128,
                              kind="decode"),
    "long_500k": ShapeConfig("long_500k", seq_len=524288, global_batch=1,
                             kind="decode"),
}

# long_500k needs sub-quadratic attention: run for SSM/hybrid archs only;
# pure full-attention archs skip it.
LONG_CONTEXT_FAMILIES = ("ssm", "hybrid")


def shape_applicable(cfg, shape: ShapeConfig) -> bool:
    if shape.name == "long_500k":
        return cfg.family in LONG_CONTEXT_FAMILIES
    return True
