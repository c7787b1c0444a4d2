"""The benchmark's decoders: dense or MoE transformers whose every layer is
HCCS attention and an MLP or sparse experts, as bench/reference/decoder.py
computes them. A configuration file with "model": "decoder" runs through
this module, which holds all that the harness knows of the model:

    reference_config(conf)     the reference's view of the file
    port_config(conf)          the program's ModelConfig
    make_weights, make_hccs    the inputs that stand in for a checkpoint
    logits_at                  the plain reference's logits
    tiny_sizes(conf, dtype)    the sizes of the CPU tests
    active_params_per_token, model_flops, attention_layers,
    attention_shape            the work counts the per-layer readers take

A file that states structure the decoder does not compute is refused: it
would otherwise run silently as a plain decoder."""
from __future__ import annotations

import torch

from bench.reference import decoder as reference

# keys of a file that state structure, and the values the decoder computes
# (a key the file leaves out is not refused)
COMPUTES = {
    "layer_types": lambda v: not v,                 # every layer alike
    "sliding_window": lambda v: not v,              # full causal attention
    "shared_intermediate_size": lambda v: not v,    # no shared expert
    "tie_word_embeddings": lambda v: v is True,     # the head is the table
    "attention_bias": lambda v: v is False,
    "mlp_bias": lambda v: v is False,
    "hidden_act": lambda v: v == "silu",
    "position_embedding_type": lambda v: v == "rope",
}

# the reference's sizes that the program's ModelConfig takes by the same name
PORT_SIZES = ("num_layers", "d_model", "num_heads", "num_kv_heads",
              "head_dim", "d_ff", "vocab_size", "rope_theta", "num_experts",
              "experts_per_token")

# the CPU tests' sizes: every width, depth and the vocabulary cut down
TINY = dict(num_hidden_layers=2, hidden_size=128, intermediate_size=96,
            num_attention_heads=4, num_key_value_heads=2, vocab_size=300)

# HCCS constants are drawn inside the integer datapath's feasible region
# for the calibration row length n (paper eq. 11): D <= 127,
# B - S*D >= ceil(256 / n), n*B <= 32767, B > 0, S >= 0
N_REF = 128


def refuse_unsupported(conf: dict):
    """Raise, naming each key, where `conf` states structure the decoder
    does not compute."""
    bad = [f"{k}={conf[k]!r}" for k, ok in COMPUTES.items()
           if k in conf and not ok(conf[k])]
    if bad:
        raise ValueError(f"configuration {conf.get('name')!r} states what "
                         f"the decoder model does not compute: "
                         f"{', '.join(bad)}")


def reference_config(conf: dict) -> dict:
    """The reference's view of a configuration file: the published sizes
    under their published names, and the port's settings it serves with.
    head_dim is the file's where it states one, else hidden / heads."""
    refuse_unsupported(conf)
    port = conf["port"]
    return dict(
        num_layers=conf["num_hidden_layers"], d_model=conf["hidden_size"],
        num_heads=conf["num_attention_heads"],
        num_kv_heads=conf["num_key_value_heads"],
        head_dim=(conf.get("head_dim")
                  or conf["hidden_size"] // conf["num_attention_heads"]),
        d_ff=conf["intermediate_size"], vocab_size=conf["vocab_size"],
        padded_vocab=port["padded_vocab"], rope_theta=conf["rope_theta"],
        num_experts=conf.get("num_local_experts", 0),
        experts_per_token=conf.get("num_experts_per_tok", 0),
        dtype=port["dtype"], hccs_mode=port["hccs_mode"], hccs=conf["hccs"])


def port_config(conf: dict):
    """The program's ModelConfig of a configuration file: the registry's
    architecture with the file's sizes and the port's settings."""
    from repro_torch.configs.registry import get_config
    ref = reference_config(conf)
    port = {k: v for k, v in conf["port"].items() if k != "padded_vocab"}
    cfg = get_config(conf["arch"]).replace(
        **{k: ref[k] for k in PORT_SIZES}, **port)
    if cfg.padded_vocab != conf["port"]["padded_vocab"]:
        raise ValueError(f"padded vocab {cfg.padded_vocab} != "
                         f"{conf['port']['padded_vocab']}")
    return cfg


def tiny_sizes(conf: dict, dtype: str = "float32") -> dict:
    """The entries of `conf` that the CPU tests replace, served in `dtype`:
    TINY, 4 experts of which 2 a token where the file has experts, and a
    stated head_dim kept apart from hidden / heads (32 against 16)."""
    c = dict(TINY, port=dict(conf["port"], padded_vocab=2048, dtype=dtype))
    if conf.get("num_local_experts"):
        c.update(num_local_experts=4, num_experts_per_tok=2)
    if conf.get("head_dim"):
        c.update(num_attention_heads=8, head_dim=32)
    return c


def _randn(gen, shape, dtype, std, device):
    return torch.randn(shape, generator=gen, dtype=dtype, device=device) * std


def make_weights(cfg: dict, seed: int, device) -> dict:
    """Weights of the configuration `cfg` (reference_config's dict) from
    `seed`, in the program's parameter layout: normal matrices with std
    fan_in**-0.5 in the served dtype, a float32 router, unit norm scales;
    one generator call per stacked leaf, on `device`."""
    dt = getattr(torch, cfg["dtype"])
    gen = torch.Generator(device=device).manual_seed(int(seed))
    L, d, f = cfg["num_layers"], cfg["d_model"], cfg["d_ff"]
    h, hkv, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]

    def rand(shape, std, dtype=dt):
        return _randn(gen, shape, dtype, std, device)

    layers = {
        "norm1": {"scale": torch.ones((L, d), dtype=dt, device=device)},
        "norm2": {"scale": torch.ones((L, d), dtype=dt, device=device)},
        "attn": {"wq": rand((L, d, h * hd), d ** -0.5),
                 "wk": rand((L, d, hkv * hd), d ** -0.5),
                 "wv": rand((L, d, hkv * hd), d ** -0.5),
                 "wo": rand((L, h * hd, d), (h * hd) ** -0.5)},
    }
    if cfg["num_experts"]:
        e = cfg["num_experts"]
        layers["moe"] = {
            "router": rand((L, d, e), d ** -0.5, torch.float32),
            "experts": {"w_in": rand((L, e, d, f), d ** -0.5),
                        "w_gate": rand((L, e, d, f), d ** -0.5),
                        "w_out": rand((L, e, f, d), f ** -0.5)}}
    else:
        layers["mlp"] = {"w_in": rand((L, d, f), d ** -0.5),
                         "w_gate": rand((L, d, f), d ** -0.5),
                         "w_out": rand((L, f, d), f ** -0.5)}
    return {"embed": {"table": rand((cfg["padded_vocab"], d), d ** -0.5)},
            "layers": layers,
            "final_norm": {"scale": torch.ones((d,), dtype=dt,
                                               device=device)}}


def make_hccs(cfg: dict, seed: int, device) -> dict:
    """Per-(layer, head) HCCS constants from `seed`, as offline calibration
    leaves them: theta = (B, S, D) int32 in the feasible region at N_REF,
    and a float32 int8 logit scale log-uniform over `hccs.scale`. Returns
    the program's layout, {"B", "S", "D": (L, H) int32, "scale": (L, H)}."""
    L, h = cfg["num_layers"], cfg["num_heads"]
    spec = cfg["hccs"]
    gen = torch.Generator(device="cpu").manual_seed(int(seed) ^ 0x5EED)
    floor = -(-256 // N_REF)
    b_max = 32767 // N_REF
    d_vals = torch.tensor(spec["D"], dtype=torch.int64)
    D = d_vals[torch.randint(len(spec["D"]), (L, h), generator=gen)]
    s_max = (b_max - floor) // D
    S = 1 + (torch.rand((L, h), generator=gen) * s_max).long().clamp(
        max=s_max - 1)
    b_lo = S * D + floor
    B = b_lo + (torch.rand((L, h), generator=gen)
                * (b_max - b_lo + 1)).long().clamp(max=b_max - b_lo)
    lo, hi = (torch.log(torch.tensor(float(v))) for v in spec["scale"])
    scale = torch.exp(lo + (hi - lo) * torch.rand((L, h), generator=gen))
    out = {"B": B, "S": S, "D": D}
    out = {k: v.to(torch.int32).to(device) for k, v in out.items()}
    out["scale"] = scale.to(torch.float32).to(device)
    return out


def logits_at(weights, hccs, seqs, rows, cfg, cast=None):
    """The plain reference's logits at `rows` of each of `seqs`, in float32
    with TF32 off; `cast` is the precision control's hook (see
    bench/reference/decoder.py logits_at)."""
    with reference.full_float32():
        return reference.logits_at(weights, hccs, seqs, rows, cfg, cast)


def attention_layers(cfg: dict) -> int:
    """Packed-attention calls a step makes: one a layer."""
    return cfg["num_layers"]


def attention_shape(cfg: dict) -> tuple[int, int, int]:
    """(heads, kv_heads, head_dim) of each packed-attention call."""
    return cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]


def active_params_per_token(cfg: dict) -> int:
    """Active non-embedding parameters a token passes through: the
    attention projections, and the MLP or the router and its top-k
    experts (not the capacity padding)."""
    d, f = cfg["d_model"], cfg["d_ff"]
    hd = cfg["head_dim"]
    attn = d * cfg["num_heads"] * hd * 2 + d * cfg["num_kv_heads"] * hd * 2
    if cfg["num_experts"]:
        mlp = d * cfg["num_experts"] + cfg["experts_per_token"] * 3 * d * f
    else:
        mlp = 3 * d * f
    return cfg["num_layers"] * (attn + mlp)


def model_flops(cfg: dict, tokens: int, keys: int, sampled_rows: int) -> float:
    """Model FLOPs of a stretch of steps: 2 x active parameters per token
    processed, HCCS attention's QK and PV over every token's live keys in
    every layer, and the LM head over the published vocabulary on each row
    that was sampled."""
    attn = 4.0 * cfg["num_heads"] * cfg["head_dim"] * keys * cfg["num_layers"]
    head = 2.0 * cfg["d_model"] * cfg["vocab_size"] * sampled_rows
    return 2.0 * active_params_per_token(cfg) * tokens + attn + head
