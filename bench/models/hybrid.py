"""The benchmark's hybrid: a model whose layers mix with Mamba-2 or with
HCCS attention (no rotation), as the file's `layer_types` says, each mixer
followed by a SwiGLU MLP, as bench/reference/hybrid.py computes it. A
configuration file with "model": "hybrid" runs through this module, which
holds all that the harness knows of the model (bench/models/decoder.py
lists the seam's functions), and the work of its Mamba-2 scan:

    mamba_layers(cfg)          scans a step makes: one a Mamba-2 layer
    scan_call(slots, cfg)      (operations, bytes) of one layer's scan of
                               a step, from the step's schedule

A file that states structure the hybrid does not compute is refused,
naming the key."""
from __future__ import annotations

import math

import torch

from bench.models import decoder
from bench.reference import hybrid as reference

MIXERS = ("mamba", "attention")

# keys of a file that state structure, and the values the hybrid computes
COMPUTES = {
    "layer_types": lambda v: bool(v) and set(v) <= set(MIXERS),
    "position_embedding_type": lambda v: v == "nope",
    "num_local_experts": lambda v: not v,           # the MLP, no experts
    "sliding_window": lambda v: not v,
    "tie_word_embeddings": lambda v: v is True,
    "attention_bias": lambda v: v is False,
    "mlp_bias": lambda v: v is False,
    "hidden_act": lambda v: v == "silu",
    "normalization_function": lambda v: v == "rmsnorm",
    "mamba_proj_bias": lambda v: v is False,
    "mamba_conv_bias": lambda v: v is True,
}

# the CPU tests' sizes: one whole period of the published pattern (layers
# 0-9: attention at 5), every width cut down, a chunk of 8 tokens, shorter
# than the tests' prompts
TINY = dict(num_hidden_layers=10, hidden_size=128, intermediate_size=96,
            shared_intermediate_size=96, num_attention_heads=4,
            num_key_value_heads=2, vocab_size=300, mamba_d_state=16,
            mamba_d_head=32, mamba_n_heads=8, mamba_chunk_size=8)

# Mamba-2's own initialisation (the mamba_ssm reference): A uniform over
# [1, 16], dt log-uniform over [0.001, 0.1] (floor 1e-4) set through
# dt_bias = softplus^-1(dt), D = 1
A_RANGE = (1.0, 16.0)
DT_RANGE = (1e-3, 1e-1)
DT_FLOOR = 1e-4


def refuse_unsupported(conf: dict):
    """Raise, naming each key, where `conf` states structure the hybrid
    does not compute, or leaves out its layer pattern."""
    bad = [f"{k}={conf[k]!r}" for k, ok in COMPUTES.items()
           if k in conf and not ok(conf[k])]
    if "layer_types" not in conf:
        bad.append("layer_types missing")
    elif len(conf["layer_types"]) != conf["num_hidden_layers"]:
        bad.append(f"layer_types names {len(conf['layer_types'])} layers "
                   f"of num_hidden_layers={conf['num_hidden_layers']}")
    if bad:
        raise ValueError(f"configuration {conf.get('name')!r} states what "
                         f"the hybrid model does not compute: "
                         f"{', '.join(bad)}")


def reference_config(conf: dict) -> dict:
    """The reference's view of a configuration file: the published sizes,
    the layer pattern and the port's settings it serves with."""
    refuse_unsupported(conf)
    port = conf["port"]
    d, hp = conf["hidden_size"], conf["mamba_d_head"]
    di = conf["mamba_expand"] * d
    if di != conf["mamba_n_heads"] * hp:
        raise ValueError(f"mamba_n_heads x mamba_d_head = "
                         f"{conf['mamba_n_heads'] * hp} is not "
                         f"mamba_expand x hidden_size = {di}")
    return dict(
        num_layers=conf["num_hidden_layers"],
        layer_types=list(conf["layer_types"]), d_model=d,
        num_heads=conf["num_attention_heads"],
        num_kv_heads=conf["num_key_value_heads"],
        head_dim=(conf.get("head_dim")
                  or d // conf["num_attention_heads"]),
        d_ff=conf["shared_intermediate_size"],
        vocab_size=conf["vocab_size"], padded_vocab=port["padded_vocab"],
        d_inner=di, ssm_expand=conf["mamba_expand"],
        ssm_heads=conf["mamba_n_heads"], ssm_head_dim=hp,
        ssm_state=conf["mamba_d_state"], ssm_groups=conf["mamba_n_groups"],
        ssm_chunk=conf["mamba_chunk_size"], conv_kernel=conf["mamba_d_conv"],
        dtype=port["dtype"], hccs_mode=port["hccs_mode"], hccs=conf["hccs"])


def port_config(conf: dict):
    """The program's config of a configuration file: the registry's
    architecture (a port-only InterleavedConfig) with the file's sizes,
    pattern and the port's settings."""
    from repro_torch.configs.registry import get_config
    ref = reference_config(conf)
    port = {k: v for k, v in conf["port"].items() if k != "padded_vocab"}
    cfg = get_config(conf["arch"]).replace(
        num_layers=ref["num_layers"], layer_types=tuple(ref["layer_types"]),
        d_model=ref["d_model"], num_heads=ref["num_heads"],
        num_kv_heads=ref["num_kv_heads"], head_dim=ref["head_dim"],
        d_ff=ref["d_ff"], vocab_size=ref["vocab_size"],
        ssm_state=ref["ssm_state"], ssm_expand=ref["ssm_expand"],
        ssm_head_dim=ref["ssm_head_dim"], ssm_groups=ref["ssm_groups"],
        ssm_chunk=ref["ssm_chunk"], ssm_conv=ref["conv_kernel"], **port)
    if cfg.padded_vocab != conf["port"]["padded_vocab"]:
        raise ValueError(f"padded vocab {cfg.padded_vocab} != "
                         f"{conf['port']['padded_vocab']}")
    if cfg.ssm_heads != ref["ssm_heads"]:
        raise ValueError(f"the program's {cfg.ssm_heads} Mamba-2 heads != "
                         f"{ref['ssm_heads']}")
    return cfg


def tiny_sizes(conf: dict, dtype: str = "float32") -> dict:
    """The entries of `conf` that the CPU tests replace, served in `dtype`:
    TINY and the pattern's first period."""
    return dict(TINY, layer_types=list(conf["layer_types"][:10]),
                port=dict(conf["port"], padded_vocab=2048, dtype=dtype))


def layers_of(cfg: dict, kind: str) -> int:
    return cfg["layer_types"].count(kind)


def make_weights(cfg: dict, seed: int, device) -> dict:
    """Weights of the configuration `cfg` (reference_config's dict) from
    `seed`, in the program's parameter layout: normal matrices with std
    fan_in**-0.5 in the served dtype (the conv's taps and bias too, fan_in
    the conv width), unit norm scales, and Mamba-2's own A_log, dt_bias
    and D in float32; one generator call per stacked leaf, on `device`."""
    dt = getattr(torch, cfg["dtype"])
    gen = torch.Generator(device=device).manual_seed(int(seed))
    L, d, f = cfg["num_layers"], cfg["d_model"], cfg["d_ff"]
    la, lm = layers_of(cfg, "attention"), layers_of(cfg, "mamba")
    h, hkv, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    di, nh, k = cfg["d_inner"], cfg["ssm_heads"], cfg["conv_kernel"]
    gn = cfg["ssm_groups"] * cfg["ssm_state"]
    c = di + 2 * gn

    def rand(shape, std, dtype=dt):
        return decoder._randn(gen, shape, dtype, std, device)

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen,
                                           dtype=torch.float32, device=device)

    dt0 = torch.exp(uniform((lm, nh), math.log(DT_RANGE[0]),
                            math.log(DT_RANGE[1]))).clamp(min=DT_FLOOR)
    ones = (lambda shape: torch.ones(shape, dtype=dt, device=device))
    layers = {
        "norm1": {"scale": ones((L, d))},
        "norm2": {"scale": ones((L, d))},
        "mlp": {"w_in": rand((L, d, f), d ** -0.5),
                "w_gate": rand((L, d, f), d ** -0.5),
                "w_out": rand((L, f, d), f ** -0.5)},
        "attn": {"wq": rand((la, d, h * hd), d ** -0.5),
                 "wk": rand((la, d, hkv * hd), d ** -0.5),
                 "wv": rand((la, d, hkv * hd), d ** -0.5),
                 "wo": rand((la, h * hd, d), (h * hd) ** -0.5)},
        "ssm": {"in_proj": rand((lm, d, di + c + nh), d ** -0.5),
                "out_proj": rand((lm, di, d), di ** -0.5),
                "conv_w": rand((lm, c, k), k ** -0.5),
                "conv_b": rand((lm, c), k ** -0.5),
                "A_log": torch.log(uniform((lm, nh), *A_RANGE)),
                "dt_bias": dt0 + torch.log(-torch.expm1(-dt0)),
                "D": torch.ones((lm, nh), dtype=torch.float32,
                                device=device),
                "norm": ones((lm, di))},
    }
    return {"embed": {"table": rand((cfg["padded_vocab"], d), d ** -0.5)},
            "layers": layers, "final_norm": {"scale": ones((d,))}}


def make_hccs(cfg: dict, seed: int, device) -> dict:
    """The attention layers' HCCS constants from `seed`, as the decoder
    draws them (bench/models/decoder.py make_hccs): (La, H) leaves."""
    return decoder.make_hccs(
        dict(cfg, num_layers=layers_of(cfg, "attention")), seed, device)


def logits_at(weights, hccs, seqs, rows, cfg, cast=None):
    """The plain reference's logits at `rows` of each of `seqs`, in float32
    with TF32 off; `cast` is the precision control's hook."""
    with reference.full_float32():
        return reference.logits_at(weights, hccs, seqs, rows, cfg, cast)


def attention_layers(cfg: dict) -> int:
    """Packed-attention calls a step makes: one an attention layer."""
    return layers_of(cfg, "attention")


def attention_shape(cfg: dict) -> tuple[int, int, int]:
    """(heads, kv_heads, head_dim) of each packed-attention call."""
    return cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]


def mamba_layers(cfg: dict) -> int:
    """Scans a step makes: one a Mamba-2 layer."""
    return layers_of(cfg, "mamba")


def _mamba_params(cfg: dict) -> int:
    d, di, nh = cfg["d_model"], cfg["d_inner"], cfg["ssm_heads"]
    c = di + 2 * cfg["ssm_groups"] * cfg["ssm_state"]
    return d * (di + c + nh) + di * d + c * cfg["conv_kernel"]


def active_params_per_token(cfg: dict) -> int:
    """Non-embedding parameters a token passes through: each attention
    layer's projections, each Mamba-2 layer's in- and out-projections and
    conv taps, and every layer's MLP."""
    d, hd = cfg["d_model"], cfg["head_dim"]
    attn = d * cfg["num_heads"] * hd * 2 + d * cfg["num_kv_heads"] * hd * 2
    return (layers_of(cfg, "attention") * attn
            + mamba_layers(cfg) * _mamba_params(cfg)
            + cfg["num_layers"] * 3 * d * cfg["d_ff"])


def ssd_token_flops(cfg: dict) -> float:
    """The SSD's least work a token and layer: the state update and its
    readout, a multiply-add each per state element of every head."""
    return 4.0 * cfg["ssm_heads"] * cfg["ssm_state"] * cfg["ssm_head_dim"]


def model_flops(cfg: dict, tokens: int, keys: int, sampled_rows: int) -> float:
    """Model FLOPs of a stretch of steps: 2 x active parameters per token
    processed (the conv's taps among them), the SSD's state update and
    readout on every token in every Mamba-2 layer, HCCS attention's QK and
    PV over every token's live keys in every attention layer, and the LM
    head over the published vocabulary on each row that was sampled."""
    attn = (4.0 * cfg["num_heads"] * cfg["head_dim"] * keys
            * layers_of(cfg, "attention"))
    ssd = ssd_token_flops(cfg) * tokens * mamba_layers(cfg)
    head = 2.0 * cfg["d_model"] * cfg["vocab_size"] * sampled_rows
    return 2.0 * active_params_per_token(cfg) * tokens + attn + ssd + head


def scan_call(slots, cfg: dict) -> tuple[float, float]:
    """(operations, bytes) of one Mamba-2 layer's scan of a step (the conv,
    the SSD and the state's read and write: kernels/ssd.py in the port).
    slots: (L0, n) per slot that has tokens in the step, its n tokens at
    positions L0 .. L0 + n - 1.

    Operations: the conv (2 K a channel and token) and the SSD's chunked
    products over each slot's n tokens in chunks of at most ssm_chunk q:
    C B^T (2 q^2 n a group), its masked product with dt x (2 q^2 hp a
    head), each chunk's state (2 q n hp a head) and the readout of the
    state entering it (2 q n hp a head), and D x. Bytes: each slot's SSD
    state (f32) and conv window written once, and read once where the slot
    had tokens before (L0 > 0); each token's raw x B C and dt read and y
    written once, in the served dtype; the layer's conv taps and bias and
    its A_log, dt_bias and D once."""
    el = torch.finfo(getattr(torch, cfg["dtype"])).bits // 8
    nh, hp, n = cfg["ssm_heads"], cfg["ssm_head_dim"], cfg["ssm_state"]
    g, k, q_max = cfg["ssm_groups"], cfg["conv_kernel"], cfg["ssm_chunk"]
    di = cfg["d_inner"]
    c = di + 2 * g * n
    state = nh * n * hp * 4 + (k - 1) * c * el
    ops = 0.0
    nbytes = c * k * el + c * el + 3 * nh * 4
    for l0, m in slots:
        full, rest = divmod(m, q_max)
        for q, times in ((q_max, full), (rest, 1 if rest else 0)):
            ops += times * (2.0 * q * q * n * g + 2.0 * q * q * hp * nh
                            + 4.0 * q * n * hp * nh)
        ops += m * (2.0 * c * k + 2.0 * di)
        nbytes += state * (2 if l0 > 0 else 1) + m * (c + nh + di) * el
    return ops, nbytes
