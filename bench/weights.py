"""The benchmark's inputs that stand in for a checkpoint: weights and the
per-head HCCS constants, made from the run's seed on the device with the
benchmark's own generator, in the program's parameter layout. The program
and the reference are handed the same tensors."""
from __future__ import annotations

import torch

# HCCS constants are drawn inside the integer datapath's feasible region
# for the calibration row length n (paper eq. 11): D <= 127,
# B - S*D >= ceil(256 / n), n*B <= 32767, B > 0, S >= 0
N_REF = 128


def _randn(gen, shape, dtype, std, device):
    return torch.randn(shape, generator=gen, dtype=dtype, device=device) * std


def make_weights(cfg: dict, seed: int, device) -> dict:
    """Weights of the configuration `cfg` (the reference's dict, see
    spec.reference_config) from `seed`: normal matrices with std
    fan_in**-0.5 in the served dtype, a float32 router, unit norm scales;
    one generator call per stacked leaf."""
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
