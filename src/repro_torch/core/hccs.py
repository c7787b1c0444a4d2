"""Head-Calibrated Clipped-Linear Softmax (HCCS) — the port of
`repro/core/hccs.py`.

Algorithm 1 of the paper bit-exactly in int32 lanes, plus the differentiable
float/STE path the attention layers run (fake-quant + straight-through
integer stages). Modes (paper §III-B):

  i16+div : T=32767, exact Q0 reciprocal rho = floor(T/Z),      p = s*rho
  i8+div  : rho_u8 = floor(255*2^R / Z), R=INV_SHIFT=15,        p = (s*rho_u8) >> (R+OUT_SHIFT)
  i16+clb : rho approx T / 2^floor(log2 Z) (leading-bit detect), p = s*rho
  i8+clb  : rho_u8 approx (255<<R) >> floor(log2 Z),             p = (s*rho_u8) >> (R+OUT_SHIFT)
  wide    : stages 1-4 in integers, then p = s / Z at full precision

All functions work on the last axis (the key axis of an attention row). The
STE is written as the JAX package writes it, `x + (y - x).detach()`: the
forward value is that float expression, the gradient is the identity.
"""
from __future__ import annotations

import dataclasses

import torch

INV_SHIFT = 15          # R in the paper's eq. (8)
OUT_SHIFT = 0           # extra down-shift on the int8 output path
T_I16 = 32767           # target integer scale, int16 output
T_I8 = 255              # target integer scale, int8 output
MODES: tuple[str, ...] = ("i16_div", "i8_div", "i16_clb", "i8_clb")


@dataclasses.dataclass(frozen=True)
class HCCSParams:
    """Per-head calibration constants theta_h = (B_h, S_h, D_max,h): tensors
    of any broadcastable shape (int32 by construction)."""
    B: torch.Tensor
    S: torch.Tensor
    D: torch.Tensor

    def astuple(self):
        return self.B, self.S, self.D


def _i32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int32, device=like.device)


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def true_div(a, b) -> torch.Tensor:
    """a / b as one IEEE division per element, like XLA's. Torch evaluates
    `number / tensor` as reciprocal(tensor) * number (8439 of the quotients
    32767 / z, z = 1..32767, land one ulp away on the CPU), and on CUDA
    `tensor / number` as a multiply by the number's reciprocal; one ulp can
    move an int8 bin. Every division by a constant in the port's HCCS paths
    goes through here."""
    if not isinstance(a, torch.Tensor):
        a = torch.as_tensor(a, dtype=b.dtype, device=b.device)
    if not isinstance(b, torch.Tensor):
        b = torch.as_tensor(b, dtype=a.dtype, device=a.device)
    return torch.div(a, b)


def leading_bit(z: torch.Tensor) -> torch.Tensor:
    """floor(log2(z)) for positive int32 z by the JAX package's branch-free
    shift cascade (bit-exact with it)."""
    z = z.to(torch.int32)
    k = torch.zeros_like(z)
    for shift in (16, 8, 4, 2, 1):
        gt = (z >> shift) > 0
        k = k + torch.where(gt, shift, 0).to(torch.int32)
        z = torch.where(gt, z >> shift, z)
    return k


def hccs_scores(x_i8: torch.Tensor, B, S, D):
    """Stages 1-4: max-reduce, distance + clamp, affine score, sum-reduce.
    Returns (s, Z) as int32."""
    x = x_i8.to(torch.int32)
    m = x.max(dim=-1, keepdim=True).values                    # stage 1
    delta = torch.minimum(m - x, _i32(D, x))                  # stage 2
    s = _i32(B, x) - _i32(S, x) * delta                       # stage 3
    Z = s.sum(dim=-1, keepdim=True, dtype=torch.int32)        # stage 4
    return s, Z


def normalize(s: torch.Tensor, Z: torch.Tensor, mode: str = "i16_div",
              out_shift: int = OUT_SHIFT) -> torch.Tensor:
    """Stage 5: reciprocal-based normalization in int32 arithmetic. Returns
    values in [0, 32767] (i16 modes) or [0, 255] (i8 modes)."""
    Z = torch.clamp(Z, min=1)
    if mode == "i16_div":
        return s * torch.div(_i32(T_I16, Z), Z, rounding_mode="floor")
    if mode == "i16_clb":
        rho = _i32(T_I16, Z) >> leading_bit(Z)
        return torch.clamp(s * rho, max=T_I16)
    if mode == "i8_div":
        rho = torch.div(_i32(T_I8 << INV_SHIFT, Z), Z, rounding_mode="floor")
        return torch.clamp((s * rho) >> (INV_SHIFT + out_shift), max=T_I8)
    if mode == "i8_clb":
        rho = _i32(T_I8 << INV_SHIFT, Z) >> leading_bit(Z)
        return torch.clamp((s * rho) >> (INV_SHIFT + out_shift), max=T_I8)
    raise ValueError(f"unknown mode {mode!r}")


def hccs_mode_inv(z: torch.Tensor, mode: str) -> torch.Tensor:
    """Float form of the Stage-5 reciprocal for linear post-hoc scaling:
    out = (sum_i s_i v_i) * hccs_mode_inv(Z, mode), with z float32 >= 1.

    HCCS is linear in the active window, so the i16 integer reciprocal
    truncations can be applied to the accumulated float numerator after the
    fact. The i8 modes floor per element after the rho multiply, which is
    not post-hoc linear; they (and "wide") get the exact reciprocal. The
    CUDA kernels evaluate the same float formula (kernels/csrc)."""
    if mode == "i16_div":
        return true_div(torch.floor(true_div(T_I16, z)), T_I16)
    if mode == "i16_clb":
        return true_div(torch.floor(
            T_I16 * torch.exp2(-torch.floor(torch.log2(z)))), T_I16)
    return true_div(1.0, z)


def hccs_int(x_i8: torch.Tensor, params: HCCSParams,
             mode: str = "i16_div") -> torch.Tensor:
    """Full integer HCCS (Algorithm 1): int logits -> scaled int probs."""
    s, Z = hccs_scores(x_i8, *params.astuple())
    return normalize(s, Z, mode)


def hccs_probs(x_i8: torch.Tensor, params: HCCSParams,
               mode: str = "i16_div") -> torch.Tensor:
    """Integer HCCS rescaled to float probabilities in [0, 1]."""
    p = hccs_int(x_i8, params, mode).to(torch.float32)
    return true_div(p, T_I16 if mode.startswith("i16") else T_I8)


# ---------------------------------------------------------------------------
# Differentiable path (QAT and the STE attention)
# ---------------------------------------------------------------------------

def _ste_round(x: torch.Tensor) -> torch.Tensor:
    """round() (half to even) with a straight-through gradient."""
    return x + (torch.round(x) - x).detach()


def _ste_floor(x: torch.Tensor) -> torch.Tensor:
    return x + (torch.floor(x) - x).detach()


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jnp.clip as it is built, minimum(maximum(x, lo), hi): at a bound the
    gradient splits in half (torch.clamp would pass all of it)."""
    return torch.minimum(torch.maximum(x, _f32(lo, x)), _f32(hi, x))


def quantize_logits(x_fp: torch.Tensor, scale) -> torch.Tensor:
    """Fake-quantize float logits to the int8 grid with STE:
    clip(round(x / scale), -128, 127) as float-valued integers."""
    return _clip(_ste_round(x_fp / scale), -128.0, 127.0)


def _masked(x_fp, mask):
    if mask is None:
        return x_fp
    return torch.where(mask, x_fp, _f32(-1e30, x_fp))


def hccs_qat(x_fp: torch.Tensor, scale, params: HCCSParams,
             mode: str = "i16_div", hard: bool = True,
             mask: torch.Tensor | None = None) -> torch.Tensor:
    """Differentiable HCCS on float logits: fake-quant -> surrogate -> probs.

    hard=True rounds every integer stage with STE (bit-faithful forward);
    hard=False is the smooth relaxation. mask: optional bool (..., n);
    masked lanes are set to -1e30 before quantization, score 0 and are
    excluded from Z."""
    B = _f32(params.B, x_fp)
    S = _f32(params.S, x_fp)
    D = _f32(params.D, x_fp)
    x_fp = _masked(x_fp, mask)
    q = quantize_logits(x_fp, scale)
    # amax, not max: its gradient splits evenly between tied maxima, as
    # jnp.max's does (quantized logits tie often)
    m = torch.amax(q, dim=-1, keepdim=True)
    delta = torch.minimum(m - q, D)
    s = B - S * delta
    if mask is not None:
        s = torch.where(mask, s, _f32(0.0, s))
    Z = torch.maximum(s.sum(dim=-1, keepdim=True), _f32(1.0, s))
    if not hard or mode == "wide":
        return s / Z
    if mode.endswith("div"):
        if mode == "i16_div":
            rho = _ste_floor(true_div(T_I16, Z))
            p = true_div(s * rho, T_I16)
        else:
            rho = _ste_floor(true_div(T_I8 * (1 << INV_SHIFT), Z))
            p = _ste_floor(true_div(s * rho, 1 << (INV_SHIFT + OUT_SHIFT)))
            p = true_div(torch.minimum(p, _f32(T_I8, p)), T_I8)
    else:  # clb
        k = torch.floor(torch.log2(Z)).detach()
        pow2 = torch.exp2(k)
        if mode == "i16_clb":
            rho = _ste_floor(true_div(T_I16, pow2))
            p = true_div(torch.minimum(s * rho, _f32(T_I16, s)), T_I16)
        else:
            rho = _ste_floor(true_div(T_I8 * (1 << INV_SHIFT), pow2))
            p = _ste_floor(true_div(s * rho, 1 << (INV_SHIFT + OUT_SHIFT)))
            p = true_div(torch.minimum(p, _f32(T_I8, p)), T_I8)
    return p


def softmax_fp(x: torch.Tensor) -> torch.Tensor:
    """Reference float softmax (the paper's float32 baseline)."""
    return torch.softmax(x, dim=-1)


def hccs_static_max_qat(x_fp: torch.Tensor, scale, params: HCCSParams,
                        mask: torch.Tensor | None = None) -> torch.Tensor:
    """STATIC-max HCCS: distances against the int8 ceiling 127 instead of
    the row max (no Stage 1), then s / Z."""
    B = _f32(params.B, x_fp)
    S = _f32(params.S, x_fp)
    D = _f32(params.D, x_fp)
    x_fp = _masked(x_fp, mask)
    q = quantize_logits(x_fp, scale)
    s = B - S * torch.minimum(127.0 - q, D)
    if mask is not None:
        s = torch.where(mask, s, _f32(0.0, s))
    Z = torch.maximum(s.sum(dim=-1, keepdim=True), _f32(1.0, s))
    return s / Z


def hccs_attention_prob_fn(params: HCCSParams, scale, mode: str = "i16_div",
                           hard: bool = True):
    """Factory: returns prob_fn(logits) -> probs, pluggable into attention.

    The returned function takes float logits (after q.k / sqrt(d)) and
    applies fake-quant + HCCS with the STE (`hccs_qat`), so it serves QAT
    training and bit-faithful inference simulation alike."""
    def prob_fn(logits: torch.Tensor) -> torch.Tensor:
        return hccs_qat(logits, scale, params, mode=mode, hard=hard)
    return prob_fn
