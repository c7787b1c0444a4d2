"""Calibration in the port (repro_torch/core/calibrate.py, core/qat.py and
the model's logit capture) against the JAX package.

The twins of tests/test_calibration.py's four tests run on the port (its
grid through `hccs_rows`'s plain version on the CPU); then the same inputs
through both packages: the grid's KLs, the chosen theta at every
granularity, the row subsampling, the observer's scales and the captured
attention logits of a tiny model.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JaxModelConfig
from repro.core import calibrate as JC
from repro.core import qat as JQ
from repro.models import attention as JA
from repro.models import blocks as JB
from repro.models import model as JM
from repro.models.layers import embed_tokens as jax_embed_tokens
from repro_torch.configs.base import ModelConfig
from repro_torch.core import calibrate, qat
from repro_torch.core.calibrate import (_kl_for_grid, _kl_for_heads,
                                        calibrate_heads, calibrate_rows,
                                        collect_attention_logits)
from repro_torch.core.constraints import (default_params, feasible_grid,
                                          validate_params)
from repro_torch.core.hccs import HCCSParams, hccs_probs
from repro_torch.models import attention as A
from repro_torch.models import model as M

CPU = "cpu"
# The grid's KLs against JAX's: the integer stages are bit-equal, so only
# the f32 softmax, log and the row sums differ in rounding. Measured on
# seeded 24 x 64 rows, four modes: JAX's f32 KL lies up to 1.07e-6 relative
# from the same formula in float64, the port's within 2.3e-7, and the two
# up to 1.08e-6 apart; the gate is twice that. A small KL is a sum of
# terms of either sign far larger than itself, whose rounding does not
# shrink with it, hence an absolute term too: measured 5.8e-8 at a KL of
# 0.005 (per-head calibration of the heads below), gate twice that.
KL_RTOL = 2e-6
KL_ATOL = 1.2e-7
# The captured logits of the tiny model against JAX's eager capture (f32,
# the same weights): measured max |d| 9.5e-7 (layer 0) and 2.4e-6 (layer
# 1) on logits up to 4.5 (the projections differ by a few ulp between the
# frameworks' matmuls; ROADMAP.md section C2); the gate is about 4x that.
CAPTURE_ATOL = 1e-5


def _heads_data(L=2, H=2, R=32, n=64, seed=0):
    """Heterogeneous heads: focused (peaked logits) and broad (flat)."""
    rng = np.random.default_rng(seed)
    rows = np.zeros((L, H, R, n), np.float32)
    for l in range(L):
        for h in range(H):
            temp = 0.5 if (l + h) % 2 == 0 else 4.0   # focused vs broad
            rows[l, h] = rng.normal(0, temp, (R, n))
    scale = np.abs(rows).max(axis=(2, 3)) / 127.0
    return rows, scale


def _mean_kl(rows, scale, params, n):
    kl_total, count = 0.0, 0
    L, H = rows.shape[:2]
    for l in range(L):
        for h in range(H):
            x = rows[l, h]
            xq = np.clip(np.round(x / scale[l, h]), -128, 127).astype(np.int32)
            p = HCCSParams(B=params.B[l, h], S=params.S[l, h],
                           D=params.D[l, h])
            q = hccs_probs(torch.from_numpy(xq), p, "i16_div").numpy()
            q = q / np.maximum(q.sum(-1, keepdims=True), 1e-9)
            ref = torch.softmax(torch.from_numpy(x), -1).numpy()
            kl = (ref * (np.log(np.maximum(ref, 1e-20)) -
                         np.log(np.maximum(q, 1e-9)))).sum(-1)
            kl_total += kl.mean()
            count += 1
    return kl_total / count


def _inputs(x, scale):
    xq = torch.from_numpy(np.clip(np.round(x / scale), -128, 127)
                          .astype(np.int8))
    return xq, torch.softmax(torch.from_numpy(x), -1)


# ------------------------------------------- twins of test_calibration.py --

def test_calibration_beats_default():
    n = 64
    rng = np.random.default_rng(3)
    x = rng.normal(0, 2.5, (64, n)).astype(np.float32)
    scale = np.abs(x).max() / 127
    (B, S, D), kl = calibrate_rows(x, scale, n, device=CPU)
    validate_params(B, S, D, n)
    B0, S0, D0 = default_params(n)
    xq, pref = _inputs(x, scale)
    kl0 = float(_kl_for_grid(xq, pref, torch.tensor([[B0, S0, D0]]))[0])
    assert kl < kl0
    assert kl < 0.5   # paper reports ~0.1-0.3 for typical heads


def test_granularity_ordering():
    """per-head <= per-layer <= global mean KL (Table II's claim, measured
    on the calibration objective)."""
    n = 64
    rows, scale = _heads_data(n=n)
    results = {}
    for gran in ("global", "per_layer", "per_head"):
        params, _ = calibrate_heads(rows, scale, n, granularity=gran,
                                    device=CPU)
        results[gran] = _mean_kl(rows, scale, params, n)
    assert results["per_head"] <= results["per_layer"] + 1e-6
    assert results["per_layer"] <= results["global"] + 1e-6


def test_calibrated_params_respect_constraints():
    n = 128
    rows, scale = _heads_data(n=n, L=1, H=2, R=16)
    params, kl = calibrate_heads(rows, scale, n, granularity="per_head",
                                 device=CPU)
    validate_params(params.B.numpy(), params.S.numpy(), params.D.numpy(), n)
    assert params.B.dtype == torch.int32 and params.B.shape == (1, 2)
    assert (kl >= 0).all()


def test_focused_heads_get_steeper_slope():
    """A focused (low-temperature) head needs larger S*scale-sensitivity
    than a broad head: calibration reflects head heterogeneity."""
    n = 64
    rng = np.random.default_rng(5)
    focused = rng.normal(0, 6.0, (64, n)).astype(np.float32)
    broad = rng.normal(0, 0.5, (64, n)).astype(np.float32)
    sf = np.abs(focused).max() / 127
    sb = np.abs(broad).max() / 127
    (Bf, Sf, Df), _ = calibrate_rows(focused, sf, n, device=CPU)
    (Bb, Sb, Db), _ = calibrate_rows(broad, sb, n, device=CPU)
    decay_f = Sf * Df / max(Bf, 1)
    decay_b = Sb * Db / max(Bb, 1)
    assert decay_f >= decay_b


# ------------------------------------------------------ parity with JAX --

@pytest.mark.parametrize("mode", ["i16_div", "i16_clb", "i8_div", "i8_clb"])
def test_kl_for_grid_matches_jax(mode):
    n = 64
    rng = np.random.default_rng(11)
    x = rng.normal(0, 3.0, (24, n)).astype(np.float32)
    scale = np.abs(x).max() / 127
    grid = feasible_grid(n)
    xq, pref = _inputs(x, scale)
    got = _kl_for_grid(xq, pref, torch.from_numpy(grid), mode).numpy()
    want = np.asarray(JC._kl_for_grid(
        jnp.asarray(xq.numpy(), jnp.int32), jax.nn.softmax(jnp.asarray(x), -1),
        jnp.asarray(grid), mode))
    assert got.shape == (len(grid),) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=KL_RTOL, atol=KL_ATOL)


def test_kl_for_heads_is_one_kl_per_head(monkeypatch):
    """Heads stacked into one hccs_rows call, and candidates split over
    several calls, give each head's own KLs bit for bit."""
    rows, scale = _heads_data(L=1, H=3, R=8, n=32)
    grid = torch.from_numpy(feasible_grid(32))
    ins = [_inputs(rows[0, h], scale[0, h]) for h in range(3)]
    monkeypatch.setattr(calibrate, "EVALS_PER_CALL", 3 * 8 * 32 * 5)
    stacked = _kl_for_heads(torch.stack([i[0] for i in ins]),
                            torch.stack([i[1] for i in ins]), grid)
    monkeypatch.undo()
    for h, (xq, pref) in enumerate(ins):
        np.testing.assert_array_equal(stacked[h].numpy(),
                                      _kl_for_grid(xq, pref, grid).numpy())


def test_wide_mode_is_refused_in_both_packages():
    xq, pref = _inputs(np.ones((2, 8), np.float32), 0.1)
    with pytest.raises(ValueError):
        _kl_for_grid(xq, pref, torch.tensor([[4, 0, 8]]), "wide")
    with pytest.raises(ValueError):
        JC._kl_for_grid(jnp.asarray(xq.numpy(), jnp.int32),
                        jnp.asarray(pref.numpy()), jnp.asarray([[4, 0, 8]]),
                        "wide")


@pytest.mark.parametrize("seed", [3, 5])
def test_calibrate_rows_picks_jax_theta(seed):
    n = 64
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1.0 + seed, (48, n)).astype(np.float32)
    scale = np.abs(x).max() / 127
    theta, kl = calibrate_rows(x, scale, n, device=CPU)
    jtheta, jkl = JC.calibrate_rows(x, scale, n)
    assert theta == jtheta
    np.testing.assert_allclose(kl, jkl, rtol=KL_RTOL, atol=KL_ATOL)


@pytest.mark.parametrize("granularity", ["global", "per_layer", "per_head"])
def test_calibrate_heads_picks_jax_theta(granularity, monkeypatch):
    """(Small calls: the per-head grid runs one head a call, and the other
    granularities' candidates split over calls.)"""
    n = 64
    rows, scale = _heads_data(L=2, H=3, R=16, n=n, seed=7)
    monkeypatch.setattr(calibrate, "EVALS_PER_CALL", 1 << 16)
    params, kl = calibrate_heads(rows, scale, n, granularity=granularity,
                                 device=CPU)
    jparams, jkl = JC.calibrate_heads(rows, scale, n, granularity=granularity)
    for name in ("B", "S", "D"):
        np.testing.assert_array_equal(getattr(params, name).numpy(),
                                      np.asarray(getattr(jparams, name)))
    np.testing.assert_allclose(kl, jkl, rtol=KL_RTOL, atol=KL_ATOL)


def test_collect_attention_logits_bit_equal():
    rng = np.random.default_rng(4)
    batches = [rng.normal(0, 1, (2, 3, 2, 8, 8)).astype(np.float32)
               for _ in range(3)]
    got = collect_attention_logits([torch.from_numpy(b) for b in batches],
                                   max_rows_per_head=12, seed=9)
    want = JC.collect_attention_logits(batches, max_rows_per_head=12, seed=9)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (2, 3, 12, 8)


def test_observer_and_fake_quant_match_jax():
    rng = np.random.default_rng(6)
    obs, jobs = qat.AbsMaxObserver(), JQ.AbsMaxObserver()
    for _ in range(3):
        x = rng.normal(0, 2, (2, 3, 5, 7)).astype(np.float32)
        obs.update(torch.from_numpy(x), (0, 1))
        jobs.update(x, (0, 1))
    np.testing.assert_array_equal(obs.scales(), jobs.scales())
    amax = np.asarray([0.0, 1e-7, 3.3, 127.5], np.float32)
    np.testing.assert_array_equal(qat.logit_scale_from_amax(amax).numpy(),
                                  np.asarray(JQ.logit_scale_from_amax(amax)))
    x = rng.normal(0, 3, (64,)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    y = qat.fake_quant_int8(xt, torch.tensor(0.02))
    y.sum().backward()
    jy, jg = jax.value_and_grad(
        lambda v: JQ.fake_quant_int8(v, jnp.float32(0.02)).sum())(
            jnp.asarray(x))
    np.testing.assert_array_equal(y.detach().numpy(),
                                  np.asarray(JQ.fake_quant_int8(
                                      jnp.asarray(x), jnp.float32(0.02))))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jg))


def _tiny(**kw):
    base = dict(name="t", family="dense", num_layers=2, d_model=64,
                num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
                vocab_pad_multiple=1, attention_prob="softmax")
    base.update(kw)
    return base


def test_captured_logits_match_jax_eager_capture():
    """The port's forward (no cache) under capture_attention_logits against
    the JAX package's eager per-layer capture (benchmarks/common.py's
    eager_capture) on the same weights: one (B, H, T, T) f32 tensor per
    layer, scaled and unmasked (a causal model's future keys included)."""
    jcfg = JaxModelConfig(**_tiny())
    cfg = ModelConfig(**_tiny())
    np_params = jax.tree.map(np.asarray,
                             JM.init_params(jax.random.PRNGKey(0), jcfg))
    params = M.params_from_jax(np_params, cfg, device=CPU)
    toks = np.random.default_rng(1).integers(0, 256, (2, 12)).astype(np.int32)
    x = jax_embed_tokens(np_params["weights"]["embed"], jnp.asarray(toks),
                         jcfg)
    pos = jnp.broadcast_to(jnp.arange(12)[None], toks.shape)
    want = []
    for l in range(jcfg.num_layers):
        lp = jax.tree.map(lambda a: a[l], np_params["weights"]["layers"])
        with JA.capture_attention_logits() as cap:
            x, _, _ = JB.apply_block(lp, x, jcfg, hccs=None, positions=pos)
        want.append(np.asarray(cap[0]))
    with torch.no_grad(), A.capture_attention_logits() as cap:
        M.forward(params["weights"], params["hccs"],
                  {"tokens": torch.from_numpy(toks)}, cfg)
    assert A._CAPTURE is None and len(cap) == cfg.num_layers
    for got, ref in zip(cap, want):
        assert got.shape == (2, 4, 12, 12) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, atol=CAPTURE_ATOL)
    # unmasked: the last key's logit is captured for the first query too
    assert np.all(cap[0][:, :, 0, -1].numpy() != 0)
