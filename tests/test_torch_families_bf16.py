"""Two tests in bf16 witness the SSM numbers on the card (PERF.md section
7; the substrate in torch_families.py): a bf16 rounding that differs grows
with depth in both packages alike, and JAX cannot prefill the hybrid in
bf16 (ROADMAP.md section C3).
"""
import torch_threads  # noqa: F401  (first: one torch thread a worker)
import jax
import numpy as np
import pytest
import torch

from repro.configs import reduced_config
from repro.models import model as JM
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JWave
from repro_torch.models import model as M
import torch_families as F


def _drifts(models, seq):
    """Each package's teacher-forced logits on `seq`, and how far its own
    prefill of seq[:, :-1] plus one decode step part from them at the
    decode row (None where the package cannot prefill)."""
    cfg, params, pcfg, pparams = models
    t = seq.shape[1]
    w, hc = params["weights"], params["hccs"]
    x, _, _ = JM.forward(w, hc, {"tokens": jax.numpy.asarray(seq)}, cfg)
    jfull = np.asarray(JM.logits_from_hidden(w, x, cfg), np.float32)
    try:
        _, cache = JM.prefill(w, hc, {"tokens": jax.numpy.asarray(
            seq[:, :-1])}, cfg, max_len=t)
        jdec, _ = JM.decode_step(w, hc, jax.numpy.asarray(seq[:, -1:]),
                                 cache, cfg)
        jdrift = float(np.abs(np.asarray(jdec, np.float32)
                              - jfull[:, -1]).max())
    except TypeError:
        jdrift = None
    pw, phc = pparams["weights"], pparams["hccs"]
    st = torch.from_numpy(seq)
    with torch.inference_mode():
        x, _, _ = M.forward(pw, phc, {"tokens": st}, pcfg)
        pfull = M.logits_from_hidden(pw, x, pcfg).float().numpy()
        _, cache = M.prefill(pw, phc, {"tokens": st[:, :-1]}, pcfg,
                             max_len=t)
        pdec, _ = M.decode_step(pw, phc, st[:, -1:], cache, pcfg)
    pdrift = float(np.abs(pdec.float().numpy() - pfull[:, -1]).max())
    v = cfg.vocab_size
    return jfull[..., :v], pfull[..., :v], jdrift, pdrift


def test_bf16_ssm_rounding_grows_with_depth_in_both_packages():
    """The witness for the bf16 SSM numbers on the card (PERF.md section
    7): with bf16 weights, one rounding that differs grows through the
    random-weight layers. Reduced mamba2 (width 128), seed 0, 2 x 40
    tokens. The two packages' teacher-forced logits, which agree to 5e-3
    in f32 at 24 layers (measured 9.4e-4), part by 0.0156, 0.172 and 1.33
    at 2, 8 and 24 bf16 layers (logits up to 5.0), and the wave engines'
    greedy tokens part at 24 layers; JAX's own prefill + decode row parts
    from its forward by 0, 0.0156 and 0.0903 (the port's by 0 on the CPU;
    on the card by 2.29 at 48 full-width layers)."""
    seq = np.random.default_rng(0).integers(0, 512, (2, 40)).astype(np.int32)
    reqs = F.requests(reduced_config("mamba2-1.3b"), (11, 11, 21), seed=1)
    cross, jdrift, same = [], [], []
    for layers in (2, 8, 24):
        models = F.models("mamba2-1.3b", dtype="bfloat16", num_layers=layers)
        jfull, pfull, jd, pd = _drifts(models, seq)
        cross.append(float(np.abs(jfull - pfull).max()))
        jdrift.append(jd)
        assert pd <= 0.1
        got, want = F.both("wave", models, reqs, max_batch=3, max_len=48)
        same.append(got == want)
    assert cross[0] <= 0.05 and cross[1] >= 2 * cross[0]
    assert cross[2] >= 0.5 and cross[2] >= 4 * cross[1]
    assert jdrift[0] <= jdrift[1] < jdrift[2] and jdrift[2] >= 0.05
    assert same == [True, True, False]
    jfull, pfull, _, _ = _drifts(F.models("mamba2-1.3b", num_layers=24), seq)
    assert np.abs(jfull - pfull).max() <= 5e-3


def test_jax_hybrid_cannot_prefill_in_bf16():
    """JAX's hybrid block comes back in f32 under a cache with bf16
    weights, and lax.scan refuses the carry (ROADMAP.md C3): JAX cannot
    prefill or serve hymba in bf16. The port keeps the residual in the
    model's dtype; its prefill + decode row parts from its forward by
    0.0469 at 2 reduced layers (logits up to 4.5; gate 0.1)."""
    models = F.models("hymba-1.5b", dtype="bfloat16")
    seq = np.random.default_rng(0).integers(0, 512, (2, 40)).astype(np.int32)
    _, _, jd, pd = _drifts(models, seq)
    assert jd is None and pd <= 0.1
    cfg, params = models[:2]
    with pytest.raises(TypeError, match="carry"):
        F.serve(JWave(params, cfg, max_batch=1, max_len=32),
               F.requests(cfg, (11,)), JRequest)
