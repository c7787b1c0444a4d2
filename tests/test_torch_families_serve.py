"""The port's engines on the MoE, SSM and hybrid families against the JAX
package's engines, on the same weights (made by
`repro.models.model.init_params`, carried across by `params_from_jax`; the
JAX kernels run in interpret mode) and the same traffic.

- reduced granite-moe-1b-a400m (4 experts, top 2, capacity 1.25) on the
  packed and lockstep PagedEngine, the ContinuousEngine and the wave
  ServeEngine, the fused kernels on and off;
- reduced mamba2-1.3b and hymba-1.5b on the wave and continuous engines
  (the paged engine refuses them, in both packages, with one message);
- a JAX checkpoint of a reduced MoE (HCCS router) and an SSM model loads in
  the port and serves the JAX engine's tokens.

Two behaviours of the JAX engines are reproduced, not corrected (ROADMAP.md
section C3), and pinned here with their tokens:
- the packed PagedEngine routes all of a step's tokens, pad lanes included,
  through one MoE dispatch group, so capacity drops make a request's tokens
  depend on the batch: request 2 of DROP_TRAFFIC gets other tokens there
  than on the wave engine;
- the ContinuousEngine folds its bucket-padding tokens into the SSM state:
  an 11-token prompt, padded to 16, decodes other tokens than on the wave
  engine, which batches equal prompts without padding.

Every engine gate is token identity (no greedy token moved on these f32
configs). Two tests in bf16 witness the SSM numbers on the card: a bf16
rounding that differs grows with depth in both packages alike, and JAX
cannot prefill the hybrid in bf16 (ROADMAP.md section C3).
"""
import dataclasses
import os
import tempfile

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.configs import reduced_config
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.models import model as JM
from repro.serve import ContinuousEngine as JContinuous
from repro.serve import PagedEngine as JPaged
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JWave
from repro.train import make_train_state as jax_make_train_state
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models import model as M
from repro_torch.serve import (ContinuousEngine, PagedEngine, Request,
                               ServeEngine)
from repro_torch.train import train_state_from_params

CPU = "cpu"
# three prompts of 11, 23 and 5 tokens (6 new each) whose packed steps drop
# tokens at capacity 1.25
DROP_TRAFFIC = (11, 23, 5)
ENGINES = {"wave": (JWave, ServeEngine, {}),
           "continuous": (JContinuous, ContinuousEngine, {}),
           "packed": (JPaged, PagedEngine, dict(block_size=8)),
           "lockstep": (JPaged, PagedEngine, dict(block_size=8,
                                                  packed=False))}


def _models(arch, **kw):
    cfg = reduced_config(arch).replace(**kw)
    params = JM.init_params(jax.random.PRNGKey(0), cfg)
    pcfg = ModelConfig(**dataclasses.asdict(cfg))
    pparams = M.params_from_jax(jax.tree.map(np.asarray, params), pcfg,
                                device=CPU)
    return cfg, params, pcfg, pparams


def _requests(cfg, lens, max_new=6, seed=0):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, cfg.vocab_size, n).astype(np.int32),
             max_new) for i, n in enumerate(lens)]


def _serve(engine, reqs, cls=Request):
    for uid, prompt, m in reqs:
        engine.submit(cls(uid=uid, prompt=prompt.copy(), max_new_tokens=m))
    return {r.uid: list(r.out_tokens) for r in engine.run()}


def _both(engine, models, reqs, max_batch=4, max_len=64):
    cfg, params, pcfg, pparams = models
    jcls, pcls, kw = ENGINES[engine]
    want = _serve(jcls(params, cfg, max_batch=max_batch, max_len=max_len,
                       **kw), reqs, JRequest)
    got = _serve(pcls(pparams, pcfg, max_batch=max_batch, max_len=max_len,
                      device=CPU, **kw), reqs)
    return got, want


@pytest.mark.parametrize("kernel", ["fused", "none"])
@pytest.mark.parametrize("engine", list(ENGINES))
def test_moe_engine_matches_jax_engine(engine, kernel):
    """DROP_TRAFFIC and a mixed batch of six requests (several waves,
    a one-token budget, prompts past one paged block)."""
    models = _models("granite-moe-1b-a400m", decode_kernel=kernel)
    for reqs in (_requests(models[0], DROP_TRAFFIC),
                 _requests(models[0], (5, 21, 9, 21, 5, 14), seed=1)):
        got, want = _both(engine, models, reqs)
        assert got == want
        assert all(len(t) == m for (u, _, m), t in
                   zip(reqs, (got[u] for u, _, _ in reqs)))


def test_moe_packed_step_routes_pad_lanes_with_the_batch():
    """The JAX packed engine's tokens depend on the batch under capacity
    drops (its pad lanes share the step's dispatch group): requests 0 and 1
    agree with the wave engine, request 2 does not. The port serves the
    same tokens as each JAX engine."""
    models = _models("granite-moe-1b-a400m", decode_kernel="fused")
    reqs = _requests(models[0], DROP_TRAFFIC)
    packed, jpacked = _both("packed", models, reqs)
    wave, jwave = _both("wave", models, reqs)
    assert packed == jpacked and wave == jwave
    assert packed[0] == wave[0] and packed[1] == wave[1]
    assert wave[2][:3] == [499, 397, 453]
    assert packed[2][:3] == [164, 77, 77]


@pytest.mark.parametrize("engine", ["wave", "continuous"])
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "hymba-1.5b"])
def test_ssm_engine_matches_jax_engine(arch, engine):
    """An 11-token prompt (padded to a 16-token bucket on the continuous
    engine) among a mixed batch, 6 new tokens each."""
    models = _models(arch, decode_kernel="fused")
    reqs = _requests(models[0], (11, 5, 21, 11, 16))
    got, want = _both(engine, models, reqs)
    assert got == want
    assert all(len(t) == 6 for t in got.values())


@pytest.mark.parametrize("arch,wave_tokens,continuous_tokens", [
    ("mamba2-1.3b", [228, 494, 448, 26, 26, 26], [228, 20, 20, 20, 20, 43]),
    ("hymba-1.5b", [232, 493, 72, 91, 399, 46],
     [232, 380, 179, 179, 179, 179])])
def test_continuous_engine_folds_bucket_pads_into_the_ssm_state(
        arch, wave_tokens, continuous_tokens):
    """An 11-token prompt is prefilled in a 16-token bucket, and
    the 5 pad tokens run through the SSD into the slot's state; the first
    token (sampled at the prompt's last position) agrees, the rest follow
    the padded state. Both packages give these tokens."""
    models = _models(arch, decode_kernel="fused")
    reqs = _requests(models[0], (11,))
    wave, jwave = _both("wave", models, reqs)
    cont, jcont = _both("continuous", models, reqs)
    assert wave == jwave == {0: wave_tokens}
    assert cont == jcont == {0: continuous_tokens}


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "hymba-1.5b"])
def test_paged_engine_refuses_ssm_state_as_jax_does(arch):
    cfg, params, pcfg, pparams = _models(arch)
    msgs = []
    for cls, p, c, kw in ((JPaged, params, cfg, {}),
                          (PagedEngine, pparams, pcfg, dict(device=CPU))):
        with pytest.raises(ValueError) as e:
            cls(p, c, max_len=64, **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "SSM state" in msgs[0]


@pytest.mark.parametrize("arch,kw", [
    ("granite-moe-1b-a400m", dict(hccs_router=True)),
    ("mamba2-1.3b", {})])
def test_jax_checkpoint_loads_and_serves_in_the_port(arch, kw):
    """A JAX train state of a reduced MoE (with the router's HCCS leaves)
    and of an SSM model, saved by the JAX manager, restores in the port bit
    for bit and serves the JAX wave engine's tokens."""
    cfg = reduced_config(arch).replace(**kw)
    pcfg = ModelConfig(**dataclasses.asdict(cfg))
    jstate = jax_make_train_state(jax.random.PRNGKey(5), cfg,
                                  JaxTrainConfig())
    template = train_state_from_params(M.init_params(pcfg, device=CPU),
                                       TrainConfig())
    with tempfile.TemporaryDirectory() as d:
        JaxCheckpointManager(os.path.join(d, "j")).save(3, jstate, cfg=cfg)
        restored, manifest = CheckpointManager(os.path.join(d, "j")).restore(
            template, cfg=pcfg)
    assert manifest["step"] == 3
    want = {".".join(str(p.key) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(
                jstate["params"])[0]}
    got = M.flatten_tree(restored["params"])
    assert want.keys() == got.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    if cfg.hccs_router:
        assert "weights.layers.moe.hccs.B" in got
    reqs = _requests(cfg, (7, 12))
    jwant = _serve(JWave(jstate["params"], cfg, max_batch=2, max_len=32),
                   reqs, JRequest)
    with torch.no_grad():
        got_toks = _serve(ServeEngine(restored["params"], pcfg, max_batch=2,
                                      max_len=32, device=CPU), reqs)
    assert got_toks == jwant


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
    reqs = _requests(reduced_config("mamba2-1.3b"), (11, 11, 21), seed=1)
    cross, jdrift, same = [], [], []
    for layers in (2, 8, 24):
        models = _models("mamba2-1.3b", dtype="bfloat16", num_layers=layers)
        jfull, pfull, jd, pd = _drifts(models, seq)
        cross.append(float(np.abs(jfull - pfull).max()))
        jdrift.append(jd)
        assert pd <= 0.1
        got, want = _both("wave", models, reqs, max_batch=3, max_len=48)
        same.append(got == want)
    assert cross[0] <= 0.05 and cross[1] >= 2 * cross[0]
    assert cross[2] >= 0.5 and cross[2] >= 4 * cross[1]
    assert jdrift[0] <= jdrift[1] < jdrift[2] and jdrift[2] >= 0.05
    assert same == [True, True, False]
    jfull, pfull, _, _ = _drifts(_models("mamba2-1.3b", num_layers=24), seq)
    assert np.abs(jfull - pfull).max() <= 5e-3


def test_jax_hybrid_cannot_prefill_in_bf16():
    """JAX's hybrid block comes back in f32 under a cache with bf16
    weights, and lax.scan refuses the carry (ROADMAP.md C3): JAX cannot
    prefill or serve hymba in bf16. The port keeps the residual in the
    model's dtype; its prefill + decode row parts from its forward by
    0.0469 at 2 reduced layers (logits up to 4.5; gate 0.1)."""
    models = _models("hymba-1.5b", dtype="bfloat16")
    seq = np.random.default_rng(0).integers(0, 512, (2, 40)).astype(np.int32)
    _, _, jd, pd = _drifts(models, seq)
    assert jd is None and pd <= 0.1
    cfg, params = models[:2]
    with pytest.raises(TypeError, match="carry"):
        _serve(JWave(params, cfg, max_batch=1, max_len=32),
               _requests(cfg, (11,)), JRequest)
