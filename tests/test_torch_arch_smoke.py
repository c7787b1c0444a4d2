"""The twin of tests/test_arch_smoke.py: every arch of the registry (reduced)
and the paper's two BERT encoders, in the port against the JAX package on
the same weights (made by `repro.models.model.init_params`, carried across
by `params_from_jax`).

One forward (hidden states, logits, MoE aux loss) and one train step (loss,
grad norm, updated weights) per arch, with lm_loss as the reference test
takes it and, for the encoders, cls_loss on the synthetic classification
task; prefill plus one decode step against the teacher-forced forward for
the reference's four archs; the HCCS-inapplicable arch's empty theta; the
padded vocabulary's masked lanes.

Tolerances, measured on these configs (torch 2.13 CPU against jax 0.9 CPU,
f32):
- hidden states: max |d| 1.2e-6 to 8.6e-6 (mamba2, the SSD's einsums), 2e-5
  gate. hymba-1.5b alone reads 4.4e-4: one int8 logit bin of its HCCS
  attention flips at token 14 of row 0 (the projections differ by an ulp
  between the frameworks' matmuls, ROADMAP.md section C2); with softmax
  attention the same arch reads 7.2e-6. Its gate is 2e-3 and the softmax
  twin is held to 2e-5.
- aux loss: equal to 1e-7 relative (2e-6 gate).
- one train step: loss within 5.6e-7 relative (gate 2e-6), grad norm
  within 4.6e-6 (hymba; others 4.7e-7; gate 1e-5), weights within 1.3e-4
  (gate 5e-4: AdamW's first update is about +-lr an element, so a
  gradient within rounding of zero lands up to lr away).
- decode against the forward: the JAX test's own 2e-4 within the port
  (measured 3.7e-6); the port's prefill and decode logits against JAX's
  forward, max |d| 9.7e-6 (mamba2's decode row), gate 5e-5.
"""
import torch_threads  # noqa: F401  (first: one torch thread a worker)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_config, reduced_config
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.data import ClsTask, ClsTaskConfig
from repro.models import model as JM
from repro.train import make_train_state, make_train_step
from repro_torch.configs import registry as port_registry
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models import model as M
from repro_torch.train import make_train_step as port_train_step
from repro_torch.train import train_state_from_params

B, T = 2, 24
CPU = "cpu"
HIDDEN_ATOL = 2e-5
FLIP_ATOL = {"hymba-1.5b": 2e-3}     # one flipped int8 bin (docstring)
AUX_RTOL = 2e-6
STEP_RTOL = {"loss": 2e-6, "grad_norm": 1e-5, "lr": 1e-6}
PARAM_ATOL = 5e-4
DECODE_ATOL = 2e-4                   # tests/test_arch_smoke.py's own
CROSS_LOGIT_ATOL = 5e-5
ENCODERS = ("bert-tiny", "bert-small")


def _config(arch):
    return get_config(arch) if arch in ENCODERS else reduced_config(arch)


def _port_cfg(cfg):
    return ModelConfig(**dataclasses.asdict(cfg))


def _batch(cfg, rng):
    """The reference test's batch (embeddings or tokens, LM labels, M-RoPE
    streams); the encoders' is the classification task's."""
    if cfg.num_classes:
        return ClsTask(ClsTaskConfig(vocab_size=cfg.vocab_size, seq_len=T,
                                     num_classes=cfg.num_classes)
                       ).batch_at(0, B)
    batch = {}
    if cfg.input_mode == "embeddings":
        batch["embeddings"] = rng.normal(0, 1, (B, T, cfg.d_model)).astype(
            np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (B, T)).astype(
            np.int32)
    batch["labels"] = rng.integers(0, cfg.vocab_size, (B, T)).astype(
        np.int32)
    if cfg.rope == "mrope":
        batch["mrope_positions"] = np.tile(np.arange(T), (3, B, 1)).astype(
            np.int32)
    return batch


def _weights_of(tree):
    return {".".join(str(p.key) for p in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _forward_both(cfg, params, batch):
    pcfg = _port_cfg(cfg)
    pp = M.params_from_jax(jax.tree.map(np.asarray, params), pcfg,
                           device=CPU)
    jx, _, jaux = JM.forward(params["weights"], params["hccs"],
                             jax.tree.map(jnp.asarray, batch), cfg)
    with torch.no_grad():
        x, _, aux = M.forward(pp["weights"], pp["hccs"],
                              {k: torch.from_numpy(v)
                               for k, v in batch.items()}, pcfg)
        logits = M.logits_from_hidden(pp["weights"], x, pcfg)
    jl = JM.logits_from_hidden(params["weights"], jx, cfg)
    return (x, logits, aux), (np.asarray(jx), np.asarray(jl), float(jaux))


@pytest.mark.parametrize("arch", list(ARCH_IDS))
def test_forward_and_train_step(arch):
    forward_and_train_step(arch)


def forward_and_train_step(arch):
    """The forward and one train step of `arch` in both packages (the
    encoders' cases are in test_torch_arch_smoke_encoders.py)."""
    cfg = _config(arch)
    batch = _batch(cfg, np.random.default_rng(0))
    tcfg = JaxTrainConfig(total_steps=4, warmup_steps=1)
    state = make_train_state(jax.random.PRNGKey(0), cfg, tcfg)
    pcfg = _port_cfg(cfg)
    pstate = train_state_from_params(
        M.params_from_jax(jax.tree.map(np.asarray, state["params"]), pcfg,
                          device=CPU),
        TrainConfig(total_steps=4, warmup_steps=1))

    (x, logits, aux), (jx, jl, jaux) = _forward_both(cfg, state["params"],
                                                     batch)
    assert x.shape == (B, T, cfg.d_model)
    assert bool(torch.isfinite(x).all()), f"{arch}: non-finite hidden states"
    assert logits.shape == (B, T, cfg.padded_vocab)
    atol = FLIP_ATOL.get(arch, HIDDEN_ATOL)
    np.testing.assert_allclose(x.numpy(), jx, atol=atol)
    np.testing.assert_allclose(logits.numpy(), jl, atol=atol)
    np.testing.assert_allclose(float(aux), jaux, rtol=AUX_RTOL)
    assert (float(aux) > 0) == cfg.is_moe

    jloss = JM.cls_loss if cfg.num_classes else JM.lm_loss
    ploss = M.cls_loss if cfg.num_classes else M.lm_loss
    step = jax.jit(make_train_step(cfg, tcfg, loss_fn=jloss),
                   donate_argnums=0)
    state, jm = step(state, jax.tree.map(jnp.asarray, batch))
    pstate, m = port_train_step(pcfg, TrainConfig(total_steps=4,
                                                  warmup_steps=1),
                                loss_fn=ploss)(
        pstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(m) == set(jm)
    loss, gn = float(m["loss"]), float(m["grad_norm"])
    assert np.isfinite(loss), f"{arch}: non-finite loss"
    assert np.isfinite(gn) and gn > 0, f"{arch}: bad grad norm {gn}"
    for key, tol in STEP_RTOL.items():
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=tol,
                                   err_msg=key)
    got = M.flatten_tree(pstate["params"]["weights"])
    want = _weights_of(state["params"]["weights"])
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v, atol=PARAM_ATOL,
                                   err_msg=k)


def test_hymba_flip_is_the_hccs_bin():
    """hymba's wider gate is one HCCS int8 bin: with softmax attention its
    forward holds to the common gate."""
    cfg = reduced_config("hymba-1.5b").replace(attention_prob="softmax")
    params = JM.init_params(jax.random.PRNGKey(0), cfg)
    batch = _batch(cfg, np.random.default_rng(0))
    (x, logits, _), (jx, jl, _) = _forward_both(cfg, params, batch)
    np.testing.assert_allclose(x.numpy(), jx, atol=HIDDEN_ATOL)
    np.testing.assert_allclose(logits.numpy(), jl, atol=HIDDEN_ATOL)


@pytest.mark.parametrize("arch", ["granite-3-2b", "hymba-1.5b",
                                  "mamba2-1.3b", "qwen3-moe-235b-a22b"])
def test_decode_matches_forward(arch):
    """Prefill + single decode step == teacher-forced full forward, within
    the port (the reference's gate) and against JAX's forward."""
    cfg = reduced_config(arch)
    if cfg.is_moe:
        # capacity-dropping MoE drops different tokens when the dispatch set
        # differs (46 prefill tokens vs 48 teacher-forced); test the routing
        # math itself with drop-free capacity, as the reference does
        cfg = cfg.replace(moe_capacity_factor=8.0)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    params = JM.init_params(jax.random.PRNGKey(1), cfg)
    jx, _, _ = JM.forward(params["weights"], params["hccs"],
                          {"tokens": jnp.asarray(toks)}, cfg)
    jfull = np.asarray(JM.logits_from_hidden(params["weights"], jx, cfg))
    pcfg = _port_cfg(cfg)
    pp = M.params_from_jax(jax.tree.map(np.asarray, params), pcfg,
                           device=CPU)
    pt = torch.from_numpy(toks)
    with torch.no_grad():
        x, _, _ = M.forward(pp["weights"], pp["hccs"], {"tokens": pt}, pcfg)
        full = M.logits_from_hidden(pp["weights"], x, pcfg).numpy()
        lg_p, cache = M.prefill(pp["weights"], pp["hccs"],
                                {"tokens": pt[:, :T - 1]}, pcfg, max_len=T,
                                cache_dtype="float32")
        lg_d, _ = M.decode_step(pp["weights"], pp["hccs"], pt[:, T - 1:],
                                cache, pcfg)
    np.testing.assert_allclose(lg_p.numpy(), full[:, T - 2], atol=DECODE_ATOL)
    np.testing.assert_allclose(lg_d.numpy(), full[:, T - 1], atol=DECODE_ATOL)
    np.testing.assert_allclose(lg_p.numpy(), jfull[:, T - 2],
                               atol=CROSS_LOGIT_ATOL)
    np.testing.assert_allclose(lg_d.numpy(), jfull[:, T - 1],
                               atol=CROSS_LOGIT_ATOL)
    if cfg.family in ("ssm", "hybrid"):
        assert cache["layers"]["ssm"].shape == (
            cfg.num_layers, B, cfg.ssm_heads, cfg.ssm_state,
            cfg.ssm_head_dim)


def test_hccs_inapplicable_arch_has_no_hccs_state():
    cfg = port_registry.reduced_config("mamba2-1.3b")
    params = M.init_params(cfg, device=CPU)
    assert params["hccs"] == {}, "attention-free arch must carry no theta"
    assert "attn" not in params["weights"]["layers"]


def test_vocab_padding_masks_pad_lanes():
    cfg = port_registry.reduced_config("granite-3-2b").replace(
        vocab_size=500, vocab_pad_multiple=128)
    assert cfg.padded_vocab == 512
    params = M.init_params(cfg, device=CPU)
    toks = torch.from_numpy(
        np.random.default_rng(0).integers(0, 500, (1, 8)))
    with torch.no_grad():
        x, _, _ = M.forward(params["weights"], params["hccs"],
                            {"tokens": toks}, cfg)
        logits = M.logits_from_hidden(params["weights"], x, cfg)
    assert float(logits[..., 500:].max()) < -1e29
