"""The port's training path against the JAX package on the same weights:
the cache-free forward and lm_loss, the gradients of the STE attention,
three train steps (with and without int8 gradient compression), theta kept
frozen, a resume from a checkpoint, and the training launcher.

Weights are made by `repro.models.model.init_params` and carried across by
`params_from_jax`; batches come from the synthetic LM stream, which both
packages draw bit for bit.
"""
import dataclasses
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JaxModelConfig
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.data import LMStream as JaxLMStream
from repro.data import LMStreamConfig as JaxLMStreamConfig
from repro.models import model as JM
from repro.train import make_train_state as jax_make_train_state
from repro.train import make_train_step as jax_make_train_step
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.data import LMStream, LMStreamConfig
from repro_torch.launch import train as port_train
from repro_torch.models import attention as A
from repro_torch.models import model as M
from repro_torch.train import (make_eval_step, make_train_step, train_loop,
                               train_state_from_params)

CPU = "cpu"
# Tolerances, measured on these tiny f32 configs (torch 2.13 CPU against
# jax 0.9 CPU):
# - the forward's hidden state and the loss: max |d| 2.3e-6 on the hidden
#   state (entries up to 3.2), loss within 1.6e-7 relative (the
#   frameworks' matmuls differ by a few ulp); gates about 10x that;
# - gradients: max |d| 3.9e-7 on leaves whose largest entry is up to 0.5,
#   with no int8 logit bin flipped; gate 5e-6 absolute;
# - three train steps at lr 1e-2: loss within 1.7e-7 relative, grad_norm
#   6.7e-7, lr equal; params max |d| 1.2e-4 and more than 1e-5 apart in
#   1.5e-4 of the elements (AdamW's first updates are about +-lr an
#   element, so a gradient within rounding of zero lands up to lr away);
# - with int8 compression a stochastic-rounding bin that flips (a residual
#   one ulp from a rounding boundary) moves its element by a whole quantum,
#   which Adam turns into about lr: loss within 1.7e-5, grad_norm 1.4e-4,
#   params more than 1e-4 apart in 0.9% of the elements by step 3.
HIDDEN_ATOL = 2e-5
LOSS_RTOL = 2e-6
GRAD_ATOL = 5e-6
STEP_RTOL = {"loss": 2e-6, "lr": 1e-6, "grad_norm": 5e-6}
PARAM_ATOL, PARAM_OFF, PARAM_OFF_SHARE = 5e-4, 1e-5, 1e-3
INT8_RTOL = {"loss": 1e-4, "lr": 1e-6, "grad_norm": 1e-3}
INT8_PARAM_OFF, INT8_PARAM_OFF_SHARE = 1e-4, 0.02

MODELS = {
    "softmax": dict(attention_prob="softmax"),
    "hccs-i16_div": dict(attention_prob="hccs", hccs_mode="i16_div"),
    "hccs-wide": dict(attention_prob="hccs"),
}


def _cfgs(**kw):
    base = dict(name="t", family="dense", num_layers=2, d_model=64,
                num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
                vocab_pad_multiple=1)
    base.update(kw)
    return ModelConfig(**base), JaxModelConfig(**base)


def _batch(step=0, seq=16, batch=2, vocab=256):
    return JaxLMStream(JaxLMStreamConfig(vocab_size=vocab, seq_len=seq,
                                         global_batch=batch)).batch_at(step)


def _models(name):
    cfg, jcfg = _cfgs(**MODELS[name])
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    params = M.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                               device=CPU)
    return cfg, jcfg, params, jparams


def _port_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _weights_of(tree):
    """{'a.b': numpy} of a JAX weights tree, keyed like M.flatten_tree."""
    return {".".join(str(p.key) for p in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("name", list(MODELS))
def test_forward_without_cache_and_lm_loss_match_jax(name):
    cfg, jcfg, params, jparams = _models(name)
    b = _batch()
    b["labels"][0, 3] = -100                 # a padded label is skipped
    with torch.no_grad():
        x, cache, aux = M.forward(params["weights"], params["hccs"],
                                  _port_batch(b), cfg)
        loss, metrics = M.lm_loss(params["weights"], params["hccs"],
                                  _port_batch(b), cfg)
    jx, jcache, _ = JM.forward(jparams["weights"], jparams["hccs"],
                               {"tokens": jnp.asarray(b["tokens"])}, jcfg)
    jloss, jmetrics = JM.lm_loss(jparams["weights"], jparams["hccs"],
                                 jax.tree.map(jnp.asarray, b), jcfg)
    assert cache is None and jcache is None and float(aux) == 0.0
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=HIDDEN_ATOL)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    assert set(metrics) == set(jmetrics) == {"lm_loss", "aux_loss"}


def test_remat_changes_memory_not_numbers():
    """remat "full" / "dots" (checkpointed blocks) and "none" give the same
    loss and gradients bit for bit."""
    out = []
    for remat in ("none", "dots", "full"):
        cfg, _, params, _ = _models("hccs-wide")
        cfg = cfg.replace(remat=remat)
        w = {k: v.requires_grad_() for k, v in
             M.flatten_tree(params["weights"]).items()}
        loss, _ = M.lm_loss(M.unflatten_tree(w), params["hccs"],
                            _port_batch(_batch()), cfg)
        grads = torch.autograd.grad(loss, list(w.values()))
        out.append((loss.detach(), grads))
    for loss, grads in out[1:]:
        assert torch.equal(loss, out[0][0])
        for g, g0 in zip(grads, out[0][1]):
            assert torch.equal(g, g0)


def _bin_flips(cfg, jcfg, params, jparams, b):
    """int8 logit bins that differ between the two forwards' captured
    attention logits (HCCS quantizes logits / scale)."""
    from repro.models import attention as JA
    from repro.models import blocks as JB
    from repro.models.layers import embed_tokens
    with torch.no_grad(), A.capture_attention_logits() as cap:
        M.forward(params["weights"], params["hccs"], _port_batch(b), cfg)
    x = embed_tokens(jparams["weights"]["embed"], jnp.asarray(b["tokens"]),
                     jcfg)
    pos = jnp.broadcast_to(jnp.arange(b["tokens"].shape[1])[None],
                           b["tokens"].shape)
    flips = 0
    for l in range(jcfg.num_layers):
        lp = jax.tree.map(lambda a: a[l], jparams["weights"]["layers"])
        hc = jax.tree.map(lambda a: a[l], jparams["hccs"])
        with JA.capture_attention_logits() as jcap:
            x, _, _ = JB.apply_block(lp, x, jcfg, hccs=hc, positions=pos)
        scale = np.asarray(hc["scale"])[None, :, None, None]
        q = np.round(cap[l].numpy() / scale)
        jq = np.round(np.asarray(jcap[0]) / scale)
        flips += int(np.sum(q != jq))
    return flips


@pytest.mark.parametrize("name", list(MODELS))
def test_gradients_match_jax_value_and_grad(name):
    """The port's autograd through the STE attention against
    jax.value_and_grad of lm_loss. A 1-ulp logit difference can flip an
    int8 bin and move the gradient by a whole bin: the flips are counted
    (none on this batch), not hidden."""
    cfg, jcfg, params, jparams = _models(name)
    b = _batch(step=1)
    w = {k: v.requires_grad_() for k, v in
         M.flatten_tree(params["weights"]).items()}
    loss, _ = M.lm_loss(M.unflatten_tree(w), params["hccs"], _port_batch(b),
                        cfg)
    grads = dict(zip(w, torch.autograd.grad(loss, list(w.values()))))
    (jloss, _), jgrads = jax.value_and_grad(JM.lm_loss, has_aux=True)(
        jparams["weights"], jparams["hccs"], jax.tree.map(jnp.asarray, b),
        jcfg)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=LOSS_RTOL)
    if cfg.attention_prob == "hccs":
        assert _bin_flips(cfg, jcfg, params, jparams, b) == 0
    want = _weights_of(jgrads)
    assert want.keys() == grads.keys()
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[k], atol=GRAD_ATOL,
                                   err_msg=k)


def _run_both(name, compress, steps=3):
    cfg, jcfg, params, jparams = _models(name)
    jt = JaxTrainConfig(warmup_steps=2, total_steps=10, learning_rate=1e-2,
                        grad_compression=compress)
    tcfg = TrainConfig(**dataclasses.asdict(jt))
    jstate = jax_make_train_state(jax.random.PRNGKey(0), jcfg, jt)
    jstate = dict(jstate, params=jparams)
    state = train_state_from_params(params, tcfg)
    hccs_before = {k: v.clone() for k, v in state["params"]["hccs"].items()}
    jstep = jax.jit(jax_make_train_step(jcfg, jt))
    step = make_train_step(cfg, tcfg)
    rows = []
    for s in range(steps):
        b = _batch(step=s)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, b))
        state, m = step(state, _port_batch(b))
        rows.append((m, jm))
    return state, jstate, rows, hccs_before


@pytest.mark.parametrize("compress", ["none", "int8"])
@pytest.mark.parametrize("name", list(MODELS))
def test_three_train_steps_match_jax(name, compress):
    state, jstate, rows, hccs_before = _run_both(name, compress)
    rtol = STEP_RTOL if compress == "none" else INT8_RTOL
    for m, jm in rows:
        assert set(m) == set(jm)
        for key, tol in rtol.items():
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=tol, err_msg=key)
    got = M.flatten_tree(state["params"]["weights"])
    want = _weights_of(jstate["params"]["weights"])
    diffs = np.concatenate([np.abs(got[k].numpy() - want[k]).ravel()
                            for k in want])
    if compress == "none":
        assert diffs.max() <= PARAM_ATOL
        assert np.mean(diffs > PARAM_OFF) <= PARAM_OFF_SHARE
    else:
        assert np.mean(diffs > INT8_PARAM_OFF) <= INT8_PARAM_OFF_SHARE
        ef = M.flatten_tree(state["ef_error"])
        assert set(ef) == set(want)
        assert all(v.dtype == torch.float32 for v in ef.values())
    np.testing.assert_array_equal(state["rng"].numpy(),
                                  np.asarray(jstate["rng"]))
    assert int(state["opt"].step) == int(jstate["opt"].step) == 3
    # theta and the logit scales are frozen: unchanged bit for bit
    for k, v in hccs_before.items():
        assert torch.equal(state["params"]["hccs"][k], v)
        np.testing.assert_array_equal(v.numpy(),
                                      np.asarray(jstate["params"]["hccs"][k]))


def test_eval_step_matches_lm_loss():
    cfg, jcfg, params, jparams = _models("hccs-wide")
    b = _batch(step=4)
    m = make_eval_step(cfg)(params, _port_batch(b))
    _, jm = JM.lm_loss(jparams["weights"], jparams["hccs"],
                       jax.tree.map(jnp.asarray, b), jcfg)
    np.testing.assert_allclose(float(m["lm_loss"]), float(jm["lm_loss"]),
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("compress", ["none", "int8"])
def test_resume_equals_uninterrupted_run(compress):
    """Save at step 2, restore into a fresh state, run on: the losses and
    the final state equal an uninterrupted run's bit for bit (the CPU is
    deterministic)."""
    cfg, _, _, _ = _models("hccs-wide")
    tcfg = TrainConfig(warmup_steps=1, total_steps=4, learning_rate=1e-2,
                       grad_compression=compress)
    stream = LMStream(LMStreamConfig(vocab_size=256, seq_len=16,
                                     global_batch=2))

    def batch_fn(s):
        return _port_batch(stream.batch_at(s))

    def fresh():
        return train_state_from_params(M.init_params(cfg, seed=3,
                                                     device=CPU), tcfg)
    step = make_train_step(cfg, tcfg)
    whole, hist = train_loop(fresh(), step, batch_fn, total_steps=4,
                             log_every=0)
    with tempfile.TemporaryDirectory() as d:
        _, first = train_loop(fresh(), step, batch_fn, total_steps=2,
                              ckpt_dir=d, cfg=cfg, log_every=0)
        other = train_state_from_params(M.init_params(cfg, seed=9,
                                                      device=CPU), tcfg)
        resumed, rest = train_loop(other, step, batch_fn, total_steps=4,
                                   ckpt_dir=d, cfg=cfg, log_every=0)
    assert [h["step"] for h in first + rest] == [0, 1, 2, 3]
    assert [h["loss"] for h in first + rest] == [h["loss"] for h in hist]
    from repro_torch.checkpoint.manager import _flatten
    a, b = _flatten(whole), _flatten(resumed)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_train_launcher_runs_and_resumes_on_cpu(capsys):
    with tempfile.TemporaryDirectory() as d:
        args = ["--arch", "granite-3-2b", "--reduced", "--device", "cpu",
                "--steps", "3", "--batch", "2", "--seq", "16",
                "--ckpt-dir", os.path.join(d, "ck")]
        state, hist = port_train.main(args)
        assert [h["step"] for h in hist] == [0, 1, 2]
        assert all(np.isfinite(h["loss"]) for h in hist)
        assert "final loss" in capsys.readouterr().out
        _, hist = port_train.main(args[:6] + ["4"] + args[7:])
        assert [h["step"] for h in hist] == [3]
        assert "[resume] restored step 3" in capsys.readouterr().out
    _, hist = port_train.main(["--arch", "granite-3-2b", "--reduced",
                               "--device", "cpu", "--steps", "2", "--batch",
                               "2", "--seq", "8", "--prob", "softmax",
                               "--grad-compression", "int8"])
    assert len(hist) == 2
    with pytest.raises(NotImplementedError, match="A10"):
        port_train.main(["--arch", "musicgen-large", "--reduced", "--device",
                         "cpu", "--steps", "1"])
