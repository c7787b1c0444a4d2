"""The port's four examples (examples/torch_*.py) held stage by stage to the
JAX scripts (examples/*.py) on the CPU, at cut sizes, on the same seeds and
the same weights (JAX's, carried across by `params_from_jax` /
`train_state_from_params`, or a JAX checkpoint where an optimizer state
must come too). The JAX scripts run at import, so each reference here
redoes a script's stage with the JAX package; the scripts' own constants
and configs are read by running their source up to the first stage.

Tolerances, measured here (torch 2.13 CPU against jax 0.9 CPU, f32):
- quickstart: cls losses of 4 float steps within 1.3e-7 relative and of 2
  QAT steps within 4.6e-7 (gate LOSS_RTOL 2e-6); the captured logits
  within 4.6e-6 (gate CAPTURE_ATOL 1e-5); the rows differ in the last
  ulps, so theta is held by the near-tie rule (ROADMAP.md C2): the KLs of
  the picks within test_torch_calibration.py's KL_RTOL / KL_ATOL (measured
  6e-8 apart; all 6 heads picked JAX's theta); the accuracies on 2
  validation batches equal.
- calibration study: rows and scales bit-equal, so theta at the three
  granularities is equal at R = 8; KLs 8.9e-8 apart (gate KL_RTOL /
  KL_ATOL).
- train_lm: 4 demo-config steps with int8 gradient compression, losses
  within 1.4e-6 relative (gate INT8_LOSS_RTOL 1e-4, test_torch_train.py's
  int8 gate: the compression's noise is bit-equal, its quantization bins
  follow the gradients' last ulps); 2 + 2 steps through a checkpoint equal
  4 uninterrupted steps bit for bit.
- serving: 2 pre-train steps' losses within 2.9e-7 relative (gate
  LOSS_RTOL); a 6-request cut of the queue (odd uids at temperature 0.7)
  gives equal tokens on all three engines; one 2-turn, 2-session chat
  gives equal tokens and prefix_stats().
"""
import torch_threads  # noqa: F401  (first: one torch thread a worker)
import argparse
import dataclasses
import importlib.util
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.core import calibrate as JC
from repro.data import LMStream as JaxLMStream
from repro.data import LMStreamConfig as JaxLMStreamConfig
from repro.models import blocks as JB
from repro.models import model as JM
from repro.models.attention import capture_attention_logits as jax_capture
from repro.models.layers import embed_tokens as jax_embed_tokens
from repro.serve import ContinuousEngine as JContinuous
from repro.serve import PagedEngine as JPaged
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JWave
from repro.train import make_train_state as jax_make_train_state
from repro.train import make_train_step as jax_make_train_step
from repro.train import train_loop as jax_train_loop
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import TrainConfig
from repro_torch.core.hccs import HCCSParams
from repro_torch.models import model as M
from repro_torch.serve import Request
from repro_torch.train import train_state_from_params

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
LOSS_RTOL = 2e-6
INT8_LOSS_RTOL = 1e-4
CAPTURE_ATOL = 1e-5
KL_RTOL, KL_ATOL = 2e-6, 1.2e-7      # test_torch_calibration.py's
CAL_ROWS = 8                          # max_rows_per_head / the study's R
CAP_BATCH, VAL_BATCHES = 4, 2
QS_BATCH = 8                          # quickstart train batch (script: 32)
LM_BATCH, LM_SEQ = 2, 32


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _script_prefix(name, stop):
    """The namespace of the JAX example `name` run up to the first `stop`:
    its constants, configs and data."""
    src = (ROOT / "examples" / name).read_text()
    ns = {"__name__": name}
    exec(compile(src[:src.index(stop)], name, "exec"), ns)
    return ns


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _theta_or_tie(got, kl, want, jkl):
    """Which heads picked JAX's theta; every head's KL within KL_RTOL /
    KL_ATOL of JAX's (the near-tie rule where an ulp of the rows moves a
    pick, ROADMAP.md C2)."""
    same = np.ones(kl.shape, bool)
    for name in ("B", "S", "D"):
        same &= getattr(got, name).cpu().numpy() == np.asarray(
            getattr(want, name))
    np.testing.assert_allclose(kl, jkl, rtol=KL_RTOL, atol=KL_ATOL)
    return same


qs = _example("torch_quickstart")
study = _example("torch_calibration_study")
tlm = _example("torch_train_lm")
serving = _example("torch_serving")


# ---------------------------------------------------------- quickstart --


@pytest.fixture(scope="module")
def jax_qs():
    """The JAX script's stages at the cut size: 4 float steps from
    PRNGKey(0), the capture and per-head calibration on the trained
    weights, the accuracies, and the state QAT starts from."""
    ns = _script_prefix("quickstart.py", "def train")
    cfg, task = ns["cfg_float"], ns["task"]
    tcfg = JaxTrainConfig(total_steps=4, warmup_steps=8, learning_rate=3e-4)
    state = jax_make_train_state(jax.random.PRNGKey(0), cfg, tcfg)
    init = _np_tree(state["params"])
    step = jax.jit(jax_make_train_step(cfg, tcfg, loss_fn=JM.cls_loss))
    losses = []
    for s in range(4):
        state, m = step(state, _jax_batch(task.batch_at(s, QS_BATCH)))
        losses.append(float(m["loss"]))
    return dict(ns=ns, init=init, state=state, losses=losses)


_JAX_ACC: dict = {}


def _jax_accuracy(params, cfg, task):
    """The JAX script's accuracy() on VAL_BATCHES batches (cls_loss under
    jit, one compile a config: eager dispatch costs more than a compile)."""
    if cfg not in _JAX_ACC:
        _JAX_ACC[cfg] = jax.jit(
            lambda w, h, b: JM.cls_loss(w, h, b, cfg)[1]["acc"])
    loss = _JAX_ACC[cfg]
    return float(np.mean([float(loss(
        params["weights"], params["hccs"],
        _jax_batch(task.batch_at(9000 + s, 64, split="val"))))
        for s in range(VAL_BATCHES)]))


@pytest.fixture(scope="module")
def jax_qs_cal(jax_qs):
    """The JAX script's capture loop (layer by layer through apply_block)
    and per-head calibration on the float-trained weights."""
    ns = jax_qs["ns"]
    cfg, task, seq = ns["cfg_float"], ns["task"], ns["SEQ"]
    w = jax_qs["state"]["params"]["weights"]
    cap_batches = []
    for s in range(2):
        toks = jnp.asarray(task.batch_at(7000 + s, CAP_BATCH)["tokens"])
        x = jax_embed_tokens(w["embed"], toks, cfg)
        pos = jnp.broadcast_to(jnp.arange(seq)[None], toks.shape)
        x = x + jnp.take(w["pos_embed"], pos, axis=0)
        per_layer = []
        for l in range(cfg.num_layers):
            lp = jax.tree.map(lambda a: a[l], w["layers"])
            with jax_capture() as cap:
                x, _, _ = JB.apply_block(lp, x, cfg, positions=pos)
            per_layer.append(np.asarray(cap[0]))
        cap_batches.append(np.moveaxis(np.stack(per_layer), 2, 1))
    rows = JC.collect_attention_logits(cap_batches,
                                       max_rows_per_head=CAL_ROWS)
    scales = np.abs(rows).max(axis=(2, 3)) / 127.0
    theta, kl = JC.calibrate_heads(rows, scales, seq, granularity="per_head")
    return dict(cap=cap_batches, theta=theta, kl=kl, scales=scales)


def test_quickstart_constants_are_the_jax_scripts():
    ns = _script_prefix("quickstart.py", "def train")
    assert (qs.SEQ, qs.BATCH, qs.STEPS) == (ns["SEQ"], ns["BATCH"],
                                            ns["STEPS"])
    assert dataclasses.asdict(qs.cfg_float) == dataclasses.asdict(
        ns["cfg_float"])
    assert dataclasses.asdict(qs.task.cfg) == dataclasses.asdict(
        ns["task"].cfg)


def test_quickstart_float_steps_match_jax(jax_qs):
    """4 float cls_loss steps from JAX's initial weights: the same losses
    step by step."""
    tcfg = TrainConfig(total_steps=4, warmup_steps=8, learning_rate=3e-4)
    state = train_state_from_params(
        M.params_from_jax(jax_qs["init"], qs.cfg_float, device=CPU), tcfg)
    state, losses = qs.train(qs.cfg_float, 4, state=state, batch=QS_BATCH,
                             device=CPU)
    np.testing.assert_allclose(losses, jax_qs["losses"], rtol=LOSS_RTOL)
    assert state["opt"].step.item() == 4


def test_quickstart_capture_and_calibration_match_jax(jax_qs, jax_qs_cal):
    """On JAX's float-trained weights: the layer-by-layer capture within
    CAPTURE_ATOL and the per-head calibration's theta."""
    params = M.params_from_jax(_np_tree(jax_qs["state"]["params"]),
                               qs.cfg_float, device=CPU)
    cap = qs.capture(params["weights"], qs.cfg_float, batch=CAP_BATCH,
                     device=CPU)
    assert len(cap) == 2
    for got, want in zip(cap, jax_qs_cal["cap"]):
        assert got.shape == want.shape == (2, 3, CAP_BATCH, qs.SEQ, qs.SEQ)
        np.testing.assert_allclose(got, want, atol=CAPTURE_ATOL)
    theta, kl, scales = qs.calibrate(cap, qs.SEQ,
                                     max_rows_per_head=CAL_ROWS, device=CPU)
    np.testing.assert_allclose(scales, jax_qs_cal["scales"], rtol=1e-6)
    _theta_or_tie(theta, kl, jax_qs_cal["theta"], jax_qs_cal["kl"])


def test_quickstart_no_retrain_and_qat_match_jax(jax_qs, jax_qs_cal):
    """The swap to HCCS with JAX's theta and scales, then 2 QAT steps at
    lr 1e-4 with theta frozen from JAX's float-trained state (optimizer
    included, through a JAX checkpoint): accuracies on 2 validation batches
    equal, QAT losses within LOSS_RTOL, theta unchanged."""
    ns = jax_qs["ns"]
    jcfg, task = ns["cfg_float"], ns["task"]
    jcfg_h = jcfg.replace(attention_prob="hccs", hccs_mode="i16_div")
    cal = jax_qs_cal
    jhccs = {"B": jnp.asarray(cal["theta"].B),
             "S": jnp.asarray(cal["theta"].S),
             "D": jnp.asarray(cal["theta"].D),
             "scale": jnp.asarray(cal["scales"], jnp.float32)}
    jstate = {**jax_qs["state"], "params": {
        "weights": jax_qs["state"]["params"]["weights"], "hccs": jhccs}}
    cfg_h = qs.cfg_float.replace(attention_prob="hccs", hccs_mode="i16_div")
    tcfg = TrainConfig(total_steps=2, warmup_steps=8, learning_rate=1e-4)
    with tempfile.TemporaryDirectory() as d:
        JaxCheckpointManager(d).save(4, jstate, cfg=jcfg_h)
        template = train_state_from_params(
            M.params_from_jax(_np_tree(jstate["params"]), cfg_h,
                              device=CPU), tcfg)
        state, manifest = CheckpointManager(d).restore(template, cfg=cfg_h)
    assert manifest["step"] == 4

    want_base = _jax_accuracy(jax_qs["state"]["params"], jcfg, task)
    want_nr = _jax_accuracy(jstate["params"], jcfg_h, task)
    weights = state["params"]["weights"]
    assert qs.accuracy({"weights": weights, "hccs": {}}, qs.cfg_float,
                       batches=VAL_BATCHES, device=CPU) == want_base
    theta = HCCSParams(*(torch.tensor(np.asarray(getattr(cal["theta"], k)))
                         for k in "BSD"))
    params_h = qs.hccs_params(weights, theta, cal["scales"], device=CPU)
    for k, v in params_h["hccs"].items():
        assert torch.equal(v, state["params"]["hccs"][k]), k
    assert qs.accuracy(params_h, cfg_h, batches=VAL_BATCHES,
                       device=CPU) == want_nr

    jtcfg = JaxTrainConfig(total_steps=2, warmup_steps=8, learning_rate=1e-4)
    jstep = jax.jit(jax_make_train_step(jcfg_h, jtcfg, loss_fn=JM.cls_loss))
    jlosses = []
    for s in range(2):
        jstate, m = jstep(jstate, _jax_batch(task.batch_at(s, QS_BATCH)))
        jlosses.append(float(m["loss"]))
    before = {k: v.clone() for k, v in state["params"]["hccs"].items()}
    state, losses = qs.train(cfg_h, 2, state=state, lr=1e-4,
                             batch=QS_BATCH, device=CPU)
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
    for k, v in before.items():
        assert torch.equal(state["params"]["hccs"][k], v), k
    assert qs.accuracy(state["params"], cfg_h, batches=VAL_BATCHES,
                       device=CPU) == _jax_accuracy(jstate["params"], jcfg_h,
                                                    task)


# --------------------------------------------------- calibration study --


def test_study_rows_are_the_jax_scripts():
    ns = _script_prefix("calibration_study.py", 'print(f"feasible band')
    assert (study.L, study.H, study.R, study.N) == (ns["L"], ns["H"],
                                                    ns["R"], ns["N"])
    rows, scales, temps = study.make_rows()
    assert rows.dtype == ns["rows"].dtype and scales.dtype == ns[
        "scales"].dtype
    np.testing.assert_array_equal(rows, ns["rows"])
    np.testing.assert_array_equal(scales, ns["scales"])
    np.testing.assert_array_equal(temps, ns["temps"])


def test_study_theta_matches_jax_at_cut_rows():
    """The study at R = 8 rows a head: theta at each granularity equal to
    JAX's calibrate_heads on the same rows, KLs within KL_RTOL / KL_ATOL."""
    rows, scales, _ = study.make_rows(R=CAL_ROWS)
    logs = []
    got = study.study(rows, scales, device=CPU, log=logs.append)
    assert [line.split()[0] for line in logs] == list(study.GRANULARITIES)
    for gran, (theta, kl) in got.items():
        want, jkl = JC.calibrate_heads(rows, scales, study.N,
                                       granularity=gran)
        assert _theta_or_tie(theta, kl, want, jkl).all(), gran


# ------------------------------------------------------------ train_lm --


def _jax_train_lm_config(big):
    """The JAX script's (cfg, batch, seq) block, run with --big = big."""
    src = (ROOT / "examples" / "train_lm.py").read_text()
    block = src[src.index("if args.big:"):src.index("n_params =")]
    ns = {"ModelConfig": JaxModelConfig,
          "args": argparse.Namespace(big=big)}
    exec(block, ns)
    return ns["cfg"], ns["batch"], ns["seq"]


@pytest.mark.parametrize("big", [False, True])
def test_train_lm_configs_are_the_jax_scripts(big):
    cfg, batch, seq = tlm.model_config(big)
    jcfg, jbatch, jseq = _jax_train_lm_config(big)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (batch, seq) == (jbatch, jseq)


def test_train_lm_int8_steps_match_jax():
    """4 demo-config steps with int8 gradient compression from JAX's
    initial state: losses within INT8_LOSS_RTOL step by step."""
    jcfg, _, _ = _jax_train_lm_config(False)
    cfg, _, _ = tlm.model_config(False)
    jtcfg = JaxTrainConfig(total_steps=4, warmup_steps=0, learning_rate=1e-3,
                           grad_compression="int8")
    jstate = jax_make_train_state(jax.random.PRNGKey(0), jcfg, jtcfg)
    init = _np_tree(jstate["params"])
    jstep = jax.jit(jax_make_train_step(jcfg, jtcfg))
    stream = JaxLMStream(JaxLMStreamConfig(
        vocab_size=jcfg.vocab_size, seq_len=LM_SEQ, global_batch=LM_BATCH))
    jlosses = []
    for s in range(4):
        jstate, m = jstep(jstate, _jax_batch(stream.batch_at(s)))
        jlosses.append(float(m["loss"]))
    tcfg = tlm.train_config(4, "int8")
    state = train_state_from_params(M.params_from_jax(init, cfg, device=CPU),
                                    tcfg)
    _, hist = tlm.train(cfg, tcfg, LM_BATCH, LM_SEQ, state=state,
                        device=CPU, log_fn=lambda *a: None)
    assert [h["step"] for h in hist] == [0, 1, 2, 3]
    np.testing.assert_allclose([h["loss"] for h in hist], jlosses,
                               rtol=INT8_LOSS_RTOL)


def test_train_lm_resume_equals_uninterrupted():
    """2 steps into a checkpoint directory, then a run to 4 that resumes at
    step 2: the same losses and final state as 4 uninterrupted steps."""
    cfg, _, _ = tlm.model_config(False)
    tcfg = tlm.train_config(4, "none")
    quiet = (lambda *a: None)
    whole, hist = tlm.train(cfg, tcfg, LM_BATCH, LM_SEQ, device=CPU,
                            log_fn=quiet)
    logs = []
    with tempfile.TemporaryDirectory() as d:
        _, first = tlm.train(cfg, tcfg, LM_BATCH, LM_SEQ, steps=2,
                             ckpt_dir=d, device=CPU, log_fn=quiet)
        resumed, rest = tlm.train(cfg, tcfg, LM_BATCH, LM_SEQ, ckpt_dir=d,
                                  device=CPU, log_fn=logs.append)
    assert any(line.startswith("[resume] restored step 2") for line in logs)
    assert [h["step"] for h in first + rest] == [0, 1, 2, 3]
    assert [h["loss"] for h in first + rest] == [h["loss"] for h in hist]
    a = M.flatten_tree(whole["params"]["weights"])
    b = M.flatten_tree(resumed["params"]["weights"])
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ------------------------------------------------------------- serving --


@pytest.fixture(scope="module")
def served_models():
    """2 pre-train steps of the JAX script's model in both packages from
    JAX's initial state (the port's from JAX's weights); then JAX's trained
    weights in both packages, and the 6-request cut of the queue."""
    ns = _script_prefix("serving.py", 'print("[1/3]')
    jcfg = ns["cfg"]
    jtcfg = JaxTrainConfig(total_steps=2, warmup_steps=6, learning_rate=3e-3)
    jstate = jax_make_train_state(jax.random.PRNGKey(0), jcfg, jtcfg)
    init = _np_tree(jstate["params"])
    stream = JaxLMStream(JaxLMStreamConfig(vocab_size=ns["VOCAB"],
                                           seq_len=ns["SEQ"], global_batch=8))
    jstate, jhist = jax_train_loop(
        jstate, jax.jit(jax_make_train_step(jcfg, jtcfg)),
        lambda s: _jax_batch(stream.batch_at(s)), total_steps=2,
        log_every=0)
    params = _np_tree(jstate["params"])
    return dict(ns=ns, init=init, jhist=jhist, jparams=jstate["params"],
                params=M.params_from_jax(params, serving.cfg, device=CPU))


def _cut_queue(cls):
    reqs = serving.mixed_queue(np.random.default_rng(0), n=6)
    return [cls(uid=r.uid, prompt=r.prompt.copy(),
                max_new_tokens=r.max_new_tokens, temperature=r.temperature)
            for r in reqs]


def test_serving_constants_and_pretrain_match_jax(served_models):
    ns = served_models["ns"]
    assert (serving.VOCAB, serving.SEQ) == (ns["VOCAB"], ns["SEQ"])
    assert dataclasses.asdict(serving.cfg) == dataclasses.asdict(ns["cfg"])
    state = train_state_from_params(
        M.params_from_jax(served_models["init"], serving.cfg, device=CPU),
        TrainConfig(total_steps=2, warmup_steps=6, learning_rate=3e-3))
    _, hist = serving.pretrain(serving.cfg, 2, state=state, device=CPU,
                               log_fn=lambda *a: None)
    np.testing.assert_allclose([h["loss"] for h in hist],
                               [h["loss"] for h in served_models["jhist"]],
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("engine", ["wave", "continuous", "paged"])
def test_serving_queue_tokens_match_jax(served_models, engine):
    """The queue's first 6 requests (greedy and temperature 0.7) on one
    engine: the port's timed pass gives the JAX engine's tokens."""
    jcls = {"wave": JWave, "continuous": JContinuous, "paged": JPaged}[engine]
    kw = dict(block_size=16) if engine == "paged" else {}
    jeng = jcls(served_models["jparams"], served_models["ns"]["cfg"],
                max_batch=8, max_len=128, **kw)
    for r in _cut_queue(JRequest):
        jeng.submit(r)
    want = {r.uid: [int(t) for t in r.out_tokens] for r in jeng.run()}
    reqs = _cut_queue(Request)
    assert sum(r.temperature > 0 for r in reqs) == 3
    engines = dict(serving.engines(served_models["params"], serving.cfg,
                                   CPU))
    for r in reqs:
        engines[engine].submit(r)
    got = {r.uid: [int(t) for t in r.out_tokens]
           for r in engines[engine].run()}
    assert got == want


def test_serving_chat_sessions_match_jax(served_models):
    """Two turns of two sessions on the paged engine with decode-block
    sharing: tokens and prefix_stats() equal to the JAX engine's."""
    rng = np.random.default_rng(0)
    serving.mixed_queue(rng)                 # the script's draws before it
    got, stats = serving.chat(served_models["params"], serving.cfg, rng,
                              turns=2, device=CPU, log=lambda *a: None)
    rng = np.random.default_rng(0)
    serving.mixed_queue(rng)
    jchat = JPaged(served_models["jparams"], served_models["ns"]["cfg"],
                   max_batch=4, max_len=256, block_size=16,
                   decode_sharing=True)
    want = {}
    for turn in range(2):
        for s in range(2):
            jchat.submit(JRequest(uid=10 * s + turn,
                                  prompt=rng.integers(
                                      0, serving.VOCAB, 24).astype(np.int32),
                                  max_new_tokens=12), session=f"user-{s}")
        for r in jchat.run():
            want[r.uid] = [int(t) for t in r.out_tokens]
    assert {u: [int(t) for t in v] for u, v in got.items()} == want
    assert stats == jchat.prefix_stats()
    assert stats["decode_hits"] > 0
