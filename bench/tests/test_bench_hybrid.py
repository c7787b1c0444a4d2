"""The hybrid (bench/models/hybrid.py, bench/reference/hybrid.py) at a
small size on the CPU, in float32, with the benchmark's own weights handed
to the program and the reference:

- the program's packed PagedEngine, prefill then decode, against the
  reference's full forward at every served position: several slots in one
  step, prompts split across steps inside an SSD chunk, segments of 1, 2
  and 3 tokens (shorter than the conv window), sequences longer than the
  chunk, slots reused by later requests, and the pipelined async loop;
- a warm step of pad lanes leaves every slot's state as it was;
- the reference's dual form against the token-by-token recurrence;
- the work counts against a hand count, the keys the module refuses, and
  the two Mamba-2 readers, which read nothing where no scan ran.

Tolerances: the program and the reference compute the same float32 sums
in other orders (the program's SSD chunked per segment, the reference's
dual form over the whole sequence); the largest logit error measured at
this size is 2.4e-6 (logits up to ~4), so 1e-4 is the gate."""
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bench import check, harness, spec
from bench.reference import hybrid as reference
from bench.tests import tiny
from bench.tests.test_bench_program_trace import program

from repro_torch.serve import paged
from repro_torch.serve.engine import Request
from repro_torch.serve.paged import PagedEngine

CELL = "granite-4.0-h-micro.short-chat"
BENCH = spec.Bench()
LOGIT_TOL = 1e-4


def setup(seed=3):
    conf = tiny.config(BENCH, CELL)
    model = BENCH.model(conf)
    ref_cfg = model.reference_config(conf)
    cfg = model.port_config(conf)
    w = model.make_weights(ref_cfg, seed, "cpu")
    hccs = model.make_hccs(ref_cfg, seed, "cpu")
    return conf, model, ref_cfg, cfg, w, hccs


def serve(lengths, new, engine_kw, seed=3, **kw):
    """Serve one request a prompt length through a packed PagedEngine,
    recording each step's (frontier, tokens) per slot. Returns (the
    requests as check.py reads them, the engine's own logits, the steps,
    the engine, the model's pieces)."""
    conf, model, ref_cfg, cfg, w, hccs = setup(seed)
    eng = PagedEngine({"weights": w, "hccs": hccs}, cfg, packed=True,
                      device="cpu", **engine_kw, **kw)
    tap = check.OwnLogits(eng)
    steps = []
    pack = paged.pack_slot_ids

    def recorded(t_valid, width):
        steps.append([(int(s), int(eng._lengths[s]), int(t_valid[s]))
                      for s in np.flatnonzero(t_valid)])
        return pack(t_valid, width)
    paged.pack_slot_ids = recorded
    try:
        rng = np.random.default_rng(seed)
        reqs = [Request(uid=i, prompt=rng.integers(
            0, ref_cfg["vocab_size"], n).astype(np.int32),
            max_new_tokens=new) for i, n in enumerate(lengths)]
        for r in reqs:
            eng.submit(r)
        while eng.busy:
            eng.step()
    finally:
        paged.pack_slot_ids = pack
    done = [dict(uid=r.uid, prompt=r.prompt, out=list(r.out_tokens))
            for r in reqs]
    return done, tap.own(), steps, eng, (model, ref_cfg, w, hccs)


def readings(done, own, parts):
    model, ref_cfg, w, hccs = parts
    ref = check.reference_logits(model, w, hccs, ref_cfg, done)
    return check.readings(ref, done, own)


ENGINE = dict(max_batch=3, token_budget=8, max_len=64, block_size=8,
              num_blocks=3 * 8 + 2)


def test_served_logits_match_the_reference():
    """Five requests through three slots with 8 lanes a step: chunks of
    odd lengths split prompts inside the 8-token SSD chunk, decode lanes
    ride beside them, and two slots are reused."""
    done, own, steps, _, parts = serve([3, 2, 11, 20, 1], 6, ENGINE)
    got = readings(done, own, parts)
    assert got["tokens"] == 30
    assert got["logit_err"] < LOGIT_TOL and got["gap"] == 0.0, got
    segs = [seg for step in steps for seg in step]
    chunk = parts[1]["ssm_chunk"]
    assert max(len(step) for step in steps) == 3       # several slots
    assert {1, 2, 3} <= {t for _, _, t in segs}         # < the conv window
    assert any(l0 > 0 and t > 1 for _, l0, t in segs)   # a continued chunk
    assert any(l0 % chunk and t > 1 for _, l0, t in segs)   # mid-chunk
    assert any(l0 + t > chunk for _, l0, t in segs)     # past one chunk
    firsts = [s for s, l0, _ in segs if l0 == 0]
    assert len(firsts) == 5 and len(set(firsts)) < 5    # slots reused


def test_async_loop_serves_the_same():
    done, own, _, _, parts = serve([3, 2, 11, 20, 1], 6, ENGINE)
    adone, _, _, eng, _ = serve([3, 2, 11, 20, 1], 6, ENGINE,
                                async_loop=True)
    assert [r["out"] for r in adone] == [r["out"] for r in done]
    assert eng.async_overlapped_steps > 0
    got = readings(done, own, parts)
    assert got["logit_err"] < LOGIT_TOL and got["gap"] == 0.0, got


def test_pad_lanes_leave_every_state():
    """After a prompt's first chunk every slot has state; a step at each
    rung of pad lanes only (as the harness warms the ladder) changes no
    byte of it, and serving goes on to the reference's logits."""
    _, model, ref_cfg, cfg, w, hccs = setup()
    eng = PagedEngine({"weights": w, "hccs": hccs}, cfg, packed=True,
                      device="cpu", **ENGINE)
    tap = check.OwnLogits(eng)
    rng = np.random.default_rng(5)
    reqs = [Request(uid=i, prompt=rng.integers(0, 300, n).astype(np.int32),
                    max_new_tokens=4) for i, n in enumerate([13, 6, 9])]
    for r in reqs:
        eng.submit(r)
    eng.step()
    layers = eng._cache["layers"]
    before = {k: layers[k].clone() for k in ("ssm", "conv", "k", "v")}
    assert all(before["ssm"][:, s].abs().sum() > 0 for s in range(3))
    harness.warm_rungs(eng)
    for k in ("ssm", "conv"):
        assert torch.equal(layers[k], before[k]), k
    while eng.busy:
        eng.step()
    done = [dict(uid=r.uid, prompt=r.prompt, out=list(r.out_tokens))
            for r in reqs]
    got = readings(done, tap.own(), (model, ref_cfg, w, hccs))
    assert got["logit_err"] < LOGIT_TOL and got["gap"] == 0.0, got


def test_dual_form_equals_the_recurrence():
    g = torch.Generator().manual_seed(0)
    t, nh, hp, n = 37, 4, 8, 16
    x = torch.randn((t, nh, hp), generator=g)
    B = torch.randn((t, 1, n), generator=g)
    C = torch.randn((t, 1, n), generator=g)
    dt = torch.rand((t, nh), generator=g) * 0.5
    a = -torch.rand(nh, generator=g) * 4 * dt
    D = torch.rand(nh, generator=g)
    y = reference.ssd_dual(x, dt, a, B, C, D, head_block=3)
    s = torch.zeros((nh, n, hp))
    rec = []
    for i in range(t):
        s = torch.exp(a[i])[:, None, None] * s \
            + dt[i][:, None, None] * B[i, 0][None, :, None] * x[i][:, None]
        rec.append(torch.einsum("n,hnp->hp", C[i, 0], s) + D[:, None] * x[i])
    assert torch.allclose(y, torch.stack(rec), atol=1e-5, rtol=1e-5)


def test_work_counts_against_a_hand_count():
    conf, model, cfg, *_ = setup()
    d, f, L = 128, 96, 10
    di, nh, hp, n, k = 256, 8, 32, 16, 4
    c = di + 2 * n
    attn = d * 4 * 32 * 2 + d * 2 * 32 * 2
    mamba = d * (di + c + nh) + di * d + c * k
    assert model.active_params_per_token(cfg) == \
        attn + 9 * mamba + L * 3 * d * f
    assert (model.attention_layers(cfg), model.mamba_layers(cfg)) == (1, 9)
    assert model.attention_shape(cfg) == (4, 2, 32)
    flops = model.model_flops(cfg, tokens=10, keys=55, sampled_rows=2)
    assert flops == (2 * model.active_params_per_token(cfg) * 10
                     + 4 * 4 * 32 * 55 + 4 * nh * n * hp * 10 * 9
                     + 2 * d * 300 * 2)
    # one layer's scan of a step: a fresh 10-token prefill (chunks of 8
    # and 2) and a decode lane with state behind it
    ops, nbytes = model.scan_call([(0, 10), (40, 1)], cfg)
    chunked = sum(2 * q * q * n + 2 * q * q * hp * nh + 4 * q * n * hp * nh
                  for q in (8, 2, 1))
    assert ops == chunked + 11 * (2 * c * k + 2 * di)
    state = nh * n * hp * 4 + (k - 1) * c * 4
    assert nbytes == (c * k * 4 + c * 4 + 3 * nh * 4 + 3 * state
                      + 11 * (c + nh + di) * 4)


REFUSED = [("layer_types", ["mamba", "conv"]),
           ("position_embedding_type", "rope"),
           ("num_local_experts", 8), ("sliding_window", 4096),
           ("tie_word_embeddings", False), ("attention_bias", True),
           ("hidden_act", "gelu"), ("mamba_proj_bias", True),
           ("mamba_conv_bias", False), ("normalization_function", "layernorm")]


@pytest.mark.parametrize("key,value", REFUSED, ids=[k for k, _ in REFUSED])
def test_hybrid_refuses_what_it_does_not_compute(key, value):
    conf = dict(BENCH.config("granite-4.0-h-micro"), **{key: value})
    model = BENCH.model(conf)
    for view in (model.reference_config, model.port_config):
        with pytest.raises(ValueError, match=key):
            view(conf)


def test_hybrid_refuses_a_pattern_of_another_depth():
    conf = dict(BENCH.config("granite-4.0-h-micro"), num_hidden_layers=39)
    with pytest.raises(ValueError, match="layer_types"):
        BENCH.model(conf).reference_config(conf)


def _ctx(prog, model_name, steps):
    conf = BENCH.config(model_name)
    model = BENCH.model(conf)
    return SimpleNamespace(profile=prog.profile, program=prog, model=model,
                           cfg=model.reference_config(conf),
                           stretch_steps=steps)


def test_ssm_readers_read_nothing_without_a_scan():
    """A device trace with kernels but no repro.ssm ranges (the existing
    cells' programs) gives neither reading."""
    prog = program()
    for name in ("granite-3-2b", "granite-4.0-h-micro"):
        ctx = _ctx(prog, name, [[(0, 5)]])
        for metric in ("ssm_busy_share", "ssm_scan_roofline"):
            assert BENCH.reader(metric)(ctx) is None


def test_ssm_readers_on_a_synthetic_trace():
    """Kernels launched inside repro.ssm and repro.ssm.scan: the busy share
    is their device time over busy time, the roofline the scans' bound
    over the scan kernels' time."""
    host = [("bench.stretch", 0, 10_000), ("repro.forward", 0, 9_000),
            ("repro.ssm", 100, 900), ("repro.ssm.scan", 300, 600)]
    launches = [(150, 1000, 2000), (350, 2000, 5000), (700, 5000, 6000)]
    prog = program(host=host, kernels=[], launches=launches)
    steps = [[(0, 128), (900, 1)]]
    ctx = _ctx(prog, "granite-4.0-h-micro", steps)
    busy = prog.profile.busy_s
    assert BENCH.reader("ssm_busy_share")(ctx) == pytest.approx(
        100.0 * 5000e-9 / busy)
    from bench import counts
    bound = counts.bound_seconds(*ctx.model.scan_call(steps[0], ctx.cfg))
    assert BENCH.reader("ssm_scan_roofline")(ctx) == pytest.approx(
        100.0 * bound * 36 / 3000e-9)


def test_traced_cell_on_the_cpu_reads_no_ssm_metric(monkeypatch):
    monkeypatch.setattr(harness, "STRETCH_S", 0.3)
    import time
    res, _ = harness.run(BENCH, CELL, 2 ** 31 + 7, 1.5, True, "cpu",
                         time.perf_counter(), tiny.sizes(BENCH, CELL))
    assert res["correct"] is True
    assert not {"ssm_busy_share", "ssm_scan_roofline"} & set(res["metrics"])
    assert {"dispatch_ms", "lane_fill"} <= set(res["metrics"])


def test_the_configuration_is_the_catalogs():
    """Every number of the source's config as the catalog holds it, the
    pattern's attention layers where the source puts them, nothing cut."""
    conf = BENCH.config("granite-4.0-h-micro")
    att = [i for i, k in enumerate(conf["layer_types"]) if k == "attention"]
    assert att == [5, 15, 25, 35] and len(conf["layer_types"]) == 40
    assert conf["reduced"] == []
    cfg = BENCH.model(conf).port_config(conf)
    assert (cfg.d_model, cfg.d_inner, cfg.ssm_heads, cfg.ssm_state,
            cfg.ssm_conv, cfg.ssm_chunk, cfg.d_ff, cfg.padded_vocab) == \
        (2048, 4096, 64, 128, 4, 256, 8192, 100352)
    assert cfg.rope == "none" and cfg.layer_types == tuple(
        conf["layer_types"])
    assert math.isclose(conf["not_modelled"]["rms_norm_eps"]["published"],
                        conf["rms_norm_eps"])
