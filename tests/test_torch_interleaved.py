"""The port's interleaved family (configs/granite_4_0_h_micro.py): Mamba-2
and attention mixers by layer, each followed by an MLP, served by the
packed PagedEngine with per-slot recurrent state beside the block pool.
Port-only (the JAX package has no such family), so these tests hold the
program to itself; bench/tests/test_bench_hybrid.py holds it to the plain
reference.

The configuration and its checks; the paged cache's layout; each option
the per-slot state cannot follow yet refused by name (and the slot-arena
engines refusing the family, mamba2 and hymba keeping the paged engine's
refusal); the spans of a profiled packed step; the forward without a
cache against the engine's prefill logits."""
import torch_threads  # noqa: F401  (first: one torch thread a worker)

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.granite_4_0_h_micro import InterleavedConfig
from repro_torch.models import model as M
from repro_torch.serve import (AdmissionConfig, ContinuousEngine,
                               ServeEngine)
from repro_torch.serve.engine import Request
from repro_torch.serve.paged import PagedEngine, init_paged_cache

PATTERN = ("mamba", "mamba", "attention", "mamba")


def tiny(**kw):
    sizes = dict(name="tiny", num_layers=4, layer_types=PATTERN, d_model=64,
                 num_heads=4, num_kv_heads=2, head_dim=16, d_ff=96,
                 vocab_size=256, vocab_pad_multiple=64, ssm_state=16,
                 ssm_head_dim=16, ssm_chunk=8, dtype="float32",
                 decode_kernel="fused")
    return get_config("granite-4.0-h-micro").replace(**dict(sizes, **kw))


def engine(cfg=None, **kw):
    cfg = cfg or tiny()
    opts = dict(max_batch=2, max_len=64, block_size=8, num_blocks=20,
                device="cpu")
    opts.update(kw)
    return PagedEngine(M.init_params(cfg, seed=0, device="cpu"), cfg, **opts)


def requests(lengths=(11, 5), new=3):
    rng = np.random.default_rng(3)
    return [Request(uid=i, prompt=rng.integers(0, 256, n).astype(np.int32),
                    max_new_tokens=new) for i, n in enumerate(lengths)]


def test_the_configuration():
    cfg = get_config("granite-4.0-h-micro")
    assert isinstance(cfg, InterleavedConfig)
    assert [i for i, k in enumerate(cfg.layer_types) if k == "attention"] \
        == [5, 15, 25, 35]
    assert (cfg.layers_of("mamba"), cfg.layers_of("attention")) == (36, 4)
    assert cfg.layer_plan[5] == ("attention", 0)
    assert cfg.layer_plan[36] == ("mamba", 32)
    assert (cfg.d_inner, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_conv,
            cfg.ssm_chunk, cfg.rope, cfg.padded_vocab) == \
        (4096, 64, 128, 4, 256, "none", 100352)
    # the JAX package's fields stay ModelConfig's; the pattern is added
    extra = {f.name for f in dataclasses.fields(cfg)} - {
        f.name for f in dataclasses.fields(ModelConfig)}
    assert extra == {"layer_types", "ssm_conv"}


@pytest.mark.parametrize("kw,match", [
    (dict(layer_types=PATTERN[:3]), "layer_types names 3"),
    (dict(layer_types=("mamba", "conv", "attention", "mamba")), "unknown"),
    (dict(ssm_conv=5), "ssm_conv"),
    (dict(family="hybrid"), "interleaved")])
def test_the_configuration_refuses(kw, match):
    with pytest.raises(ValueError, match=match):
        tiny(**kw)


def test_paged_cache_holds_attention_pools_and_per_slot_state():
    cfg = tiny()
    c = init_paged_cache(cfg, 10, 8, 3, device="cpu")["layers"]
    assert tuple(c["k"].shape) == (1, 10, 2, 8, 16)
    assert tuple(c["ssm"].shape) == (3, 3, 8, 16, 16)
    assert c["ssm"].dtype == torch.float32
    assert tuple(c["conv"].shape) == (3, 3, 3, 128 + 32)


@pytest.mark.parametrize("option", [
    "prefix_sharing", "decode_sharing", "speculative", "preemption",
    "packed=False"])
def test_paged_engine_refuses_by_name(option):
    kw = {"prefix_sharing": dict(prefix_sharing=True),
          "decode_sharing": dict(decode_sharing=True),
          "speculative": dict(speculative=True),
          "preemption": dict(admission=AdmissionConfig(preemption=True)),
          "packed=False": dict(packed=False)}[option]
    with pytest.raises(ValueError, match=option):
        engine(**kw)


def test_sessions_are_refused_by_name():
    eng = engine()
    with pytest.raises(ValueError, match="session="):
        eng.submit(requests()[0], session="a")


@pytest.mark.parametrize("cls", [ServeEngine, ContinuousEngine])
def test_slot_arena_engines_refuse_the_family(cls):
    cfg = tiny()
    with pytest.raises(ValueError, match="packed PagedEngine"):
        cls(M.init_params(cfg, seed=0, device="cpu"), cfg, device="cpu")


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "hymba-1.5b"])
def test_paged_engine_keeps_refusing_ssm_and_hymba(arch):
    from repro_torch.configs import reduced_config
    cfg = reduced_config(arch)
    with pytest.raises(ValueError, match="per-slot SSM state"):
        PagedEngine(M.init_params(cfg, seed=0, device="cpu"), cfg,
                    max_batch=2, max_len=64, block_size=8, device="cpu")


def _ranges(prof):
    return sorted((e.start_ns(), e.end_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith("repro."))


def _children(ranges, parent):
    s0, e0, _ = parent
    inside = [r for r in ranges if s0 <= r[0] and r[1] <= e0
              and r != parent]
    return [r for r in inside
            if not any(o != r and o[0] <= r[0] and r[1] <= o[1]
                       for o in inside)]


def test_profiled_packed_step_nests_the_spans():
    """repro.layer > repro.ssm > repro.ssm.scan on Mamba-2 layers,
    repro.layer > repro.attn on the attention layer, repro.mlp after
    every mixer."""
    eng = engine()
    for req in requests():
        eng.submit(req)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        eng.step()
    ranges = _ranges(prof)
    forward = next(r for r in ranges if r[2] == "repro.forward")
    layers = [r for r in _children(ranges, forward)
              if r[2] == "repro.layer"]
    assert len(layers) == 4
    for kind, layer in zip(PATTERN, layers):
        parts = _children(ranges, layer)
        mixer = "repro.ssm" if kind == "mamba" else "repro.attn"
        assert [r[2] for r in parts] == [mixer, "repro.mlp"]
        inner = [r[2] for r in _children(ranges, parts[0])]
        assert inner == (["repro.ssm.scan"] if kind == "mamba" else [])


def test_forward_without_a_cache_matches_the_engines_prefill():
    """Each row of a batch is a whole sequence from zero state: the
    last-position logits of the cache-free forward equal those the
    packed engine samples its first token from."""
    cfg = tiny()
    params = M.init_params(cfg, seed=0, device="cpu")
    reqs = requests(lengths=(13, 13), new=1)
    eng = PagedEngine(params, cfg, max_batch=2, max_len=64, block_size=8,
                      num_blocks=20, token_budget=64, device="cpu")
    seen = []
    seam = eng._packed_fn

    def tapped(*a):
        logits, cache = seam(*a)
        seen.append(logits.clone())
        return logits, cache
    eng._packed_fn = tapped
    for r in reqs:
        eng.submit(r)
    eng.run()
    toks = torch.tensor(np.stack([r.prompt for r in reqs]))
    with torch.no_grad():
        x, _, _ = M.forward(params["weights"], params["hccs"],
                            {"tokens": toks}, cfg)
        want = M.logits_from_hidden(params["weights"], x[:, -1], cfg)
    got, = seen                                 # both prompts, one step
    assert torch.allclose(got[:, :256], want[:, :256], atol=1e-4), \
        float((got[:, :256] - want[:, :256]).abs().max())
