"""The benchmark's work counts (bench/counts.py, and the decoder's through
its model module's seam) against values worked out by hand."""
from types import SimpleNamespace

import pytest

from bench import counts, spec

# PERF.md's width-256 packed case (the port's chip smoke, phases 3 and 14):
# 8 slots with frontiers 2048, 1024, 777, 1500, 33, 100, 511, 1 and the
# engine's schedule at width 256 with a 128-token chunk cap: 128, 100 and
# 23 prefill tokens, then one token each; one 32-key block of slot 3 is an
# unallocated entry
FRONTS = [2048, 1024, 777, 1500, 33, 100, 511, 1]
TOKENS = [128, 100, 23, 1, 1, 1, 1, 1]


def seam(name):
    """The model module of configuration `name` and its reference view."""
    bench = spec.Bench()
    conf = bench.config(name)
    model = bench.model(conf)
    return model, model.reference_config(conf)


def test_width_256_case_is_3_04_gflop():
    slots = [(f - n, n) for f, n in zip(FRONTS, TOKENS)]
    # 128 x 1921 + 128 x 129 / 2 = 254016; 100 x 924 + 5050 = 97450;
    # 23 x 754 + 276 = 17618; 1500 + 33 + 100 + 511 + 1 = 2145
    assert counts.packed_keys(slots) == 254016 + 97450 + 17618 + 2145
    ops, _ = counts.packed_call(slots, 32, 8, 64)
    live = ops - 4.0 * 32 * 64 * 32            # the unallocated block
    assert live == 3040845824.0
    assert live / counts.PEAK_F32_CORES * 1e3 == pytest.approx(0.0454,
                                                                abs=5e-5)


def test_packed_call_bytes_by_hand():
    # one slot: 10 keys before, 2 tokens; H 4, Hkv 2, d 8, f32 pool:
    # K and V rows 12 x 2 x 8 x 4 B each, q and out 2 x 4 x 8 x 4 B each
    ops, nbytes = counts.packed_call([(10, 2)], 4, 2, 8)
    assert ops == 4 * 4 * 8 * (10 + 1 + 10 + 2)
    assert nbytes == 2 * 12 * 2 * 8 * 4 + 2 * 2 * 4 * 8 * 4
    assert counts.bound_seconds(ops, nbytes) == nbytes / counts.PEAK_HBM
    assert counts.bound_seconds(1e15, 1.0) == 1e15 / counts.PEAK_TOP


@pytest.mark.parametrize("name,per_token", [
    # 40 x (2048 x 2048 x 2 + 2048 x 512 x 2 + 3 x 2048 x 8192)
    ("granite-3-2b", 40 * (8388608 + 2097152 + 50331648)),
    # 24 x (1024 x 1024 x 2 + 1024 x 512 x 2 + 1024 x 32 + 8 x 3 x 1024
    # x 512): the router and the top-8 experts
    ("granite-moe-1b-a400m", 24 * (2097152 + 1048576 + 32768 + 12582912)),
])
def test_active_parameters(name, per_token):
    model, cfg = seam(name)
    assert model.active_params_per_token(cfg) == per_token


def test_model_flops_by_hand():
    model, cfg = seam("granite-3-2b")
    p = model.active_params_per_token(cfg)
    assert 2 * p / 1e9 == pytest.approx(4.8654, abs=1e-4)
    # 10 tokens, 100 live keys over all of them, 3 sampled rows
    want = (2.0 * p * 10 + 4.0 * 32 * 64 * 100 * 40
            + 2.0 * 2048 * 49155 * 3)
    assert model.model_flops(cfg, 10, 100, 3) == want


@pytest.mark.parametrize("name,calls,shape", [
    ("granite-3-2b", 40, (32, 8, 64)),
    ("granite-moe-1b-a400m", 24, (16, 8, 64)),
])
def test_attention_calls(name, calls, shape):
    model, cfg = seam(name)
    assert model.attention_layers(cfg) == calls
    assert model.attention_shape(cfg) == shape


def test_roofline_counts_the_models_attention_calls():
    """packed_attn_roofline takes the calls a step and their shape from the
    model module: a model with 4 attention layers reads a tenth of one with
    40 on the same schedule and device time."""
    read = spec.Bench().reader("packed_attn_roofline")
    steps = [[(10, 2), (0, 5)], [(12, 1)]]
    ops, nbytes = zip(*(counts.packed_call(s, 32, 8, 64, 4) for s in steps))
    bound = sum(counts.bound_seconds(o, b) for o, b in zip(ops, nbytes))

    def reading(layers):
        model = SimpleNamespace(attention_layers=lambda cfg: layers,
                                attention_shape=lambda cfg: (32, 8, 64))
        profile = SimpleNamespace(kernel_s=lambda name: 1e-3)
        return read(SimpleNamespace(cfg={}, model=model, profile=profile,
                                    stretch_steps=steps, pool_bytes=4))
    assert reading(40) == 100.0 * bound * 40 / 1e-3
    assert reading(4) == 100.0 * bound * 4 / 1e-3
