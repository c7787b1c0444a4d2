"""The plain reference (bench/reference/decoder.py) against the program's
plain path at a small size on the CPU, with the benchmark's own weights
handed to both, in float32: the dense and the MoE forward without a cache,
and the logits the packed PagedEngine sampled from while serving."""
import numpy as np
import pytest
import torch

from bench import check, spec
from bench.reference import decoder
from bench.tests import tiny

from repro_torch.models import model as M
from repro_torch.serve.engine import Request
from repro_torch.serve.paged import PagedEngine

CELLS = {"dense": "granite-3-2b.azure-code", "moe": "granite-moe-1b-a400m.azure-code"}


def setup(kind, seed=3):
    bench = spec.Bench()
    conf = tiny.config(bench, CELLS[kind])
    model = bench.model(conf)
    ref_cfg = model.reference_config(conf)
    cfg = model.port_config(conf)
    w = model.make_weights(ref_cfg, seed, "cpu")
    hccs = model.make_hccs(ref_cfg, seed, "cpu")
    return model, ref_cfg, cfg, w, hccs


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_forward_matches_the_program(kind):
    _, ref_cfg, cfg, w, hccs = setup(kind)
    tok = torch.randint(0, ref_cfg["vocab_size"], (40,),
                        generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        x, _, _ = M.forward(w, hccs, {"tokens": tok[None]}, cfg)
        prog = M.logits_from_hidden(w, x, cfg)[0, :, :ref_cfg["vocab_size"]]
        ref, = decoder.logits_at(w, hccs, [tok], [torch.arange(40)], ref_cfg)
    assert prog.shape == ref.shape
    assert torch.allclose(prog, ref, atol=2e-4, rtol=1e-4), \
        float((prog - ref).abs().max())


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_served_logits_match_the_program(kind):
    """A packed PagedEngine serves a few requests; the reference recomputed
    over each prompt and its served tokens agrees with the engine's own
    logits at every served position, and every served token is the
    reference's first choice."""
    model, ref_cfg, cfg, w, hccs = setup(kind)
    eng = PagedEngine({"weights": w, "hccs": hccs}, cfg, packed=True,
                      device="cpu", **tiny.ENGINE)
    tap = check.OwnLogits(eng)
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(0, ref_cfg["vocab_size"], n)
                    .astype(np.int32), max_new_tokens=6)
            for i, n in enumerate([9, 30, 17, 41, 5])]
    for r in reqs:
        eng.submit(r)
    while eng.busy:
        eng.step()
    done = [dict(uid=r.uid, prompt=r.prompt, out=list(r.out_tokens))
            for r in reqs]
    ref = check.reference_logits(model, w, hccs, ref_cfg, done)
    got = check.readings(ref, done, tap.own())
    assert got["tokens"] == 30
    assert got["logit_err"] < 1e-3 and got["gap"] < 1e-3, got


def test_hccs_inverse_modes():
    z = torch.tensor([1.0, 3.0, 300.0])
    assert torch.equal(decoder.hccs_inverse(z, "wide"), 1.0 / z)
    assert torch.equal(decoder.hccs_inverse(z, "i16_div"),
                       torch.floor(32767 / z) / 32767)
    # clb: 2^-floor(log2 z), truncated to the int16 grid
    assert torch.allclose(decoder.hccs_inverse(z, "i16_clb"),
                          torch.tensor([1.0, 16383 / 32767, 127 / 32767]))
