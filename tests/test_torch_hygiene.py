"""Import hygiene, device rules and config parity of the port.

The port (src/repro_torch and chip_smoke.py) imports neither JAX nor the JAX
package; its entry points run on the card unless asked for the CPU and
raise without one; paths not ported yet raise instead of falling back; and
its configs are the JAX package's, field for field.
"""
import torch_threads  # noqa: F401  (first: one torch thread a worker)
import ast
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import base as jax_base
from repro.configs import registry as jax_registry
from repro_torch.configs import base as port_base
from repro_torch.configs import registry as port_registry
from repro_torch.kernels.decode import (hccs_decode, hccs_packed_prefill,
                                        hccs_paged_decode)
from repro_torch.launch import serve as port_serve
from repro_torch.models import model as M
from repro_torch.serve import AdmissionConfig, ContinuousEngine, ServeEngine
from repro_torch.serve.engine import Request
from repro_torch.serve.paged import PagedEngine, init_paged_cache

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = sorted((ROOT / "examples").glob("torch_*.py"))
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + EXAMPLES
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax(path):
    roots = set(_imported_roots(path))
    assert not roots & FORBIDDEN, roots & FORBIDDEN


def test_every_port_module_imports_without_jax():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "import importlib, pkgutil, repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "print(' '.join(mods))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    mods = set(res.stdout.split())
    assert len(mods) >= 20
    assert {"repro_torch.core.hccs", "repro_torch.models.attention",
            "repro_torch.models.blocks", "repro_torch.kernels.decode",
            "repro_torch.serve.engine", "repro_torch.serve.continuous",
            "repro_torch.serve.paged", "repro_torch.launch.serve",
            "repro_torch.serve.prng", "repro_torch.serve.telemetry",
            "repro_torch.kernels.ops", "repro_torch.kernels.ref",
            "repro_torch.kernels.hccs", "repro_torch.kernels.softmax_bf16",
            "repro_torch.kernels.attention"} <= mods


# The JAX package's modules with no counterpart at the same path in the
# port: the port's progress meter. Every module has one now; a module
# added on either side must update it.
UNPORTED = []


def test_unported_modules_are_the_recorded_list():
    ref = ROOT / "src" / "repro"
    port = ROOT / "src" / "repro_torch"
    missing = sorted(p.relative_to(ref).as_posix() for p in ref.rglob("*.py")
                     if not (port / p.relative_to(ref)).is_file())
    assert missing == UNPORTED


def test_core_exports_every_public_name_of_the_jax_core():
    """`repro_torch.core` exports what `repro.core` does: the HCCS names
    and the calibrate, constraints and qat submodules."""
    import repro.core as jax_core
    import repro_torch.core as port_core
    public = {n for n in dir(jax_core) if not n.startswith("_")}
    assert len(public) >= 14
    assert public <= {n for n in dir(port_core) if not n.startswith("_")}
    from repro_torch.core import (  # noqa: F401
        hccs_attention_prob_fn, hccs_probs, softmax_fp)
    for sub in ("calibrate", "constraints", "qat", "hccs"):
        assert getattr(port_core, sub).__name__ == f"repro_torch.core.{sub}"


@pytest.mark.parametrize("mode", ["i16_div", "i8_div", "i16_clb", "i8_clb",
                                  "wide"])
@pytest.mark.parametrize("hard", [True, False])
def test_hccs_attention_prob_fn_and_its_gradient_match_jax(mode, hard):
    """The factory's STE probability function against JAX's: outputs equal
    and the gradient of a weighted sum through the STE within 2.3e-8
    (measured; gate 1e-6) on float logits with per-head scales, and
    softmax_fp against jax.nn.softmax.

    One reference-side exception (ROADMAP.md section C3): XLA:CPU's exp2 is
    inexact at some integers (exp2(13.) is 8192.004), so in the i8_clb
    mode JAX's rho = floor(255 * 2^15 / 2^k) is 1019 where it is 1020 for
    8192 <= Z < 16384. Rows at such a k are counted; there the port's
    gradient is JAX's times the two rhos' ratio, and its output equals the
    exact formula."""
    import jax
    import jax.numpy as jnp

    from repro.core import hccs as JH
    from repro_torch.core import HCCSParams, hccs_attention_prob_fn, \
        softmax_fp
    from repro_torch.core.constraints import default_params
    rng = np.random.default_rng(3)
    x = rng.normal(0, 2, (2, 3, 5, 16)).astype(np.float32)
    w = rng.normal(0, 1, x.shape).astype(np.float32)
    B, S, D = (np.full((3, 1, 1), v, np.int32) for v in default_params(16))
    scale = np.asarray([0.05, 0.08, 0.11], np.float32)[:, None, None]
    jfn = JH.hccs_attention_prob_fn(
        JH.HCCSParams(B=jnp.asarray(B), S=jnp.asarray(S), D=jnp.asarray(D)),
        jnp.asarray(scale), mode=mode, hard=hard)
    fn = hccs_attention_prob_fn(
        HCCSParams(B=torch.from_numpy(B), S=torch.from_numpy(S),
                   D=torch.from_numpy(D)), torch.from_numpy(scale),
        mode=mode, hard=hard)
    jout, jgrad = jax.value_and_grad(
        lambda a: jnp.sum(jfn(a) * w))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = torch.sum(fn(xt) * torch.from_numpy(w))
    out.backward()
    got, want = fn(torch.from_numpy(x)).numpy(), np.asarray(
        jfn(jnp.asarray(x)))
    grad, jgrad = xt.grad.numpy(), np.asarray(jgrad)
    # the rows whose leading bit k XLA's exp2 misses
    q = np.clip(np.round(x / scale), -128, 127)
    sc = B - S * np.minimum(q.max(-1, keepdims=True) - q, D)
    k = np.floor(np.log2(np.maximum(sc.sum(-1, keepdims=True), 1.0)))
    pow2 = np.asarray(jnp.exp2(jnp.asarray(k, jnp.float32)))
    rho = np.floor(255 * 2 ** 15 / np.exp2(k))
    ratio = rho / np.floor(np.float32(255 * 2 ** 15) / pow2)
    odd = (ratio != 1) & (mode == "i8_clb" and hard)
    assert odd.sum() <= 19                      # measured: 19 of 30 rows
    if odd.any():
        exact = (np.minimum(np.floor(sc * rho / 2 ** 15), 255) / 255
                 ).astype(np.float32)
        np.testing.assert_array_equal(np.where(odd, got, 0),
                                      np.where(odd, exact, 0))
        jgrad = np.where(odd, jgrad * ratio, jgrad)
    np.testing.assert_array_equal(np.where(odd, 0, got),
                                  np.where(odd, 0, want))
    np.testing.assert_allclose(float(out.detach()), float(jout), rtol=2e-6)
    np.testing.assert_allclose(grad, jgrad, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(softmax_fp(torch.from_numpy(x)).numpy(),
                               np.asarray(JH.softmax_fp(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)   # measured 2.6e-7


def _cfg(**kw):
    return port_registry.reduced_config("granite-3-2b").replace(
        **{"decode_kernel": "fused", **kw})


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _cfg()
    with pytest.raises(RuntimeError, match="CUDA"):
        M.init_params(cfg)
    params = M.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedEngine(params, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        M.params_from_jax({}, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_paged_cache(cfg, 4, 32, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        M.init_cache(cfg, 2, 32)
    for engine in (ServeEngine, ContinuousEngine):
        with pytest.raises(RuntimeError, match="CUDA"):
            engine(params, cfg)
        with pytest.raises(ValueError, match="lie on"):
            engine(params, cfg, device="meta")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_serve.main(["--arch", "granite-3-2b", "--reduced"])
    with pytest.raises(ValueError, match="lie on"):
        PagedEngine(params, cfg, device="meta")
    # the four examples: main([]) is the script at its defaults, on the card
    assert [p.stem for p in EXAMPLES] == [
        "torch_calibration_study", "torch_quickstart", "torch_serving",
        "torch_train_lm"]
    for path in EXAMPLES:
        spec = importlib.util.spec_from_file_location(path.stem, path)
        example = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(example)
        with pytest.raises(RuntimeError, match="CUDA"):
            example.main([])


def test_training_and_calibration_entry_points_raise_without_cuda(
        monkeypatch):
    """make_train_state, the training launcher and calibration run on the
    card unless asked for the CPU, and raise without one."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.calibrate import calibrate_heads, calibrate_rows
    from repro_torch.launch import train as port_train
    from repro_torch.train import make_train_state
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _cfg()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_train_state(0, cfg, TrainConfig())
    assert make_train_state(0, cfg, TrainConfig(), device="cpu")[
        "opt"].step.device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        port_train.main(["--arch", "granite-3-2b", "--reduced", "--steps",
                         "1"])
    rows = np.random.default_rng(0).normal(0, 1, (1, 2, 4, 16))
    with pytest.raises(RuntimeError, match="CUDA"):
        calibrate_rows(rows[0, 0], 0.01, 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        calibrate_heads(rows, np.full((1, 2), 0.01), 16)
    params, _ = calibrate_heads(rows, np.full((1, 2), 0.01), 16,
                                device="cpu")
    assert params.B.device.type == "cpu"


@pytest.mark.parametrize("engine,kw", [
    ("paged", dict(speculative=True)),
    ("paged", dict(admission=AdmissionConfig(max_queue=4))),
    ("continuous", dict(admission=AdmissionConfig(
        max_queue=4, backpressure="shed-lowest-priority"))),
    ("paged", dict(async_loop=True)),
    ("paged", dict(telemetry=True)),
    ("continuous", dict(telemetry=True)),
    ("wave", dict(telemetry=True)),
], ids=["speculative", "admission", "continuous-admission", "async",
        "telemetry", "continuous-telemetry", "wave-telemetry"])
def test_ported_paths_serve(engine, kw):
    """The options that earlier slices refused now serve: speculative
    decoding, the robustness layer and the async loop on the paged engine,
    robust admission on the continuous one, telemetry on all three (greedy
    requests run to completion; telemetry traces every one)."""
    cfg = _cfg()
    params = M.init_params(cfg, device="cpu")
    cls = {"paged": PagedEngine, "continuous": ContinuousEngine,
           "wave": ServeEngine}[engine]
    eng = cls(params, cfg, device="cpu", max_batch=2, max_len=64, **kw)
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(0, 50, 9).astype(np.int32),
                    max_new_tokens=4) for i in range(3)]
    for r in reqs:
        eng.submit(r)
    done = eng.run()
    assert sorted(r.uid for r in done) == [0, 1, 2]
    assert all(r.done and len(r.out_tokens) == 4 for r in reqs)
    if "admission" in kw:
        assert eng.robust_counters.snapshot()["per_class"]["0"][
            "finished"] == 3
    if "async_loop" in kw:
        assert eng.async_overlapped_steps > 0
    if "telemetry" in kw:
        snap = eng.snapshot()
        assert snap["latency"]["requests"] == 3
        assert snap["phases"]["steps"] > 0


@pytest.mark.parametrize("engine", [ServeEngine, ContinuousEngine])
def test_slot_arena_engines_refuse_int8_kv(engine):
    """The slot arena is fp-only: kv_quant raises ValueError, as the JAX
    engines do."""
    params = M.init_params(_cfg(), device="cpu")
    with pytest.raises(ValueError, match="fp-only"):
        engine(params, _cfg(kv_quant="int8"), device="cpu")


def test_unported_request_and_launcher_options_raise():
    cfg = _cfg()
    eng = PagedEngine(M.init_params(cfg, device="cpu"), cfg, device="cpu",
                      max_len=64)
    hot = Request(uid=0, prompt=np.arange(4, dtype=np.int32),
                  max_new_tokens=5, temperature=0.7)
    eng.submit(hot)                      # temperature sampling serves
    assert eng.run() == [hot] and hot.done and len(hot.out_tokens) == 5
    done = port_serve.main(["--arch", "granite-3-2b", "--reduced",
                            "--device", "cpu", "--speculative",
                            "--decode-sharing", "--turns", "2", "--requests",
                            "2", "--prompt-len", "9", "--new-tokens", "6",
                            "--block-size", "8", "--decode-kernel", "none"])
    assert len(done) == 4 and all(len(r.out_tokens) == 6 for r in done)
    with pytest.raises(SystemExit):
        port_serve.main(["--arch", "granite-3-2b", "--reduced", "--device",
                         "cpu", "--speculative", "--scheduler", "paged",
                         "--step-layout", "lockstep"])
    with pytest.raises(SystemExit):
        port_serve.main(["--arch", "granite-3-2b", "--reduced", "--device",
                         "cpu", "--chaos", "0", "--scheduler", "wave"])
    with pytest.raises(SystemExit):
        port_serve.main(["--arch", "granite-3-2b", "--reduced", "--device",
                         "cpu", "--scheduler", "wave", "--step-layout",
                         "lockstep"])
    # every family of the registry builds; the forward takes hot buffers
    # (lockstep only, as in JAX), the continuous and paged engines refuse
    # them as the JAX engines do
    M.init_params(port_registry.reduced_config("mamba2-1.3b"), device="cpu")
    hot_cfg = cfg.replace(hot_buffer=8)
    cache = M.init_cache(hot_cfg, 2, 32, device="cpu")
    assert cache["layers"]["hot_k"].shape[-2] == 8
    with pytest.raises(ValueError, match="lockstep-only"):
        M.init_cache(hot_cfg, 2, 32, per_slot_lengths=True, device="cpu")
    params = M.init_params(hot_cfg, device="cpu")
    for engine, match in ((ContinuousEngine, "slot arena, not hot buffers"),
                          (PagedEngine, "block pool, not hot buffers")):
        with pytest.raises(ValueError, match=match):
            engine(params, hot_cfg, device="cpu", max_len=64)


def test_constrain_adds_no_operation_outside_a_mesh(monkeypatch):
    """constrain returns its argument object outside use_rules (and on a
    plain tensor under them), and a reduced dense forward runs the same
    aten ops with the model's constrain calls as with every call site
    replaced by a bare identity."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.models import attention, blocks, layers, moe, ssm
    from repro_torch.parallel import sharding as SH

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    x = torch.zeros(2, 3)
    assert SH.constrain(x, "batch", "model") is x

    class FakeMesh:
        mesh_dim_names = ("data", "model")
    with SH.use_rules(FakeMesh()):
        assert SH.spec("batch", "model") == ("data", "model")
        assert SH.constrain(x, "batch", "model") is x

    cfg = _cfg()
    params = M.init_params(cfg, device="cpu")
    toks = torch.arange(24, dtype=torch.int32).reshape(2, 12) % 50

    def run():
        with torch.no_grad(), Ops() as ops:
            M.forward(params["weights"], params["hccs"], {"tokens": toks},
                      cfg)
        return ops.ops

    with_calls = run()
    for mod in (attention, blocks, layers, M, moe, ssm):
        monkeypatch.setattr(mod, "constrain", lambda t, *a: t)
    assert run() == with_calls and len(with_calls) > 50


@pytest.mark.parametrize("key", ["stage_rows", "draft_rows"])
def test_speculative_cache_extras_are_consumed(key):
    """The speculative verify step's per-step keys are paged extras the
    model hands every layer: on an int8 pool, draft_rows folds the marked
    rows with a clamped scale, and stage_rows returns every layer's raw
    rows as f32 (L, 1, Hkv, T, hd) beside the pools."""
    cfg = _cfg().replace(cache_layout="paged", kv_quant="int8")
    params = M.init_params(cfg, device="cpu")
    cache = init_paged_cache(cfg, 4, 32, 2, device="cpu")
    pools = cache["layers"]
    cache.update(block_table=torch.tensor([[1, -1]], dtype=torch.int32),
                 write_pos=torch.tensor([[32, 33]], dtype=torch.int32),
                 kv_len=torch.tensor([1, 2], dtype=torch.int32),
                 slot_ids=torch.tensor([0, 0], dtype=torch.int32))
    extra = (torch.zeros((), dtype=torch.int32) if key == "stage_rows"
             else torch.tensor([[False, True]]))
    cache[key] = extra
    _, out, _ = M.forward(
        params["weights"], params["hccs"],
        {"tokens": torch.tensor([[3, 4]], dtype=torch.int32),
         "positions": torch.tensor([[0, 1]], dtype=torch.int32)}, cfg, cache)
    assert key in M.PAGED_EXTRAS
    if key == "stage_rows":
        shape = (cfg.num_layers, 1, cfg.num_kv_heads, 2, cfg.head_dim)
        for name in ("staged_k", "staged_v"):
            assert out["layers"][name].shape == shape
            assert out["layers"][name].dtype == torch.float32
        assert "staged_k" not in pools         # the engine's dict untouched
    else:
        assert "staged_k" not in out["layers"]
        assert (pools["k_scale"][:, 1] > 0).all()


def test_cancel_without_and_with_the_robustness_layer():
    """cancel() drops a queued request (failed, "cancelled") without the
    robustness layer; with it (here from the config's preemption field, as
    the JAX engine reads it) the queue is the priority queue and the cancel
    is counted per class."""
    cfg = _cfg()
    params = M.init_params(cfg, device="cpu")
    for robust_cfg in (cfg, cfg.replace(cache_layout="paged",
                                        preemption=True)):
        eng = PagedEngine(params, robust_cfg, device="cpu", max_len=64)
        req = Request(uid=7, prompt=np.arange(4, dtype=np.int32),
                      priority=2)
        eng.submit(req)
        assert eng.cancel(7) and req.failed
        assert req.fail_reason == "cancelled"
        assert not eng.busy and not eng.cancel(7)
        assert eng.robust_counters.cancelled == 1
        assert eng._robust == (robust_cfg is not cfg)
    assert eng.robust_counters.snapshot()["per_class"]["2"]["cancelled"] == 1
    assert eng._adm.preemption


@pytest.mark.parametrize("scheduler", ["wave", "continuous", "lockstep",
                                       "packed"])
def test_launcher_serves_every_scheduler_on_cpu(scheduler, capsys):
    """The STE paths make --decode-kernel none work for every layout (the
    packed one through its per-slot STE grid)."""
    args = ["--arch", "granite-3-2b", "--reduced", "--device", "cpu",
            "--requests", "3", "--prompt-len", "9", "--new-tokens", "3",
            "--decode-kernel", "none"]
    if scheduler == "lockstep":
        args += ["--scheduler", "paged", "--step-layout", "lockstep",
                 "--block-size", "8"]
    elif scheduler == "packed":
        args += ["--scheduler", "paged", "--block-size", "8"]
    else:
        args += ["--scheduler", scheduler]
    done = port_serve.main(args)
    assert len(done) == 3 and all(len(r.out_tokens) == 3 for r in done)
    assert "served 3 requests" in capsys.readouterr().out


@pytest.mark.parametrize("flags", [
    ["--async-loop", "--scheduler", "wave"],
    ["--async-loop", "--step-layout", "lockstep"],
    ["--token-budget", "16", "--scheduler", "continuous"],
    ["--arrival-rate", "2", "--scheduler", "wave"],
    ["--arrival-rate", "2", "--turns", "2"],
    ["--arrival-rate", "-1"],
    ["--chaos", "0", "--arrival-rate", "2"],
    ["--arch", "qwen2-vl-2b"],
    ["--arch", "musicgen-large", "--scheduler", "wave"],
])
def test_launcher_refuses_what_the_jax_launcher_refuses(flags):
    with pytest.raises(SystemExit):
        port_serve.main(["--arch", "granite-3-2b", "--reduced", "--device",
                         "cpu"] + flags)


@pytest.mark.parametrize("mode", ["async-trace", "open-loop"])
def test_launcher_async_telemetry_and_open_loop(mode, tmp_path, capsys):
    """--async-loop with --trace-out prints the snapshot and writes a
    Chrome trace that parses line by line; --arrival-rate serves every
    request open-loop through drive_open_loop."""
    args = ["--arch", "granite-3-2b", "--reduced", "--device", "cpu",
            "--requests", "3", "--prompt-len", "9", "--new-tokens", "3",
            "--block-size", "8", "--decode-kernel", "none"]
    trace = tmp_path / "trace.jsonl"
    if mode == "async-trace":
        args += ["--async-loop", "--token-budget", "16", "--trace-out",
                 str(trace)]
    else:
        args += ["--arrival-rate", "50"]
    done = port_serve.main(args)
    assert len(done) == 3 and all(len(r.out_tokens) == 3 for r in done)
    out = capsys.readouterr().out
    assert "telemetry snapshot (schema v2, engine=paged)" in out
    if mode == "async-trace":
        assert "async loop:" in out and "0 sync fallbacks" in out
        events = [json.loads(ln) for ln in trace.read_text().splitlines()]
        assert events and {e["cat"] for e in events} == {"step", "phase"}
    else:
        assert "open-loop at 50 req/s" in out


def test_decode_wrappers_on_cpu_count_no_launch():
    rng = np.random.default_rng(1)
    t = (lambda a, dt=torch.float32: torch.tensor(a, dtype=dt))
    q = t(rng.normal(size=(2, 4, 8)))
    pool = t(rng.normal(size=(5, 2, 8, 8)))
    arena = t(rng.normal(size=(2, 2, 11, 8)))
    args = (t([0.1] * 4), t([[159, 1, 64]] * 4, torch.int32))
    out = hccs_paged_decode(q, pool, pool, t([[1, 2], [3, -1]], torch.int32),
                            t([9, 3], torch.int32), *args)
    assert out.shape == (2, 4, 8)
    out = hccs_decode(q, arena, arena, t([11, 0], torch.int32), *args)
    assert out.shape == (2, 4, 8) and (out[1] == 0).all()
    assert hccs_paged_decode.launches == hccs_decode.launches == 0
    with pytest.raises(ValueError, match="mode"):
        hccs_decode(q, arena, arena, t([11, 0], torch.int32), *args,
                    mode="i8_clb")
    with pytest.raises(TypeError, match="K/V"):
        hccs_decode(q, arena.to(torch.int8), arena.to(torch.int8),
                    t([11, 0], torch.int32), *args)
    with pytest.raises(ValueError, match="qint_out"):
        hccs_decode(q, arena, arena, t([11, 0], torch.int32), *args,
                    qint_out=torch.zeros((2, 4, 11), dtype=torch.int8))
    with pytest.raises(ValueError, match="int32"):
        hccs_paged_decode(q, pool, pool, t([[1, 2]], torch.int32),
                          t([9, 3], torch.int32), *args)


def test_kernel_wrapper_on_cpu_counts_no_launch():
    before = hccs_packed_prefill.launches
    assert before == 0
    rng = np.random.default_rng(0)
    t = (lambda a, dt=torch.float32: torch.tensor(a, dtype=dt))
    out = hccs_packed_prefill(
        t(rng.normal(size=(3, 4, 8))), t(rng.normal(size=(5, 2, 8, 8))),
        t(rng.normal(size=(5, 2, 8, 8))), t([[1, 2], [3, -1]], torch.int32),
        t([0, 1, -1], torch.int32), t([9, 3, 0], torch.int32),
        t([0.1] * 4), t([[159, 1, 64]] * 4, torch.int32))
    assert out.shape == (3, 4, 8)
    assert hccs_packed_prefill.launches == before
    with pytest.raises(ValueError):                  # the i8 modes: no
        hccs_packed_prefill(                         # post-hoc linearity
            t(rng.normal(size=(3, 4, 8))), t(rng.normal(size=(5, 2, 8, 8))),
            t(rng.normal(size=(5, 2, 8, 8))),
            t([[1, 2], [3, -1]], torch.int32), t([0, 1, -1], torch.int32),
            t([9, 3, 0], torch.int32), t([0.1] * 4),
            t([[159, 1, 64]] * 4, torch.int32), mode="i8_div")


def test_kernel_api_builds_nothing_at_import():
    """Importing the public kernel API (and running it on CPU tensors)
    neither builds nor loads the CUDA library."""
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "import torch\n"
        "from repro_torch.kernels import (hccs_attention, hccs_decode,\n"
        "    hccs_packed_prefill, hccs_paged_decode, hccs_softmax,\n"
        "    softmax_reference)\n"
        "from repro_torch.kernels import build\n"
        "hccs_softmax(torch.zeros((2, 8), dtype=torch.int8),\n"
        "             torch.tensor([[9, 1, 8]] * 2, dtype=torch.int32))\n"
        "softmax_reference(torch.zeros((2, 8)))\n"
        "print(build._lib is None, build.BUILD_DIR.exists() and any(\n"
        "    build.BUILD_DIR.glob('*.so')))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split()[0] == "True"


def _fake_cuda_args(name):
    """Arguments of each kernel wrapper as CUDA tensors without a card:
    FakeTensors carry a device and a shape, and no data."""
    f32, i32 = torch.float32, torch.int32
    q3, pool, sc, th = ((2, 4, 16), f32), ((5, 2, 8, 16), f32), \
        ((4,), f32), ((4, 3), i32)
    shapes = {
        "hccs_rows": [((4, 16), torch.int8), ((4, 3), i32)],
        "softmax_bf16": [((4, 16), torch.bfloat16)],
        "hccs_mha_fused": [((1, 4, 8, 16), f32), ((1, 2, 8, 16), f32),
                           ((1, 2, 8, 16), f32), sc, th],
        "hccs_decode": [q3, ((2, 2, 11, 16), f32), ((2, 2, 11, 16), f32),
                        ((2,), i32), sc, th],
        "hccs_paged_decode": [q3, pool, pool, ((2, 3), i32), ((2,), i32),
                              sc, th],
        "hccs_packed_prefill": [q3, pool, pool, ((2, 3), i32), ((2,), i32),
                                ((2,), i32), sc, th],
    }[name]
    return [torch.empty(shape, dtype=dt, device="cuda")
            for shape, dt in shapes]


@pytest.mark.parametrize("name", [
    "hccs_rows", "softmax_bf16", "hccs_mha_fused", "hccs_decode",
    "hccs_paged_decode", "hccs_packed_prefill"])
def test_wrappers_raise_on_cuda_when_the_build_fails(name, monkeypatch):
    """On a CUDA tensor each kernel wrapper launches its kernel or raises:
    a failed build raises and neither counts a launch nor runs the plain
    version."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import (attention, build, decode, hccs,
                                     softmax_bf16)
    mod = {"hccs_rows": hccs, "softmax_bf16": softmax_bf16,
           "hccs_mha_fused": attention}.get(name, decode)
    wrapper = getattr(mod, name)
    ref = getattr(mod, f"{name}_ref")

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    def no_fallback(*a, **kw):
        raise AssertionError(f"{ref.__name__} ran on a CUDA tensor")

    monkeypatch.setattr(build, "load_library", no_nvcc)
    monkeypatch.setattr(mod, ref.__name__, no_fallback)
    before = wrapper.launches
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = _fake_cuda_args(name)
        with pytest.raises(RuntimeError, match="nvcc"):
            wrapper(*args)
    assert wrapper.launches == before


def _record_launches(monkeypatch):
    """Replace the `launch` that kernels/decode.py imports from build with a
    recorder that counts the launch as build.launch does; the wrappers'
    counters are restored afterwards."""
    from repro_torch.kernels import decode
    calls = []

    def record(fn, entry, device, *args):
        calls.append((fn, entry, args))
        fn.launches += 1

    for fn in (decode.hccs_decode, decode.hccs_packed_prefill,
               decode.hccs_paged_decode):
        monkeypatch.setattr(fn, "launches", fn.launches)
    monkeypatch.setattr(decode, "launch", record)
    return calls


@pytest.mark.parametrize("with_qint", [False, True])
@pytest.mark.parametrize("static_max", [False, True])
@pytest.mark.parametrize("name", ["hccs_decode", "hccs_packed_prefill",
                                  "hccs_paged_decode"])
def test_split_wrappers_make_one_c_call_with_their_workspace(
        name, static_max, with_qint, monkeypatch):
    """The split-sweep wrappers enqueue all their passes through one C
    call: it gets a uint8 workspace of `workspace_bytes` (no q_int scratch
    of its own when qint_out is given or under static_max), qint_out in the
    scratch's place right before it, and the wrapper counts one launch."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import decode
    calls = _record_launches(monkeypatch)
    wrapper = getattr(decode, name)
    before = wrapper.launches
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = _fake_cuda_args(name)
        r, h, d = args[0].shape
        length = 11 if name == "hccs_decode" else 3 * 8
        qo = (torch.empty((r, h, length), dtype=torch.int8, device="cuda")
              if with_qint else None)
        out = wrapper(*args, static_max=static_max, qint_out=qo)
        assert out.shape == (r, h, d) and out.device.type == "cuda"
        assert len(calls) == 1
        fn, entry, cargs = calls[0]
        ws = [i for i, a in enumerate(cargs) if isinstance(a, torch.Tensor)
              and a.dtype == torch.uint8]
        assert len(ws) == 1
        i = ws[0]
        want = decode.workspace_bytes(
            r, h, length, d, qint_scratch=not with_qint and not static_max)
        assert cargs[i].numel() == cargs[i + 1] == want
        assert cargs[i - 1] is qo and cargs[i - 2] is out
        assert cargs[-2] == int(static_max)
    assert fn is wrapper and entry == f"{name}_launch"
    assert wrapper.launches == before + 1


def test_decode_wrappers_launch_past_the_row_sweeps_shared_memory(
        monkeypatch):
    """The split sweep keeps no per-key state in shared memory, so all
    three decode wrappers launch a row whose int8 q_int alone (group x
    max_len bytes) would not fit in a block's shared memory, as the
    one-block-per-row sweep they replaced kept it."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import decode
    calls = _record_launches(monkeypatch)
    nblk = decode.MAX_SMEM_BYTES // 8            # group 2 x 8-key blocks
    assert 2 * nblk * 8 > decode.MAX_SMEM_BYTES
    with FakeTensorMode(allow_non_fake_inputs=True):
        f32, i32 = torch.float32, torch.int32
        cuda = (lambda shape, dt=f32: torch.empty(shape, dtype=dt,
                                                  device="cuda"))
        q, pool = cuda((2, 4, 16)), cuda((5, 2, 8, 16))
        sc, th = cuda((4,)), cuda((4, 3), i32)
        table, lens = cuda((2, nblk), i32), cuda((2,), i32)
        arena = cuda((2, 2, nblk * 8, 16))
        for static_max in (False, True):
            kw = dict(static_max=static_max)
            decode.hccs_paged_decode(q, pool, pool, table, lens, sc, th,
                                     **kw)
            decode.hccs_packed_prefill(q, pool, pool, table, lens, lens, sc,
                                       th, **kw)
            decode.hccs_decode(q, arena, arena, lens, sc, th, **kw)
    assert [c[1] for c in calls] == 2 * ["hccs_paged_decode_launch",
                                         "hccs_packed_prefill_launch",
                                         "hccs_decode_launch"]


@pytest.mark.parametrize("tq,tk,causal,dtype,cached", [
    (8, 8, True, torch.float32, True),
    (64, 4096, True, torch.bfloat16, True),    # rows see 64 keys
    (64, 4096, False, torch.float32, False),   # past the q_int cache
    (4096, 4096, True, torch.bfloat16, False),
])
def test_fused_wrapper_hands_the_launch_its_shape_and_variant(
        tq, tk, causal, dtype, cached, monkeypatch):
    """On CUDA tensors (fake) hccs_mha_fused makes one C call with the
    shapes, dtype code, causal flag, the kernel's f32 sm_scale and the
    variant fused_plan picks for the shape, and counts one launch."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import attention
    calls = []

    def record(fn, entry, device, *args):
        calls.append((fn, entry, args))
        fn.launches += 1

    monkeypatch.setattr(attention.hccs_mha_fused, "launches",
                        attention.hccs_mha_fused.launches)
    monkeypatch.setattr(attention, "launch", record)
    before = attention.hccs_mha_fused.launches
    with FakeTensorMode(allow_non_fake_inputs=True):
        q = torch.empty((1, 4, tq, 16), dtype=dtype, device="cuda")
        k = torch.empty((1, 2, tk, 16), dtype=dtype, device="cuda")
        sc = torch.empty((4,), device="cuda")
        th = torch.empty((4, 3), dtype=torch.int32, device="cuda")
        out = attention.hccs_mha_fused(q, k, k, sc, th, causal=causal)
        assert out.shape == q.shape and out.dtype == dtype
    (fn, entry, args), = calls
    assert fn is attention.hccs_mha_fused and entry == "hccs_fused_launch"
    assert args[0] is q and args[1] is k and args[2] is k
    assert args[5] is out and args[6] is None
    cache, smem = attention.fused_plan(tq, tk, 16, q.element_size(), causal)
    assert smem <= attention.MAX_SMEM_BYTES
    assert args[7:] == (1, 4, 2, tq, tk, 16, attention.POOL_TYPES[dtype],
                        int(causal), attention.sm_scale(16), int(cache))
    assert cache == cached
    assert attention.hccs_mha_fused.launches == before + 1


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_fused_wrapper_takes_non_contiguous_inputs(device, monkeypatch):
    """hccs_attention accepts a (B, T, H, d) -> (B, H, T, d) transposed view
    on both devices: on the CPU it equals the contiguous call; on a CUDA
    tensor (fake, with a failing build) it reaches the launch rather than
    refusing the layout."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import build
    from repro_torch.kernels.ops import hccs_attention
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 8, h, 16), generator=g).transpose(1, 2)
               for h in (4, 2, 2))
    scale = torch.full((4,), 0.05)
    theta = torch.tensor([[159, 1, 64]] * 4, dtype=torch.int32)
    assert not q.is_contiguous()
    if device == "cpu":
        got = hccs_attention(q, k, v, scale, theta)
        want = hccs_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              scale, theta)
        assert torch.equal(got, want)
        return

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    def contiguous(self, memory_format=torch.contiguous_format):
        # a fake CUDA tensor's own contiguous() needs a CUDA build of torch
        return self if self.is_contiguous() else self.clone(
            memory_format=memory_format)

    monkeypatch.setattr(build, "load_library", no_nvcc)
    monkeypatch.setattr(torch.Tensor, "contiguous", contiguous)
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = [torch.empty((1, 8, h, 16), device="cuda").transpose(1, 2)
                for h in (4, 2, 2)]
        args += [torch.empty((4,), device="cuda"),
                 torch.empty((4, 3), dtype=torch.int32, device="cuda")]
        assert not args[0].is_contiguous()
        with pytest.raises(RuntimeError, match="nvcc"):
            hccs_attention(*args)


@pytest.mark.parametrize("name", ["ModelConfig", "ShapeConfig",
                                  "TrainConfig"])
def test_config_dataclasses_match(name):
    jcls, pcls = getattr(jax_base, name), getattr(port_base, name)
    jf, pf = dataclasses.fields(jcls), dataclasses.fields(pcls)
    assert [(f.name, f.type, f.default) for f in jf] == \
        [(f.name, f.type, f.default) for f in pf]


@pytest.mark.parametrize("bad", [
    dict(decode_kernel="x"), dict(cache_layout="x"), dict(block_size=12),
    dict(block_size=4), dict(cache_dtype="int8"), dict(kv_quant="x"),
    dict(draft_len=0), dict(speculative=True), dict(backpressure="x"),
    dict(queue_limit=-1), dict(preemption=True), dict(async_loop=True)])
def test_model_config_errors_match(bad):
    base = dict(name="t", family="dense", num_layers=2, d_model=64,
                num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256)
    msgs = []
    for cls in (jax_base.ModelConfig, port_base.ModelConfig):
        with pytest.raises(ValueError) as e:
            cls(**base, **bad)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("arch", jax_registry.ARCH_IDS)
def test_registry_matches(arch):
    assert port_registry.ARCH_IDS == jax_registry.ARCH_IDS
    for fn in ("get_config", "reduced_config"):
        j = getattr(jax_registry, fn)(arch)
        p = getattr(port_registry, fn)(arch)
        assert dataclasses.asdict(j) == dataclasses.asdict(p)
        assert (j.padded_vocab, j.d_inner, j.ssm_heads, j.is_moe) == \
            (p.padded_vocab, p.d_inner, p.ssm_heads, p.is_moe)
