"""The port's training substrates (repro_torch/checkpoint, optim, data,
train/loop.py) — twins of TestCheckpoint, TestOptim, TestData and
TestTrainLoop in tests/test_substrates.py — and their parity with the JAX
package: one AdamW step, the compression noise and its threefry streams,
the synthetic batches, and checkpoints loaded across packages.
"""
import dataclasses
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.checkpoint.manager import config_hash as jax_config_hash
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.data import synthetic as JD
from repro.optim import adamw as jax_adamw
from repro.optim import compression as jax_compression
from repro.train import make_train_state as jax_make_train_state
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import config_hash
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.data import synthetic as D
from repro_torch.models import model as M
from repro_torch.optim import adamw, compression
from repro_torch.serve import prng
from repro_torch.train import (make_train_state, train_loop,
                               train_state_from_params)

CPU = "cpu"
# One AdamW step on the same params and grads against JAX's: the clip and
# the bias corrections are the same f32 expressions, but the global norm's
# sums run in another order, and XLA's pow and cos are not torch's: the
# cosine's cos lands an ulp away, which 1 + cos magnifies (lr 2.5e-7
# relative at step 40; near the end of the decay, where 1 + cos nearly
# cancels, 2.4e-5 relative but 1.1e-11 absolute at a base rate of 3e-4).
# A first moment where b1 * mu and (1 - b1) * g nearly cancel carries the
# clip's rounding at the size of its terms: 9.3e-10 absolute (1.9e-6
# relative) at step 40. The gates are 1e-6 relative, plus 2e-9 absolute on
# params and moments, and for the schedule alone 1e-7 of the base rate.
ADAMW_RTOL = 1e-6
ADAMW_ATOL = 2e-9
LR_ATOL_OF_BASE = 1e-7


def tiny(**kw):
    base = dict(name="t", family="dense", num_layers=2, d_model=64,
                num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
                vocab_pad_multiple=1)
    base.update(kw)
    return ModelConfig(**base), JaxModelConfig(**base)


def _leaves(tree):
    """{keystr: numpy} of a JAX tree."""
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_leaves(tree):
    from repro_torch.checkpoint.manager import _flatten, to_numpy
    return {k: to_numpy(v) for k, v in _flatten(tree).items()}


# ----------------------------------------------------------- checkpoint ---

class TestCheckpoint:
    def test_roundtrip_exact(self):
        cfg, _ = tiny()
        state = make_train_state(0, cfg, TrainConfig(), device=CPU)
        with tempfile.TemporaryDirectory() as d:
            mgr = CheckpointManager(d)
            mgr.save(7, state, cfg=cfg)
            fresh = make_train_state(1, cfg, TrainConfig(), device=CPU)
            restored, manifest = mgr.restore(fresh, cfg=cfg)
            assert manifest["step"] == 7
            a, b = _port_leaves(state), _port_leaves(restored)
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])

    def test_config_mismatch_rejected(self):
        cfg, _ = tiny()
        tree = {"w": torch.ones(4)}
        with tempfile.TemporaryDirectory() as d:
            mgr = CheckpointManager(d)
            mgr.save(1, tree, cfg=cfg)
            with pytest.raises(ValueError):
                mgr.restore(tree, cfg=tiny(d_model=128)[0])

    def test_latest_pointer_and_gc(self):
        tree = {"w": torch.ones(4)}
        with tempfile.TemporaryDirectory() as d:
            mgr = CheckpointManager(d, keep=2)
            for s in (1, 2, 3, 4):
                mgr.save(s, tree)
            assert mgr.latest_step() == 4
            kept = sorted(x for x in os.listdir(d) if x.startswith("step_"))
            assert len(kept) == 2

    def test_async_save(self):
        tree = {"w": torch.arange(8.0)}
        with tempfile.TemporaryDirectory() as d:
            mgr = CheckpointManager(d)
            mgr.save_async(3, tree)
            tree["w"].add_(1.0)          # the step after: updates in place
            mgr.wait()
            restored, _ = mgr.restore(tree)
            np.testing.assert_array_equal(restored["w"].numpy(),
                                          np.arange(8.0))

    def test_elastic_restore_new_sharding_is_refused(self):
        """Placement on a mesh is not ported (ROADMAP.md item A11)."""
        tree = {"w": torch.arange(16.0).reshape(4, 4)}
        with tempfile.TemporaryDirectory() as d:
            mgr = CheckpointManager(d)
            mgr.save(1, tree)
            with pytest.raises(NotImplementedError, match="A11"):
                mgr.restore(tree, shardings={"w": None})
            restored, _ = mgr.restore(tree)
            np.testing.assert_array_equal(restored["w"].numpy(),
                                          tree["w"].numpy())

    def test_shape_mismatch_raises(self):
        with tempfile.TemporaryDirectory() as d:
            mgr = CheckpointManager(d)
            mgr.save(1, {"w": torch.ones(4)})
            with pytest.raises(ValueError, match="does not fit"):
                mgr.restore({"w": torch.ones(5)})

    @pytest.mark.parametrize("compress", ["none", "int8"])
    def test_jax_checkpoint_restores_in_the_port(self, compress):
        """A JAX train state saved by the JAX manager loads into the port's
        state bit for bit (keys equal, leaves equal, the rng a uint32 leaf),
        and the port's save of it loads back into the JAX state."""
        cfg, jcfg = tiny()
        tcfg = TrainConfig(grad_compression=compress)
        jstate = jax_make_train_state(jax.random.PRNGKey(3), jcfg,
                                      JaxTrainConfig(grad_compression=compress))
        jstate = dict(jstate, rng=jax.random.PRNGKey(11))
        template = train_state_from_params(M.init_params(cfg, device=CPU),
                                           tcfg)
        assert config_hash(cfg) == jax_config_hash(jcfg)
        with tempfile.TemporaryDirectory() as d:
            JaxCheckpointManager(os.path.join(d, "j")).save(5, jstate,
                                                            cfg=jcfg)
            restored, manifest = CheckpointManager(
                os.path.join(d, "j")).restore(template, cfg=cfg)
            assert manifest["step"] == 5
            want, got = _leaves(jstate), _port_leaves(restored)
            assert want.keys() == got.keys()
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k])
            assert restored["rng"].dtype == torch.uint32
            CheckpointManager(os.path.join(d, "p")).save(6, restored,
                                                         cfg=cfg)
            back, manifest = JaxCheckpointManager(
                os.path.join(d, "p")).restore(jstate, cfg=jcfg)
            assert manifest["step"] == 6
            for k, v in _leaves(back).items():
                np.testing.assert_array_equal(v, want[k])

    def test_bf16_leaves_cross_load_as_raw_words(self):
        """bf16 leaves: JAX's np.savez writes ml_dtypes bfloat16 as raw
        2-byte words; the port reads them as torch.bfloat16 bit for bit and
        writes the same words (JAX's own manager cannot restore them:
        ROADMAP.md section C3)."""
        cfg, jcfg = tiny(dtype="bfloat16")
        jstate = jax_make_train_state(jax.random.PRNGKey(3), jcfg,
                                      JaxTrainConfig())
        template = make_train_state(0, cfg, TrainConfig(), device=CPU)
        with tempfile.TemporaryDirectory() as d:
            JaxCheckpointManager(os.path.join(d, "j")).save(1, jstate,
                                                            cfg=jcfg)
            restored, _ = CheckpointManager(os.path.join(d, "j")).restore(
                template, cfg=cfg)
            table = restored["params"]["weights"]["embed"]["table"]
            assert table.dtype == torch.bfloat16
            jt = np.asarray(jstate["params"]["weights"]["embed"]["table"])
            np.testing.assert_array_equal(table.float().numpy(),
                                          jt.astype(np.float32))
            CheckpointManager(os.path.join(d, "p")).save(1, restored,
                                                         cfg=cfg)
            with np.load(os.path.join(d, "j", "step_000000001",
                                      "arrays.npz")) as a, \
                    np.load(os.path.join(d, "p", "step_000000001",
                                         "arrays.npz")) as b:
                assert sorted(a.files) == sorted(b.files)
                for k in a.files:
                    assert a[k].dtype.itemsize == b[k].dtype.itemsize
                    assert a[k].tobytes() == b[k].tobytes(), k


# ------------------------------------------------------- optim/compress ---

class TestOptim:
    def test_adamw_decreases_quadratic(self):
        tcfg = TrainConfig(learning_rate=0.1, warmup_steps=0,
                           total_steps=100, weight_decay=0.0)
        params = {"w": torch.tensor([3.0, -2.0])}
        state = adamw.init(params)
        for _ in range(60):
            g = {"w": 2 * params["w"]}
            params, state, _ = adamw.apply_updates(params, g, state, tcfg)
        assert float(params["w"].abs().max()) < 0.5

    def test_grad_clip(self):
        tcfg = TrainConfig(learning_rate=0.0, grad_clip=1.0)
        params = {"w": torch.zeros(3)}
        state = adamw.init(params)
        _, _, stats = adamw.apply_updates(params, {"w": torch.full((3,),
                                                                   100.0)},
                                          state, tcfg)
        assert float(stats["grad_norm"]) > 100

    def test_compression_error_feedback_unbiased(self):
        """With EF, the running sum of dequantized grads tracks the true
        sum."""
        rng = np.random.default_rng(0)
        g_true = torch.from_numpy(rng.normal(0, 1, (64,)).astype(np.float32))
        err = None
        acc = torch.zeros(64)
        key = prng.prng_key(0)
        for _ in range(50):
            key, sub = prng.split(key)
            deq, err = compression.compress_grads({"g": g_true.clone()},
                                                  err, sub)
            acc = acc + deq["g"]
        rel = float(torch.linalg.norm(acc / 50 - g_true)
                    / torch.linalg.norm(g_true))
        assert rel < 0.05

    @pytest.mark.parametrize("step", [0, 3, 40])
    def test_adamw_step_matches_jax(self, step):
        rng = np.random.default_rng(step)
        shapes = {"a": (7, 5), "b": {"c": (33,), "d": (2, 3, 4)}}
        mk = (lambda s, sc: rng.normal(0, sc, s).astype(np.float32))
        p = jax.tree.map(lambda s: mk(s, 1.0), shapes,
                         is_leaf=lambda x: isinstance(x, tuple))
        g = jax.tree.map(lambda s: mk(s, 0.3), shapes,
                         is_leaf=lambda x: isinstance(x, tuple))
        mu = jax.tree.map(lambda s: mk(s, 0.01), shapes,
                          is_leaf=lambda x: isinstance(x, tuple))
        nu = jax.tree.map(lambda s: np.abs(mk(s, 0.01)), shapes,
                          is_leaf=lambda x: isinstance(x, tuple))
        tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=5,
                           total_steps=50, grad_clip=0.5)
        jt = jax.tree.map(jnp.asarray, (p, g, mu, nu))
        jstate = jax_adamw.AdamWState(step=jnp.int32(step), mu=jt[2],
                                      nu=jt[3])
        jp, js, jstats = jax_adamw.apply_updates(
            jt[0], jt[1], jstate, JaxTrainConfig(**dataclasses.asdict(tcfg)))
        tt = [adamw.tree_map(torch.from_numpy, t) for t in (p, g, mu, nu)]
        for slice_elems in (adamw.SLICE_ELEMS, 10):
            args = [adamw.tree_map(torch.clone, t) for t in tt]
            state = adamw.AdamWState(step=torch.tensor(step,
                                                       dtype=torch.int32),
                                     mu=args[2], nu=args[3])
            old = adamw.SLICE_ELEMS
            adamw.SLICE_ELEMS = slice_elems
            try:
                pp, ps, stats = adamw.apply_updates(args[0], args[1], state,
                                                    tcfg)
            finally:
                adamw.SLICE_ELEMS = old
            assert int(ps.step) == step + 1
            np.testing.assert_allclose(stats["lr"].numpy(),
                                       np.asarray(jstats["lr"]),
                                       rtol=ADAMW_RTOL)
            np.testing.assert_allclose(stats["grad_norm"].numpy(),
                                       np.asarray(jstats["grad_norm"]),
                                       rtol=ADAMW_RTOL)
            for got, want in ((pp, jp), (ps.mu, js.mu), (ps.nu, js.nu)):
                for k, v in _leaves(want).items():
                    leaf = got
                    for part in k.strip("[']").split("']['"):
                        leaf = leaf[part]
                    np.testing.assert_allclose(leaf.numpy(), v,
                                               rtol=ADAMW_RTOL,
                                               atol=ADAMW_ATOL)
            # in place, as the JAX step donates its state
            assert pp["a"] is args[0]["a"] and ps.mu["a"] is args[2]["a"]
            assert ps.step is state.step

    def test_cosine_schedule_matches_jax(self):
        steps = torch.arange(0, 120, dtype=torch.int32)
        for base, warm, total in ((3e-4, 10, 100), (1e-2, 0, 50)):
            got = torch.stack([adamw.cosine_lr(s, base, warm, total)
                               for s in steps]).numpy()
            want = np.asarray(jax.vmap(lambda s: jax_adamw.cosine_lr(
                s, base, warm, total))(jnp.arange(0, 120, dtype=jnp.int32)))
            np.testing.assert_allclose(got, want, rtol=ADAMW_RTOL,
                                       atol=LR_ATOL_OF_BASE * base)

    def test_slices_keep_every_element(self):
        """The in-place update's slices cover a large leaf exactly once."""
        t = torch.zeros(5, 3, 4)
        old = adamw.SLICE_ELEMS
        adamw.SLICE_ELEMS = 24
        try:
            parts = adamw._slices(t)
        finally:
            adamw.SLICE_ELEMS = old
        assert [p.shape[0] for p in parts] == [2, 2, 1]
        for i, p in enumerate(parts):
            p.fill_(i + 1)
        assert (t > 0).all()


class TestCompressionParity:
    def test_split_and_uniform_bit_equal(self):
        for seed in (0, 7, 2**32 - 1):
            key = jax.random.PRNGKey(seed)
            want = np.asarray(jax.random.split(key, 5))
            got = np.asarray(prng.split(prng.prng_key(seed), 5))
            np.testing.assert_array_equal(got, want)
            sub = want[3]
            u = np.asarray(jax.random.uniform(jnp.asarray(sub, jnp.uint32),
                                              (6, 7, 9), minval=-0.5,
                                              maxval=0.5)).ravel()
            keys = torch.tensor([int(v) for v in sub], dtype=torch.int64)
            whole = prng.uniform_range(keys, u.size, -0.5, 0.5).numpy()
            parts = np.concatenate([
                prng.uniform_range(keys, 100, -0.5, 0.5).numpy(),
                prng.uniform_range(keys, u.size - 100, -0.5, 0.5,
                                   start=100).numpy()])
            np.testing.assert_array_equal(whole.view(np.uint32),
                                          u.view(np.uint32))
            np.testing.assert_array_equal(parts, whole)

    @pytest.mark.parametrize("with_error", [False, True])
    def test_compress_grads_bit_equal(self, with_error):
        """The same grads, residuals and key: the dequantized grads and the
        new residuals equal JAX's bit for bit, drawn in pieces or not."""
        rng = np.random.default_rng(5)
        g = {"b": rng.normal(0, 1, (9, 17)).astype(np.float32),
             "a": {"w": rng.normal(0, 3, (4, 33)).astype(np.float32)}}
        e = (jax.tree.map(lambda x: rng.normal(0, 0.01, x.shape)
                          .astype(np.float32), g) if with_error else None)
        key = jax.random.PRNGKey(42)
        jdeq, jerr = jax_compression.compress_grads(
            jax.tree.map(jnp.asarray, g),
            None if e is None else jax.tree.map(jnp.asarray, e), key)
        old = compression.CHUNK
        for chunk in (old, 50):
            fresh = (lambda t: adamw.tree_map(
                lambda a: torch.from_numpy(a.copy()), t))
            tg, te = fresh(g), None if e is None else fresh(e)
            compression.CHUNK = chunk
            try:
                deq, err = compression.compress_grads(tg, te, (0, 42))
            finally:
                compression.CHUNK = old
            for got, want in ((deq, jdeq), (err, jerr)):
                np.testing.assert_array_equal(got["b"].numpy(),
                                              np.asarray(want["b"]))
                np.testing.assert_array_equal(got["a"]["w"].numpy(),
                                              np.asarray(want["a"]["w"]))

    def test_compress_in_place_and_bf16(self):
        """The results are written into the given grads and residuals; a
        bf16 grad comes back bf16 with f32 residuals, as JAX's."""
        rng = np.random.default_rng(8)
        g = rng.normal(0, 1, (5, 6)).astype(np.float32)
        jdeq, jerr = jax_compression.compress_grads(
            {"w": jnp.asarray(g, jnp.bfloat16)}, None, jax.random.PRNGKey(1))
        tg = {"w": torch.from_numpy(g).to(torch.bfloat16)}
        te = compression.init_error(tg)
        deq, err = compression.compress_grads(tg, te, (0, 1))
        assert deq["w"] is tg["w"] and err["w"] is te["w"]
        assert deq["w"].dtype == torch.bfloat16
        assert err["w"].dtype == torch.float32
        np.testing.assert_array_equal(
            deq["w"].float().numpy(), np.asarray(jdeq["w"], np.float32))
        np.testing.assert_array_equal(err["w"].numpy(),
                                      np.asarray(jerr["w"]))


# ------------------------------------------------------------- data ---

class TestData:
    def test_deterministic_across_restarts(self):
        c = D.LMStreamConfig(vocab_size=128, seq_len=16, global_batch=4,
                             seed=1)
        a = D.LMStream(c).batch_at(7)
        b = D.LMStream(c).batch_at(7)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])

    def test_sharding_partitions_batch(self):
        c = D.LMStreamConfig(vocab_size=128, seq_len=16, global_batch=4,
                             seed=1)
        s0 = D.LMStream(c, shard=0, num_shards=2).batch_at(3)
        s1 = D.LMStream(c, shard=1, num_shards=2).batch_at(3)
        assert s0["tokens"].shape == (2, 16)
        assert not np.array_equal(s0["tokens"], s1["tokens"])

    def test_cls_task_learnable_signal(self):
        task = D.ClsTask(D.ClsTaskConfig(vocab_size=1000, seq_len=32, seed=0))
        b = task.batch_at(0, 64)
        assert set(np.unique(b["cls_labels"])) <= {0, 1}
        v = task.batch_at(0, 64, split="val")
        assert not np.array_equal(b["tokens"], v["tokens"])

    @pytest.mark.parametrize("shard", [0, 1])
    def test_lm_stream_bit_equal(self, shard):
        kw = dict(vocab_size=49155, seq_len=40, global_batch=4, seed=3)
        for step in (0, 5):
            got = D.LMStream(D.LMStreamConfig(**kw), shard, 2).batch_at(step)
            want = JD.LMStream(JD.LMStreamConfig(**kw), shard,
                               2).batch_at(step)
            for k in ("tokens", "labels"):
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])

    @pytest.mark.parametrize("relational,pair", [(False, False),
                                                 (True, True)])
    def test_cls_task_bit_equal(self, relational, pair):
        kw = dict(vocab_size=1000, seq_len=33, num_classes=3, seed=2,
                  relational=relational, pair=pair)
        for split in ("train", "val"):
            got = D.ClsTask(D.ClsTaskConfig(**kw)).batch_at(4, 16, split)
            want = JD.ClsTask(JD.ClsTaskConfig(**kw)).batch_at(4, 16, split)
            for k in ("tokens", "cls_labels"):
                np.testing.assert_array_equal(got[k], want[k])

    def test_embedding_batch_bit_equal(self):
        got = D.make_embedding_batch(np.random.default_rng(1), 2, 5, 8, 50)
        want = JD.make_embedding_batch(np.random.default_rng(1), 2, 5, 8, 50)
        for k in ("embeddings", "labels"):
            np.testing.assert_array_equal(got[k], want[k])


# -------------------------------------------------------------- loop ---

class TestTrainLoop:
    def test_straggler_monitor(self):
        from repro_torch.train.loop import StepTimeMonitor
        mon = StepTimeMonitor(k_sigma=3.0)
        for i in range(20):
            mon.observe(i, 0.01 + 0.0001 * (i % 3))
        assert mon.observe(20, 0.5)          # 50x slower step flagged
        assert mon.stragglers[-1][0] == 20

    def test_nan_circuit_breaker(self):
        calls = {"n": 0}

        def bad_step(state, batch):
            calls["n"] += 1
            return state, {"loss": torch.tensor(float("nan"))}

        state, hist = train_loop({}, bad_step, lambda s: {}, total_steps=10,
                                 log_every=0)
        assert calls["n"] == 1               # aborted immediately

    def test_preemption_signal_saves_and_stops(self):
        """SIGTERM during a step (handlers installed) ends the loop after
        that step with a blocking save; the old handler is restored."""
        import signal
        before = signal.getsignal(signal.SIGTERM)

        def step(state, batch):
            if batch == 1:
                os.kill(os.getpid(), signal.SIGTERM)
            return {"w": state["w"] + 1.0}, {"loss": torch.tensor(1.0)}

        with tempfile.TemporaryDirectory() as d:
            logs = []
            state, hist = train_loop({"w": torch.zeros(1)}, step,
                                     lambda s: s, total_steps=10, ckpt_dir=d,
                                     log_fn=logs.append, log_every=0,
                                     install_signal_handlers=True)
            assert [h["step"] for h in hist] == [0, 1]
            assert CheckpointManager(d).latest_step() == 2
            assert any("[preempt]" in m for m in logs)
        assert signal.getsignal(signal.SIGTERM) == before

    def test_cadence_and_final_save(self):
        """Saves every ckpt_every steps and once more at the end; a rerun
        resumes from LATEST and runs only the remaining steps."""
        logs = []

        def step(state, batch):
            state = {"w": state["w"] + 1.0}
            return state, {"loss": state["w"].sum()}

        with tempfile.TemporaryDirectory() as d:
            state, hist = train_loop({"w": torch.zeros(2)}, step,
                                     lambda s: None, total_steps=5,
                                     ckpt_dir=d, ckpt_every=2, log_every=0)
            assert [h["step"] for h in hist] == [0, 1, 2, 3, 4]
            assert CheckpointManager(d).latest_step() == 5
            assert sorted(x for x in os.listdir(d)
                          if x.startswith("step_"))[-3:] == [
                "step_000000002", "step_000000004", "step_000000005"]
            state, hist = train_loop({"w": torch.zeros(2)}, step,
                                     lambda s: None, total_steps=7,
                                     ckpt_dir=d, log_fn=logs.append,
                                     log_every=0)
            assert [h["step"] for h in hist] == [5, 6]
            assert float(state["w"][0]) == 7.0
            assert any("[resume] restored step 5" in m for m in logs)
