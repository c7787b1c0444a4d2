"""The port's training substrates (repro_torch/checkpoint, optim, data,
train/loop.py) and its MoE and SSD layers (models/moe.py, models/ssm.py) —
twins of TestCheckpoint, TestMoE, TestSSD, TestOptim, TestData and
TestTrainLoop in tests/test_substrates.py — and their parity with the JAX
package: one AdamW step, the compression noise and its threefry streams,
the synthetic batches, checkpoints loaded across packages, MoE routing
(expert ids, keep masks, slots, output, aux) and the SSD's chunked and
recurrent forms with their gradients.
"""
import torch_threads  # noqa: F401  (first: one torch thread a worker)
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
from repro.models import moe as JMoE
from repro.models import ssm as JSSM
from repro.optim import adamw as jax_adamw
from repro.optim import compression as jax_compression
from repro.train import make_train_state as jax_make_train_state
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import config_hash
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.data import synthetic as D
from repro_torch.models import model as M
from repro_torch.models import moe as MoE
from repro_torch.models import ssm as SSM
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
        """The twin of test_elastic_restore_new_sharding. The name is kept
        from the slices that refused placement on a mesh; the restore now
        takes explicit shardings: on a (1, 1) mesh over a fake process
        group, "w" sharded over data restores as a DTensor equal to the
        saved array, and a None sharding (or none) as the plain tensor."""
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh
        from torch.testing._internal.distributed.fake_pg import FakeStore

        from repro_torch.parallel.sharding import NamedSharding
        tree = {"w": torch.arange(16.0).reshape(4, 4)}
        with tempfile.TemporaryDirectory() as d:
            mgr = CheckpointManager(d)
            mgr.save(1, tree)
            dist.init_process_group("fake", store=FakeStore(), rank=0,
                                    world_size=1)
            try:
                mesh = DeviceMesh("cpu", torch.zeros((1, 1), dtype=int),
                                  mesh_dim_names=("data", "model"))
                sh = {"w": NamedSharding.from_spec(mesh, ("data", None))}
                restored, _ = mgr.restore(tree, shardings=sh)
                np.testing.assert_array_equal(
                    restored["w"].full_tensor().numpy(), tree["w"].numpy())
                plain, _ = mgr.restore(tree, shardings={"w": None})
            finally:
                dist.destroy_process_group()
            assert type(plain["w"]) is torch.Tensor
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


# ------------------------------------------------------------------ MoE ---

# MoE against JAX on the same weights (f32): router probabilities within
# 3.0e-7 (softmax router; the HCCS router's are equal), outputs within
# 6.0e-7 and aux losses within 1.2e-7, measured on the cases below; the
# gates are 5x that. Expert ids, keep masks and slots were equal in every
# case (0 flips among 128-1024 routed entries, 19-120 rows with tied
# probabilities under the HCCS router): an id may differ only where the
# port's gap between consecutive top-(k+1) probabilities is below
# ROUTE_EPS (30x the probability drift), and such tokens are counted; a
# group with none compares its keep mask and slots bit for bit.
MOE_OUT_ATOL = 3e-6
MOE_AUX_RTOL = 6e-7
ROUTE_EPS = 1e-5


def _torch_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _jax_route(p, x, cfg):
    """The JAX module's routing steps (repro/models/moe.py:74-107), which
    apply_moe keeps internal: expert ids (G, M, K), keep mask and slots
    (G, M*K), and router probabilities."""
    b, t, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    G = JMoE._num_groups(cfg, b * t)
    m = b * t // G
    cap = max(int(m * k / e * cfg.moe_capacity_factor), 1)
    logits = x.reshape(G, m, d).astype(jnp.float32) @ p["router"]
    probs = JMoE._router_probs(p, logits, cfg)
    _, idx = jax.lax.top_k(probs, k)
    flat = idx.reshape(G, m * k)
    order = jnp.argsort(flat, axis=1, stable=True)
    sorted_e = jnp.take_along_axis(flat, order, axis=1)
    counts = jnp.zeros((G, e), jnp.int32).at[
        jnp.arange(G)[:, None], flat].add(1)
    starts = jnp.cumsum(counts, axis=1) - counts
    pos_sorted = (jnp.arange(m * k)[None] -
                  jnp.take_along_axis(starts, sorted_e, axis=1))
    pos = jnp.take_along_axis(pos_sorted, jnp.argsort(order, axis=1),
                              axis=1)
    return (np.asarray(idx), np.asarray(pos < cap),
            np.asarray(jnp.minimum(pos, cap - 1)), np.asarray(probs))


def _moe_case(**kw):
    cfg, jcfg = tiny(family="moe", **kw)
    p = JMoE.init_moe(jax.random.PRNGKey(0), jcfg)
    return cfg, jcfg, p, _torch_tree(p)


class TestMoE:
    def test_dispatch_combine_identity_single_expert(self):
        """E=1, K=1, ample capacity: MoE == plain FFN on every token."""
        cfg, jcfg, jp, p = _moe_case(num_experts=1, experts_per_token=1,
                                     moe_capacity_factor=2.0)
        x = torch.from_numpy(np.random.default_rng(0).normal(
            0, 1, (2, 8, 64)).astype(np.float32))
        out, aux = MoE.apply_moe(p, x, cfg)
        w = p["experts"]
        xf = x.reshape(-1, 64)
        h = torch.nn.functional.silu(xf @ w["w_gate"][0]) * (
            xf @ w["w_in"][0])
        want = (h @ w["w_out"][0]).reshape(2, 8, 64)
        np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=2e-4,
                                   atol=1e-5)
        jout, jaux = JMoE.apply_moe(jp, jnp.asarray(x.numpy()), jcfg)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout),
                                   atol=MOE_OUT_ATOL)
        np.testing.assert_allclose(float(aux), float(jaux),
                                   rtol=MOE_AUX_RTOL)

    def test_capacity_drops_overflow(self):
        cfg, jcfg, jp, p = _moe_case(num_experts=4, experts_per_token=1,
                                     moe_capacity_factor=0.25)
        x = np.random.default_rng(0).normal(0, 1, (2, 16, 64)).astype(
            np.float32)
        out, aux = MoE.apply_moe(p, torch.from_numpy(x), cfg)
        assert bool(torch.isfinite(out).all())
        # the dropped tokens' outputs are zero, as in JAX
        r = MoE.route(p, torch.from_numpy(x), cfg)
        dropped = ~r["keep"].reshape(-1)
        assert dropped.any()
        assert (out.reshape(-1, 64)[dropped] == 0).all()
        jout, _ = JMoE.apply_moe(jp, jnp.asarray(x), jcfg)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout),
                                   atol=MOE_OUT_ATOL)

    def test_hccs_router_ordering_matches_quantized_logits(self):
        """HCCS preserves the order of the quantized logits exactly (ties in
        the int8 grid are ties in HCCS too), so expert selection equals
        softmax-on-quantized-logits selection up to in-tie permutation."""
        from repro_torch.core.constraints import default_params
        from repro_torch.core.hccs import HCCSParams, hccs_qat
        rng = np.random.default_rng(2)
        logits = torch.from_numpy(rng.normal(0, 2, (32, 16)).astype(
            np.float32))
        scale = 0.05
        B, S, D = default_params(16)
        p = HCCSParams(B=torch.tensor(B, dtype=torch.int32),
                       S=torch.tensor(S, dtype=torch.int32),
                       D=torch.tensor(D, dtype=torch.int32))
        probs_h = hccs_qat(logits, scale, p, "i16_div").numpy()
        q = np.clip(np.round(logits.numpy() / scale), -128, 127)
        for row_p, row_q in zip(probs_h, q):
            # strictly larger quantized logit => prob >= (monotone)
            order = np.argsort(row_q, kind="stable")
            assert (np.diff(row_p[order]) >= -1e-9).all()
            # equal quantized logits => exactly equal probs (ties preserved)
            for val in np.unique(row_q):
                ps = row_p[row_q == val]
                assert np.allclose(ps, ps[0], atol=1e-9)

    def test_top_k_puts_the_lower_index_first_on_ties(self):
        """jax.lax.top_k's order on tied rows, which the HCCS router makes
        common."""
        rows = np.array([[0.25, 0.5, 0.25, 0.5, 0.0],
                         [0.1, 0.1, 0.1, 0.1, 0.1],
                         [0.0, 0.3, 0.3, 0.4, 0.0]], np.float32)
        vals, idx = MoE.top_k(torch.from_numpy(rows), 3)
        jvals, jidx = jax.lax.top_k(jnp.asarray(rows), 3)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))

    @pytest.mark.parametrize("kw", [
        dict(num_experts=8, experts_per_token=2),
        dict(num_experts=8, experts_per_token=2, moe_capacity_factor=0.5),
        dict(num_experts=8, experts_per_token=2, hccs_router=True),
        dict(num_experts=16, experts_per_token=4, hccs_router=True,
             hccs_mode="i16_div", moe_capacity_factor=0.75, moe_groups=2),
        dict(num_experts=32, experts_per_token=8, hccs_router=True),
    ], ids=["softmax", "drops", "hccs-router", "hccs-groups-drops",
            "hccs-32e-top8"])
    def test_apply_moe_matches_jax(self, kw):
        """Routing (ids, keep mask, slots), output and aux against JAX on
        the same weights, tied HCCS-router rows and capacity drops
        included."""
        cfg, jcfg, jp, p = _moe_case(**kw)
        x = np.random.default_rng(0).normal(0, 1, (4, 32, 64)).astype(
            np.float32)
        with torch.no_grad():
            out, aux = MoE.apply_moe(p, torch.from_numpy(x), cfg)
            r = MoE.route(p, torch.from_numpy(x), cfg)
        jout, jaux = JMoE.apply_moe(jp, jnp.asarray(x), jcfg)
        jidx, jkeep, jslot, jprobs = _jax_route(jp, jnp.asarray(x), jcfg)
        k = cfg.experts_per_token
        probs = r["probs"].numpy()
        np.testing.assert_allclose(probs, jprobs, atol=MOE_OUT_ATOL)
        top = -np.sort(-probs, axis=-1)[..., :k + 1]
        gaps = -np.diff(top, axis=-1)
        near = ((gaps > 0) & (gaps < ROUTE_EPS)).any(-1)     # (G, M)
        flips = (r["idx"].numpy() != jidx).any(-1)
        assert not (flips & ~near).any(), "an expert id flipped at a margin"
        assert flips.sum() == 0, f"{flips.sum()} near-tie flips"
        np.testing.assert_array_equal(r["keep"].numpy(), jkeep)
        np.testing.assert_array_equal(r["slot"].numpy(), jslot)
        assert not jkeep.all()                  # capacity drops ran
        if cfg.hccs_router:                     # and tied rows
            assert (gaps == 0).any()
        np.testing.assert_allclose(out.numpy(), np.asarray(jout),
                                   atol=MOE_OUT_ATOL)
        np.testing.assert_allclose(float(aux), float(jaux),
                                   rtol=MOE_AUX_RTOL)


# ------------------------------------------------------------------ SSD ---

# SSD against JAX on the same weights (f32, A_log and dt_bias drawn so the
# decays differ per head): outputs and final states within 1.4e-6 at chunk
# 4-5 (gate 1e-5), 4.4e-5 at chunk 256 (values up to ~1e2; gate 2e-4);
# the recurrent step within 1.5e-6; input gradients within 4.3e-6 (gate
# 2e-5). At chunk 64 both packages' gradients are NaN in the same entries:
# above the causal diagonal exp(seg) overflows to inf and the masked
# branch's zero cotangent times inf is NaN (repro/models/ssm.py:89-92).
SSD_ATOL = {4: 1e-5, 5: 1e-5, 64: 1e-4, 256: 2e-4}
SSD_GRAD_ATOL = 2e-5


def _ssd_case(T, **kw):
    cfg, jcfg = tiny(family="ssm", num_heads=0, num_kv_heads=0, d_ff=0,
                     ssm_state=8, ssm_head_dim=16, **kw)
    p = JSSM.init_ssm(jax.random.PRNGKey(0), jcfg)
    p = dict(p, A_log=jnp.asarray(np.random.default_rng(3).normal(
        0, 0.5, p["A_log"].shape), jnp.float32),
        dt_bias=jnp.asarray(np.random.default_rng(4).normal(
            0, 0.5, p["dt_bias"].shape), jnp.float32))
    x = np.random.default_rng(0).normal(0, 1, (2, T, 64)).astype(np.float32)
    return cfg, jcfg, p, _torch_tree(p), x


class TestSSD:
    def test_chunked_matches_recurrent(self):
        """The chunked SSD (training path) == step-by-step recurrence."""
        cfg, _ = tiny(family="ssm", num_heads=0, num_kv_heads=0, d_ff=0,
                      ssm_state=8, ssm_head_dim=16, ssm_chunk=4)
        p = SSM.init_ssm(torch.Generator().manual_seed(0), cfg,
                         torch.float32, "cpu", 1)
        p = {k: v[0] for k, v in p.items()}
        x = torch.from_numpy(np.random.default_rng(0).normal(
            0, 1, (2, 12, 64)).astype(np.float32))
        y_chunked, state_final = SSM.apply_ssd(p, x, cfg)
        state = torch.zeros((2, cfg.ssm_heads, cfg.ssm_state,
                             cfg.ssm_head_dim))
        ys = []
        for t in range(12):
            y_t, state = SSM.apply_ssd_step(p, x[:, t:t + 1], cfg, state)
            ys.append(y_t)
        y_rec = torch.cat(ys, dim=1)
        np.testing.assert_allclose(y_chunked.numpy(), y_rec.numpy(),
                                   atol=2e-4)
        np.testing.assert_allclose(state_final.numpy(), state.numpy(),
                                   atol=2e-4)

    @pytest.mark.slow
    def test_chunk_size_invariance(self):
        cfg4, _ = tiny(family="ssm", num_heads=0, num_kv_heads=0, d_ff=0,
                       ssm_state=8, ssm_head_dim=16, ssm_chunk=4)
        cfg6 = cfg4.replace(ssm_chunk=6)
        p = SSM.init_ssm(torch.Generator().manual_seed(0), cfg4,
                         torch.float32, "cpu", 1)
        p = {k: v[0] for k, v in p.items()}
        x = torch.from_numpy(np.random.default_rng(1).normal(
            0, 1, (1, 24, 64)).astype(np.float32))
        y4, s4 = SSM.apply_ssd(p, x, cfg4)
        y6, s6 = SSM.apply_ssd(p, x, cfg6)
        np.testing.assert_allclose(y4.numpy(), y6.numpy(), atol=2e-4)
        np.testing.assert_allclose(s4.numpy(), s6.numpy(), atol=2e-4)

    @pytest.mark.parametrize("T,kw", [
        (12, dict(ssm_chunk=4)), (13, dict(ssm_chunk=5, ssm_groups=2)),
        (256, dict(ssm_chunk=256))], ids=["chunk4", "chunk5-groups2",
                                          "chunk256"])
    def test_apply_ssd_and_step_match_jax(self, T, kw):
        """apply_ssd from a given state (a ragged last chunk, two B/C
        groups) and apply_ssd_step against JAX's."""
        cfg, jcfg, jp, p, x = _ssd_case(T, **kw)
        st0 = np.random.default_rng(1).normal(
            0, 1, (2, cfg.ssm_heads, 8, 16)).astype(np.float32)
        atol = SSD_ATOL[kw["ssm_chunk"]]
        with torch.no_grad():
            y, st = SSM.apply_ssd(p, torch.from_numpy(x), cfg,
                                  torch.from_numpy(st0))
            ys, sts = SSM.apply_ssd_step(p, torch.from_numpy(x[:, :1]), cfg,
                                         torch.from_numpy(st0))
        jy, jst = JSSM.apply_ssd(jp, jnp.asarray(x), jcfg, jnp.asarray(st0))
        jys, jsts = JSSM.apply_ssd_step(jp, jnp.asarray(x[:, :1]), jcfg,
                                        jnp.asarray(st0))
        assert st.dtype == sts.dtype == torch.float32
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=atol)
        np.testing.assert_allclose(st.numpy(), np.asarray(jst), atol=atol)
        np.testing.assert_allclose(ys.numpy(), np.asarray(jys), atol=1e-5)
        np.testing.assert_allclose(sts.numpy(), np.asarray(jsts), atol=1e-5)

    @pytest.mark.parametrize("T,chunk", [(12, 4), (64, 64)])
    def test_gradients_as_finite_as_jax(self, T, chunk):
        """Gradients of sum(apply_ssd) in x and in A_log: equal to JAX's
        where JAX's are finite, NaN exactly where JAX's are (the masked
        exp's overflow at chunk 64)."""
        cfg, jcfg, jp, p, x = _ssd_case(T, ssm_chunk=chunk)
        jg = jax.grad(lambda p_, x_: JSSM.apply_ssd(p_, x_, jcfg)[0].sum(),
                      argnums=(0, 1))(jp, jnp.asarray(x))
        pt = {k: v.clone().requires_grad_() for k, v in p.items()}
        xt = torch.from_numpy(x).requires_grad_()
        SSM.apply_ssd(pt, xt, cfg)[0].sum().backward()
        for got, want in ((xt.grad.numpy(), np.asarray(jg[1])),
                          (pt["A_log"].grad.numpy(),
                           np.asarray(jg[0]["A_log"]))):
            np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
            ok = ~np.isnan(want)
            np.testing.assert_allclose(got[ok], want[ok],
                                       atol=SSD_GRAD_ATOL, rtol=1e-5)
        assert np.isnan(np.asarray(jg[1])).any() == (chunk == 64)

    def test_softplus_is_jax_softplus(self):
        """jax.nn.softplus, logaddexp(x, 0) with no threshold (torch's
        F.softplus has one): equal within one f32 ulp (measured: one of
        these ten values an ulp apart, the frameworks' log1p/exp)."""
        x = np.array([-30.0, -1.0, 0.0, 1e-3, 5.0, 19.99, 20.0, 20.01, 35.0,
                      90.0], np.float32)
        got = SSM.softplus(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, np.asarray(jax.nn.softplus(
            jnp.asarray(x))), rtol=2.0 ** -23, atol=0)


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
