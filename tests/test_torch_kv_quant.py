"""The port's int8 paged KV (`repro_torch/quant/int8.py`,
`repro_torch/kernels/kv_quant.py`, the int8 pools of `serve/paged.py`)
against the JAX package: the twin of tests/test_kv_quant.py.

The same numpy-seeded inputs go through both packages. Gates:
  * rounding, quantize / dequantize / fake_quant: bit-identical to the JAX
    functions and to the pinned tie values;
  * the fold: the plain version `paged_quant_scatter_ref` bit-identical to
    JAX `paged_quant_scatter` (pools and scales), to the numpy model, across
    any step partition, with growth from zero scales and `draft_rows`; and
    a numpy emulation of the CUDA kernel's algorithm (csrc/kv_quant.cu)
    bit-identical to the JAX fold;
  * engines on the tiny config: greedy tokens, step counts, block tables and
    prefix_stats equal to the JAX engines' (token identity; no greedy token
    moved in any comparison), and the port's own identities token for
    token: packed == lockstep, sharing on == off, kernel on == off, a reused
    engine == a fresh one;
  * int8 against f32 KV: the JAX package's measured drift gate (exact-match
    >= 0.90, logit MAE mean <= 0.08, step max <= 0.5), on the port;
  * byte accounting: exact integers.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro.models.attention import paged_quant_scatter as jax_fold
from repro.quant import int8 as jq
from repro.serve import PagedEngine as JPaged
from repro.serve import Request as JRequest
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.kv_quant import (KV_QUANT_EPS, KV_QUANT_INV_QMAX,
                                          paged_quant_scatter,
                                          paged_quant_scatter_ref)
from repro_torch.models import model as M
from repro_torch.quant import int8 as pq
from repro_torch.serve import ContinuousEngine, PagedEngine, Request, \
    ServeEngine
from repro_torch.serve.engine import kv_cache_byte_stats
from repro_torch.serve.paged import _copy_block_kv, init_paged_cache


@pytest.fixture
def served(tiny_cfg):
    """The JAX config and params, and the port's twins."""
    def make(**kw):
        cfg = tiny_cfg(attention_prob="hccs", hccs_mode="i16_div", **kw)
        params = JM.init_params(jax.random.PRNGKey(0), cfg)
        pcfg = ModelConfig(**dataclasses.asdict(cfg))
        pparams = M.params_from_jax(jax.tree.map(np.asarray, params), pcfg,
                                    device="cpu")
        return cfg, params, pcfg, pparams
    return make


def _requests(rng, n, lens=(5, 9, 13, 21, 34), max_new=8):
    return [(i, rng.integers(0, 256, int(rng.choice(lens))).astype(np.int32),
             max_new) for i in range(n)]


def _serve(engine, reqs, cls=Request):
    for uid, prompt, m in reqs:
        engine.submit(cls(uid=uid, prompt=prompt.copy(), max_new_tokens=m))
    return {r.uid: list(r.out_tokens) for r in engine.run()}


KW = dict(max_batch=4, max_len=64, block_size=16)


# ----------------------------------------------------------- rounding mode --

class TestRoundingMode:
    """Ties: half away from zero (the paper's MAC rounder) by default,
    half to even on request; both bit-identical to the JAX package's."""

    @pytest.mark.parametrize("mode,want", [
        ("half_away", [1.0, -1.0, 2.0, -2.0, 3.0, -3.0, 0.0, -0.0]),
        ("nearest_even", [0.0, -0.0, 2.0, -2.0, 2.0, -2.0, 0.0, -0.0])])
    def test_ties(self, mode, want):
        x = np.array([0.5, -0.5, 1.5, -1.5, 2.5, -2.5, 0.49, -0.49],
                     np.float32)
        got = pq.round_to_int(torch.tensor(x), mode).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, np.asarray(jq.round_to_int(jnp.asarray(x), mode)))

    def test_modes_disagree_exactly_on_even_ties(self):
        x = torch.arange(0.5, 10.0, 1.0)
        away = pq.round_to_int(x, "half_away")
        even = pq.round_to_int(x, "nearest_even")
        np.testing.assert_array_equal((away != even).numpy(),
                                      (np.arange(10) % 2) == 0)

    def test_quantize_clips_and_rounds(self):
        x = np.array([0.05, -0.05, 20.0, -20.0], np.float32)
        q = pq.quantize(torch.tensor(x), torch.tensor(0.1))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), [1, -1, 127, -128])
        np.testing.assert_array_equal(
            q.numpy(), np.asarray(jq.quantize(jnp.asarray(x),
                                              jnp.float32(0.1))))

    def test_quantize_rejects_unknown_mode(self):
        with pytest.raises(ValueError, match="rounding"):
            pq.round_to_int(torch.zeros(1), "stochastic")

    def test_dequantize_roundtrip_error_bound(self, rng):
        x = rng.normal(size=256).astype(np.float32)
        s = np.float32(np.abs(x).max() / 127.0)
        got = pq.dequantize(pq.quantize(torch.tensor(x), torch.tensor(s)),
                            torch.tensor(s)).numpy()
        assert np.abs(got - x).max() <= 0.5 * float(s) + 1e-7
        np.testing.assert_array_equal(got, np.asarray(jq.dequantize(
            jq.quantize(jnp.asarray(x), s), s)))

    def test_fake_quant_matches_quant_dequant_and_passes_gradients(self,
                                                                   rng):
        x = torch.tensor(rng.normal(size=64).astype(np.float32),
                         requires_grad=True)
        s = torch.tensor(0.03)
        y = pq.fake_quant(x, s)
        np.testing.assert_array_equal(
            y.detach().numpy(), pq.dequantize(pq.quantize(x.detach(), s),
                                              s).numpy())
        np.testing.assert_array_equal(
            y.detach().numpy(),
            np.asarray(jq.fake_quant(jnp.asarray(x.detach().numpy()),
                                     jnp.float32(0.03))))
        y.sum().backward()                    # straight through
        np.testing.assert_array_equal(x.grad.numpy(), np.ones(64))

    def test_weight_helpers_match_jax(self, rng):
        w = rng.normal(size=(2, 8, 6)).astype(np.float32)
        np.testing.assert_array_equal(pq.per_channel_scale(w, 1),
                                      jq.per_channel_scale(w, 1))
        tree = {"a": torch.tensor(w), "b": {"c": torch.tensor(w[0, 0])}}
        got = pq.quantize_weights_tree(tree)
        want = jq.quantize_weights_tree({"a": jnp.asarray(w),
                                         "b": {"c": jnp.asarray(w[0, 0])}})
        np.testing.assert_array_equal(got["a"].numpy(), np.asarray(want["a"]))
        np.testing.assert_array_equal(got["b"]["c"].numpy(), w[0, 0])


# ------------------------------------------------------------ per-row fold --

def _np_half_away(x):
    return np.sign(x) * np.floor(np.abs(x) + np.float32(0.5))


def _np_fold(pool, scales, rows, positions):
    """The numpy model of the fold, float32 throughout."""
    n, hkv, bs, hd = pool.shape
    pool = pool.astype(np.float32).copy()
    scales = scales.astype(np.float32).copy()
    for x, p in zip(rows, positions):
        blk, r = int(p) // bs, int(p) % bs
        x = x.astype(np.float32)
        s_new = np.maximum(scales[blk],
                           np.maximum(np.abs(x).max(-1),
                                      np.float32(KV_QUANT_EPS))
                           * KV_QUANT_INV_QMAX)
        ratio = (scales[blk] / s_new).astype(np.float32)
        payload = np.clip(_np_half_away(pool[blk] * ratio[:, None, None]),
                          -128, 127)
        payload[:, r, :] = np.clip(_np_half_away(x / s_new[:, None]),
                                   -128, 127)
        pool[blk] = payload
        scales[blk] = s_new
    return pool.astype(np.int8), scales


def _both_folds(pool, scales, new_kv, wp, draft=None, splits=None):
    """JAX paged_quant_scatter and the port's plain version on the same
    numpy inputs, the port's over the write split into `splits` groups of
    lanes. Returns ((jax pool, scales), (port pool, scales))."""
    jp, js = jax_fold(jnp.asarray(pool), jnp.asarray(scales),
                      jnp.asarray(new_kv), jnp.asarray(wp),
                      draft_rows=None if draft is None else jnp.asarray(draft))
    tp, ts = torch.tensor(pool), torch.tensor(scales)
    t = wp.shape[1]
    cuts = [0] + list(np.cumsum(splits or [t]))
    for a, b in zip(cuts[:-1], cuts[1:]):
        out = paged_quant_scatter(
            tp, ts, torch.tensor(new_kv[:, :, a:b]), torch.tensor(wp[:, a:b]),
            None if draft is None else torch.tensor(draft[:, a:b]))
        assert out[0] is tp and out[1] is ts          # in place
    return (np.asarray(jp), np.asarray(js)), (tp.numpy(), ts.numpy())


class TestQuantScatterFold:
    N, HKV, BS, HD = 3, 2, 4, 5

    def _rows(self, rng, t, scale=1.0):
        return rng.normal(scale=scale,
                          size=(1, self.HKV, t, self.HD)).astype(np.float32)

    def _zero_state(self):
        return (np.zeros((self.N, self.HKV, self.BS, self.HD), np.int8),
                np.zeros((self.N, self.HKV), np.float32))

    def test_matches_jax_and_numpy_bit_exact(self, rng):
        t = 2 * self.BS
        rows = self._rows(rng, t)
        wp = np.arange(t, dtype=np.int32)[None]
        (jp, js), (tp, ts) = _both_folds(*self._zero_state(), rows, wp)
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(ts, js)
        np_, ns = _np_fold(*self._zero_state(),
                           list(rows[0].transpose(1, 0, 2)), wp[0])
        np.testing.assert_array_equal(tp, np_)
        np.testing.assert_array_equal(ts, ns)

    @pytest.mark.parametrize("splits", [[1] * 8, [3, 5], [4, 4], [2, 5, 1]])
    def test_partition_independent(self, rng, splits):
        rows = self._rows(rng, 8)
        wp = np.arange(8, dtype=np.int32)[None]
        (jp, js), (tp, ts) = _both_folds(*self._zero_state(), rows, wp,
                                         splits=splits)
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(ts, js)

    def test_scales_grow_monotonically(self, rng):
        pool, scales = map(torch.tensor, self._zero_state())
        prev = torch.zeros_like(scales)
        rows = self._rows(rng, self.BS, scale=3.0)
        for i in range(self.BS):
            paged_quant_scatter(pool, scales,
                                torch.tensor(rows[:, :, i:i + 1]),
                                torch.tensor([[i]], dtype=torch.int32))
            assert (scales >= prev).all()
            prev = scales.clone()

    def test_requant_keeps_rows_representable(self, rng):
        rows = self._rows(rng, self.BS)
        rows[:, :, -1] *= 50.0                # late row forces a big rescale
        pool, scales = map(torch.tensor, self._zero_state())
        for i in range(self.BS):
            paged_quant_scatter(pool, scales,
                                torch.tensor(rows[:, :, i:i + 1]),
                                torch.tensor([[i]], dtype=torch.int32))
        deq = pool[0].float().numpy() * scales[0].numpy()[:, None, None]
        bound = 0.5 * scales[0].numpy()[:, None, None] + 1e-6
        assert (np.abs(deq - rows[0]) <= 4 * bound).all()

    def test_zero_scale_block_payload_reset(self):
        """A fresh block (scale 0) over stale bytes: ratio 0 zeroes it."""
        pool = np.full((self.N, self.HKV, self.BS, self.HD), 77, np.int8)
        scales = np.zeros((self.N, self.HKV), np.float32)
        row = np.ones((1, self.HKV, 1, self.HD), np.float32)
        (jp, js), (tp, ts) = _both_folds(
            pool, scales, row, np.array([[self.BS]], np.int32))
        np.testing.assert_array_equal(tp, jp)
        assert (tp[1, :, 1:] == 0).all()
        assert (tp[1, :, 0] == 127).all() and (tp[0] == 77).all()

    @pytest.mark.parametrize("seed", range(6))
    def test_draft_rows_collisions_and_stale_scales(self, seed):
        """Random targets (several rows into one position, out of order),
        stale bytes, a mix of zero and set scales, clamped draft rows."""
        rng = np.random.default_rng(seed)
        pool = rng.integers(-128, 128, (5, 2, 4, 6)).astype(np.int8)
        scales = np.where(rng.random((5, 2)) < 0.5, 0,
                          rng.uniform(1e-3, 0.1, (5, 2))).astype(np.float32)
        rows = (rng.normal(size=(2, 2, 7, 6))
                * rng.choice([1e-9, 0.01, 1, 30])).astype(np.float32)
        wp = rng.integers(0, 20, (2, 7)).astype(np.int32)
        draft = rng.random((2, 7)) < 0.3 if seed % 2 else None
        (jp, js), (tp, ts) = _both_folds(pool, scales, rows, wp, draft)
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(ts, js)


def _emulate_kernel(pool, scales, rows, pos, draft=None):
    """csrc/kv_quant.cu's algorithm in numpy, step for step: per (block, kv
    head) of the step, its rows in order, their candidate scales, the scalar
    scale recurrence with its growth events, each position's last writer,
    and every payload element computed on its own (its last write, then the
    later events' requants)."""
    f32 = np.float32

    def rc(v):
        r = np.floor(np.abs(v).astype(f32) + f32(0.5)).astype(f32)
        return np.clip(np.where(v < 0, -r, np.where(v > 0, r, f32(0))),
                       -128, 127).astype(f32)
    pool, scales = pool.copy(), scales.copy()
    n, hkv, bs, d = pool.shape
    for j in range(len(pos)):
        blk = pos[j] // bs
        if any(pos[i] // bs == blk for i in range(j)):
            continue                          # not the block's first row
        ridx = [i for i in range(j, len(pos)) if pos[i] // bs == blk]
        for kv in range(hkv):
            last = [-1] * bs
            s, events, sc = f32(scales[blk, kv]), [], []
            for m, i in enumerate(ridx):
                c = f32(f32(max(f32(np.abs(rows[i, kv]).max()),
                                f32(KV_QUANT_EPS))) * KV_QUANT_INV_QMAX)
                last[pos[i] - blk * bs] = m
                s_new = s if (draft is not None and draft[i] and s > 0) \
                    else f32(max(s, c))
                if s_new != s:
                    events.append((m, f32(s / s_new)))
                sc.append(s_new)
                s = s_new
            payload = pool[blk, kv].astype(f32)
            for p in range(bs):
                m = last[p]
                v = (rc((rows[ridx[m], kv] / sc[m]).astype(f32)) if m >= 0
                     else payload[p])
                for k, ratio in events:
                    if k > m:
                        v = rc((v * ratio).astype(f32))
                pool[blk, kv, p] = v.astype(np.int8)
            scales[blk, kv] = s
    return pool, scales


@pytest.mark.parametrize("seed", range(8))
def test_cuda_kernel_algorithm_matches_jax_fold(seed):
    """The CUDA kernel cannot run here: its algorithm, emulated in numpy,
    equals the JAX fold bit for bit (collisions, trash-style repeats, fresh
    and stale blocks, draft rows, values at the eps floor)."""
    rng = np.random.default_rng(100 + seed)
    pool = rng.integers(-128, 128, (6, 2, 4, 5)).astype(np.int8)
    scales = np.where(rng.random((6, 2)) < 0.4, 0,
                      rng.uniform(1e-3, 0.2, (6, 2))).astype(np.float32)
    r = int(rng.integers(1, 30))
    rows = (rng.normal(size=(r, 2, 5)) * rng.choice(
        [1e-9, 0.01, 1, 40], size=(r, 1, 1))).astype(np.float32)
    pos = rng.integers(0, 24, r).astype(np.int32)
    if seed % 2:
        pos = np.sort(pos)
    draft = rng.random(r) < 0.3 if seed % 4 == 1 else None
    got = _emulate_kernel(pool, scales, rows, pos, draft)
    jp, js = jax_fold(jnp.asarray(pool), jnp.asarray(scales),
                      jnp.asarray(rows.transpose(1, 0, 2)[None]),
                      jnp.asarray(pos[None]),
                      draft_rows=None if draft is None
                      else jnp.asarray(draft[None]))
    np.testing.assert_array_equal(got[0], np.asarray(jp))
    np.testing.assert_array_equal(got[1], np.asarray(js))


def test_fold_wrapper_checks_and_counts_no_cpu_launch():
    pool = torch.zeros((3, 2, 4, 5), dtype=torch.int8)
    scales = torch.zeros((3, 2))
    kv = torch.ones((1, 2, 3, 5))
    wp = torch.tensor([[0, 1, 2]], dtype=torch.int32)
    paged_quant_scatter(pool, scales, kv.bfloat16(), wp)
    assert paged_quant_scatter.launches == 0
    with pytest.raises(ValueError, match="int8"):
        paged_quant_scatter(pool.float(), scales, kv, wp)
    with pytest.raises(ValueError, match="scales"):
        paged_quant_scatter(pool, scales[:2], kv, wp)
    with pytest.raises(ValueError, match="write_pos"):
        paged_quant_scatter(pool, scales, kv, wp.long())
    with pytest.raises(TypeError, match="new_kv"):
        paged_quant_scatter(pool, scales, kv.double(), wp)
    ref = (torch.zeros_like(pool), torch.zeros_like(scales))
    paged_quant_scatter_ref(*ref, kv.bfloat16(), wp)
    assert torch.equal(ref[0], pool) and torch.equal(ref[1], scales)


# ------------------------------------------------------ engine-level parity --

class TestEnginePartitionParity:
    """int8 engines against the JAX engines on the same weights and
    requests, and the port's own identities: greedy tokens under every step
    partition of the same token stream are identical."""

    def test_packed_matches_lockstep_and_jax(self, served, rng):
        cfg, params, pcfg, pparams = served(kv_quant="int8")
        reqs = _requests(rng, 6)
        outs = {}
        for packed in (True, False):
            jeng = JPaged(params, cfg, packed=packed, **KW)
            peng = PagedEngine(pparams, pcfg, packed=packed, device="cpu",
                               **KW)
            want = _serve(jeng, reqs, JRequest)
            outs[packed] = _serve(peng, reqs)
            assert outs[packed] == want
            assert jeng.occupancy_steps == peng.occupancy_steps
        assert outs[True] == outs[False]

    @pytest.mark.parametrize("packed", [True, False])
    def test_sharing_matches_isolated(self, served, rng, packed):
        cfg, params, pcfg, pparams = served(kv_quant="int8")
        shared = rng.integers(0, 256, 16).astype(np.int32)
        reqs = [(i, np.concatenate([shared, rng.integers(0, 256, 5).astype(
            np.int32)]), 8) for i in range(4)]
        plain = _serve(PagedEngine(pparams, pcfg, packed=packed,
                                   device="cpu", **KW), reqs)
        share = dict(prefix_sharing=True, decode_sharing=True)
        peng = PagedEngine(pparams, pcfg, packed=packed, device="cpu",
                           **share, **KW)
        jeng = JPaged(params, cfg, packed=packed, **share, **KW)
        got = _serve(peng, reqs)
        assert got == plain == _serve(jeng, reqs, JRequest)
        assert peng.prefix_hits > 0
        assert peng.prefix_stats() == {
            k: v for k, v in jeng.prefix_stats().items()
            if k in peng.prefix_stats()}

    def test_kernel_matches_grid(self, served, rng):
        """The packed step with the fused kernel == the per-slot STE grid
        (decode_kernel none), and each == the JAX engine's."""
        cfg, params, pcfg, pparams = served(kv_quant="int8")
        reqs = _requests(rng, 4)
        outs = []
        for kernel in ("none", "fused"):
            want = _serve(JPaged(params, cfg.replace(decode_kernel=kernel),
                                 **KW), reqs, JRequest)
            got = _serve(PagedEngine(pparams, pcfg.replace(
                decode_kernel=kernel), device="cpu", **KW), reqs)
            assert got == want
            outs.append(got)
        assert outs[0] == outs[1]

    def test_engine_reuse_matches_fresh_engine(self, served, rng):
        """Blocks freed at EOS and reallocated keep the prior owner's
        scales; the fresh-block reset zeroes them."""
        _, _, pcfg, pparams = served(kv_quant="int8")
        first, second = _requests(rng, 4), _requests(rng, 4)
        eng = PagedEngine(pparams, pcfg, device="cpu", **KW)
        _serve(eng, first)
        reused = _serve(eng, second)
        assert reused == _serve(PagedEngine(pparams, pcfg, device="cpu",
                                            **KW), second)


class TestSharedBlockIntegrity:
    def _warm(self, served, rng):
        _, _, pcfg, pparams = served(kv_quant="int8", prefix_sharing=True)
        prompt = rng.integers(0, 256, 32).astype(np.int32)   # 2 full blocks
        eng = PagedEngine(pparams, pcfg, max_batch=2, max_len=64,
                          block_size=16, device="cpu")
        eng.submit(Request(uid=0, prompt=prompt.copy(), max_new_tokens=4))
        eng.run()
        return eng, prompt

    def test_cow_copies_scales_and_shared_bytes_frozen(self, served, rng):
        eng, prompt = self._warm(served, rng)
        shared = sorted(eng.trie.blocks())
        assert len(shared) == 2
        lay = eng._cache["layers"]
        snap = {n: lay[n][:, shared].clone()
                for n in ("k", "v", "k_scale", "v_scale")}
        eng.submit(Request(uid=1, prompt=prompt.copy(), max_new_tokens=4))
        eng.run()
        assert eng.cow_copies >= 1
        for n in snap:
            assert torch.equal(lay[n][:, shared], snap[n]), n

    def test_cow_destination_dequantizes_identically(self, served, rng):
        eng, _ = self._warm(served, rng)
        src = max(eng.trie.blocks())
        dst = eng.alloc.alloc()
        _copy_block_kv(eng._cache["layers"], src, dst)
        lay = eng._cache["layers"]
        for n in ("k", "v", "k_scale", "v_scale"):
            assert torch.equal(lay[n][:, dst], lay[n][:, src]), n


class TestDriftTolerance:
    """int8 against f32 KV, the one tolerance-gated comparison, with the
    JAX package's gates (measured there on this workload: exact-match
    0.979, per-step logit MAE mean 0.024, max 0.204), held on the port."""
    EXACT_MATCH_MIN = 0.90
    LOGIT_MAE_MEAN_MAX = 0.08
    LOGIT_MAE_STEP_MAX = 0.5

    def _run(self, pparams, pcfg, reqs, record, monkeypatch):
        from repro_torch.serve import paged as paged_mod
        orig = paged_mod.M.logits_from_hidden

        def wrapped(w, h, cfg):
            out = orig(w, h, cfg)
            record.append(out[:, 0].clone())
            return out
        monkeypatch.setattr(paged_mod.M, "logits_from_hidden", wrapped)
        try:
            return _serve(PagedEngine(pparams, pcfg, device="cpu", **KW),
                          reqs)
        finally:
            monkeypatch.setattr(paged_mod.M, "logits_from_hidden", orig)

    def test_int8_drift_within_gate(self, served, rng, monkeypatch):
        _, _, pcfg, pparams = served()
        reqs = _requests(rng, 12, max_new=12)
        lf, lq = [], []
        fp = self._run(pparams, pcfg, reqs, lf, monkeypatch)
        q8 = self._run(pparams, pcfg.replace(kv_quant="int8"), reqs, lq,
                       monkeypatch)
        toks_f = [t for u in sorted(fp) for t in fp[u]]
        toks_q = [t for u in sorted(q8) for t in q8[u]]
        assert len(toks_f) == len(toks_q)
        match = np.mean([a == b for a, b in zip(toks_f, toks_q)])
        assert match >= self.EXACT_MATCH_MIN, match
        assert len(lf) == len(lq)
        maes = [float((a - b).abs().mean()) for a, b in zip(lf, lq)]
        assert np.mean(maes) <= self.LOGIT_MAE_MEAN_MAX, np.mean(maes)
        assert np.max(maes) <= self.LOGIT_MAE_STEP_MAX, np.max(maes)


# ------------------------------------------------------------- byte stats --

class TestKVByteStats:
    def test_paged_int8_vs_fp32_exact_accounting(self, tiny_cfg):
        """int8 payload = fp32 / 4, plus the scales counted in full; the
        ratio is 0.25 + 1/(block_size * head_dim) exactly."""
        cfg = ModelConfig(**dataclasses.asdict(tiny_cfg()))
        fp = init_paged_cache(cfg, 8, 16, 4, device="cpu")
        q8 = init_paged_cache(cfg.replace(kv_quant="int8"), 8, 16, 4,
                              device="cpu")
        sf = kv_cache_byte_stats(fp, cfg, None)
        sq = kv_cache_byte_stats(q8, cfg, None)
        scale_bytes = 2 * cfg.num_layers * 8 * cfg.num_kv_heads * 4
        for key in ("cache_bytes_padded", "cache_bytes_logical"):
            assert sq[key] == sf[key] // 4 + scale_bytes
        assert (sq["cache_bytes_padded"] / sf["cache_bytes_padded"]
                == 0.25 + 1 / (16 * cfg.head_dim))

    def test_byte_stats_match_jax_where_nothing_is_padded(self, tiny_cfg):
        """The port keeps the true head_dim; where the JAX package pads
        nothing (kernel off) the two packages count the same bytes."""
        from repro.serve import kv_cache_byte_stats as jax_stats
        from repro.serve.paged import init_paged_cache as jax_init
        jcfg = tiny_cfg(kv_quant="int8")
        cfg = ModelConfig(**dataclasses.asdict(jcfg))
        want = jax_stats(jax_init(jcfg, 8, 16, 4), jcfg, None)
        assert kv_cache_byte_stats(init_paged_cache(cfg, 8, 16, 4,
                                                    device="cpu"),
                                   cfg, None) == want

    def test_slot_arena_dtype_accounting(self, tiny_cfg):
        cfg = ModelConfig(**dataclasses.asdict(tiny_cfg()))
        c32 = M.init_cache(cfg, 4, 32, "float32", per_slot_lengths=True,
                           device="cpu")
        c16 = M.init_cache(cfg, 4, 32, "bfloat16", per_slot_lengths=True,
                           device="cpu")
        s32, s16 = (kv_cache_byte_stats(c, cfg, 32) for c in (c32, c16))
        assert s16["cache_bytes_padded"] * 2 == s32["cache_bytes_padded"]
        assert s16["cache_bytes_logical"] * 2 == s32["cache_bytes_logical"]


# ------------------------------------------------ cache-dtype single source --

class TestCacheDtypeSingleSource:
    def test_default_flows_from_cfg_everywhere(self, tiny_cfg):
        cfg = ModelConfig(**dataclasses.asdict(tiny_cfg(
            cache_dtype="bfloat16")))
        assert M.init_cache(cfg, 2, 32, device="cpu")["layers"]["k"].dtype \
            == torch.bfloat16
        assert init_paged_cache(cfg, 4, 16, 2, device="cpu")["layers"][
            "k"].dtype == torch.bfloat16
        params = M.init_params(cfg, device="cpu")
        paged = PagedEngine(params, cfg, max_len=32, block_size=16,
                            device="cpu")
        assert paged._cache["layers"]["k"].dtype == torch.bfloat16
        q8 = PagedEngine(params, cfg.replace(kv_quant="int8"), max_len=32,
                         block_size=16, device="cpu")
        assert q8._cache["layers"]["k"].dtype == torch.int8
        assert q8._cache["layers"]["k_scale"].dtype == torch.float32

    def test_explicit_override_still_wins(self, tiny_cfg):
        cfg = ModelConfig(**dataclasses.asdict(tiny_cfg(
            cache_dtype="bfloat16")))
        c = M.init_cache(cfg, 2, 32, "float32", device="cpu")
        assert c["layers"]["k"].dtype == torch.float32

    def test_cfg_validation(self, tiny_cfg):
        base = dataclasses.asdict(tiny_cfg())
        with pytest.raises(ValueError, match="cache_dtype"):
            ModelConfig(**{**base, "cache_dtype": "int4"})
        with pytest.raises(ValueError, match="kv_quant"):
            ModelConfig(**{**base, "kv_quant": "int4"})

    def test_slot_engines_reject_kv_quant(self, tiny_cfg):
        cfg = ModelConfig(**dataclasses.asdict(tiny_cfg(kv_quant="int8")))
        params = M.init_params(cfg, device="cpu")
        with pytest.raises(ValueError, match="paged"):
            ServeEngine(params, cfg, device="cpu")
        with pytest.raises(ValueError, match="paged"):
            ContinuousEngine(params, cfg, max_len=32, device="cpu")

