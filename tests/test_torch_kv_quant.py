"""The port's int8 paged KV (`repro_torch/quant/int8.py`,
`repro_torch/kernels/kv_quant.py`, the int8 pools of `serve/paged.py`)
against the JAX package: the twin of tests/test_kv_quant.py.

The same numpy-seeded inputs go through both packages. Gates:
  * rounding, quantize / dequantize / fake_quant: bit-identical to the JAX
    functions and to the pinned tie values;
  * the fold: the plain version `paged_quant_scatter_ref` bit-identical to
    JAX `paged_quant_scatter` (pools and scales), to the numpy model, across
    any step partition, with growth from zero scales and `draft_rows`; the
    K+V plain version against two JAX folds and its layer-batched form
    against the vmapped JAX fold; a numpy emulation of the CUDA kernel's
    algorithm (csrc/kv_quant.cu: the map-pair scan, in one launch or in
    slices of rows) bit-identical to the JAX fold; the wrappers' one-C-call
    contract on fake CUDA tensors;
  * engines on the tiny config: greedy tokens, step counts, block tables and
    prefix_stats equal to the JAX engines' (token identity; no greedy token
    moved in any comparison), and the port's own identities token for
    token: packed == lockstep, sharing on == off, kernel on == off, a reused
    engine == a fresh one;
  * int8 against f32 KV: the JAX package's measured drift gate (exact-match
    >= 0.90, logit MAE mean <= 0.08, step max <= 0.5), on the port;
  * byte accounting: exact integers.
"""
import torch_threads  # noqa: F401  (first: one torch thread a worker)
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
                                          fold_smem_bytes,
                                          paged_quant_scatter,
                                          paged_quant_scatter_kv,
                                          paged_quant_scatter_kv_ref,
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


def _rc(v):
    """round_clip of csrc/kv_quant.cu in float32."""
    f32 = np.float32
    r = np.floor(np.abs(v).astype(f32) + f32(0.5)).astype(f32)
    return np.clip(np.where(v < 0, -r, np.where(v > 0, r, f32(0))),
                   -128, 127).astype(f32)


def _scan_pairs(pa, pb):
    """The kernel's warp scan, lane by lane: 32 (a, b) map pairs, shuffle
    offsets 1-16, (a1, b1) then (a2, b2) = (max(a1, a2), b1 > 0 ? max(b1,
    a2) : b2); the identity (0, 0) on lanes without a row."""
    pa, pb = list(pa), list(pb)
    for o in (1, 2, 4, 8, 16):
        qa, qb = pa[:], pb[:]
        for lane in range(o, 32):
            pb[lane] = (max(qb[lane - o], qa[lane]) if qb[lane - o] > 0
                        else qb[lane])
            pa[lane] = max(qa[lane - o], qa[lane])
    return pa, pb


def _emulate_scan_kernel(pool, scales, rows, pos, draft=None, fresh=None):
    """csrc/kv_quant.cu's paged_quant_scatter_kv_kernel in numpy for one
    pool, step for step: per kv head (a CTA) every row's candidate scale
    (negated for a draft row); the distinct blocks; the fresh blocks (a
    written one starts at scale 0, the others are set to 0); per block (a
    warp) the rows in 32-lane chunks, each chunk's map pairs scanned as the
    warp does and applied to the running scale, the growth events and
    their ratios, each row's events-through count, each position's last
    writer; then every payload element from its last write and the later
    events."""
    f32 = np.float32
    pool, scales = pool.copy(), scales.copy()
    n, hkv, bs, d = pool.shape
    r = len(pos)
    fresh = set() if fresh is None else {int(f) for f in fresh}
    for kv in range(hkv):
        cand = []
        for i in range(r):
            c = f32(f32(max(f32(np.abs(rows[i, kv]).max()),
                            f32(KV_QUANT_EPS))) * KV_QUANT_INV_QMAX)
            cand.append(-c if draft is not None and draft[i] else c)
        blocks = list(dict.fromkeys(int(p) // bs for p in pos))
        for f in fresh - set(blocks):
            if 0 <= f < n:
                scales[f, kv] = 0.0
        for blk in blocks:
            s_run = f32(0) if blk in fresh else scales[blk, kv]
            ratios, thru, srow, last = [], {}, {}, [-1] * bs
            for base in range(0, r, 32):
                hit = [base + lane < r and pos[base + lane] // bs == blk
                       for lane in range(32)]
                if not any(hit):
                    continue
                pa = [f32(0) if not h or cand[base + lane] < 0
                      else cand[base + lane] for lane, h in enumerate(hit)]
                pb = [abs(cand[base + lane]) if h else f32(0)
                      for lane, h in enumerate(hit)]
                pa, pb = _scan_pairs(pa, pb)
                s_i = [max(s_run, a) if s_run > 0 else b
                       for a, b in zip(pa, pb)]
                s_prev = [s_run] + s_i[:-1]
                for lane in range(32):
                    if not hit[lane]:
                        continue
                    i = base + lane
                    if s_i[lane] != s_prev[lane]:
                        ratios.append(f32(s_prev[lane] / s_i[lane]))
                    thru[i], srow[i] = len(ratios), s_i[lane]
                    last[pos[i] - blk * bs] = max(last[pos[i] - blk * bs], i)
                s_run = s_i[31]
            scales[blk, kv] = s_run
            for p in range(bs):
                m = last[p]
                if m >= 0:
                    v, k = _rc((rows[m, kv] / srow[m]).astype(f32)), thru[m]
                else:
                    v, k = pool[blk, kv, p].astype(f32), 0
                for ratio in ratios[k:]:
                    v = _rc((v * ratio).astype(f32))
                pool[blk, kv, p] = v.astype(np.int8)
    return pool, scales


def _scan_case(seed):
    """Seeded fold inputs for the scan kernel's emulation: stale bytes,
    zero and set scales, up to 80 rows (three 32-lane chunks) of mixed
    magnitudes (1e-9: the eps floor) into random, sorted or trash-style
    targets (every other row into block 0, position lane % block_size),
    draft rows on half the seeds, fresh blocks on some."""
    rng = np.random.default_rng(300 + seed)
    pool = rng.integers(-128, 128, (6, 2, 4, 5)).astype(np.int8)
    scales = np.where(rng.random((6, 2)) < 0.4, 0,
                      rng.uniform(1e-3, 0.2, (6, 2))).astype(np.float32)
    r = int(rng.integers(1, 81))
    rows = (rng.normal(size=(r, 2, 5)) * rng.choice(
        [1e-9, 0.01, 1, 40], size=(r, 1, 1))).astype(np.float32)
    pos = rng.integers(0, 24, r).astype(np.int32)
    if seed % 3 == 1:
        pos = np.sort(pos)
    elif seed % 3 == 2:
        trash = np.arange(r) % 2 == 0
        pos[trash] = np.arange(r)[trash] % 4
    draft = rng.random(r) < 0.3 if seed % 2 else None
    fresh = (rng.choice(6, 3, replace=False).astype(np.int32)
             if seed % 4 >= 2 else None)
    return pool, scales, rows, pos, draft, fresh


@pytest.mark.parametrize("seed", range(8))
def test_cuda_kernel_algorithm_matches_jax_fold(seed):
    """The CUDA kernel cannot run here: its algorithm, emulated in numpy,
    equals the JAX fold bit for bit (collisions, stale and zero-scale
    blocks, sorted targets, draft rows, values at the eps floor) on up to
    29 rows, one 32-lane chunk."""
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
    got = _emulate_scan_kernel(pool, scales, rows, pos, draft)
    jp, js = _jax_fold_rows(pool, scales, rows, pos, draft)
    np.testing.assert_array_equal(got[0], np.asarray(jp))
    np.testing.assert_array_equal(got[1], np.asarray(js))


def _jax_fold_rows(pool, scales, rows, pos, draft=None):
    """JAX paged_quant_scatter of (R, Hkv, hd) rows into one pool."""
    return jax_fold(jnp.asarray(pool), jnp.asarray(scales),
                    jnp.asarray(rows.transpose(1, 0, 2)[None]),
                    jnp.asarray(pos[None]),
                    draft_rows=None if draft is None
                    else jnp.asarray(draft[None]))


@pytest.mark.parametrize("seed", range(12))
def test_scan_kernel_algorithm_matches_jax_fold(seed):
    """The CUDA kernel cannot run here: its algorithm (the map-pair scan of
    each block's rows over 32-lane chunks, the fresh-block reset, the
    per-element requant), emulated in numpy, equals the JAX fold bit for
    bit after the same reset: collisions, trash-style repeats, draft rows
    on zero-scale and stale blocks, values at the eps floor."""
    pool, scales, rows, pos, draft, fresh = _scan_case(seed)
    got = _emulate_scan_kernel(pool, scales, rows, pos, draft, fresh)
    reset = scales.copy()
    if fresh is not None:
        reset[fresh] = 0.0
    jp, js = _jax_fold_rows(pool, reset, rows, pos, draft)
    np.testing.assert_array_equal(got[0], np.asarray(jp))
    np.testing.assert_array_equal(got[1], np.asarray(js))


@pytest.mark.parametrize("seed", range(4))
def test_row_slices_fold_as_one_launch(seed):
    """A write too wide for one CTA's shared memory is folded in
    consecutive slices of rows, one launch each, the fresh blocks reset in
    the first: the emulated kernel over the slices equals the JAX fold of
    the whole write after the same reset."""
    pool, scales, rows, pos, draft, fresh = _scan_case(seed + 4)
    cut = sorted(np.random.default_rng(seed).choice(
        np.arange(1, len(pos) + 1), min(2, len(pos)), replace=False))
    got = (pool, scales)
    for a, b in zip([0, *cut], [*cut, len(pos)]):
        got = _emulate_scan_kernel(
            *got, rows[a:b], pos[a:b], None if draft is None else draft[a:b],
            fresh if a == 0 else None)
    reset = scales.copy()
    if fresh is not None:
        reset[fresh] = 0.0
    jp, js = _jax_fold_rows(pool, reset, rows, pos, draft)
    np.testing.assert_array_equal(got[0], np.asarray(jp))
    np.testing.assert_array_equal(got[1], np.asarray(js))


@pytest.mark.parametrize("draft", [False, True])
def test_scan_pairs_compose_as_the_serial_chain(draft):
    """The map pairs under any split into chunks give the serial chain's
    scales: 70 rows into one block from a set scale and from scale 0 (a
    draft row then sets it), against the JAX fold's serial loop."""
    rng = np.random.default_rng(7)
    rows = (rng.normal(size=(70, 1, 3))
            * rng.choice([0.01, 1, 9], size=(70, 1, 1))).astype(np.float32)
    pos = (np.arange(70) % 4).astype(np.int32)
    dr = rng.random(70) < 0.5 if draft else None
    pool = np.zeros((1, 1, 4, 3), np.int8)
    for s0 in (0.0, 0.02):
        scales = np.full((1, 1), s0, np.float32)
        got = _emulate_scan_kernel(pool, scales, rows, pos, dr)
        want = _jax_fold_rows(pool, scales, rows, pos, dr)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_kv_ref_matches_two_jax_folds(rng):
    """paged_quant_scatter_kv_ref (fresh-block reset, draft rows, distinct
    K and V rows) against JAX paged_quant_scatter on K, then on V, after
    the same reset."""
    pool = rng.integers(-128, 128, (2, 5, 2, 4, 6)).astype(np.int8)
    scales = np.where(rng.random((2, 5, 2)) < 0.4, 0, rng.uniform(
        1e-3, 0.1, (2, 5, 2))).astype(np.float32)
    rows = (rng.normal(size=(2, 2, 2, 7, 6)) * 3).astype(np.float32)
    wp = rng.integers(0, 20, (2, 7)).astype(np.int32)
    draft = rng.random((2, 7)) < 0.3
    fresh = np.array([3, 0, 3], np.int32)
    t = [torch.tensor(a) for a in (pool, scales)]
    out = paged_quant_scatter_kv_ref(
        t[0][0], t[1][0], torch.tensor(rows[0]), t[0][1], t[1][1],
        torch.tensor(rows[1]), torch.tensor(wp), torch.tensor(draft),
        torch.tensor(fresh))
    assert out[0] is not None and out[0].data_ptr() == t[0][0].data_ptr()
    for q in range(2):
        reset = scales[q].copy()
        reset[fresh] = 0.0
        jp, js = jax_fold(jnp.asarray(pool[q]), jnp.asarray(reset),
                          jnp.asarray(rows[q]), jnp.asarray(wp),
                          draft_rows=jnp.asarray(draft))
        np.testing.assert_array_equal(t[0][q].numpy(), np.asarray(jp))
        np.testing.assert_array_equal(t[1][q].numpy(), np.asarray(js))


def test_layered_kv_ref_matches_vmapped_jax_fold(rng):
    """The layer-batched plain version (pools (L, N, Hkv, bs, hd), rows (L,
    B, Hkv, t, hd), one write_pos) against jax.vmap(paged_quant_scatter)
    over layers, as the JAX engine's replay runs it."""
    L = 3
    pools = [rng.integers(-128, 128, (L, 4, 2, 4, 5)).astype(np.int8)
             for _ in range(2)]
    scales = [np.where(rng.random((L, 4, 2)) < 0.3, 0, rng.uniform(
        1e-3, 0.1, (L, 4, 2))).astype(np.float32) for _ in range(2)]
    rows = [(rng.normal(size=(L, 1, 2, 9, 5))
             * rng.choice([0.01, 1, 20], size=(L, 1, 1, 9, 1))
             ).astype(np.float32) for _ in range(2)]
    wp = rng.integers(0, 16, (1, 9)).astype(np.int32)
    tp = [torch.tensor(p) for p in pools]
    ts = [torch.tensor(s) for s in scales]
    paged_quant_scatter_kv(tp[0], ts[0], torch.tensor(rows[0]), tp[1],
                           ts[1], torch.tensor(rows[1]), torch.tensor(wp))
    assert paged_quant_scatter_kv.launches == 0
    fold = jax.vmap(jax_fold, in_axes=(0, 0, 0, None))
    for q in range(2):
        jp, js = fold(jnp.asarray(pools[q]), jnp.asarray(scales[q]),
                      jnp.asarray(rows[q]), jnp.asarray(wp))
        np.testing.assert_array_equal(tp[q].numpy(), np.asarray(jp))
        np.testing.assert_array_equal(ts[q].numpy(), np.asarray(js))


def test_fold_smem_bytes_formula():
    """44 B a row, 8 B a hash slot (a power of two >= 2 rows, at least
    32), 4 B per position for each of the 16 warps."""
    assert fold_smem_bytes(1, 32) == 44 + 8 * 32 + 64 * 32
    assert fold_smem_bytes(16, 4) == 44 * 16 + 8 * 32 + 64 * 4
    assert fold_smem_bytes(17, 4) == 44 * 17 + 8 * 64 + 64 * 4
    assert fold_smem_bytes(256, 32) == 44 * 256 + 8 * 512 + 64 * 32


def _record_fold_launches(monkeypatch):
    """Replace the `launch` kernels/kv_quant.py imports from build with a
    recorder that counts the launch as build.launch does."""
    from repro_torch.kernels import kv_quant
    calls = []

    def record(fn, entry, device, *args):
        calls.append((fn, entry, args))
        fn.launches += 1

    monkeypatch.setattr(kv_quant.paged_quant_scatter_kv, "launches",
                        kv_quant.paged_quant_scatter_kv.launches)
    monkeypatch.setattr(kv_quant, "launch", record)
    return calls


@pytest.mark.parametrize("layers", [0, 3])
@pytest.mark.parametrize("verify", [False, True])
def test_kv_wrapper_makes_one_c_call_with_the_rows_strides(
        layers, verify, monkeypatch):
    """On CUDA tensors (fake) paged_quant_scatter_kv makes one C call for K
    and V (and, given pools with a layer axis, for every layer): the rows
    go as the caller's tensors, K a contiguous (B, Hkv, t, hd) tensor and
    V the transposed projection, no copy, with their strides; bool draft
    rows, int32 write targets and fresh blocks as they are; one launch
    counted."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import kv_quant
    calls = _record_fold_launches(monkeypatch)
    before = kv_quant.paged_quant_scatter_kv.launches
    lead = (layers,) if layers else ()
    with FakeTensorMode(allow_non_fake_inputs=True):
        cuda = (lambda shape, dt=torch.float32: torch.empty(
            shape, dtype=dt, device="cuda"))
        kp, vp = cuda((*lead, 9, 2, 4, 8), torch.int8), cuda(
            (*lead, 9, 2, 4, 8), torch.int8)
        ks, vs = cuda((*lead, 9, 2)), cuda((*lead, 9, 2))
        k = cuda((*lead, 1, 2, 6, 8), torch.bfloat16)
        v = cuda((*lead, 1, 6, 2, 8), torch.bfloat16).transpose(-3, -2)
        wp = cuda((1, 6), torch.int32)
        dr = cuda((1, 6), torch.bool) if verify else None
        fresh = cuda((5,), torch.int32) if verify else None
        out = kv_quant.paged_quant_scatter_kv(kp, ks, k, vp, vs, v, wp,
                                              draft_rows=dr,
                                              fresh_blocks=fresh)
    assert out == (kp, ks, vp, vs)
    (fn, entry, args), = calls
    assert fn is kv_quant.paged_quant_scatter_kv
    assert entry == "paged_quant_scatter_kv_launch"
    assert args[:6] == (kp, ks, k, vp, vs, v)
    assert args[6] is wp and args[7] is dr and args[8] is fresh
    lk = k.stride() if layers else (0, *k.stride())
    lv = v.stride() if layers else (0, *v.stride())
    assert list(args[9]) == [*lk, *lv]
    assert args[10:] == (max(layers, 1), 2, 9, 2, 4, 8, 1, 6,
                         5 if verify else 0, 1)
    assert kv_quant.paged_quant_scatter_kv.launches == before + 1


def test_one_pool_wrapper_and_conversions(monkeypatch):
    """paged_quant_scatter makes the same C call with one pool (no V, zero
    strides after K's), counted on paged_quant_scatter_kv; draft rows of
    another dtype and fresh blocks of int64 are converted, the only copies
    a wrapper makes; a write wider than one launch's shared memory is still
    one C call (the C entry folds it in slices); a block too large for one
    row's shared memory raises before any call."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import kv_quant
    calls = _record_fold_launches(monkeypatch)
    before = kv_quant.paged_quant_scatter_kv.launches
    with FakeTensorMode(allow_non_fake_inputs=True):
        cuda = (lambda shape, dt=torch.float32: torch.empty(
            shape, dtype=dt, device="cuda"))
        pool, sc = cuda((9, 2, 4, 8), torch.int8), cuda((9, 2))
        rows, wp = cuda((2, 2, 3, 8)), cuda((2, 3), torch.int32)
        kv_quant.paged_quant_scatter(pool, sc, rows, wp,
                                     draft_rows=cuda((2, 3), torch.int32))
        (fn, _, args), = calls
        assert fn is kv_quant.paged_quant_scatter_kv
        assert args[:6] == (pool, sc, rows, None, None, None)
        assert args[7].dtype == torch.uint8 and args[8] is None
        assert list(args[9]) == [0, *rows.stride(), 0, 0, 0, 0, 0]
        assert args[10:12] == (1, 1)
        kv_quant.paged_quant_scatter_kv(
            pool, sc, rows, pool, sc, rows, wp,
            fresh_blocks=cuda((3,), torch.int64))
        assert calls[1][2][8].dtype == torch.int32
        wide = kv_quant.MAX_SMEM_BYTES // 44
        assert kv_quant.fold_smem_bytes(wide, 4) > kv_quant.MAX_SMEM_BYTES
        kv_quant.paged_quant_scatter(pool, sc, cuda((1, 2, wide, 8)),
                                     cuda((1, wide), torch.int32))
        assert calls[2][2][16:18] == (1, wide)
        bs = kv_quant.MAX_SMEM_BYTES // (4 * kv_quant.FOLD_WARPS)
        with pytest.raises(ValueError, match="shared memory"):
            kv_quant.paged_quant_scatter(
                cuda((2, 2, bs, 4), torch.int8), cuda((2, 2)),
                cuda((1, 2, 1, 4)), cuda((1, 1), torch.int32))
    assert len(calls) == 3
    assert kv_quant.paged_quant_scatter_kv.launches == before + 3


@pytest.mark.parametrize("name", ["paged_quant_scatter_kv",
                                  "paged_quant_scatter"])
def test_fold_wrappers_raise_on_cuda_when_the_build_fails(name,
                                                          monkeypatch):
    """On a CUDA tensor a fold wrapper launches its kernel or raises: a
    failed build raises, counts no launch and runs no plain version."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import build, kv_quant
    wrapper = getattr(kv_quant, name)

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    def no_fallback(*a, **kw):
        raise AssertionError("a plain version ran on a CUDA tensor")

    monkeypatch.setattr(build, "load_library", no_nvcc)
    for ref in ("paged_quant_scatter_ref", "paged_quant_scatter_kv_ref"):
        monkeypatch.setattr(kv_quant, ref, no_fallback)
    before = kv_quant.paged_quant_scatter_kv.launches
    with FakeTensorMode(allow_non_fake_inputs=True):
        pool = torch.empty((5, 2, 4, 8), dtype=torch.int8, device="cuda")
        sc = torch.empty((5, 2), device="cuda")
        rows = torch.empty((1, 2, 3, 8), device="cuda")
        wp = torch.empty((1, 3), dtype=torch.int32, device="cuda")
        args = ((pool, sc, rows, pool, sc, rows, wp)
                if name == "paged_quant_scatter_kv" else (pool, sc, rows, wp))
        with pytest.raises(RuntimeError, match="nvcc"):
            wrapper(*args)
    assert kv_quant.paged_quant_scatter_kv.launches == before


def test_fold_wrapper_checks_and_counts_no_cpu_launch():
    pool = torch.zeros((3, 2, 4, 5), dtype=torch.int8)
    scales = torch.zeros((3, 2))
    kv = torch.ones((1, 2, 3, 5))
    wp = torch.tensor([[0, 1, 2]], dtype=torch.int32)
    paged_quant_scatter(pool, scales, kv.bfloat16(), wp)
    assert paged_quant_scatter_kv.launches == 0
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

