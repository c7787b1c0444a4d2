"""The port's speculative decoding (repro_torch/serve/paged.py) against the
JAX engine's, twin of tests/test_spec_decode.py class for class.

The same seeded multi-turn workload (sessions re-feeding their history plus
short user messages, so the trie and the n-gram lookup both draft) runs
through the JAX PagedEngine and the port's on the same weights (carried
across by params_from_jax; f32, the tiny config). Gates:

  * tokens identical to the JAX engine's and to the port's never-drafted
    run; speculative counters and every prefix_stats() key equal to the
    JAX engine's; block tables and free lists equal after every step;
  * rollback leaves no trace (garbage drafts, rejected every step): the
    port's host state equals its never-drafted twin's, and on int8 pools
    every block but the trash block is bit-exact to it;
  * port against JAX on int8 pools, the same run: the int8 bins that
    differ are counted, and gated at 0 (INT8_BIN_FLIPS_MAX): no bin moved
    at these shapes, although an ulp of float drift across frameworks may
    flip one (tests/test_torch_kv_quant.py).
"""
import torch_threads  # noqa: F401  (first: one torch thread a worker)
import dataclasses

import jax
import numpy as np
import pytest

from repro.models import model as JM
from repro.serve import PagedEngine as JPaged
from repro.serve import Request as JRequest
from repro.serve import paged as jpaged
from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.serve import PagedEngine, Request
from repro_torch.serve.paged import (BlockAllocator, PrefixTrie,
                                     ngram_propose, prefix_chunk,
                                     schedule_step_tokens)

BS = 8   # trie-level tests' block size (engine tests use 16 via kwargs)
# int8 bins of the port's pool that may differ from the JAX engine's after
# the same drafted run (measured 0 at these shapes)
INT8_BIN_FLIPS_MAX = 0


def _models(tiny_cfg, quant="none"):
    cfg = tiny_cfg(attention_prob="hccs", hccs_mode="i16_div",
                   kv_quant=quant)
    params = JM.init_params(jax.random.PRNGKey(0), cfg)
    pcfg = ModelConfig(**dataclasses.asdict(cfg))
    pparams = M.params_from_jax(jax.tree.map(np.asarray, params), pcfg,
                                device="cpu")
    return cfg, params, pcfg, pparams


_MODELS: dict = {}


@pytest.fixture
def models(tiny_cfg):
    def get(quant="none"):
        if quant not in _MODELS:
            _MODELS[quant] = _models(tiny_cfg, quant)
        return _MODELS[quant]
    return get


def _kw(**kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_len", 256)
    kw.setdefault("block_size", 16)
    kw.setdefault("packed", True)
    kw.setdefault("draft_len", 4)
    return kw


def _session_requests(seed: int, sessions=3, turns=3, max_new=12):
    """The JAX twin's seeded multi-turn workload: per turn, every session
    sends the shared 12-token base plus 3 fresh tokens."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, 12).astype(np.int32)
    uid, out = 0, []
    for _ in range(turns):
        turn = []
        for s in range(sessions):
            extra = rng.integers(0, 256, 3).astype(np.int32)
            turn.append((uid, np.concatenate([base, extra]), max_new,
                         f"s{s}"))
            uid += 1
        out.append(turn)
    return out


def _host_state(eng):
    """Everything the scheduler can observe: allocator, tables, frontiers,
    reservations, registration watermarks, and the trie index."""
    return dict(
        free=list(eng.alloc._free), ref=dict(eng.alloc._ref),
        tables=eng._tables.copy(), lengths=eng._lengths.copy(),
        resv=eng._resv.copy(), reg_level=eng._reg_level.copy(),
        reg_parent=eng._reg_parent.copy(),
        trie_index=dict(eng.trie._index),
        trie_kids={p: dict(k) for p, k in eng.trie._kids.items()})


def _assert_host_state_equal(a, b):
    for name in ("free", "ref", "trie_index", "trie_kids"):
        assert a[name] == b[name], name
    for name in ("tables", "lengths", "resv", "reg_level", "reg_parent"):
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def _serve_sessions(engines, seed=7):
    """Drive every engine of `engines` [(engine, Request class)] through the
    session workload in step: after EVERY step their tables and free lists
    must agree. Returns one {uid: tokens} per engine."""
    outs = [{} for _ in engines]
    for turn in _session_requests(seed):
        for eng, cls in engines:
            for uid, prompt, m, sess in turn:
                eng.submit(cls(uid=uid, prompt=prompt.copy(),
                               max_new_tokens=m), session=sess)
        while any(e.busy for e, _ in engines):
            for (eng, _), out in zip(engines, outs):
                for r in eng.step():
                    out[r.uid] = tuple(int(t) for t in r.out_tokens)
            ref = engines[0][0]
            for eng, _ in engines[1:]:
                np.testing.assert_array_equal(eng._tables, ref._tables)
                assert list(eng.alloc._free) == list(ref.alloc._free)
    return outs


_RUNS: dict = {}


def _sessions_run(models, quant, sharing):
    """The JAX speculative engine, the port's speculative engine and the
    port's never-drafted engine on the session workload, memoized."""
    key = (quant, sharing)
    if key not in _RUNS:
        cfg, params, pcfg, pparams = models(quant)
        share = dict(prefix_sharing=sharing, decode_sharing=sharing)
        jeng = JPaged(params, cfg, speculative=True, **_kw(**share))
        peng = PagedEngine(pparams, pcfg, speculative=True, device="cpu",
                           **_kw(**share))
        plain = PagedEngine(pparams, pcfg, speculative=False, device="cpu",
                            **_kw(**share))
        outs = _serve_sessions([(jeng, JRequest), (peng, Request)])
        (plain_out,) = _serve_sessions([(plain, Request)])
        _RUNS[key] = (jeng, peng, plain, outs[0], outs[1], plain_out)
    return _RUNS[key]


# ------------------------------------------------------------ drafting --


class TestNgramPropose:
    def test_longest_repeated_suffix_continuation(self):
        assert ngram_propose([1, 2, 3, 9, 1, 2, 3], 2) == [9, 1]

    def test_most_recent_occurrence_wins(self):
        assert ngram_propose([1, 2, 5, 1, 2, 7, 1, 2], 3) == [7, 1, 2]

    def test_no_repeat_returns_empty(self):
        assert ngram_propose([1, 2, 3, 4, 5], 4) == []

    def test_k_caps_proposal(self):
        assert ngram_propose([4, 5, 6, 7, 4, 5], 1) == [6]

    def test_tiny_sequences(self):
        assert ngram_propose([], 4) == []
        assert ngram_propose([3], 4) == []
        assert ngram_propose([3, 3], 2) == [3]

    @pytest.mark.parametrize("seed", range(4))
    def test_matches_jax(self, seed):
        rng = np.random.default_rng(seed)
        for _ in range(50):
            seq = rng.integers(0, 6, int(rng.integers(0, 40)))
            k, n = int(rng.integers(1, 6)), int(rng.integers(1, 4))
            assert ngram_propose(seq, k, n) == jpaged.ngram_propose(seq, k,
                                                                    n)


class TestExtendPath:
    def _trie(self, chains, alloc_cls=BlockAllocator, trie_cls=PrefixTrie):
        alloc = alloc_cls(64)
        trie = trie_cls(alloc, BS)
        for chain in chains:
            parent = -1
            for j in range(len(chain) // BS):
                blk = alloc.alloc()
                parent = trie.insert(parent, prefix_chunk(chain, j, BS),
                                     blk, "prompt")
                alloc.free([blk])
        return trie

    def test_continues_matched_path(self):
        chain = list(range(3 * BS))
        trie = self._trie([chain])
        assert trie.extend_path(chain[:BS], 2 * BS) == chain[BS:3 * BS]

    def test_partial_tail_content_match(self):
        chain = list(range(3 * BS))
        trie = self._trie([chain])
        got = trie.extend_path(chain[:BS + 3], BS)
        assert got == chain[BS + 3:2 * BS + 3]

    def test_diverging_tail_returns_empty(self):
        chain = list(range(3 * BS))
        trie = self._trie([chain])
        assert trie.extend_path(chain[:BS] + [255], BS) == []

    def test_most_recent_child_wins(self):
        head = list(range(BS))
        a = head + [100] * BS
        b = head + [100] * (BS - 1) + [101]
        trie = self._trie([a, b])
        assert trie.extend_path(head + [100], BS)[:BS - 2] \
            == b[BS + 1:2 * BS - 1]

    def test_every_full_block_of_extension_rematches(self):
        chain = list(range(4 * BS))
        trie = self._trie([chain])
        for cut in (BS, BS + 1, 2 * BS - 1, 2 * BS + 5):
            prefix = chain[:cut]
            ext = prefix + trie.extend_path(prefix, 2 * BS)
            assert len(trie.match(ext)) == len(ext) // BS

    def test_pure_no_lru_touch(self):
        chain = list(range(2 * BS))
        trie = self._trie([chain])
        lru = dict(trie._lru)
        trie.extend_path(chain[:BS], BS)
        assert trie._lru == lru

    @pytest.mark.parametrize("seed", range(3))
    def test_matches_jax(self, seed):
        """Seeded chains over a small alphabet (shared heads, diverging
        tails): the port's drafts equal the JAX trie's at every cut."""
        rng = np.random.default_rng(seed)
        head = rng.integers(0, 4, BS).tolist()
        chains = [head + rng.integers(0, 3, int(rng.integers(1, 4)) * BS)
                  .tolist() for _ in range(5)]
        port = self._trie(chains)
        ref = self._trie(chains, jpaged.BlockAllocator, jpaged.PrefixTrie)
        for chain in chains:
            for cut in range(1, len(chain)):
                k = int(rng.integers(1, 2 * BS))
                assert port.extend_path(chain[:cut], k) == \
                    ref.extend_path(chain[:cut], k)


class TestScheduleDrafts:
    def test_default_layout_unchanged(self):
        live = np.array([True, True, True])
        remaining = np.array([0, 5, 0])
        base = schedule_step_tokens(live, remaining, 16, 8)
        with_none = schedule_step_tokens(live, remaining, 16, 8, drafts=None)
        np.testing.assert_array_equal(base, with_none)

    def test_drafts_dealt_to_decode_slots_first(self):
        live = np.array([True, True, True])
        remaining = np.array([0, 50, 0])
        t = schedule_step_tokens(live, remaining, 8, 8,
                                 drafts=np.array([2, 0, 3]))
        np.testing.assert_array_equal(t, [3, 1, 4])

    def test_budget_truncates_drafts(self):
        live = np.array([True, True])
        remaining = np.array([0, 0])
        t = schedule_step_tokens(live, remaining, 4, None,
                                 drafts=np.array([4, 4]))
        assert t.sum() == 4 and t[0] == 3


# ------------------------------------------------------- engine parity --


class TestGreedyParity:
    @pytest.mark.parametrize("quant", ["none", "int8"])
    @pytest.mark.parametrize("sharing", [False, True])
    def test_multi_turn_token_identical(self, models, sharing, quant):
        """Port speculative == JAX speculative == port never-drafted, with
        equal tables and free lists after every step and equal speculative
        counters."""
        jeng, peng, plain, jout, pout, plain_out = _sessions_run(
            models, quant, sharing)
        assert pout == jout
        assert pout == plain_out
        assert peng.drafted_tokens > 0 and peng.accepted_tokens > 0
        assert plain.drafted_tokens == 0
        for name in ("spec_steps", "spec_rollbacks", "drafted_tokens",
                     "accepted_tokens", "rejected_tokens", "occupancy_steps"):
            assert getattr(peng, name) == getattr(jeng, name), name
        assert list(peng.alloc._free) == list(jeng.alloc._free)
        np.testing.assert_array_equal(peng._tables, jeng._tables)

    @pytest.mark.parametrize("spec", [False, True])
    def test_prefix_stats_match_jax_key_for_key(self, models, spec):
        """prefix_stats() equals the JAX engine's, every key and value, the
        six speculative ones included, with drafting on and off."""
        jeng, peng, plain, *_ = _sessions_run(models, "none", True)
        if spec:
            assert peng.prefix_stats() == jeng.prefix_stats()
            return
        cfg, params, _, _ = models("none")
        jplain = JPaged(params, cfg, speculative=False,
                        **_kw(prefix_sharing=True, decode_sharing=True))
        _serve_sessions([(jplain, JRequest)])
        want = jplain.prefix_stats()
        assert plain.prefix_stats() == want
        assert want["acceptance_rate"] is None and want["spec_steps"] == 0

    def test_acceptance_rate_on_repetitive_workload(self, models):
        _, peng, *_ = _sessions_run(models, "none", True)
        stats = peng.prefix_stats()
        assert stats["tokens_drafted"] == (stats["tokens_accepted"]
                                           + stats["tokens_rejected"])
        assert stats["acceptance_rate"] >= 0.3

    def test_counters_zero_and_rate_none_without_drafting(self, models):
        _, _, pcfg, pparams = models("none")
        eng = PagedEngine(pparams, pcfg, speculative=False, device="cpu",
                          **_kw())
        eng.submit(Request(uid=0, prompt=np.arange(5, dtype=np.int32),
                           max_new_tokens=4))
        eng.run()
        stats = eng.prefix_stats()
        assert stats["tokens_drafted"] == 0
        assert stats["acceptance_rate"] is None


# ----------------------------------------------------- no-trace rollback --


GARBAGE = 7


def _garbage(live, remaining):
    dec = np.flatnonzero(np.asarray(live) & (np.asarray(remaining) == 0))
    return {int(s): [GARBAGE] * 3 for s in dec}


_PAIRS: dict = {}


def _garbage_runs(models, quant, seed=0):
    """The port never drafting and drafting garbage (rejected essentially
    every step), and the JAX engine drafting the same garbage, on seeded
    requests; memoized."""
    if quant in _PAIRS:
        return _PAIRS[quant]
    cfg, params, pcfg, pparams = models(quant)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, 256, int(rng.integers(3, 40)))
               .astype(np.int32) for _ in range(4)]
    share = dict(prefix_sharing=True, decode_sharing=True)
    runs = []
    for spec, cls in ((False, PagedEngine), (True, PagedEngine),
                      (True, JPaged)):
        if cls is JPaged:
            eng = JPaged(params, cfg, speculative=spec, **_kw(**share))
            req_cls = JRequest
        else:
            eng = cls(pparams, pcfg, speculative=spec, device="cpu",
                      **_kw(**share))
            req_cls = Request
        if spec:
            eng._propose_drafts = _garbage
        for i, p in enumerate(prompts):
            eng.submit(req_cls(uid=i, prompt=p.copy(), max_new_tokens=16))
        runs.append((eng, {r.uid: tuple(int(t) for t in r.out_tokens)
                           for r in eng.run()}))
    _PAIRS[quant] = runs
    return runs


class TestNoTrace:
    """Garbage drafts against a never-drafted twin: host state
    indistinguishable, and on int8 pools the device blocks bit-exact (draft
    lanes fold with a clamped scale; the post-verification restore and
    replay re-fold exactly the committed rows)."""

    @pytest.mark.parametrize("quant", ["none", "int8"])
    def test_host_state_and_tokens(self, models, quant):
        (e0, out0), (e1, out1), (ej, outj) = _garbage_runs(models, quant)
        assert out1 == out0 == outj
        assert e1.spec_rollbacks > 0 and e1.rejected_tokens > 0
        _assert_host_state_equal(_host_state(e0), _host_state(e1))
        _assert_host_state_equal(_host_state(ej), _host_state(e1))
        assert e1.prefix_stats() == ej.prefix_stats()

    def test_int8_pool_bit_identical(self, models):
        (e0, _), (e1, _), _ = _garbage_runs(models, "int8")
        for name in ("k", "v", "k_scale", "v_scale"):
            a = e0._cache["layers"][name].numpy()
            b = e1._cache["layers"][name].numpy()
            # block 0 is the trash target of rejected lanes
            np.testing.assert_array_equal(a[:, 1:], b[:, 1:], err_msg=name)

    def test_int8_pool_against_jax_bin_flips(self, models):
        """The port's int8 pool after the drafted run against the JAX
        engine's: differing bins counted over the live blocks, scales to
        float tolerance."""
        _, (e1, _), (ej, _) = _garbage_runs(models, "int8")
        hd = e1.cfg.head_dim
        live = sorted(set(int(b) for b in e1.alloc._ref))
        assert live
        flips = total = 0
        for name in ("k", "v"):
            a = e1._cache["layers"][name].numpy()[:, live]
            b = np.asarray(ej._cache["layers"][name])[:, live, ..., :hd]
            flips += int((a != b).sum())
            total += a.size
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
        assert flips <= INT8_BIN_FLIPS_MAX, (flips, total)
        for name in ("k_scale", "v_scale"):
            np.testing.assert_allclose(
                e1._cache["layers"][name].numpy()[:, live],
                np.asarray(ej._cache["layers"][name])[:, live], rtol=1e-6)

    def test_pool_drains_clean_after_run(self, models):
        _, (e1, _), _ = _garbage_runs(models, "int8")
        e1.clear_prefix_cache()
        assert e1.alloc.num_free == e1.num_blocks - 1
        assert e1.alloc.num_live == 0


# --------------------------------------------------------- config guards --


class TestConfigGuards:
    def test_speculative_requires_paged_layout(self):
        base = dict(name="t", family="dense", num_layers=2, d_model=64,
                    num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256)
        with pytest.raises(ValueError, match="paged"):
            ModelConfig(**base, speculative=True)

    def test_draft_len_positive(self, models):
        _, _, pcfg, pparams = models("none")
        with pytest.raises(ValueError, match="draft_len"):
            PagedEngine(pparams, pcfg, speculative=True, device="cpu",
                        **_kw(draft_len=0))

    def test_speculative_requires_packed_step(self, models):
        _, _, pcfg, pparams = models("none")
        with pytest.raises(ValueError, match="packed"):
            PagedEngine(pparams, pcfg, speculative=True, device="cpu",
                        **_kw(packed=False))

    def test_engine_kwarg_overrides_cfg(self, models):
        _, _, pcfg, pparams = models("none")
        eng = PagedEngine(pparams, pcfg.replace(cache_layout="paged",
                                                speculative=True),
                          speculative=False, device="cpu", **_kw())
        assert not eng.speculative
        eng = PagedEngine(pparams, pcfg.replace(cache_layout="paged",
                                                speculative=True),
                          device="cpu", **_kw())
        assert eng.speculative and 8 in eng._widths
