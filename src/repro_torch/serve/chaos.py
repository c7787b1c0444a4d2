"""Fault-injection chaos harness + engine invariant checker (paged engine) —
the port of `repro/serve/chaos.py`.

The robustness layer (serve/admission.py, paged.py OVERLOAD ROBUSTNESS)
claims the paged engine survives overload, preemption storms, mid-flight
cancellation and device failures without leaking a block or wedging. This
module is the test substrate behind that claim:

* ``check_invariants(eng)`` — the global consistency predicate, checkable
  at ANY step boundary:
    - allocator conservation: the free list and the live refcount table
      partition {1, .., num_blocks-1} exactly (no leak, no double-own);
    - refcounts match holders: every live block's refcount equals the
      number of slot-table entries + prefix-trie index entries (+ declared
      external holders) referencing it;
    - the trie never references a freed block, and every indexed entry's
      parent chain is reachable (parent is the root or itself indexed);
    - dead slots are fully reset (table -1, no reservation, no feed);
    - reservation soundness: outstanding reservations never exceed the
      free pool (skipped while external holders pin blocks the gate could
      not know about — exactly the hand-driven-exhaustion scenario).

* ``ChaosMonkey`` — a seeded fault injector that drives a ROBUST engine
  (admission=AdmissionConfig) through a randomized schedule of arrival
  bursts, allocator exhaustion (blocks stolen straight from the pool and
  later returned), mid-flight cancels, preemption storms, and device-step
  failures (exceptions raised BEFORE the wrapped device half runs, so the
  in-place pools are untouched and retries are safe; NaN logits surfaced
  to the nan_check). After every step it asserts
  ``check_invariants``; at the end it drains the engine to empty and
  asserts the pool returns to fully free.

Faults are injected at seeded points (numpy Generator), so every run is
reproducible from (seed, engine config) — CI runs a fixed-seed matrix
across packed x sharing x int8 legs (tests/test_torch_chaos.py). The
monkey wraps the engine's device seams (_step_fn, _packed_fn,
_packed_spec_fn); the verify step is never poisoned.
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from repro_torch.serve.admission import QueueFull
from repro_torch.serve.paged import TRASH_BLOCK, BlockPoolExhausted

DEFAULT_FAULTS = ("exhaustion", "burst", "cancel", "preempt",
                  "device_error", "nan")


def check_invariants(eng, external=()):
    """Assert the paged engine's global block-accounting invariants (module
    docstring). `external` lists blocks held by parties the engine cannot
    see (e.g. the chaos monkey's stolen blocks), counted as one holder
    each. Raises AssertionError with a specific message on violation;
    returns None on success. O(num_blocks + table size + trie size)."""
    alloc = eng.alloc
    n = alloc.num_blocks
    free = set(alloc._free)
    live = set(alloc._ref)
    assert len(alloc._free) == len(free), "free list holds duplicates"
    assert not (free & live), f"blocks both free and live: {free & live}"
    assert free | live == set(range(1, n)), (
        "allocator conservation violated: free + live != all usable blocks "
        f"(missing {set(range(1, n)) - free - live}, "
        f"extra {free | live - set(range(1, n))})")
    assert TRASH_BLOCK not in live and TRASH_BLOCK not in free, \
        "trash block entered the allocator"

    holders = collections.Counter(int(b) for b in external)
    for row in eng._tables:
        for b in row:
            if b >= 0:
                holders[int(b)] += 1
    for blk in eng.trie.blocks():
        holders[int(blk)] += 1
        assert alloc.ref(blk) >= 1, \
            f"trie references freed block {int(blk)}"
    assert dict(holders) == alloc._ref, (
        "refcounts do not match holders: "
        f"holders={dict(holders)} refs={alloc._ref}")

    for key in eng.trie._index:
        parent = key[0]
        assert parent == -1 or parent in eng.trie._block_key, (
            f"trie entry {key!r} has unreachable parent {parent}")

    for slot in range(eng.max_batch):
        if not eng._live[slot]:
            assert eng._slots[slot] is None, f"dead slot {slot} holds a req"
            assert eng._feeds[slot] is None, f"dead slot {slot} holds a feed"
            assert (eng._tables[slot] == -1).all(), \
                f"dead slot {slot} holds blocks"
            assert eng._resv[slot] == 0, f"dead slot {slot} holds reservation"
        else:
            assert eng._slots[slot] is not None, f"live slot {slot} empty"

    if not external:
        assert int(eng._resv.sum()) <= alloc.num_free, (
            f"reservations {int(eng._resv.sum())} exceed free pool "
            f"{alloc.num_free}")


def assert_drained(eng):
    """Assert the engine is idle with a fully reclaimed pool: no queued or
    live work, every table empty, and — after dropping the prefix cache —
    every usable block back on the free list."""
    assert not eng.busy, "engine still busy"
    assert (eng._tables == -1).all(), "tables hold blocks after drain"
    eng.clear_prefix_cache()
    check_invariants(eng)
    assert eng.alloc.num_free == eng.num_blocks - 1, (
        f"pool not fully reclaimed: {eng.alloc.num_free} free of "
        f"{eng.num_blocks - 1} usable")


class ChaosMonkey:
    """Seeded fault injector around a ROBUST paged engine (module
    docstring). Usage:

        eng = PagedEngine(params, cfg, admission=AdmissionConfig(...), ...)
        report = ChaosMonkey(eng, seed=0, make_request=mk).run()

    `make_request(i)` returns the i-th Request to submit (the monkey owns
    WHEN it is submitted, the caller owns its shape: priority, deadlines,
    prompt). The run submits `n_requests` total, injects a fault with
    probability `fault_rate` per step, asserts check_invariants after
    every step, then drains and asserts the pool is fully reclaimed.
    Returns a report dict (steps, per-fault injection counts, finished /
    failed request lists)."""

    def __init__(self, eng, *, seed: int, make_request, n_requests: int = 24,
                 fault_rate: float = 0.4, faults=DEFAULT_FAULTS,
                 max_steps: int = 4000):
        if not getattr(eng, "_robust", False):
            raise ValueError(
                "ChaosMonkey requires a robust engine "
                "(PagedEngine(admission=AdmissionConfig(...)))")
        self.eng = eng
        self.rng = np.random.default_rng(seed)
        self.make_request = make_request
        self.n_requests = int(n_requests)
        self.fault_rate = float(fault_rate)
        self.faults = tuple(faults)
        self.max_steps = int(max_steps)
        self.injected = collections.Counter()
        self._stolen: list[int] = []
        self._made = 0
        self._reqs: list = []            # every request ever submitted;
        # dropped requests (shed / cancelled / deadline / device) are NOT
        # returned by step(), so terminal outcomes are read off these refs
        # device-fault plumbing: wrap the engine's device seams. Exceptions
        # are raised BEFORE the wrapped function runs (the in-place pools
        # are untouched, so the engine's retry repeats the call exactly);
        # NaN logits run the REAL step once and poison only the returned
        # logits (the KV write already happened — a sampling-head fault).
        self._pending_raise = 0
        self._pending_nan = False
        self._orig = {}
        for name in ("_step_fn", "_packed_fn", "_packed_spec_fn"):
            self._orig[name] = getattr(eng, name)
            setattr(eng, name, self._wrap(self._orig[name],
                                          allow_nan=name != "_packed_spec_fn"))
        # NaN faults need the engine's nan_check to surface as a clean
        # failed-with-reason; flip it on for the run (config is frozen)
        eng._adm = dataclasses.replace(eng._adm, nan_check=True)

    def _wrap(self, fn, *, allow_nan: bool):
        def wrapped(*args):
            if self._pending_raise > 0:
                self._pending_raise -= 1
                raise RuntimeError("chaos: injected device fault")
            out = fn(*args)
            if self._pending_nan and allow_nan:
                self._pending_nan = False
                logits, cache = out
                return torch.full_like(logits, float("nan")), cache
            return out
        return wrapped

    def restore(self):
        """Unwrap the engine's step functions (idempotent)."""
        for name, fn in self._orig.items():
            setattr(self.eng, name, fn)

    # ------------------------------------------------------------ faults --

    def _submit_one(self) -> bool:
        if self._made >= self.n_requests:
            return False
        req = self.make_request(self._made)
        self._reqs.append(req)
        try:
            self.eng.submit(req)
        except QueueFull:
            self.injected["queue_full"] += 1
        self._made += 1
        return True

    def _inject(self, kind: str):
        eng, rng = self.eng, self.rng
        if kind == "exhaustion":
            # steal straight from the pool, below the reservation gate's
            # assumptions — the next growth step hits BlockPoolExhausted
            # and must unwind + preempt instead of crashing
            k = int(rng.integers(1, max(eng.alloc.num_free, 1) + 1))
            for _ in range(k):
                try:
                    self._stolen.append(eng.alloc.alloc())
                except BlockPoolExhausted:
                    break
        elif kind == "burst":
            for _ in range(int(rng.integers(2, 6))):
                if not self._submit_one():
                    break
        elif kind == "cancel":
            uids = [r.uid for r in eng._queue]
            uids += [eng._slots[s].uid for s in np.flatnonzero(eng._live)]
            if uids:
                eng.cancel(uids[int(rng.integers(len(uids)))])
        elif kind == "preempt":
            live = np.flatnonzero(eng._live)
            if len(live):
                for s in rng.permutation(live)[:int(rng.integers(1, 3))]:
                    eng._preempt_slot(int(s))
        elif kind == "device_error":
            # 1..max_device_retries consecutive failures stay transparent
            # (retried); occasionally exceed the budget so the fail-all
            # path runs too
            self._pending_raise = int(
                rng.integers(1, eng._adm.max_device_retries + 2))
        elif kind == "nan":
            self._pending_nan = True
        else:
            raise ValueError(f"unknown fault kind {kind!r}")
        self.injected[kind] += 1

    def _release_stolen(self, k: int | None = None):
        take = len(self._stolen) if k is None else min(k, len(self._stolen))
        for _ in range(take):
            self.eng.alloc.free([self._stolen.pop()])

    # --------------------------------------------------------------- run --

    def run(self) -> dict:
        eng, rng = self.eng, self.rng
        steps = 0
        for _ in range(min(4, self.n_requests)):
            self._submit_one()
        while ((eng.busy or self._made < self.n_requests or self._stolen)
               and steps < self.max_steps):
            steps += 1
            if self._made < self.n_requests and rng.random() < 0.5:
                self._submit_one()
            if rng.random() < self.fault_rate:
                self._inject(str(rng.choice(self.faults)))
            eng.step()
            # give the system its blocks back eventually, or a permanently
            # starved pool turns the run into pure preemption churn
            if self._stolen and rng.random() < 0.5:
                self._release_stolen(int(rng.integers(1,
                                                      len(self._stolen) + 1)))
            check_invariants(eng, external=self._stolen)
        assert steps < self.max_steps, (
            f"chaos run did not converge in {self.max_steps} steps "
            f"(busy={eng.busy}, stolen={len(self._stolen)})")
        self._release_stolen()
        self._pending_raise = 0
        self._pending_nan = False
        guard = 0
        while eng.busy:
            eng.step()
            check_invariants(eng)
            guard += 1
            assert guard < self.max_steps, "drain did not converge"
        assert_drained(eng)
        self.restore()
        ok = [r for r in self._reqs if r.done]
        failed = [r for r in self._reqs if r.failed]
        assert len(ok) + len(failed) == self._made, (
            "request neither finished nor failed after drain: "
            f"{[r.uid for r in self._reqs if not (r.done or r.failed)]}")
        return dict(steps=steps, submitted=self._made,
                    finished=ok, failed=failed,
                    faults=dict(self.injected),
                    robustness=eng.robust_counters.snapshot())
