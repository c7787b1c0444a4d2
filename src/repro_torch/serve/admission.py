"""Overload-robust admission: priority classes, deadlines, backpressure —
the port of `repro/serve/admission.py`, host code copied as it is.

The serving engines' default admission is FIFO and fail-fast: the queue is
unbounded, a long request can starve the pool, and `BlockPoolExhausted` is a
hard error. This module is the strictly OPT-IN robustness layer on top —
engines constructed without an `admission=` config behave byte-identically
to before it existed. With a config, requests gain a priority/SLA class
(`Request.priority`, higher = more important) and optional deadlines
(`deadline_ttft` / `deadline_e2e`, seconds from submit), and the engine's
queue becomes an `AdmissionQueue`:

* **bounded queue + backpressure** — `max_queue` caps queued (not running)
  requests; on overflow the `backpressure` policy decides:
    - "reject": `submit()` raises `QueueFull` (the HTTP-429 analogue; the
      caller owns retry/shed);
    - "shed-lowest-priority": the lowest-priority, most-recently-submitted
      queued request (possibly the incoming one) is dropped, marked
      `failed` with reason "shed".
* **priority ordering** — admission serves the highest class first, FIFO
  within a class (all-equal priorities degenerate to plain FIFO, which is
  how the opt-in layer keeps default behavior unchanged). Strict priority:
  a stalled head blocks lower classes — the price of a one-line
  deadlock-freedom argument, paid for by preemption below.
* **preemption** (paged engine) — when the reservation gate would stall a
  higher-class head, the engine preempts a victim (lowest class, most
  recently admitted; see `choose_victim`): its blocks are freed back to
  the pool refcount-aware (shared/trie blocks survive), and the request is
  re-queued with its generated tokens as resume state — on re-admission
  the engine re-prefills prompt + out_tokens, riding the prefix trie so
  the re-prefill is mostly skipped (sampling keys are per (uid,
  generation index), so resumed outputs are token-identical to an
  uncontended run).
* **deadlines** — checked at step boundaries: a queued request past its
  TTFT (or E2E) deadline is expired in place; a running one is failed and
  its blocks freed. Both drain cleanly (sessions reusable, int8 scale
  state consistent).
* **graceful exhaustion** (paged engine) — `BlockPoolExhausted` never
  escapes `step()`: the step's partial allocations are rolled back
  (journal unwind in paged.py) and a victim is preempted instead.

`RobustnessCounters` is the shared per-engine counter bundle
(`engine.robust_counters.snapshot()`, the JAX snapshot's `robustness`
section).

Deadlines read the engine's serving clock (its Telemetry's clock,
`serve/telemetry.py` SERVING_CLOCK unless injected) unless
`AdmissionConfig.clock` pins another.
"""
from __future__ import annotations

import bisect
import dataclasses


class QueueFull(RuntimeError):
    """submit() under backpressure="reject" with the bounded queue full —
    raised before any engine or session state is touched, so the caller can
    retry or shed without cleanup."""


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """Knobs of the opt-in robustness layer (engines take `admission=`).

    max_queue:          queued-request bound (None/0 = unbounded).
    backpressure:       "reject" | "shed-lowest-priority" (see module doc).
    preemption:         priority preemption by block reclaim (paged only).
    graceful_exhaustion: catch BlockPoolExhausted inside step() and
                        preempt-or-shed instead of crashing (paged only).
    nan_check:          scan sampling rows for non-finite logits and fail
                        the slot with reason "nan_logits" (a per-step host
                        sync — meant for the chaos harness, not hot paths).
    max_device_retries: transient device-step failures retried this many
                        times before every live slot fails with reason
                        "device_error".
    clock:              deadline clock override (seconds; injectable for
                        tests). None — the default — means the engine's
                        serving clock, its Telemetry's clock.
    """
    max_queue: int | None = None
    backpressure: str = "reject"
    preemption: bool = True
    graceful_exhaustion: bool = True
    nan_check: bool = False
    max_device_retries: int = 3
    clock: object = None

    def __post_init__(self):
        if self.backpressure not in ("reject", "shed-lowest-priority"):
            raise ValueError(
                f"backpressure must be 'reject' or 'shed-lowest-priority', "
                f"got {self.backpressure!r}")
        if self.max_queue is not None and self.max_queue < 0:
            raise ValueError(f"max_queue must be >= 0, got {self.max_queue}")


def as_admission(admission, cfg=None):
    """Normalize an engine's `admission=` constructor argument: a config
    passes through, truthy builds the default config, and None falls back
    to the ModelConfig robustness fields (queue_limit / backpressure /
    preemption) — returning None when those are all off, which keeps the
    engine on the exact pre-robustness code path."""
    if isinstance(admission, AdmissionConfig):
        return admission
    if admission:
        return AdmissionConfig()
    if cfg is not None and (getattr(cfg, "queue_limit", 0)
                            or getattr(cfg, "preemption", False)):
        return AdmissionConfig(
            max_queue=getattr(cfg, "queue_limit", 0) or None,
            backpressure=getattr(cfg, "backpressure", "reject"),
            preemption=bool(getattr(cfg, "preemption", False)))
    return None


@dataclasses.dataclass
class _Entry:
    """One queued request: `key` orders the queue (highest priority first,
    FIFO within a class via the monotone submit seq), `submit_ts` anchors
    its deadlines. A re-queued (preempted) request keeps its ORIGINAL seq
    and submit_ts: it re-admits ahead of later arrivals of its class, and
    its SLA clock never restarts."""
    key: tuple
    seq: int
    submit_ts: float
    req: object


class AdmissionQueue:
    """Priority-ordered bounded queue (see module docstring). The engine
    reads it through `head()` / `pop_head()` and the len/bool protocol; all
    policy (bound, shed, priority order, deadline expiry) lives here so the
    engines' admission loops stay policy-free."""

    def __init__(self, config: AdmissionConfig):
        self.config = config
        self._entries: list[_Entry] = []
        self._seq = 0

    def __len__(self):
        return len(self._entries)

    def __bool__(self):
        return bool(self._entries)

    def __iter__(self):
        """Requests in admission order (highest class first)."""
        return (e.req for e in self._entries)

    def _insert(self, entry: _Entry):
        bisect.insort(self._entries, entry, key=lambda e: e.key)

    def push(self, req, *, now: float) -> list:
        """Enqueue under the bound/backpressure policy. Returns the requests
        SHED to stay within the bound (possibly `req` itself under
        shed-lowest-priority — the caller marks them failed); raises
        QueueFull under the reject policy WITHOUT enqueueing."""
        cap = self.config.max_queue
        if cap and len(self._entries) >= cap \
                and self.config.backpressure == "reject":
            raise QueueFull(
                f"admission queue full ({cap} queued); backpressure=reject")
        seq = self._seq
        self._seq += 1
        self._insert(_Entry((-int(getattr(req, "priority", 0)), seq),
                            seq, now, req))
        shed = []
        while cap and len(self._entries) > cap:
            # lowest class, most recently submitted: the LAST entry is the
            # lowest class's newest arrival by construction of the key
            shed.append(self._entries.pop().req)
        return shed

    def requeue(self, req, *, seq: int, submit_ts: float):
        """Re-enqueue a preempted request with its original seq/submit_ts
        (resume state rides on the request's own out_tokens). Bypasses the
        bound: the request was already admitted once — shedding it here
        would turn backpressure into silent cancellation of running work."""
        self._insert(_Entry((-int(getattr(req, "priority", 0)), seq),
                            seq, submit_ts, req))

    def head(self):
        return self._entries[0].req

    def pop_head(self) -> _Entry:
        return self._entries.pop(0)

    def head_entry(self) -> _Entry:
        return self._entries[0]

    def remove(self, uid) -> object | None:
        """Remove and return the queued request with this uid (None when not
        queued)."""
        for i, e in enumerate(self._entries):
            if e.req.uid == uid:
                return self._entries.pop(i).req
        return None

    def expire(self, now: float) -> list[tuple]:
        """Remove queued requests past a deadline; returns [(req, reason)].
        A request past BOTH deadlines reports the TTFT one (it comes first
        by definition: first token precedes finish)."""
        out, keep = [], []
        for e in self._entries:
            age = now - e.submit_ts
            ttft = getattr(e.req, "deadline_ttft", None)
            e2e = getattr(e.req, "deadline_e2e", None)
            if ttft is not None and age > ttft:
                out.append((e.req, "deadline_ttft"))
            elif e2e is not None and age > e2e:
                out.append((e.req, "deadline_e2e"))
            else:
                keep.append(e)
        self._entries = keep
        return out


def choose_victim(live_slots, priorities, admit_seq, *, below=None):
    """The preemption victim policy: among live slots, the LOWEST priority
    class, most recently admitted within it (newest work loses least).
    `below` restricts victims to classes strictly below it (priority
    preemption must not evict an equal-or-higher class); None considers
    every live slot (graceful-exhaustion reclaim, where freeing anything
    beats crashing). Returns the slot index or None."""
    best = None
    for slot in live_slots:
        p = int(priorities[slot])
        if below is not None and p >= below:
            continue
        k = (p, -int(admit_seq[slot]))
        if best is None or k < best[0]:
            best = (k, int(slot))
    return None if best is None else best[1]


_CLASS_KEYS = ("submitted", "admitted", "finished", "preempted",
               "deadline_misses", "shed", "rejected", "cancelled")


class RobustnessCounters:
    """Per-engine robustness counter bundle (the JAX telemetry snapshot's
    `robustness` section). Engines bump the public attributes and per-class
    dicts (`klass(priority)`); `snapshot()` is the JSON-ready view with
    derived rates."""

    def __init__(self):
        self.preemptions = 0
        self.exhaustion_events = 0
        self.device_retries = 0
        self.cancelled = 0
        self.shed = 0
        self.rejected = 0
        self.deadline_miss_ttft = 0
        self.deadline_miss_e2e = 0
        # re-prefill telemetry over RESUMED admissions only: tokens is the
        # full re-fed sequence length, skipped the prefix-trie-matched part
        self.reprefill_tokens = 0
        self.reprefill_skipped = 0
        self.per_class: dict[int, dict] = {}

    def klass(self, priority) -> dict:
        return self.per_class.setdefault(
            int(priority), {k: 0 for k in _CLASS_KEYS})

    def snapshot(self) -> dict:
        return dict(
            preemptions=self.preemptions,
            exhaustion_events=self.exhaustion_events,
            device_retries=self.device_retries,
            cancelled=self.cancelled,
            shed=self.shed,
            rejected=self.rejected,
            deadline_misses=dict(ttft=self.deadline_miss_ttft,
                                 e2e=self.deadline_miss_e2e,
                                 total=(self.deadline_miss_ttft
                                        + self.deadline_miss_e2e)),
            reprefill=dict(tokens=self.reprefill_tokens,
                           skipped=self.reprefill_skipped,
                           skip_rate=(self.reprefill_skipped
                                      / max(self.reprefill_tokens, 1))),
            per_class={str(p): dict(c)
                       for p, c in sorted(self.per_class.items())})
