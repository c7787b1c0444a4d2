"""How `correct` is decided for a served cell.

Once the window has closed, a sample of the requests it finished, drawn
from the seed and always holding the longest, is recomputed by the
configuration's plain reference (bench/reference/<model>.py, through its
model module's `logits_at`) over each prompt with its served tokens. At
every served position, two numbers:

  gap        reference's best logit - reference's logit of the served token
  logit_err  |the engine's own logit of the token it served - the
             reference's logit of that token|

and over the sample `gap` and `logit_err` at their widest, and
`logit_rms`, the root mean square of logit_err over every position.

The engine's own logit is read on the timed path, as it sampled
(`OwnLogits`, the engine's device seam wrapped). A cell limits
(bench/cells/<cell>.json) the numbers whose readings under its precision
control exceed the sound program's threefold or more. The control
(bench/control.py) puts the reference in e4m3 in the engine's place: its
own logit and served token are those of its own argmax at each of the
same positions."""
from __future__ import annotations

import numpy as np
import torch

# positions whose logit error exceeds TAIL are counted (`over_tail`, a
# diagnostic beside the compared numbers)
TAIL = 0.05


class OwnLogits:
    """The engine's own logit of each token it samples, copied from the
    LogitTap of the port's chip smoke: the device seam is wrapped to keep
    the largest logit of each returned row (greedy serving samples it),
    and each step files it under (uid, index of the token). The values
    stay on the device until `own` is read, so no host sync is added."""

    def __init__(self, eng):
        self._filed, self._last = [], None
        seam = eng._packed_fn

        def wrapped(*args):
            logits, cache = seam(*args)
            self._last = (logits.float().max(-1).values,
                          [(int(s), eng._slots[s],
                            len(eng._slots[s].out_tokens))
                           for s in np.flatnonzero(eng._live)
                           if eng._slots[s] is not None])
            return logits, cache
        eng._packed_fn = wrapped
        step = eng.step

        def stepped():
            self._last = None
            out = step()
            if self._last is not None:
                vals, live = self._last
                self._filed.append((vals, [(s, req, n0) for s, req, n0 in
                                           live if len(req.out_tokens) > n0]))
            return out
        eng.step = stepped

    def own(self) -> dict:
        out = {}
        for vals, live in self._filed:
            v = vals.cpu().numpy()
            for s, req, n0 in live:
                out[(req.uid, n0)] = float(v[s])
        return out


def sample(done, seed: int, n: int) -> list:
    """n requests of `done` (dicts with uid, prompt, out), the longest
    (prompt + served tokens) always among them, the rest drawn from the
    seed."""
    if not done:
        return []
    order = sorted(done, key=lambda r: (-(len(r["prompt"]) + len(r["out"])),
                                        r["uid"]))
    rest = order[1:]
    rng = np.random.default_rng([seed, 7])
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [order[0]] + [rest[i] for i in sorted(pick)]


def reference_logits(model, weights, hccs, cfg, reqs, cast=None):
    """The reference's logits (the model module's `logits_at`) at each
    served position of each request: the sequence is the prompt and every
    served token but the last, the rows the prompt's last position
    onwards."""
    dev = weights["embed"]["table"].device
    seqs, rows = [], []
    for r in reqs:
        p, o = np.asarray(r["prompt"]), np.asarray(r["out"])
        seq = np.concatenate([p, o[:-1]]).astype(np.int64)
        seqs.append(torch.as_tensor(seq, device=dev))
        rows.append(torch.arange(len(p) - 1, len(seq), device=dev))
    with torch.no_grad():
        return model.logits_at(weights, hccs, seqs, rows, cfg, cast)


def readings(ref, reqs, own) -> dict:
    """Widest gap and logit error, and the RMS logit error, of the served
    tokens against the reference logits `ref` (one (R_i, V) tensor a
    request)."""
    gap = err = sq = 0.0
    n = over = 0
    for lg, r in zip(ref, reqs):
        tok = torch.as_tensor(np.asarray(r["out"], np.int64),
                              device=lg.device)
        at = lg.gather(1, tok[:, None])[:, 0]
        gap = max(gap, float((lg.max(-1).values - at).max()))
        mine = torch.tensor([own.get((r["uid"], i), float("nan"))
                             for i in range(len(r["out"]))],
                            dtype=torch.float32, device=lg.device)
        e = (mine - at).abs()
        e = torch.nan_to_num(e, nan=float("inf"))
        err = max(err, float(e.max()))
        sq += float(e.square().sum())
        over += int((e > TAIL).sum())
        n += len(r["out"])
    return dict(gap=gap, logit_err=err, logit_rms=(sq / max(n, 1)) ** 0.5,
                tokens=n, over_tail=over)


def control_readings(ref, low) -> dict:
    """The control's readings: at each position the lower precision's own
    first token and logit (`low`, one (R_i, V) tensor a request), held to
    the reference `ref` as a served token is."""
    gap = err = sq = 0.0
    n = over = 0
    for lg, lo in zip(ref, low):
        pick = lo.argmax(-1, keepdim=True)
        at = lg.gather(1, pick)[:, 0]
        gap = max(gap, float((lg.max(-1).values - at).max()))
        e = (lo.gather(1, pick)[:, 0] - at).abs()
        err = max(err, float(e.max()))
        sq += float(e.square().sum())
        over += int((e > TAIL).sum())
        n += e.numel()
    return dict(gap=gap, logit_err=err, logit_rms=(sq / max(n, 1)) ** 0.5,
                over_tail=over)


def verdict(values: dict, limits: dict) -> tuple[bool, dict]:
    """correct, and {name: {"value", "limit"}} for every limited number; a
    number over its limit, or a limit with no number, is not correct."""
    checks = {k: {"value": values.get(k), "limit": v}
              for k, v in limits.items()}
    ok = bool(limits) and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in checks.values())
    return ok, checks
