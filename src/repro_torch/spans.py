"""Named ranges of the program on the device trace's clock.

    with span("repro.attn"):
        ...

While a `torch.profiler` records, `span(name)` is a
`torch.profiler.record_function(name)` range: the profiler stamps it on
the clock of the kernels and CUDA runtime calls it records, so a reader
can put each kernel launch, host wait and idle gap down to the innermost
range around it. Otherwise `span` returns the shared null context `NULL`:
one test of the profiler's state, no allocation, no device fence.

The models and the serving engines both import it from here;
`serve/telemetry.py` re-exports it beside the step profiler. Every name
starts with `repro.`.
"""
from __future__ import annotations

import contextlib

import torch

NULL = contextlib.nullcontext()


def span(name: str):
    """A `record_function` range named `name` while a profiler records,
    else the shared null context."""
    if not torch.autograd._profiler_enabled():
        return NULL
    return torch.profiler.record_function(name)
