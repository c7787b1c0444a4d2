"""The paper's two BERT encoders at their full size in the port against the
JAX package on the same weights: one forward and one train step with
cls_loss on the synthetic classification task, held to the tolerances of
test_torch_arch_smoke.py (its docstring), which holds every other arch of
the registry."""
import torch_threads  # noqa: F401  (first: one torch thread a worker)
import pytest

from test_torch_arch_smoke import ENCODERS, forward_and_train_step


@pytest.mark.parametrize("arch", ENCODERS)
def test_forward_and_train_step(arch):
    forward_and_train_step(arch)
