"""One torch thread in each test process of the twins (tests/test_torch_*.py).

The tier-1 run spreads the suite over six pytest-xdist workers on one host,
and torch's default of one OpenMP thread a core in every worker
oversubscribes the cores: six concurrent copies of the unprofiled-step tests
of test_torch_async_chaos.py took 161 s with eight threads each and 13 s
with one on an 8-core host. The twins' tensors are small, so one thread
loses little on its own. Every twin module imports this one first.
"""
import torch

torch.set_num_threads(1)
