"""Property tests of the port's HCCS core (`repro_torch/core`): the twin of
tests/test_hccs_properties.py, fuzzed with hypothesis, each case also held
bit-for-bit against the JAX package's hccs_int / leading_bit on the same
integers.
"""
import torch_threads  # noqa: F401  (first: one torch thread a worker)
from conftest import require_hypothesis

hypothesis = require_hypothesis()

import hypothesis.strategies as st  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from hypothesis import given, settings  # noqa: E402

from repro.core import HCCSParams as JParams  # noqa: E402
from repro.core import hccs_int as jax_hccs_int  # noqa: E402
from repro.core import leading_bit as jax_leading_bit  # noqa: E402
from repro_torch.core.constraints import (default_params,  # noqa: E402
                                          feasible_grid, is_feasible,
                                          validate_params)
from repro_torch.core.hccs import (MODES, HCCSParams, hccs_int,  # noqa: E402
                                   leading_bit)


def make_params(B, S, D):
    i32 = (lambda v: torch.tensor(v, dtype=torch.int32))
    return HCCSParams(B=i32(B), S=i32(S), D=i32(D))


def _jax(row, B, S, D, mode):
    p = JParams(B=jnp.int32(B), S=jnp.int32(S), D=jnp.int32(D))
    return np.asarray(jax_hccs_int(jnp.asarray(row)[None], p, mode))[0]


@st.composite
def rows_and_params(draw):
    n = draw(st.integers(4, 256))
    B, S, D = default_params(n)
    row = draw(st.lists(st.integers(-128, 127), min_size=n, max_size=n))
    return np.asarray(row, np.int32), (B, S, D), n


class TestInvariantProperties:
    @settings(max_examples=80, deadline=None)
    @given(rows_and_params())
    def test_nonnegative_bounded_unit_sum(self, data):
        row, (B, S, D), n = data
        p = make_params(B, S, D)
        for mode in MODES:
            out = hccs_int(torch.tensor(row)[None], p, mode)[0].numpy()
            np.testing.assert_array_equal(out, _jax(row, B, S, D, mode))
            T = 32767 if mode.startswith("i16") else 255
            assert (out >= 0).all() and (out <= T).all(), mode
            if mode == "i16_div":
                delta = np.minimum(row.max() - row, D)
                Z = int((B - S * delta).sum())
                assert T - Z < out.sum() <= T

    @settings(max_examples=80, deadline=None)
    @given(rows_and_params())
    def test_monotonicity_order_preserved(self, data):
        row, (B, S, D), n = data
        out = hccs_int(torch.tensor(row)[None], make_params(B, S, D),
                       "i16_div")[0].numpy()
        order = np.argsort(row, kind="stable")
        assert (np.diff(out[order]) >= 0).all()

    @settings(max_examples=50, deadline=None)
    @given(rows_and_params(), st.integers(-20, 20))
    def test_shift_invariance(self, data, c):
        row, (B, S, D), n = data
        shifted = np.clip(row.astype(np.int64) + c, -128, 127).astype(
            np.int32)
        if not np.array_equal(np.clip(row + c, -128, 127) - c, row):
            return                            # clipping destroyed the shift
        p = make_params(B, S, D)
        a = hccs_int(torch.tensor(row)[None], p, "i16_div")
        b = hccs_int(torch.tensor(shifted)[None], p, "i16_div")
        assert torch.equal(a, b)


class TestConstraintProperties:
    @settings(max_examples=40, deadline=None)
    @given(st.integers(4, 4096))
    def test_feasible_grid_is_feasible(self, n):
        g = feasible_grid(n, num_b=4, num_s=4, d_values=(16, 64, 127))
        assert len(g) > 0
        for B, S, D in g:
            assert is_feasible(int(B), int(S), int(D), n)
            validate_params(B, S, D, n)

    @settings(max_examples=60, deadline=None)
    @given(st.integers(1, 2 ** 30))
    def test_leading_bit_brackets(self, z):
        k = int(leading_bit(torch.tensor(z, dtype=torch.int32)))
        assert 2 ** k <= z < 2 ** (k + 1)
        assert k == int(np.asarray(jax_leading_bit(jnp.int32(z))))
