"""The rows of `generalize_shapes` and `generalize_smoke` (`ROW_CASES`)
against the JAX package's (`tests/test_torch_generalize.py`'s inputs and
tolerances). In a file of their own, of at most five tests, because their
JAX compiles take most of that file's time.
"""

import numpy as np
import pytest

from test_torch_generalize import (
    ROW_CASES,
    _rows,
)


@pytest.mark.parametrize("case", sorted(ROW_CASES))


def test_row_matches_jax(case):
    jrow, trow = _rows(case)
    assert set(trow) == set(jrow)
    for key in ("final_state_mse", "zero_force_final_mse",
                "ratio_vs_zero_force"):
        np.testing.assert_allclose(trow[key], jrow[key], rtol=1e-5,
                                   err_msg=key)
    if case == "smoke-perturbed":  # the controller acts
        assert abs(trow["ratio_vs_zero_force"] - 1.0) > 1e-3
