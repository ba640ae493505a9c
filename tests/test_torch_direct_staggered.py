"""The loss and each trainable net's gradient of the staggered class at n = 4 with the direct two-channel force, against the JAX
package (`tests/test_torch_direct.py`'s case `direct_staggered`, inputs and
tolerances). In a file of its own, of at most five tests, because its JAX
compile is the slowest part of that file.
"""

import pytest

from test_torch_direct import _CASES, _check_gradients, _check_loss

NAME = "direct_staggered"


@pytest.mark.parametrize("name", [NAME])
def test_loss_matches_jax(name):
    _check_loss(name)


@pytest.mark.parametrize("name, net", [
    (NAME, net) for net in _CASES[NAME][2]["trainable_networks"]])
def test_gradients_match_jax(name, net):
    _check_gradients(name, net)
