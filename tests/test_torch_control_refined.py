"""The 'refined' sequence class's loss and each trainable net's gradient
against the JAX package's (`tests/test_torch_control.py`'s (a), its apps
and tolerances). In a file of its own, of at most five tests, because its
JAX compile is the slowest of that file's classes.
"""

import pytest

from test_torch_control import _CLASSES, _check_class_gradients, _check_class_loss

CLS = "refined"


@pytest.mark.parametrize("cls", [CLS])
def test_class_loss_matches_jax(cls):
    _check_class_loss(cls)


@pytest.mark.parametrize("cls,net", [(CLS, n) for n in _CLASSES[CLS]])
def test_class_gradients_match_jax(cls, net):
    _check_class_gradients(cls, net)
