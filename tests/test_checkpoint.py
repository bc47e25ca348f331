"""Training-state checkpoints (train/checkpoint.py): an .npz of the
flattened pytree, restored into a template's structure, with no orbax."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gaussian_splatting_web_tpu.models.gaussian_model import GaussianModel
from gaussian_splatting_web_tpu.train.checkpoint import (
    STATE_FILE, has_checkpoint, restore_loop_state, restore_train_state,
    save_loop_state, save_train_state,
)
from gaussian_splatting_web_tpu.train.densify import pad_to_capacity
from gaussian_splatting_web_tpu.train.trainer import (
    TrainState, make_optimizer,
)
from tests.conftest import make_random_cloud


def _state(n, sh_degree, seed=0):
    model = GaussianModel.from_cloud(
        make_random_cloud(n, seed=seed, sh_degree=sh_degree))
    params, dstate = pad_to_capacity(model, 2 * n)
    opt = make_optimizer(scene_extent=1.0)
    state = TrainState(params=params, opt_state=opt.init(params),
                       step=jnp.asarray(7, jnp.int32))
    return state, dstate


def _assert_trees_equal(a, b):
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("sh_degree", [0, 2])
def test_loop_state_roundtrip(tmp_path, sh_degree):
    """Every leaf comes back bit for bit — SH degree 0 included, whose
    sh_rest leaves (and their Adam moments) have zero size."""
    state, dstate = _state(16, sh_degree)
    if sh_degree == 0:
        assert state.params.sh_rest.size == 0
    d = str(tmp_path / "ckpt")
    assert not has_checkpoint(d)
    save_loop_state(state, dstate, 40, d)
    assert has_checkpoint(d)
    t_state, t_dstate = _state(16, sh_degree, seed=1)
    s2, d2, it = restore_loop_state(d, t_state, t_dstate)
    assert it == 40
    _assert_trees_equal(s2, state)
    _assert_trees_equal(d2, dstate)


def test_train_state_roundtrip_and_overwrite(tmp_path):
    d = str(tmp_path / "final")
    a, _ = _state(8, 1, seed=0)
    b, _ = _state(8, 1, seed=2)
    save_train_state(a, d)
    save_train_state(b, d)                 # replaces, leaves no temp file
    assert sorted(os.listdir(d)) == [STATE_FILE]
    _assert_trees_equal(restore_train_state(d, a), b)


def test_restore_refuses_another_shape(tmp_path):
    """A template of another capacity is an error, not a silent reshape."""
    d = str(tmp_path / "ckpt")
    state, dstate = _state(16, 1)
    save_loop_state(state, dstate, 5, d)
    other, other_d = _state(12, 1)
    with pytest.raises(ValueError, match="leaf"):
        restore_loop_state(d, other, other_d)
    with pytest.raises(ValueError, match="structure"):
        restore_train_state(d, other)
