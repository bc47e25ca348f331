"""Checkpoint / resume.

The reference's only "checkpoint" is the immutable .ply itself (SURVEY.md §5:
re-parse file = resume). Here both layers exist:

  * `save_ply` / `load_ply`: the canonical interchange format — exported
    scenes load in the reference viewer and the INRIA toolchain (io.ply).
  * the full training state (params + optimizer + step, and the loop's
    densification state and iteration) as one `.npz` of the flattened
    pytree's leaves, restored into the structure of a template built from
    the same model shape and optimizer. The tree structure and every
    leaf's shape and dtype are checked against the template.
"""

from __future__ import annotations

import os
from typing import Optional

import jax

from ..io.ply import read_ply, write_ply
from ..models.gaussian_model import GaussianModel
from .trainer import TrainState


def save_ply(state_or_model, path: str, active_sh_degree: Optional[int] = None):
    model = state_or_model.params if isinstance(state_or_model, TrainState) \
        else state_or_model
    write_ply(jax.device_get(model.to_cloud(active_sh_degree)), path)


def load_ply_model(path: str) -> GaussianModel:
    return GaussianModel.from_cloud(read_ply(path))


STATE_FILE = "state.npz"


def _save_tree(tree, path: str) -> None:
    """Write `tree`'s leaves (host copies) and its structure to
    `path`/state.npz, replacing any earlier file in one rename."""
    import numpy as np

    leaves, treedef = jax.tree_util.tree_flatten(jax.device_get(tree))
    arrays = {f"leaf_{i:05d}": np.asarray(x) for i, x in enumerate(leaves)}
    arrays["treedef"] = np.asarray(str(treedef))
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, STATE_FILE + ".tmp.npz")
    np.savez(tmp, **arrays)
    os.replace(tmp, os.path.join(path, STATE_FILE))


def _load_tree(path: str, template):
    """Read `path`/state.npz into the structure of `template`; raise
    ValueError if the structure, a shape or a dtype differs."""
    import numpy as np

    t_leaves, treedef = jax.tree_util.tree_flatten(jax.device_get(template))
    with np.load(os.path.join(path, STATE_FILE), allow_pickle=False) as z:
        if str(z["treedef"]) != str(treedef):
            raise ValueError(
                f"checkpoint {path} holds another tree structure than the "
                f"template")
        if len(z.files) - 1 != len(t_leaves):
            raise ValueError(f"checkpoint {path} holds {len(z.files) - 1} "
                             f"leaves, the template {len(t_leaves)}")
        leaves = []
        for i, t in enumerate(t_leaves):
            x = z[f"leaf_{i:05d}"]
            t = np.asarray(t)
            if x.shape != t.shape or x.dtype != t.dtype:
                raise ValueError(
                    f"checkpoint {path} leaf {i}: {x.dtype}{list(x.shape)} "
                    f"where the template has {t.dtype}{list(t.shape)}")
            leaves.append(x)
    return jax.tree_util.tree_unflatten(treedef, leaves)


def save_train_state(state: TrainState, path: str) -> None:
    _save_tree(state, path)


def restore_train_state(path: str, template: TrainState) -> TrainState:
    """Restore into the structure of `template` (built from the same model
    shape + optimizer)."""
    return _load_tree(path, template)


def has_checkpoint(path: Optional[str]) -> bool:
    return bool(path) and os.path.isfile(os.path.join(path, STATE_FILE))


def save_loop_state(state, dstate, it: int, path: str) -> None:
    """Persist the FULL training-loop state (TrainState + DensifyState +
    iteration) — what checkpoint-restart (`parallel.multihost.
    run_with_restarts`, `cli train --restarts`) resumes from."""
    _save_tree({"state": state, "dstate": dstate, "it": it}, path)


def restore_loop_state(path: str, state_template, dstate_template):
    """Inverse of save_loop_state → (state, dstate, it). Templates must be
    built from the same model capacity + optimizer."""
    import numpy as np

    r = _load_tree(path, {"state": state_template, "dstate": dstate_template,
                          "it": np.asarray(0)})
    return r["state"], r["dstate"], int(r["it"])
