"""Adaptive density control (INRIA §5.2: clone / split / prune / opacity
reset) under XLA static shapes.

The reference never trains (SURVEY.md intro), so this subsystem is new
capability. The INRIA CUDA implementation reallocates tensors every
densification step; that's hostile to jit/pjit, so here the model lives in a
fixed-capacity arena:

  * the model holds `capacity` slots; an `alive` bool mask marks real
    gaussians (dead slots render as opacity −∞);
  * clone/split allocate children into free slots via `jnp.nonzero(...,
    size=capacity)` prefix allocation — everything stays fixed-shape and
    jittable, overflow simply defers growth to the next round;
  * prune just clears `alive` bits.

Densification pressure is driven by the accumulated norm of the loss
gradient w.r.t. screen-space splat centers (the INRIA criterion), which
falls out of jax.grad on ProjectedSplats.mean2d.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

from ..models.gaussian_model import GaussianModel

DEAD_OPACITY = -100.0  # sigmoid ≈ 0: dead slots never rasterize


@dataclasses.dataclass
class DensifyState:
    grad_accum: jax.Array   # [C] accumulated ||d loss / d mean2d||
    denom: jax.Array        # [C] number of accumulations
    alive: jax.Array        # [C] bool
    # [C] max projected pixel radius seen since the last densify round —
    # INRIA's max_radii2D, driving the >20 px screen-size prune (their
    # prune_points big_points_vs). None = not tracked (legacy states).
    max_radius2d: jax.Array | None = None

    @property
    def capacity(self) -> int:
        return self.alive.shape[0]


jax.tree_util.register_dataclass(
    DensifyState,
    data_fields=["grad_accum", "denom", "alive", "max_radius2d"],
    meta_fields=[],
)


def pad_to_capacity(model: GaussianModel, capacity: int
                    ) -> Tuple[GaussianModel, DensifyState]:
    """Place a model into a fixed-capacity arena."""
    n = model.num_gaussians
    if capacity < n:
        raise ValueError(f"capacity {capacity} < model size {n}")
    pad = capacity - n

    def padf(x, fill=0.0):
        width = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, width, constant_values=fill)

    padded = GaussianModel(
        xyz=padf(model.xyz),
        log_scale=padf(model.log_scale),
        quat=padf(model.quat),
        opacity_logit=padf(model.opacity_logit, DEAD_OPACITY),
        sh_dc=padf(model.sh_dc),
        sh_rest=padf(model.sh_rest),
    )
    alive = jnp.arange(capacity) < n
    zeros = jnp.zeros((capacity,), jnp.float32)
    return padded, DensifyState(grad_accum=zeros, denom=zeros, alive=alive,
                                max_radius2d=zeros)


def accumulate_stats(state: DensifyState, d_mean2d: jnp.ndarray,
                     visible: jnp.ndarray,
                     radius2d: jnp.ndarray | None = None) -> DensifyState:
    """Add this step's screen-space positional gradient norms for visible
    splats (INRIA add_densification_stats), and max-accumulate the
    projected pixel radius (INRIA's per-iteration max_radii2D update)."""
    norm = jnp.linalg.norm(d_mean2d, axis=-1)
    vis = visible & state.alive
    mr = state.max_radius2d
    if mr is not None and radius2d is not None:
        mr = jnp.maximum(mr, jnp.where(vis, radius2d, 0.0))
    return DensifyState(
        grad_accum=state.grad_accum + jnp.where(vis, norm, 0.0),
        denom=state.denom + vis.astype(jnp.float32),
        alive=state.alive,
        max_radius2d=mr,
    )


def _alloc(free_ok: jnp.ndarray, want: jnp.ndarray):
    """Map the k-th wanting source to the k-th free slot. Returns
    (src_idx [C], dst_idx [C], pair_live [C])."""
    c = free_ok.shape[0]
    free_idx = jnp.nonzero(free_ok, size=c, fill_value=0)[0]
    src_idx = jnp.nonzero(want, size=c, fill_value=0)[0]
    n_pairs = jnp.minimum(jnp.sum(free_ok), jnp.sum(want))
    k = jnp.arange(c)
    return src_idx, free_idx, k < n_pairs


def densify_and_prune(
    model: GaussianModel,
    state: DensifyState,
    key: jax.Array,
    grad_threshold: float = 2e-4,
    percent_dense: float = 0.01,
    scene_extent: float = 1.0,
    min_opacity: float = 0.005,
    max_world_radius_frac: float | None = None,
    max_screen_size: float | jax.Array | None = None,
) -> Tuple[GaussianModel, DensifyState, jax.Array]:
    """One INRIA densification round (jittable, fixed shapes).

    Faithful to INRIA densify_and_clone / densify_and_split:
      * clone: exact copy into a free slot (source untouched);
      * split: N=2 children, BOTH resampled from the source gaussian with
        scale ÷ (0.8·N) = 1.6, and the source pruned — not the round-1
        1-child + shrink-in-place shortcut.
    Under the fixed arena, allocation happens in two prefix passes (child #1
    for every hot source, child #2 for split sources); a split source is
    pruned only if both of its children were actually placed, so arena
    overflow degrades to a clone instead of losing mass.

    Returns (model, state, changed): `changed` marks slots whose contents
    were (re)written or freed this round — the rows whose Adam moments the
    caller must zero (INRIA zeroes exactly the new rows; see
    train_loop.reset_opt_rows).
    """
    c = state.capacity
    avg_grad = state.grad_accum / jnp.maximum(state.denom, 1.0)
    max_scale = jnp.exp(jnp.max(model.log_scale, axis=-1))
    dense_limit = percent_dense * scene_extent

    hot = state.alive & (avg_grad >= grad_threshold)
    clone_mask = hot & (max_scale <= dense_limit)
    split_mask = hot & (max_scale > dense_limit)

    from ..ops.projection import quat_to_rotmat

    def make_children(src, sub):
        """Children gathered at `src`; split sources resampled + shrunk."""
        child = jax.tree_util.tree_map(lambda x: x[src], model)
        is_split = split_mask[src]
        noise = jax.random.normal(sub, (c, 3))
        R = quat_to_rotmat(child.quat)
        offset = jnp.einsum(
            "nij,nj->ni", R, noise * jnp.exp(child.log_scale),
            precision=jax.lax.Precision.HIGHEST,
        )
        return dataclasses.replace(
            child,
            xyz=jnp.where(is_split[:, None], child.xyz + offset, child.xyz),
            log_scale=jnp.where(
                is_split[:, None], child.log_scale - jnp.log(1.6),
                child.log_scale,
            ),
        )

    def placed_mask(src, live):
        return (
            jnp.zeros((c,), bool)
            .at[jnp.where(live, src, c)]
            .set(True, mode="drop")
        )

    key1, key2 = jax.random.split(key)
    free = ~state.alive
    changed = jnp.zeros((c,), bool)

    # pass 1: one child per hot source (clone copy or split child #1)
    src1, dst1, live1 = _alloc(free, clone_mask | split_mask)
    child1 = make_children(src1, key1)
    # pass 2: split child #2, from the free slots pass 1 didn't take
    taken1 = placed_mask(dst1, live1)
    src2, dst2, live2 = _alloc(free & ~taken1, split_mask)
    child2 = make_children(src2, key2)

    def scatter(dst_arr, child_arr, dst, live):
        idx = jnp.where(live, dst, c)  # c → dropped
        return dst_arr.at[idx].set(child_arr, mode="drop")

    new_model = jax.tree_util.tree_map(
        lambda a, ch: scatter(a, ch, dst1, live1), model, child1
    )
    new_model = jax.tree_util.tree_map(
        lambda a, ch: scatter(a, ch, dst2, live2), new_model, child2
    )
    alive = state.alive | taken1 | placed_mask(dst2, live2)
    changed = changed | taken1 | placed_mask(dst2, live2)

    # prune split sources whose both children were placed (INRIA
    # densify_and_split ends with prune_points(selected))
    fully_split = (
        split_mask & placed_mask(src1, live1) & placed_mask(src2, live2)
    )
    alive = alive & ~fully_split
    changed = changed | fully_split

    # --- prune ----------------------------------------------------------
    opacity = jax.nn.sigmoid(new_model.opacity_logit)
    dead = opacity < min_opacity
    if max_world_radius_frac is not None:
        # INRIA prunes oversized gaussians only in later iterations; enable
        # by passing a fraction of the scene extent
        dead = dead | (
            jnp.exp(jnp.max(new_model.log_scale, axis=-1))
            > max_world_radius_frac * scene_extent
        )
    if max_screen_size is not None and state.max_radius2d is not None:
        # INRIA's big_points_vs prune: splats whose projected radius
        # exceeded max_screen_size px (20 in the paper) since the last
        # round. At low render resolutions this is the pressure that
        # stops the model fitting with screen-filling blobs; may be a
        # traced scalar (inf = disabled) so callers can gate it by
        # iteration without recompiling.
        dead = dead | (state.max_radius2d > max_screen_size)
    changed = changed | (alive & dead)
    alive = alive & ~dead

    # dead slots must never rasterize
    new_model = dataclasses.replace(
        new_model,
        opacity_logit=jnp.where(alive, new_model.opacity_logit, DEAD_OPACITY),
    )

    zeros = jnp.zeros((c,), jnp.float32)
    return (
        new_model,
        DensifyState(grad_accum=zeros, denom=zeros, alive=alive,
                     max_radius2d=(None if state.max_radius2d is None
                                   else zeros)),
        changed,
    )


def reset_opacity(model: GaussianModel, alive: jnp.ndarray,
                  max_opacity: float = 0.01) -> GaussianModel:
    """INRIA periodic opacity reset: clamp opacity to ≤ max_opacity."""
    cap_logit = jnp.log(max_opacity / (1 - max_opacity)).astype(jnp.float32)
    new_logit = jnp.minimum(model.opacity_logit, cap_logit)
    return dataclasses.replace(
        model,
        opacity_logit=jnp.where(alive, new_logit, DEAD_OPACITY),
    )


def compact(model: GaussianModel, state: DensifyState) -> GaussianModel:
    """Drop dead slots (host-side, for export)."""
    import numpy as np

    alive = np.asarray(state.alive)
    return jax.tree_util.tree_map(lambda x: jnp.asarray(np.asarray(x)[alive]),
                                  model)
