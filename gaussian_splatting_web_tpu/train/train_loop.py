"""Full 3DGS training loop: photometric optimization + adaptive density
control + progressive SH, against posed images (io.dataset).

The INRIA recipe re-expressed jit-first:
  * one jitted step computes loss, parameter grads, AND the screen-space
    positional gradients that drive densification — the latter via a
    zero-valued auxiliary parameter added to the projected means (its
    gradient IS d loss / d mean2d, with no second pass);
  * densification/pruning runs every `densify_every` steps as a jitted
    fixed-shape arena update (train.densify); Adam moments are zeroed
    per-row for exactly the slots the round rewrote or freed
    (reset_opt_rows — INRIA's cat_tensors_to_optimizer/prune semantics),
    surviving gaussians keep their moments;
  * opacity reset every `opacity_reset_every`; SH degree unlocks one band
    every `sh_upgrade_every` (INRIA oneupSHdegree).
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Callable, List, Optional

import jax
import jax.numpy as jnp
import optax

from ..config import RenderConfig
from ..core.types import CameraParams
from ..io.dataset import View, scene_extent
from ..models.gaussian_model import GaussianModel
from ..ops.projection import project_gaussians
from ..ops.rasterize import rasterize_tiles
from ..ops.sort import bin_splats
from .densify import (
    DensifyState, accumulate_stats, densify_and_prune, pad_to_capacity,
    reset_opacity,
)
from .loss import photometric_loss
from .trainer import TrainState, make_optimizer


def reset_opt_rows(opt_state, changed: jnp.ndarray):
    """Zero per-gaussian optimizer moments at `changed` rows.

    INRIA's densification surgically zeroes exp_avg/exp_avg_sq for new rows
    (cat_tensors_to_optimizer) and drops pruned rows' state
    (_prune_optimizer); in the fixed-capacity arena both become "zero the
    moment rows the round touched". Every opt-state leaf whose leading
    dimension matches the arena capacity is a per-row moment (Adam mu/nu
    over the GaussianModel pytree); scalars (step counts, schedules) pass
    through untouched.
    """
    c = changed.shape[0]

    def fix(x):
        if hasattr(x, "ndim") and x.ndim >= 1 and x.shape[0] == c:
            mask = changed.reshape((c,) + (1,) * (x.ndim - 1))
            return jnp.where(mask, jnp.zeros_like(x), x)
        return x

    return jax.tree_util.tree_map(fix, opt_state)


def reset_opt_opacity(opt_state, capacity: int):
    """Zero the opacity moments for all rows (INRIA reset_opacity replaces
    the opacity tensor in the optimizer with zeroed state,
    replace_tensor_to_optimizer)."""

    def fix(path, x):
        is_opacity = any(
            getattr(p, "name", "") == "opacity_logit" for p in path
        )
        if (is_opacity and hasattr(x, "ndim") and x.ndim >= 1
                and x.shape[0] == capacity):
            return jnp.zeros_like(x)
        return x

    return jax.tree_util.tree_map_with_path(fix, opt_state)


@dataclasses.dataclass(frozen=True)
class TrainLoopConfig:
    iterations: int = 7000
    densify_from: int = 500
    densify_until: int = 5000
    densify_every: int = 300
    opacity_reset_every: int = 3000
    sh_upgrade_every: int = 1000
    grad_threshold: float = 2e-4
    percent_dense: float = 0.01
    min_opacity: float = 0.005
    # INRIA prunes world-space-huge gaussians (scales.max > 0.1·extent)
    # once training is past the first opacity reset — without it, splats
    # that drift large stay large (and at low render resolutions their
    # footprints can exceed the binning caps, zeroing their gradients — a
    # ratchet: they can never shrink back; the r5 training-plateau
    # diagnosis measured 42k/64k splats overflowing). None disables.
    world_radius_frac: float | None = 0.1
    world_prune_from: int = 3000
    # INRIA's max_screen_size prune (20 px): splats whose projected
    # radius exceeded this since the last densify round are pruned, past
    # world_prune_from. The screen-space counterpart of the world-radius
    # prune — at low render resolutions this is the pressure that stops
    # the fit degenerating into screen-filling blobs. None disables.
    screen_size_px: float | None = 20.0
    lambda_dssim: float = 0.2
    capacity_factor: float = 4.0   # arena size as multiple of initial N
    log_every: int = 50
    seed: int = 0
    steps_per_call: int = 25       # lax.scan this many optimizer steps per
                                   # dispatch. The loop clips each block at
                                   # the next densify/reset/SH/log/
                                   # checkpoint boundary, so semantics are
                                   # exactly the sequential loop's.


def make_densify_train_step(
    optimizer: optax.GradientTransformation,
    width: int,
    height: int,
    config: RenderConfig,
    lambda_dssim: float,
):
    """(state, dstate, camera, target, sh_degree) → (state, dstate, loss).

    sh_degree is a static arg (one compile per unlocked band).
    """

    def loss_fn(params: GaussianModel, vs_aux, camera, target, sh_degree):
        cloud = params.to_cloud(sh_degree)
        splats = project_gaussians(cloud, camera, width, height, config)
        splats = dataclasses.replace(splats, mean2d=splats.mean2d + vs_aux)
        # the compositor rasterize_tiles picks (ops.rasterize.
        # select_compositor) is the one render_impl uses
        bins = bin_splats(splats, width, height, config)
        rgb, alpha = rasterize_tiles(splats, bins, width, height, config)
        bg = jnp.asarray(config.background, dtype=rgb.dtype)
        img = rgb + (1.0 - alpha[..., None]) * bg
        loss = photometric_loss(img, target, lambda_dssim)
        return loss, (splats.valid, splats.radius)

    from functools import partial

    @partial(jax.jit, static_argnums=(4,))
    def step(state: TrainState, dstate: DensifyState, camera: CameraParams,
             target: jnp.ndarray, sh_degree: int):
        vs_aux = jnp.zeros((state.params.num_gaussians, 2), jnp.float32)
        (loss, (visible, radius2d)), (g_params, g_vs) = jax.value_and_grad(
            loss_fn, argnums=(0, 1), has_aux=True
        )(state.params, vs_aux, camera, target, sh_degree)

        updates, opt_state = optimizer.update(
            g_params, state.opt_state, state.params
        )
        params = optax.apply_updates(state.params, updates)
        # Densification pressure in INRIA's units: their backward emits
        # view-space gradients scaled by (0.5·W, 0.5·H)
        # (diff-gaussian-rasterization backward.cu ddelx_dx/ddely_dy), so
        # the canonical grad_threshold=2e-4 is calibrated for
        # half-viewport coordinates. Our mean2d is in PIXELS — its raw
        # gradient is ~(W/2)× smaller, which at real resolutions left the
        # threshold unreachable and densification dormant (the round-3
        # train-at-scale underfit: 2000→2282 splats in 3000 iters).
        g_vs = g_vs * jnp.asarray([width * 0.5, height * 0.5],
                                  jnp.float32)
        dstate = accumulate_stats(dstate, g_vs, visible, radius2d=radius2d)
        return (
            TrainState(params=params, opt_state=opt_state,
                       step=state.step + 1),
            dstate,
            loss,
        )

    @partial(jax.jit, static_argnums=(5,))
    def step_many(state: TrainState, dstate: DensifyState, cameras_stacked,
                  targets_stacked: jnp.ndarray, view_idx: jnp.ndarray,
                  sh_degree: int):
        """lax.scan of `step` over a block of view indices (one dispatch
        for len(view_idx) optimizer steps — identical math to calling
        `step` sequentially). cameras_stacked/targets_stacked have the
        view axis leading; view_idx is a [k] i32 array."""

        def body(carry, vi):
            st, ds = carry
            camera = jax.tree_util.tree_map(lambda x: x[vi], cameras_stacked)
            st, ds, loss = step(st, ds, camera, targets_stacked[vi],
                                sh_degree)
            return (st, ds), loss

        (state, dstate), losses = jax.lax.scan(
            body, (state, dstate), view_idx)
        return state, dstate, losses

    step.many = step_many
    return step


def train(
    model: GaussianModel,
    views: List[View],
    width: int,
    height: int,
    render_config: RenderConfig = RenderConfig(),
    loop: TrainLoopConfig = TrainLoopConfig(),
    on_log: Optional[Callable[[int, float, int], None]] = None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 0,
):
    """Run the full training loop. Returns (model, densify_state).

    With `checkpoint_dir`: resumes from the stored loop state when the
    directory holds one (checkpoint-restart — the recovery model of
    parallel.multihost), and, when `checkpoint_every` > 0, saves the full
    loop state (TrainState + DensifyState + iteration) periodically. The
    view-sampling RNG restarts from `loop.seed` on resume, so the exact
    view sequence after a restart differs — harmless for SGD.
    """
    import numpy as np

    extent = scene_extent(views)
    capacity = int(model.num_gaussians * loop.capacity_factor)
    params, dstate = pad_to_capacity(model, capacity)

    optimizer = make_optimizer(scene_extent=extent)
    state = TrainState(
        params=params, opt_state=optimizer.init(params),
        step=jnp.zeros((), jnp.int32),
    )
    step_fn = make_densify_train_step(
        optimizer, width, height, render_config, loop.lambda_dssim
    )
    # the big-splat prune thresholds are TRACED scalars (inf = disabled)
    # so toggling them at world_prune_from doesn't recompile
    densify_jit = jax.jit(lambda m, d, k, wr, ss: densify_and_prune(
        m, d, k,
        grad_threshold=loop.grad_threshold,
        percent_dense=loop.percent_dense,
        scene_extent=extent,
        min_opacity=loop.min_opacity,
        max_world_radius_frac=wr,
        max_screen_size=ss,
    ))

    key = jax.random.PRNGKey(loop.seed)
    rng = np.random.default_rng(loop.seed)
    targets = [jnp.asarray(v.image) for v in views]
    max_sh = model.max_sh_degree
    t0 = time.time()

    start_it = 0
    if checkpoint_dir:
        from .checkpoint import (
            has_checkpoint, restore_loop_state, save_loop_state,
        )

        if has_checkpoint(checkpoint_dir):
            state, dstate, start_it = restore_loop_state(
                checkpoint_dir, state, dstate)
            print(f"resumed from {checkpoint_dir} at iteration {start_it}",
                  file=sys.stderr)

    # blocked stepping: lax.scan `steps_per_call` optimizer steps per
    # dispatch (step_fn.many), clipping each block at the next host-side
    # event so densify/reset/SH/log/checkpoint fire at exactly the same
    # iterations as the sequential loop.
    from ..core.types import stack_cameras

    targets_stacked = jnp.stack(targets)
    cameras_stacked = stack_cameras([v.camera for v in views])

    def _next_mult(i, p):
        return (i // p + 1) * p

    it = start_it
    loss = jnp.zeros(())
    while it < loop.iterations:
        sh_degree = min((it + 1) // loop.sh_upgrade_every, max_sh)
        # largest block end that crosses no host-side event boundary;
        # sh_degree is constant up to the end of its band
        sh_band_end = ((it + 1) // loop.sh_upgrade_every + 1) \
            * loop.sh_upgrade_every - 1
        bound = min(
            loop.iterations,
            _next_mult(it, loop.log_every),
            _next_mult(it, loop.opacity_reset_every),
            _next_mult(it, loop.densify_every),
            sh_band_end,
        )
        if checkpoint_dir and checkpoint_every:
            bound = min(bound, _next_mult(it, checkpoint_every))
        k = max(1, min(loop.steps_per_call, bound - it))
        vi = jnp.asarray(rng.integers(len(views), size=k), jnp.int32)
        state, dstate, losses = step_fn.many(
            state, dstate, cameras_stacked, targets_stacked, vi, sh_degree)
        loss = losses[-1]
        it += k

        if (loop.densify_from <= it <= loop.densify_until
                and it % loop.densify_every == 0):
            key, sub = jax.random.split(key)
            late = it >= loop.world_prune_from
            wr = (loop.world_radius_frac
                  if (loop.world_radius_frac is not None and late)
                  else np.inf)
            ss = (loop.screen_size_px
                  if (loop.screen_size_px is not None and late)
                  else np.inf)
            new_params, dstate, changed = densify_jit(
                state.params, dstate, sub, jnp.float32(wr),
                jnp.float32(ss))
            state = TrainState(
                params=new_params,
                opt_state=reset_opt_rows(state.opt_state, changed),
                step=state.step,
            )

        if it % loop.opacity_reset_every == 0:
            new_params = reset_opacity(state.params, dstate.alive)
            state = TrainState(
                params=new_params,
                opt_state=reset_opt_opacity(state.opt_state, capacity),
                step=state.step,
            )

        if checkpoint_dir and checkpoint_every and it % checkpoint_every == 0:
            save_loop_state(state, dstate, it, checkpoint_dir)

        if it % loop.log_every == 0:
            alive = int(jnp.sum(dstate.alive))
            if on_log is not None:
                # extended signature: callbacks that want to probe the
                # live model (periodic eval, overflow stats) declare
                # state/dstate keywords
                import inspect

                params_ = inspect.signature(on_log).parameters
                if "state" in params_:
                    on_log(it, float(loss), alive, state=state,
                           dstate=dstate)
                else:
                    on_log(it, float(loss), alive)
            else:
                print(
                    f"iter {it:6d}  loss {float(loss):.4f}  "
                    f"gaussians {alive}  sh {sh_degree}  "
                    f"{(time.time()-t0)/it*1e3:.0f} ms/it",
                    file=sys.stderr,
                )

    return state, dstate
