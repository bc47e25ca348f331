"""Multi-chip training step: camera-batch DP × pixel-tile sharding.

The whole step runs inside one shard_map over the ('data', 'tile') mesh:

  * the camera batch (and target images) shard over 'data';
  * within each data shard, every device composites only its strided strip
    of image tiles, then `all_gather`s tiles over 'tile' to form the full
    image (needed for SSIM's cross-tile windows);
  * the photometric loss is computed on the gathered image, pre-scaled by
    1/|tile axis| so the all_gather transpose (a psum-scatter of cotangents)
    yields exact gradients;
  * parameter gradients and the loss are summed over 'tile' and averaged
    over 'data' in one all-reduce over both axes (mesh.flat_psum).

Gaussian parameters are replicated in round 1 (per SURVEY.md §2.3: replicate
first, shard-gather ring exchange later).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import optax
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..config import RenderConfig
from ..core.types import CameraParams
from ..models.gaussian_model import GaussianModel
from ..ops.projection import project_gaussians
from ..ops.rasterize import assemble_image, composite_tiles_auto
from ..train.loss import photometric_loss
from ..train.trainer import TrainState
from .mesh import AXES, flat_psum
from .render_sharded import _padded_tile_ids


def make_sharded_train_step(
    optimizer: optax.GradientTransformation,
    width: int,
    height: int,
    mesh: Mesh,
    config: RenderConfig = RenderConfig(),
    lambda_dssim: float = 0.2,
    active_sh_degree: Optional[int] = None,
):
    """Build a jitted sharded train step.

    Returned signature: (state, cameras, targets) → (state, loss) where
    `cameras` is a batched CameraParams (leading axis = camera batch,
    divisible by the 'data' axis size) and `targets` is [B, H, W, 3].
    """
    gx, gy = config.grid_size(width, height)
    num_tiles = gx * gy
    n_tile = mesh.shape[AXES.tile]
    n_data = mesh.shape[AXES.data]
    tile_ids, per = _padded_tile_ids(num_tiles, n_tile, config.tile_chunk)
    ts = config.tile_size
    mesh_platform = mesh.devices.flat[0].platform

    def local_loss(params: GaussianModel, cameras, targets, my_tiles):
        """Loss for this device's camera shard × tile shard (pre-scaled)."""
        cloud = params.to_cloud(active_sh_degree)

        def one_cam(camera, target):
            splats = project_gaussians(cloud, camera, width, height, config)
            local = composite_tiles_auto(
                splats, my_tiles, width, height, config, gx,
                platform=mesh_platform)
            gathered = jax.lax.all_gather(local, AXES.tile, tiled=True)
            dealt = gathered.reshape(n_tile, per, ts, ts, 4)
            row_major = dealt.transpose(1, 0, 2, 3, 4).reshape(-1, ts, ts, 4)
            out = assemble_image(row_major, width, height, gx, gy)
            bg = jnp.asarray(config.background, dtype=out.dtype)
            img = out[..., :3] + (1.0 - out[..., 3:4]) * bg
            return photometric_loss(img, target, lambda_dssim)

        # scan over the local camera batch (bounded memory; remat-friendly)
        losses = jax.lax.map(lambda ct: one_cam(ct[0], ct[1]), (cameras, targets))
        return jnp.mean(losses) / n_tile  # pre-scale for the tile psum

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(AXES.data), P(AXES.data), P(AXES.tile)),
        out_specs=(P(), P()),
        check_vma=False,
    )
    def grads_shard(params, cameras, targets, my_tiles):
        loss, g = jax.value_and_grad(local_loss)(params, cameras, targets, my_tiles)
        # one all-reduce over both axes: sum over 'tile', mean over 'data'
        loss, g = jax.tree_util.tree_map(
            lambda x: x / n_data,
            flat_psum((loss, g), (AXES.data, AXES.tile)))
        return loss, g

    @jax.jit
    def step(state: TrainState, cameras: CameraParams, targets: jnp.ndarray):
        loss, grads = grads_shard(state.params, cameras, targets, tile_ids)
        updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        new_state = TrainState(
            params=params, opt_state=opt_state, step=state.step + 1
        )
        return new_state, loss

    return step
