"""Tile rasterizer: front-to-back alpha compositing over binned splats.

This is the reference's fragment stage + blend unit (simple_render.ts:169-200
with the one-minus-dst-alpha/one "under" blend state, :454-471) re-designed
for an accelerator:

  * Pixels live in tiles of `tile_size`² (= 256) pixels, and each tile
    composites only the depth-sorted splat segment binning gave it.
  * The inherently sequential front-to-back transmittance recurrence
    T_{k+1} = T_k (1 - α_k) is replaced by an *exclusive cumulative sum of
    log(1-α)* along the depth-sorted splat axis: w_k = α_k exp(Σ_{j<k}
    log(1-α_j)). A cumsum is a parallel scan, the whole compositor becomes
    a few dense element-wise ops + reductions, and — crucially — it is
    differentiable by construction, so the backward pass (the INRIA
    hand-written back-to-front CUDA kernel) falls out of jax.grad.
  * INRIA early termination (stop before the splat that would push
    transmittance under 1e-4) is an exact masked `cummax` instead of a loop
    break, so results match the sequential formulation.
  * Tiles are processed in chunks via `lax.map` with a checkpointed body:
    the backward pass re-gathers and recomputes per-chunk activations
    instead of storing O(tiles × splats × pixels) residuals.

This XLA compositor is the CPU path and the ground truth for the GPU
compositor kernel (ops.triton_raster), whose backward is this module's VJP;
`select_compositor` picks between them.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Dict, Tuple

import jax
import jax.numpy as jnp

from ..config import RenderConfig
from ..core.types import CameraParams, GaussianCloud
from .projection import ProjectedSplats, project_gaussians
from .sort import TileBins, bin_splats


NUM_FIELDS = 9   # mx, my, conic_a, conic_b, conic_c, r, g, b, opacity
FIELD_ROW = 16   # row width the fields are padded to before the gather
DEAD_POWER = -1e4  # log-opacity of an empty slot: far below the cutoff


def pack_sorted_fields(
    splats: ProjectedSplats, bins: TileBins, pad: int,
) -> jnp.ndarray:
    """Gather splat appearance fields into (tile, depth)-sorted pair order.

    One contiguous [M + pad, 16] f32 row gather replaces per-tile
    [tiles × max_per_tile] element gathers: after it, every tile's splat
    list is a *contiguous slab* readable with a dynamic slice. Rows are
    padded 9 → 16 fields (64-byte rows). `pad` zero rows keep end-of-array
    slices in bounds.
    """
    packed = jnp.stack(
        [
            splats.mean2d[:, 0],
            splats.mean2d[:, 1],
            splats.conic[:, 0],
            splats.conic[:, 1],
            splats.conic[:, 2],
            splats.rgb[:, 0],
            splats.rgb[:, 1],
            splats.rgb[:, 2],
            splats.opacity,
        ]
        + [jnp.zeros_like(splats.opacity)] * (FIELD_ROW - NUM_FIELDS),
        axis=-1,
    )                                                        # [N, 16]
    sorted_fields = packed[bins.sorted_gidx]                 # [M, 16]
    return jnp.concatenate(
        [sorted_fields, jnp.zeros((pad, FIELD_ROW), sorted_fields.dtype)]
    )


def _composite_chunk(
    tile_ids: jnp.ndarray,          # [C] int32
    sorted_fields: jnp.ndarray,     # [M + K, 16] (pack_sorted_fields)
    bins: TileBins,
    gx: int,
    config: RenderConfig,
) -> jnp.ndarray:
    """Rasterize a chunk of tiles → [C, P, 4] (rgb, alpha), P = tile_size²."""
    ts = config.tile_size
    k_cap = config.max_per_tile
    c = tile_ids.shape[0]
    p = ts * ts

    start = bins.tile_start[tile_ids]                       # [C]
    count = jnp.minimum(bins.tile_count[tile_ids], k_cap)   # [C]

    k = jnp.arange(k_cap, dtype=jnp.int32)                  # [K]
    live = k[None, :] < count[:, None]                      # [C, K]

    slab = jax.vmap(
        lambda s: jax.lax.dynamic_slice(
            sorted_fields, (s, 0), (k_cap, FIELD_ROW)
        )
    )(start)                                                 # [C, K, 16]
    mean = slab[..., 0:2]
    conic = slab[..., 2:5]
    rgb = slab[..., 5:8]
    opac = slab[..., 8]

    if config.debug_selected >= 0:
        # "selected splat" highlight (simple_render.ts:171,181-190): the
        # chosen gaussian composites magenta at ≥0.9 alpha so its actual
        # screen footprint is visible through the normal blend stack
        gidx_p = jnp.concatenate(
            [bins.sorted_gidx,
             jnp.full((k_cap,), -1, bins.sorted_gidx.dtype)])
        gid_slab = jax.vmap(
            lambda s: jax.lax.dynamic_slice(gidx_p, (s,), (k_cap,))
        )(start)                                             # [C, K]
        sel = gid_slab == config.debug_selected
        rgb = jnp.where(sel[..., None],
                        jnp.asarray([1.0, 0.0, 1.0], rgb.dtype), rgb)
        opac = jnp.where(sel, jnp.maximum(opac, 0.9), opac)

    # Falloff as a plain f32 quadratic form in global pixel coordinates,
    # the same arithmetic, term for term, as the GPU kernel
    # (ops.triton_raster) and the NumPy oracle. log(opacity) folds into
    # power, so alpha = exp(power) and the 1/255 cutoff (:191-193) is a
    # compare on power; DEAD_POWER kills slots past the tile's count.
    tx = (tile_ids % gx).astype(jnp.float32) * ts           # [C]
    ty = (tile_ids // gx).astype(jnp.float32) * ts
    u = jnp.arange(ts, dtype=jnp.float32)
    px = tx[:, None] + jnp.broadcast_to(u[None, :], (ts, ts)).reshape(p)
    py = ty[:, None] + jnp.broadcast_to(u[:, None], (ts, ts)).reshape(p)
    dx = px[:, None, :] - mean[..., 0][..., None]           # [C, K, P]
    dy = py[:, None, :] - mean[..., 1][..., None]
    ca, cb, cc = (conic[..., i][..., None] for i in range(3))
    log_op = jnp.where(live, jnp.log(jnp.maximum(opac, 1e-30)), DEAD_POWER)
    power = log_op[..., None] - (
        0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy)
    alpha = jnp.where(
        power >= math.log(config.alpha_cutoff),
        jnp.minimum(jnp.exp(power), config.alpha_max), 0.0)

    # transmittance via exclusive cumsum of log(1-α)
    log1m = jnp.log1p(-alpha)
    log_t_incl = jnp.cumsum(log1m, axis=1)
    log_t_excl = log_t_incl - log1m
    # INRIA early termination: a splat contributes only if it would leave
    # T·(1-α) ≥ ε, and nothing after the first violator contributes.
    done = jnp.logical_not(
        jax.lax.cummax(
            (log_t_incl < jnp.log(config.transmittance_eps)).astype(jnp.int32),
            axis=1,
        )
        == 0
    )
    w = jnp.where(done, 0.0, alpha * jnp.exp(log_t_excl))   # [C, K, P]

    color = jnp.einsum("ckp,ckq->cpq", w, rgb,
                       precision=jax.lax.Precision.HIGHEST)  # [C, P, 3]
    alpha_out = jnp.sum(w, axis=1)                          # [C, P]
    return jnp.concatenate([color, alpha_out[..., None]], axis=-1)


def composite_tiles(
    splats: ProjectedSplats,
    bins: TileBins,
    tile_ids: jnp.ndarray,
    gx: int,
    config: RenderConfig,
) -> jnp.ndarray:
    """Composite an arbitrary flat list of tile ids → [T, ts, ts, 4].

    `len(tile_ids)` must be a multiple of config.tile_chunk (pad with
    repeated ids). Shared by the single-chip path and the shard_map
    tile-sharded path (each device passes its owned tile ids).
    """
    ts = config.tile_size
    chunk = min(config.tile_chunk, tile_ids.shape[0])
    n_chunks = tile_ids.shape[0] // chunk
    assert n_chunks * chunk == tile_ids.shape[0], "pad tile_ids to a chunk multiple"

    sorted_fields = pack_sorted_fields(splats, bins, pad=config.max_per_tile)
    body = jax.checkpoint(
        partial(
            _composite_chunk,
            sorted_fields=sorted_fields,
            bins=bins,
            gx=gx,
            config=config,
        )
    )
    out = jax.lax.map(body, tile_ids.reshape(n_chunks, chunk))  # [n, C, P, 4]
    return out.reshape(tile_ids.shape[0], ts, ts, 4)


def select_compositor(platform: str, config: RenderConfig) -> str:
    """The one compositor dispatch: 'kernel' (the Triton compositor of
    ops.triton_raster) or 'xla' (composite_tiles) for `platform`.

    The kernel is compiled for the GPU only (the CPU never runs it in
    interpret mode behind the caller's back); other platforms are refused.
    config.use_pallas == 'never' asks for the XLA compositor everywhere.
    debug_selected needs per-pair gaussian ids, which only the XLA
    compositor reads."""
    if platform not in ("cpu", "gpu"):
        raise ValueError(f"no compositor for platform {platform!r}")
    if config.use_pallas not in ("auto", "never"):
        raise ValueError(f"use_pallas={config.use_pallas!r}")
    if (platform == "gpu" and config.use_pallas == "auto"
            and config.debug_selected < 0):
        return "kernel"
    return "xla"


def composite(
    splats: ProjectedSplats,
    bins: TileBins,
    tile_ids: jnp.ndarray,
    gx: int,
    config: RenderConfig,
    platform: str | None = None,
) -> jnp.ndarray:
    """Composite a tile-id list → [T, ts, ts, 4] with the compositor that
    select_compositor picks for `platform` (default: the default backend).

    Sharded callers pass their mesh's device platform, which is the
    platform the computation runs on."""
    if platform is None:
        platform = jax.default_backend()
    if select_compositor(platform, config) == "kernel":
        from .triton_raster import composite_tiles_kernel

        return composite_tiles_kernel(splats, bins, tile_ids, gx, config)
    return composite_tiles(splats, bins, tile_ids, gx, config)


def composite_tiles_auto(
    splats: ProjectedSplats,
    tile_ids: jnp.ndarray,
    width: int,
    height: int,
    config: RenderConfig,
    gx: int,
    platform: str | None = None,
) -> jnp.ndarray:
    """Bin `splats`, then composite a tile-id subset → [T, ts, ts, 4].
    Used by the shard_map tile-sharded paths (each device passes the
    tiles it owns)."""
    bins = bin_splats(splats, width, height, config)
    return composite(splats, bins, tile_ids, gx, config, platform)


def assemble_image(
    tiles_out: jnp.ndarray, width: int, height: int, gx: int, gy: int
) -> jnp.ndarray:
    """[gx·gy(+pad), ts, ts, 4] (row-major tile order) → [H, W, 4]."""
    ts = tiles_out.shape[1]
    out = tiles_out[: gx * gy]
    out = out.reshape(gy, gx, ts, ts, 4).transpose(0, 2, 1, 3, 4)
    return out.reshape(gy * ts, gx * ts, 4)[:height, :width]


def rasterize_tiles(
    splats: ProjectedSplats,
    bins: TileBins,
    width: int,
    height: int,
    config: RenderConfig,
    platform: str | None = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Composite all tiles → (rgb [H, W, 3], alpha [H, W])."""
    gx, gy = config.grid_size(width, height)
    num_tiles = gx * gy
    chunk = min(config.tile_chunk, num_tiles)
    padded = -(-num_tiles // chunk) * chunk
    tile_ids = jnp.arange(padded, dtype=jnp.int32) % num_tiles
    out = composite(splats, bins, tile_ids, gx, config, platform)
    out = assemble_image(out, width, height, gx, gy)
    return out[..., :3], out[..., 3]


def render_impl(
    cloud: GaussianCloud,
    camera: CameraParams,
    width: int,
    height: int,
    config: RenderConfig = RenderConfig(),
) -> Tuple[jnp.ndarray, Dict[str, jnp.ndarray]]:
    """Full forward render: project → bin → composite (+ background).

    The end-to-end analogue of the reference's per-frame draw()
    (renderer.ts:301-330: key-init pass → radix sort → instanced raster →
    blend), collapsed into one jittable program. Use `render` for the jitted
    entry point; use this inside larger jitted computations (loss functions,
    shard_map bodies).

    Returns (image [H, W, 3], aux) where aux carries alpha and binning stats.
    """
    if config.dtype not in ("float32", "f32"):
        # apply the configured scene-storage policy (bf16 SH/scale/quat/
        # opacity, f32 positions) so RenderConfig(dtype=...) acts even when
        # the caller didn't pre-convert the cloud; no-op on an already-
        # converted cloud
        cloud = cloud.with_storage_dtype(config.dtype)
    splats = project_gaussians(cloud, camera, width, height, config)
    bins = bin_splats(splats, width, height, config)
    rgb, alpha = rasterize_tiles(splats, bins, width, height, config)

    bg = jnp.asarray(config.background, dtype=rgb.dtype)
    img = rgb + (1.0 - alpha[..., None]) * bg
    aux = {
        "alpha": alpha,
        "num_pairs": bins.num_pairs,
        "overflow": bins.overflow,
        "num_visible": jnp.sum(splats.valid.astype(jnp.int32)),
    }
    return img, aux


render = partial(jax.jit, static_argnums=(2, 3, 4))(render_impl)
