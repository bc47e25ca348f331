"""GPU compositor kernel: one Pallas program per 16×16 tile, through Triton.

The shape of INRIA's CUDA rasterizer (diff-gaussian-rasterization
forward.cu renderCUDA): each program owns one tile, its 256 pixels laid
across the program's lanes, and walks that tile's depth-sorted segment of
the [M + pad, 16] field rows from `pack_sorted_fields` front to back, in
chunks of CHUNK splats. Within a chunk the transmittance
recurrence is the same exclusive log(1-α) cumsum as the XLA compositor
(ops.rasterize._composite_chunk); across chunks log T and the running RGBA
ride the carry of a `while_loop` that stops as soon as every pixel of the
tile has crossed the 1e-4 transmittance threshold. So a tile does work in
proportion to its live splats, and no [tiles, splats, pixels]
intermediate ever reaches device memory.

Semantics are those of `_composite_chunk`: the 1/255 alpha cutoff, the
0.99 alpha clamp, the 1e-4 early-termination rule (the splat that would
push T under it does not contribute, nor does anything after it), and the
`max_per_tile` cap on each tile's list.

The backward pass is `jax.vjp` of the XLA compositor on the same bins
(`composite_tiles_kernel`'s custom VJP), so gradients are the XLA path's
by construction.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..config import RenderConfig
from .projection import ProjectedSplats
from .rasterize import DEAD_POWER, composite_tiles, pack_sorted_fields
from .sort import TileBins

# Splats per step of a tile's walk, and the Triton launch shape. On an
# H100 at the 1M/1080p bench scene, chunks of 8 beat 16, 32 and 64, and 4
# warps with one stage were at least as fast as 8 warps or two stages
# (PERF.md).
CHUNK = 8
NUM_WARPS = 4
NUM_STAGES = 1


def _kernel(ids_ref, start_ref, count_ref, fields_ref, out_ref, *,
            gx: int, ts: int, kc: int, k_cap: int, log_cutoff: float,
            alpha_max: float, log_eps: float):
    t = pl.program_id(0)
    tile = ids_ref[t]
    start = start_ref[t]
    count = jnp.minimum(count_ref[t], k_cap)
    p = ts * ts

    pix = jnp.arange(p, dtype=jnp.int32)
    px = (pix % ts + (tile % gx) * ts).astype(jnp.float32)    # [P]
    py = (pix // ts + (tile // gx) * ts).astype(jnp.float32)
    lane = jnp.arange(kc, dtype=jnp.int32)
    n_chunks = (count + (kc - 1)) // kc

    def cond(carry):
        i, all_done = carry[0], carry[-1]
        return jnp.logical_and(i < n_chunks, all_done == 0)

    def body(carry):
        i, log_t, dead, r, g, b, a, _ = carry
        rows = pl.ds(start + i * kc, kc)
        mx = fields_ref[rows, 0]                               # [KC]
        my = fields_ref[rows, 1]
        ca = fields_ref[rows, 2]
        cb = fields_ref[rows, 3]
        cc = fields_ref[rows, 4]
        cr = fields_ref[rows, 5]
        cg = fields_ref[rows, 6]
        cbl = fields_ref[rows, 7]
        op = fields_ref[rows, 8]
        live = (i * kc + lane) < count                         # [KC]

        dx = px[None, :] - mx[:, None]                         # [KC, P]
        dy = py[None, :] - my[:, None]
        log_op = jnp.where(live, jnp.log(jnp.maximum(op, 1e-30)),
                           DEAD_POWER)
        power = log_op[:, None] - (
            0.5 * (ca[:, None] * dx * dx + cc[:, None] * dy * dy)
            + cb[:, None] * dx * dy)
        alpha = jnp.where(power >= log_cutoff,
                          jnp.minimum(jnp.exp(power), alpha_max), 0.0)
        log1m = jnp.log1p(-alpha)
        incl = log_t[None, :] + jnp.cumsum(log1m, axis=0)      # [KC, P]
        excl = incl - log1m
        # a pixel stops at the first splat that would take T under eps;
        # counting the violations so far keeps the stop monotone in k
        # whatever rounding the chunk's scan used
        hit = jnp.logical_or(incl < log_eps, dead[None, :] > 0)
        stop = jnp.cumsum(hit.astype(jnp.int32), axis=0) > 0
        w = jnp.where(stop, 0.0, alpha * jnp.exp(excl))        # [KC, P]

        r = r + jnp.sum(w * cr[:, None], axis=0)
        g = g + jnp.sum(w * cg[:, None], axis=0)
        b = b + jnp.sum(w * cbl[:, None], axis=0)
        a = a + jnp.sum(w, axis=0)
        log_t = log_t + jnp.sum(log1m, axis=0)
        dead = jnp.maximum(dead, jnp.max(stop.astype(jnp.int32), axis=0))
        return i + 1, log_t, dead, r, g, b, a, jnp.min(dead)

    zeros = jnp.zeros((p,), jnp.float32)
    init = (jnp.int32(0), zeros, jnp.zeros((p,), jnp.int32),
            zeros, zeros, zeros, zeros, jnp.int32(0))
    _, _, _, r, g, b, a, _ = jax.lax.while_loop(cond, body, init)
    out_ref[0, :] = r
    out_ref[1, :] = g
    out_ref[2, :] = b
    out_ref[3, :] = a


def composite_fields_kernel(
    fields: jnp.ndarray,
    tile_ids: jnp.ndarray,
    tile_start: jnp.ndarray,
    tile_count: jnp.ndarray,
    gx: int,
    config: RenderConfig,
    interpret: bool = False,
) -> jnp.ndarray:
    """Run the kernel over `tile_ids` → [T, 4, P] (r, g, b, alpha rows).

    `fields` is pack_sorted_fields' [M + pad, 16] array with
    pad ≥ max_per_tile rounded up to a multiple of CHUNK;
    tile_start/tile_count are per entry of `tile_ids`."""
    ts = config.tile_size
    p = ts * ts
    if p & (p - 1):
        raise ValueError(f"the kernel needs a power-of-two tile_size, not "
                         f"{ts}")
    n = tile_ids.shape[0]
    kernel = partial(
        _kernel, gx=gx, ts=ts, kc=CHUNK, k_cap=config.max_per_tile,
        log_cutoff=math.log(config.alpha_cutoff),
        alpha_max=config.alpha_max,
        log_eps=math.log(config.transmittance_eps))
    return pl.pallas_call(
        kernel,
        grid=(n,),
        out_specs=pl.BlockSpec((None, 4, p), lambda t: (t, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((n, 4, p), jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=NUM_WARPS, num_stages=NUM_STAGES),
        interpret=interpret,
        name="composite_tiles_triton",
    )(tile_ids.astype(jnp.int32), tile_start.astype(jnp.int32),
      tile_count.astype(jnp.int32), fields)


def _kernel_pad(config: RenderConfig) -> int:
    return -(-config.max_per_tile // CHUNK) * CHUNK


def _forward(splats, bins, tile_ids, gx, config, interpret):
    ts = config.tile_size
    fields = pack_sorted_fields(splats, bins, pad=_kernel_pad(config))
    out = composite_fields_kernel(
        fields, tile_ids, bins.tile_start[tile_ids],
        bins.tile_count[tile_ids], gx, config, interpret)
    return out.transpose(0, 2, 1).reshape(-1, ts, ts, 4)


@partial(jax.custom_vjp, nondiff_argnums=(3, 4, 5))
def _composite_vjp(splats, bins, tile_ids, gx, config, interpret):
    return _forward(splats, bins, tile_ids, gx, config, interpret)


def _composite_vjp_fwd(splats, bins, tile_ids, gx, config, interpret):
    out = _forward(splats, bins, tile_ids, gx, config, interpret)
    return out, (splats, bins, tile_ids)


def _zero_cotangent(x):
    x = jnp.asarray(x)
    if jnp.issubdtype(x.dtype, jnp.floating):
        return jnp.zeros_like(x)
    return np.zeros(x.shape, jax.dtypes.float0)


def _composite_vjp_bwd(gx, config, interpret, res, g):
    splats, bins, tile_ids = res
    _, vjp = jax.vjp(
        lambda s: composite_tiles(s, bins, tile_ids, gx, config), splats)
    (g_splats,) = vjp(g)
    return (g_splats, jax.tree_util.tree_map(_zero_cotangent, bins),
            _zero_cotangent(tile_ids))


_composite_vjp.defvjp(_composite_vjp_fwd, _composite_vjp_bwd)


def composite_tiles_kernel(
    splats: ProjectedSplats,
    bins: TileBins,
    tile_ids: jnp.ndarray,
    gx: int,
    config: RenderConfig,
    interpret: bool = False,
) -> jnp.ndarray:
    """Drop-in for ops.rasterize.composite_tiles → [T, ts, ts, 4], run by
    the Triton kernel. Gradients are the XLA compositor's VJP on the same
    bins. `interpret=True` runs the kernel in Pallas' interpreter (tests
    on a machine without a GPU); callers on the card leave it False."""
    return _composite_vjp(splats, bins, tile_ids, gx, config, interpret)
