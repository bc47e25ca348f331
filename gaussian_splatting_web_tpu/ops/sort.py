"""Depth ordering + tile binning.

The reference's sorting subsystem is a per-frame global GPU radix argsort of
(depth-key, index) pairs (renderer.ts:160-183 + webgpu-radix-sort; key init in
shaders.ts:44-73; legacy bitonic path in bitonic.ts/depth_sorter.ts). Every
pixel then iterates splats in that single global order.

Here the design is the INRIA tile-binned one: expand each splat into the
16x16-pixel tiles its extent covers, sort the (tile, depth, id) triples once
with XLA's variadic sort (`lax.sort`), and read per-tile contiguous,
depth-ordered segments via searchsorted offsets. This turns "sort +
full-screen quads" into "one sort + dense per-tile reads", which is what the
compositor needs for front-to-back compositing of one tile's segment.

Static-shape strategy (XLA requires fixed shapes): each gaussian owns
`config.max_dup` candidate (tile, depth) slots; slots beyond its actual tile
footprint get tile_id = num_tiles and sort to the end. Footprints larger than
max_dup tiles are truncated (counted in `overflow` for observability). The
per-tile segment length is later capped at `config.max_per_tile` by the
rasterizer.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..config import RenderConfig
from .projection import ProjectedSplats


@dataclasses.dataclass
class TileBins:
    """Sorted splat→tile assignment.

    sorted_gidx:  [M] gaussian index per (tile, depth)-sorted pair (M is
                  the pair cap after gather-cap truncation).
    tile_start:   [T] offset of each tile's segment in the sorted pairs.
    tile_count:   [T] segment length per tile.
    num_pairs:    [] total live pairs (observability).
    overflow:     [] gaussians whose tile footprint was shrunk at max_dup,
                  plus tier-cap and pair-cap losses.
    """

    sorted_gidx: jax.Array
    tile_start: jax.Array
    tile_count: jax.Array
    num_pairs: jax.Array
    overflow: jax.Array


jax.tree_util.register_dataclass(
    TileBins,
    data_fields=["sorted_gidx", "tile_start", "tile_count", "num_pairs",
                 "overflow"],
    meta_fields=[],
)


def float_to_sortable_uint(f: jnp.ndarray) -> jnp.ndarray:
    """Monotonic float32 → uint32 key transform: flip the sign bit for
    positives, complement all bits for negatives.

    The reference's version (shaders.ts:36-40) negates the arithmetic-shift
    mask, producing 0x80000001 instead of 0xFFFFFFFF for negatives — keys for
    negative depths (its orbit camera's entire view volume) are not order-
    preserving among themselves. We implement the correct transform; for the
    positive depths of INRIA cameras the two agree bit-exactly.
    """
    fu = jax.lax.bitcast_convert_type(f.astype(jnp.float32), jnp.uint32)
    neg = jax.lax.bitcast_convert_type(fu, jnp.int32) < 0
    mask = jnp.where(neg, jnp.uint32(0xFFFFFFFF), jnp.uint32(0x80000000))
    return fu ^ mask


def depth_sort_indices(depth: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
    """Global front-to-back argsort by view depth — the reference's whole
    per-frame sort (renderer.ts:301-315) as one XLA op. Invalid splats sort
    to the end."""
    key = jnp.where(valid, depth, jnp.float32(jnp.inf))
    return jnp.argsort(key)


TAU_SLACK = 1e-3  # conservative slack on the cutoff level-set threshold:
                  # the compositor evaluates the quadratic per pixel with
                  # other rounding than the culling test, so borderline
                  # q ≈ τ pixels must never be culled


def _cutoff_tau(opacity: jnp.ndarray, config: RenderConfig) -> jnp.ndarray:
    """Level-set threshold τ: alpha ≥ cutoff ⟺ ½ dᵀΣ⁻¹d ≤ τ (matches the
    opacity-aware radius in ops.projection)."""
    return jnp.log(
        jnp.maximum(opacity, config.alpha_cutoff) / config.alpha_cutoff
    )


def _footprints(splats: ProjectedSplats, width: int, height: int,
                config: RenderConfig):
    """Per-gaussian tile rects (INRIA getRect semantics, tightened).

    In the exact-footprint mode (radius_sigma == 0) the rect uses PER-AXIS
    extents of the cutoff level-set ellipse, rx = √(2τΣxx), ry = √(2τΣyy)
    (Σxx = C/det Σ⁻¹ etc.) instead of the INRIA circular bound r = √(2τλ₁):
    an anisotropic splat's bounding box shrinks by up to λ₁/λ₂ in one axis,
    which directly cuts (tile, splat) pair count. Output-exact: pixels
    outside the level set have alpha < cutoff and composite to zero."""
    ts = config.tile_size
    gx, gy = config.grid_size(width, height)
    mean = jnp.where(splats.valid[:, None], splats.mean2d, -1e6)
    if config.radius_sigma > 0:
        rx = ry = splats.radius
    else:
        qa, qb, qc = (splats.conic[:, 0], splats.conic[:, 1],
                      splats.conic[:, 2])
        det_q = jnp.maximum(qa * qc - qb * qb, 1e-24)
        tau = _cutoff_tau(splats.opacity, config)
        # +0.5 px guards the boundary pixel against rounding differences
        # between this closed form and the compositor's quadratic
        rx = jnp.sqrt(2.0 * tau * qc / det_q) + 0.5
        ry = jnp.sqrt(2.0 * tau * qa / det_q) + 0.5
        rx = jnp.where(splats.valid, jnp.minimum(rx, splats.radius), 0.0)
        ry = jnp.where(splats.valid, jnp.minimum(ry, splats.radius), 0.0)
    x0 = jnp.clip(jnp.floor((mean[:, 0] - rx) / ts), 0, gx).astype(jnp.int32)
    y0 = jnp.clip(jnp.floor((mean[:, 1] - ry) / ts), 0, gy).astype(jnp.int32)
    x1 = jnp.clip(jnp.floor((mean[:, 0] + rx) / ts) + 1, 0, gx).astype(jnp.int32)
    y1 = jnp.clip(jnp.floor((mean[:, 1] + ry) / ts) + 1, 0, gy).astype(jnp.int32)
    rw = jnp.where(splats.valid, x1 - x0, 0)
    rh = jnp.where(splats.valid, y1 - y0, 0)
    return x0, y0, rw, rh


def _rect_quad_min(qa, qb, qc, dx0, dx1, dy0, dy1):
    """Exact min of q(d) = ½(A dx² + 2B dx dy + C dy²) over the rectangle
    [dx0,dx1]×[dy0,dy1] for positive-definite (A,B,C). The unconstrained
    minimum is q(0)=0; otherwise the min lies on one of the four edges,
    where the 1D minimizer clamps to the edge interval."""
    inside = (dx0 <= 0) & (dx1 >= 0) & (dy0 <= 0) & (dy1 >= 0)
    safe_a = jnp.maximum(qa, 1e-12)
    safe_c = jnp.maximum(qc, 1e-12)

    def edge_x(e):           # dx fixed at e, minimize over dy
        y = jnp.clip(-qb * e / safe_c, dy0, dy1)
        return 0.5 * qa * e * e + qb * e * y + 0.5 * qc * y * y

    def edge_y(e):           # dy fixed at e, minimize over dx
        x = jnp.clip(-qb * e / safe_a, dx0, dx1)
        return 0.5 * qc * e * e + qb * e * x + 0.5 * qa * x * x

    q = jnp.minimum(
        jnp.minimum(edge_x(dx0), edge_x(dx1)),
        jnp.minimum(edge_y(dy0), edge_y(dy1)),
    )
    return jnp.where(inside, 0.0, q)


def candidate_slot_tiles(x0, y0, rw, ntg, d, gx, num_tiles, ts, rows=None):
    """Dense slot grid: slot k → k-th tile of the footprint (row-major).
    Returns (tile [d, R] int32 with `num_tiles` as the dead sentinel,
    live [d, R] bool).

    SLOT-MAJOR layout ([d, R], splats in the MINOR dim): the minor
    dimension stays R = millions wide for every tier width d, so no
    narrow minor dimension is ever padded or relaid out. Flattening
    therefore yields slot-major order: slot id (within a tier block) =
    k·R + g.

    With `rows` = (mx, my, A, B, C, τ) per splat, each slot additionally
    passes an EXACT ellipse–tile-rect overlap test (_rect_quad_min):
    corner tiles of the bounding rect that the cutoff level-set ellipse
    misses are marked dead and sort to the end with the sentinels —
    output-exact pair-count reduction (the compositor zeroes
    alpha < cutoff for every pixel of such tiles)."""
    slot = jnp.arange(d, dtype=jnp.int32)[:, None]        # [d, 1]
    live = slot < ntg[None, :]                            # [d, R]
    safe_rw = jnp.maximum(rw, 1)[None, :]
    ty = y0[None, :] + slot // safe_rw
    tx = x0[None, :] + slot % safe_rw
    if rows is not None:
        mx, my, qa, qb, qc, tau = rows
        dx0 = tx.astype(jnp.float32) * ts - mx[None, :]
        dy0 = ty.astype(jnp.float32) * ts - my[None, :]
        qmin = _rect_quad_min(
            qa[None, :], qb[None, :], qc[None, :],
            dx0, dx0 + (ts - 1), dy0, dy0 + (ts - 1),
        )
        live = live & (qmin <= tau[None, :] + TAU_SLACK)
    tile = jnp.where(live, ty * gx + tx, num_tiles)
    return tile, live


def sort_pair_arrays(tiers, num_tiles, n, num_pairs, overflow,
                     config: RenderConfig):
    """Sort (tile, depth) pair tiers into per-tile depth-ordered segments.

    `tiers` is a list of (tile_id [d, R] with `num_tiles` sentinel,
    live [d, R], gidx [d, R], depth [R]) blocks — slot-major (see
    candidate_slot_tiles). Implements both key modes (packed single key
    when config.depth_bits > 0, exact two-key otherwise) and the post-sort
    gather-cap truncation. Called by bin_splats; the sharded paths reach it
    through bin_splats.

    Returns (sorted_gidx, tile_start, tile_count, num_pairs, overflow)."""
    tile_bits = max(int(num_tiles + 1).bit_length(), 1)
    depth_bits = min(config.depth_bits, 32 - tile_bits)

    if depth_bits > 0:
        keys, gidxs = [], []
        for tile_id, live, gidx, depth in tiers:
            dkey = float_to_sortable_uint(depth) >> (32 - depth_bits)
            key = (tile_id.astype(jnp.uint32) << depth_bits) | dkey[None, :]
            keys.append(
                jnp.where(live, key, jnp.uint32(0xFFFFFFFF)).reshape(-1))
            gidxs.append(gidx.reshape(-1))
        # one key, one payload: the shape XLA hands to a radix sort
        sorted_key, sorted_gidx = jax.lax.sort(
            (jnp.concatenate(keys), jnp.concatenate(gidxs)), num_keys=1)
        bounds = jnp.arange(num_tiles + 1, dtype=jnp.uint32) << depth_bits
        edges = jnp.searchsorted(sorted_key, bounds, side="left").astype(
            jnp.int32
        )
        tile_start = edges[:-1]
        tile_count = edges[1:] - edges[:-1]
    else:
        tiles_flat, depths_flat, gidx_flat = [], [], []
        for tile_id, live, gidx, depth in tiers:
            dd, rows = tile_id.shape
            tiles_flat.append(tile_id.astype(jnp.int32).reshape(-1))
            depths_flat.append(
                jnp.broadcast_to(depth[None, :], (dd, rows))
                .astype(jnp.float32).reshape(-1)
            )
            gidx_flat.append(gidx.reshape(-1))
        sorted_tile, _, sorted_gidx = jax.lax.sort(
            (jnp.concatenate(tiles_flat), jnp.concatenate(depths_flat),
             jnp.concatenate(gidx_flat)),
            num_keys=2,
        )
        tile_range = jnp.arange(num_tiles, dtype=jnp.int32)
        tile_start = jnp.searchsorted(
            sorted_tile, tile_range, side="left"
        ).astype(jnp.int32)
        tile_end = jnp.searchsorted(
            sorted_tile, tile_range, side="right"
        ).astype(jnp.int32)
        tile_count = tile_end - tile_start

    if config.gather_cap_factor > 0:
        # Dead (sentinel-key) pairs sort to the end, so truncating the
        # sorted pair array to cap = factor·N costs nothing while
        # cap ≥ live pairs — and everything downstream (the sorted-field
        # gather and its backward scatter) shrinks with it. If a scene
        # exceeds the cap, the farthest tiles lose their deepest splats
        # (counted in overflow).
        # floor: factor·N is a trained-scene heuristic (pairs ≈ 2-3·N); a
        # tiny scene of large splats can legitimately need far more pairs
        # per splat, so never cap below gather_cap_floor pairs
        cap = min(int(sorted_gidx.shape[0]),
                  max(int(n * config.gather_cap_factor),
                      config.gather_cap_floor))
        sorted_gidx = sorted_gidx[:cap]
        tile_count = jnp.minimum(
            tile_count, jnp.maximum(cap - tile_start, 0)
        )
        tile_start = jnp.minimum(tile_start, cap)  # keep slab reads in bounds
        overflow = overflow + jnp.maximum(num_pairs - cap, 0)
        num_pairs = jnp.minimum(num_pairs, cap)

    return sorted_gidx, tile_start, tile_count, num_pairs, overflow


def bin_splats(
    splats: ProjectedSplats,
    width: int,
    height: int,
    config: RenderConfig,
) -> TileBins:
    """Bin projected splats into depth-sorted per-tile segments.

    Design: the dense N×max_dup slot grid is built directly into sort keys
    with *no scatter*; dead slots carry an all-ones sentinel key and sort
    to the end. With `depth_bits > 0` the (tile, depth) pair packs into ONE
    uint32 key — tile id in the high bits, the top `depth_bits` of the
    monotone float→uint depth transform below (the reference packs depth
    into 32-bit radix keys the same way, shaders.ts:36-40 — we put the tile
    id where its sign-bit trick lived). Depth ordering then ties only for
    splats whose depths agree to ~2⁻¹³ relative, visually
    indistinguishable. `depth_bits = 0` selects the exact (tile, f32-depth)
    two-key sort.
    """
    gx, gy = config.grid_size(width, height)
    num_tiles = gx * gy
    n = splats.depth.shape[0]
    d = config.max_dup

    x0, y0, rw, rh = _footprints(splats, width, height, config)
    # Center-preserving footprint shrink: a splat whose rect exceeds
    # max_dup tiles used to be truncated to its first d slots in ROW-MAJOR
    # order — the top band of its bbox — putting a hard horizontal edge
    # through every oversized splat. During training that corrupts the
    # rendered TARGETS themselves (ground-truth images banded, capping
    # PSNR at ~13 regardless of fit quality). Instead shrink the rect
    # around its center by √(d/ntg): the splat renders its central core
    # (where the Gaussian mass is), stays differentiable everywhere it is
    # visible, and recovers exactness as soon as it shrinks below d tiles.
    # Shrunk splats are counted in `overflow`.
    ntg_raw = rw * rh
    _over = ntg_raw > d
    _sf = jnp.sqrt(d / jnp.maximum(ntg_raw, 1).astype(jnp.float32))
    _rw2 = jnp.clip(jnp.floor(rw.astype(jnp.float32) * _sf)
                    .astype(jnp.int32), 1, d)
    # floor() keeps rw2·rh2 ≤ rw·rh·sf² = d except through the 1-clamps;
    # the division cap restores the invariant in those corner cases
    _rh2 = jnp.clip(jnp.floor(rh.astype(jnp.float32) * _sf)
                    .astype(jnp.int32), 1,
                    jnp.maximum(d // jnp.maximum(_rw2, 1), 1))
    x0 = jnp.where(_over, x0 + (rw - _rw2) // 2, x0)
    y0 = jnp.where(_over, y0 + (rh - _rh2) // 2, y0)
    rw = jnp.where(_over, _rw2, rw)
    rh = jnp.where(_over, _rh2, rh)
    ntg_full = rw * rh
    ts = config.tile_size
    exact_tile_test = config.radius_sigma <= 0 and config.tile_cull

    def slot_tiles(x0, y0, rw, ntg, d, rows=None):
        return candidate_slot_tiles(
            x0, y0, rw, ntg, d, gx, num_tiles, ts, rows=rows
        )

    if exact_tile_test:
        rows_all = (
            splats.mean2d[:, 0], splats.mean2d[:, 1],
            splats.conic[:, 0], splats.conic[:, 1], splats.conic[:, 2],
            _cutoff_tau(splats.opacity, config),
        )
    else:
        rows_all = None

    overflow = jnp.sum(_over.astype(jnp.int32))
    d_a = min(config.tier_split, d) if config.tier_split > 0 else d
    if d_a < d:
        # Tiered duplication: most splats touch few tiles (bench-scene CPU
        # histogram: ≤2 covers 75%, ≤4 covers 99.4%), so a full N×max_dup
        # grid is mostly sentinel padding that the sort pays for. Tier A
        # gives every gaussian d_a slots; splats with bigger footprints are
        # compacted (a small gather, not a scatter) into compacted tiers of
        # ascending width — optionally a middle tier (config.tier_mid),
        # then max_dup.
        widths = []
        if d_a < config.tier_mid < d:
            widths.append((config.tier_mid,
                           max(min(int(n * config.mid_frac), n), 256)))
        widths.append((d, max(min(int(n * config.big_frac), n), 256)))

        big_a = ntg_full > d_a
        ntg_a = jnp.where(big_a, 0, ntg_full)
        tile_a, live_a = slot_tiles(x0, y0, rw, ntg_a, d_a, rows=rows_all)
        gidx_a = jnp.broadcast_to(
            jnp.arange(n, dtype=jnp.int32)[None, :], (d_a, n)
        )
        tiers = [(tile_a, live_a, gidx_a, splats.depth)]
        num_pairs = jnp.sum(live_a.astype(jnp.int32))

        # Compaction via ONE stable class sort of (class, iota) instead of
        # one jnp.nonzero per tier. Stability keeps each class's indices
        # ascending; tier j's block starts at the running class-count
        # offset (dynamic_slice).
        n_comp = len(widths)
        cls = jnp.full((n,), n_comp, jnp.uint32)
        prev_w = d_a
        for j, (w_j, _) in enumerate(widths):
            sel = ntg_full > prev_w
            if w_j != d:
                sel = jnp.logical_and(sel, ntg_full <= w_j)
            cls = jnp.where(sel, jnp.uint32(j), cls)
            prev_w = w_j
        _, perm = jax.lax.sort(
            (cls, jnp.arange(n, dtype=jnp.int32)), num_keys=1,
            is_stable=True)
        class_counts = [
            jnp.sum((cls == j).astype(jnp.int32)) for j in range(n_comp)]
        # pad so every dynamic_slice below fits unclamped (caps have a 256
        # floor and may exceed n on tiny scenes)
        perm = jnp.concatenate(
            [perm, jnp.zeros((max(c for _, c in widths),), jnp.int32)])

        # ONE row gather per compacted tier instead of one element gather
        # per column: the per-splat values every tier needs (footprint
        # rect, depth, optional cull rows) pack into a [n, R8] f32 row
        # matrix first (int columns bitcast so the pack is exact).
        gcols = [x0, y0, rw, ntg_full, splats.depth]
        if rows_all is not None:
            gcols += list(rows_all)
        rowpad = -len(gcols) % 8
        packed_rows = jnp.stack(
            [jax.lax.bitcast_convert_type(a, jnp.float32)
             if a.dtype == jnp.int32 else a for a in gcols]
            + [jnp.zeros((n,), jnp.float32)] * rowpad, axis=1)

        offset = jnp.int32(0)
        for j, (w_j, cap_j) in enumerate(widths):
            n_sel = class_counts[j]
            idx_j = jax.lax.dynamic_slice(perm, (offset,), (cap_j,))
            valid_j = jnp.arange(cap_j) < n_sel
            idx_j = jnp.where(valid_j, idx_j, 0)
            offset = offset + n_sel

            g = packed_rows[idx_j]                        # [cap_j, R8]
            x0_j, y0_j, rw_j, ntg_sel = (
                jax.lax.bitcast_convert_type(g[:, k], jnp.int32)
                for k in range(4))
            depth_j = g[:, 4]
            rows_j = (tuple(g[:, 5 + k] for k in range(len(rows_all)))
                      if rows_all is not None else None)

            ntg_j = jnp.where(valid_j, jnp.minimum(ntg_sel, w_j), 0)
            tile_j, live_j = slot_tiles(
                x0_j, y0_j, rw_j, ntg_j, w_j, rows=rows_j
            )
            gidx_j = jnp.broadcast_to(idx_j[None, :], (w_j, cap_j))
            tiers.append((tile_j, live_j, gidx_j, depth_j))
            overflow = overflow + jnp.maximum(n_sel - cap_j, 0)
            num_pairs = num_pairs + jnp.sum(live_j.astype(jnp.int32))
    else:
        ntg = jnp.minimum(ntg_full, d)
        tile_id, live = slot_tiles(x0, y0, rw, ntg, d, rows=rows_all)
        gidx = jnp.broadcast_to(
            jnp.arange(n, dtype=jnp.int32)[None, :], (d, n)
        )
        num_pairs = jnp.sum(live.astype(jnp.int32))
        tiers = [(tile_id, live, gidx, splats.depth)]

    sorted_gidx, tile_start, tile_count, num_pairs, overflow = (
        sort_pair_arrays(tiers, num_tiles, n, num_pairs, overflow, config))
    return TileBins(
        sorted_gidx=sorted_gidx,
        tile_start=tile_start,
        tile_count=tile_count,
        num_pairs=num_pairs,
        overflow=overflow,
    )
