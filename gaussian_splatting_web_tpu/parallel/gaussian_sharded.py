"""Gaussian-sharded rendering/training: ring exchange of projected-splat
shards around pixel-tile owners.

SURVEY.md §2.3 / §5: ring-attention's moral equivalent for a rasterizer is a
ring-style exchange of Gaussian shards around pixel-tile owners. Here the
Gaussian parameter arrays (and their Adam moments) live SHARDED over the
'tile' mesh axis — per-device parameter + optimizer memory is N/S — and a
`lax.scan` of `ppermute` steps walks every shard's PROJECTED splats around
the ring (projection itself runs only on the owning device, so the O(N)
vertex work is sharded too). Projected splats are 12 f32 per gaussian vs up
to 59 for raw SH-degree-3 parameters, so the ring moves ~5× fewer bytes
than exchanging raw parameters, and XLA's latency-hiding scheduler can
overlap each hop with the previous block's key-building work.

Because `ppermute` has an exact transpose (the reversed ring), the whole
exchange is differentiable: each device's loss cotangents flow backward
around the ring and accumulate at each shard's home device, which is
exactly the gradient reduce-scatter the sharded optimizer needs — no
explicit `psum` over 'tile' for parameter gradients.

Honest scaling notes:
  * compositing compute is sharded by tile ownership (strided deal, the
    static load balancer — or contiguous bands in the banded paths),
    projection by gaussian ownership;
  * round 2's full-N-per-device binning sort became the banded ring
    (round 3: per-hop band filter, O(N·d/S) binning but O(N) compaction
    sort work per device) and then the round-5 `banded_candidates_a2a`
    (ONE class sort of the owned splats + one all_to_all: O(N/S)
    selection AND O(N·d/S) binning per device — every render stage now
    scales except the per-band tile compositing skew);
  * transient render activations are O(N·d/S) per device on the banded
    paths; parameters + optimizer state are N/S everywhere (params +
    2 Adam moments = 3× model memory bounds trainable scene size).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import optax
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import RenderConfig
from ..core.types import CameraParams, GaussianCloud
from ..models.gaussian_model import GaussianModel
from ..ops.projection import project_gaussians
from ..ops.rasterize import assemble_image, composite_tiles_auto
from ..train.loss import photometric_loss
from ..train.trainer import TrainState
from .mesh import AXES, flat_psum
from .render_sharded import _padded_tile_ids


def ring_all_gather(tree, axis: str, n_shards: int):
    """Reassemble full arrays from per-device shards with an explicit
    ppermute ring (an all_gather written as a scan so each hop can overlap
    downstream per-block work, and so its transpose — the cotangent ring —
    is explicit).

    Every leaf [n_s, ...] → [S·n_s, ...] in global shard order, identical
    on all devices of `axis`."""
    my = jax.lax.axis_index(axis)
    perm = [(i, (i + 1) % n_shards) for i in range(n_shards)]

    def step(blk, _):
        return jax.tree_util.tree_map(
            lambda x: jax.lax.ppermute(x, axis, perm), blk
        ), blk

    _, blocks = jax.lax.scan(step, tree, None, length=n_shards)
    # at step k this device held the block that originated at shard
    # (my - k) mod S; reorder stacked blocks into global order 0..S-1
    k_of_src = jnp.mod(my - jnp.arange(n_shards), n_shards)
    return jax.tree_util.tree_map(
        lambda b: b[k_of_src].reshape((-1,) + b.shape[2:]), blocks
    )


def shard_model(model: GaussianModel, mesh: Mesh) -> GaussianModel:
    """Place a model with its leading (gaussian) axis sharded over 'tile'.
    N must divide the axis size (pad with dead gaussians upstream if not)."""
    s = mesh.shape[AXES.tile]
    n = model.num_gaussians
    if n % s:
        raise ValueError(f"N={n} not divisible by tile axis {s}")
    sharding = NamedSharding(mesh, P(AXES.tile))
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(x, sharding), model
    )


def render_gaussian_sharded(
    cloud: GaussianCloud,
    camera: CameraParams,
    width: int,
    height: int,
    mesh: Mesh,
    config: RenderConfig = RenderConfig(),
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Forward render with the GAUSSIANS sharded over 'tile' (each device
    also owns a strided strip of tiles). Returns (rgb, alpha), replicated.
    """
    gx, gy = config.grid_size(width, height)
    num_tiles = gx * gy
    s = mesh.shape[AXES.tile]
    tile_ids, per = _padded_tile_ids(num_tiles, s, config.tile_chunk)
    mesh_platform = mesh.devices.flat[0].platform

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(AXES.tile), P(), P(AXES.tile)),
        out_specs=P(),
        check_vma=False,
    )
    def run(cloud_shard, camera, my_tiles):
        splats_shard = project_gaussians(
            cloud_shard, camera, width, height, config
        )
        splats = ring_all_gather(splats_shard, AXES.tile, s)
        local = composite_tiles_auto(
            splats, my_tiles, width, height, config, gx,
            platform=mesh_platform)
        return jax.lax.all_gather(local, AXES.tile, tiled=True)

    gathered = run(cloud, camera, tile_ids)
    ts = config.tile_size
    dealt = gathered.reshape(s, per, ts, ts, 4)
    row_major = dealt.transpose(1, 0, 2, 3, 4).reshape(-1, ts, ts, 4)
    img = assemble_image(row_major, width, height, gx, gy)
    return img[..., :3], img[..., 3]


def _pack_splat_rows(splats):
    """ProjectedSplats → [n, 16] f32 row matrix (11 fields + valid flag +
    zero padding) so ring hops and candidate compaction move ONE aligned
    row array instead of seven leaves."""
    n = splats.depth.shape[0]
    return jnp.concatenate(
        [
            splats.mean2d,
            splats.conic,
            splats.depth[:, None],
            splats.radius[:, None],
            splats.rgb,
            splats.opacity[:, None],
            splats.valid.astype(jnp.float32)[:, None],
            jnp.zeros((n, 4), jnp.float32),
        ],
        axis=1,
    )


def _unpack_splat_rows(rows):
    from ..ops.projection import ProjectedSplats

    return ProjectedSplats(
        mean2d=rows[:, 0:2],
        conic=rows[:, 2:5],
        depth=rows[:, 5],
        radius=rows[:, 6],
        rgb=rows[:, 7:10],
        opacity=rows[:, 10],
        valid=rows[:, 11] > 0.5,
    )


def banded_tile_rows(gy: int, n_shards: int) -> int:
    """Tile rows per band (contiguous row-band tile ownership)."""
    return -(-gy // n_shards)


def banded_cap_hop(n: int, s: int, cand_factor: float) -> int:
    """Per-hop candidate capacity of the ring-sharded binning: expected
    candidates/hop is n_s/s (one shard's splats landing in one band), with
    `cand_factor` safety, a 256 floor, and the shard size as the cap."""
    n_s = n // s
    return min(n_s, max(int(cand_factor * n_s / s), 256))


def banded_band_tiles(width: int, height: int, s: int,
                      config: RenderConfig) -> Tuple[jnp.ndarray, int, int]:
    """Contiguous row-band tile ownership → (band_tiles [S·per_pad] i32,
    per_band, per_pad). Band b owns tiles [b·per_band, (b+1)·per_band);
    each band's list is padded to a tile_chunk multiple with repeated ids
    (their duplicate tiles are sliced off before assembly)."""
    gx, gy = config.grid_size(width, height)
    num_tiles = gx * gy
    rows_per = banded_tile_rows(gy, s)
    per_band = rows_per * gx
    chunk = min(config.tile_chunk, per_band)
    per_pad = -(-per_band // chunk) * chunk
    band_tiles = jnp.minimum(
        jnp.arange(s * per_pad, dtype=jnp.int32).reshape(s, per_pad)
        % per_pad + (jnp.arange(s, dtype=jnp.int32) * per_band)[:, None],
        num_tiles - 1,
    ).reshape(-1)
    return band_tiles, per_band, per_pad


def banded_candidates(splats_shard, width: int, height: int, s: int,
                      rows_per: int, cap_hop: int,
                      config: RenderConfig):
    """Ring-sharded candidate selection (runs INSIDE shard_map, on the
    'tile' axis): walk every shard's packed projected-splat rows around
    the ppermute ring; per hop keep only splats whose footprint tile-row
    range intersects this device's contiguous band of `rows_per` tile
    rows, compacted to `cap_hop` rows by a stable (class, iota) sort.

    Returns (local_splats [S·cap_hop], overflow) — the candidate set this
    device bins/composites, O(N·d/S) instead of O(N·d). Differentiable:
    the hop scan is a ppermute ring whose transpose runs the cotangents
    backward around the ring, and the compaction gather's transpose is a
    scatter-add back into the originating block."""
    from ..ops.sort import _footprints

    packed = _pack_splat_rows(splats_shard)        # [n_s, 16]
    # footprint tile-row range of each owned splat (same rect the binning
    # uses → the band test is conservative-exact)
    x0, y0, rw, rh = _footprints(splats_shard, width, height, config)
    prows = packed.at[:, 12].set(y0.astype(jnp.float32))
    prows = prows.at[:, 13].set((y0 + rh).astype(jnp.float32))

    my = jax.lax.axis_index(AXES.tile)
    band_lo = (my * rows_per).astype(jnp.float32)
    band_hi = band_lo + rows_per
    perm = [(i, (i + 1) % s) for i in range(s)]

    def hop(blk, _):
        y0b = blk[:, 12]
        y1b = blk[:, 13]
        live = blk[:, 11] > 0.5
        mask = jnp.logical_and(
            jnp.logical_and(y1b > band_lo, y0b < band_hi), live)
        n_hit = jnp.sum(mask.astype(jnp.int32))
        key = jnp.where(mask, jnp.uint32(0), jnp.uint32(1))
        _, idx = jax.lax.sort(
            (key, jnp.arange(blk.shape[0], dtype=jnp.int32)),
            num_keys=1)
        idx = idx[:cap_hop]
        cand = blk[idx]                            # [cap_hop, 16]
        ok = jnp.arange(cap_hop) < n_hit
        cand = jnp.where(ok[:, None], cand, 0.0)   # dead rows: valid=0
        nxt = jax.lax.ppermute(blk, AXES.tile, perm)
        return nxt, (cand, jnp.maximum(n_hit - cap_hop, 0))

    _, (cands, over) = jax.lax.scan(hop, prows, None, length=s)
    local_splats = _unpack_splat_rows(cands.reshape(s * cap_hop, 16))
    return local_splats, jnp.sum(over)


def banded_candidates_a2a(splats_shard, width: int, height: int, s: int,
                          rows_per: int, cap_hop: int,
                          config: RenderConfig, bmax: int | None = None):
    """Pair-level streamed candidate selection (round 5, the follow-up the
    module notes have promised since round 2): instead of walking all S
    shards around the ring and re-compacting n_s rows per hop (O(N) sort
    work per device per image — the 2.76× 'band' stage inflation in
    virtual-mesh decomposition), each device classifies its OWN splats by
    destination band ONCE (a single stable sort of bmax·n_s elements,
    O(N/S) per device, flat in S) and a single `all_to_all` delivers each
    band's candidate block.

    A splat's footprint rows [y0, y0+rh) touch bands b0..b1; each owned
    splat gets `bmax` destination slots (bands past bmax are dropped and
    COUNTED — exactness claims require overflow == 0, same contract as
    cap_hop truncation). bmax defaults to min(s, 4): spanning 3+ bands
    requires footprint height > rows_per tile rows.

    Returns (local_splats [S·cap_hop], overflow) — same shape and
    contract as banded_candidates. Differentiable: all_to_all transposes
    to the reverse all_to_all, the row gather to a scatter-add."""
    if bmax is None:
        bmax = min(s, 4)
    from ..ops.sort import _footprints

    packed = _pack_splat_rows(splats_shard)        # [n_s, 16]
    n_s = packed.shape[0]
    x0, y0, rw, rh = _footprints(splats_shard, width, height, config)
    del x0, rw
    live = jnp.logical_and(splats_shard.valid, rh > 0)
    b0 = jnp.clip(y0 // rows_per, 0, s - 1)
    b1 = jnp.clip((y0 + rh - 1) // rows_per, 0, s - 1)
    nb = jnp.where(live, b1 - b0 + 1, 0)           # bands touched

    k = jnp.arange(bmax, dtype=b0.dtype)[:, None]  # [bmax, 1]
    dest = b0[None, :] + k                         # [bmax, n_s]
    slot_live = jnp.logical_and(k < nb[None, :], dest < s)
    cls = jnp.where(slot_live, dest, s).astype(jnp.uint32).reshape(-1)
    iota = jnp.arange(bmax * n_s, dtype=jnp.uint32)
    if s < 15 and bmax * n_s < (1 << 28):
        # one single-operand u32 sort: class in the top 4 bits, slot id
        # below (half the sort cost of a key+payload pair; segment
        # bounds come from searchsorted on the same key)
        skey = jax.lax.sort((cls << 28) | iota)
        sorted_slot = (skey & jnp.uint32((1 << 28) - 1)).astype(jnp.int32)
        edges = jnp.searchsorted(
            skey, jnp.arange(s + 1, dtype=jnp.uint32) << 28,
            side="left").astype(jnp.int32)
        start_b = edges[:-1]
        cnt_b = edges[1:] - edges[:-1]              # [S]
    else:
        _, sorted_slot = jax.lax.sort(
            (cls, iota.astype(jnp.int32)), num_keys=1)
        cnt_b = jnp.sum(
            (cls[None, :] == jnp.arange(s, dtype=jnp.uint32)[:, None])
            .astype(jnp.int32), axis=1)            # [S]
        start_b = jnp.concatenate(
            [jnp.zeros((1,), jnp.int32), jnp.cumsum(cnt_b)[:-1]])

    idx_mat = start_b[:, None] + jnp.arange(cap_hop, dtype=jnp.int32)[None]
    idx_mat = jnp.clip(idx_mat, 0, bmax * n_s - 1)     # [S, cap_hop]
    slots = sorted_slot[idx_mat]                       # flat slot k·n_s+g
    rows = packed[slots % n_s]                         # [S, cap_hop, 16]
    valid_rows = (jnp.arange(cap_hop, dtype=jnp.int32)[None, :]
                  < cnt_b[:, None])
    send = jnp.where(valid_rows[..., None], rows, 0.0)

    recv = jax.lax.all_to_all(
        send, AXES.tile, split_axis=0, concat_axis=0, tiled=True)
    local_splats = _unpack_splat_rows(recv.reshape(s * cap_hop, 16))
    over = (jnp.sum(jnp.maximum(cnt_b - cap_hop, 0))
            + jnp.sum(jnp.maximum(nb - bmax, 0)))
    return local_splats, over


def render_gaussian_sharded_banded(
    cloud: GaussianCloud,
    camera: CameraParams,
    width: int,
    height: int,
    mesh: Mesh,
    config: RenderConfig = RenderConfig(),
    cand_factor: float = 2.5,
    stream: str = "a2a",
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Gaussian-sharded forward render with RING-SHARDED BINNING — the
    round-2 follow-up (gaussian_sharded module notes): per ring hop each
    device keeps only the splats whose footprint rows intersect its
    CONTIGUOUS band of tile rows, so the binning sort, the compositor
    slabs, and peak activations are O(N·d/S) per device instead of O(N·d).

    Mechanics: project the owned shard; walk every shard's packed splat
    rows around the ppermute ring; per hop, a conservative band-overlap
    test + a stable (class, iota) sort compacts the passing block to
    `cap_hop = cand_factor·n_s/S` candidate rows (overflow counted, like
    binning); the concatenated S·cap_hop ≈ cand_factor·N/S candidates
    then go through the ordinary subset compositor, which bins ONLY them.
    Exact while candidates fit the cap: the band test uses the same
    footprint rect as binning, so no contributing splat is dropped. Under
    depth_bits > 0 the packed key breaks depth TIES by input position, and
    the ring reorders candidates, so tie pixels may differ from the
    replicated path (same caveat as any re-ordering — the documented
    quantized-key semantics); depth_bits=0 is bit-identical. Tier-cap /
    gather-cap overflow likewise truncates by input position — exactness
    claims require overflow == 0 (it is returned for exactly this).

    Tile ownership is contiguous row bands (not the strided deal of the
    replicated-binning path): band locality is what makes candidate
    filtering possible; the cost is spatial load skew — the static
    tradeoff documented in SURVEY §7 "Load balance".

    Returns (rgb, alpha, overflow), replicated.
    """
    gx, gy = config.grid_size(width, height)
    num_tiles = gx * gy
    s = mesh.shape[AXES.tile]
    rows_per = banded_tile_rows(gy, s)
    band_tiles, per_band, per_pad = banded_band_tiles(
        width, height, s, config)
    n = cloud.num_gaussians
    cap_hop = banded_cap_hop(n, s, cand_factor)
    mesh_platform = mesh.devices.flat[0].platform
    ts = config.tile_size

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(AXES.tile), P(), P(AXES.tile)),
        out_specs=(P(), P()),
        check_vma=False,
    )
    def run(cloud_shard, camera, my_tiles):
        splats_shard = project_gaussians(
            cloud_shard, camera, width, height, config
        )
        select = (banded_candidates_a2a if stream == "a2a"
                  else banded_candidates)
        local_splats, over = select(
            splats_shard, width, height, s, rows_per, cap_hop, config)
        tiles = composite_tiles_auto(
            local_splats, my_tiles, width, height, config, gx,
            platform=mesh_platform)
        gathered = jax.lax.all_gather(
            tiles.reshape(per_pad, ts * ts, 4), AXES.tile, tiled=False)
        # the overflow psum waits for the gather: one collective order on
        # every device (mesh.flat_psum)
        gathered, over = jax.lax.optimization_barrier((gathered, over))
        return gathered, jax.lax.psum(over, AXES.tile)

    gathered, overflow = run(cloud, camera, band_tiles)
    # bands are contiguous: [S, per_pad, ...] → slice each band's real
    # tiles → global row-major order → crop the last band's padding
    tiles = gathered[:, :per_band].reshape(-1, ts, ts, 4)
    img = assemble_image(tiles[:num_tiles], width, height, gx, gy)
    return img[..., :3], img[..., 3], overflow


def make_gaussian_sharded_train_step(
    optimizer: optax.GradientTransformation,
    width: int,
    height: int,
    mesh: Mesh,
    config: RenderConfig = RenderConfig(),
    lambda_dssim: float = 0.2,
    active_sh_degree: Optional[int] = None,
    banded: bool = False,
    cand_factor: float = 2.5,
    n_gaussians: Optional[int] = None,
    stream: str = "a2a",
):
    """Sharded-parameter training step (BASELINE.md config 5).

    Signature: (state, cameras, targets) → (state, loss). `state.params`
    leaves are sharded P('tile') on the gaussian axis (see shard_model);
    the optimizer state inherits that sharding, so parameter + moment
    memory per device is N/S. Parameter gradients arrive PRE-SHARDED from
    the ring transpose; only the loss and the 'data'-axis mean use
    collectives.

    With `banded=True` (requires `n_gaussians`) the ring is the
    RING-SHARDED BINNING of render_gaussian_sharded_banded: tile ownership
    becomes contiguous row bands and each device bins/composites only the
    ≈cand_factor·N/S splats whose footprints intersect its band
    (banded_candidates) — so binning, compositor slabs, and activations in
    the TRAIN step are O(N·d/S) per device, not just parameter memory
    (VERDICT r3 item 5; the round-3 ring gathered ALL N projected splats).
    Exactness caveats are those of the banded render (cap overflow
    truncates; depth ties under depth_bits > 0 may reorder).
    """
    gx, gy = config.grid_size(width, height)
    num_tiles = gx * gy
    n_tile = mesh.shape[AXES.tile]
    n_data = mesh.shape[AXES.data]
    ts = config.tile_size
    mesh_platform = mesh.devices.flat[0].platform
    if banded:
        if n_gaussians is None:
            raise ValueError("banded=True requires n_gaussians")
        rows_per = banded_tile_rows(gy, n_tile)
        tile_ids, per_band, per = banded_band_tiles(
            width, height, n_tile, config)
        cap_hop = banded_cap_hop(n_gaussians, n_tile, cand_factor)
    else:
        tile_ids, per = _padded_tile_ids(num_tiles, n_tile,
                                         config.tile_chunk)

    def local_loss(params_shard: GaussianModel, cameras, targets, my_tiles):
        cloud_shard = params_shard.to_cloud(active_sh_degree)

        def one_cam(camera, target):
            splats_shard = project_gaussians(
                cloud_shard, camera, width, height, config
            )
            over = jnp.zeros((), jnp.int32)
            if banded:
                # cap_hop truncation drops splats (and their gradients)
                # silently — surface the count so an undersized
                # cand_factor is detectable during training (ADVICE r4)
                select = (banded_candidates_a2a if stream == "a2a"
                          else banded_candidates)
                splats, over = select(
                    splats_shard, width, height, n_tile, rows_per,
                    cap_hop, config)
            else:
                splats = ring_all_gather(splats_shard, AXES.tile, n_tile)
            local = composite_tiles_auto(
                splats, my_tiles, width, height, config, gx,
                platform=mesh_platform)
            gathered = jax.lax.all_gather(local, AXES.tile, tiled=True)
            if banded:
                # contiguous bands: band b's real tiles are already in
                # global row-major order
                row_major = gathered.reshape(
                    n_tile, per, ts, ts, 4)[:, :per_band].reshape(
                    -1, ts, ts, 4)
            else:
                dealt = gathered.reshape(n_tile, per, ts, ts, 4)
                row_major = dealt.transpose(1, 0, 2, 3, 4).reshape(
                    -1, ts, ts, 4)
            out = assemble_image(row_major[:num_tiles], width, height,
                                 gx, gy)
            bg = jnp.asarray(config.background, dtype=out.dtype)
            img = out[..., :3] + (1.0 - out[..., 3:4]) * bg
            return photometric_loss(img, target, lambda_dssim), over

        losses, overs = jax.lax.map(lambda ct: one_cam(ct[0], ct[1]),
                                    (cameras, targets))
        # pre-scale for the tile psum; overflow rides as non-diff aux
        return jnp.mean(losses) / n_tile, jax.lax.stop_gradient(
            jnp.sum(overs))

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(AXES.tile), P(AXES.data), P(AXES.data), P(AXES.tile)),
        out_specs=(P(), P(), P(AXES.tile)),
        check_vma=False,
    )
    def grads_shard(params_shard, cameras, targets, my_tiles):
        (loss, over), g = jax.value_and_grad(
            local_loss, has_aux=True)(
            params_shard, cameras, targets, my_tiles
        )
        # The barrier holds the scalar reductions until the backward (and
        # its ring collectives) is done, and each reduction below feeds
        # the next: every device issues the collectives in one order
        # (mesh.flat_psum says why that matters).
        loss, over, g = jax.lax.optimization_barrier((loss, over, g))
        loss, over = flat_psum((loss, over), AXES.tile)
        # parameter grads are shard-local already (ring transpose); only
        # average over the data-parallel camera batch
        loss, over, g = flat_psum((loss, over, g), AXES.data)
        loss, g = jax.tree_util.tree_map(lambda x: x / n_data, (loss, g))
        return loss, over, g

    @jax.jit
    def step(state: TrainState, cameras: CameraParams, targets: jnp.ndarray):
        loss, over, grads = grads_shard(
            state.params, cameras, targets, tile_ids)
        updates, opt_state = optimizer.update(
            grads, state.opt_state, state.params
        )
        params = optax.apply_updates(state.params, updates)
        return (TrainState(params=params, opt_state=opt_state,
                           step=state.step + 1), loss,
                {"overflow": over})

    return step


def init_sharded_train_state(
    model: GaussianModel, optimizer, mesh: Mesh
) -> TrainState:
    """TrainState with params AND Adam moments sharded over 'tile'.

    Per-gaussian moment leaves (leading dim == N) get the params' P('tile')
    sharding; scalar state (step counts, schedules) stays replicated."""
    n = model.num_gaussians
    params = shard_model(model, mesh)

    def shd(leaf):
        if getattr(leaf, "ndim", 0) >= 1 and leaf.shape[0] == n:
            return NamedSharding(mesh, P(AXES.tile))
        return NamedSharding(mesh, P())

    abstract = jax.eval_shape(optimizer.init, params)
    opt_state = jax.jit(
        optimizer.init,
        out_shardings=jax.tree_util.tree_map(shd, abstract),
    )(params)
    return TrainState(
        params=params, opt_state=opt_state, step=jnp.zeros((), jnp.int32)
    )
