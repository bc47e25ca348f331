"""Render configuration.

The reference bakes all of its knobs into WGSL template strings at shader-build
time (SURVEY.md §5 "Config"; e.g. low-pass 0.3 at simple_render.ts:295-296,
alpha cutoff 1/255 at simple_render.ts:191, max splat 4096 px at
simple_render.ts:312-314, znear/zfar 0.2/100 at camera.ts:484). Here the same
constants live in one frozen dataclass that specializes jitted functions and
the compositor kernel through closure — the JAX analogue of shader-string
interpolation.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static (compile-time) configuration for the renderer.

    All fields are hashable Python values so a RenderConfig can be passed as a
    `static_argnums` argument to jit.
    """

    # --- tiling -----------------------------------------------------------
    # Defaults ARE the benched configuration: what render()/CLI/viewer
    # ship is exactly what bench.py measures.
    tile_size: int = 16          # pixels per tile side (16x16 = 256 px)
    max_dup: int = 16            # max tiles a single gaussian may be binned into
    tile_chunk: int = 32         # tiles rasterized per lax.map step
    max_per_tile: int = 1024     # per-tile splat list capacity (static shape cap)
    depth_bits: int = 19         # >0: packed single-key sort keeping this
                                 # many depth bits below the tile id (one
                                 # sort key instead of two; splats whose depths agree
                                 # to ~2⁻¹³ relative may reorder — visually
                                 # indistinguishable, and the compositor is
                                 # order-exact for whatever order it gets).
                                 # 0 = exact (tile, f32 depth) two-key sort
                                 # (oracle-parity mode, used by tests that
                                 # compare against the NumPy reference).
    tier_split: int = 2          # >0: tiered duplication — every gaussian
                                 # gets this many slots, footprints larger
                                 # than it spill to compacted tiers
                                 # (tier_mid, then max_dup). 0 = single
                                 # tier. 2 covers ~75% of splats at the 1M
                                 # bench scene (CPU footprint histogram),
                                 # so the sort sees far fewer dead slots
                                 # than with max_dup slots per splat.
    tier_mid: int = 4            # optional middle compacted tier width
                                 # (tier_split < tier_mid < max_dup to
                                 # enable; 99.4% of bench splats fit in 4)
    mid_frac: float = 0.3        # middle-tier capacity as a fraction of N
                                 # (bench scene needs 238k of the 300k cap;
                                 # overflow is graceful + counted)
    big_frac: float = 1.0 / 64.0  # big-tier capacity as a fraction of N
                                 # (bench scene needs 6.1k of the 15.6k cap;
                                 # overflow is graceful + counted)
    gather_cap_factor: float = 3.0  # >0: truncate the sorted pair array to
                                 # this multiple of N (dead padding sorts
                                 # last, so ≥ live-pair count is lossless)
    gather_cap_floor: int = 65536  # never cap below this many pairs —
                                 # factor·N is a trained-scene heuristic;
                                 # tiny scenes of large splats need more
                                 # pairs per splat
    tile_cull: bool = False      # exact ellipse–tile-rect overlap test per
                                 # candidate (splat, tile) slot: corner tiles
                                 # of the bounding rect the cutoff level-set
                                 # ellipse misses are dropped (output-exact;
                                 # only active when radius_sigma == 0).
                                 # At the 1M-splat/1080p bench scene it cuts
                                 # live pairs by 18%, at the price of a
                                 # per-slot edge minimization in binning;
                                 # off until a measurement on the card says
                                 # the trade pays.

    # --- EWA / splat constants (parity with the reference shader) --------
    lowpass: float = 0.3         # cov2d diagonal dilation  (simple_render.ts:295-296)
    fov_clamp: float = 1.3       # frustum clamp factor      (simple_render.ts:265-271)
    max_radius_px: float = 4096.0  # max splat extent        (simple_render.ts:312-314)
    alpha_cutoff: float = 1.0 / 255.0  # discard threshold   (simple_render.ts:191-193)
    alpha_max: float = 0.99      # INRIA alpha clamp
    transmittance_eps: float = 1e-4  # early-termination threshold (INRIA)
    radius_sigma: float = 0.0    # 0 = exact opacity-aware footprint radius
                                 # (cutoff level set); >0 = fixed-σ INRIA
                                 # heuristic (e.g. 3.0)

    # --- camera defaults --------------------------------------------------
    znear: float = 0.2           # camera.ts:484
    zfar: float = 100.0          # camera.ts:484

    # --- compositing / post ----------------------------------------------
    background: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    # post-process pass (post_process_render.ts:63-76)
    post_alpha_boost: float = 1.5
    post_alpha_pow: float = 4.0
    post_alpha_knee: float = 0.99

    # --- precision --------------------------------------------------------
    # Scene STORAGE dtype (GaussianCloud.with_storage_dtype): 'float32' for
    # bit-parity with the reference; 'bfloat16' stores SH/scale/quat/opacity
    # in bf16 (positions stay f32) — scene memory ≈ halves, compute still
    # decodes to f32 (projection.py casts at use). Compositing always runs
    # in f32.
    dtype: str = "float32"

    # --- compositor selection (ops.rasterize.select_compositor) -----------
    # 'auto': the Triton compositor kernel on a GPU, the XLA compositor on
    # the CPU. 'never': the XLA compositor everywhere (the kernel's
    # reference, e.g. for comparisons on the card).
    use_pallas: str = "auto"  # 'auto' | 'never'

    # --- debugging --------------------------------------------------------
    # ≥0: render that gaussian id highlighted magenta at ≥0.9 alpha — the
    # reference's "selected splat" debug path (negative-opacity marker →
    # magenta fragment, simple_render.ts:171,181-190), re-keyed by id since
    # parameters are optimizer state here, not a hand-editable buffer.
    # Forces the XLA compositor (the kernel does not carry per-pair
    # gaussian ids). A densify-debugging tool, not a hot path.
    debug_selected: int = -1

    def grid_size(self, width: int, height: int) -> Tuple[int, int]:
        """Number of tiles in (x, y)."""
        ts = self.tile_size
        return (-(-width // ts), -(-height // ts))

    def num_tiles(self, width: int, height: int) -> int:
        gx, gy = self.grid_size(width, height)
        return gx * gy

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = RenderConfig()
