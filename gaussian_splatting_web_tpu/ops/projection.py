"""Per-gaussian geometry: covariance build + EWA projection to screen space.

This is the vertex-shader stage of the reference (simple_render.ts:217-332)
re-designed as one vectorized jitted map over all N gaussians — XLA fuses the
whole chain (quat→R, Σ3D, view transform, Jacobian, cov2d, conic, SH) into a
handful of elementwise loops; there is no per-splat scalar work anywhere.

Conventions (canonicalized; see core.camera):
  * view matrix is world→camera with +z forward (INRIA/COLMAP).
  * proj is the INRIA projection (clip.w = view z), camera.ts:19-42.
  * pixel coords via ndc2pix(v, S) = ((v+1)·S − 1)/2 (INRIA).

Differences from the reference worth noting (all deliberate):
  * The Jacobian uses focal_x and focal_y separately; the reference reuses
    the x focal for both rows (simple_render.ts:273-278).
  * The reference's conic has a flipped off-diagonal sign
    (simple_render.ts:298,327) but never uses the conic in its fragment
    shader (alpha comes from quad UVs, simple_render.ts:174-175); we use the
    standard conic α = σ·exp(-½ dᵀ Σ₂D⁻¹ d) (INRIA formulation).
  * Depth sorting uses view-space z (= clip w), matching the key-init shader
    (shaders.ts:66-68) for INRIA cameras. The reference's orbit camera feeds
    -z-forward depths into the same ascending sort, silently reversing its
    compositing order; canonicalizing the camera removes that bug class.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from ..config import RenderConfig
from ..core.types import CameraParams, GaussianCloud
from .sh import eval_sh

HIGHEST = jax.lax.Precision.HIGHEST


@dataclasses.dataclass
class ProjectedSplats:
    """Screen-space splats, one entry per input gaussian (masked by `valid`).

    mean2d:  [N, 2] pixel-space center.
    conic:   [N, 3] upper triangle (A, B, C) of Σ₂D⁻¹.
    depth:   [N] view-space depth (+z forward).
    radius:  [N] conservative pixel radius (0 for culled).
    rgb:     [N, 3] SH-evaluated color.
    opacity: [N] sigmoid-decoded opacity.
    valid:   [N] bool visibility mask.
    """

    mean2d: jax.Array
    conic: jax.Array
    depth: jax.Array
    radius: jax.Array
    rgb: jax.Array
    opacity: jax.Array
    valid: jax.Array


jax.tree_util.register_dataclass(
    ProjectedSplats,
    data_fields=["mean2d", "conic", "depth", "radius", "rgb", "opacity", "valid"],
    meta_fields=[],
)


def quat_to_rotmat(q: jnp.ndarray) -> jnp.ndarray:
    """[..., 4] (x, y, z, w) → [..., 3, 3] standard rotation matrix.

    Equivalent to the reference shader's column-major constructor applied to
    its conjugated load-time quaternion (simple_render.ts:110-114 +
    ply.ts:202-213); see io.ply for the equivalence proof.
    """
    # normalize with the eps INSIDE the sqrt: `q / max(norm(q), eps)` has a
    # finite VALUE at q = 0 but a NaN GRADIENT (d norm/dq = q/norm = 0/0),
    # which zero-padded dead rows in the training arena hit every step —
    # the NaN then spreads through Adam / global ops to live rows
    q = q / jnp.sqrt(
        jnp.maximum(jnp.sum(q * q, axis=-1, keepdims=True), 1e-24))
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return jnp.stack(
        [
            jnp.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1),
            jnp.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1),
            jnp.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1),
        ],
        axis=-2,
    )


def compute_cov3d(
    log_scale: jnp.ndarray, quat: jnp.ndarray, scale_modifier
) -> jnp.ndarray:
    """Σ₃D = (R S)(R S)ᵀ as the packed upper triangle [..., 6].

    (ref compute_cov3d, simple_render.ts:127-162; scale decoded in-kernel
    instead of on the CPU, cf. ply.ts:333-335.)
    """
    scale = jnp.exp(log_scale) * scale_modifier
    R = quat_to_rotmat(quat)
    M = R * scale[..., None, :]  # R @ diag(scale)
    sigma = jnp.matmul(M, jnp.swapaxes(M, -1, -2), precision=HIGHEST)
    return jnp.stack(
        [
            sigma[..., 0, 0],
            sigma[..., 0, 1],
            sigma[..., 0, 2],
            sigma[..., 1, 1],
            sigma[..., 1, 2],
            sigma[..., 2, 2],
        ],
        axis=-1,
    )


def ndc2pix(v: jnp.ndarray, size: float) -> jnp.ndarray:
    """INRIA pixel-center convention."""
    return ((v + 1.0) * size - 1.0) * 0.5


def project_gaussians(
    cloud: GaussianCloud,
    camera: CameraParams,
    width: int,
    height: int,
    config: RenderConfig,
) -> ProjectedSplats:
    """Project every gaussian to screen space (the reference's per-instance
    vertex work, simple_render.ts:217-332, as one fused vector map)."""
    f32 = jnp.float32
    xyz = cloud.xyz.astype(f32)
    view = camera.view.astype(f32)
    proj = camera.proj.astype(f32)

    # --- view / clip transform ------------------------------------------
    # precision=HIGHEST: a default-precision f32 product may run in TF32
    # on a GPU, which moves splat centres by a visible fraction of a pixel
    mm = partial(jnp.matmul, precision=HIGHEST)
    t = mm(xyz, view[:3, :3].T) + view[:3, 3]  # [N,3] camera space
    depth = t[..., 2]
    pv = mm(proj, view)
    clip = mm(xyz, pv[:3, :3].T) + pv[:3, 3]       # x,y,z rows
    clip_w = mm(xyz, pv[3, :3]) + pv[3, 3]         # w row (= depth for INRIA proj)
    # behind-camera cull (ref NaN-culls at clipPos.w <= 0, simple_render.ts:230-233)
    in_front = clip_w > 0.2
    safe_w = jnp.where(in_front, clip_w, 1.0)
    ndc = clip[..., :2] / safe_w[..., None]
    mean2d = jnp.stack(
        [ndc2pix(ndc[..., 0], width), ndc2pix(ndc[..., 1], height)], axis=-1
    )

    # --- 3D covariance ---------------------------------------------------
    cov3d = compute_cov3d(cloud.log_scale.astype(f32), cloud.quat.astype(f32),
                          camera.scale_modifier.astype(f32))
    c00, c01, c02, c11, c12, c22 = [cov3d[..., i] for i in range(6)]

    # --- EWA: cov2d = J W Σ Wᵀ Jᵀ ---------------------------------------
    tz = jnp.where(in_front, depth, 1.0)
    lim_x = config.fov_clamp * camera.tan_half_fov[0]  # simple_render.ts:265-271
    lim_y = config.fov_clamp * camera.tan_half_fov[1]
    tx = jnp.clip(t[..., 0] / tz, -lim_x, lim_x) * tz
    ty = jnp.clip(t[..., 1] / tz, -lim_y, lim_y) * tz

    fx = camera.focal[0]
    fy = camera.focal[1]
    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    # J rows (simple_render.ts:274-278, with per-axis focals):
    #   [fx/z, 0, -fx·x/z²]
    #   [0, fy/z, -fy·y/z²]
    j00 = fx * inv_z
    j02 = -fx * tx * inv_z2
    j11 = fy * inv_z
    j12 = -fy * ty * inv_z2

    W = view[:3, :3]
    # U = J @ W  → [N, 2, 3]
    u0 = j00[..., None] * W[0] + j02[..., None] * W[2]
    u1 = j11[..., None] * W[1] + j12[..., None] * W[2]

    def quad(a, b):
        """aᵀ Σ₃D b for row vectors a, b: [N,3]·[N,3] with packed Σ."""
        return (
            a[..., 0] * (c00 * b[..., 0] + c01 * b[..., 1] + c02 * b[..., 2])
            + a[..., 1] * (c01 * b[..., 0] + c11 * b[..., 1] + c12 * b[..., 2])
            + a[..., 2] * (c02 * b[..., 0] + c12 * b[..., 1] + c22 * b[..., 2])
        )

    # low-pass dilation (simple_render.ts:295-296, INRIA 0.3)
    a2d = quad(u0, u0) + config.lowpass
    b2d = quad(u0, u1)
    c2d = quad(u1, u1) + config.lowpass

    det = a2d * c2d - b2d * b2d
    det_ok = det > 0.0
    safe_det = jnp.where(det_ok, det, 1.0)
    inv_det = 1.0 / safe_det
    conic = jnp.stack([c2d * inv_det, -b2d * inv_det, a2d * inv_det], axis=-1)

    # --- appearance ------------------------------------------------------
    rgb = eval_sh(cloud.sh.astype(f32), xyz, camera.cam_pos.astype(f32))
    opacity = jax.nn.sigmoid(cloud.opacity_logit.astype(f32))  # simple_render.ts:328

    # Opacity-aware EXACT footprint radius: the compositor zeroes
    # α = σ(o)·exp(-½ dᵀΣ⁻¹d) below alpha_cutoff (simple_render.ts:191-193),
    # so the cutoff level-set ellipse bounds every contributing pixel —
    # max extent √(2 λ₁ ln(opacity/cutoff)). For near-opaque splats this is
    # slightly wider than the INRIA 3σ heuristic (exact where 3σ clips a
    # visible tail) and far tighter for faint ones; splats with
    # opacity ≤ cutoff are culled outright. radius_sigma > 0 restores the
    # fixed-σ heuristic for INRIA-parity experiments.
    mid = 0.5 * (a2d + c2d)
    lam1 = mid + jnp.sqrt(jnp.maximum(mid * mid - det, 0.1))
    if config.radius_sigma > 0:
        radius = jnp.ceil(config.radius_sigma * jnp.sqrt(lam1))
    else:
        log_ratio = jnp.log(
            jnp.maximum(opacity, config.alpha_cutoff) / config.alpha_cutoff
        )
        radius = jnp.ceil(jnp.sqrt(2.0 * lam1 * log_ratio))
    radius = jnp.minimum(radius, config.max_radius_px)

    # --- visibility ------------------------------------------------------
    on_screen = (
        (mean2d[..., 0] + radius >= 0)
        & (mean2d[..., 0] - radius < width)
        & (mean2d[..., 1] + radius >= 0)
        & (mean2d[..., 1] - radius < height)
    )
    valid = in_front & det_ok & (radius > 0) & on_screen

    return ProjectedSplats(
        mean2d=mean2d,
        conic=conic,
        depth=depth,
        radius=jnp.where(valid, radius, 0.0),
        rgb=rgb,
        opacity=opacity,
        valid=valid,
    )
