"""CPU oracle renderer: naive NumPy INRIA-formulation forward pass.

The deliberately simple, obviously-correct implementation every accelerator
kernel is tested against — the role the CPU reference argsort plays for the
reference's bitonic sort test (bitonic.ts:239-288), extended to the full
pipeline. No tiling, no static-shape tricks: global depth sort + a
per-gaussian sequential front-to-back blend over the whole image.

Kept intentionally independent of the ops/ implementations: separate SH
basis, separate quaternion→matrix, sequential transmittance recurrence
instead of cumsum. Agreement between the two is therefore meaningful.
"""

from __future__ import annotations

import numpy as np

from ..config import RenderConfig
from ..core.types import CameraParams, GaussianCloud

_SH_C0 = 0.28209479177387814
_SH_C1 = 0.4886025119029199
_SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
          -1.0925484305920792, 0.5462742152960396)
_SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
          0.3731763325901154, -0.4570457994644658, 1.445305721320277,
          -0.5900435899266435)


def _sh_to_rgb(sh: np.ndarray, dirs: np.ndarray) -> np.ndarray:
    k = sh.shape[1]
    x, y, z = dirs[:, 0:1], dirs[:, 1:2], dirs[:, 2:3]
    c = _SH_C0 * sh[:, 0]
    if k > 1:
        c = c + _SH_C1 * (-y * sh[:, 1] + z * sh[:, 2] - x * sh[:, 3])
    if k > 4:
        xx, yy, zz = x * x, y * y, z * z
        xy, xz, yz = x * y, x * z, y * z
        c = (c + _SH_C2[0] * xy * sh[:, 4] + _SH_C2[1] * yz * sh[:, 5]
             + _SH_C2[2] * (2 * zz - xx - yy) * sh[:, 6]
             + _SH_C2[3] * xz * sh[:, 7] + _SH_C2[4] * (xx - yy) * sh[:, 8])
    if k > 9:
        c = (c + _SH_C3[0] * y * (3 * xx - yy) * sh[:, 9]
             + _SH_C3[1] * xy * z * sh[:, 10]
             + _SH_C3[2] * y * (4 * zz - xx - yy) * sh[:, 11]
             + _SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh[:, 12]
             + _SH_C3[4] * x * (4 * zz - xx - yy) * sh[:, 13]
             + _SH_C3[5] * z * (xx - yy) * sh[:, 14]
             + _SH_C3[6] * x * (xx - 3 * yy) * sh[:, 15])
    return np.maximum(c + 0.5, 0.0)


def _quat_to_rot(q: np.ndarray) -> np.ndarray:
    q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    x, y, z, w = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    R = np.empty((q.shape[0], 3, 3), dtype=np.float64)
    R[:, 0, 0] = 1 - 2 * (y * y + z * z)
    R[:, 0, 1] = 2 * (x * y - w * z)
    R[:, 0, 2] = 2 * (x * z + w * y)
    R[:, 1, 0] = 2 * (x * y + w * z)
    R[:, 1, 1] = 1 - 2 * (x * x + z * z)
    R[:, 1, 2] = 2 * (y * z - w * x)
    R[:, 2, 0] = 2 * (x * z - w * y)
    R[:, 2, 1] = 2 * (y * z + w * x)
    R[:, 2, 2] = 1 - 2 * (x * x + y * y)
    return R


def render_reference(
    cloud: GaussianCloud,
    camera: CameraParams,
    width: int,
    height: int,
    config: RenderConfig = RenderConfig(),
) -> np.ndarray:
    """Naive forward render → [H, W, 3] float64 (premultiplied color over
    the configured background)."""
    xyz = np.asarray(cloud.xyz, dtype=np.float64)
    view = np.asarray(camera.view, dtype=np.float64)
    proj = np.asarray(camera.proj, dtype=np.float64)
    cam_pos = np.asarray(camera.cam_pos, dtype=np.float64)
    focal = np.asarray(camera.focal, dtype=np.float64)
    tanf = np.asarray(camera.tan_half_fov, dtype=np.float64)
    scale_mod = float(np.asarray(camera.scale_modifier))
    n = xyz.shape[0]

    # project
    t = xyz @ view[:3, :3].T + view[:3, 3]
    pv = proj @ view
    clip = xyz @ pv[:3, :3].T + pv[:3, 3]
    clip_w = xyz @ pv[3, :3] + pv[3, 3]
    depth = t[:, 2]
    in_front = clip_w > 0.2

    ndc = clip[:, :2] / np.where(in_front, clip_w, 1.0)[:, None]
    mean2d = np.stack(
        [((ndc[:, 0] + 1) * width - 1) * 0.5,
         ((ndc[:, 1] + 1) * height - 1) * 0.5], axis=1)

    # cov3d
    scale = np.exp(np.asarray(cloud.log_scale, dtype=np.float64)) * scale_mod
    R = _quat_to_rot(np.asarray(cloud.quat, dtype=np.float64))
    M = R * scale[:, None, :]
    cov3d = M @ np.swapaxes(M, 1, 2)

    # EWA
    tz = np.where(in_front, depth, 1.0)
    tx = np.clip(t[:, 0] / tz, -config.fov_clamp * tanf[0],
                 config.fov_clamp * tanf[0]) * tz
    ty = np.clip(t[:, 1] / tz, -config.fov_clamp * tanf[1],
                 config.fov_clamp * tanf[1]) * tz
    J = np.zeros((n, 2, 3), dtype=np.float64)
    J[:, 0, 0] = focal[0] / tz
    J[:, 0, 2] = -focal[0] * tx / tz**2
    J[:, 1, 1] = focal[1] / tz
    J[:, 1, 2] = -focal[1] * ty / tz**2
    T = J @ view[:3, :3]
    cov2d = T @ cov3d @ np.swapaxes(T, 1, 2)
    cov2d[:, 0, 0] += config.lowpass
    cov2d[:, 1, 1] += config.lowpass

    a, b, c = cov2d[:, 0, 0], cov2d[:, 0, 1], cov2d[:, 1, 1]
    det = a * c - b * b
    det_ok = det > 0
    inv_det = 1.0 / np.where(det_ok, det, 1.0)
    conic = np.stack([c * inv_det, -b * inv_det, a * inv_det], axis=1)

    opacity = 1.0 / (1.0 + np.exp(-np.asarray(cloud.opacity_logit, np.float64)))

    mid = 0.5 * (a + c)
    lam1 = mid + np.sqrt(np.maximum(mid * mid - det, 0.1))
    if config.radius_sigma > 0:
        radius = np.ceil(config.radius_sigma * np.sqrt(lam1))
    else:
        # exact opacity-aware footprint (see ops.projection)
        log_ratio = np.log(np.maximum(opacity, config.alpha_cutoff)
                           / config.alpha_cutoff)
        radius = np.ceil(np.sqrt(2.0 * lam1 * log_ratio))
    radius = np.minimum(radius, config.max_radius_px)

    rgb = _sh_to_rgb(
        np.asarray(cloud.sh, dtype=np.float64),
        (xyz - cam_pos) / np.maximum(
            np.linalg.norm(xyz - cam_pos, axis=1, keepdims=True), 1e-12),
    )
    on_screen = ((mean2d[:, 0] + radius >= 0) & (mean2d[:, 0] - radius < width)
                 & (mean2d[:, 1] + radius >= 0) & (mean2d[:, 1] - radius < height))
    valid = in_front & det_ok & (radius > 0) & on_screen

    # global front-to-back order (the reference's per-frame depth sort,
    # shaders.ts:66-68 + radix sort)
    order = np.argsort(np.where(valid, depth, np.inf), kind="stable")

    # The blend stage accumulates in float32 — the INRIA CUDA (and GPU
    # kernel) working precision — so the knife-edge transmittance-threshold
    # comparisons pick the same contributor set as the accelerator path.
    mean2d32 = mean2d.astype(np.float32)
    conic32 = conic.astype(np.float32)
    rgb32 = rgb.astype(np.float32)
    opacity32 = opacity.astype(np.float32)

    img = np.zeros((height, width, 3), dtype=np.float32)
    trans = np.ones((height, width), dtype=np.float32)
    done = np.zeros((height, width), dtype=bool)

    # Coverage uses the same tile-aligned footprint as ops.sort.bin_splats
    # (INRIA getRect): a splat touches exactly the pixels of the tiles its
    # 3σ rect overlaps. This makes oracle and tiled renderer agree exactly,
    # not just up to the alpha cutoff tail outside the rect.
    ts = config.tile_size
    gx, gy = config.grid_size(width, height)
    ys, xs = np.mgrid[0:height, 0:width]
    for idx in order:
        if not valid[idx]:
            break
        x0 = int(np.clip(np.floor((mean2d[idx, 0] - radius[idx]) / ts), 0, gx)) * ts
        x1 = min(int(np.clip(np.floor((mean2d[idx, 0] + radius[idx]) / ts) + 1, 0, gx)) * ts, width)
        y0 = int(np.clip(np.floor((mean2d[idx, 1] - radius[idx]) / ts), 0, gy)) * ts
        y1 = min(int(np.clip(np.floor((mean2d[idx, 1] + radius[idx]) / ts) + 1, 0, gy)) * ts, height)
        if x0 >= x1 or y0 >= y1:
            continue
        dx = (xs[y0:y1, x0:x1] - mean2d32[idx, 0]).astype(np.float32)
        dy = (ys[y0:y1, x0:x1] - mean2d32[idx, 1]).astype(np.float32)
        power = (np.float32(-0.5) * (conic32[idx, 0] * dx * dx + conic32[idx, 2] * dy * dy)
                 - conic32[idx, 1] * dx * dy)
        power = np.minimum(power, np.float32(0.0))
        alpha = np.minimum(opacity32[idx] * np.exp(power),
                           np.float32(config.alpha_max))
        alpha = np.where(alpha < config.alpha_cutoff, np.float32(0.0), alpha)

        tile_T = trans[y0:y1, x0:x1]
        test_T = tile_T * (np.float32(1.0) - alpha)
        contribute = (~done[y0:y1, x0:x1]) & (alpha > 0)
        newly_done = contribute & (test_T < config.transmittance_eps)
        contribute &= ~newly_done

        w = np.where(contribute, alpha * tile_T, np.float32(0.0))
        img[y0:y1, x0:x1] += w[..., None] * rgb32[idx]
        trans[y0:y1, x0:x1] = np.where(contribute, test_T, tile_T)
        done[y0:y1, x0:x1] |= newly_done

    bg = np.asarray(config.background, dtype=np.float32)
    return (img + trans[..., None] * bg).astype(np.float64)
