"""Core pytree types.

The reference packs gaussians into an interleaved WGSL-struct byte buffer
(src/packing.ts, src/ply.ts:249-263: {position vec3, logScale vec3, rotQuat
vec4, opacityLogit f32, shCoeffs vec3[K]}). Here the layout is
structure-of-arrays: each field is a dense [N, ...] array so every per-gaussian
op is a vectorized map that XLA fuses, and fields shard/replicate
independently under shard_map.

Parameters are stored in their *raw* (pre-activation) form — log-scale and
opacity logit — and decoded in-kernel (exp/sigmoid), making them directly
differentiable training parameters. The reference instead applies exp on the
CPU at load time (src/ply.ts:333-335) and sigmoid in-shader
(src/simple_render.ts:328); we move both into the kernel.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


def _register(cls, data_fields, meta_fields=()):
    jax.tree_util.register_dataclass(
        cls, data_fields=list(data_fields), meta_fields=list(meta_fields)
    )
    return cls


@dataclasses.dataclass
class GaussianCloud:
    """A structure-of-arrays 3D Gaussian point cloud.

    Attributes:
      xyz:           [N, 3] float — world-space means.
      log_scale:     [N, 3] float — log of per-axis scales (exp in-kernel).
      quat:          [N, 4] float — rotation quaternion (x, y, z, w), need not
                     be normalized (normalized in-kernel). Standard convention;
                     see io.ply for the mapping from the reference's
                     swizzle+sign-flip storage (src/ply.ts:170-213).
      opacity_logit: [N] float — opacity logit (sigmoid in-kernel).
      sh:            [N, K, 3] float — spherical-harmonics color coefficients,
                     K in {1, 4, 9, 16} for degrees 0-3 (src/ply.ts:130-143).
    """

    xyz: jax.Array
    log_scale: jax.Array
    quat: jax.Array
    opacity_logit: jax.Array
    sh: jax.Array

    @property
    def num_gaussians(self) -> int:
        return self.xyz.shape[0]

    @property
    def sh_degree(self) -> int:
        k = self.sh.shape[1]
        return {1: 0, 4: 1, 9: 2, 16: 3}[k]

    def astype(self, dtype) -> "GaussianCloud":
        return GaussianCloud(
            xyz=self.xyz.astype(dtype),
            log_scale=self.log_scale.astype(dtype),
            quat=self.quat.astype(dtype),
            opacity_logit=self.opacity_logit.astype(dtype),
            sh=self.sh.astype(dtype),
        )

    def with_storage_dtype(self, dtype: str) -> "GaussianCloud":
        """Apply the RenderConfig.dtype storage policy.

        'bfloat16' stores the SH coefficients, log-scales, quaternions and
        opacity logits in bf16 — SH alone is 48 of the 59 floats per
        degree-3 gaussian, so scene memory nearly halves and per-chip
        scene capacity nearly doubles. Positions stay float32: a bf16
        mantissa (8 bits) would move splat centers by whole pixels at
        screen scale, while bf16 on the other fields perturbs alpha/color
        by ~0.4% relative (validated vs f32 in
        tests/test_rasterize.py::test_bfloat16_storage_close_to_f32).
        Compute is unaffected — projection decodes every field to f32
        (projection.py casts at use), matching the "bf16 storage, f32
        accumulate" policy of SURVEY §7.
        """
        import jax.numpy as jnp

        if dtype in ("float32", "f32"):
            return self
        if dtype not in ("bfloat16", "bf16"):
            raise ValueError(f"unsupported storage dtype {dtype!r}")
        bf = jnp.bfloat16
        return GaussianCloud(
            xyz=self.xyz,                                # f32: pixel accuracy
            log_scale=self.log_scale.astype(bf),
            quat=self.quat.astype(bf),
            opacity_logit=self.opacity_logit.astype(bf),
            sh=self.sh.astype(bf),
        )

    def bbox(self):
        """(min, max) scene bounding box (ref: src/ply.ts:276-285)."""
        return jnp.min(self.xyz, axis=0), jnp.max(self.xyz, axis=0)

    def reindex(self, order) -> "GaussianCloud":
        """Reorder all per-gaussian rows by `order` (host or device index
        array). Rendering is order-independent (depth sort happens per
        frame), so any permutation is semantics-preserving."""
        return GaussianCloud(
            xyz=self.xyz[order],
            log_scale=self.log_scale[order],
            quat=self.quat[order],
            opacity_logit=self.opacity_logit[order],
            sh=self.sh[order],
        )

    def spatial_sort(self) -> "GaussianCloud":
        """Morton-order the cloud (one host-side sort per scene).

        Gives spatially coherent storage (useful for chunked/streamed
        processing and keeping densification clones near their parents).
        It is not wired into the render hot path: whether index locality
        speeds up the per-frame pair gather on the GPU is not measured.
        """
        return self.reindex(morton_order(np.asarray(jax.device_get(self.xyz))))


_register(
    GaussianCloud, ["xyz", "log_scale", "quat", "opacity_logit", "sh"]
)


def morton_order(xyz: np.ndarray) -> np.ndarray:
    """Argsort of 30-bit Morton (Z-order) codes of bbox-quantized positions."""
    p = np.asarray(xyz, dtype=np.float64)
    p = np.nan_to_num(p)
    lo, hi = p.min(axis=0), p.max(axis=0)
    q = ((p - lo) / np.maximum(hi - lo, 1e-12) * 1023.0).astype(np.uint64)

    def spread(v):  # interleave 10 bits with two zero bits each
        v &= np.uint64(0x3FF)
        v = (v | (v << np.uint64(16))) & np.uint64(0x030000FF)
        v = (v | (v << np.uint64(8))) & np.uint64(0x0300F00F)
        v = (v | (v << np.uint64(4))) & np.uint64(0x030C30C3)
        v = (v | (v << np.uint64(2))) & np.uint64(0x09249249)
        return v

    code = (
        spread(q[:, 0])
        | (spread(q[:, 1]) << np.uint64(1))
        | (spread(q[:, 2]) << np.uint64(2))
    )
    return np.argsort(code, kind="stable")


@dataclasses.dataclass
class CameraParams:
    """Dynamic (traced) camera state.

    Static shape info (image width/height) is deliberately *not* part of this
    pytree: it is passed separately as static arguments so jit sees fixed
    shapes.

    The uniform struct of the reference carries {viewMatrix, projMatrix,
    cameraPosition, tanHalfFovX/Y, focalX/Y, scaleModifier}
    (src/renderer.ts:24-33); this is the same surface as arrays.

    Attributes:
      view:      [4, 4] world→camera matrix.
      proj:      [4, 4] camera→clip matrix (INRIA convention, see core.camera).
      cam_pos:   [3] camera center in world space (for SH view direction,
                 ref src/camera.ts:135-138).
      focal:     [2] (focal_x, focal_y) in pixels.
      tan_half_fov: [2] (tan(fovx/2), tan(fovy/2)).
      scale_modifier: [] global scale multiplier (ref simple_render.ts:98).
    """

    view: jax.Array
    proj: jax.Array
    cam_pos: jax.Array
    focal: jax.Array
    tan_half_fov: jax.Array
    scale_modifier: jax.Array

    @property
    def view_proj(self) -> jax.Array:
        return jnp.matmul(self.proj, self.view,
                          precision=jax.lax.Precision.HIGHEST)


_register(
    CameraParams,
    ["view", "proj", "cam_pos", "focal", "tan_half_fov", "scale_modifier"],
)


def stack_cameras(cams) -> CameraParams:
    """Stack a list of CameraParams into a batched CameraParams (leading axis)."""
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *cams)


def numpy_cloud(cloud: GaussianCloud) -> GaussianCloud:
    """Device→host copy of every field (for the CPU reference renderer)."""
    return GaussianCloud(
        xyz=np.asarray(cloud.xyz),
        log_scale=np.asarray(cloud.log_scale),
        quat=np.asarray(cloud.quat),
        opacity_logit=np.asarray(cloud.opacity_logit),
        sh=np.asarray(cloud.sh),
    )
