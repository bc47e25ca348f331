"""Tests of the Triton compositor kernel (ops/triton_raster.py) and the one
compositor dispatch (ops.rasterize.select_compositor).

On the CPU the kernel runs in Pallas' interpreter (interpret=True: the same
kernel code that is compiled for the GPU). The `gpu`-marked test compiles
it for the card and skips elsewhere; chip_smoke.py runs that comparison at
full size on the card.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gaussian_splatting_web_tpu.config import RenderConfig
from gaussian_splatting_web_tpu.core import camera as cam
from gaussian_splatting_web_tpu.ops.projection import project_gaussians
from gaussian_splatting_web_tpu.ops.rasterize import (
    composite_tiles, rasterize_tiles, select_compositor,
)
from gaussian_splatting_web_tpu.ops.sort import bin_splats
from gaussian_splatting_web_tpu.ops.triton_raster import (
    composite_fields_kernel, composite_tiles_kernel,
)
from tests.conftest import assert_images_close, make_random_cloud

CFG = RenderConfig(max_dup=64, max_per_tile=256, tile_chunk=4)


def _setup(n=60, seed=0, sh_degree=1, w=64, h=48, cfg=CFG):
    cloud = make_random_cloud(n, seed=seed, sh_degree=sh_degree)
    camera = cam.default_camera(w, h, eye=(0, 0, -6), center=(0, 0, 0))
    s = project_gaussians(cloud, camera, w, h, cfg)
    b = bin_splats(s, w, h, cfg)
    return s, b, w, h


def _all_tiles(w, h, cfg):
    gx, gy = cfg.grid_size(w, h)
    n = gx * gy
    padded = -(-n // cfg.tile_chunk) * cfg.tile_chunk
    return jnp.arange(padded, dtype=jnp.int32) % n, gx


def _both(s, b, w, h, cfg):
    ids, gx = _all_tiles(w, h, cfg)
    ref = composite_tiles(s, b, ids, gx, cfg)
    out = composite_tiles_kernel(s, b, ids, gx, cfg, interpret=True)
    return np.asarray(out), np.asarray(ref)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pallas_matches_xla(seed):
    s, b, w, h = _setup(seed=seed)
    out, ref = _both(s, b, w, h, CFG)
    assert out.shape == ref.shape
    assert_images_close(out.reshape(-1, 16, 4), ref.reshape(-1, 16, 4))
    assert float(ref[..., 3].max()) > 0.1          # the scene is visible


def _opaque_stack(n=40):
    cloud = make_random_cloud(n, seed=5, sh_degree=0)
    rng = np.random.default_rng(7)
    cloud.xyz = np.concatenate(
        [rng.normal(scale=0.05, size=(n, 2)), rng.uniform(-2, 2, (n, 1))],
        axis=1).astype(np.float32)
    cloud.opacity_logit = np.full((n,), 6.0, dtype=np.float32)
    cloud.log_scale = np.full((n, 3), -0.7, dtype=np.float32)
    return cloud


def test_pallas_early_termination_scene():
    """Opaque stacked scene: every pixel of the centre tiles crosses the
    1e-4 transmittance threshold, so the kernel's while_loop exits before
    the end of those tiles' lists."""
    w = h = 48
    camera = cam.default_camera(w, h, eye=(0, 0, -6), center=(0, 0, 0))
    s = project_gaussians(_opaque_stack(), camera, w, h, CFG)
    b = bin_splats(s, w, h, CFG)
    out, ref = _both(s, b, w, h, CFG)
    assert float(ref[..., 3].max()) > 0.999         # saturated pixels
    assert_images_close(out.reshape(-1, 16, 4), ref.reshape(-1, 16, 4))


def test_pallas_grad_through_custom_vjp():
    """The custom VJP is the XLA compositor's VJP on the same bins."""
    s, b, w, h = _setup(n=20)
    ids, gx = _all_tiles(w, h, CFG)
    wts = jnp.linspace(0.5, 1.5, 4)

    def loss(fn):
        return lambda s: jnp.sum(fn(s) ** 2 * wts)

    g1 = jax.grad(loss(lambda s: composite_tiles_kernel(
        s, b, ids, gx, CFG, interpret=True)), allow_int=True)(s)
    g0 = jax.grad(loss(lambda s: composite_tiles(s, b, ids, gx, CFG)),
                  allow_int=True)(s)
    for name in ("mean2d", "conic", "rgb", "opacity"):
        np.testing.assert_allclose(
            np.asarray(getattr(g1, name)), np.asarray(getattr(g0, name)),
            atol=1e-6, err_msg=name)


def test_rasterize_pallas_binned_matches_xla():
    """The shipped binning (packed depth key, tiers, pair cap) feeding the
    kernel gives the XLA compositor's image."""
    cfg = RenderConfig(max_dup=16, max_per_tile=256, tile_chunk=4,
                       depth_bits=19, tier_split=2, gather_cap_factor=3.0)
    s, b, w, h = _setup(n=60, seed=3, cfg=cfg)
    out, ref = _both(s, b, w, h, cfg)
    assert_images_close(out.reshape(-1, 16, 4), ref.reshape(-1, 16, 4))


def test_subset_kernel_matches_composite_tiles():
    """An arbitrary strided tile subset (one shard's deal) composites the
    same tiles as the XLA compositor, value and gradient."""
    cfg = CFG.replace(tile_chunk=2)
    cloud = make_random_cloud(60, seed=4, sh_degree=1)
    w, h = 64, 48
    camera = cam.default_camera(w, h, eye=(0, 0, -6), center=(0, 0, 0))
    gx, gy = cfg.grid_size(w, h)
    tile_ids = jnp.arange(1, gx * gy, 2, dtype=jnp.int32)

    def f(kernel):
        def run(cl):
            s = project_gaussians(cl, camera, w, h, cfg)
            b = bin_splats(s, w, h, cfg)
            if kernel:
                return composite_tiles_kernel(s, b, tile_ids, gx, cfg, True)
            return composite_tiles(s, b, tile_ids, gx, cfg)
        return run

    np.testing.assert_allclose(np.asarray(f(True)(cloud)),
                               np.asarray(f(False)(cloud)), atol=2e-4)
    ww = jnp.linspace(0.3, 1.0, 4)
    g_k = jax.grad(lambda cl: jnp.sum(f(True)(cl) * ww))(cloud)
    g_x = jax.grad(lambda cl: jnp.sum(f(False)(cl) * ww))(cloud)
    for a, b_ in zip(jax.tree_util.tree_leaves(g_k),
                     jax.tree_util.tree_leaves(g_x)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b_),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("max_per_tile", [20, 44])
def test_kernel_cap_and_padding(max_per_tile):
    """A max_per_tile that the kernel's CHUNK does not divide: the field
    rows are padded to whole chunks, and every tile's list is cut at
    max_per_tile exactly as the XLA compositor cuts it."""
    from gaussian_splatting_web_tpu.ops.triton_raster import CHUNK

    assert max_per_tile % CHUNK
    cfg = RenderConfig(max_dup=64, max_per_tile=max_per_tile, tile_chunk=4)
    s, b, w, h = _setup(n=200, seed=8, cfg=cfg)
    assert int(b.tile_count.max()) > max_per_tile     # the cap binds
    out, ref = _both(s, b, w, h, cfg)
    assert_images_close(out.reshape(-1, 16, 4), ref.reshape(-1, 16, 4))


def test_kernel_output_layout():
    """composite_fields_kernel returns [T, 4, P] rows (r, g, b, alpha);
    the wrapper turns them into [T, ts, ts, 4] pixel-major tiles."""
    s, b, w, h = _setup(n=30, seed=6)
    ids, gx = _all_tiles(w, h, CFG)
    from gaussian_splatting_web_tpu.ops.rasterize import pack_sorted_fields

    fields = pack_sorted_fields(s, b, pad=CFG.max_per_tile)
    rows = composite_fields_kernel(fields, ids, b.tile_start[ids],
                                   b.tile_count[ids], gx, CFG, True)
    assert rows.shape == (ids.shape[0], 4, 256)
    tiles = composite_tiles_kernel(s, b, ids, gx, CFG, interpret=True)
    assert tiles.shape == (ids.shape[0], 16, 16, 4)
    np.testing.assert_array_equal(
        np.asarray(rows).transpose(0, 2, 1).reshape(tiles.shape),
        np.asarray(tiles))


def test_kernel_needs_power_of_two_tiles():
    cfg = CFG.replace(tile_size=12)
    s, b, w, h = _setup(n=10, cfg=cfg)
    ids, gx = _all_tiles(w, h, cfg)
    with pytest.raises(ValueError, match="power-of-two tile_size"):
        composite_tiles_kernel(s, b, ids, gx, cfg, interpret=True)


@pytest.mark.parametrize("platform,use_pallas,debug,want", [
    ("cpu", "auto", -1, "xla"),
    ("cpu", "never", -1, "xla"),
    ("gpu", "auto", -1, "kernel"),
    ("gpu", "never", -1, "xla"),
    ("gpu", "auto", 3, "xla"),
    ("cpu", "always", -1, ValueError),
    ("gpu", "always", -1, ValueError),
    ("metal", "auto", -1, ValueError),
    ("gpu", "sometimes", -1, ValueError),
])
def test_select_compositor(platform, use_pallas, debug, want):
    cfg = RenderConfig(use_pallas=use_pallas, debug_selected=debug)
    if isinstance(want, type):
        with pytest.raises(want):
            select_compositor(platform, cfg)
    else:
        assert select_compositor(platform, cfg) == want


def test_rasterize_tiles_takes_xla_path_on_cpu():
    """On the CPU backend the default dispatch is the XLA compositor: the
    traced program holds no Pallas call."""
    s, b, w, h = _setup(n=10)
    jaxpr = jax.make_jaxpr(
        lambda s: rasterize_tiles(s, b, w, h, CFG))(s)
    assert "pallas_call" not in str(jaxpr)
    jaxpr_k = jax.make_jaxpr(
        lambda s: rasterize_tiles(s, b, w, h, CFG, platform="gpu"))(s)
    assert "pallas_call" in str(jaxpr_k)


@pytest.mark.gpu
def test_compiled_kernel_matches_xla_on_gpu(gpu_device):
    """The kernel compiled for the card (no interpreter) against the XLA
    compositor on the same bins."""
    with jax.default_device(gpu_device):
        s, b, w, h = _setup(n=200, seed=1)
        ids, gx = _all_tiles(w, h, CFG)
        out = jax.jit(lambda s, b: composite_tiles_kernel(
            s, b, ids, gx, CFG))(s, b)
        ref = jax.jit(lambda s, b: composite_tiles(s, b, ids, gx, CFG))(s, b)
    assert_images_close(np.asarray(out).reshape(-1, 16, 4),
                        np.asarray(ref).reshape(-1, 16, 4))
