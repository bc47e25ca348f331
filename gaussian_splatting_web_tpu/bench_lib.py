"""Benchmark harness (shared by repo-root bench.py and the CLI `bench`).

Measures, on the default JAX device, with the SHIPPED RenderConfig defaults
(what bench.py measures is exactly what render()/CLI/viewer run):

  * forward render throughput (Mpix/s) at the target resolution,
  * forward+backward throughput,
  * bin+sort throughput (M splats/s).

Timing is the host clock around calls that end in `block_until_ready`,
after warm-up calls that absorb compilation (utils.metrics.time_fn). Every
result names the device it ran on. The benchmark needs a GPU: on any other
backend it raises instead of reporting a CPU number under a device metric.

With no PLY given, a 1M-gaussian synthetic scene shaped like an
INRIA-trained capture is used (the reference ships only toy scenes; its
large blobs are stripped — .MISSING_LARGE_BLOBS).
"""

from __future__ import annotations

import json
import sys
from typing import Optional

import numpy as np


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def make_scene(n, seed=0, sh_degree=3, log_scale_range=(-6.0, -4.0)):
    """Synthetic scene shaped like an INRIA-trained capture: many small
    splats (screen footprints of a few pixels to a couple of tiles), which
    is what real trained scenes look like (garden/bicycle: 1-6M splats at
    roughly pixel scale)."""
    from .core.types import GaussianCloud

    rng = np.random.default_rng(seed)
    k = {0: 1, 1: 4, 2: 9, 3: 16}[sh_degree]
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return GaussianCloud(
        xyz=(rng.normal(size=(n, 3)) * 2.0).astype(np.float32),
        log_scale=rng.uniform(*log_scale_range, size=(n, 3)).astype(np.float32),
        quat=q,
        opacity_logit=rng.uniform(-3, 1, size=(n,)).astype(np.float32),
        sh=rng.normal(scale=0.3, size=(n, k, 3)).astype(np.float32),
    )


def device_record() -> dict:
    """The device a result was measured on, as JAX reports it."""
    import jax

    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def run(
    ply: Optional[str] = None,
    width: int = 1920,
    height: int = 1080,
    n_synthetic: int = 1_000_000,
    emit_json: bool = True,
) -> dict:
    import jax
    import jax.numpy as jnp

    from .config import RenderConfig
    from .core import camera as cam
    from .io.ply import read_ply
    from .ops.projection import project_gaussians
    from .ops.rasterize import render_impl
    from .ops.sort import bin_splats
    from .utils.metrics import enable_compile_cache, time_fn

    device = device_record()
    if device["platform"] != "gpu":
        raise RuntimeError(
            f"bench measures the GPU; the default backend is "
            f"{device['platform']}")
    enable_compile_cache()

    # the shipped defaults ARE the benched configuration
    config = RenderConfig()

    _log(f"device={device}")
    if ply:
        cloud = read_ply(ply)
        lo, hi = cloud.bbox()
        center = (np.asarray(lo) + np.asarray(hi)) / 2
        eye = center + np.array([0, 0, -5.0])
    else:
        cloud = make_scene(n_synthetic)
        center = np.zeros(3)
        eye = np.array([0, 0, -8.0])
    n = cloud.num_gaussians
    cloud = jax.device_put(cloud)
    camera = jax.device_put(
        cam.default_camera(width, height, eye=eye, center=center)
    )

    fwd = jax.jit(lambda c: render_impl(c, camera, width, height, config)[0])
    t = time_fn(fwd, cloud, iters=10)
    mpixps = width * height / t / 1e6
    _log(f"forward: {t*1e3:.3f} ms → {mpixps:.2f} Mpix/s "
         f"({n} gaussians @{width}x{height})")

    grad = jax.jit(jax.grad(
        lambda c: jnp.sum(render_impl(c, camera, width, height, config)[0])))
    tb = time_fn(grad, cloud, iters=5)
    _log(f"forward+backward: {tb*1e3:.3f} ms → "
         f"{width*height/tb/1e6:.2f} Mpix/s")

    bin_fn = jax.jit(lambda c: bin_splats(
        project_gaussians(c, camera, width, height, config),
        width, height, config))
    ts = time_fn(bin_fn, cloud, iters=10)
    bins = bin_fn(cloud)
    _log(f"project+bin+sort: {ts*1e3:.3f} ms → {n/ts/1e6:.2f} M splats/s "
         f"(live pairs {int(bins.num_pairs)}, overflow {int(bins.overflow)})")

    result = {
        "metric": f"forward_render_{height}p",
        "value": mpixps,
        "unit": "Mpix/s",
        "fwd_bwd_mpixps": width * height / tb / 1e6,
        "sort_msplats_per_s": n / ts / 1e6,
        "device": device,
    }
    if emit_json:
        print(json.dumps(result))
    return result
