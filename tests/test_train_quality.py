"""Training quality regression: from-random-init training on a synthetic
multi-view capture must reach a PSNR floor.

This is the CI-sized version of the training recipe; the full-size
training benchmark cell is to be rebuilt on the GPU (ROADMAP D6).
"""

import numpy as np

from gaussian_splatting_web_tpu.config import RenderConfig
from gaussian_splatting_web_tpu.core import camera as cam
from gaussian_splatting_web_tpu.io.dataset import View
from gaussian_splatting_web_tpu.models.gaussian_model import GaussianModel
from gaussian_splatting_web_tpu.ops.rasterize import render
from gaussian_splatting_web_tpu.train.densify import compact
from gaussian_splatting_web_tpu.train.loss import psnr
from gaussian_splatting_web_tpu.train.train_loop import TrainLoopConfig, train
from tests.conftest import make_random_cloud

W, H = 48, 36
CFG = RenderConfig(max_dup=32, max_per_tile=96, tile_chunk=4)


def _camera_at(angle, y=0.4):
    eye = (4.0 * np.sin(angle), y, -4.0 * np.cos(angle))
    return cam.default_camera(W, H, eye=eye, center=(0, 0, 0))


def test_train_from_random_init_reaches_psnr_floor():
    target_cloud = make_random_cloud(48, seed=7, sh_degree=0, spread=1.0)
    views = []
    for i in range(4):
        camera = _camera_at(i * np.pi / 2)
        img, _ = render(target_cloud, camera, W, H, CFG)
        views.append(View(camera=camera, image=np.asarray(img), name=f"v{i}"))

    start = GaussianModel.from_cloud(
        make_random_cloud(48, seed=42, sh_degree=0, spread=1.0)
    )
    init_psnrs = [
        psnr(render(start.to_cloud(), v.camera, W, H, CFG)[0], v.image)
        for v in views
    ]

    state, dstate = train(
        start, views, W, H, render_config=CFG,
        loop=TrainLoopConfig(
            iterations=150, densify_from=30, densify_until=120,
            densify_every=30, opacity_reset_every=10_000,
            sh_upgrade_every=10_000, capacity_factor=4.0, log_every=50,
        ),
    )
    final = compact(state.params, dstate)
    final_psnrs = [
        psnr(render(final.to_cloud(), v.camera, W, H, CFG)[0], v.image)
        for v in views
    ]
    # learning must be substantial and absolute quality reasonable for a
    # 150-iteration run. Floor calibrated r5 across init seeds 42/3/17:
    # 23.29 / 24.55 / 23.39 dB — 21.0 keeps ~2 dB of seed margin while
    # catching any real gradient/densify regression (the old 17.0 floor
    # would have passed a 23→17.5 regression; VERDICT r4 item 3).
    assert np.mean(final_psnrs) > np.mean(init_psnrs) + 3.0
    assert np.mean(final_psnrs) > 21.0
