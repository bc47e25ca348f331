"""Quickstart: render a reference scene, differentiate through the render,
and take one training step. Runs on the CPU or a GPU.

    python examples/quickstart.py [path/to/scene.ply]
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

from gaussian_splatting_web_tpu import RenderConfig
from gaussian_splatting_web_tpu.core import camera as cam
from gaussian_splatting_web_tpu.io.ply import read_ply
from gaussian_splatting_web_tpu.models.gaussian_model import GaussianModel
from gaussian_splatting_web_tpu.ops.rasterize import render, render_impl
from gaussian_splatting_web_tpu.train.trainer import (
    init_train_state, make_optimizer, make_train_step,
)
from gaussian_splatting_web_tpu.utils.image import write_png


def main():
    ply = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "tests", "data",
        "pc_short.ply")
    cloud = jax.device_put(read_ply(ply))
    print(f"{cloud.num_gaussians} gaussians, SH degree {cloud.sh_degree}")

    lo, hi = cloud.bbox()
    center = (np.asarray(lo) + np.asarray(hi)) / 2
    w, h = 400, 300
    camera = cam.default_camera(w, h, eye=center + np.array([0, 0, -4.0]),
                                center=center)
    config = RenderConfig(max_per_tile=256)

    # forward render
    img, aux = render(cloud, camera, w, h, config)
    write_png(np.asarray(img), "quickstart.png")
    print(f"rendered quickstart.png ({int(aux['num_pairs'])} splat-tile pairs)")

    # differentiate straight through the renderer
    def brightness(cloud):
        img, _ = render_impl(cloud, camera, w, h, config)
        return jnp.mean(img)

    g = jax.grad(brightness)(cloud)
    print("d(mean brightness)/d(opacity_logit) norm:",
          float(jnp.linalg.norm(g.opacity_logit)))

    # one training step toward a dimmed copy of the image
    model = GaussianModel.from_cloud(cloud)
    opt = make_optimizer()
    state = init_train_state(model, opt)
    step = make_train_step(opt, w, h, config)
    state, loss = step(state, camera, img * 0.5)
    print("train step loss:", float(loss))


if __name__ == "__main__":
    main()
