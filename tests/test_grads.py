"""Differentiability tests (BASELINE config 2: forward + backward gradcheck).

The renderer is differentiable by construction (log-transmittance cumsum);
these tests check gradients numerically against finite differences and
structurally (nonzero where expected, zero for invisible splats).
"""

import numpy as np
import jax
import jax.numpy as jnp

from gaussian_splatting_web_tpu.config import RenderConfig
from gaussian_splatting_web_tpu.core import camera as cam
from gaussian_splatting_web_tpu.models.gaussian_model import GaussianModel
from gaussian_splatting_web_tpu.ops.rasterize import render_impl
from tests.conftest import make_random_cloud

CFG = RenderConfig(max_dup=128, max_per_tile=64, tile_chunk=4)
W = H = 32


def _camera():
    return cam.default_camera(W, H, eye=(0, 0, -6), center=(0, 0, 0))


def _loss(cloud):
    img, _ = render_impl(cloud, _camera(), W, H, CFG)
    # weighted sum so the gradient isn't uniform
    wgt = jnp.linspace(0.0, 1.0, W * H * 3).reshape(H, W, 3)
    return jnp.sum(img * wgt)


def test_grads_exist_and_finite():
    cloud = make_random_cloud(12, seed=0, sh_degree=1)
    g = jax.grad(_loss)(cloud)
    for name in ("xyz", "log_scale", "quat", "opacity_logit", "sh"):
        arr = np.asarray(getattr(g, name))
        assert np.all(np.isfinite(arr)), name
    # visible scene → some gradient signal on every continuous parameter
    assert np.abs(np.asarray(g.sh)).max() > 0
    assert np.abs(np.asarray(g.opacity_logit)).max() > 0
    assert np.abs(np.asarray(g.xyz)).max() > 0


def test_grad_matches_finite_difference():
    """Directional finite-difference check through the full pipeline
    (the role of jax.test_util.check_grads, but robust to the alpha-cutoff
    discontinuities: we test at a point and direction where the render is
    locally smooth)."""
    cloud = make_random_cloud(6, seed=2, sh_degree=0)
    loss = lambda c: _loss(c)
    g = jax.grad(loss)(cloud)

    # The render is only PIECEWISE smooth: every footprint edge is an
    # alpha-cutoff level set, and a finite step moves it across discrete
    # pixels (O(1/255) jumps). Central differences therefore cannot
    # converge below a few percent at ANY eps (measured: fd at eps=1e-4
    # swings 0.21..0.74 around dot=0.597 for both the round-4 and round-5
    # alpha formulations). This check's job is to catch sign / missing-
    # factor bugs (≥50% discrepancies), so: several directions, several
    # steps, best-of agreement per direction.
    for dseed in (0, 3):
        rng = np.random.default_rng(dseed)
        direction = jax.tree_util.tree_map(
            lambda x: jnp.asarray(
                rng.normal(size=np.shape(x)).astype(np.float32)), cloud
        )
        dot = sum(
            float(jnp.vdot(a, b))
            for a, b in zip(jax.tree_util.tree_leaves(g),
                            jax.tree_util.tree_leaves(direction))
        )

        def shift(s, direction=direction):
            return jax.tree_util.tree_map(
                lambda x, d: x + s * d, cloud, direction)

        diffs = []
        for eps in (5e-4, 1e-3, 2e-3):
            f_plus = float(loss(shift(eps)))
            f_minus = float(loss(shift(-eps)))
            fd = (f_plus - f_minus) / (2 * eps)
            diffs.append(abs(fd - dot) / max(1.0, abs(fd)))
        assert min(diffs) < 7e-2, (dseed, diffs, dot)


def test_invisible_splat_zero_grad():
    cloud = make_random_cloud(2, seed=1, sh_degree=0)
    xyz = np.asarray(cloud.xyz).copy()
    xyz[1] = [0, 0, -50.0]  # far behind the camera
    cloud.xyz = xyz
    g = jax.grad(_loss)(cloud)
    assert np.abs(np.asarray(g.sh)[1]).max() == 0.0
    assert float(np.abs(np.asarray(g.opacity_logit)[1])) == 0.0


def test_occluded_splat_small_color_grad():
    """A splat fully behind an opaque one gets (near-)zero color gradient."""
    cloud = make_random_cloud(2, seed=0, sh_degree=0)
    cloud.xyz = np.array([[0, 0, -1.0], [0, 0, 0.0]], dtype=np.float32)
    cloud.log_scale = np.full((2, 3), -0.5, dtype=np.float32)
    cloud.quat = np.tile(np.array([[0, 0, 0, 1.0]], np.float32), (2, 1))
    cloud.opacity_logit = np.array([12.0, 0.0], dtype=np.float32)
    g = jax.grad(_loss)(cloud)
    front = np.abs(np.asarray(g.sh)[0]).max()
    back = np.abs(np.asarray(g.sh)[1]).max()
    # the 0.99 alpha cap leaves ~1% transmittance plus gaussian tails, so
    # "occluded" means strongly attenuated, not exactly zero
    assert back < 0.2 * front


def test_train_step_decreases_loss():
    """Overfit a tiny scene to a fixed target for a few steps."""
    import optax
    from gaussian_splatting_web_tpu.train.trainer import (
        init_train_state, make_train_step,
    )

    target_cloud = make_random_cloud(16, seed=7, sh_degree=0)
    target, _ = render_impl(target_cloud, _camera(), W, H, CFG)
    target = jax.lax.stop_gradient(target)

    start = make_random_cloud(16, seed=8, sh_degree=0)
    model = GaussianModel.from_cloud(start)
    opt = optax.adam(2e-2)
    state = init_train_state(model, opt)
    step = make_train_step(opt, W, H, CFG, lambda_dssim=0.0)

    camera = _camera()
    losses = []
    for _ in range(15):
        state, loss = step(state, camera, target)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.9, losses
    assert int(state.step) == 15


def test_zero_quat_padded_rows_finite_grads():
    """Dead zero-padded arena rows (quat = 0) must produce FINITE gradients:
    `q / max(norm(q), eps)` has a NaN gradient at q = 0 (d norm/dq = 0/0)
    even though its value is fine — a latent trainer killer the round-3
    safe-normalize (eps inside the sqrt) fixes (projection.quat_to_rotmat).
    """
    import numpy as np
    from gaussian_splatting_web_tpu.models.gaussian_model import GaussianModel
    from gaussian_splatting_web_tpu.train.densify import (
        DEAD_OPACITY, pad_to_capacity,
    )

    cloud = make_random_cloud(8, seed=3, sh_degree=0)
    model, dstate = pad_to_capacity(GaussianModel.from_cloud(cloud), 16)
    assert float(model.quat[-1].sum()) == 0.0  # zero-padded dead row

    def loss(m):
        img, _ = render_impl(m.to_cloud(0), _camera(), W, H, CFG)
        return jnp.sum(img ** 2)

    g = jax.grad(loss)(model)
    for leaf in jax.tree_util.tree_leaves(g):
        assert np.isfinite(np.asarray(leaf)).all()
