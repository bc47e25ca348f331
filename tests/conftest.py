"""Test configuration: run everything on the CPU with an 8-device virtual
mesh (`--xla_force_host_platform_device_count=N`, the standard stand-in for
several accelerators in distributed tests, SURVEY.md §4). Tests of code
that runs only on a GPU carry the `gpu` marker and skip here (the
`gpu_device` fixture); chip_smoke.py runs those paths on the card.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402

from gaussian_splatting_web_tpu.utils.metrics import (  # noqa: E402
    enable_compile_cache,
)

jax.config.update("jax_platforms", "cpu")
# persistent compile cache, by the program's own rule: XLA-CPU compiles
# are slow, and later runs reuse them
enable_compile_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from gaussian_splatting_web_tpu.core.types import GaussianCloud  # noqa: E402

DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def make_random_cloud(n: int, seed: int = 0, sh_degree: int = 0,
                      spread: float = 1.0, center=(0.0, 0.0, 0.0)) -> GaussianCloud:
    """A reproducible random test scene (the role of the reference's tiny
    checked-in PLYs, SURVEY.md §4)."""
    rng = np.random.default_rng(seed)
    k = {0: 1, 1: 4, 2: 9, 3: 16}[sh_degree]
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return GaussianCloud(
        xyz=(rng.normal(size=(n, 3)) * spread + np.asarray(center)).astype(np.float32),
        log_scale=rng.uniform(-3.5, -1.5, size=(n, 3)).astype(np.float32),
        quat=q,
        opacity_logit=rng.uniform(-2.0, 2.0, size=(n,)).astype(np.float32),
        sh=rng.normal(scale=0.3, size=(n, k, 3)).astype(np.float32),
    )


@pytest.fixture
def random_cloud():
    return make_random_cloud(64, seed=0, sh_degree=0)


def assert_images_close(img, ref, atol=2e-4, max_bad_frac=2e-4):
    """allclose for rendered images with an escape hatch for transmittance-
    threshold ties: the parallel log-cumsum compositor and a sequential
    product can round the T<1e-4 early-termination comparison differently on
    isolated knife-edge pixels. Those pixels are bounded in number, not in
    magnitude."""
    img = np.asarray(img, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    diff = np.abs(img - ref).max(axis=-1)
    bad = diff > atol
    frac = bad.mean()
    assert frac <= max_bad_frac, (
        f"{bad.sum()} pixels (frac {frac:.2e}) differ by more than {atol}; "
        f"max diff {diff.max():.3e}"
    )


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where JAX has none."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs a GPU; chip_smoke.py runs this path on the card")
