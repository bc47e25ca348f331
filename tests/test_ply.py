"""PLY IO tests against the reference's semantics (src/ply.ts) on small
scenes committed under tests/data (written by tests/data/make_fixtures.py
with io.ply.write_ply, at the sizes of the reference's sample scenes)."""

import io
import os

import numpy as np
import pytest

from gaussian_splatting_web_tpu.io.ply import read_ply, write_ply, _parse_header
from tests.conftest import DATA_DIR, make_random_cloud

SIMPLE = os.path.join(DATA_DIR, "simple.ply")
M3 = os.path.join(DATA_DIR, "m3splat.ply")
PC_SHORT = os.path.join(DATA_DIR, "pc_short.ply")


def test_header_simple():
    with open(SIMPLE, "rb") as f:
        header = _parse_header(f.read())
    assert header.vertex_count == 62
    assert header.sh_degree == 3  # 45 f_rest → deg 3 (ply.ts:227-235)
    assert header.n_sh_coeffs == 16


@pytest.mark.parametrize("path,count", [(SIMPLE, 62), (M3, 3), (PC_SHORT, 100)])
def test_read_reference_scenes(path, count):
    cloud = read_ply(path)
    assert cloud.num_gaussians == count
    assert cloud.sh.shape == (count, 16, 3)
    assert cloud.sh_degree == 3
    # quats normalized (ply.ts:170-176) and finite (NaN guard ply.ts:293-296)
    norms = np.linalg.norm(cloud.quat, axis=1)
    assert np.all(np.isfinite(cloud.quat))
    assert np.allclose(norms[norms > 0], 1.0, atol=1e-5)
    assert np.all(np.isfinite(cloud.xyz))


def test_reference_quat_equivalence():
    """Our (x,y,z,w) quat → standard R must equal the reference's
    sign-flipped quat → column-major shader R (see io/ply.py docstring)."""
    cloud = read_ply(SIMPLE)
    q = np.asarray(cloud.quat, dtype=np.float64)

    # reference path: qq = (-x, -y, -z, w) (ply.ts:202-213), then the WGSL
    # mat3x3 constructor builds the TRANSPOSE of the row listing
    # (simple_render.ts:110-114)
    x, y, z, w = -q[:, 0], -q[:, 1], -q[:, 2], q[:, 3]
    rows = np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], axis=1)
    ref_R = np.swapaxes(rows, 1, 2)  # column-major constructor transposes

    from gaussian_splatting_web_tpu.ops.projection import quat_to_rotmat
    ours = np.asarray(quat_to_rotmat(cloud.quat), dtype=np.float64)
    np.testing.assert_allclose(ours, ref_R, atol=1e-5)


def test_roundtrip():
    cloud = make_random_cloud(17, seed=3, sh_degree=2)
    buf = io.BytesIO()
    write_ply(cloud, buf)
    back = read_ply(buf.getvalue())
    np.testing.assert_allclose(back.xyz, cloud.xyz, atol=1e-6)
    np.testing.assert_allclose(back.log_scale, cloud.log_scale, atol=1e-6)
    np.testing.assert_allclose(back.opacity_logit, cloud.opacity_logit, atol=1e-6)
    np.testing.assert_allclose(back.sh, cloud.sh, atol=1e-6)
    # quats match up to normalization (they were already unit)
    np.testing.assert_allclose(back.quat, cloud.quat, atol=1e-5)
    assert back.sh_degree == 2


def test_progress_callback(tmp_path):
    cloud = make_random_cloud(5, seed=1)
    p = tmp_path / "x.ply"
    write_ply(cloud, str(p))
    calls = []
    read_ply(str(p), progress=lambda got, total: calls.append((got, total)))
    assert calls and calls[-1][0] == calls[-1][1]


def test_bbox():
    cloud = read_ply(SIMPLE)
    lo, hi = cloud.bbox()
    assert np.all(np.asarray(lo) <= np.asarray(hi))
