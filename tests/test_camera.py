"""Camera math tests (ref src/camera.ts)."""

import json
import math
import os

import numpy as np

from gaussian_splatting_web_tpu.core import camera as cam
from gaussian_splatting_web_tpu.io.cameras import load_cameras_json
from tests.conftest import DATA_DIR

CAM_JSON = os.path.join(DATA_DIR, "cam.json")


def test_projection_inria_structure():
    """camera.ts:19-42: symmetric frustum, +z forward, w' = z."""
    P = cam.projection_inria(0.2, 100.0, math.radians(70), math.radians(50))
    assert P[3, 2] == 1.0 and P[3, 3] == 0.0
    assert P[0, 0] == np.float32(1.0 / math.tan(math.radians(70) / 2))
    assert P[1, 1] == np.float32(1.0 / math.tan(math.radians(50) / 2))
    # znear maps to z'=0, zfar to z'=1 after divide
    for z, expect in [(0.2, 0.0), (100.0, 1.0)]:
        clip = P @ np.array([0, 0, z, 1.0])
        assert abs(clip[2] / clip[3] - expect) < 1e-5


def test_perspective_wgpu_structure():
    P = cam.perspective_wgpu(1.0, 1.5, 0.03, 1000.0)
    assert P[3, 2] == -1.0
    for z, expect in [(-0.03, 0.0), (-1000.0, 1.0)]:
        clip = P @ np.array([0, 0, z, 1.0])
        assert abs(clip[2] / clip[3] - expect) < 1e-4


def test_look_at_maps_center_forward():
    view = cam.look_at([0, 0, -5], [0, 0, 0], [0, 1, 0])
    c = view @ np.array([0, 0, 0, 1.0])
    # -z forward: center 5 units ahead → z = -5
    np.testing.assert_allclose(c[:3], [0, 0, -5], atol=1e-6)


def test_gl_to_colmap_flip():
    view = cam.gl_to_colmap_view(cam.look_at([0, 0, -5], [0, 0, 0], [0, 1, 0]))
    c = view @ np.array([0, 0, 0, 1.0])
    np.testing.assert_allclose(c[:3], [0, 0, 5], atol=1e-6)  # +z forward
    up = view @ np.array([0, 1, 0, 1.0])
    assert up[1] < 0  # y-down camera frame


def test_focal_fov_roundtrip():
    f = cam.fov2focal(cam.focal2fov(1111.0, 800), 800)
    assert abs(f - 1111.0) < 1e-9


def test_world_to_cam_from_rt_inverse():
    rng = np.random.default_rng(0)
    # random rotation via QR
    Q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(Q) < 0:
        Q[:, 0] *= -1
    t = rng.normal(size=3)
    view = cam.world_to_cam_from_rt(Q, t)
    # camera center maps to origin
    np.testing.assert_allclose(view @ np.array([*t, 1.0]), [0, 0, 0, 1], atol=1e-5)
    np.testing.assert_allclose(cam.camera_position_from_view(view), t, atol=1e-5)


def test_load_reference_cam_json():
    cams = load_cameras_json(CAM_JSON)
    assert len(cams) == 365  # SURVEY.md §2.1 #6
    camera, (w, h), name = cams[0]
    assert w > 0 and h > 0 and name
    assert camera.view.shape == (4, 4)
    assert camera.proj[3, 2] == 1.0  # INRIA convention (camera.ts:484)
    # depth of scene-ish points should be mostly positive for a real capture
    assert np.isfinite(camera.cam_pos).all()


def test_camera_from_json_target_size_quirk():
    """camera.ts:482-483 computes FOV against the canvas, not sensor, size."""
    with open(CAM_JSON) as f:
        raw = json.load(f)[0]
    c_native, (w, h), _ = load_cameras_json(json.dumps([raw]))[0]
    c_canvas, (w2, h2), _ = load_cameras_json(json.dumps([raw]), target_size=(640, 480))[0]
    assert (w2, h2) == (640, 480)
    assert not np.allclose(c_native.proj[0, 0], c_canvas.proj[0, 0])


def test_default_camera():
    c = cam.default_camera(640, 480)
    assert c.proj[3, 2] == 1.0
    # the default eye is at (0,-5,3) looking at origin → origin in front
    t = c.view @ np.array([0, 0, 0, 1.0])
    assert t[2] > 0
    np.testing.assert_allclose(c.cam_pos, [0, -5, 3], atol=1e-5)
