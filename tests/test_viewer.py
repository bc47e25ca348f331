"""Orbit state machine + web viewer + CLI smoke tests."""

import json
import os
import threading
import urllib.request

import numpy as np
import pytest

from gaussian_splatting_web_tpu.viewer import orbit
from tests.conftest import make_random_cloud


def test_rotate_preserves_radius():
    s = orbit.OrbitState(eye=(0, 0, -3), center=(0, 0, 0), radius=3.0)
    s2 = orbit.rotate(s, 0.5, 0.2)
    r = np.linalg.norm(np.asarray(s2.eye) - np.asarray(s2.center))
    assert abs(r - 3.0) < 1e-6
    assert s2.eye != s.eye


def test_rotate_noop_on_zero_delta():
    s = orbit.OrbitState()
    assert orbit.rotate(s, 0, 0) is s


def test_pole_flip_guard():
    """Large pitch deltas near the pole are rejected (camera.ts:218-223)."""
    s = orbit.OrbitState(eye=(0.01, 2.99, 0.0), center=(0, 0, 0), radius=3.0,
                         sensitivity=1.0)
    s2 = orbit.rotate(s, 0.0, 2.0)  # huge pitch → should be vetoed
    assert abs(s2.eye[1] - s.eye[1]) < 0.5


def test_translate_moves_eye_and_center_together():
    s = orbit.OrbitState(eye=(0, 0, -3), center=(0, 0, 0))
    s2 = orbit.translate(s, 0.1, 0.0)
    d_eye = np.asarray(s2.eye) - np.asarray(s.eye)
    d_center = np.asarray(s2.center) - np.asarray(s.center)
    np.testing.assert_allclose(d_eye, d_center, atol=1e-9)
    assert np.linalg.norm(d_eye) > 0


def test_zoom_clamps_radius():
    s = orbit.OrbitState(eye=(0, 0, -3), center=(0, 0, 0), radius=3.0)
    s2 = orbit.zoom(s, -1e6)
    assert s2.radius == 0.2  # camera.ts:168


def test_inertia_decay():
    s = orbit.OrbitState(eye=(1, 0, -3), center=(0, 0, 0),
                         previous_eye=(0, 0, -3))
    s = orbit.release(s)
    assert orbit.is_dirty(s)
    for _ in range(25):
        s = orbit.update(s)
    assert not orbit.is_dirty(s)


def test_to_camera():
    s = orbit.OrbitState(eye=(0, 0, -4), center=(0, 0, 0))
    c = orbit.to_camera(s, 64, 48)
    assert c.view.shape == (4, 4)
    np.testing.assert_allclose(c.cam_pos, [0, 0, -4], atol=1e-5)


def test_viewer_server_roundtrip():
    from gaussian_splatting_web_tpu.config import RenderConfig
    from gaussian_splatting_web_tpu.viewer.server import serve

    cloud = make_random_cloud(8, seed=0)
    cfg = RenderConfig(max_dup=16, max_per_tile=16, tile_chunk=2)
    httpd, app = serve(cloud, host="127.0.0.1", port=0, width=32, height=32,
                       config=cfg, block=False)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        port = httpd.server_address[1]
        base = f"http://127.0.0.1:{port}"
        with urllib.request.urlopen(base + "/") as r:
            assert b"splat viewer" in r.read()
        with urllib.request.urlopen(base + "/info") as r:
            info = json.loads(r.read())
            assert info["num_gaussians"] == 8
        req = urllib.request.Request(
            base + "/event",
            data=json.dumps({"kind": "rotate", "dx": 0.3, "dy": 0.1}).encode(),
            method="POST",
        )
        with urllib.request.urlopen(req) as r:
            png = r.read()
            assert png[:8] == b"\x89PNG\r\n\x1a\n"
        # malformed events must yield 400, not a dropped connection
        bad = urllib.request.Request(
            base + "/event", data=b"garbage!!!", method="POST"
        )
        try:
            urllib.request.urlopen(bad)
            assert False, "expected HTTPError"
        except urllib.error.HTTPError as e:
            assert e.code == 400
        # and the server must still serve afterwards
        with urllib.request.urlopen(base + "/info") as r:
            assert json.loads(r.read())["num_gaussians"] == 8
    finally:
        httpd.shutdown()


def test_cli_info_and_render(tmp_path, capsys):
    from gaussian_splatting_web_tpu.cli import main
    from gaussian_splatting_web_tpu.io.ply import write_ply

    cloud = make_random_cloud(6, seed=0, sh_degree=1)
    ply = tmp_path / "scene.ply"
    write_ply(cloud, str(ply))

    main(["info", "--ply", str(ply)])
    out = json.loads(capsys.readouterr().out)
    assert out["num_gaussians"] == 6 and out["sh_degree"] == 1

    outdir = tmp_path / "renders"
    main(["render", "--ply", str(ply), "--out", str(outdir),
          "--width", "48", "--height", "32",
          "--max-dup", "16", "--max-per-tile", "16", "--tile-chunk", "2"])
    pngs = list(outdir.glob("*.png"))
    assert len(pngs) == 1


def test_png_writer(tmp_path):
    from gaussian_splatting_web_tpu.utils.image import write_png, _png_bytes

    img = np.random.default_rng(0).uniform(size=(8, 10, 3)).astype(np.float32)
    p = tmp_path / "x.png"
    write_png(img, str(p))
    assert p.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    # pure-python fallback encoder too
    raw = _png_bytes((img * 255).astype(np.uint8))
    assert raw[:8] == b"\x89PNG\r\n\x1a\n"


def test_post_process():
    import jax.numpy as jnp

    from gaussian_splatting_web_tpu.ops.composite import post_process

    rgb = jnp.ones((8, 8, 3)) * 0.5
    alpha = jnp.full((8, 8), 0.4)
    out = post_process(rgb, alpha)
    # a' = sat(0.4*1.5) = 0.6 < 0.99 → 0.6^4
    np.testing.assert_allclose(np.asarray(out[..., 3]), 0.6**4, atol=1e-6)
    out2 = post_process(rgb, jnp.full((8, 8), 0.7))
    np.testing.assert_allclose(np.asarray(out2[..., 3]), 1.0, atol=1e-6)


# ---------------------------------------------------------------------------
# round 2: viewer parity sweep (VERDICT.md "missing" items 2-8)
# ---------------------------------------------------------------------------

def test_roll_rotates_up_only():
    """u/o roll the up vector about the view axis (camera.ts:398-424; the
    reference's rotate() drops its z arg — see orbit.roll docstring)."""
    s = orbit.OrbitState(eye=(0, 0, -3), center=(0, 0, 0), sensitivity=1.0)
    s2 = orbit.roll(s, 0.25)  # quarter turn at sensitivity 1
    assert s2.eye == s.eye and s2.center == s.center
    assert abs(np.dot(s2.up, (0, 1, 0))) < 1e-9  # 90° from +y
    # rolling back restores up
    s3 = orbit.roll(s2, -0.25)
    np.testing.assert_allclose(s3.up, (0, 1, 0), atol=1e-9)


def test_roll_noop_cases():
    s = orbit.OrbitState()
    assert orbit.roll(s, 0.0) is s
    degenerate = orbit.OrbitState(eye=(0, 0, 0), center=(0, 0, 0))
    assert orbit.roll(degenerate, 0.5) is degenerate


def test_set_sensitivity_clamps():
    s = orbit.OrbitState()
    assert orbit.set_sensitivity(s, 0.5).sensitivity == 0.5
    assert orbit.set_sensitivity(s, -1.0).sensitivity == 1e-3
    assert orbit.set_sensitivity(s, 1e9).sensitivity == 10.0


def _png_size(png: bytes):
    import struct
    return struct.unpack(">II", png[16:24])


def _start_viewer(n=8, width=32, height=32, scene_dir=None):
    import urllib.request

    from gaussian_splatting_web_tpu.config import RenderConfig
    from gaussian_splatting_web_tpu.viewer.server import serve

    cloud = make_random_cloud(n, seed=0)
    cfg = RenderConfig(max_dup=16, max_per_tile=16, tile_chunk=2)
    httpd, app = serve(cloud, host="127.0.0.1", port=0, width=width,
                       height=height, config=cfg, block=False,
                       scene_dir=scene_dir)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def post(path, data):
        req = urllib.request.Request(base + path, data=data, method="POST")
        return urllib.request.urlopen(req)

    def event(ev):
        return post("/event", json.dumps(ev).encode())

    return httpd, app, base, post, event


def test_viewer_rgba_post_processed_frames():
    """Presented frames are RGBA with the post-process alpha shaping
    (post_process_render.ts:63-76) — VERDICT missing item 4."""
    httpd, app, base, post, event = _start_viewer()
    try:
        with event({"kind": "init"}) as r:
            png = r.read()
        # IHDR color type at byte 25: 6 = RGBA
        assert png[25] == 6
        frame, _ = app.handle_event({"kind": "init"})
        assert frame.shape[-1] == 4
        # alpha channel went through the boost/knee curve: all values are
        # either >= knee or a boosted 4th power — spot-check monotonicity
        # and range
        a = frame[..., 3]
        assert a.min() >= 0.0 and a.max() <= 1.0
    finally:
        httpd.shutdown()


def test_viewer_inertia_tick_loop():
    """release arms inertia; X-Dirty stays 1 across ticks until decay
    (renderer.ts:332-387 dirty gating, camera.ts:440-442)."""
    httpd, app, base, post, event = _start_viewer()
    try:
        with event({"kind": "rotate", "dx": 0.3, "dy": 0.0}) as r:
            assert r.headers["X-Dirty"] == "0"
        with event({"kind": "release"}) as r:
            assert r.headers["X-Dirty"] == "1"
        n = 0
        while n < 40:
            with event({"kind": "tick"}) as r:
                if r.headers["X-Dirty"] == "0":
                    break
            n += 1
        assert 1 <= n < 30  # inertia decays by 0.05/frame from 1.0
    finally:
        httpd.shutdown()


def test_viewer_sensitivity_roll_resize_events():
    httpd, app, base, post, event = _start_viewer()
    try:
        with event({"kind": "sensitivity", "value": 0.25}):
            pass
        assert app.state.sensitivity == 0.25
        with event({"kind": "roll", "d": 0.5}):
            pass
        assert tuple(app.state.up) != (0.0, 1.0, 0.0)
        # resize rounds to tile multiples and re-renders at the new size
        with event({"kind": "resize", "width": 50, "height": 40}) as r:
            w, h = _png_size(r.read())
        assert (w, h) == (48, 32) == (app.width, app.height)
    finally:
        httpd.shutdown()


def test_viewer_scene_and_cameras_hot_swap(tmp_path):
    """POST /scene swaps the PLY (index.ts:29-54) and POST /cameras loads
    presets (camera.ts:529-537) without restarting the server."""
    import io as _io
    import urllib.request

    from gaussian_splatting_web_tpu.io.ply import write_ply

    httpd, app, base, post, event = _start_viewer(n=8)
    try:
        new_cloud = make_random_cloud(17, seed=3)
        buf = _io.BytesIO()
        write_ply(new_cloud, buf)
        with post("/scene", buf.getvalue()) as r:
            info = json.loads(r.read())
        assert info["num_gaussians"] == 17
        with urllib.request.urlopen(base + "/info") as r:
            assert json.loads(r.read())["num_gaussians"] == 17
        # orbit re-centered on the new scene bbox (index.ts:115-119)
        lo, hi = new_cloud.bbox()
        np.testing.assert_allclose(
            app.state.center, (np.asarray(lo) + np.asarray(hi)) / 2, atol=1e-5)

        cams = [{"id": 0, "img_name": "v0", "width": 64, "height": 48,
                 "position": [0.0, 0.0, -5.0],
                 "rotation": [[1, 0, 0], [0, 1, 0], [0, 0, 1]],
                 "fx": 60.0, "fy": 60.0}]
        with post("/cameras", json.dumps(cams).encode()) as r:
            info = json.loads(r.read())
        assert info["cameras"] == ["v0"]
        with event({"kind": "preset", "index": 0}) as r:
            assert r.read()[:8] == b"\x89PNG\r\n\x1a\n"
    finally:
        httpd.shutdown()


def test_viewer_model_url_param(tmp_path):
    """GET /?model=<name> loads <scene_dir>/<name>.ply before serving the
    page (the reference's URL-parameter scene selection, index.ts:89-95),
    and the page ships the loading popup + progress bar
    (fetchWithProgress, index.ts:55-84)."""
    import urllib.error
    import urllib.request

    from gaussian_splatting_web_tpu.io.ply import write_ply

    write_ply(make_random_cloud(21, seed=4), str(tmp_path / "alt.ply"))
    httpd, app, base, post, event = _start_viewer(scene_dir=str(tmp_path))
    try:
        with urllib.request.urlopen(base + "/?model=alt") as r:
            page = r.read().decode()
        assert "popup" in page and "barfill" in page
        with urllib.request.urlopen(base + "/info") as r:
            assert json.loads(r.read())["num_gaussians"] == 21
        # unknown model → 404, scene unchanged
        try:
            urllib.request.urlopen(base + "/?model=../etc/passwd")
            assert False, "expected 404"
        except urllib.error.HTTPError as e:
            assert e.code == 404
        with urllib.request.urlopen(base + "/info") as r:
            assert json.loads(r.read())["num_gaussians"] == 21
    finally:
        httpd.shutdown()


def test_cli_render_writes_rgba(tmp_path):
    from gaussian_splatting_web_tpu.cli import main
    from gaussian_splatting_web_tpu.io.ply import write_ply

    cloud = make_random_cloud(6, seed=0, sh_degree=1)
    ply = tmp_path / "scene.ply"
    write_ply(cloud, str(ply))
    outdir = tmp_path / "renders"
    main(["render", "--ply", str(ply), "--out", str(outdir),
          "--width", "48", "--height", "32",
          "--max-dup", "16", "--max-per-tile", "16", "--tile-chunk", "2"])
    png = next(outdir.glob("*.png")).read_bytes()
    assert png[25] == 6  # RGBA: the present pass shaped alpha rides along
