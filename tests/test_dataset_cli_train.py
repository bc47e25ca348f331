"""Dataset loader + CLI train end-to-end on a synthetic capture."""

import json
import math
import os

import numpy as np

from gaussian_splatting_web_tpu.config import RenderConfig
from gaussian_splatting_web_tpu.core import camera as cam
from gaussian_splatting_web_tpu.io.dataset import load_dataset
from gaussian_splatting_web_tpu.io.ply import read_ply, write_ply
from gaussian_splatting_web_tpu.ops.rasterize import render
from gaussian_splatting_web_tpu.utils.image import write_png
from tests.conftest import make_random_cloud

W = H = 32
CFG = RenderConfig(max_dup=16, max_per_tile=32, tile_chunk=2)


def _write_capture(tmp_path, n_views=2):
    """Render a tiny scene from orbit cameras; save INRIA-style capture."""
    cloud = make_random_cloud(16, seed=4, sh_degree=0)
    imgdir = tmp_path / "images"
    os.makedirs(imgdir, exist_ok=True)
    entries = []
    for i in range(n_views):
        angle = i * 0.7
        eye = np.array([3 * math.sin(angle), 0.3, -3 * math.cos(angle)])
        camera = cam.default_camera(W, H, eye=eye, center=(0, 0, 0))
        img, _ = render(cloud, camera, W, H, CFG)
        write_png(np.asarray(img), str(imgdir / f"view{i}.png"))
        # serialize in cameras.json convention: camera-to-world rotation
        # (row-major) + camera center; focals from the projection
        view = np.asarray(camera.view)
        R_w2c = view[:3, :3]
        fx = float(camera.focal[0])
        fy = float(camera.focal[1])
        entries.append({
            "id": i, "img_name": f"view{i}", "width": W, "height": H,
            "position": [float(x) for x in np.asarray(camera.cam_pos)],
            "rotation": [[float(R_w2c.T[r, c]) for c in range(3)]
                         for r in range(3)],
            "fx": fx, "fy": fy,
        })
    camfile = tmp_path / "cameras.json"
    camfile.write_text(json.dumps(entries))
    return cloud, str(camfile), str(imgdir)


def test_load_dataset_roundtrip(tmp_path):
    cloud, camfile, imgdir = _write_capture(tmp_path)
    views = load_dataset(camfile, imgdir, W, H)
    assert len(views) == 2
    assert views[0].image.shape == (H, W, 3)
    # the serialized camera must reproduce the original view transform:
    # re-render and compare to the stored image (PNG-quantized)
    img, _ = render(cloud, views[0].camera, W, H, CFG)
    diff = np.abs(np.asarray(img) - views[0].image)
    assert np.percentile(diff, 99) < 0.02, diff.max()


def test_cli_train_smoke(tmp_path, capsys):
    from gaussian_splatting_web_tpu.cli import main

    cloud, camfile, imgdir = _write_capture(tmp_path)
    ply = tmp_path / "init.ply"
    write_ply(make_random_cloud(16, seed=5, sh_degree=0), str(ply))
    out = tmp_path / "trained.ply"
    main([
        "train", "--ply", str(ply), "--cameras", camfile, "--images", imgdir,
        "--out", str(out), "--iterations", "12",
        "--width", str(W), "--height", str(H),
        "--max-dup", "16", "--max-per-tile", "32", "--tile-chunk", "2",
    ])
    assert out.exists()
    trained = read_ply(str(out))
    assert trained.num_gaussians >= 1


def test_cli_train_resume_from_checkpoint(tmp_path, capsys):
    """CLI --checkpoint + --checkpoint-every + --multihost (no-op without
    a coordinator): a second invocation resumes the saved loop state
    instead of restarting from scratch (VERDICT r2 item 8)."""
    from gaussian_splatting_web_tpu.cli import main

    cloud, camfile, imgdir = _write_capture(tmp_path)
    ply = tmp_path / "init.ply"
    write_ply(make_random_cloud(16, seed=5, sh_degree=0), str(ply))
    out = tmp_path / "trained.ply"
    ckpt = tmp_path / "ckpt"
    base = [
        "train", "--ply", str(ply), "--cameras", camfile, "--images", imgdir,
        "--out", str(out), "--width", str(W), "--height", str(H),
        "--max-dup", "16", "--max-per-tile", "32", "--tile-chunk", "2",
        "--checkpoint", str(ckpt), "--checkpoint-every", "4",
        "--multihost", "--restarts", "1",
    ]
    main(base + ["--iterations", "8"])
    assert ckpt.exists() and any(ckpt.iterdir())
    # resume: the loop must pick up at iteration 8 and only run 9..12
    main(base + ["--iterations", "12"])
    err = capsys.readouterr().err
    assert "resumed from" in err and "at iteration 8" in err
    assert out.exists()


def test_cli_eval(tmp_path, capsys):
    from gaussian_splatting_web_tpu.cli import main

    cloud, camfile, imgdir = _write_capture(tmp_path)
    ply = tmp_path / "scene.ply"
    write_ply(cloud, str(ply))
    main([
        "eval", "--ply", str(ply), "--cameras", camfile, "--images", imgdir,
        "--width", str(W), "--height", str(H),
        "--max-dup", "16", "--max-per-tile", "32", "--tile-chunk", "2",
    ])
    out = json.loads(capsys.readouterr().out)
    # rendering the same scene the capture came from → near-perfect PSNR
    assert out["views"] == 2
    assert out["psnr_mean"] > 35, out
    assert out["ssim_mean"] > 0.95, out


def test_cli_render_gaussian_sharded_banded(tmp_path, capsys):
    """`cli render --gaussian-sharded banded` (VERDICT r3 item 10): the
    banded ring-sharded render must be reachable from the shipped CLI and
    match the single-device render."""
    import jax

    from gaussian_splatting_web_tpu.cli import main

    if len(jax.devices()) < 2:
        import pytest

        pytest.skip("needs a multi-device mesh")

    # 17 splats: NOT divisible by the device count — exercises dead-pad
    cloud = make_random_cloud(17, seed=6, sh_degree=0)
    ply = tmp_path / "scene.ply"
    write_ply(cloud, str(ply))
    out = tmp_path / "renders"
    args = [
        "render", "--ply", str(ply), "--out", str(out),
        "--width", str(W), "--height", str(H), "--no-post",
        "--max-dup", "16", "--max-per-tile", "32", "--tile-chunk", "2",
        "--depth-bits", "0",
    ]
    main(args + ["--gaussian-sharded", "banded"])
    png = list(out.iterdir())
    assert len(png) == 1

    out2 = tmp_path / "renders_single"
    main(args[:4] + [str(out2)] + args[5:])
    from gaussian_splatting_web_tpu.utils.image import read_image

    a = read_image(str(png[0])) * 255.0
    b = read_image(str(list(out2.iterdir())[0])) * 255.0
    np.testing.assert_allclose(a, b, atol=2.0)
