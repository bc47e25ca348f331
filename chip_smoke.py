"""Smoke test of the main paths on an NVIDIA GPU, at full width.

    python chip_smoke.py               # one card
    python chip_smoke.py --four-cards  # the multi-card paths on 4 cards

One card, in one process: the 1M-splat, SH-degree-3 bench scene
(`bench_lib.make_scene(1_000_000, seed=0)`) at 1920×1080 with the shipped
RenderConfig —

  1. kernel: the Triton compositor against the XLA compositor on the same
     bins (image, and gradients through the kernel's custom VJP), with
     compile times, memory_analysis and a short timing of both;
  2. oracle: the default render path against the NumPy oracle
     (ref/cpu_reference.py) at 20k splats and 320×240, exact mode;
  3. render: `cli render` of 3 orbit cameras from a PLY written by
     io.ply.write_ply;
  4. viewer: `viewer.server.serve(block=False)` on a local port, driven
     with POST /event (init, rotate, zoom, tick);
  5. train: `train.train_loop.train` on 4 views rendered from the scene,
     from a second seeded 1M cloud, across a densify round, an opacity
     reset and a checkpoint save, then resumed from that checkpoint.

With --four-cards it runs only the multi-card paths, each against its
one-device result: the DP×tile train step, the gaussian-sharded train step
(ring and banded), and `cli render --gaussian-sharded`.

Every phase prints one JSON object per line; the last line is
{"ok": true, "device": {"platform", "kind", "count"}}. A failed phase or
comparison raises, exits non-zero and prints no last line. The script
exits with code 2 when JAX's default device is not a GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

W, H = 1920, 1080
N_SPLATS = 1_000_000


class ComparisonFailed(AssertionError):
    pass


def emit(**record) -> None:
    print(json.dumps(record), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def check(name: str, error: float, tolerance: float, **info) -> None:
    ok = bool(error <= tolerance)
    emit(phase="compare", name=name, error=float(error),
         tolerance=float(tolerance), ok=ok, **info)
    if not ok:
        raise ComparisonFailed(f"{name}: {error} > {tolerance}")


def image_bad_frac(img, ref, atol=2e-4) -> tuple:
    """(fraction of pixels off by more than atol in any channel, max
    difference): the rule of tests/conftest.assert_images_close."""
    diff = np.abs(np.asarray(img, np.float64)
                  - np.asarray(ref, np.float64)).max(axis=-1)
    return float((diff > atol).mean()), float(diff.max())


def grad_p99(g, g_ref) -> tuple:
    """Scale-relative gradient error over the float leaves: |g - g_ref|
    over max|g_ref| of each leaf → (p99, max)."""
    import jax

    rels = []
    for a, b in zip(jax.tree_util.tree_leaves(g),
                    jax.tree_util.tree_leaves(g_ref)):
        if a.dtype == jax.dtypes.float0 or not np.issubdtype(a.dtype,
                                                             np.floating):
            continue
        a = np.asarray(a, np.float64).ravel()
        b = np.asarray(b, np.float64).ravel()
        if b.size:
            rels.append(np.abs(a - b) / (np.abs(b).max() + 1e-30))
    rel = np.concatenate(rels)
    return float(np.percentile(rel, 99)), float(rel.max())


def aot(name: str, fn, *args):
    """Compile `fn(*args)` ahead of time, reporting the seconds it took."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    emit(phase="compile", program=name, seconds=time.perf_counter() - t0)
    return compiled


def memory(name: str, compiled) -> None:
    m = compiled.memory_analysis()
    emit(phase="memory_analysis", program=name,
         argument_bytes=m.argument_size_in_bytes,
         output_bytes=m.output_size_in_bytes,
         temp_bytes=m.temp_size_in_bytes,
         generated_code_bytes=m.generated_code_size_in_bytes)


def orbit_cameras_json(path: str, n: int, radius: float, width: int,
                       height: int) -> None:
    """An INRIA cameras.json of `n` views on a circle around the origin
    (camera-to-world rotation rows, centre, focal lengths for a 60°
    vertical field of view)."""
    f = height / (2.0 * np.tan(np.radians(30.0)))
    cams = []
    for i in range(n):
        a = 2.0 * np.pi * i / n
        pos = np.array([radius * np.sin(a), -0.15 * radius,
                        -radius * np.cos(a)])
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross(fwd, [0.0, -1.0, 0.0])
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        cams.append({"id": i, "img_name": f"view{i:02d}", "width": width,
                     "height": height, "position": pos.tolist(),
                     "rotation": np.stack([right, down, fwd], 1).tolist(),
                     "fx": f, "fy": f})
    with open(path, "w") as fh:
        json.dump(cams, fh)


# --------------------------------------------------------------------- one card

def phase_kernel(card: str, n: int = N_SPLATS) -> None:
    import jax
    import jax.numpy as jnp

    from gaussian_splatting_web_tpu import bench_lib
    from gaussian_splatting_web_tpu.config import RenderConfig
    from gaussian_splatting_web_tpu.core import camera as cam
    from gaussian_splatting_web_tpu.ops.projection import project_gaussians
    from gaussian_splatting_web_tpu.ops.rasterize import (
        rasterize_tiles, render_impl,
    )
    from gaussian_splatting_web_tpu.ops.sort import bin_splats
    from gaussian_splatting_web_tpu.utils.metrics import time_fn

    cfg = RenderConfig()
    xla = cfg.replace(use_pallas="never")
    cloud = jax.device_put(bench_lib.make_scene(n, seed=0))
    camera = jax.device_put(cam.default_camera(
        W, H, eye=np.array([0.0, 0.0, -8.0]), center=np.zeros(3)))

    def project_bin(c):
        s = project_gaussians(c, camera, W, H, cfg)
        return s, bin_splats(s, W, H, cfg)

    splats, bins = aot("project+bin", project_bin, cloud)(cloud)
    emit(phase="kernel", scene=f"make_scene({n}, seed=0)",
         width=W, height=H, live_pairs=int(bins.num_pairs),
         overflow=int(bins.overflow),
         max_tile_count=int(jnp.max(bins.tile_count)))

    # same bins into both compositors: image, then gradients through the
    # kernel's custom VJP against jax.grad of the XLA compositor
    def composite(c):
        return lambda s, b: rasterize_tiles(s, b, W, H, c)

    k_img = aot("composite kernel", composite(cfg), splats, bins)
    x_img = aot("composite xla", composite(xla), splats, bins)
    (rgb_k, a_k), (rgb_x, a_x) = k_img(splats, bins), x_img(splats, bins)
    img_k = np.concatenate([np.asarray(rgb_k), np.asarray(a_k)[..., None]],
                           -1)
    img_x = np.concatenate([np.asarray(rgb_x), np.asarray(a_x)[..., None]],
                           -1)
    bad, mx = image_bad_frac(img_k, img_x)
    check("kernel vs xla image, 1M splats 1920x1080", bad, 2e-4,
          metric="fraction of pixels with |diff| > 2e-4", max_diff=mx,
          precision="f32 compositing; matmuls precision=HIGHEST")

    ww = jnp.linspace(0.5, 1.5, W)[None, :, None]

    def loss(c):
        def f(s, b):
            rgb, a = rasterize_tiles(s, b, W, H, c)
            return jnp.sum(rgb * ww) + jnp.sum(a)
        return jax.grad(f, allow_int=True)

    g_k = aot("grad kernel", loss(cfg), splats, bins)(splats, bins)
    g_x = aot("grad xla", loss(xla), splats, bins)(splats, bins)
    p99, gmax = grad_p99(g_k, g_x)
    check("kernel vs xla gradients (custom VJP), 1M splats 1920x1080",
          p99, 1e-4, metric="p99 of scale-relative |diff|", max=gmax,
          precision="f32")

    # end to end, render and render+backward, kernel against XLA
    times = {}
    for label, c in (("kernel", cfg), ("xla", xla)):
        fwd = aot(f"render {label}",
                  lambda cl, c=c: render_impl(cl, camera, W, H, c)[0], cloud)
        if label == "kernel":
            memory("render (kernel)", fwd)
        times[f"forward_{label}_ms"] = time_fn(fwd, cloud, iters=10) * 1e3
        bwd = aot(f"render+grad {label}", jax.grad(
            lambda cl, c=c: jnp.sum(render_impl(cl, camera, W, H, c)[0])),
            cloud)
        times[f"fwd_bwd_{label}_ms"] = time_fn(bwd, cloud, iters=5) * 1e3
    emit(phase="timing", card=card, scene="1M splats, 1920x1080",
         method="host clock, block_until_ready, median after warm-up",
         **times)


def phase_oracle() -> None:
    import jax

    from gaussian_splatting_web_tpu import bench_lib
    from gaussian_splatting_web_tpu.config import RenderConfig
    from gaussian_splatting_web_tpu.core import camera as cam
    from gaussian_splatting_web_tpu.ops.rasterize import render
    from gaussian_splatting_web_tpu.ref.cpu_reference import render_reference

    w, h = 320, 240
    cfg = RenderConfig(depth_bits=0, gather_cap_factor=0.0)
    # splats at least 4 units in front of the camera, so that none outgrows
    # max_dup tiles (the binning would shrink it; the oracle does not)
    cloud = bench_lib.make_scene(21_000, seed=1, log_scale_range=(-4.5, -3.0))
    keep = np.flatnonzero(cloud.xyz[:, 2] > -6.0)[:20_000]
    cloud = dataclasses.replace(cloud, **{
        f: getattr(cloud, f)[keep]
        for f in ("xyz", "log_scale", "quat", "opacity_logit", "sh")})
    camera = cam.default_camera(w, h, eye=np.array([0.0, 0.0, -10.0]),
                                center=np.zeros(3))
    img, aux = render(jax.device_put(cloud), camera, w, h, cfg)
    if int(aux["overflow"]):
        raise ComparisonFailed("oracle scene overflowed the binning caps")
    ref = render_reference(cloud, camera, w, h, cfg)
    bad, mx = image_bad_frac(img, ref)
    # the rule of tests/conftest.assert_images_close: isolated pixels at a
    # transmittance-threshold tie may round the 1e-4 test the other way
    check("render (kernel path) vs NumPy oracle, 20k splats 320x240", bad,
          2e-4, metric="fraction of pixels with |diff| > 2e-4", max_diff=mx,
          splats=len(keep), precision="f32 device vs f64/f32 oracle")


def phase_render(tmp: str, ply: str, cams: str) -> None:
    from gaussian_splatting_web_tpu.cli import main as cli_main
    from gaussian_splatting_web_tpu.utils.image import decode_png

    out = os.path.join(tmp, "renders")
    t0 = time.perf_counter()
    cli_main(["render", "--ply", ply, "--cameras", cams, "--out", out,
              "--width", str(W), "--height", str(H)])
    files = sorted(os.listdir(out))
    shapes = []
    for f in files:
        with open(os.path.join(out, f), "rb") as fh:
            arr = decode_png(fh.read())
        if arr.shape != (H, W, 4) or arr[..., 3].max() == 0:
            raise ComparisonFailed(f"render {f}: shape {arr.shape}, "
                                   f"max alpha {arr[..., 3].max()}")
        shapes.append(list(arr.shape))
    if len(files) != 3:
        raise ComparisonFailed(f"cli render wrote {len(files)} PNGs, not 3")
    emit(phase="render", cli="render --cameras (3 views)", files=files,
         shapes=shapes, seconds_with_compile=time.perf_counter() - t0)


def phase_viewer(cloud) -> None:
    from gaussian_splatting_web_tpu.utils.image import decode_png
    from gaussian_splatting_web_tpu.viewer.server import serve

    httpd, _app = serve(cloud, host="127.0.0.1", port=0, width=W, height=H,
                        block=False)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    port = httpd.server_address[1]
    try:
        events = [{"kind": "init"}, {"kind": "rotate", "dx": 0.3, "dy": 0.1},
                  {"kind": "zoom", "d": -400}, {"kind": "tick"}]
        ms = []
        for ev in events:
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/event",
                data=json.dumps(ev).encode(), method="POST")
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=600) as resp:
                body, ctype = resp.read(), resp.headers["Content-Type"]
            ms.append((time.perf_counter() - t0) * 1e3)
            arr = decode_png(body)
            if ctype != "image/png" or arr.shape != (H, W, 4):
                raise ComparisonFailed(
                    f"viewer {ev['kind']}: {ctype} {arr.shape}")
        emit(phase="viewer", events=[e["kind"] for e in events],
             frame_shape=[H, W, 4],
             client_ms=ms, note="first event includes compile")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)


def phase_train(tmp: str, teacher, cams: str, card: str,
                n: int = N_SPLATS) -> None:
    import jax

    from gaussian_splatting_web_tpu import bench_lib
    from gaussian_splatting_web_tpu.config import RenderConfig
    from gaussian_splatting_web_tpu.core.types import stack_cameras
    from gaussian_splatting_web_tpu.io.cameras import load_cameras_json
    from gaussian_splatting_web_tpu.io.dataset import View, scene_extent
    from gaussian_splatting_web_tpu.models.gaussian_model import GaussianModel
    from gaussian_splatting_web_tpu.ops.rasterize import render
    from gaussian_splatting_web_tpu.train.checkpoint import (
        has_checkpoint, restore_loop_state,
    )
    from gaussian_splatting_web_tpu.train.densify import pad_to_capacity
    from gaussian_splatting_web_tpu.train.train_loop import (
        TrainLoopConfig, make_densify_train_step, train,
    )
    from gaussian_splatting_web_tpu.train.trainer import (
        TrainState, make_optimizer,
    )

    cfg = RenderConfig()
    views = []
    for camera, _, name in load_cameras_json(cams, target_size=(W, H)):
        img, _ = render(teacher, camera, W, H, cfg)
        views.append(View(camera=camera, image=np.asarray(img), name=name))
    model = GaussianModel.from_cloud(bench_lib.make_scene(n, seed=1))
    # blocks of 10 steps everywhere, SH band 0 throughout: one step program
    loop = TrainLoopConfig(
        iterations=40, densify_from=20, densify_until=40, densify_every=20,
        opacity_reset_every=30, sh_upgrade_every=1000, log_every=10,
        steps_per_call=10, capacity_factor=2.0)
    ckpt = os.path.join(tmp, "ckpt")

    # the step program train() builds, compiled ahead for its compile time
    # and memory analysis (train() then finds it in the compile cache)
    capacity = int(model.num_gaussians * loop.capacity_factor)
    params, dstate = pad_to_capacity(model, capacity)
    opt = make_optimizer(scene_extent=scene_extent(views))
    state = TrainState(params=params, opt_state=opt.init(params),
                       step=jax.numpy.zeros((), jax.numpy.int32))
    step = make_densify_train_step(opt, W, H, cfg, loop.lambda_dssim)
    vi = jax.numpy.zeros((loop.steps_per_call,), jax.numpy.int32)
    args = (state, dstate, stack_cameras([v.camera for v in views]),
            jax.numpy.stack([jax.numpy.asarray(v.image) for v in views]), vi)
    t0 = time.perf_counter()
    compiled = step.many.lower(*args, 0).compile()
    emit(phase="compile", program="train step x10 (lax.scan)",
         seconds=time.perf_counter() - t0)
    memory("train step x10 (lax.scan)", compiled)
    del state, params, dstate, args, compiled

    logs = []

    def on_log(it, loss, alive):
        logs.append((it, loss, alive, time.perf_counter()))

    state, dstate = train(model, views, W, H, cfg, loop, on_log=on_log,
                          checkpoint_dir=ckpt, checkpoint_every=20)
    its = [x[0] for x in logs]
    losses = [x[1] for x in logs]
    if its != [10, 20, 30, 40] or not np.all(np.isfinite(losses)):
        raise ComparisonFailed(f"train logs {logs}")
    if not has_checkpoint(ckpt):
        raise ComparisonFailed("no checkpoint written")
    # the loop state on disk is the state train() returned at iteration 40
    saved, saved_d, it = restore_loop_state(ckpt, state, dstate)
    same = all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(
        jax.tree_util.tree_leaves((saved, saved_d)),
        jax.tree_util.tree_leaves((state, dstate))))
    if it != 40 or not same:
        raise ComparisonFailed(f"checkpoint at {it}, equal={same}")
    step_ms = (logs[2][3] - logs[1][3]) / 10 * 1e3
    emit(phase="train", iterations=its, losses=losses,
         alive=[x[2] for x in logs], capacity=capacity,
         checkpoint_iteration=it, card=card,
         ms_per_iteration_21_30=step_ms,
         note="iterations 21-30: 10 steps in one dispatch + opacity reset")

    logs.clear()
    resumed = dataclasses.replace(loop, iterations=50)
    state2, _ = train(model, views, W, H, cfg, resumed, on_log=on_log,
                      checkpoint_dir=ckpt, checkpoint_every=20)
    if [x[0] for x in logs] != [50] or int(state2.step) != 50 \
            or not np.isfinite(logs[0][1]):
        raise ComparisonFailed(f"resume: logs {logs}, step {state2.step}")
    emit(phase="train_resume", resumed_from=40, iterations=[50],
         loss=logs[0][1], step=int(state2.step))


def one_card(card: str, n: int = N_SPLATS) -> None:
    import jax

    from gaussian_splatting_web_tpu import bench_lib
    from gaussian_splatting_web_tpu.io.ply import write_ply

    phase_kernel(card, n)
    phase_oracle()
    with tempfile.TemporaryDirectory() as tmp:
        ply = os.path.join(tmp, "scene.ply")
        cams = os.path.join(tmp, "cameras.json")
        teacher = bench_lib.make_scene(n, seed=0)
        write_ply(teacher, ply)
        orbit_cameras_json(cams, 3, 8.0, W, H)
        phase_render(tmp, ply, cams)
        teacher = jax.device_put(teacher)
        phase_viewer(teacher)
        train_cams = os.path.join(tmp, "train_cameras.json")
        orbit_cameras_json(train_cams, 4, 8.0, W, H)
        phase_train(tmp, teacher, train_cams, card, n)


# ------------------------------------------------------------------ four cards

def four_cards(n: int = 65_536, w: int = 960, h: int = 544) -> None:
    import jax
    import jax.numpy as jnp
    import optax

    from gaussian_splatting_web_tpu import bench_lib
    from gaussian_splatting_web_tpu.cli import main as cli_main
    from gaussian_splatting_web_tpu.config import RenderConfig
    from gaussian_splatting_web_tpu.core import camera as cam
    from gaussian_splatting_web_tpu.core.types import stack_cameras
    from gaussian_splatting_web_tpu.io.ply import write_ply
    from gaussian_splatting_web_tpu.models.gaussian_model import GaussianModel
    from gaussian_splatting_web_tpu.ops.rasterize import render_impl
    from gaussian_splatting_web_tpu.parallel.gaussian_sharded import (
        init_sharded_train_state, make_gaussian_sharded_train_step,
    )
    from gaussian_splatting_web_tpu.parallel.mesh import make_mesh
    from gaussian_splatting_web_tpu.parallel.train_sharded import (
        make_sharded_train_step,
    )
    from gaussian_splatting_web_tpu.train.loss import photometric_loss
    from gaussian_splatting_web_tpu.train.trainer import init_train_state
    from gaussian_splatting_web_tpu.utils.image import read_image

    devices = jax.devices()[:4]
    if len(devices) < 4:
        raise RuntimeError(f"--four-cards needs 4 GPUs, JAX sees "
                           f"{len(jax.devices())}")
    # single-tier exact binning: the banded ring reorders candidates, so
    # only overflow-free exact mode is order-independent
    cfg = RenderConfig(tier_split=0, depth_bits=0)
    scene = bench_lib.make_scene(n, seed=2, sh_degree=1,
                                 log_scale_range=(-4.5, -3.0))
    model = GaussianModel.from_cloud(scene)
    cams = [cam.default_camera(w, h, eye=np.array([0.0, y, -8.0]),
                               center=np.zeros(3)) for y in (0.0, 1.0)]
    targets = jnp.stack([
        render_impl(bench_lib.make_scene(n, seed=3, sh_degree=1), c, w, h,
                    cfg)[0] for c in cams])
    cameras = stack_cameras(cams)
    # SGD at a power-of-two rate: p0 - p1 is the gradient times the rate
    # up to one rounding, so one step compares the sharded gradients
    lr = 2.0 ** 20
    opt = optax.sgd(lr)

    def loss_fn(params):
        return sum(photometric_loss(render_impl(params.to_cloud(), c, w, h,
                                                cfg)[0], t, 0.2)
                   for c, t in zip(cams, targets)) / len(cams)

    loss_ref, g_ref = jax.jit(jax.value_and_grad(loss_fn))(model)

    def compare(name, loss, params):
        check(f"{name}: loss vs one device",
              abs(float(loss) - float(loss_ref)),
              1e-5 * max(1.0, abs(float(loss_ref))), metric="|diff|")
        g = jax.tree_util.tree_map(
            lambda p0, p1: (np.asarray(p0, np.float64)
                            - np.asarray(p1, np.float64)) / lr,
            model, params)
        p99, gmax = grad_p99(g, g_ref)
        check(f"{name}: gradients vs one device", p99, 1e-4,
              metric="p99 of scale-relative |diff|", max=gmax,
              precision="f32")

    mesh = make_mesh(devices, data=2, tile=2)
    step = make_sharded_train_step(opt, w, h, mesh, cfg, lambda_dssim=0.2)
    st, loss = step(init_train_state(model, opt), cameras, targets)
    compare("DP x tile train step (data=2, tile=2)", loss, st.params)

    for banded in (False, True):
        step_g = make_gaussian_sharded_train_step(
            opt, w, h, mesh, cfg, lambda_dssim=0.2, banded=banded,
            n_gaussians=n)
        st, loss, aux = step_g(init_sharded_train_state(model, opt, mesh),
                               cameras, targets)
        name = ("gaussian-sharded train step, "
                + ("banded" if banded else "ring") + " (data=2, tile=2)")
        if int(aux["overflow"]):
            raise ComparisonFailed(f"{name}: overflow {int(aux['overflow'])}")
        compare(name, loss, st.params)

    with tempfile.TemporaryDirectory() as tmp:
        ply = os.path.join(tmp, "scene.ply")
        write_ply(scene, ply)
        outs = {}
        for label, extra in (("one device", []),
                             ("gaussian-sharded", ["--gaussian-sharded"])):
            out = os.path.join(tmp, label.replace(" ", "_"))
            cli_main(["render", "--ply", ply, "--out", out, "--width",
                      str(w), "--height", str(h), "--depth-bits", "0"]
                     + extra)
            (png,) = os.listdir(out)
            outs[label] = read_image(os.path.join(out, png)) * 255.0
        err = float(np.abs(outs["one device"]
                           - outs["gaussian-sharded"]).max())
        check("cli render --gaussian-sharded (4 cards) vs one device", err,
              2.0, metric="max |diff| in 8-bit levels")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the multi-card paths, on 4 GPUs")
    args = p.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX's default device is "
              f"{dev.platform}", file=sys.stderr)
        return 2

    from gaussian_splatting_web_tpu.utils.metrics import enable_compile_cache

    enable_compile_cache()
    card = card_line()
    emit(phase="device", nvidia_smi=card, platform=dev.platform,
         kind=dev.device_kind, count=len(jax.devices()),
         jax_version=jax.__version__)
    if args.four_cards:
        four_cards()
        count = 4
    else:
        one_card(card)
        count = len(jax.devices())
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
