"""Command-line interface.

Covers the reference's app-shell surface (src/index.ts: load PLY by URL
param, load cameras.json, render loop, fps readout) as batch commands:

  python -m gaussian_splatting_web_tpu.cli render  --ply scene.ply [--cameras cam.json] --out out/
  python -m gaussian_splatting_web_tpu.cli bench   --ply scene.ply --width 1920 --height 1080
  python -m gaussian_splatting_web_tpu.cli info    --ply scene.ply
  python -m gaussian_splatting_web_tpu.cli serve   --ply scene.ply --port 8090
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _load(args):
    import jax

    from .io.ply import read_ply

    t0 = time.time()
    last = [0.0]

    def progress(got, total):
        if time.time() - last[0] > 0.5:
            last[0] = time.time()
            print(f"\rloading {got/1e6:.0f}/{total/1e6:.0f} MB", end="", file=sys.stderr)

    cloud = read_ply(args.ply, progress=progress)
    print(f"\rloaded {cloud.num_gaussians} gaussians "
          f"(SH degree {cloud.sh_degree}) in {time.time()-t0:.2f}s",
          file=sys.stderr)
    cloud = jax.device_put(cloud)
    dtype = getattr(args, "dtype", None)
    if dtype:
        cloud = cloud.with_storage_dtype(dtype)
    return cloud


def _config(args):
    from .config import RenderConfig

    kw = {}
    for f in ("tile_size", "max_dup", "max_per_tile", "tile_chunk",
              "depth_bits", "dtype"):
        v = getattr(args, f, None)
        if v is not None:
            kw[f] = v
    return RenderConfig(**kw)


def cmd_info(args):
    from .io.ply import read_ply

    cloud = read_ply(args.ply)
    lo, hi = cloud.bbox()
    print(json.dumps({
        "num_gaussians": cloud.num_gaussians,
        "sh_degree": cloud.sh_degree,
        "bbox_min": [float(x) for x in lo],
        "bbox_max": [float(x) for x in hi],
    }, indent=2))


def cmd_render(args):
    import numpy as np

    from .core import camera as cam
    from .io.cameras import load_cameras_json
    from .ops.composite import post_process
    from .ops.rasterize import render
    from .utils.image import write_png

    cloud = _load(args)
    config = _config(args)
    w, h = args.width, args.height

    sharded_mode = getattr(args, "gaussian_sharded", None)
    if sharded_mode:
        # gaussian-sharded rendering over all local devices: params shard
        # N/S, a ppermute ring walks projected splats around tile owners
        # ('banded' adds per-hop band compaction → O(N·d/S) binning)
        import dataclasses as _dc

        import jax

        from .parallel.gaussian_sharded import (
            render_gaussian_sharded, render_gaussian_sharded_banded,
        )
        from .parallel.mesh import make_mesh

        devices = jax.devices()
        if len(devices) < 2:
            print("--gaussian-sharded: only one device visible; "
                  "rendering on a 1-device mesh (no sharding win)",
                  file=sys.stderr)
        s = len(devices)
        mesh = make_mesh(devices, tile=s)
        n = cloud.num_gaussians
        if n % s:
            # pad to a multiple of the shard count with dead gaussians
            # (opacity_logit -100 → sigmoid ≈ 0, never rasterizes)
            pad = s - n % s

            def _pad(name):
                a = np.asarray(getattr(cloud, name))
                fill = -100.0 if name == "opacity_logit" else 0.0
                tail = np.full((pad,) + a.shape[1:], fill, a.dtype)
                return np.concatenate([a, tail])

            cloud = _dc.replace(
                cloud, **{f.name: _pad(f.name) for f in _dc.fields(cloud)})

        def render_fn(cloud, camera, w, h, config):
            if sharded_mode == "banded":
                rgb, alpha, _ = render_gaussian_sharded_banded(
                    cloud, camera, w, h, mesh, config)
            else:
                rgb, alpha = render_gaussian_sharded(
                    cloud, camera, w, h, mesh, config)
            import jax.numpy as jnp

            bg = jnp.asarray(config.background, dtype=rgb.dtype)
            img = rgb + (1.0 - alpha[..., None]) * bg
            zero = jnp.zeros((), jnp.int32)
            return img, {"alpha": alpha, "num_pairs": zero,
                         "overflow": zero}

        render_ = render_fn
    else:
        render_ = render

    if args.cameras:
        cams = load_cameras_json(args.cameras, target_size=(w, h))
        if args.limit:
            cams = cams[: args.limit]
    else:
        lo, hi = cloud.bbox()
        center = (np.asarray(lo) + np.asarray(hi)) / 2
        camera = cam.default_camera(w, h, eye=center + np.array([0, 0, -5.0]),
                                    center=center)
        cams = [(camera, (w, h), "default")]

    os.makedirs(args.out, exist_ok=True)
    total_t = 0.0
    for i, (camera, _, name) in enumerate(cams):
        t0 = time.time()
        img, aux = render_(cloud, camera, w, h, config)
        if getattr(args, "post", True):
            # the reference's present pass always shapes alpha
            # (post_process_render.ts:145-166); write RGBA so viewers
            # composite it like the premultiplied canvas did
            rgba = np.asarray(post_process(img, aux["alpha"], config))
            a = np.maximum(rgba[..., 3:4], 1.0 / 255.0)
            img = np.concatenate(
                [np.clip(rgba[..., :3] / a, 0.0, 1.0), rgba[..., 3:4]], -1
            )
        else:
            img.block_until_ready()
        dt = time.time() - t0
        total_t += dt
        out = os.path.join(args.out, f"{i:04d}_{os.path.basename(str(name))}.png")
        write_png(np.asarray(img), out)
        print(f"{out}  {dt*1e3:.1f} ms  "
              f"({w*h/dt/1e6:.1f} Mpix/s, pairs={int(aux['num_pairs'])})",
              file=sys.stderr)
    print(f"rendered {len(cams)} views, avg "
          f"{total_t/len(cams)*1e3:.1f} ms/view", file=sys.stderr)


def cmd_bench(args):
    from . import bench_lib

    bench_lib.run(ply=args.ply, width=args.width, height=args.height)


def cmd_train(args):
    # multi-host entry: initialize jax.distributed BEFORE any backend touch
    # (no-op when no coordinator is configured — the single-process case)
    if getattr(args, "multihost", False):
        from .parallel.multihost import initialize_multihost

        initialize_multihost()

    import jax

    from .io.dataset import load_dataset
    from .models.gaussian_model import GaussianModel
    from .train.checkpoint import save_ply, save_train_state
    from .train.densify import compact
    from .train.train_loop import TrainLoopConfig, train

    views = load_dataset(args.cameras, args.images, args.width, args.height,
                         limit=args.limit or None)
    print(f"{len(views)} training views at {args.width}x{args.height}",
          file=sys.stderr)

    if args.ply:
        model = GaussianModel.from_cloud(_load(args))
    else:
        # bootstrap from random points inside the camera hull
        import numpy as np

        centers = np.stack([np.asarray(v.camera.cam_pos) for v in views])
        lo, hi = centers.min(0) - 1, centers.max(0) + 1
        rng = np.random.default_rng(0)
        xyz = rng.uniform(lo, hi, size=(20_000, 3)).astype(np.float32)
        model = GaussianModel.from_points(xyz, sh_degree=3)

    if getattr(args, "fresh", False) and args.checkpoint:
        # discard an existing loop state so the run starts from scratch
        # (without --fresh, a re-run with the same dir resumes from it)
        import shutil

        from .train.checkpoint import has_checkpoint

        if has_checkpoint(args.checkpoint):
            shutil.rmtree(args.checkpoint)
            print(f"--fresh: removed existing loop state in "
                  f"{args.checkpoint}", file=sys.stderr)

    def run_once(ckpt_dir):
        return train(
            model, views, args.width, args.height,
            render_config=_config(args),
            loop=TrainLoopConfig(iterations=args.iterations),
            checkpoint_dir=ckpt_dir,
            checkpoint_every=getattr(args, "checkpoint_every", 0),
        )

    if getattr(args, "restarts", 0) > 0 and args.checkpoint:
        # checkpoint-restart driver: on failure, retry resuming from the
        # newest saved loop state (parallel.multihost recovery model)
        from .parallel.multihost import run_with_restarts

        state, dstate = run_with_restarts(
            run_once, checkpoint_dir=args.checkpoint,
            max_restarts=args.restarts)
    else:
        state, dstate = run_once(args.checkpoint)

    final = compact(state.params, dstate)
    save_ply(final, args.out)
    print(f"saved {final.num_gaussians} gaussians → {args.out}",
          file=sys.stderr)
    if args.checkpoint:
        save_train_state(state, args.checkpoint + "-final")


def cmd_eval(args):
    import jax.numpy as jnp
    import numpy as np

    from .io.dataset import load_dataset
    from .ops.rasterize import render
    from .train.loss import ssim

    cloud = _load(args)
    config = _config(args)
    views = load_dataset(args.cameras, args.images, args.width, args.height,
                         limit=args.limit or None)
    psnrs, ssims = [], []
    for v in views:
        img, _ = render(cloud, v.camera, args.width, args.height, config)
        img = np.clip(np.asarray(img), 0, 1)
        mse = float(np.mean((img - v.image) ** 2))
        psnrs.append(10 * np.log10(1.0 / max(mse, 1e-10)))
        ssims.append(float(ssim(jnp.asarray(img), jnp.asarray(v.image))))
        print(f"{v.name}: PSNR {psnrs[-1]:.2f} dB  SSIM {ssims[-1]:.4f}",
              file=sys.stderr)
    print(json.dumps({
        "views": len(views),
        "psnr_mean": float(np.mean(psnrs)),
        "ssim_mean": float(np.mean(ssims)),
    }))


def cmd_serve(args):
    from .viewer.server import serve

    cloud = _load(args)
    # ?model=<name> scene switching resolves .ply files next to the
    # launch scene (the reference's URL-parameter loading, index.ts:89-95)
    scene_dir = os.path.dirname(os.path.abspath(args.ply)) if args.ply \
        else None
    serve(cloud, host=args.host, port=args.port,
          width=args.width, height=args.height, config=_config(args),
          scene_dir=scene_dir)


def main(argv=None):
    p = argparse.ArgumentParser(prog="gaussian_splatting_web_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp, ply_required=True):
        sp.add_argument("--ply", required=ply_required)
        sp.add_argument("--width", type=int, default=1280)
        sp.add_argument("--height", type=int, default=720)
        sp.add_argument("--tile-size", dest="tile_size", type=int)
        sp.add_argument("--max-dup", dest="max_dup", type=int)
        sp.add_argument("--max-per-tile", dest="max_per_tile", type=int)
        sp.add_argument("--tile-chunk", dest="tile_chunk", type=int)
        sp.add_argument("--dtype", choices=("float32", "bfloat16"),
                        help="scene storage dtype (bfloat16 ~halves scene "
                             "memory; positions stay f32)")
        sp.add_argument("--depth-bits", dest="depth_bits", type=int,
                        help="packed sort depth bits (0 = exact sort)")

    sp = sub.add_parser("info", help="scene statistics")
    sp.add_argument("--ply", required=True)
    sp.set_defaults(fn=cmd_info)

    sp = sub.add_parser("render", help="offline render to PNGs")
    sp.add_argument("--no-post", dest="post", action="store_false",
                    help="skip the present-pass alpha shaping "
                         "(post_process_render.ts:63-76)")
    common(sp)
    sp.add_argument("--cameras", help="INRIA cameras.json")
    sp.add_argument("--out", default="renders")
    sp.add_argument("--limit", type=int, default=0)
    sp.add_argument("--gaussian-sharded", dest="gaussian_sharded",
                    nargs="?", const="ring", choices=("ring", "banded"),
                    help="shard the gaussians over all local devices and "
                    "render via the ppermute ring (parallel."
                    "gaussian_sharded); '=banded' adds ring-sharded "
                    "binning (per-hop band compaction, O(N·d/S) per "
                    "device). Needs >1 device (a multi-device host or a "
                    "virtual CPU mesh).")
    sp.set_defaults(fn=cmd_render)

    sp = sub.add_parser("bench", help="throughput benchmark")
    common(sp, ply_required=False)
    sp.set_defaults(fn=cmd_bench)

    sp = sub.add_parser("train", help="train a scene from posed images")
    common(sp, ply_required=False)
    sp.add_argument("--cameras", required=True, help="INRIA cameras.json")
    sp.add_argument("--images", required=True, help="directory of images")
    sp.add_argument("--out", default="trained.ply")
    sp.add_argument("--iterations", type=int, default=7000)
    sp.add_argument("--limit", type=int, default=0, help="max training views")
    sp.add_argument("--checkpoint", help="checkpoint dir: the LOOP "
                    "state (params+opt+iteration) is saved here every "
                    "--checkpoint-every iterations and resumed from when "
                    "present; the final TrainState is written to "
                    "'<dir>-final'")
    sp.add_argument("--checkpoint-every", type=int, default=500,
                    dest="checkpoint_every",
                    help="save the loop state every N iterations")
    sp.add_argument("--fresh", action="store_true",
                    help="ignore an existing loop state in --checkpoint "
                    "and start training from scratch (by default a "
                    "re-run with the same dir silently resumes)")
    sp.add_argument("--multihost", action="store_true",
                    help="initialize jax.distributed before training "
                    "(no-op without a coordinator — single-process safe)")
    sp.add_argument("--restarts", type=int, default=0,
                    help="checkpoint-restart retries on failure "
                    "(requires --checkpoint)")
    sp.set_defaults(fn=cmd_train)

    sp = sub.add_parser("eval", help="PSNR/SSIM against ground-truth images")
    common(sp)
    sp.add_argument("--cameras", required=True)
    sp.add_argument("--images", required=True)
    sp.add_argument("--limit", type=int, default=0)
    sp.set_defaults(fn=cmd_eval)

    sp = sub.add_parser("serve", help="interactive web viewer")
    common(sp)
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=8090)
    sp.set_defaults(fn=cmd_serve)

    args = p.parse_args(argv)
    from .utils.metrics import enable_compile_cache

    enable_compile_cache()
    args.fn(args)


if __name__ == "__main__":
    main()
