"""Write the small test scenes and cameras in this directory.

    python -m tests.data.make_fixtures

simple.ply (62 splats), m3splat.ply (3) and pc_short.ply (100) are seeded
random SH-degree-3 clouds written with io.ply.write_ply, the sizes of the
reference viewer's sample scenes of the same names. cam.json is a 365-view
INRIA cameras.json orbit (camera-to-world rotation rows, camera centre,
focal lengths in pixels) at 1959×1090.
"""

import json
import os

import numpy as np

from gaussian_splatting_web_tpu.core.types import GaussianCloud
from gaussian_splatting_web_tpu.io.ply import write_ply

HERE = os.path.dirname(os.path.abspath(__file__))
SCENES = {"simple.ply": (62, 0), "m3splat.ply": (3, 1), "pc_short.ply": (100, 2)}


def random_cloud(n: int, seed: int) -> GaussianCloud:
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return GaussianCloud(
        xyz=rng.normal(size=(n, 3)).astype(np.float32),
        log_scale=rng.uniform(-3.5, -1.5, size=(n, 3)).astype(np.float32),
        quat=q,
        opacity_logit=rng.uniform(-2.0, 2.0, size=(n,)).astype(np.float32),
        sh=rng.normal(scale=0.3, size=(n, 16, 3)).astype(np.float32),
    )


def orbit_cameras(n: int = 365, width: int = 1959, height: int = 1090):
    cams = []
    for i in range(n):
        a = 2.0 * np.pi * i / n
        pos = np.array([4.0 * np.sin(a), -1.0, -4.0 * np.cos(a)])
        fwd = -pos / np.linalg.norm(pos)                 # +z looks at origin
        right = np.cross(fwd, [0.0, -1.0, 0.0])
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)                      # +y down (COLMAP)
        c2w = np.stack([right, down, fwd], axis=1)
        cams.append({
            "id": i, "img_name": f"{i:05d}", "width": width,
            "height": height,
            "position": [round(float(v), 4) for v in pos],
            "rotation": [[round(float(v), 4) for v in row] for row in c2w],
            "fx": 1159.5, "fy": 1164.7,
        })
    return cams


def main():
    for name, (n, seed) in SCENES.items():
        write_ply(random_cloud(n, seed), os.path.join(HERE, name))
    with open(os.path.join(HERE, "cam.json"), "w") as f:
        json.dump(orbit_cameras(), f, separators=(",", ":"))


if __name__ == "__main__":
    main()
