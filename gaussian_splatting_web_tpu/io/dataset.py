"""Training dataset: posed images + cameras.

Loads an INRIA-style capture: a cameras.json (io.cameras) next to an images
directory whose filenames match the `img_name` entries. Images are resized
to the training resolution on the host and served as [H, W, 3] float32
targets.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core.types import CameraParams
from ..utils.image import read_image
from .cameras import load_cameras_json


@dataclasses.dataclass
class View:
    camera: CameraParams
    image: np.ndarray  # [H, W, 3] float32 in [0, 1]
    name: str


def _load_image(path: str, size: Tuple[int, int]) -> np.ndarray:
    """[H, W, 3] float32 target at `size` = (width, height). PNGs at that
    size need nothing beyond the standard library; other formats and
    resizing need PIL."""
    if path.lower().endswith(".png"):
        img = read_image(path)
        if img.shape[1::-1] == tuple(size):
            return img
    from PIL import Image

    img = Image.open(path).convert("RGB")
    if img.size != size:
        img = img.resize(size, Image.LANCZOS)
    return np.asarray(img, dtype=np.float32) / 255.0


def load_dataset(
    cameras_json: str,
    images_dir: str,
    width: int,
    height: int,
    limit: Optional[int] = None,
    extensions: Sequence[str] = (".png", ".jpg", ".jpeg", ".JPG", ".PNG"),
) -> List[View]:
    """Load all (camera, image) pairs whose image file exists."""
    views: List[View] = []
    for camera, _, name in load_cameras_json(cameras_json,
                                             target_size=(width, height)):
        stem = os.path.splitext(str(name))[0]
        path = None
        for ext in extensions:
            cand = os.path.join(images_dir, stem + ext)
            if os.path.exists(cand):
                path = cand
                break
        if path is None:
            continue
        views.append(View(camera=camera,
                          image=_load_image(path, (width, height)),
                          name=str(name)))
        if limit and len(views) >= limit:
            break
    if not views:
        raise FileNotFoundError(
            f"no images from {cameras_json} found under {images_dir}"
        )
    return views


def scene_extent(views: Sequence[View]) -> float:
    """INRIA 'cameras extent': radius of the camera-center bounding sphere."""
    centers = np.stack([np.asarray(v.camera.cam_pos) for v in views])
    center = centers.mean(axis=0)
    return float(np.linalg.norm(centers - center, axis=1).max()) * 1.1 or 1.0


def epoch_indices(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).permutation(n)
