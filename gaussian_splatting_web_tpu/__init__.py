"""gaussian_splatting_web_tpu — a differentiable 3D Gaussian splatting
renderer and trainer in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capability surface of the
`Lontoone/gaussian-splatting-web` WebGPU viewer, extended with autodiff,
training, and multi-device (shard_map) execution. It runs on the CPU and
on NVIDIA GPUs.

Layer map (mirrors SURVEY.md §1 of the reference):

  io/        PLY parsing/writing + cameras.json        (ref: src/ply.ts, src/packing.ts)
  core/      GaussianCloud pytree, camera math         (ref: src/camera.ts)
  ops/       projection, SH, sort/binning, rasterize   (ref: src/shaders.ts,
             — jitted JAX + a Triton compositor kernel  src/simple_render.ts,
                                                        webgpu-radix-sort)
  ref/       NumPy CPU oracle renderer                 (ref: testBitonic CPU-ref pattern,
                                                        src/bitonic.ts:239-288)
  models/    trainable Gaussian model families
  parallel/  Mesh/shard_map tile+camera sharding       (new; reference is single-GPU)
  train/     losses, optimizer, train step             (new; reference is forward-only)
  viewer/    orbit camera state machine + web viewer   (ref: src/camera.ts, index.html)
  utils/     math, metrics, image IO                   (ref: src/mylib.ts)
"""

__version__ = "0.1.0"

from .config import RenderConfig
from .core.types import GaussianCloud, CameraParams

__all__ = ["RenderConfig", "GaussianCloud", "CameraParams", "__version__"]
