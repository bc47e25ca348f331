"""Timing + throughput metrics.

The reference's only instrumentation is a DOM FPS label updated per frame
(renderer.ts:70-72, 332-338). Here: a block_until_ready timing harness and
structured per-frame stats (Mpix/s, splats sorted/s, tiles touched), per
SURVEY.md §5 observability plan.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict

import jax


@dataclasses.dataclass
class FrameStats:
    frame_ms: float
    mpix_per_s: float
    num_gaussians: int
    num_pairs: int = 0
    overflow: int = 0

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


class Timer:
    """Wall-clock timer that blocks on JAX async dispatch."""

    def __init__(self):
        self.t0 = None
        self.elapsed = 0.0

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0
        return False


def compile_cache_dir() -> str:
    """Where the persistent XLA compilation cache lives:
    $JAX_COMPILATION_CACHE_DIR when set, else `<repo>/.jax_cache` — a
    fixed path, because the path is part of every cache key."""
    import os

    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Enable the persistent XLA compilation cache at compile_cache_dir()
    (so later CLI/bench invocations start hot) and return the path."""
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return path


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 2) -> float:
    """Median host-clock seconds per call of `fn(*args)`, each call ended
    by `jax.block_until_ready` on its result, after `warmup` calls (which
    absorb compilation)."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def throughput_mpixps(width: int, height: int, seconds: float) -> float:
    return width * height / seconds / 1e6
