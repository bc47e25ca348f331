"""Runtime plumbing: the compile-cache rule, device selection of the
driver entry point, one-collective reductions for sharded steps, and the
stdlib PNG codec."""

import os
import struct
import subprocess
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gaussian_splatting_web_tpu.utils.image import (
    decode_png, encode_png, read_image, write_png,
)
from gaussian_splatting_web_tpu.utils.metrics import compile_cache_dir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_compile_cache_dir_default_is_repo_local(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache_dir() == os.path.join(REPO, ".jax_cache")


def test_compile_cache_dir_follows_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache_dir() == str(tmp_path)


def test_compile_cache_written_only_where_environment_says(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, a compile lands there and the
    repo-local default directory is not created."""
    cache = tmp_path / "cache"
    home = tmp_path / "home"
    home.mkdir()
    code = (
        "import jax, jax.numpy as jnp\n"
        "from gaussian_splatting_web_tpu.utils.metrics import "
        "enable_compile_cache\n"
        "print(enable_compile_cache())\n"
        "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)\n"
        "jax.jit(lambda x: jnp.sin(x) * 3)(jnp.ones(8)).block_until_ready()\n"
    )
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(cache),
               JAX_PLATFORMS="cpu", HOME=str(home), PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(cache)
    assert cache.is_dir() and os.listdir(cache)
    assert os.listdir(home) == []


def test_graft_entry_devices_come_from_the_default_backend():
    import __graft_entry__ as entry

    devs = entry._get_devices(2)
    assert [d.platform for d in devs] == [jax.default_backend()] * 2
    with pytest.raises(RuntimeError, match="need"):
        entry._get_devices(len(jax.devices()) + 1)


def test_flat_psum_is_one_all_reduce_with_per_leaf_sums():
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from gaussian_splatting_web_tpu.parallel.mesh import (
        AXES, flat_psum, make_mesh,
    )

    mesh = make_mesh(data=2, tile=4)
    x = jnp.arange(8 * 3, dtype=jnp.float32).reshape(8, 3)
    k = jnp.arange(8, dtype=jnp.int32)

    def body(x, k):
        tree = {"x": x[0], "k": k[0], "s": jnp.sum(x)}
        return flat_psum(tree, (AXES.data, AXES.tile))

    f = shard_map(body, mesh=mesh, in_specs=(P(("data", "tile")),) * 2,
                  out_specs=P(), check_vma=False)
    out = jax.jit(f)(x, k)
    np.testing.assert_allclose(out["x"], np.asarray(x).sum(0))
    assert out["k"].dtype == jnp.int32 and int(out["k"]) == 28
    np.testing.assert_allclose(out["s"], float(np.asarray(x).sum()))
    hlo = jax.jit(f).lower(x, k).as_text()
    assert hlo.count("all_reduce") + hlo.count("all-reduce") == 1


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_roundtrip(tmp_path, channels):
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, size=(13, 17, channels), dtype=np.uint8)
    np.testing.assert_array_equal(decode_png(encode_png(img)), img)
    p = str(tmp_path / "x.png")
    write_png(img, p)
    want = img if channels >= 3 else np.repeat(img, 3, axis=-1)
    np.testing.assert_allclose(read_image(p), want[..., :3] / 255.0)


def _filtered_png(img: np.ndarray, kind: int) -> bytes:
    """PNG bytes of uint8 [H, W, C] with every row under filter `kind`
    (the forward filters of the PNG spec, §9)."""
    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int64)
    out = []
    for y in range(h):
        x = rows[y]
        up = rows[y - 1] if y else np.zeros_like(x)
        left = np.concatenate([np.zeros(c, np.int64), x[:-c]])
        ul = np.concatenate([np.zeros(c, np.int64), up[:-c]])
        if kind == 0:
            f = x
        elif kind == 1:
            f = x - left
        elif kind == 2:
            f = x - up
        elif kind == 3:
            f = x - (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
            f = x - pred
        out.append(bytes([kind]) + (f % 256).astype(np.uint8).tobytes())

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
def test_png_decode_each_filter(kind):
    rng = np.random.default_rng(kind)
    img = rng.integers(0, 256, size=(9, 11, 3), dtype=np.uint8)
    np.testing.assert_array_equal(decode_png(_filtered_png(img, kind)), img)


def test_png_decode_refuses_unsupported():
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"GIF89a")
    bad = bytearray(_filtered_png(np.zeros((2, 2, 3), np.uint8), 0))
    bad[24] = 16                                  # bit depth 16
    with pytest.raises(ValueError, match="bit depth"):
        decode_png(bytes(bad))


def test_bench_refuses_a_cpu_backend():
    """The benchmark reports device metrics only from a GPU: on the CPU it
    raises before timing anything, and names the device it found."""
    from gaussian_splatting_web_tpu import bench_lib

    assert bench_lib.device_record() == {
        "platform": "cpu", "kind": jax.devices()[0].device_kind,
        "count": len(jax.devices())}
    with pytest.raises(RuntimeError, match="GPU"):
        bench_lib.run(n_synthetic=16, width=32, height=32, emit_json=False)
