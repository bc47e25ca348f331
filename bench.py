"""Benchmark driver. Prints ONE JSON line with the forward render throughput
at 1080p (Mpix/s), forward+backward and bin+sort rates, and the device
they were measured on (platform, device_kind, device count). Needs a GPU.
Detail goes to stderr.
"""

from gaussian_splatting_web_tpu import bench_lib

if __name__ == "__main__":
    bench_lib.run()
