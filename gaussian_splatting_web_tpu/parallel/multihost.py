"""Multi-host initialization + failure/recovery story (SURVEY.md §2.3
"Multi-host entry" and §5 "Failure detection / elastic recovery").

The reference is a single browser process (gpu_context.ts:12-26) with no
distribution; this is new capability. On a multi-host job each host
process calls `initialize_multihost()` before any backend touch, with the
coordinator given as arguments or as JAX_COORDINATOR_ADDRESS (plus
JAX_NUM_PROCESSES and JAX_PROCESS_ID); `jax.distributed` handles the
rendezvous. After init, `parallel.mesh.make_mesh()` sees all global
devices and `shard_map` programs span hosts.

Recovery model (checkpoint-restart, the standard JAX story): training
state persists via train.checkpoint (an .npz of the full loop state, PLY
for the reference-interchangeable model); `run_with_restarts` wraps a
training driver with bounded retries, reloading the newest checkpoint
after a failure — preemption-shaped faults resume at the last saved step.
There is no in-job elastic resize: JAX meshes are static, so host failure
= job restart.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Callable, Optional


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize jax.distributed for a multi-host run.

    Returns True if distributed init ran, False for single-process runs
    (no coordinator configured — the common single-host case, a no-op).
    Must be called before any jax backend use in the process.
    """
    import jax

    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if coordinator_address is None:
        return False
    kwargs = {"coordinator_address": coordinator_address}
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    elif os.environ.get("JAX_NUM_PROCESSES"):
        kwargs["num_processes"] = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is not None:
        kwargs["process_id"] = process_id
    elif os.environ.get("JAX_PROCESS_ID"):
        kwargs["process_id"] = int(os.environ["JAX_PROCESS_ID"])
    jax.distributed.initialize(**kwargs)
    print(
        f"jax.distributed: process {jax.process_index()}/"
        f"{jax.process_count()}, {jax.local_device_count()} local / "
        f"{jax.device_count()} global devices",
        file=sys.stderr,
    )
    return True


def run_with_restarts(
    train_fn: Callable[[Optional[str]], object],
    checkpoint_dir: Optional[str] = None,
    max_restarts: int = 3,
    backoff_s: float = 10.0,
):
    """Checkpoint-restart driver: call `train_fn(checkpoint_dir)` and, on
    failure, retry up to `max_restarts` times with linear backoff.

    `train_fn` is responsible for resuming from the newest checkpoint in
    `checkpoint_dir` when one exists (train.checkpoint.load_train_state)
    and for saving periodically. Transient pod failures (preemption,
    network flap during a collective) surface as exceptions from the
    jitted step; a restarted process re-initializes the backend cleanly.
    """
    attempt = 0
    while True:
        try:
            return train_fn(checkpoint_dir)
        except KeyboardInterrupt:
            raise
        except Exception as e:  # noqa: BLE001
            # Retry only failures that look transient (match
            # known-transient types explicitly rather than blacklisting
            # deterministic ones — a distributed-runtime failure that
            # happens to surface as ValueError should still be retried,
            # while a deterministic shape/config error should not).
            # Known-transient: the backend's XlaRuntimeError (collective
            # timeouts, preemption, RPC flaps), grpc errors, OSError
            # (checkpoint I/O), and generic RuntimeError from the
            # distributed service.
            transient_names = (
                "XlaRuntimeError", "RpcError", "InternalError",
                "UnavailableError", "DeadlineExceededError",
                "AbortedError",
            )
            is_transient = (
                isinstance(e, (RuntimeError, OSError, ConnectionError))
                or any(c.__name__ in transient_names
                       for c in type(e).__mro__)
            )
            if not is_transient:
                # Deterministic programming/config errors — e.g. a
                # checkpoint restored against a different model size —
                # fail identically on every attempt; surface immediately.
                raise
            attempt += 1
            if attempt > max_restarts:
                raise
            print(
                f"training attempt {attempt} failed ({type(e).__name__}: "
                f"{e}); restarting from checkpoint in {backoff_s:.0f}s",
                file=sys.stderr,
            )
            time.sleep(backoff_s * attempt)
