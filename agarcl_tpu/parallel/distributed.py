"""Multi-host bring-up helpers.

The reference has no multi-process story (its server is a stub,
agario/server/main.cpp:1-9). Scale-out here is standard JAX SPMD: every
host calls `initialize()` (which wraps jax.distributed.initialize), builds
the same global mesh over jax.devices(), and runs the same ShardedVecEnv
program. The network between hosts carries only the JAX runtime's
coordination; per-step data stays on each host's devices (the env loop has
no collectives).
"""

from __future__ import annotations

import os
from typing import Optional

import jax


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """jax.distributed.initialize with env-var fallbacks
    (COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID); no-op when
    single-process."""
    coordinator_address = coordinator_address or os.environ.get(
        "COORDINATOR_ADDRESS")
    if coordinator_address is None:
        return  # single host
    num_processes = num_processes or int(os.environ.get("NUM_PROCESSES", 1))
    process_id = process_id if process_id is not None else int(
        os.environ.get("PROCESS_ID", 0))
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def global_env_count(envs_per_device: int) -> int:
    return envs_per_device * jax.device_count()


def local_shard(global_array):
    """The addressable (host-local) slice of a global env-axis array, as a
    host numpy array, in global env order.

    Shards live on different local devices, so they are concatenated on the
    host (a device-side jnp.concatenate of committed per-device arrays is an
    error)."""
    import numpy as np
    shards = sorted(global_array.addressable_shards,
                    key=lambda s: (s.index[0].start or 0))
    return np.concatenate([np.asarray(s.data) for s in shards], axis=0)
