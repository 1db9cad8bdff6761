"""Worker process for the multi-process jax.distributed test.

Launched by tests/test_distributed.py with env vars:
  DW_COORD (host:port), DW_NPROC, DW_PID, DW_OUT (npz path).
Each process owns 2 virtual CPU devices; the 4-device global mesh runs a
ShardedVecEnv and the worker saves its local shard of rewards and masses.
"""

import os

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=2")
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402


def main():
    coord = os.environ["DW_COORD"]
    nproc = int(os.environ["DW_NPROC"])
    pid = int(os.environ["DW_PID"])
    out_path = os.environ["DW_OUT"]

    # must run before importing agarcl_tpu: its modules build jnp constants
    # at import time, which initializes the XLA backend. (parallel.
    # distributed.initialize is the same call; production entry points
    # initialize before touching the env modules.)
    jax.distributed.initialize(coordinator_address=coord,
                               num_processes=nproc, process_id=pid)

    from agarcl_tpu.parallel import distributed as D
    assert jax.process_count() == nproc, jax.process_count()
    assert jax.device_count() == 2 * nproc, jax.device_count()

    import numpy as np

    from agarcl_tpu.config import EnvConfig
    from agarcl_tpu.parallel.mesh import ShardedVecEnv, make_env_mesh

    cfg = EnvConfig(num_agents=1, ticks_per_step=2, arena_size=80,
                    num_pellets=20, num_viruses=2, num_bots=0, mode=4)
    mesh = make_env_mesh()
    env = ShardedVecEnv(cfg, 16, mesh, obs_type="ram")
    states = env.reset(3)
    acts = np.tile(np.asarray([[0.6, -0.4, 0.0]], np.float32), (16, 1, 1))
    for _ in range(3):
        states, obs, rewards, dones = env.step(states, acts)

    r_local = np.asarray(D.local_shard(rewards))
    m_local = np.asarray(D.local_shard(states.player_mass()))
    o_local = np.asarray(D.local_shard(obs))
    np.savez(out_path, rewards=r_local, mass=m_local, obs=o_local)
    print(f"worker {pid}: ok shard={r_local.shape}")


if __name__ == "__main__":
    main()
