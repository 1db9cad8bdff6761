"""Multi-chip / multi-host scaling: env batch sharded over a 1-D device mesh.

The reference has no distributed system at all (SURVEY §2 parallelism
inventory: server is a stub, client networking commented out). Scaling here is
plain SPMD: N lockstep envs shard along an 'envs' mesh axis and each device
simulates its slice independently. The step has no collective at all
(lockstep envs are embarrassingly parallel); only a reduction the caller asks
for, such as `mean_reward`, crosses devices.

Multi-host: construct the mesh over `jax.devices()` after
`jax.distributed.initialize()`; the same code runs unchanged — host-local
shards are addressable, the global batch is the concatenation.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from agarcl_tpu.config import EnvConfig
from agarcl_tpu.env import env_reset, env_step
from agarcl_tpu.vec import make_obs_fn


def make_env_mesh(devices=None) -> Mesh:
    """1-D mesh over all (or the given) devices, axis name 'envs'."""
    import numpy as np
    devices = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devices, axis_names=("envs",))


class ShardedVecEnv:
    """VecEnv with the env axis sharded over a device mesh.

    num_envs must divide evenly by mesh size. All states/obs/reward arrays are
    globally shaped with NamedSharding(mesh, P('envs')) on the leading axis;
    XLA keeps every per-step computation local to its shard.
    """

    def __init__(self, cfg: EnvConfig, num_envs: int, mesh: Mesh,
                 obs_type: str = "ram", obs_config=None):
        n_dev = mesh.devices.size
        assert num_envs % n_dev == 0, (num_envs, n_dev)
        self.cfg = cfg
        self.num_envs = num_envs
        self.mesh = mesh
        frame_fn, num_frames = make_obs_fn(cfg, obs_type, obs_config)
        self._frame_fn = frame_fn
        self.num_frames = num_frames

        env_sharding = NamedSharding(mesh, P("envs"))

        def _reset_batch(seeds):
            return jax.vmap(functools.partial(env_reset, cfg))(seeds)

        def _step_batch(states, actions):
            return jax.vmap(
                functools.partial(env_step, cfg, obs_fn=frame_fn,
                                  num_frames=num_frames))(states, actions)

        self._reset = jax.jit(_reset_batch,
                              in_shardings=(env_sharding,),
                              out_shardings=env_sharding)
        self._step = jax.jit(_step_batch,
                             in_shardings=(env_sharding, env_sharding),
                             out_shardings=env_sharding,
                             donate_argnums=(0,))
        self._env_sharding = env_sharding

    def reset(self, seed: int = 0):
        seeds = jnp.arange(self.num_envs, dtype=jnp.uint32) + jnp.uint32(
            (seed * 0x9E3779B9) & 0xFFFFFFFF)
        seeds = jax.device_put(seeds, self._env_sharding)
        return self._reset(seeds)

    def step(self, states, actions):
        """Returns (states, obs, rewards, dones) (obs None if obs_type none)."""
        actions = jax.device_put(jnp.asarray(actions, jnp.float32),
                                 self._env_sharding)
        out = self._step(states, actions)
        if self._frame_fn is None:
            states, rewards, dones = out
            return states, None, rewards, dones
        return out

    def mean_reward(self, rewards):
        """Mean over all envs; XLA inserts the cross-device reduction."""
        return jnp.mean(rewards)
