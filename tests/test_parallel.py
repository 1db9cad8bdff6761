"""Multi-device sharding tests on the 8-device virtual CPU mesh: the env axis
shards with zero per-step collectives; results must be identical to the
unsharded batch."""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from agarcl_tpu import EnvConfig, env_reset, env_step
from agarcl_tpu.parallel import ShardedVecEnv, make_env_mesh
from agarcl_tpu.vec import VecEnv

CFG = EnvConfig(num_agents=1, ticks_per_step=2, arena_size=100,
                num_pellets=32, num_viruses=2, num_bots=0, mode=4)


def test_sharded_env_runs_on_mesh():
    assert len(jax.devices()) == 8
    mesh = make_env_mesh()
    env = ShardedVecEnv(CFG, num_envs=16, mesh=mesh, obs_type="ram")
    states = env.reset(0)
    acts = jnp.zeros((16, 1, 3), jnp.float32)
    states, obs, rewards, dones = env.step(states, acts)
    assert rewards.shape == (16, 1)
    # state is actually distributed across all 8 devices
    shard_devs = {s.device for s in states.cell_pos.addressable_shards}
    assert len(shard_devs) == 8


def test_sharded_matches_unsharded():
    mesh = make_env_mesh()
    senv = ShardedVecEnv(CFG, num_envs=8, mesh=mesh, obs_type="none")
    sstates = senv.reset(0)
    acts = jnp.tile(jnp.asarray([[0.3, -0.2, 0.0]], jnp.float32), (8, 1, 1))
    sstates, _, srewards, _ = senv.step(sstates, acts)

    reset_b = jax.jit(jax.vmap(functools.partial(env_reset, CFG)))
    step_b = jax.jit(jax.vmap(functools.partial(env_step, CFG)))
    seeds = jnp.arange(8, dtype=jnp.uint32)
    ustates = reset_b(seeds)
    ustates, urewards, _ = step_b(ustates, acts)

    np.testing.assert_allclose(np.asarray(srewards), np.asarray(urewards))
    np.testing.assert_allclose(np.asarray(sstates.cell_pos),
                               np.asarray(ustates.cell_pos), rtol=1e-6)


def test_vecenv_autoreset():
    cfg = EnvConfig(num_agents=1, ticks_per_step=2, arena_size=100,
                    num_pellets=32, num_viruses=0, num_bots=0, mode=3)
    env = VecEnv(cfg, 4, obs_type="none", auto_reset=True)
    states, _ = env.reset(0)
    # force done: mass over the mode-3 threshold
    states = states.replace(
        cell_mass=states.cell_mass.at[:, 0, 0].set(23500))
    acts = jnp.zeros((4, 1, 3), jnp.float32)
    states, obs, rewards, dones = env.step(states, acts)
    assert bool(jnp.all(dones))
    # next step: fresh envs, mass back to spawn size
    states, obs, rewards, dones = env.step(states, acts)
    assert int(states.player_mass().max()) <= 30
