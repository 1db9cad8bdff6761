"""Observation-path throughput: ram / grid / screen with obs CONSUMED.

Every timing loop blocks on the observation tensor, so the observation
pipeline cannot be dead-coded by XLA (discarding obs from a jitted loop
silently removes the whole obs computation and overstates throughput).
Rates are of the default JAX device; run on the card for device numbers.

Usage: python bench/obs_bench.py [ram|grid|screen|all]
"""

import sys
import time

import jax
import jax.numpy as jnp

from agarcl_tpu import EnvConfig
from agarcl_tpu.vec import VecEnv

CFG = EnvConfig(num_agents=1, ticks_per_step=4, arena_size=350,
                num_pellets=500, num_viruses=10, num_bots=0,
                reward_type=True, mode=4)


def _actions(n):
    key = jax.random.PRNGKey(0)
    return jnp.zeros((n, 1, 3), jnp.float32).at[..., :2].set(
        jax.random.uniform(key, (n, 1, 2), minval=-1.0, maxval=1.0))


def _run(env, n, steps_per_call, calls):
    states, _ = env.reset(0)
    acts = _actions(n)
    if steps_per_call > 1:
        states, obs, r, d = env.multi_step(states, acts, steps_per_call)
        jax.block_until_ready(obs)
        t0 = time.perf_counter()
        for _ in range(calls):
            states, obs, r, d = env.multi_step(states, acts, steps_per_call)
        jax.block_until_ready(obs)
    else:
        out = env.step(states, acts)
        jax.block_until_ready(out[1])
        t0 = time.perf_counter()
        for _ in range(calls):
            out = env.step(out[0], acts)
        jax.block_until_ready(out[1])
    return n * steps_per_call * calls / (time.perf_counter() - t0)


def bench_ram():
    env = VecEnv(CFG, 8192, obs_type="ram")
    print(f"ram 8192 envs, 10-step chained: "
          f"{_run(env, 8192, 10, 4):,.0f} env-steps/s")


def bench_grid():
    from agarcl_tpu.obs.grid import GridObsConfig
    for G, n in ((64, 4096), (128, 2048)):
        env = VecEnv(CFG, n, obs_type="grid",
                     obs_config=GridObsConfig(grid_size=G))
        print(f"grid {G}x{G} {n} envs, 5-step chained: "
              f"{_run(env, n, 5, 8):,.0f} env-steps/s")


def bench_screen():
    from agarcl_tpu.obs.screen import ScreenObsConfig
    import dataclasses
    cfg = dataclasses.replace(CFG, mode=1)
    for S, n in ((84, 2048), (128, 256)):
        env = VecEnv(cfg, n, obs_type="screen",
                     obs_config=ScreenObsConfig(screen_len=S,
                                                agent_view=True))
        print(f"screen {S}x{S} {n} envs, 5-step chained: "
              f"{_run(env, n, 5, 8):,.0f} env-steps/s")


if __name__ == "__main__":
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    if which not in ("ram", "grid", "screen", "all"):
        sys.exit(f"unknown mode {which!r}: expected ram|grid|screen|all")
    if which in ("ram", "all"):
        bench_ram()
    if which in ("grid", "all"):
        bench_grid()
    if which in ("screen", "all"):
        bench_screen()
