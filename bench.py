"""Throughput benchmark: env-steps/s on one device at 8192 vectorized envs.

Prints ONE JSON line: {"metric", "value", "unit", "runs", "platform",
"device_kind", "device_count", "gpu"}. value is the median of 3 timed runs;
"gpu" is the card's name and power limit as nvidia-smi reports them (null
when there is no nvidia-smi). The platform is whatever JAX picks
(JAX_PLATFORMS selects it); a CPU result is labelled "cpu" and is not a
device measurement.
"""

import argparse
import json
import time

import jax
import jax.numpy as jnp

from agarcl_tpu.compile_cache import enable_compile_cache
from agarcl_tpu.config import bench_config
from agarcl_tpu.obs.grid import GridObsConfig
from agarcl_tpu.obs.screen import ScreenObsConfig
from agarcl_tpu.profiling import gpu_name_and_power_limit
from agarcl_tpu.vec import VecEnv

NUM_ENVS = 8192
# Steps chained inside one device program per multi_step call (one host
# dispatch per call). These defaults are placeholders: the benchmark
# redesign picks them on the card by measurement.
STEPS_PER_CALL = 40
TIMED_CALLS = 4


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--envs", type=int, default=NUM_ENVS)
    ap.add_argument("--steps", type=int, default=0,
                    help="steps chained per multi_step call (0 = auto: "
                         "40 for ram/none obs, 10 otherwise)")
    ap.add_argument("--iters", type=int, default=TIMED_CALLS)
    ap.add_argument("--mode", type=int, default=4,
                    help="game mode (7-10 = duel vs one scripted bot)")
    ap.add_argument("--bots", type=int, default=-1,
                    help="mode-0 bot count (-1 = default 4, the reference "
                         "full-game roster law's four scripted types, "
                         "BaseEnvironment.hpp:381-397; modes 1-6 ignore "
                         "it, modes 7-10 force one)")
    ap.add_argument("--agents", type=int, default=1,
                    help="number of action-driven agents (multi-agent "
                         "games; each agent gets its own obs frame)")
    ap.add_argument("--obs", default="ram",
                    choices=("ram", "grid", "screen", "gobigger", "none"),
                    help="observation computed+returned every step")
    ap.add_argument("--size", type=int, default=0,
                    help="grid_size / screen_len override (0 = default)")
    ap.add_argument("--poly", action="store_true",
                    help="screen obs: reference fan silhouettes "
                         "(polygon_edges)")
    ap.add_argument("--grid-dtype", default="int16",
                    choices=("int32", "int16", "int8"),
                    help="grid obs output dtype (int16 = the saturating "
                         "contract default, GridObsConfig.out_dtype; "
                         "int32 = exact values, the reference-compatible "
                         "gym wrapper's dtype; int8 quarters the frame "
                         "bytes)")
    args = ap.parse_args()
    num_envs, timed_calls = args.envs, args.iters
    steps_per_call = args.steps or (
        STEPS_PER_CALL if args.obs in ("ram", "none") else 10)

    enable_compile_cache()

    num_bots = 0
    if args.mode == 0:
        num_bots = args.bots if args.bots >= 0 else 4
    elif args.mode in (7, 8, 9, 10):
        num_bots = 1
    cfg = bench_config(num_agents=args.agents, num_bots=num_bots,
                       mode=args.mode)
    obs_config = None
    if args.obs == "grid":
        obs_config = GridObsConfig(grid_size=args.size or 64,
                                   out_dtype=args.grid_dtype)
    elif args.obs == "screen":
        obs_config = ScreenObsConfig(screen_len=args.size or 84,
                                     agent_view=True,
                                     polygon_edges=args.poly,
                                     polygon_virus=("circle" if args.poly
                                                    else "wavy"))
    env = VecEnv(cfg, num_envs, obs_type=args.obs, obs_config=obs_config)
    states, _ = env.reset(0)

    actions = jnp.zeros((num_envs, cfg.num_agents, 3), jnp.float32)
    key = jax.random.PRNGKey(0)
    dirs = jax.random.uniform(key, (num_envs, cfg.num_agents, 2),
                              minval=-1.0, maxval=1.0)
    actions = actions.at[..., :2].set(dirs)

    # compile, then one untimed call so the timed runs start warm
    for _ in range(2):
        states, obs, rewards, dones = env.multi_step(states, actions,
                                                     steps_per_call)
        jax.block_until_ready((states, obs, rewards))

    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(timed_calls):
            states, obs, rewards, dones = env.multi_step(states, actions,
                                                         steps_per_call)
        jax.block_until_ready((states, obs, rewards))
        # host fetch of a device-side reduction closes the timed region
        checksum = float(jax.device_get(jnp.sum(
            jnp.asarray(rewards, jnp.float32))))
        dt = time.perf_counter() - t0
        assert checksum == checksum, "NaN rewards"
        runs.append(num_envs * steps_per_call * timed_calls / dt)
    sps = sorted(runs)[len(runs) // 2]
    suffix = "" if args.mode == 4 else f"_mode{args.mode}"
    if args.mode == 0:
        suffix += f"_{num_bots}bots"
    if args.agents != 1:
        suffix += f"_{args.agents}ag"
    if args.obs == "grid" and args.grid_dtype != "int16":
        suffix += f"_{args.grid_dtype}"
    if args.obs == "screen" and args.poly:
        suffix += "_poly"
    dev = jax.devices()[0]
    print(json.dumps({
        "metric":
            f"env_steps_per_sec_per_chip_{num_envs}envs_{args.obs}{suffix}",
        "value": sps,
        "unit": "steps/s",
        "runs": runs,
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "gpu": gpu_name_and_power_limit(),
    }))


if __name__ == "__main__":
    main()
