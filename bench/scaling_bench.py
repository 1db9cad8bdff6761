"""Scaling-efficiency benchmark: env-steps/s at 1..N devices.

Lockstep envs are embarrassingly parallel (no per-step collectives), so
efficiency is gated only by per-device dispatch overhead and the smallest
per-device batch.

On several devices or hosts this runs as-is over the real mesh (call
jax.distributed.initialize() first on each host). Without them, run on the
virtual CPU platform:

  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python bench/scaling_bench.py

Prints one JSON line per device count plus a final efficiency summary.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from agarcl_tpu import EnvConfig
from agarcl_tpu.parallel import ShardedVecEnv, make_env_mesh

ENVS_PER_DEVICE = int(os.environ.get("SCALING_ENVS_PER_DEVICE", "1024"))
STEPS = 10


def measure(n_dev: int) -> float:
    devices = jax.devices()[:n_dev]
    mesh = make_env_mesh(devices)
    cfg = EnvConfig(num_agents=1, ticks_per_step=4, arena_size=350,
                    num_pellets=500, num_viruses=10, num_bots=0, mode=4)
    env = ShardedVecEnv(cfg, num_envs=ENVS_PER_DEVICE * n_dev, mesh=mesh,
                        obs_type="ram")
    states = env.reset(0)
    acts = jnp.zeros((env.num_envs, 1, 3), jnp.float32)
    states, obs, rewards, dones = env.step(states, acts)  # compile
    jax.block_until_ready(rewards)
    t0 = time.perf_counter()
    for _ in range(STEPS):
        states, obs, rewards, dones = env.step(states, acts)
    jax.block_until_ready(rewards)
    dt = time.perf_counter() - t0
    return env.num_envs * STEPS / dt


def main():
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="",
                    help="write the per-device-count rows + efficiency "
                         "summary as one JSON artifact (committed runs: "
                         "bench/scaling_results_*.json)")
    args = ap.parse_args()
    n = len(jax.devices())
    counts = sorted({1, 2, n // 2, n} - {0})
    results = {}
    rows = []
    for c in counts:
        if c > n:
            continue
        sps = measure(c)
        results[c] = sps
        row = {"devices": c, "env_steps_per_sec": round(sps, 1),
               "envs": ENVS_PER_DEVICE * c}
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = None
    if len(results) > 1 and 1 in results:
        top = max(results)
        eff = results[top] / (results[1] * top)
        summary = {"metric": "scaling_efficiency_1_to_N",
                   "N": top, "value": round(eff, 4), "target": 0.85,
                   "efficiency_per_count": {
                       str(c): round(results[c] / (results[1] * c), 4)
                       for c in sorted(results) if c > 1}}
        print(json.dumps(summary), flush=True)
    if args.out:
        import platform
        art = {"platform": jax.default_backend(),
               "host_cpus": os.cpu_count(),
               "machine": platform.machine(),
               "envs_per_device": ENVS_PER_DEVICE,
               "rows": rows, "summary": summary,
               "note": ("virtual CPU devices share the host's physical "
                        "cores: counts beyond the core count are "
                        "core-bound, not a sharding property — real "
                        "multi-chip runs use this same program over a "
                        "hardware mesh")}
        with open(args.out, "w") as f:
            json.dump(art, f, indent=1)
        print(f"wrote {args.out}", flush=True)


if __name__ == "__main__":
    main()
