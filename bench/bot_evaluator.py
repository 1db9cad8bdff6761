"""Bot evaluator — the vmapped counterpart of the reference's ThreadPool-based
tool (/root/reference/agario/bots/benchmark.cpp:134-271: BotEvaluator plays
many headless games in parallel on 4 CPU threads and aggregates per-bot
avg/max/min mass).

Here the fan-out is a vmap: thousands of lockstep mode-0 games run on one
device; the report aggregates final masses per bot type across all games.

Usage:
  JAX_PLATFORMS=cpu python bench/bot_evaluator.py --games 64 --steps 100
  python bench/bot_evaluator.py --games 2048 --steps 250        # on the GPU
"""

import argparse
import functools
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


BOT_NAMES = {1: "HungryBot", 2: "HungryShyBot", 3: "AggressiveBot",
             4: "AggressiveShyBot"}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--games", type=int, default=64)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--bots", type=int, default=8)
    ap.add_argument("--arena", type=int, default=250)
    ap.add_argument("--pellets", type=int, default=500)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    from agarcl_tpu import EnvConfig, env_reset, env_step

    cfg = EnvConfig(num_agents=1, ticks_per_step=4, arena_size=args.arena,
                    num_pellets=args.pellets, num_viruses=10,
                    num_bots=args.bots, mode=0)
    reset_b = jax.jit(jax.vmap(functools.partial(env_reset, cfg)))
    step_b = jax.jit(jax.vmap(functools.partial(env_step, cfg)))

    states = reset_b(jnp.arange(args.games, dtype=jnp.uint32)
                     + jnp.uint32(args.seed))
    # the RL agent random-walks; bots follow their policies in-engine
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    for t in range(args.steps):
        acts = np.zeros((args.games, 1, 3), np.float32)
        acts[..., :2] = rng.uniform(-1, 1, (args.games, 1, 2))
        states, rewards, dones = step_b(states, jnp.asarray(acts))
    jax.block_until_ready(states.cell_mass)
    dt = time.perf_counter() - t0

    masses = np.asarray(states.player_mass())          # (games, players)
    bot_types = cfg.bot_types()
    print(f"{args.games} games x {args.steps} steps "
          f"({args.games * args.steps / dt:,.0f} env-steps/s)")
    print(f"{'player':18s} {'avg':>8s} {'max':>8s} {'min':>8s}")
    agent = masses[:, 0]
    print(f"{'agent (random)':18s} {agent.mean():8.1f} {agent.max():8d} "
          f"{agent.min():8d}")
    for bt in sorted(set(bot_types) - {0}):
        cols = [i for i, b in enumerate(bot_types) if b == bt]
        m = masses[:, cols].ravel()
        print(f"{BOT_NAMES[bt]:18s} {m.mean():8.1f} {m.max():8d} "
              f"{m.min():8d}")


if __name__ == "__main__":
    main()
