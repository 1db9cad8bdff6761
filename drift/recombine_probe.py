"""Targeted probe for the recombine-timer SPEC deviation (SPEC.md Q-recombine):
the reference arms a WALL-CLOCK 10 s timer per split cell
(/root/reference/agario/core/Entities.hpp:183-193); agarcl_tpu pins it to
300 ticks = 10 game-seconds at 30 t/s (SPEC.md). In a fast headless run the
reference's timer is ~never reached (the sim runs years of game time per
wall second), so its split cells recombine only after ~10 real seconds —
an artifact of real-time play leaking into the headless benchmark. This
probe forces one split, then counts ticks until the cells merge, in both
engines, and (for the reference) also reports the wall time that elapsed.
"""
import os, sys, time
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
import numpy as np


def ref_merge_ticks(max_steps=3000, sleep=0.0):
    from drift.harness import RefEnv
    env = RefEnv(arena=100, num_pellets=50, num_viruses=0, mode=4, seed=3)
    # grow a bit so the split is legal (mass >= 50)
    for t in range(200):
        dx, dy = env.nearest_pellet_dir()
        env.step(dx, dy, 0, ticks=4)
        if env.metrics()["mass"] >= 60:
            break
    env.step(0.5, 0.0, 2, ticks=1)          # split
    assert env.metrics()["cells"] >= 2, env.metrics()
    t0 = time.perf_counter()
    for t in range(max_steps):
        env.step(0.0, 0.0, 0, ticks=1)
        if sleep:
            time.sleep(sleep)
        if env.metrics()["cells"] == 1:
            return t + 1, time.perf_counter() - t0
    return None, time.perf_counter() - t0


def ours_merge_ticks(max_steps=3000):
    import jax
    import functools
    import jax.numpy as jnp
    from agarcl_tpu import EnvConfig, env_reset
    from agarcl_tpu.env import apply_actions
    from agarcl_tpu.engine.tick import engine_tick
    cfg = EnvConfig(num_agents=1, ticks_per_step=1, arena_size=100,
                    num_pellets=50, num_viruses=0, num_bots=0, mode=4)
    s = env_reset(cfg, 3)
    tick = jax.jit(functools.partial(engine_tick, cfg))
    app = jax.jit(functools.partial(apply_actions, cfg))
    # grow by chasing pellets until splittable
    for t in range(800):
        pp, pa = s.pellet_xy_alive(cfg)
        cen = np.asarray(s.player_centroid()[0])
        rel = np.asarray(pp) - cen
        d2 = (rel * rel).sum(-1)
        d2 = np.where(np.asarray(pa) & (d2 > 1e-4), d2, 1e30)
        v = rel[d2.argmin()]
        v = v / max(np.linalg.norm(v), 1e-6)
        s = app(s, jnp.asarray([[v[0], v[1], 0.0]], jnp.float32))
        s = tick(s)
        if float(s.player_mass()[0]) >= 60:
            break
    s = app(s, jnp.asarray([[0.5, 0.0, 2.0]], jnp.float32))
    s = tick(s)
    assert int(s.cell_alive[0].sum()) >= 2
    s = app(s, jnp.asarray([[0.0, 0.0, 0.0]], jnp.float32))
    for t in range(max_steps):
        s = tick(s)
        if int(s.cell_alive[0].sum()) == 1:
            return t + 1
    return None


if __name__ == "__main__":
    ot = ours_merge_ticks()
    print(f"agarcl_tpu: split cells recombine after {ot} ticks "
          f"(pinned 300-tick = 10 game-second timer + touch condition)")
    rt, wall = ref_merge_ticks()
    print(f"reference (fast headless): recombine after {rt} ticks, "
          f"{wall:.1f} wall-seconds")
    rt2, wall2 = ref_merge_ticks(sleep=1 / 30.0)
    print(f"reference (real-time 30 t/s): recombine after {rt2} ticks, "
          f"{wall2:.1f} wall-seconds")
