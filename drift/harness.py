"""Reference-drift harness: the ACTUAL reference engine vs agarcl_tpu.

The parity suite (tests/test_parity.py) proves three implementations of
SPEC.md agree bit-for-bit — but SPEC.md deliberately pins away the
reference's nondeterminism (unordered_map player order, std::rand bots,
wall-clock recombine timers) and deviates in a few documented rules
(same-tick food eats, one-virus-spawn-per-tick cap). This harness closes
the remaining gap (VERDICT r3, missing item 1): it compiles the REAL
reference engine headless (renderable=false — the same configuration
/root/reference/agario/CMakeLists.txt:155-183 builds without OpenGL)
behind a small C shim (drift/ref_shim.cpp) and compares *behavior
distributions* under matched configs and identical scripted action
sequences:

  - mass trajectories (mean over seeds at checkpoints)
  - final-mass distributions (KS statistic)
  - pellets eaten, cell counts after splits, live pellet/food counts

Exact trajectories CANNOT match (the reference seeds std::srand with
wall-clock time at construction, Engine.hpp:49, and bots draw from
std::rand) — distribution-level agreement is the correct target, matching
how the reference's own bench validates (random-walk episodic rewards,
bench/screen_obs_example.py).

Run: python -m drift.harness [--steps N] [--seeds K] [--report]
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "libref.so")
_SRC = os.path.join(_DIR, "ref_shim.cpp")


def build_ref(force: bool = False) -> str:
    """Compile the reference-engine shim (idempotent)."""
    if force or not os.path.exists(_SO) or (
            os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
        subprocess.run(
            ["g++", "-O2", "-std=c++17", "-fpermissive", "-shared", "-fPIC",
             "-I/root/reference", "-o", _SO, _SRC],
            check=True, capture_output=True)
    return _SO


class RefEnv:
    """The actual /root/reference engine, headless, one env."""

    def __init__(self, arena=100, num_pellets=200, num_viruses=2, mode=4,
                 num_agents=1, num_bots=0, seed=0):
        lib = ctypes.CDLL(build_ref())
        lib.ref_create.restype = ctypes.c_void_p
        lib.ref_create.argtypes = [ctypes.c_int] * 7
        lib.ref_destroy.argtypes = [ctypes.c_void_p]
        lib.ref_step.argtypes = [ctypes.c_void_p, ctypes.c_float,
                                 ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_float]
        for f, ret in (("ref_agent_mass", ctypes.c_double),
                       ("ref_agent_cells", ctypes.c_int),
                       ("ref_pellets_alive", ctypes.c_int),
                       ("ref_viruses_alive", ctypes.c_int),
                       ("ref_foods_alive", ctypes.c_int),
                       ("ref_agent_x", ctypes.c_double),
                       ("ref_agent_y", ctypes.c_double),
                       ("ref_agent_food_eaten", ctypes.c_int),
                       ("ref_bot_mass", ctypes.c_double)):
            getattr(lib, f).restype = ret
            getattr(lib, f).argtypes = [ctypes.c_void_p]
        lib.ref_respawn_if_dead.argtypes = [ctypes.c_void_p]
        for f in ("ref_nearest_pellet_dir", "ref_nearest_virus_dir"):
            getattr(lib, f).argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float)]
        self._lib = lib
        self._h = lib.ref_create(arena, num_pellets, num_viruses, mode,
                                 num_agents, num_bots, seed)

    def step(self, dx, dy, act=0, ticks=4, dt=1.0 / 30.0):
        self._lib.ref_step(self._h, float(dx), float(dy), int(act),
                           int(ticks), float(dt))
        self._lib.ref_respawn_if_dead(self._h)

    def metrics(self):
        lib, h = self._lib, self._h
        return dict(mass=lib.ref_agent_mass(h), cells=lib.ref_agent_cells(h),
                    pellets=lib.ref_pellets_alive(h),
                    viruses=lib.ref_viruses_alive(h),
                    foods=lib.ref_foods_alive(h),
                    food_eaten=lib.ref_agent_food_eaten(h),
                    bot_mass=lib.ref_bot_mass(h))

    def nearest_pellet_dir(self):
        dx = ctypes.c_float()
        dy = ctypes.c_float()
        self._lib.ref_nearest_pellet_dir(self._h, ctypes.byref(dx),
                                         ctypes.byref(dy))
        return dx.value, dy.value

    def nearest_virus_dir(self):
        dx = ctypes.c_float()
        dy = ctypes.c_float()
        self._lib.ref_nearest_virus_dir(self._h, ctypes.byref(dx),
                                        ctypes.byref(dy))
        return dx.value, dy.value

    def close(self):
        if self._h:
            self._lib.ref_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def scripted_actions(seed: int, steps: int):
    """The shared per-seed action script: random directions + periodic
    split/feed so splits, ejections, and recombines all get exercised."""
    rng = np.random.default_rng(seed * 7919 + 13)
    dirs = rng.uniform(-1.0, 1.0, (steps, 2)).astype(np.float32)
    acts = np.zeros((steps,), np.int32)
    acts[::40] = 2   # split (action enum: 2=split, types.hpp:59-61)
    acts[::25] = np.where(acts[::25] == 0, 1, acts[::25])  # feed
    acts[0] = 0
    return dirs, acts


def run_reference(seeds, steps, policy="script", **cfg):
    """Per-seed metric trajectories from the actual reference engine.

    Policies (mirrored exactly by run_ours):
      script    — per-seed random directions + periodic split/feed
      chase     — unit direction toward the nearest pellet
      virusfeed — grow on pellets until mass >= 60, then aim at the
                  nearest virus and feed (exercises the food->virus
                  7-hit reset/spawn path, Engine.hpp:661-687)
      selffeed  — feed every step while flipping direction (exercises
                  ejected-food edibility timing, Engine.hpp:1011-1025)
    """
    out = []
    for s in seeds:
        env = RefEnv(seed=int(s), **cfg)
        dirs, acts = scripted_actions(int(s), steps)
        masses = np.zeros(steps)
        viruses = np.zeros(steps)
        foods = np.zeros(steps)
        for t in range(steps):
            if policy == "chase":
                dx, dy = env.nearest_pellet_dir()
                env.step(dx, dy, acts[t])
            elif policy == "virusfeed":
                if env.metrics()["mass"] >= 60:
                    dx, dy = env.nearest_virus_dir()
                    env.step(dx, dy, 1)
                else:
                    dx, dy = env.nearest_pellet_dir()
                    env.step(dx, dy, 0)
            elif policy == "selffeed":
                if env.metrics()["mass"] < 80:
                    dx, dy = env.nearest_pellet_dir()
                    env.step(dx, dy, 0)
                else:
                    flip = 1.0 if (t % 2 == 0) else -1.0
                    env.step(flip * dirs[t, 0], flip * dirs[t, 1], 1)
            else:
                env.step(dirs[t, 0], dirs[t, 1], acts[t])
            m = env.metrics()
            masses[t] = m["mass"]
            viruses[t] = m["viruses"]
            foods[t] = m["foods"]
        m = env.metrics()
        m["masses"] = masses
        m["virus_traj"] = viruses
        m["food_traj"] = foods
        env.close()
        out.append(m)
    return out


def run_ours(seeds, steps, policy="script", arena=100, num_pellets=200,
             num_viruses=2, mode=4, num_agents=1, num_bots=0):
    """Per-seed metric trajectories from agarcl_tpu (vmapped XLA on the
    default JAX device; JAX_PLATFORMS=cpu selects the CPU)."""
    import jax
    import functools
    import jax.numpy as jnp
    from agarcl_tpu import EnvConfig, env_reset
    from agarcl_tpu.env import env_step

    cfg = EnvConfig(num_agents=num_agents, ticks_per_step=4,
                    arena_size=arena, num_pellets=num_pellets,
                    num_viruses=num_viruses, num_bots=num_bots, mode=mode)
    n = len(seeds)
    states = jax.vmap(functools.partial(env_reset, cfg))(
        jnp.asarray(seeds, jnp.uint32))
    step = jax.jit(jax.vmap(functools.partial(env_step, cfg)))
    dirs = np.stack([scripted_actions(int(s), steps)[0] for s in seeds])
    acts = np.stack([scripted_actions(int(s), steps)[1] for s in seeds])
    masses = np.zeros((n, steps))
    virus_traj = np.zeros((n, steps))
    food_traj = np.zeros((n, steps))
    from agarcl_tpu.env import respawn_players

    def _nearest_dir(pos, alive, cen):
        """Unit direction (n, 2) toward each env's nearest alive entity."""
        rel = pos - cen[:, None, :]
        d2 = (rel * rel).sum(-1)
        d2 = np.where(alive & (d2 > 1e-4), d2, 1e30)
        sel = rel[np.arange(n), d2.argmin(1)]
        nn = np.maximum(np.linalg.norm(sel, axis=1, keepdims=True), 1e-6)
        return ((sel / nn).astype(np.float32),
                (d2.min(1) < 1e29)[:, None])

    for t in range(steps):
        if policy in ("chase", "virusfeed", "selffeed"):
            cen = np.asarray(states.player_centroid()[:, 0])
            pp, pa = states.pellet_xy_alive(cfg)
            dchase, has = _nearest_dir(np.asarray(pp), np.asarray(pa), cen)
            pdir = np.where(has, dchase, 0.0)
            mass = np.asarray(states.player_mass()[:, 0])
        if policy == "chase":
            a = np.concatenate([pdir, acts[:, t, None]],
                               axis=1)[:, None, :].astype(np.float32)
        elif policy == "virusfeed":
            vdir, vhas = _nearest_dir(np.asarray(states.virus_pos),
                                      np.asarray(states.virus_alive), cen)
            vdir = np.where(vhas, vdir, 0.0)
            hungry = (mass < 60)[:, None]
            d = np.where(hungry, pdir, vdir)
            act = np.where(hungry[:, 0], 0, 1).astype(np.float32)
            a = np.concatenate([d, act[:, None]],
                               axis=1)[:, None, :].astype(np.float32)
        elif policy == "selffeed":
            flip = 1.0 if (t % 2 == 0) else -1.0
            hungry = (mass < 80)[:, None]
            d = np.where(hungry, pdir, flip * dirs[:, t])
            act = np.where(hungry[:, 0], 0, 1).astype(np.float32)
            a = np.concatenate([d, act[:, None]],
                               axis=1)[:, None, :].astype(np.float32)
        else:
            a = np.concatenate([dirs[:, t], acts[:, t, None]],
                               axis=1)[:, None, :].astype(np.float32)
        states, _, _ = step(states, jnp.asarray(a))
        # mirror the harness's respawn-if-dead: AGENT ONLY, matching
        # ref_respawn_if_dead (ref_shim.cpp) which respawns pids[0].
        # (The pre-round-5 version respawned EVERY player of the env,
        # resetting a live duel bot's mass to spawn size each time the
        # agent died — the sole source of the n=200 duel final-mass
        # deviation: with it fixed, bot mass/death-rate trajectories
        # match the reference.)
        dead = ~np.asarray(states.player_alive()[:, 0])
        if dead.any():
            mask = np.zeros((n, cfg.num_players), bool)
            mask[:, 0] = dead
            states = jax.vmap(functools.partial(respawn_players, cfg))(
                states, jnp.asarray(mask))
        masses[:, t] = np.asarray(states.player_mass()[:, 0])
        virus_traj[:, t] = np.asarray(states.virus_alive).sum(1)
        food_traj[:, t] = np.asarray(states.food_alive).sum(1)
    pp, pa = states.pellet_xy_alive(cfg)
    pm_all = np.asarray(states.player_mass())
    pal_all = np.asarray(states.player_alive())
    out = []
    for i in range(n):
        bot_mass = (float(pm_all[i, 1] * pal_all[i, 1])
                    if cfg.num_players > 1 else 0.0)
        out.append(dict(
            mass=float(masses[i, -1]),
            bot_mass=bot_mass,
            cells=int(np.asarray(states.cell_alive[i, 0]).sum()),
            pellets=int(np.asarray(pa[i]).sum()),
            viruses=int(np.asarray(states.virus_alive[i]).sum()),
            foods=int(np.asarray(states.food_alive[i]).sum()),
            food_eaten=int(np.asarray(states.food_eaten[i, 0])),
            masses=masses[i],
            virus_traj=virus_traj[i],
            food_traj=food_traj[i]))
    return out


def ks_stat(a, b):
    """Two-sample Kolmogorov-Smirnov statistic (no scipy dependency)."""
    a, b = np.sort(a), np.sort(b)
    allv = np.concatenate([a, b])
    ca = np.searchsorted(a, allv, side="right") / len(a)
    cb = np.searchsorted(b, allv, side="right") / len(b)
    return float(np.abs(ca - cb).max())


def compare(ref, ours, steps):
    """Summary dict of distribution deltas."""
    checkpoints = [steps // 4, steps // 2, steps - 1]
    rm = np.stack([r["masses"] for r in ref])
    om = np.stack([o["masses"] for o in ours])
    rows = {}
    for cp in checkpoints:
        rows[f"mean_mass@{cp + 1}"] = (float(rm[:, cp].mean()),
                                       float(om[:, cp].mean()))
    rows["final_mass_ks"] = ks_stat(rm[:, -1], om[:, -1])
    for k in ("food_eaten", "pellets", "foods", "cells"):
        rows[f"mean_{k}"] = (float(np.mean([r[k] for r in ref])),
                             float(np.mean([o[k] for o in ours])))
    if any(r.get("bot_mass", 0.0) > 0 for r in ref + ours):
        rows["mean_bot_mass"] = (
            float(np.mean([r["bot_mass"] for r in ref])),
            float(np.mean([o["bot_mass"] for o in ours])))
        rows["bot_dead_frac"] = (
            float(np.mean([r["bot_mass"] == 0.0 for r in ref])),
            float(np.mean([o["bot_mass"] == 0.0 for o in ours])))
    for k in ("virus_traj", "food_traj"):
        rv = np.stack([r[k] for r in ref])
        ov = np.stack([o[k] for o in ours])
        rows[f"mean_{k}"] = (float(rv.mean()), float(ov.mean()))
        rows[f"max_{k}"] = (float(rv.max()), float(ov.max()))
    return rows


def main():
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seeds", type=int, default=48)
    ap.add_argument("--mode", type=int, default=4)
    ap.add_argument("--pellets", type=int, default=200)
    ap.add_argument("--viruses", type=int, default=2)
    ap.add_argument("--arena", type=int, default=100)
    ap.add_argument("--policy", default="script",
                    choices=["script", "chase", "virusfeed", "selffeed"])
    args = ap.parse_args()
    seeds = list(range(1, args.seeds + 1))
    kw = dict(arena=args.arena, num_pellets=args.pellets,
              num_viruses=args.viruses, mode=args.mode)
    print(f"reference engine x{args.seeds} seeds, {args.steps} steps, "
          f"policy={args.policy} ...")
    ref = run_reference(seeds, args.steps, policy=args.policy, **kw)
    print("agarcl_tpu ...")
    ours = run_ours(seeds, args.steps, policy=args.policy, **kw)
    for k, v in compare(ref, ours, args.steps).items():
        print(f"  {k}: {v}")


if __name__ == "__main__":
    main()
