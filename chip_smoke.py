"""Smoke run of the main path on one NVIDIA GPU, checked against the CPU.

    python chip_smoke.py              # every phase on one card
    python chip_smoke.py --cards 4    # the sharded four-card path only

Each env phase drives `VecEnv.reset` and `VecEnv.multi_step` at a size users
run, prints its set-up seconds (the first call: compile and run), its steady
env-steps/s and the compiled step's memory analysis, and compares its first
envs with the same XLA tick run on the CPU in this process from the same
seeds and actions. Integer and bool leaves (alive masks, pellet keys, cell
ids, ticks) must be equal; float leaves must agree within FLOAT_ATOL. The
frames the timed program returns must equal the emitter's on the card's own
states, and that emitter the CPU's. Where the two trajectories' integer
frames differ, each differing element must be explained by an entity that
sits within FLOAT_ATOL of a bin or pixel edge in the CPU's state, and is
printed with that entity and its distance. The ppo phase runs the training
loop of examples/train_ppo.py.

Every phase raises on failure. The last line of standard output is one JSON
object naming the device; it is printed only when every phase passed. The
script exits 1 without it when JAX finds no GPU: there is no CPU fallback.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from agarcl_tpu.compile_cache import enable_compile_cache
from agarcl_tpu.config import EnvConfig, bench_config
from agarcl_tpu.obs.gobigger import GoBiggerObsConfig
from agarcl_tpu.obs.grid import GridObsConfig
from agarcl_tpu.obs.screen import (_AGENT_VIEW_COLORS, _NUM_GRID_LINES,
                                   _RAD_FOOD, _RAD_PELLET, _TAN_HALF_FOV,
                                   ScreenObsConfig, _pixel_idx)
from agarcl_tpu.parallel import ShardedVecEnv, make_env_mesh
from agarcl_tpu.profiling import gpu_name_and_power_limit
from agarcl_tpu.vec import VecEnv, make_obs_fn

REPO = os.path.dirname(os.path.abspath(__file__))

# f32 state and frames: the card and the CPU run the same XLA program, but
# each backend decides on its own which multiply-adds it contracts into one
# FMA and in which order it sums, so floats may differ in the last bits and
# the collision pass carries such differences forward. 1e-3 world units is
# under 0.04% of the smallest cell's radius (2.82 at mass 25).
FLOAT_ATOL = 1e-3
FLOAT_REASON = ("f32 contraction and summation order differ between the "
                "GPU and CPU backends; 1e-3 world units is < 0.04% of a "
                "25-mass cell's radius")

STEPS_PER_CALL = 10
COMPARE_CALLS = 5          # 5 x 10 env-steps x 4 ticks = 200 ticks
COMPARE_ENVS = 32


def task_config(mode: int) -> EnvConfig:
    """The task suite's own shape (bench/tasks_configs/mode_<mode>.json)."""
    with open(os.path.join(REPO, "bench", "tasks_configs",
                           f"mode_{mode}.json")) as f:
        t = json.load(f)
    return EnvConfig(num_agents=1, ticks_per_step=t["ticks_per_step"],
                     arena_size=t["arena_size"], num_pellets=t["num_pellets"],
                     num_viruses=t["num_viruses"], num_bots=t["num_bots"],
                     pellet_regen=t["pellet_regen"],
                     reward_type=bool(t["reward_type"]),
                     c_death=t["c_death"], mode=t["mode"])


@dataclasses.dataclass(frozen=True)
class EnvPhase:
    name: str
    cfg: EnvConfig
    obs_type: str
    num_envs: int
    obs_config: object = None
    split_feed: bool = False          # seeded actions include acts 1 and 2
    respawn_main_during_obs: bool = False


def env_phases() -> dict:
    phases = [
        EnvPhase("ram", bench_config(), "ram", 8192),
        EnvPhase("duel", bench_config(mode=7, num_bots=1), "ram", 8192,
                 split_feed=True),
        EnvPhase("roster", bench_config(mode=0, num_bots=4), "ram", 8192),
        EnvPhase("grid", bench_config(), "grid", 4096,
                 obs_config=GridObsConfig(grid_size=64, out_dtype="int32")),
        EnvPhase("screen", task_config(1), "screen", 2048,
                 obs_config=ScreenObsConfig(screen_len=128, agent_view=True),
                 respawn_main_during_obs=True),
        EnvPhase("gobigger", bench_config(num_agents=2), "gobigger", 4096,
                 obs_config=GoBiggerObsConfig()),
    ]
    return {p.name: p for p in phases}


# ---------------------------------------------------------------- helpers

def require_gpu():
    """The first device, which must be a GPU; exits 1 otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (first device: {dev.platform} "
              f"{dev.device_kind}); this script measures the card only",
              file=sys.stderr)
        sys.exit(1)
    return dev


def result_line(platform: str, kind: str, count: int) -> str:
    """The contract's last line."""
    return json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": count}})


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def compare(ref, got, atol: float = FLOAT_ATOL, what: str = "") -> float:
    """Integer and bool leaves equal, float leaves within atol; raises
    AssertionError naming the first leaf that differs. Returns the largest
    float difference seen."""
    ref_l, got_l = _leaves(ref), _leaves(got)
    assert len(ref_l) == len(got_l), (what, len(ref_l), len(got_l))
    worst = 0.0
    for (path, r), (_, g) in zip(ref_l, got_l):
        name = f"{what}{jax.tree_util.keystr(path)}"
        r, g = np.asarray(r), np.asarray(g)
        assert r.shape == g.shape and r.dtype == g.dtype, \
            (name, r.shape, g.shape, r.dtype, g.dtype)
        if r.dtype.kind in "biu":
            bad = r != g
            if bad.any():
                idx = tuple(int(i) for i in np.argwhere(bad)[0])
                raise AssertionError(
                    f"{name}: {int(bad.sum())} of {bad.size} elements "
                    f"differ; first at {idx}: ref {r[idx]} got {g[idx]}")
            continue
        if (np.isfinite(r) != np.isfinite(g)).any():
            raise AssertionError(f"{name}: non-finite values at different "
                                 "places")
        d = np.abs(r.astype(np.float64) - g.astype(np.float64))
        d = np.where(np.isfinite(d), d, 0.0)
        m = float(d.max()) if d.size else 0.0
        if m > atol:
            idx = tuple(int(i) for i in np.argwhere(d > atol)[0])
            raise AssertionError(
                f"{name}: max |diff| {m:.3g} > atol {atol:g}; first at "
                f"{idx}: ref {r[idx]} got {g[idx]}")
        worst = max(worst, m)
    return worst


def make_actions(seed: int, num_envs: int, num_agents: int,
                 split_feed: bool) -> np.ndarray:
    """(N, A, 3) seeded actions: a direction in [-1, 1]^2 and, with
    split_feed, act 2 (split) or 1 (feed) for a tenth of the agents each."""
    rng = np.random.default_rng(seed)
    acts = np.zeros((num_envs, num_agents, 3), np.float32)
    acts[..., :2] = rng.uniform(-1.0, 1.0, (num_envs, num_agents, 2))
    if split_feed:
        acts[..., 2] = rng.choice(np.float32([0, 1, 2]), p=[0.8, 0.1, 0.1],
                                  size=(num_envs, num_agents))
    return acts


def head(tree, n: int, axis: int = 0):
    """Host copy of the first n envs (a copy: the state is donated)."""
    return jax.tree.map(
        lambda x: np.asarray(jax.lax.slice_in_dim(x, 0, n, axis=axis)), tree)


def env_at(tree, i: int):
    """Env i of a host batch."""
    return jax.tree.map(lambda x: x[i], tree)


def respawned(states) -> np.ndarray:
    """(N,) bool: a player of the env was respawned at the end of its last
    step. Live players count their ticks and a respawn zeroes the count,
    so a live player at zero was respawned after the step's frame was
    taken (env_step emits the frame before it respawns)."""
    alive = np.asarray(states.cell_alive).any(-1)
    return (alive & (np.asarray(states.elapsed_ticks) == 0)).any(-1)


def memory_line(compiled) -> str:
    m = compiled.memory_analysis()
    if m is None:
        return "memory_analysis: not available"
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "alias_size_in_bytes", "temp_size_in_bytes",
              "generated_code_size_in_bytes")
    return "memory_analysis: " + " ".join(
        f"{f.replace('_size_in_bytes', '')}={getattr(m, f, 'n/a')}"
        for f in fields)


def run_calls(env, states, acts_list, k: int, n_keep: int):
    """multi_step once per action set; returns the final states, the
    first n_keep envs of each call's (states, obs, rewards, dones) on the
    host, and each call's seconds."""
    kept, secs = [], []
    for acts in acts_list:
        t0 = time.perf_counter()
        states, obs, rewards, dones = env.multi_step(states, acts, k)
        jax.block_until_ready((states, obs, rewards, dones))
        secs.append(time.perf_counter() - t0)
        kept.append((head(states, n_keep),
                     head((obs, rewards, dones), n_keep, axis=1)))
    return states, kept, secs


def run_steps(env, states, acts_list, k: int):
    """k single env-steps per action set; returns every step's (states,
    (obs, rewards, dones)) on the host."""
    out = []
    for acts in acts_list:
        for _ in range(k):
            states, obs, rewards, dones = env.multi_step(states, acts, 1)
            out.append((head(states, env.num_envs),
                        jax.tree.map(lambda x: np.asarray(x[0]),
                                     (obs, rewards, dones))))
    return out


# ------------------------------------------- frame differences, explained

# grid channels with every observe_* flag on (obs/grid.py)
_GRID_CHANNEL_CLASS = ("bounds", "pellet", "pellet", "virus", "virus",
                       "own cell", "other cell", "other cell")


def _entities(cfg, state, a: int, kind: str):
    """(positions (n, 2) f64, radii (n,) f64, labels) of the live entities
    of one class in one env's host state, seen by agent a."""
    if kind == "pellet":
        pos, alive = (np.asarray(x) for x in state.pellet_xy_alive(cfg))
        rad = np.full(pos.shape[0], _RAD_PELLET)
        names = [f"pellet {i}" for i in range(pos.shape[0])]
    elif kind == "food":
        pos, alive = np.asarray(state.food_pos), np.asarray(state.food_alive)
        rad = np.full(pos.shape[0], _RAD_FOOD)
        names = [f"food {i}" for i in range(pos.shape[0])]
    elif kind == "virus":
        pos, alive = np.asarray(state.virus_pos), np.asarray(state.virus_alive)
        rad = np.sqrt(np.asarray(state.virus_mass) / np.pi)
        names = [f"virus {i}" for i in range(pos.shape[0])]
    elif kind in ("own cell", "other cell"):
        P, Cc = np.asarray(state.cell_mass).shape
        mine = np.arange(P)[:, None] == a
        keep = np.asarray(state.cell_alive) & (
            mine if kind == "own cell" else ~mine)
        pos = np.asarray(state.cell_pos).reshape(P * Cc, 2)
        rad = np.sqrt(np.asarray(state.cell_mass).reshape(-1) / np.pi)
        alive = keep.reshape(-1)
        names = [f"player {p} cell {c}" for p in range(P) for c in range(Cc)]
    else:
        raise ValueError(kind)
    live = np.flatnonzero(alive)
    return (pos[live].astype(np.float64), rad[live].astype(np.float64),
            [names[i] for i in live])


def _view(state, a: int):
    """(centroid (2,) f64, mass) of agent a."""
    c = np.asarray(state.player_centroid(), np.float64)[a]
    return c, float(np.asarray(state.player_mass())[a])


def grid_suspects(cfg, ocfg, state, a: int, index, atol: float) -> list:
    """The entities that can explain a differing grid element
    (channel, gx, gy) of agent a: those of the channel's class that sit
    within atol world units of a bin edge in `state` and land in bin
    (gx, gy) on one side of it. [(label, distance)]."""
    c, gx, gy = index
    G = ocfg.grid_size
    centre, mass = _view(state, a)
    view = min(max(2.0 * mass, 100.0), 300.0)
    kind = _GRID_CHANNEL_CLASS[c]
    if kind == "bounds":
        w = centre + (np.array([gx, gy], np.float64) - G / 2.0) * view / G
        d = min(abs(w[0]), abs(w[0] - cfg.arena_width), abs(w[1]),
                abs(w[1] - cfg.arena_height))
        return ([(f"bin ({gx}, {gy}) centre", d)] if d <= atol else [])
    pos, _, names = _entities(cfg, state, a, kind)
    u = (pos - centre) * (G / view) + G / 2.0      # grid units
    du = atol * G / view
    # C truncation toward zero; edges sit at integer u except u = 0
    lo, mid, hi = np.trunc(u - du), np.trunc(u), np.trunc(u + du)
    near = (lo != mid) | (hi != mid)               # (n, 2)
    reach = ((lo == [gx, gy]) | (mid == [gx, gy]) | (hi == [gx, gy]))
    hit = near.any(-1) & reach.all(-1)
    dist = np.where(near, np.abs(u - np.round(u)) * view / G, np.inf)
    return [(names[i], float(dist[i].min())) for i in np.flatnonzero(hit)]


def _screen_classes(colour) -> set:
    table = np.asarray(_AGENT_VIEW_COLORS)
    return {k for k in range(table.shape[0])
            if np.array_equal(table[k], colour)}


_SCREEN_CLASS = {2: "pellet", 3: "food", 4: "own cell", 5: "other cell",
                 6: "virus"}


def screen_suspects(cfg, ocfg, state, a: int, y: int, x: int, classes,
                    atol: float) -> list:
    """The entities that can explain a differing pixel (y, x) of agent
    a's agent_view screen: those of the given classes whose rim (or, for
    the arena grid, whose line edge) passes within atol world units of the
    pixel centre in `state`. [(label, distance)]."""
    S = ocfg.screen_len
    centre, mass = _view(state, a)
    z = min(max((1000.0 + mass) * 0.1, 100.0), 900.0)
    half = z * _TAN_HALF_FOV
    idx = _pixel_idx(S).astype(np.float64)
    px, py = centre[0] + idx[x] * half, centre[1] + idx[y] * half
    out = []
    for k in sorted(classes):
        if k == 1:
            lines = np.arange(_NUM_GRID_LINES) / (_NUM_GRID_LINES - 1)
            ph = half / S
            d = min(np.abs(np.abs(px - lines * cfg.arena_width) - ph).min(),
                    np.abs(np.abs(py - lines * cfg.arena_height) - ph).min(),
                    abs(px + 1e-3), abs(px - cfg.arena_width - 1e-3),
                    abs(py + 1e-3), abs(py - cfg.arena_height - 1e-3))
            if d <= atol:
                out.append(("arena grid line", float(d)))
        elif k in _SCREEN_CLASS:
            pos, rad, names = _entities(cfg, state, a, _SCREEN_CLASS[k])
            d = np.abs(np.hypot(px - pos[:, 0], py - pos[:, 1]) - rad)
            out += [(names[i], float(d[i])) for i in np.flatnonzero(d <= atol)]
    return out


def explain_frame_differences(ph: EnvPhase, step: int, state, ref_obs,
                              got_obs, atol: float = FLOAT_ATOL):
    """Explain every integer element in which the two trajectories'
    frames of one step differ. state: the CPU's host state after the step,
    ref_obs/got_obs: (n, F, A, ...) frames of the CPU and the card.
    Returns (explanation lines, elements compared); raises AssertionError
    listing the elements no entity near an edge explains."""
    lines, unexplained, total = [], [], 0
    resp = respawned(state)
    for (path, r), (_, g) in zip(_leaves(ref_obs), _leaves(got_obs)):
        r, g = np.asarray(r), np.asarray(g)
        if r.dtype.kind not in "biu":
            continue
        total += r.size
        for el in np.argwhere(r != g):
            el = tuple(int(j) for j in el)
            where = (f"[{ph.name}] step {step} env {el[0]} "
                     f"{jax.tree_util.keystr(path)}{el[1:]}: ref {r[el]} "
                     f"got {g[el]}")
            i, f, a, rest = el[0], el[1], el[2], el[3:]
            sus = []
            if f != r.shape[1] - 1 or resp[i]:
                pass            # no state of this frame was kept
            elif ph.obs_type == "grid":
                sus = grid_suspects(ph.cfg, ph.obs_config, env_at(state, i),
                                    a, rest, atol)
            elif ph.obs_type == "screen" and ph.obs_config.agent_view \
                    and not ph.obs_config.polygon_edges:
                yx = el[:3] + rest[:2]
                sus = screen_suspects(
                    ph.cfg, ph.obs_config, env_at(state, i), a, *rest[:2],
                    _screen_classes(r[yx]) | _screen_classes(g[yx]), atol)
            if sus:
                name, d = min(sus, key=lambda t: t[1])
                lines.append(f"{where}; {name} at world distance {d:.3g} "
                             f"from its edge (<= {atol:g})")
            else:
                unexplained.append(where + ("; env respawned in this step"
                                            if resp[i] else ""))
    if unexplained:
        raise AssertionError(
            f"{len(unexplained)} frame elements differ with no entity "
            f"within {atol:g} of an edge:\n" + "\n".join(unexplained[:20]))
    return lines, total


# ----------------------------------------------------------------- phases

def run_env_phase(ph: EnvPhase, ref_device, calls: int = COMPARE_CALLS,
                  k: int = STEPS_PER_CALL, n_ref: int = COMPARE_ENVS):
    """One env phase on the default device, compared with ref_device."""
    cfg, n = ph.cfg, ph.num_envs
    dev = jax.devices()[0]
    kw = dict(obs_type=ph.obs_type, obs_config=ph.obs_config,
              respawn_main_during_obs=ph.respawn_main_during_obs)
    acts_list = [make_actions(1000 + c, n, cfg.num_agents, ph.split_feed)
                 for c in range(calls)]

    env = VecEnv(cfg, n, **kw)
    states, _ = env.reset(seed=7)
    states, kept, secs = run_calls(env, states, acts_list, k, n_ref)
    # steady rate: the calls after the first (which compiles the program)
    steady = secs[1:3]
    rate = n * k * len(steady) / sum(steady)
    print(f"[{ph.name}] envs={n} obs={ph.obs_type} mode={cfg.mode} "
          f"bots={cfg.total_bots} agents={cfg.num_agents} "
          f"setup_s={secs[0]:.1f} (first call: compile + run) "
          f"steady_env_steps_per_s={rate:.1f} "
          f"({len(steady)} calls of k={k}: "
          f"{' '.join(f'{t:.4f}s' for t in steady)})",
          flush=True)
    compiled = env._multi_step.lower(states, jnp.asarray(acts_list[0]),
                                     k).compile()
    print(f"[{ph.name}] {memory_line(compiled)}", flush=True)
    del compiled, states

    with jax.default_device(ref_device):
        ref_env = VecEnv(cfg, n_ref, **kw)
        rstates, _ = ref_env.reset(seed=7)
        ref = run_steps(ref_env, rstates, [a[:n_ref] for a in acts_list], k)

    # 1. the tick: the card's integer state equals the CPU's after every
    # call, and its float state is within atol
    worst = 0.0
    for c, (gs, _) in enumerate(kept):
        worst = max(worst, compare(ref[(c + 1) * k - 1][0], gs,
                                   what=f"[{ph.name}] steps "
                                   f"{c * k + 1}-{(c + 1) * k} state"))
    print(f"[{ph.name}] tick vs {ref_device.platform}: first {n_ref} envs, "
          f"{calls * k} steps ({calls * k * cfg.ticks_per_step} ticks): "
          f"integer state equal; float max |diff| {worst:.3g} <= atol "
          f"{FLOAT_ATOL:g} ({FLOAT_REASON})", flush=True)

    # 2. the emitter: the frames the timed program returned for each
    # call's last step equal the emitter run on the card on the card's
    # states after it, and that emitter equals the CPU's on the same
    # states (integer frames exactly, floats within atol)
    frame_fn, _ = make_obs_fn(cfg, ph.obs_type, ph.obs_config)
    frames = jax.jit(jax.vmap(frame_fn))
    worst_cpu = worst_own = 0.0
    n_own = n_resp = 0
    for c, (gs, (gobs, _, _)) in enumerate(kept):
        what = f"[{ph.name}] frame after step {(c + 1) * k}"
        got = jax.device_get(frames(jax.device_put(gs, dev)))
        cpu = jax.device_get(frames(jax.device_put(gs, ref_device)))
        worst_cpu = max(worst_cpu, compare(cpu, got, what=what))
        keep = ~respawned(gs)
        last = jax.tree.map(lambda x: x[-1, keep, -1], gobs)
        worst_own = max(worst_own, compare(
            jax.tree.map(lambda x: x[keep], got), last,
            what=f"{what} (timed program)"))
        n_own, n_resp = n_own + int(keep.sum()), n_resp + int((~keep).sum())
    print(f"[{ph.name}] timed program's frames after steps "
          f"{', '.join(str((c + 1) * k) for c in range(calls))}: equal to "
          f"the emitter on the card's states in {n_own} env-steps ({n_resp} "
          f"left out: respawned after the frame; float max |diff| "
          f"{worst_own:.3g}); that emitter vs {ref_device.platform} on the "
          f"same states: integer frames equal, float max |diff| "
          f"{worst_cpu:.3g}", flush=True)

    # 3. the step outputs along the two trajectories, every step: dones
    # equal, rewards within atol, and every integer frame element that
    # differs explained by an entity within atol of a bin or pixel edge
    # (positions differ in the last bits; such an entity lands on either
    # side of the edge)
    explained, total = [], 0
    for t, (rs, (robs, rrew, rdone)) in enumerate(ref):
        gobs, grew, gdone = jax.tree.map(lambda x: x[t % k],
                                         kept[t // k][1])
        compare((rrew, rdone), (grew, gdone),
                what=f"[{ph.name}] step {t + 1} (rewards, dones)")
        with jax.default_device(ref_device):
            lines, n_el = explain_frame_differences(ph, t + 1, rs, robs,
                                                    gobs)
        explained += lines
        total += n_el
    for line in explained:
        print(line, flush=True)
    print(f"[{ph.name}] step outputs, {calls * k} steps: dones equal, "
          f"rewards within atol; integer frame elements differing between "
          f"the two trajectories: {len(explained)} of {total}, each by an "
          f"entity within {FLOAT_ATOL:g} of a bin or pixel edge", flush=True)


def load_train_ppo():
    path = os.path.join(REPO, "examples", "train_ppo.py")
    spec = importlib.util.spec_from_file_location("train_ppo", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_ppo_phase(num_envs: int = 4096, iters: int = 3,
                  rollout: int = 16):
    """examples/train_ppo.py's make_train at bench.py's configuration.
    The MLP's f32 matmuls may run in TF32 on the card, so the check is
    finiteness and a parameter update, not agreement with the CPU."""
    from agarcl_tpu.env import env_reset
    from agarcl_tpu.obs.ram import RamObsConfig
    tp = load_train_ppo()
    cfg = bench_config()
    init, train_iter, frame_fn = tp.make_train(cfg, RamObsConfig(), num_envs,
                                               rollout, 3e-4)
    params, opt_state = init(jax.random.PRNGKey(0))
    p0 = jax.tree.map(np.asarray, params)
    states = jax.jit(jax.vmap(lambda s: env_reset(cfg, s)))(
        jnp.arange(num_envs, dtype=jnp.uint32))
    obs = jax.jit(jax.vmap(frame_fn))(states)
    key = jax.random.PRNGKey(1)
    secs, losses = [], []
    for _ in range(iters):
        t0 = time.perf_counter()
        params, opt_state, states, obs, key, loss, mr = train_iter(
            params, opt_state, states, obs, key)
        losses.append(float(loss))
        secs.append(time.perf_counter() - t0)
    assert all(np.isfinite(losses)), losses
    changed = any(not np.array_equal(a, np.asarray(b)) for a, b in
                  zip(jax.tree.leaves(p0), jax.tree.leaves(params)))
    assert changed, "PPO update left every parameter unchanged"
    assert all(np.isfinite(np.asarray(x)).all()
               for x in jax.tree.leaves(params)), "non-finite parameters"
    steady = secs[1:]
    rate = num_envs * rollout * len(steady) / sum(steady)
    print(f"[ppo] envs={num_envs} rollout={rollout} iters={iters} "
          f"first_iter_s={secs[0]:.1f} (compile + run) "
          f"steady_env_steps_per_s={rate:.1f} losses={losses} "
          f"params changed, all finite (compared for finiteness only: "
          f"the MLP matmuls may run in TF32 on the card)", flush=True)


def run_sharded_phase(devices, envs_per_card: int = 8192, steps: int = 5,
                      n_check: int = 8):
    """ShardedVecEnv over the given devices vs a one-device VecEnv of the
    same total size, from the same seeds and actions."""
    cfg = bench_config()
    nd = len(devices)
    n = nd * envs_per_card
    mesh = make_env_mesh(devices)
    acts_list = [make_actions(2000 + s, n, 1, False) for s in range(steps)]

    senv = ShardedVecEnv(cfg, n, mesh, obs_type="ram")
    sstates = senv.reset(seed=7)
    t0 = time.perf_counter()
    for acts in acts_list:
        sstates, sobs, srew, sdone = senv.step(sstates, acts)
    jax.block_until_ready((sstates, sobs, srew))
    sharded_s = time.perf_counter() - t0
    shard_devs = {s.device for s in sstates.cell_pos.addressable_shards}
    assert len(shard_devs) == nd, f"state spans {len(shard_devs)} devices"

    def shard_heads(tree):
        return [jax.tree.map(lambda x: np.asarray(
            x[d * envs_per_card:d * envs_per_card + n_check]), tree)
            for d in range(nd)]
    got = shard_heads((sstates, sobs, srew, sdone))
    for d in devices:
        st = d.memory_stats() or {}
        print(f"[sharded] {d} peak_bytes_in_use="
              f"{st.get('peak_bytes_in_use', 'n/a')} bytes_in_use="
              f"{st.get('bytes_in_use', 'n/a')}", flush=True)
    del sstates, sobs

    with jax.default_device(devices[0]):
        env = VecEnv(cfg, n, obs_type="ram")
        states, _ = env.reset(seed=7)
        for acts in acts_list:
            states, obs, rew, done = env.step(states, acts)
        ref = shard_heads((states, obs, rew, done))
    worst = 0.0
    for d in range(nd):
        worst = max(worst, compare(ref[d], got[d], what=f"[sharded] shard {d} "))
    print(f"[sharded] devices={nd} envs={n} ({envs_per_card} per device) "
          f"steps={steps} sharded_s={sharded_s:.1f} (incl. compile); "
          f"first {n_check} envs of every shard vs one-device VecEnv: "
          f"integer/bool leaves equal; float max |diff| {worst:.3g}",
          flush=True)


# ------------------------------------------------------------------- main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4 runs the sharded four-card path and nothing "
                         "else")
    args = ap.parse_args(argv)

    dev = require_gpu()
    cache_dir = enable_compile_cache()
    print(f"gpu: {gpu_name_and_power_limit()}", flush=True)
    print(f"jax {jax.__version__} devices={len(jax.devices())} "
          f"kind={dev.device_kind} JAX_PLATFORMS="
          f"{os.environ.get('JAX_PLATFORMS')!r} XLA_FLAGS="
          f"{os.environ.get('XLA_FLAGS')!r} compile_cache={cache_dir}",
          flush=True)

    if args.cards == 4:
        devices = jax.devices()[:4]
        assert len(devices) == 4, f"--cards 4 found {len(jax.devices())}"
        run_sharded_phase(devices)
        print(result_line(dev.platform, dev.device_kind, len(devices)))
        return 0

    cpu = jax.devices("cpu")[0]
    for ph in env_phases().values():
        t0 = time.perf_counter()
        run_env_phase(ph, cpu)
        print(f"[{ph.name}] phase_s={time.perf_counter() - t0:.1f}",
              flush=True)
    t0 = time.perf_counter()
    run_ppo_phase()
    print(f"[ppo] phase_s={time.perf_counter() - t0:.1f}", flush=True)
    print(result_line(dev.platform, dev.device_kind, 1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
