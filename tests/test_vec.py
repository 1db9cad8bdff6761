"""VecEnv and ShardedVecEnv: the batched paths users call, against the
unbatched env step and against each other."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from agarcl_tpu import EnvConfig, env_reset, env_step
from agarcl_tpu.obs.grid import GridObsConfig
from agarcl_tpu.obs.screen import ScreenObsConfig
from agarcl_tpu.parallel import ShardedVecEnv, make_env_mesh
from agarcl_tpu.vec import VecEnv, make_obs_fn

INT_FIELDS = ("cell_mass", "cell_alive", "cell_id", "cell_recombine_at",
              "pellet_key", "virus_alive", "virus_mass", "virus_hits",
              "food_alive", "food_eaten", "highest_mass", "viruses_eaten",
              "elapsed_ticks", "last_decay_tick", "split_cooldown",
              "feed_cooldown", "ticks", "next_cell_id", "food_next",
              "virus_eaten_ptr")
F32_FIELDS = ("cell_pos", "cell_vel", "cell_split_vel",
              "virus_pos", "food_pos", "food_vel", "anti_team_decay")


def compare(ref, out, t):
    for f in INT_FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(ref, f)), np.asarray(getattr(out, f)),
            err_msg=f"{f} mismatch at tick {t}")
    for f in F32_FIELDS:
        np.testing.assert_allclose(
            np.asarray(getattr(ref, f)), np.asarray(getattr(out, f)),
            atol=2e-3, err_msg=f"{f} mismatch at tick {t}")


def test_multi_step_returns_obs():
    """VecEnv.multi_step stacks a per-step observation (never dead-coded)."""
    cfg = EnvConfig(num_agents=1, ticks_per_step=2, arena_size=80,
                    num_pellets=20, num_viruses=0, num_bots=0, mode=4)
    env = VecEnv(cfg, 4, obs_type="ram", donate=False)
    states, obs0 = env.reset(0)
    acts = jnp.zeros((4, 1, 3), jnp.float32)
    states, obs, r, d = env.multi_step(states, acts, 3)
    assert obs.shape[:2] == (3, 4)
    assert r.shape == (3, 4, 1) and d.shape == (3, 4, 1)
    assert np.all(np.isfinite(np.asarray(obs)))


def test_multi_step_matches_stepwise():
    """multi_step's stacked obs/rewards/dones must equal k sequential
    step() calls exactly (lax.scan is a pure restacking of the per-step
    results)."""
    cfg = EnvConfig(num_agents=1, ticks_per_step=2, arena_size=80,
                    num_pellets=20, num_viruses=2, num_bots=0, mode=4)
    acts = jnp.zeros((4, 1, 3), jnp.float32).at[..., 0].set(0.5)
    env = VecEnv(cfg, 4, obs_type="ram", donate=False)
    st, _ = env.reset(3)
    st_scan, obs_scan, r_scan, d_scan = env.multi_step(st, acts, 3)
    st2, _ = env.reset(3)
    obs_l, r_l, d_l = [], [], []
    for _ in range(3):
        st2, o, r, d = env.step(st2, acts)
        obs_l.append(o)
        r_l.append(r)
        d_l.append(d)
    np.testing.assert_array_equal(np.asarray(obs_scan),
                                  np.asarray(jnp.stack(obs_l)))
    np.testing.assert_array_equal(np.asarray(r_scan),
                                  np.asarray(jnp.stack(r_l)))
    np.testing.assert_array_equal(np.asarray(d_scan),
                                  np.asarray(jnp.stack(d_l)))
    compare(st_scan, st2, "multi-step-scan")


SMALL = EnvConfig(num_agents=1, ticks_per_step=2, arena_size=100,
                  num_pellets=40, num_viruses=2, num_bots=0, mode=4)
OBS_CONFIGS = {
    "grid": GridObsConfig(grid_size=16, out_dtype="int32"),
    "screen": ScreenObsConfig(screen_len=24, agent_view=True),
    "gobigger": None,
    "none": None,
}


@pytest.mark.parametrize("obs_type", list(OBS_CONFIGS))
def test_multi_step_matches_stepwise_obs(obs_type):
    """The same restacking for every other observation type, with splits
    and feeds in the actions."""
    acts = jnp.tile(jnp.asarray([[0.6, -0.4, 2.0]], jnp.float32), (3, 1, 1))
    env = VecEnv(SMALL, 3, obs_type=obs_type,
                 obs_config=OBS_CONFIGS[obs_type], donate=False)
    st, _ = env.reset(5)
    st_scan, obs_scan, r_scan, d_scan = env.multi_step(st, acts, 3)
    steps = []
    for _ in range(3):
        st, o, r, d = env.step(st, acts)
        steps.append((o, r, d))
    stacked = jax.tree.map(lambda *x: jnp.stack(x), *steps)
    if obs_type == "none":
        assert obs_scan is None and steps[0][0] is None
    for a, b in zip(jax.tree.leaves((obs_scan, r_scan, d_scan)),
                    jax.tree.leaves(stacked)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    compare(st_scan, st, obs_type)


@pytest.mark.parametrize("n", [1, 3, 5, 7])
def test_odd_env_counts(n):
    """Any env count: each env of the batch equals the unbatched env step
    from its own seed."""
    env = VecEnv(SMALL, n, obs_type="grid", obs_config=OBS_CONFIGS["grid"],
                 donate=False)
    states, obs0 = env.reset(2)
    acts = np.tile(np.asarray([[0.5, 0.5, 0.0]], np.float32), (n, 1, 1))
    states, obs, r, d = env.multi_step(states, acts, 2)
    assert obs.shape[:2] == (2, n) and r.shape == (2, n, 1)
    fn, nf = make_obs_fn(SMALL, "grid", OBS_CONFIGS["grid"])
    step1 = jax.jit(functools.partial(env_step, SMALL, obs_fn=fn,
                                      num_frames=nf))
    seeds = np.arange(n, dtype=np.uint32) + np.uint32(
        (2 * 0x9E3779B9) & 0xFFFFFFFF)
    for e in (0, n - 1):
        s = env_reset(SMALL, seeds[e])
        for t in range(2):
            s, o, _, _ = step1(s, acts[e])
            np.testing.assert_array_equal(np.asarray(obs[t, e]),
                                          np.asarray(o))
        compare(jax.tree.map(lambda x: x[e], states), s, f"env {e}")


@pytest.mark.parametrize("obs_type", ["grid", "screen"])
def test_sharded_matches_unsharded_obs(obs_type):
    """ShardedVecEnv on the 8-device CPU mesh == the one-device VecEnv
    from the same seeds: integer state and integer frames exactly."""
    n = 16
    mesh = make_env_mesh()
    senv = ShardedVecEnv(SMALL, n, mesh, obs_type=obs_type,
                         obs_config=OBS_CONFIGS[obs_type])
    env = VecEnv(SMALL, n, obs_type=obs_type,
                 obs_config=OBS_CONFIGS[obs_type], donate=False)
    acts = np.tile(np.asarray([[0.4, -0.2, 0.0]], np.float32), (n, 1, 1))
    sstates = senv.reset(3)
    ustates, _ = env.reset(3)
    for t in range(2):
        sstates, sobs, sr, _ = senv.step(sstates, acts)
        ustates, uobs, ur, _ = env.step(ustates, acts)
        np.testing.assert_array_equal(np.asarray(sobs), np.asarray(uobs))
        np.testing.assert_allclose(np.asarray(sr), np.asarray(ur), atol=1e-5)
    assert len({s.device for s in sobs.addressable_shards}) == 8
    compare(ustates, sstates, obs_type)
