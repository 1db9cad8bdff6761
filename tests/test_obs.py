"""Observation-module tests: shapes, channel semantics, view windows —
modeled on the reference's observation-shape matrix tests
(/root/reference/environment/test/grid-env-test.hpp:43-87) plus semantic
checks the reference never had."""

import jax.numpy as jnp
import dataclasses

import numpy as np
import pytest

from agarcl_tpu import EnvConfig
from agarcl_tpu.obs.grid import GridObsConfig, grid_frame
from agarcl_tpu.obs.ram import RamObsConfig, ram_frame, ram_size
from agarcl_tpu.obs.screen import ScreenObsConfig, screen_frame
from agarcl_tpu.obs.gobigger import (GoBiggerObsConfig, gobigger_frame,
                                     to_player_states)

from tests.helpers import BASE, reset


@pytest.mark.parametrize("flags", [
    (True, True, True, True),
    (True, False, False, False),
    (False, False, False, True),
    (False, False, False, False),
])
def test_grid_channel_count(flags):
    cells, others, viruses, pellets = flags
    ocfg = GridObsConfig(grid_size=16, observe_cells=cells,
                         observe_others=others, observe_viruses=viruses,
                         observe_pellets=pellets)
    expected = 1 + cells + 2 * others + 2 * viruses + 2 * pellets
    assert ocfg.channels_per_frame == expected
    s = reset(BASE, 0)
    obs = grid_frame(BASE, ocfg, s)
    assert obs.shape == (1, expected, 16, 16)
    assert obs.dtype == jnp.int16   # saturating contract default
    assert grid_frame(BASE, dataclasses.replace(ocfg, out_dtype="int32"),
                      s).dtype == jnp.int32


def test_grid_oob_channel():
    """Channel 0 marks out-of-arena bins with -1 (GridEnvironment.hpp:240-248).
    An agent in the corner sees OOB; view 100 >> arena margin."""
    s = reset(BASE, 0)
    s = s.replace(cell_pos=s.cell_pos.at[0, 0].set(jnp.array([1.0, 1.0])))
    obs = np.asarray(grid_frame(BASE, GridObsConfig(grid_size=16), s))[0]
    assert (obs[0] == -1).any()
    assert (obs[0] == 0).any()
    # center of the grid is the player's position: in bounds
    assert obs[0, 8, 8] == 0


def test_grid_pellet_channels():
    s = reset(BASE, 0)
    pos = jnp.array([50.0, 50.0])
    # all pellets on one spot 10 units right of the player
    from agarcl_tpu.state import encode_pellet_key
    s = s.replace(
        cell_pos=s.cell_pos.at[0, 0].set(pos),
        pellet_key=encode_pellet_key(
            BASE, jnp.broadcast_to(pos + jnp.array([10.0, 0.0]),
                                   s.pellet_key.shape + (2,)),
            s.pellet_alive),
        virus_alive=jnp.zeros_like(s.virus_alive))
    ocfg = GridObsConfig(grid_size=16, observe_others=False,
                         observe_viruses=False, observe_cells=False)
    obs = np.asarray(grid_frame(BASE, ocfg, s))[0]
    presence, total = obs[1], obs[2]
    # view = clamp(2*25,100,300) = 100; dx=10 -> bin trunc(16*10/100+8)=9
    assert presence[9, 8] == 1
    assert total[9, 8] == 50          # all 50 pellets stacked
    assert presence.sum() == 1
    assert total.sum() == 50


def test_ram_obs_shape_and_content():
    ocfg = RamObsConfig()
    s = reset(BASE, 3)
    obs = np.asarray(ram_frame(BASE, ocfg, s))
    assert obs.shape == (1, ram_size(BASE, ocfg))
    assert np.isfinite(obs).all()
    # mass feature present
    assert (obs == 25.0).any()


def test_screen_frame_shapes():
    s = reset(BASE, 1)
    for agent_view, ch in ((True, 4), (False, 3)):
        ocfg = ScreenObsConfig(screen_len=32, agent_view=agent_view)
        obs = np.asarray(screen_frame(BASE, ocfg, s))
        assert obs.shape == (1, 32, 32, ch)
        assert obs.dtype == np.uint8


def test_screen_agent_view_semantics():
    s = reset(BASE, 1)
    pos = jnp.array([50.0, 50.0])
    s = s.replace(
        cell_pos=s.cell_pos.at[0, 0].set(pos),
        virus_pos=s.virus_pos.at[0].set(pos + jnp.array([15.0, 0.0])),
        virus_alive=jnp.zeros_like(s.virus_alive).at[0].set(True))
    obs = np.asarray(screen_frame(BASE, ScreenObsConfig(
        screen_len=64, agent_view=True), s))[0]
    assert (obs[..., 3] == 230).any()      # main player
    assert (obs[..., 2] == 255).any()      # virus
    assert (obs[..., 3] == 26).any()       # grid lines


def test_gobigger_structured_obs():
    s = reset(BASE, 2)
    pos = jnp.array([50.0, 50.0])
    s = s.replace(cell_pos=s.cell_pos.at[0, 0].set(pos))
    ocfg = GoBiggerObsConfig()
    frame = gobigger_frame(BASE, ocfg, s)
    assert frame["foods"].shape[0] == 1
    gs, players = to_player_states(BASE, ocfg, frame)
    ps = players[0]
    assert ps.score == 25.0
    assert len(ps.clone_infos) == 1
    clone = ps.clone_infos[0]
    assert abs(clone.position[0]) < 1e-3   # own cell at own centroid
    assert clone.score == 25.0
    # pellets within the 100-unit view window appear as foods
    ppos = np.asarray(s.pellet_xy_alive(BASE)[0])
    in_view = (np.abs(ppos - np.asarray(pos)) < 50.0).all(axis=1)
    assert len(ps.food_infos) >= max(0, in_view.sum() - 2)
    assert gs.team_num == 1


def test_gobigger_vecenv_batched():
    """VecEnv(obs_type='gobigger'): the structured dict frame vmaps over the
    env axis and each env's slice converts through the host rim
    (GoBiggerEnvironment.hpp:446-548 semantics, batched)."""
    from agarcl_tpu.obs.gobigger import batch_player_states
    from agarcl_tpu.vec import VecEnv

    ocfg = GoBiggerObsConfig()
    env = VecEnv(BASE, 4, obs_type="gobigger", obs_config=ocfg)
    states, obs = env.reset(5)
    assert obs["foods"].shape[:2] == (4, 1)          # (N, A, K, F)
    actions = np.zeros((4, 1, 3), np.float32)
    actions[:, :, :2] = 0.5
    states, obs, rewards, dones = env.step(states, actions)
    assert obs["clones"].shape[0] == 4
    assert rewards.shape == (4, 1)
    # per-env rim conversion matches the single-env converter
    for e in range(4):
        gs, players = batch_player_states(BASE, ocfg, obs, e)
        assert players[0].score >= 25.0
        assert len(players[0].clone_infos) >= 1
    # envs were seeded differently -> frames differ across the batch
    f = np.asarray(obs["foods_mask"])
    assert not (f[0] == f[1]).all() or not (f[0] == f[2]).all()
    # multi_step stacks the dict obs per step
    states, obs, rewards, dones = env.multi_step(states, actions, 3)
    assert obs["foods"].shape[:3] == (3, 4, 1)


def test_grid_rasterizer_matches_numpy_scatter():
    """The matmul/unroll rasterizer must agree bin-for-bin with a scalar
    numpy scatter implementing GridEnvironment.hpp:251-279 semantics
    (trunc binning; add / max / min-with-0-for-empty per channel)."""
    cfg = EnvConfig(num_agents=2, ticks_per_step=2, arena_size=100,
                    num_pellets=40, num_viruses=5, num_bots=2, mode=0)
    G = 32
    ocfg = GridObsConfig(grid_size=G)
    s = reset(cfg, seed=11)
    # make some cells/viruses share bins to exercise max/min tie paths
    s = s.replace(cell_mass=s.cell_mass.at[1, 0].set(77))
    got = np.asarray(grid_frame(cfg, ocfg, s))

    centroid = np.asarray(s.player_centroid())
    pmass = np.asarray(s.player_mass()).astype(np.float64)
    for a in range(cfg.num_agents):
        view = float(np.clip(2.0 * pmass[a], 100.0, 300.0))

        def bins(pos, alive):
            out = []
            for i in range(pos.shape[0]):
                if not alive[i]:
                    continue
                gx = int(np.trunc(G * (pos[i, 0] - centroid[a, 0]) / view
                                  + G / 2.0))
                gy = int(np.trunc(G * (pos[i, 1] - centroid[a, 1]) / view
                                  + G / 2.0))
                if 0 <= gx < G and 0 <= gy < G:
                    out.append((gx, gy, i))
            return out

        ppos_j, palive_j = s.pellet_xy_alive(cfg)
        ppos = np.asarray(ppos_j); palive = np.asarray(palive_j)
        add = np.zeros((G, G), np.int64)
        for gx, gy, _ in bins(ppos, palive):
            add[gx, gy] += 1
        np.testing.assert_array_equal(got[a, 1], np.minimum(add, 1))
        np.testing.assert_array_equal(got[a, 2], add)

        vpos = np.asarray(s.virus_pos); valive = np.asarray(s.virus_alive)
        vmass = np.asarray(s.virus_mass)
        vmax = np.zeros((G, G), np.int64)
        vadd = np.zeros((G, G), np.int64)
        for gx, gy, i in bins(vpos, valive):
            vmax[gx, gy] = max(vmax[gx, gy], vmass[i])
            vadd[gx, gy] += vmass[i]
        np.testing.assert_array_equal(got[a, 3], vmax)
        np.testing.assert_array_equal(got[a, 4], vadd)

        P, Cc = np.asarray(s.cell_mass).shape
        cpos = np.asarray(s.cell_pos).reshape(P * Cc, 2)
        cmass = np.asarray(s.cell_mass).reshape(P * Cc)
        calive = np.asarray(s.cell_alive).reshape(P * Cc)
        owner = np.repeat(np.arange(P), Cc)
        own = np.zeros((G, G), np.int64)
        for gx, gy, i in bins(cpos, calive & (owner == a)):
            own[gx, gy] += cmass[i]
        np.testing.assert_array_equal(got[a, 5], own)
        omin = np.full((G, G), 2**30, np.int64)
        omax = np.zeros((G, G), np.int64)
        for gx, gy, i in bins(cpos, calive & (owner != a)):
            omin[gx, gy] = min(omin[gx, gy], cmass[i])
            omax[gx, gy] = max(omax[gx, gy], cmass[i])
        omin[omin == 2**30] = 0
        np.testing.assert_array_equal(got[a, 6], omin)
        np.testing.assert_array_equal(got[a, 7], omax)


def test_screen_multi_agent():
    """screen_frame for num_agents > 1: the grid-line coverage broadcast
    used to raise for A=2 (on_v lacked its row axis); each agent renders
    from its own centroid."""
    cfg = EnvConfig(num_agents=2, ticks_per_step=2, arena_size=100,
                    num_pellets=30, num_viruses=2, num_bots=0, mode=3)
    s = reset(cfg, seed=4)
    ocfg = ScreenObsConfig(screen_len=32, agent_view=True)
    f = np.asarray(screen_frame(cfg, ocfg, s))
    assert f.shape == (2, 32, 32, 4)
    # each agent sees itself (alpha-230 main-player pixels)
    assert (f[0, :, :, 3] == 230).any()
    assert (f[1, :, :, 3] == 230).any()
    # and sees the other agent only if in view; frames differ
    assert not np.array_equal(f[0], f[1])




# ---------------------------------------------------------------------------
# grid_frame and ram_frame against scalar numpy references
# ---------------------------------------------------------------------------

def numpy_grid(cfg, ocfg, state):
    """(A, C, G, G) int64 grid frame by per-entity scatter
    (GridEnvironment.hpp:240-279: trunc binning; add / max /
    min-with-0-for-empty per channel), binning the f32 offset
    2G * (pos - centroid) exactly in float64. Unclipped."""
    f32 = np.float32
    G = ocfg.grid_size
    A = cfg.num_agents
    centroid = np.asarray(state.player_centroid(), f32)
    pmass = np.asarray(state.player_mass()).astype(f32)
    P, Cc = np.asarray(state.cell_mass).shape
    cpos = np.asarray(state.cell_pos, f32).reshape(P * Cc, 2)
    cmass = np.asarray(state.cell_mass).reshape(P * Cc).astype(np.int64)
    calive = np.asarray(state.cell_alive).reshape(P * Cc)
    owner = np.repeat(np.arange(P), Cc)
    ppos, palive = (np.asarray(x) for x in state.pellet_xy_alive(cfg))
    vpos = np.asarray(state.virus_pos, f32)
    valive = np.asarray(state.virus_alive)
    vmass = np.asarray(state.virus_mass).astype(np.int64)
    out = []
    for a in range(A):
        view = f32(np.clip(f32(2.0) * pmass[a], f32(100.0), f32(300.0)))
        c = centroid[a]

        def scatter(pos, alive, vals, op):
            grid = np.zeros((G, G), np.int64)
            hit = np.zeros((G, G), bool)
            for i in np.flatnonzero(alive):
                s = f32(2 * G) * (pos[i].astype(f32) - c)
                g = np.trunc(s.astype(np.float64) / (2.0 * float(view))
                             + G / 2.0)
                gx, gy = int(g[0]), int(g[1])
                if not (0 <= gx < G and 0 <= gy < G):
                    continue
                v = vals[i]
                if op == "add":
                    grid[gx, gy] += v
                elif not hit[gx, gy]:
                    grid[gx, gy] = v
                else:
                    grid[gx, gy] = (max if op == "max" else min)(
                        grid[gx, gy], v)
                hit[gx, gy] = True
            return grid

        ij = np.arange(G, dtype=f32)
        off = (ij - f32(G / 2.0)) * view * f32(1.0 / G)
        wx, wy = c[0] + off, c[1] + off
        inb = (((wx >= 0) & (wx < cfg.arena_width))[:, None]
               & ((wy >= 0) & (wy < cfg.arena_height))[None, :])
        chans = [np.where(inb, 0, -1)]
        if ocfg.observe_pellets:
            count = scatter(ppos, palive, np.ones(len(ppos), np.int64), "add")
            chans += [np.minimum(count, 1), count]
        if ocfg.observe_viruses:
            chans += [scatter(vpos, valive, vmass, "max"),
                      scatter(vpos, valive, vmass, "add")]
        if ocfg.observe_cells:
            chans.append(scatter(cpos, calive & (owner == a), cmass, "add"))
        if ocfg.observe_others:
            others = calive & (owner != a)
            chans += [scatter(cpos, others, cmass, "min"),
                      scatter(cpos, others, cmass, "max")]
        out.append(np.stack(chans))
    return np.stack(out)


def clipped(frame, dtype):
    info = np.iinfo(dtype)
    return np.clip(frame, info.min, info.max).astype(dtype)


def played(cfg, seed, steps):
    from tests.helpers import step_fn
    s = reset(cfg, seed)
    rng = np.random.default_rng(seed)
    for t in range(steps):
        acts = np.zeros((cfg.num_agents, 3), np.float32)
        acts[:, :2] = rng.uniform(-1, 1, (cfg.num_agents, 2))
        acts[:, 2] = rng.integers(0, 3, cfg.num_agents)
        s, _, _ = step_fn(cfg)(s, jnp.asarray(acts))
    return s


SINGLE = EnvConfig(num_agents=1, ticks_per_step=4, arena_size=120,
                   num_pellets=100, num_viruses=4, num_bots=0, mode=4)
MULTI = EnvConfig(num_agents=2, ticks_per_step=4, arena_size=120,
                  num_pellets=60, num_viruses=4, num_bots=1, mode=7)


@pytest.mark.parametrize("dtype", ["int32", "int16", "int8"])
@pytest.mark.parametrize("cfg", [SINGLE, MULTI], ids=["single", "multi"])
def test_grid_frame_matches_numpy(cfg, dtype):
    """Played states (splits, feeds, a bot) bin-for-bin, per agent, in
    every output dtype (int16/int8 saturate, never wrap)."""
    s = played(cfg, 13, 6)
    ocfg = GridObsConfig(grid_size=32, out_dtype=dtype)
    got = np.asarray(grid_frame(cfg, ocfg, s))
    assert got.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(got, clipped(numpy_grid(cfg, ocfg, s),
                                               dtype))
    if cfg.num_agents > 1:          # each agent has its own view
        assert not np.array_equal(got[0], got[1])


def test_grid_frame_stacking_matches_numpy():
    """num_frames=2 through env_step: the last two ticks each give a
    frame (GridEnvironment.hpp:425-431)."""
    import functools

    import jax

    from agarcl_tpu import apply_actions, env_step
    from tests.helpers import tick_fn
    ocfg = GridObsConfig(grid_size=32, num_frames=2, out_dtype="int32")
    s0 = played(SINGLE, 9, 2)
    acts = jnp.asarray([[0.7, -0.2, 0.0]], jnp.float32)
    _, obs, _, _ = jax.jit(functools.partial(
        env_step, SINGLE, obs_fn=functools.partial(grid_frame, SINGLE, ocfg),
        num_frames=2))(s0, acts)
    s = apply_actions(SINGLE, s0, acts)
    frames = []
    for _ in range(SINGLE.ticks_per_step):
        s = tick_fn(SINGLE)(s)
        frames.append(numpy_grid(SINGLE, ocfg, s))
    obs = np.asarray(obs)
    assert obs.shape[0] == 2
    np.testing.assert_array_equal(obs, np.stack(frames[-2:]))
    assert (obs[0] != obs[1]).any()


def test_grid_bin_collisions_match_numpy():
    """Two viruses, and two of the bot's cells, forced into one bin:
    max != sum and min != max where a bin holds two entities."""
    s = reset(MULTI, 3)
    c = s.player_centroid()[0]
    s = s.replace(
        virus_pos=s.virus_pos.at[0].set(c + 10.0).at[1].set(c + 10.2),
        virus_alive=s.virus_alive.at[:2].set(True),
        virus_mass=s.virus_mass.at[0].set(120).at[1].set(180),
        cell_pos=s.cell_pos.at[2, 0].set(c - 8.0).at[2, 1].set(c - 8.3),
        cell_alive=s.cell_alive.at[2, :2].set(True),
        cell_mass=s.cell_mass.at[2, 0].set(40).at[2, 1].set(90))
    ocfg = GridObsConfig(grid_size=32, out_dtype="int32")
    got = np.asarray(grid_frame(MULTI, ocfg, s))
    np.testing.assert_array_equal(got, numpy_grid(MULTI, ocfg, s))
    assert (got[0, 3] != got[0, 4]).any()          # virus max vs sum
    assert (got[0, -2] != got[0, -1]).any()        # others min vs max


@pytest.mark.parametrize("dtype", ["int16", "int8"])
def test_grid_saturation_matches_numpy(dtype):
    """Two co-binned 20k-mass cells: the own-mass bin exceeds int16 and
    clamps at the dtype's max."""
    s = reset(SINGLE, 13)
    c = s.player_centroid()[0]
    s = s.replace(
        cell_pos=s.cell_pos.at[0, 0].set(c + 5.0).at[0, 1].set(c + 5.0),
        cell_alive=s.cell_alive.at[0, 1].set(True),
        cell_mass=s.cell_mass.at[0, 0].set(20000).at[0, 1].set(20000))
    ocfg = GridObsConfig(grid_size=32, out_dtype=dtype)
    ref = numpy_grid(SINGLE, ocfg, s)
    got = np.asarray(grid_frame(SINGLE, ocfg, s))
    np.testing.assert_array_equal(got, clipped(ref, dtype))
    assert (ref > np.iinfo(dtype).max).any()
    assert (got == np.iinfo(dtype).max).any()


def round_mantissa(x, bits):
    """f32 rounded to `bits` explicit mantissa bits, to nearest even."""
    u = np.asarray(x, np.float32).view(np.uint32)
    drop = 23 - bits
    lsb = (u >> np.uint32(drop)) & np.uint32(1)
    u = (u + np.uint32((1 << (drop - 1)) - 1) + lsb) & np.uint32(
        0xFFFFFFFF ^ ((1 << drop) - 1))
    return u.view(np.float32)


def numpy_ram(cfg, ocfg, state):
    """(A, ram_size) f32 ram frame: own cells, k nearest pellets and
    viruses by the packed (squared distance, index) key, all players."""
    from agarcl_tpu.obs.ram import key_index_bits
    f32 = np.float32
    A, P = cfg.num_agents, cfg.num_players
    centroid = np.asarray(state.player_centroid(), f32)
    pmass = np.asarray(state.player_mass()).astype(f32)
    palive = np.asarray(state.player_alive())
    ppos, pal = (np.asarray(x) for x in state.pellet_xy_alive(cfg))
    out = []
    for a in range(A):
        me = centroid[a]
        feats = [me / f32([cfg.arena_width, cfg.arena_height]), [pmass[a]]]
        alive = np.asarray(state.cell_alive[a]).astype(f32)[:, None]
        rel = (np.asarray(state.cell_pos[a], f32) - me) * alive
        feats.append(np.concatenate(
            [rel, np.asarray(state.cell_mass[a], f32)[:, None] * alive,
             np.asarray(state.cell_vel[a], f32) * alive, alive], 1).ravel())

        def nearest(pos, live, k, extra=None):
            n = len(pos)
            rel = pos.astype(f32) - me
            q = round_mantissa(rel, 11)
            d2 = (q[:, 0] * q[:, 0] + q[:, 1] * q[:, 1]).astype(f32)
            b = key_index_bits(n)
            key = (d2.view(np.int32) & np.int32(-1 << b)) | np.arange(
                n, dtype=np.int32)
            key = np.where(live, key, 0x7FFFFFFF)
            rows = []
            for i in np.argsort(key, kind="stable")[:k]:
                ok = f32(key[i] != 0x7FFFFFFF)
                row = list(rel[i] * ok)
                if extra is not None:
                    row.append(f32(extra[i]) * ok)
                rows.append(row + [ok])
            return np.asarray(rows, f32).ravel()

        feats.append(nearest(ppos, pal, min(ocfg.num_pellets,
                                             cfg.pellet_capacity)))
        feats.append(nearest(np.asarray(state.virus_pos),
                             np.asarray(state.virus_alive),
                             min(ocfg.num_viruses, cfg.virus_capacity),
                             extra=np.asarray(state.virus_mass)))
        keep = (palive & (np.arange(P) != a)).astype(f32)[:, None]
        feats.append((np.concatenate(
            [centroid - me, pmass[:, None], np.ones((P, 1), f32)], 1)
            * keep).ravel())
        out.append(np.concatenate([np.asarray(f, f32).ravel()
                                   for f in feats]))
    return np.stack(out)


@pytest.mark.parametrize("cfg", [SINGLE, MULTI], ids=["single", "multi"])
def test_ram_frame_matches_numpy(cfg):
    """Nearest-k pellets and viruses, own cells and the other-player
    block after play with splits and eaten pellets."""
    s = played(cfg, 5, 4)
    ocfg = RamObsConfig()
    got = np.asarray(ram_frame(cfg, ocfg, s))
    assert got.shape == (cfg.num_agents, ram_size(cfg, ocfg))
    np.testing.assert_allclose(got, numpy_ram(cfg, ocfg, s), rtol=1e-6,
                               atol=1e-4)
