"""Scalar-numpy reference rasterizer for the screen observation.

Pins the pixel semantics of obs/screen.py (the analytic replacement for the
reference's GL render path: renderer.hpp:91-155, ScreenEnvironment.hpp:48-88,
FrameBufferObject.hpp:187) with an independent numpy implementation that
loops over entities — the ground truth the fast rasterizer must match
pixel-for-pixel (VERDICT round-1 item 1 step 1; analogous to the grid
rasterizer's scatter oracle in test_obs.py).

All arithmetic is float32 with the same operation order as screen.py
(dx*dx <= r*r - dy*dy), so agreement is required to be exact, not approx.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from agarcl_tpu import EnvConfig, env_reset, env_step
from agarcl_tpu.engine import geometry as G
from agarcl_tpu.obs.screen import (ScreenObsConfig, _AGENT_VIEW_COLORS,
                                   _NATURAL_COLORS, _class_map, _rgb565,
                                   screen_frame)

F = np.float32
TAN_HALF = F(math.tan(math.radians(22.5)))


def numpy_class_map(cfg, state, S):
    """(A, S, S) int32 class map: 0 bg, 1 grid, 2 pellet, 3 food, 4 main,
    5 other, 6 virus; topmost in draw order wins."""
    ppos, palv = state.pellet_xy_alive(cfg)
    s = {k: np.asarray(v) for k, v in
         dict(cell_pos=state.cell_pos, cell_mass=state.cell_mass,
              cell_alive=state.cell_alive, pellet_pos=ppos,
              pellet_alive=palv, virus_pos=state.virus_pos,
              virus_mass=state.virus_mass, virus_alive=state.virus_alive,
              food_pos=state.food_pos, food_alive=state.food_alive).items()}
    A = cfg.num_agents
    P, Cc = s["cell_mass"].shape
    out = np.zeros((A, S, S), np.int32)

    def radius(m):
        return np.float32(np.asarray(G.radius(jnp.float32(m))))

    centroid = np.asarray(state.player_centroid(), F)
    for a in range(A):
        am = s["cell_alive"][a]
        mass = F(s["cell_mass"][a][am].sum())
        cx, cy = centroid[a]
        # camera z = 100 + mass/10 in its pinned form (obs/screen.py)
        z = F(min(max(F(F(1000.0) + mass) * F(0.1), F(100.0)), F(900.0)))
        half = F(z * TAN_HALF)
        idx = ((np.arange(S, dtype=F) + F(0.5)) * F(2.0) / F(S) - F(1.0))
        wx = cx + idx * half          # pixel-center world x, (S,)
        wy = cy + idx * half          # pixel-center world y (row 0 bottom)
        ph = F(half * F(1.0 / S))

        cls = np.zeros((S, S), np.int32)
        # 8x8 arena grid lines (renderables.hpp:245-340)
        ks = np.arange(8, dtype=F) / F(7.0)
        on_v = np.zeros(S, bool)
        on_h = np.zeros(S, bool)
        for k in ks:
            on_v |= np.abs(wx - k * F(cfg.arena_width)) <= ph
            on_h |= np.abs(wy - k * F(cfg.arena_height)) <= ph
        in_x = (wx >= -1e-3) & (wx <= cfg.arena_width + 1e-3)
        in_y = (wy >= -1e-3) & (wy <= cfg.arena_height + 1e-3)
        gridmask = (on_v[None, :] | on_h[:, None]) & in_x[None, :] & in_y[:, None]
        cls[gridmask] = 1

        def paint(mask2d, cid):
            cls[mask2d] = cid

        def circles(pos, rad, alive, cid):
            m = np.zeros((S, S), bool)
            for n in range(pos.shape[0]):
                if not alive[n]:
                    continue
                dx = wx - F(pos[n, 0])
                dy = wy - F(pos[n, 1])
                r2 = F(rad if np.isscalar(rad) else rad[n])
                r2 = F(r2 * r2)
                # pinned predicate form: dx^2 <= r^2 - dy^2 (one broadcast
                # op fewer than dx^2+dy^2 <= r^2; differs only at f32-ulp
                # boundaries and is used identically by the XLA and Pallas
                # rasterizers)
                m |= (dx * dx)[None, :] <= (r2 - dy * dy)[:, None]
            paint(m, cid)

        circles(s["pellet_pos"], radius(1.0), s["pellet_alive"], 2)
        circles(s["food_pos"], radius(10.0), s["food_alive"], 3)
        # players: main agent first, then others drawn over it
        crad = np.asarray(G.radius(state.cell_mass)).astype(F)
        mine_pos = s["cell_pos"][a]
        circles(mine_pos, crad[a], s["cell_alive"][a], 4)
        for p in range(P):
            if p == a:
                continue
            circles(s["cell_pos"][p], crad[p], s["cell_alive"][p], 5)
        vrad = np.asarray(G.radius(state.virus_mass)).astype(F)
        circles(s["virus_pos"], vrad, s["virus_alive"], 6)
        out[a] = cls
    return out


def _played_state(cfg, seed, steps):
    state = env_reset(cfg, seed)
    rng = np.random.default_rng(seed)
    for t in range(steps):
        acts = np.zeros((cfg.num_agents, 3), np.float32)
        acts[:, :2] = rng.uniform(-1, 1, (cfg.num_agents, 2))
        acts[:, 2] = rng.integers(0, 3, cfg.num_agents)
        state, rewards, dones = env_step(cfg, state, acts)
    return state


def test_class_map_matches_numpy_scalar():
    """Full-game state (bots, splits -> foods, viruses) rasterizes
    pixel-identically to the scalar numpy oracle."""
    cfg = EnvConfig(num_agents=2, ticks_per_step=2, arena_size=120,
                    num_pellets=60, num_viruses=4, num_bots=2, mode=0)
    state = _played_state(cfg, 13, 12)
    for S in (32, 84):
        got = np.asarray(_class_map(cfg, state, S))
        want = numpy_class_map(cfg, state, S)
        assert (got == want).all(), \
            f"S={S}: {np.count_nonzero(got != want)} mismatching pixels"


def test_class_map_matches_numpy_big_player():
    """Heavy agent (mode 6 start mass 1000) zooms the camera out; the big
    own-cell covers many pixels and pellets shrink below pixel size."""
    cfg = EnvConfig(num_agents=1, ticks_per_step=2, arena_size=200,
                    num_pellets=40, num_viruses=3, mode=6)
    state = _played_state(cfg, 5, 6)
    got = np.asarray(_class_map(cfg, state, 64))
    want = numpy_class_map(cfg, state, 64)
    assert (got == want).all()
    assert (want == 4).sum() > 100      # the big cell is visibly large


def test_screen_frame_colors_match_oracle():
    """screen_frame = color table applied to the class map (+RGB565 for the
    natural mode)."""
    cfg = EnvConfig(num_agents=1, ticks_per_step=2, arena_size=100,
                    num_pellets=30, num_viruses=2, mode=4)
    state = _played_state(cfg, 9, 8)
    S = 48
    want_cls = numpy_class_map(cfg, state, S)
    got_av = np.asarray(screen_frame(
        cfg, ScreenObsConfig(screen_len=S, agent_view=True), state))
    assert (got_av == np.asarray(_AGENT_VIEW_COLORS)[want_cls]).all()
    got_rgb = np.asarray(screen_frame(
        cfg, ScreenObsConfig(screen_len=S, agent_view=False), state))
    want_rgb = np.asarray(_rgb565(jnp.asarray(
        np.asarray(_NATURAL_COLORS)[want_cls])))
    assert (got_rgb == want_rgb).all()


def test_class_map_boundary_pixels():
    """Entities placed at exact pixel-center distances: the coverage
    predicate is dx^2 <= r^2 - dy^2 in f32, inclusive."""
    cfg = EnvConfig(num_agents=1, ticks_per_step=1, arena_size=100,
                    num_pellets=4, num_viruses=1, mode=4)
    state = env_reset(cfg, 2)
    # put the agent dead-center; pellets in a tight cross around it
    center = jnp.array([50.0, 50.0])
    from agarcl_tpu.state import encode_pellet_key
    ppos = state.pellet_xy_alive(cfg)[0]
    for i, d in enumerate(((0.9, 0.0), (-0.49, 0.0), (0.0, 3.0), (20.0, 20.0))):
        ppos = ppos.at[i].set(center + jnp.array(d))
    palive = jnp.zeros(ppos.shape[:1], bool).at[:4].set(True)
    state = state.replace(
        cell_pos=state.cell_pos.at[0, 0].set(center),
        pellet_key=encode_pellet_key(cfg, ppos, palive),
        virus_pos=state.virus_pos.at[0].set(center + jnp.array([10.0, -4.0])),
        virus_alive=jnp.zeros_like(state.virus_alive).at[0].set(True))
    for S in (41, 84):   # odd size puts a pixel center exactly on the player
        got = np.asarray(_class_map(cfg, state, S))
        want = numpy_class_map(cfg, state, S)
        assert (got == want).all(), f"S={S}"


def _colors(cfg, cls, agent_view):
    if agent_view:
        return np.asarray(_AGENT_VIEW_COLORS)[cls]
    return np.asarray(_rgb565(jnp.asarray(np.asarray(_NATURAL_COLORS)[cls])))


@pytest.mark.parametrize("agent_view", [True, False],
                         ids=["agent_view", "natural"])
def test_screen_frame_multi_agent_matches_oracle(agent_view):
    """Two agents and a bot: each agent renders from its own camera with
    its own main/other split, pixel for pixel."""
    cfg = EnvConfig(num_agents=2, ticks_per_step=2, arena_size=120,
                    num_pellets=60, num_viruses=4, num_bots=1, mode=7)
    state = _played_state(cfg, 21, 6)
    S = 40
    got = np.asarray(screen_frame(
        cfg, ScreenObsConfig(screen_len=S, agent_view=agent_view), state))
    want = _colors(cfg, numpy_class_map(cfg, state, S), agent_view)
    assert got.shape == (2, S, S, 4 if agent_view else 3)
    assert (got == want).all(), f"{np.count_nonzero(got != want)} values"
    assert (got[0] != got[1]).any()


def test_screen_frame_stacking_matches_oracle():
    """num_frames=2 through env_step: the last two ticks each give a
    frame, each equal to the oracle's rendering of that tick's state."""
    import functools

    import jax

    from agarcl_tpu import apply_actions
    from agarcl_tpu.engine.tick import engine_tick
    cfg = EnvConfig(num_agents=1, ticks_per_step=4, arena_size=100,
                    num_pellets=40, num_viruses=2, num_bots=0, mode=4)
    ocfg = ScreenObsConfig(screen_len=32, agent_view=True, num_frames=2)
    s0 = _played_state(cfg, 9, 3)
    acts = jnp.asarray([[0.7, -0.2, 0.0]], jnp.float32)
    _, obs, _, _ = jax.jit(functools.partial(
        env_step, cfg, obs_fn=functools.partial(screen_frame, cfg, ocfg),
        num_frames=2))(s0, acts)
    s = apply_actions(cfg, s0, acts)
    tick = jax.jit(functools.partial(engine_tick, cfg))
    want = []
    for _ in range(cfg.ticks_per_step):
        s = tick(s)
        want.append(_colors(cfg, numpy_class_map(cfg, s, 32), True))
    obs = np.asarray(obs)
    assert obs.shape == (2, 1, 32, 32, 4)
    assert (obs == np.stack(want[-2:])).all()
    assert (obs[0] != obs[1]).any()
