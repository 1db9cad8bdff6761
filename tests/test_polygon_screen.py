"""Polygon-silhouette screen mode (ScreenObsConfig.polygon_edges) vs an
independent scalar triangle-fan rasterizer.

The reference renders every ball as a GL triangle fan — center plus rim
vertices at angles 2*pi*i/N scaled by the radius (renderables.hpp:191-200),
with 5-gon pellets, 7-gon foods, 50-gon cells and a wavy 150-gon virus rim
(Entities.hpp:13-16,62-79). obs/screen.py emulates those silhouettes
analytically with the polar chord formula; this file checks it against a
float64 numpy point-in-triangle oracle that knows nothing about that formula.

Because the two sides use different arithmetic (f32 atan2/sin vs f64 cross
products), agreement is asserted as a sandwich: every pixel the oracle finds
inside the fan shrunk by (1-eps) must be covered, and every pixel outside
the fan grown by (1+eps) must be uncovered; boundary pixels in between are
unconstrained.
"""

import jax.numpy as jnp
import numpy as np

from agarcl_tpu import EnvConfig, env_reset
from agarcl_tpu.engine import geometry as G
from agarcl_tpu.obs.screen import (_SIDES_CELL, _SIDES_FOOD, _SIDES_PELLET,
                                   _SIDES_VIRUS, _TAN_HALF_FOV, _class_map,
                                   ScreenObsConfig, screen_frame)

EPS = 1e-3


def fan_vertices(c, r, n_sides, wavy, scale=1.0):
    """(N+1, 2) float64 rim vertices i=1..N+1 of the reference fan."""
    i = np.arange(1, n_sides + 2, dtype=np.float64)
    w = np.ones_like(i)
    if wavy:
        w = 1.0 + np.sin(30.0 * np.pi * i / n_sides) / 15.0
    ang = 2.0 * np.pi * i / n_sides
    return np.stack([c[0] + scale * r * w * np.cos(ang),
                     c[1] + scale * r * w * np.sin(ang)], axis=1)


def fan_cover(wx, wy, c, r, n_sides, wavy, scale):
    """(S, S) bool: pixel centers inside the triangle fan (inclusive),
    float64 cross-product point-in-triangle tests."""
    verts = fan_vertices(c, r, n_sides, wavy, scale)
    px = wx[None, :].astype(np.float64)     # (1, S) broadcast over rows
    py = wy[:, None].astype(np.float64)     # (S, 1)
    out = np.zeros((wy.size, wx.size), bool)
    cx, cy = float(c[0]), float(c[1])
    for t in range(n_sides):
        ax, ay = cx, cy
        bx, by = verts[t]
        dx, dy = verts[t + 1]
        # signed areas; fan is counter-clockwise so all crosses >= 0 inside
        s1 = (bx - ax) * (py - ay) - (by - ay) * (px - ax)
        s2 = (dx - bx) * (py - by) - (dy - by) * (px - bx)
        s3 = (ax - dx) * (py - dy) - (ay - dy) * (px - dx)
        out |= (s1 >= 0) & (s2 >= 0) & (s3 >= 0)
    return out


def pixel_grid(cfg, state, a, S):
    s_mass = np.asarray(state.cell_mass, np.float32)
    alive = np.asarray(state.cell_alive)
    w = np.where(alive[a], s_mass[a], 0).astype(np.float32)
    cx = float((np.asarray(state.cell_pos)[a, :, 0] * w).sum() / w.sum())
    cy = float((np.asarray(state.cell_pos)[a, :, 1] * w).sum() / w.sum())
    z = min(max(100.0 + w.sum() / 10.0, 100.0), 900.0)
    half = z * _TAN_HALF_FOV
    idx = (np.arange(S, dtype=np.float32) + 0.5) * 2.0 / S - 1.0
    return cx + idx * half, cy + idx * half


def check_class(cls_got, cid, wx, wy, entities, n_sides, wavy=False):
    """Sandwich check for one entity class: cls pixels == cid must contain
    the shrunk-fan union and avoid the complement of the grown-fan union.
    `entities`: list of (center, radius). Only meaningful where no later
    class draws over — caller passes a state with well-separated entities."""
    inner = np.zeros(cls_got.shape, bool)
    outer = np.zeros(cls_got.shape, bool)
    for c, r in entities:
        inner |= fan_cover(wx, wy, c, r, n_sides, wavy, 1.0 - EPS)
        outer |= fan_cover(wx, wy, c, r, n_sides, wavy, 1.0 + EPS)
    got = cls_got == cid
    assert (got | ~inner).all(), \
        f"class {cid}: {np.count_nonzero(inner & ~got)} missing pixels"
    assert (~got | outer).all(), \
        f"class {cid}: {np.count_nonzero(got & ~outer)} extra pixels"


def test_polygon_class_map_vs_fan_oracle():
    """Hand-placed, well-separated entities of every class rasterize to the
    exact fan silhouettes (sandwich at eps=1e-3)."""
    cfg = EnvConfig(num_agents=1, ticks_per_step=1, arena_size=200,
                    num_pellets=4, num_viruses=1, mode=4)
    state = env_reset(cfg, 3)
    center = jnp.array([100.0, 100.0])
    # one fat main cell, pellets / foods / a virus spread around it
    from agarcl_tpu.state import encode_pellet_key
    ppos = state.pellet_xy_alive(cfg)[0]
    for i, d in enumerate(((14.0, 3.0), (-17.0, 6.0), (5.0, -19.0),
                           (-9.0, -13.0))):
        ppos = ppos.at[i].set(center + jnp.array(d))
    palive = jnp.zeros(ppos.shape[:1], bool).at[:4].set(True)
    fpos = state.food_pos.at[0].set(center + jnp.array([24.0, -7.0]))
    fpos = fpos.at[1].set(center + jnp.array([-26.0, -2.0]))
    falive = jnp.zeros_like(state.food_alive).at[:2].set(True)
    state = state.replace(
        cell_pos=state.cell_pos.at[0, 0].set(center),
        cell_mass=state.cell_mass.at[0, 0].set(400),
        pellet_key=encode_pellet_key(cfg, ppos, palive),
        food_pos=fpos, food_alive=falive,
        virus_pos=state.virus_pos.at[0].set(center + jnp.array([0.0, 27.0])),
        virus_alive=jnp.zeros_like(state.virus_alive).at[0].set(True))

    S = 256
    cls = np.asarray(_class_map(cfg, state, S, polygon_edges=True))[0]
    wx, wy = pixel_grid(cfg, state, 0, S)

    def rad(m):
        return float(np.asarray(G.radius(jnp.float32(m))))

    pel = [(np.asarray(state.pellet_xy_alive(cfg)[0])[i], rad(1.0))
           for i in range(4)]
    foo = [(np.asarray(state.food_pos)[i], rad(10.0)) for i in range(2)]
    own = [(np.asarray(center), rad(400.0))]
    vir = [(np.asarray(state.virus_pos)[0],
            float(np.asarray(G.radius(state.virus_mass))[0]))]
    check_class(cls, 2, wx, wy, pel, _SIDES_PELLET)
    check_class(cls, 3, wx, wy, foo, _SIDES_FOOD)
    check_class(cls, 4, wx, wy, own, _SIDES_CELL)
    check_class(cls, 6, wx, wy, vir, _SIDES_VIRUS, wavy=True)


def test_polygon_pellet_smaller_than_circle():
    """A pentagon covers visibly fewer pixels than its circumscribed circle
    (area ratio ~0.76), and the 50-gon cell is nearly indistinguishable."""
    cfg = EnvConfig(num_agents=1, ticks_per_step=1, arena_size=200,
                    num_pellets=1, num_viruses=0, mode=4)
    state = env_reset(cfg, 1)
    center = jnp.array([100.0, 100.0])
    from agarcl_tpu.state import encode_pellet_key
    ppos1 = state.pellet_xy_alive(cfg)[0].at[0].set(
        center + jnp.array([20.0, 0.0]))
    palive1 = jnp.zeros(ppos1.shape[:1], bool).at[0].set(True)
    state = state.replace(
        cell_pos=state.cell_pos.at[0, 0].set(center),
        cell_mass=state.cell_mass.at[0, 0].set(900),
        pellet_key=encode_pellet_key(cfg, ppos1, palive1))
    S = 512
    circ = np.asarray(_class_map(cfg, state, S, polygon_edges=False))[0]
    poly = np.asarray(_class_map(cfg, state, S, polygon_edges=True))[0]
    pc, pp = (circ == 2).sum(), (poly == 2).sum()
    assert pp < pc  # pentagon strictly inside the circle
    assert pp > 0.65 * pc  # but the bulk of it (area ratio 0.757)
    cc, cp = (circ == 4).sum(), (poly == 4).sum()
    assert abs(cc - cp) / cc < 0.02  # 50-gon ~ circle (ratio 0.9967)


def test_polygon_flag_through_screen_frame():
    """screen_frame honors polygon_edges and still colorizes normally."""
    cfg = EnvConfig(num_agents=1, ticks_per_step=1, arena_size=100,
                    num_pellets=20, num_viruses=2, mode=4)
    state = env_reset(cfg, 7)
    f = np.asarray(screen_frame(
        cfg, ScreenObsConfig(screen_len=32, agent_view=True,
                             polygon_edges=True), state))
    assert f.shape == (1, 32, 32, 4) and f.dtype == np.uint8
