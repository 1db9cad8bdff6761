"""Screen observations: analytic circle rasterization replacing the OpenGL
render path (renderer + FBO + glReadPixels,
/root/reference/agario/rendering/renderer.hpp:38-213,
/root/reference/agario/rendering/FrameBufferObject.hpp:52-259,
/root/reference/environment/envs/ScreenEnvironment.hpp:24-246).

Geometry: the reference renders circles at z=0 through a 45-degree-FOV
perspective camera hovering at z = clamp(100 + mass/10, 100, 900) directly
above the player centroid (renderer.hpp:91-120). A perspective projection of
the z=0 plane from a top-down camera is an affine map, so the visible world
window is the square of half-extent z*tan(22.5 deg) and rasterization reduces
to a 2-D coverage test per pixel center — no GL needed. Row 0 is the bottom
row (glReadPixels origin).

agent_view (4-channel semantic) mode reproduces the *effective* channel
semantics of multi_channel_render_screen + post_processing_frame_data
(renderer.hpp:128-155, ScreenEnvironment.hpp:48-88): per pixel, the topmost
entity class in draw order [grid < pellets < foods < main < others < viruses]
determines the value:

  background (0,0,0,0) | grid lines (0,0,0,26) | pellet/food (255,0,0,0)
  main player (0,0,0,230) | other players (0,255,0,0) | virus (0,0,255,0)

(The reference's post-processing loop contains dead branches — e.g. the alpha
clause `data[i]==0 && data[i]==255` at ScreenEnvironment.hpp:57 is always
false — so we pin the clean semantics its consumers, e.g. the video
colorizer at AgarioEnv.py:168-181, actually rely on.)

Natural RGB mode: white background, grid lines (26,0,0), pellets red, foods
red, players green, main player (230,0,0), viruses blue — the fixed semantic
palette of renderables.hpp:106-134 (the reference's natural mode uses random
per-player colors; we pin the deterministic palette) — with GL_RGB565
quantization emulation (FrameBufferObject.hpp:187).
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np

from agarcl_tpu.config import EnvConfig
from agarcl_tpu.state import GameState
from agarcl_tpu.engine import geometry as G

_TAN_HALF_FOV = math.tan(math.radians(45.0 / 2.0))
_NUM_GRID_LINES = 8  # renderer.hpp:26
# class radii as static floats (same f32 rounding as G.radius, which would
# trace under jit): radius = sqrt(mass/pi), utils.hpp:8-11
_RAD_PELLET = float(np.sqrt(np.float32(1.0) / np.float32(np.pi)))
_RAD_FOOD = float(np.sqrt(np.float32(10.0) / np.float32(np.pi)))


@dataclasses.dataclass(frozen=True)
class ScreenObsConfig:
    screen_len: int = 84
    agent_view: bool = False
    num_frames: int = 1
    # Emulate the reference's triangle-fan silhouettes instead of true
    # circles: 5-gon pellets, 7-gon foods, 50-gon cells, 150-gon wavy-rim
    # viruses (Entities.hpp:13-16,62-79, renderables.hpp:191-200). Default
    # off: SPEC pins circles; bench/polygon_iou.py quantifies the pixel
    # difference per class.
    polygon_edges: bool = False
    # Virus silhouette under polygon_edges: "wavy" (the reference's
    # 150-gon sine rim) or "circle" (viruses stay circles; the wave is a
    # +-6.7% rim modulation, bench/polygon_iou.py).
    polygon_virus: str = "wavy"


# polygon side counts (Entities.hpp:13-16)
_SIDES_PELLET = 5
_SIDES_FOOD = 7
_SIDES_CELL = 50
_SIDES_VIRUS = 150
# wavy virus rim: vertex i sits at radius 1 + sin(30*pi*i/N)/15
# (Entities.hpp:66-75)
_VIRUS_RIM = tuple(
    1.0 + math.sin(30.0 * math.pi * i / _SIDES_VIRUS) / 15.0
    for i in range(_SIDES_VIRUS + 2))


def _poly_radius_factor(dx, dy, n_sides: int, wavy: bool = False):
    """Local silhouette radius (relative to the circumradius) of the
    reference's triangle fan in the direction of (dx, dy).

    The fan is center + rim vertices v_i = w_i * (cos(i*delta), sin(i*delta)),
    i = 1..N+1, delta = 2*pi/N (renderables.hpp:191-200); w_i = 1 except the
    wavy virus rim (Entities.hpp:66-75). For a convex fan the covered set in
    direction theta extends to the chord between the two bracketing vertices;
    the polar two-point line formula gives that boundary exactly:

        r(theta) = r1*r2*sin(th2-th1) / (r2*sin(th2-theta) + r1*sin(theta-th1))
    """
    delta = 2.0 * math.pi / n_sides
    theta = jnp.arctan2(dy, dx)                       # [-pi, pi]
    # segment between vertex k+1 and k+2 (first rim vertex at angle delta)
    k = jnp.floor((theta - delta) / delta).astype(jnp.int32) % n_sides
    th1 = (k + 1).astype(jnp.float32) * delta
    # wrap theta into [th1, th1 + delta)
    t = jnp.mod(theta - th1, 2.0 * math.pi)
    if wavy:
        rim = jnp.asarray(_VIRUS_RIM, jnp.float32)
        r1 = rim[k + 1]
        r2 = rim[k + 2]
    else:
        # regular n-gon: closed form r = cos(pi/N) / cos(t - pi/N)
        return math.cos(math.pi / n_sides) / jnp.cos(t - math.pi / n_sides)
    s = math.sin(delta)
    return r1 * r2 * s / (r2 * jnp.sin(delta - t) + r1 * jnp.sin(t))


def _pixel_idx(S: int) -> np.ndarray:
    """(S,) f32 pixel-center coordinates in (-1, 1), computed on the host
    so that every backend starts from the same values."""
    return (np.arange(S, dtype=np.float32) + np.float32(0.5)) \
        * np.float32(2.0) / np.float32(S) - np.float32(1.0)


def _camera_z(pmass):
    """renderer.hpp:91 z = clamp(100 + mass / 10, 100, 900), pinned as
    (1000 + mass) * f32(0.1): an exact sum and one rounded product (the
    GPU's division is a 2-ulp approximation)."""
    return jnp.clip((1000.0 + pmass) * np.float32(0.1), 100.0, 900.0)


def _pixel_world_coords(center, z, S):
    """World coordinates of pixel centers: (..., S) for x and y separately.

    center: (A, 2); z: (A,). Returns (wx (A,S), wy (A,S), half (A,),
    pixel_half (A,)).
    """
    half = z * _TAN_HALF_FOV
    step = _pixel_idx(S)[None, :] * half[:, None]             # (A, S)
    wx = center[:, 0:1] + step
    wy = center[:, 1:2] + step
    pixel_half = half * np.float32(1.0 / S)
    return wx, wy, half, pixel_half


def _circle_cover(wx, wy, pos, rad, alive, chunk: int = 32,
                  n_sides: int | None = None, wavy: bool = False):
    """(A, S, S) bool: any live circle covers the pixel center.

    wx/wy: (A, S); pos: (N, 2); rad: (N,); alive: (N,).

    Entities are folded in chunks under lax.scan with a running
    any-accumulator: the (A, chunk, S, S) coverage tensor of each chunk is
    consumed by its own reduction inside one fused loop, so the full
    (A, N, S, S) tensor (1.8 GB at 500 pellets x 84^2 x 512 envs under
    vmap) is never materialized. Bit-identical to the direct reduction.

    n_sides: if given, cover with the reference's N-gon fan silhouette
    (wavy = the virus rim) instead of the true circle.
    """
    A, S = wx.shape
    N = pos.shape[0]
    C = min(chunk, N)
    K = -(-N // C)
    pad = K * C - N
    px = jnp.pad(pos[:, 0], (0, pad)).reshape(K, C)
    py = jnp.pad(pos[:, 1], (0, pad)).reshape(K, C)
    r2 = jnp.pad(rad * rad, (0, pad)).reshape(K, C)
    ok = jnp.pad(alive, (0, pad)).reshape(K, C)

    def body(acc, ch):
        cpx, cpy, cr2, cok = ch
        dx = wx[:, None, :] - cpx[None, :, None]             # (A, C, S)
        dy = wy[:, None, :] - cpy[None, :, None]
        if n_sides is not None:
            d2 = (dx * dx)[:, :, None, :] + (dy * dy)[:, :, :, None]
            f = _poly_radius_factor(dx[:, :, None, :], dy[:, :, :, None],
                                    n_sides, wavy)
            cov = d2 <= cr2[None, :, None, None] * (f * f)
        else:
            # pinned predicate form dx^2 <= r^2 - dy^2: the (A,C,S) rhs
            # broadcasts into the compare, skipping the (A,C,S,S) add
            lim = cr2[None, :, None] - dy * dy               # (A, C, S)
            cov = (dx * dx)[:, :, None, :] <= lim[:, :, :, None]
        cov = cov & cok[None, :, None, None]
        return acc | jnp.any(cov, axis=1), None

    acc0 = jnp.zeros((A, S, S), bool)
    acc, _ = jax.lax.scan(body, acc0, (px, py, r2, ok))
    return acc


def _strip_K(r: float, S: int) -> int:
    """Static row budget for _strip_cover: the number of consecutive pixel
    rows that can intersect a circle of radius r at the finest pixel pitch
    (camera floor z=100 -> pitch 2*100*tan(22.5)/S), plus rounding margin."""
    pitch_min = 2.0 * 100.0 * _TAN_HALF_FOV / S
    # rows touched by the circle lie in [ceil(u-x), floor(u+x)] (u = center
    # row fraction, x = r/pitch); the strip starts at floor(u-x)-1 and
    # K = ceil(2x)+2 keeps >= 1 row of slack on both ends for f32 wobble
    return min(S, int(math.ceil(2.0 * r / pitch_min)) + 2)


def _strip_cover(wx, wy, center, half, pos, rad, alive, K: int,
                 n_sides: int | None = None):
    """(A, S, S) bool coverage via row-strip decomposition — the matmul
    path for numerous small entities (pellets/foods).

    Each circle intersects at most K consecutive pixel rows (K static per
    entity class via _strip_K); strip (n, k) carries the class test restricted
    to row base_n + k, which factors the coverage test exactly into a row
    one-hot (S, N*K) times a per-strip column mask (N*K, S) — one bf16/f32
    matmul instead of S*S*N scalar tests (0/1 bf16 operands with f32
    accumulation: exact counts). Pixel-exact vs the direct test:
    the strip predicate is the same f32 `dx*dx <= r*r - dy*dy` with wy
    rebuilt from the row index by the identical expression.

    wx, wy: (A, S) pixel-center world coords; center: (A, 2); half: (A,);
    pos: (N, 2); rad: scalar or (N,); alive: (N,).
    """
    A, S = wx.shape
    N = pos.shape[0]
    r = jnp.broadcast_to(jnp.asarray(rad, jnp.float32), (N,))
    r2 = r * r
    delta = 2.0 * half / S                                     # pixel pitch (A,)
    u = (pos[None, :, 1] - wy[:, 0:1]) / delta[:, None]        # (A, N) frac row
    base = jnp.floor(u - r[None, :] / delta[:, None]).astype(jnp.int32) - 1
    rows = base[:, :, None] + jnp.arange(K, dtype=jnp.int32)   # (A, N, K)
    # the row's y by the same expression as the pixel grid's wy (rows
    # outside the image are dropped by the one-hot below)
    idx = jnp.asarray(_pixel_idx(S))[jnp.clip(rows, 0, S - 1)]
    wy_rows = center[:, None, None, 1] + idx * half[:, None, None]
    dyr = wy_rows - pos[None, :, None, 1]                      # (A, N, K)
    dxr = wx[:, None, :] - pos[None, :, 0:1]                   # (A, N, S)
    if n_sides is not None:
        f = _poly_radius_factor(dxr[:, :, None, :], dyr[..., None], n_sides)
        cover = (jnp.square(dxr)[:, :, None, :] + jnp.square(dyr)[..., None]
                 <= r2[None, :, None, None] * (f * f))
    else:
        # pinned predicate form dx^2 <= r^2 - dy^2 (no (A,N,K,S) add)
        lim = r2[None, :, None] - jnp.square(dyr)              # (A, N, K)
        cover = jnp.square(dxr)[:, :, None, :] <= lim[..., None]
    cover = cover & alive[None, :, None, None]                 # (A, N, K, S)
    X = cover.reshape(A, N * K, S).astype(jnp.bfloat16)
    onehot = (rows.reshape(A, 1, N * K)
              == jnp.arange(S, dtype=jnp.int32)[None, :, None])
    R = onehot.astype(jnp.bfloat16)                            # (A, S, N*K)
    count = jnp.einsum("ais,asj->aij", R, X,
                       preferred_element_type=jnp.float32)
    return count >= 0.5


def _grid_cover(wx, wy, pixel_half, arena_w, arena_h):
    """(A, S, S) bool — pixel lies on one of the 8x8 arena grid lines
    (renderables.hpp:245-340: lines at k/(NLines-1) * arena)."""
    ks = (np.arange(_NUM_GRID_LINES, dtype=np.float32)
          / np.float32(_NUM_GRID_LINES - 1))
    xs = ks * np.float32(arena_w)
    ys = ks * np.float32(arena_h)
    ph = pixel_half[:, None, None]
    on_v = jnp.any(jnp.abs(wx[:, None, :] - xs[None, :, None]) <= ph, axis=1)
    on_h = jnp.any(jnp.abs(wy[:, None, :] - ys[None, :, None]) <= ph, axis=1)
    # also only inside the arena span of the lines (0..arena)
    in_x = (wx >= -1e-3) & (wx <= arena_w + 1e-3)
    in_y = (wy >= -1e-3) & (wy <= arena_h + 1e-3)
    return (on_v[:, None, :] & in_y[:, :, None] & in_x[:, None, :]) | \
        (on_h[:, :, None] & in_x[:, None, :] & in_y[:, :, None])


def _class_map(cfg: EnvConfig, state: GameState, S: int,
               polygon_edges: bool = False, polygon_virus: str = "wavy"):
    """(A, S, S) int32 class id: 0 bg, 1 grid, 2 pellet, 3 food, 4 main,
    5 other, 6 virus — topmost-in-draw-order per pixel.

    polygon_edges rasterizes the reference's fan silhouettes (5/7/50-gon +
    wavy 150-gon virus) instead of circles; polygon_virus="circle" keeps
    the virus a circle (ScreenObsConfig.polygon_virus)."""
    wavy_vir = polygon_edges and polygon_virus == "wavy"
    n_pel = _SIDES_PELLET if polygon_edges else None
    n_foo = _SIDES_FOOD if polygon_edges else None
    n_cel = _SIDES_CELL if polygon_edges else None
    n_vir = _SIDES_VIRUS if wavy_vir else None
    A = cfg.num_agents
    centroid = state.player_centroid()[:A]
    pmass = state.player_mass()[:A].astype(jnp.float32)
    z = _camera_z(pmass)
    wx, wy, half, ph = _pixel_world_coords(centroid, z, S)

    cls = jnp.zeros((A, S, S), jnp.int32)

    grid = _grid_cover(wx, wy, ph, cfg.arena_width, cfg.arena_height)
    cls = jnp.where(grid, 1, cls)

    pellet_pos, pellet_alive = state.pellet_xy_alive(cfg)
    pel = _strip_cover(wx, wy, centroid, half, pellet_pos, _RAD_PELLET,
                       pellet_alive, _strip_K(_RAD_PELLET, S),
                       n_sides=n_pel)
    cls = jnp.where(pel, 2, cls)

    foo = _strip_cover(wx, wy, centroid, half, state.food_pos, _RAD_FOOD,
                       state.food_alive, _strip_K(_RAD_FOOD, S),
                       n_sides=n_foo)
    cls = jnp.where(foo, 3, cls)

    # players: main agent first, then others drawn over it
    # (multi_channel_render_screen draws main then others; natural mode draws
    # in pid order — we use main-then-others for both)
    P, Cc = state.cell_mass.shape
    flat_pos = state.cell_pos.reshape(P * Cc, 2)
    flat_rad = G.radius(state.cell_mass).reshape(P * Cc)
    flat_alive = state.cell_alive.reshape(P * Cc)
    owner = jnp.repeat(jnp.arange(P), Cc)

    for a_idx in range(A):
        mine = flat_alive & (owner == a_idx)
        others = flat_alive & (owner != a_idx)
        main_cov = _circle_cover(wx[a_idx:a_idx + 1], wy[a_idx:a_idx + 1],
                                 flat_pos, flat_rad, mine,
                                 n_sides=n_cel)[0]
        oth_cov = _circle_cover(wx[a_idx:a_idx + 1], wy[a_idx:a_idx + 1],
                                flat_pos, flat_rad, others,
                                n_sides=n_cel)[0]
        cls_a = cls[a_idx]
        cls_a = jnp.where(main_cov, 4, cls_a)
        cls_a = jnp.where(oth_cov, 5, cls_a)
        cls = cls.at[a_idx].set(cls_a)

    vir = _circle_cover(wx, wy, state.virus_pos,
                        G.radius(state.virus_mass), state.virus_alive,
                        n_sides=n_vir, wavy=wavy_vir)
    cls = jnp.where(vir, 6, cls)
    return cls


def _rgb565(rgb):
    """Emulate GL_RGB565 storage (FrameBufferObject.hpp:187): quantize to
    5/6/5 bits and expand back to 8."""
    r = (rgb[..., 0].astype(jnp.int32) >> 3)
    g = (rgb[..., 1].astype(jnp.int32) >> 2)
    b = (rgb[..., 2].astype(jnp.int32) >> 3)
    r8 = (r << 3) | (r >> 2)
    g8 = (g << 2) | (g >> 4)
    b8 = (b << 3) | (b >> 2)
    return jnp.stack([r8, g8, b8], axis=-1).astype(jnp.uint8)


# class color tables
_AGENT_VIEW_COLORS = jnp.asarray([
    [0, 0, 0, 0],        # background
    [0, 0, 0, 26],       # grid line
    [255, 0, 0, 0],      # pellet
    [255, 0, 0, 0],      # food
    [0, 0, 0, 230],      # main player
    [0, 255, 0, 0],      # other players
    [0, 0, 255, 0],      # virus
], dtype=jnp.uint8)

_NATURAL_COLORS = jnp.asarray([
    [255, 255, 255],     # background (white clear, renderer.hpp:174)
    [26, 0, 0],          # grid line (renderables.hpp grid color 0.1,0,0)
    [255, 0, 0],         # pellet
    [255, 0, 0],         # food
    [230, 0, 0],         # main player (0.9 red)
    [0, 255, 0],         # other players
    [0, 0, 255],         # virus
], dtype=jnp.uint8)


def _apply_palette(cls, table):
    """Select-chain palette application: seven elementwise selects that
    XLA fuses into one bandwidth-bound pass, instead of a (7, C) table
    gather per pixel."""
    out = jnp.broadcast_to(table[0], cls.shape + (table.shape[1],))
    for k in range(1, table.shape[0]):
        out = jnp.where((cls == k)[..., None], table[k], out)
    return out


def screen_frame(cfg: EnvConfig, ocfg: ScreenObsConfig,
                 state: GameState) -> jnp.ndarray:
    """(A, S, S, 3|4) uint8 — one frame per agent."""
    S = ocfg.screen_len
    cls = _class_map(cfg, state, S, polygon_edges=ocfg.polygon_edges,
                     polygon_virus=ocfg.polygon_virus)
    if ocfg.agent_view:
        return _apply_palette(cls, _AGENT_VIEW_COLORS)
    return _apply_palette(cls, _rgb565(_NATURAL_COLORS))


def render_rgb(cfg: EnvConfig, state: GameState, size: int = 512):
    """Human-viewable natural-color render of agent 0's perspective
    (the rgb_array render mode, AgarioEnv.py:143-150)."""
    ocfg = ScreenObsConfig(screen_len=size, agent_view=False)
    frame = screen_frame(cfg, ocfg, state)[0]
    return frame[::-1]  # flip to row-0-top for viewing
