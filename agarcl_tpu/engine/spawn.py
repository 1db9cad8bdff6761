"""World initialization, respawn, and pellet/virus regeneration.

Reference: initialize_game/add_pellets/add_viruses/create_squared_pellets
(Engine.hpp:111-117,418-485), respawn (Engine.hpp:119-137), regeneration
(Engine.hpp:230-237). Randomness uses the counted-stream RNG (SPEC D2):
placement of slot n at tick t is a pure function of (seed, stream, t, n).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from agarcl_tpu import constants as C
from agarcl_tpu import prng
from agarcl_tpu.config import EnvConfig

_INIT_TICK = jnp.int32(-1)  # "tick" counter value for initial placement draws


def _random_location(arena_w, arena_h, radius, seed, stream, tick, slot):
    """Engine::random_location (Engine.hpp:143-148): uniform in
    [r, W-r) x [r, H-r)."""
    x = prng.uniform_range(0.0, arena_w - 2.0 * radius, seed, stream, tick,
                           slot, 0) + radius
    y = prng.uniform_range(0.0, arena_h - 2.0 * radius, seed, stream, tick,
                           slot, 1) + radius
    return jnp.stack([x, y], axis=-1)


def pellet_qparams(cfg: EnvConfig):
    """(q_lo_x, nq_x, q_lo_y, nq_y) host ints for the quantized pellet
    spawn draw (SPEC pellet quantization): eligible cells keep the
    reference's radius margin (random_location draws in [r, W-r)); the
    margin is computed from the f32 radius in f64 so Python and the C++
    oracle agree exactly."""
    rad = np.float32(np.sqrt(C.PELLET_MASS / np.pi))

    def p(arena):
        q_lo = int(np.ceil(float(rad) * 32768.0 / float(arena)))
        return q_lo, 32768 - 2 * q_lo

    qx, nx = p(cfg.arena_width)
    qy, ny = p(cfg.arena_height)
    return qx, nx, qy, ny


def pellet_spawn_keys(cfg: EnvConfig, seed, tick, slot):
    """(slot,)-shaped i32 pellet keys drawn on the quantized grid with
    pure integer arithmetic (prng.uniform_q) — bit-exact across XLA
    programs, backends and the oracle. Consumes the same RNG
    counters (STREAM_PELLET, tick, slot, axis 0/1) the float draw did."""
    qlx, nqx, qly, nqy = pellet_qparams(cfg)
    qx = prng.uniform_q(nqx, seed, prng.STREAM_PELLET, tick, slot, 0) + qlx
    qy = prng.uniform_q(nqy, seed, prng.STREAM_PELLET, tick, slot, 1) + qly
    return (qx << 15) | qy


def squared_pellet_layout(cfg: EnvConfig) -> np.ndarray:
    """create_squared_pellets (Engine.hpp:426-475): pellet ring on a centered
    square of side min(W,H)/2, spacing 1, laid out top, right, bottom, left.
    Deterministic — computed host-side as a constant."""
    w, h = cfg.arena_width, cfg.arena_height
    size = min(w, h) / 2
    n = int(size / 1.0)
    cx, cy, half = w / 2, h / 2, size / 2
    pts = []
    for i in range(n):  # top
        pts.append((cx - half + i, cy - half))
    for i in range(n):  # right
        pts.append((cx + half, cy - half + i))
    for i in range(n):  # bottom
        pts.append((cx + half - i, cy + half))
    for i in range(n):  # left
        pts.append((cx - half, cy + half - i))
    pts = [(x, y) for (x, y) in pts if 0 <= x <= w and 0 <= y <= h]
    return np.asarray(pts, dtype=np.float32)


def initial_pellets(cfg: EnvConfig, seed):
    """(Np,) i32 quantized pellet keys for a fresh game (state.py SPEC)."""
    from agarcl_tpu.state import encode_pellet_key
    Np = cfg.pellet_capacity
    if cfg.mode_spec.squared_pellets:
        layout = squared_pellet_layout(cfg)
        n = layout.shape[0]
        pos = np.zeros((Np, 2), np.float32)
        pos[:n] = layout
        alive = np.zeros((Np,), bool)
        alive[:n] = True
        return encode_pellet_key(cfg, jnp.asarray(pos), jnp.asarray(alive))
    slot = jnp.arange(Np, dtype=jnp.int32)
    key = pellet_spawn_keys(cfg, seed, _INIT_TICK, slot)
    return jnp.where(slot < cfg.num_pellets, key, jnp.int32(-1))


def initial_viruses(cfg: EnvConfig, seed):
    Nv = cfg.virus_capacity
    slot = jnp.arange(Nv, dtype=jnp.int32)
    rad = float(np.sqrt(C.VIRUS_INITIAL_MASS / np.pi))
    pos = _random_location(cfg.arena_width, cfg.arena_height, rad, seed,
                           prng.STREAM_VIRUS, _INIT_TICK, slot)
    alive = slot < cfg.num_viruses
    return pos, alive


def respawn_location(cfg: EnvConfig, pellet_pos, seed, tick, player_slot):
    """Engine::respawn placement (Engine.hpp:119-137).

    Squared-pellet modes place the player near pellet slot 0 offset by two
    min-cell radii (clamped); otherwise uniform with the min-cell radius
    margin. player_slot may be an array (vectorized respawn)."""
    rad25 = float(np.sqrt(C.CELL_MIN_SIZE / np.pi))
    if cfg.mode_spec.squared_pellets:
        loc = pellet_pos[0] + 2.0 * rad25
        loc = jnp.minimum(
            loc, jnp.asarray([cfg.arena_width - rad25,
                              cfg.arena_height - rad25], jnp.float32))
        return jnp.broadcast_to(loc, jnp.shape(player_slot) + (2,))
    return _random_location(cfg.arena_width, cfg.arena_height, rad25, seed,
                            prng.STREAM_RESPAWN, tick, player_slot)


def regen(cfg: EnvConfig, pellet_key, virus_pos, virus_vel,
          virus_mass, virus_hits, virus_alive, seed, tick):
    """Engine.hpp:230-237: every REGEN_PERIOD ticks (and only when the mode
    regenerates), refill pellets and viruses to their targets. Dead slots are
    refilled lowest-slot-first; placement draws key on (tick, slot)."""
    due = (tick % C.REGEN_PERIOD) == 0

    rad_v = float(np.sqrt(C.VIRUS_INITIAL_MASS / np.pi))
    p_alive = pellet_key >= 0
    n_alive = jnp.sum(p_alive)
    deficit = jnp.maximum(cfg.num_pellets - n_alive, 0)
    dead_order = jnp.cumsum(~p_alive) - 1  # order among dead slots
    fill = due & ~p_alive & (dead_order < deficit)
    slot = jnp.arange(pellet_key.shape[0], dtype=jnp.int32)
    new_key = pellet_spawn_keys(cfg, seed, tick, slot)
    pellet_key = jnp.where(fill, new_key, pellet_key)
    nv_alive = jnp.sum(virus_alive)
    deficit_v = jnp.maximum(cfg.num_viruses - nv_alive, 0)
    dead_order_v = jnp.cumsum(~virus_alive) - 1
    fill_v = due & ~virus_alive & (dead_order_v < deficit_v)
    slot = jnp.arange(virus_alive.shape[0], dtype=jnp.int32)
    new_vpos = _random_location(cfg.arena_width, cfg.arena_height, rad_v,
                                seed, prng.STREAM_VIRUS, tick, slot)
    virus_pos = jnp.where(fill_v[:, None], new_vpos, virus_pos)
    virus_vel = jnp.where(fill_v[:, None], 0.0, virus_vel)
    virus_mass = jnp.where(fill_v, jnp.int32(C.VIRUS_INITIAL_MASS), virus_mass)
    virus_hits = jnp.where(fill_v, 0, virus_hits)
    virus_alive = virus_alive | fill_v
    return (pellet_key, virus_pos, virus_vel, virus_mass,
            virus_hits, virus_alive)
