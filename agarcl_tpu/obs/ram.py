"""RAM (flat-vector) observations.

The reference *declares* a "ram" observation mode but never implements it
(gym_agario/AgarioEnv.py:52 accepts the string; _make_environment's assert at
AgarioEnv.py:211 rejects it; tests/ram_env_test.py targets a never-registered
env id — SURVEY §4). This module supplies the missing capability with a
fixed-shape ego-centric feature vector per agent:

  [ centroid_x/W, centroid_y/H, total_mass,
    per own cell slot (max_cells): rel_x, rel_y, mass, vel_x, vel_y, alive,
    K_p nearest pellets: rel_x, rel_y, alive,
    K_v nearest viruses: rel_x, rel_y, mass, alive,
    per player pid (num_players): rel_x, rel_y, total_mass, alive ]

Relative positions are in world units; dead/padded entries are zero. The
other-player block keeps one slot per pid (including self, zeroed) so shapes
stay static.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from agarcl_tpu.config import EnvConfig
from agarcl_tpu.state import GameState


@dataclasses.dataclass(frozen=True)
class RamObsConfig:
    num_pellets: int = 32   # K_p nearest pellets
    num_viruses: int = 8    # K_v nearest viruses


# --- packed nearest-k selection key -----------------------------------------
#
# The k-nearest selection orders entities by a single sortable int32 key:
# the f32 squared distance bit-cast to int32 (monotonic for non-negative
# floats) with its low B mantissa bits replaced by the entity's table index
# (B = ceil(log2(capacity))). This quantizes the distance comparison to
# ~2^(B-23) relative precision and resolves ties (and near-ties) by lowest
# index — a total order with *unique* keys, so each neighbor is extracted by
# one min-reduce and one compare, and any implementation that uses the same
# key picks the same neighbors. Dead entries get DEAD_KEY (INT32_MAX). The
# ram obs is our own contract — the reference declares but never
# implements it (/root/reference/gym_agario/AgarioEnv.py:52,211).

DEAD_KEY = 0x7FFFFFFF  # plain int: inlines as a literal


def key_index_bits(capacity: int) -> int:
    return max(1, (max(capacity, 2) - 1).bit_length())


def pack_nearest_key(d2, idx, alive, capacity: int):
    """Sortable int32 selection key from f32 squared distance + index.

    d2 must be non-negative and finite; idx int32 in [0, capacity);
    alive truthy for live entries.
    """
    b = key_index_bits(capacity)
    bits = jax.lax.bitcast_convert_type(d2.astype(jnp.float32), jnp.int32)
    key = (bits & jnp.int32(-1 << b)) | idx
    return jnp.where(alive, key, DEAD_KEY)


def ram_size(cfg: EnvConfig, ocfg: RamObsConfig) -> int:
    kp = min(ocfg.num_pellets, cfg.pellet_capacity)
    kv = min(ocfg.num_viruses, cfg.virus_capacity)
    return 3 + cfg.max_cells * 6 + kp * 3 + kv * 4 + cfg.num_players * 4


def ram_frame(cfg: EnvConfig, ocfg: RamObsConfig,
              state: GameState) -> jnp.ndarray:
    """(A, ram_size) f32 observation for every agent."""
    A = cfg.num_agents
    centroid = state.player_centroid()           # (P,2)
    pmass = state.player_mass().astype(jnp.float32)
    palive = state.player_alive()

    me = centroid[:A]                            # (A,2)
    feats = [me / jnp.asarray([cfg.arena_width, cfg.arena_height],
                              jnp.float32),
             pmass[:A, None]]

    # own cells
    rel = state.cell_pos[:A] - me[:, None, :]
    a = state.cell_alive[:A][..., None].astype(jnp.float32)
    cells = jnp.concatenate(
        [rel * a, state.cell_mass[:A][..., None].astype(jnp.float32) * a,
         state.cell_vel[:A] * a, a], axis=-1)    # (A, Cc, 6)
    feats.append(cells.reshape(A, -1))

    def nearest(pos, alive, k, extra=None):
        n = pos.shape[0]
        rel = pos[None, :, :] - me[:, None, :]   # (A, N, 2)
        # selection distance from offsets rounded to 12 significant bits:
        # their squares are exact in f32, so the sum rounds once whether
        # or not a backend fuses it into an FMA (SPEC "Backends")
        q = jax.lax.reduce_precision(rel, exponent_bits=8, mantissa_bits=11)
        d2 = q[..., 0] * q[..., 0] + q[..., 1] * q[..., 1]
        iota = jnp.arange(n, dtype=jnp.int32)[None, :]
        key = pack_nearest_key(d2, iota, alive[None, :], n)
        sel_key, idx = jax.lax.top_k(-key, k)    # k smallest keys
        sel_rel = jnp.take_along_axis(rel, idx[..., None], axis=1)
        af = (-sel_key != DEAD_KEY)[..., None].astype(jnp.float32)
        cols = [sel_rel * af]
        if extra is not None:
            sel_extra = jnp.take_along_axis(
                jnp.broadcast_to(extra[None, :].astype(jnp.float32),
                                 d2.shape), idx, axis=1)
            cols.append(sel_extra[..., None] * af)
        cols.append(af)
        return jnp.concatenate(cols, axis=-1).reshape(A, -1)

    pellet_pos, pellet_alive = state.pellet_xy_alive(cfg)
    feats.append(nearest(pellet_pos, pellet_alive,
                         min(ocfg.num_pellets, cfg.pellet_capacity)))
    feats.append(nearest(state.virus_pos, state.virus_alive,
                         min(ocfg.num_viruses, cfg.virus_capacity),
                         extra=state.virus_mass))

    # all players relative to each agent; self slot zeroed
    P = cfg.num_players
    rel_o = centroid[None, :, :] - me[:, None, :]            # (A, P, 2)
    self_mask = (jnp.arange(P)[None, :] == jnp.arange(A)[:, None])
    keep = (palive[None, :] & ~self_mask)[..., None].astype(jnp.float32)
    players = jnp.concatenate(
        [rel_o, jnp.broadcast_to(pmass[None, :, None], (A, P, 1)),
         jnp.ones((A, P, 1), jnp.float32)], axis=-1) * keep   # (A, P, 4)
    feats.append(players.reshape(A, -1))
    return jnp.concatenate(feats, axis=-1)
