"""Fixed-capacity struct-of-arrays game state (a JAX pytree).

Replaces the reference's pointer-rich dynamic containers
(/root/reference/agario/engine/GameState.hpp:41-69: `unordered_map<pid,
shared_ptr<Player>>`, `vector<Pellet/Food/Virus>`) with shape-static arrays +
alive masks so the whole simulation is traceable/compilable, `vmap`-able over
thousands of envs, and shardable with `shard_map`.

All per-entity data is stored unbatched (one env); batching is always an outer
`vmap`. Integer masses (int32) mirror the reference's unsigned-int mass
arithmetic (SPEC Q13).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from agarcl_tpu import constants as C
from agarcl_tpu.config import EnvConfig

# --- pellet position quantization (SPEC) ------------------------------------
# Pellet coordinates are pinned to a 32768 x 32768 arena-normalized grid and
# stored as one int32 key per slot: [qx:15][qy:15] >= 0; dead slots are -1.
# decode x = (qx + 0.5) * (W / 32768); encode qx = clip(floor(x * 32768 / W)).
# encode(decode(q)) == q exactly in f32 (q + 0.5 <= 32767.5 < 2^24 and the
# two scale factors cancel to within < 2^-22 relative, verified for all q),
# so keys pass through ticks unchanged unless the pellet is eaten/respawned.
# Max quantization error is W/65536 (~0.005 world units at arena 350) — far
# below the pellet radius (~0.56). Both implementations (XLA tick and C++
# oracle) quantize at spawn with the same f32 ops.

PELLET_QBITS = 15
PELLET_Q = 1 << PELLET_QBITS           # 32768
DEAD_PELLET_KEY = -1


def pellet_scales(cfg: EnvConfig):
    """(scale_x, scale_y, inv_x, inv_y) f32 constants for encode/decode."""
    return (np.float32(PELLET_Q / cfg.arena_width),
            np.float32(PELLET_Q / cfg.arena_height),
            np.float32(cfg.arena_width / PELLET_Q),
            np.float32(cfg.arena_height / PELLET_Q))


def encode_pellet_key(cfg: EnvConfig, pos, alive):
    """(..., 2) f32 positions + (...,) alive -> (...,) i32 keys."""
    sx, sy, _, _ = pellet_scales(cfg)
    qmax = jnp.int32(PELLET_Q - 1)
    qx = jnp.clip(jnp.floor(pos[..., 0] * sx).astype(jnp.int32), 0, qmax)
    qy = jnp.clip(jnp.floor(pos[..., 1] * sy).astype(jnp.int32), 0, qmax)
    key = (qx << PELLET_QBITS) | qy
    return jnp.where(alive, key, jnp.int32(DEAD_PELLET_KEY))


def decode_pellet_xy(cfg: EnvConfig, key):
    """(...,) i32 keys -> ((..., 2) f32 positions, (...,) bool alive).

    Dead slots decode to the (in-arena) position of key 0 — callers must
    mask by the returned alive flag (exactly as they masked pellet_alive
    before)."""
    _, _, ix, iy = pellet_scales(cfg)
    qmask = jnp.int32(PELLET_Q - 1)
    qx = (key >> PELLET_QBITS) & qmask
    qy = key & qmask
    x = (qx.astype(jnp.float32) + 0.5) * ix
    y = (qy.astype(jnp.float32) + 0.5) * iy
    return jnp.stack([x, y], axis=-1), key >= 0


@dataclasses.dataclass(frozen=True)
class GameState:
    # --- players (P = num_agents + bots; slot index IS the pid: SPEC D1) ---
    target: jax.Array          # (P, 2) f32 — movement target (Player.hpp:28)
    action: jax.Array          # (P,)  i32 — {0 none, 1 feed, 2 split}
    split_cooldown: jax.Array  # (P,)  i32
    feed_cooldown: jax.Array   # (P,)  i32
    elapsed_ticks: jax.Array   # (P,)  i32 — per-player tick count
    last_decay_tick: jax.Array # (P,)  i32
    anti_team_decay: jax.Array # (P,)  f32
    virus_eaten_ticks: jax.Array  # (P, K) i32 — ring buffer, -2**30 = empty
    virus_eaten_ptr: jax.Array    # (P,) i32 — next write slot
    food_eaten: jax.Array      # (P,) i32 — pellet-eat stat (Player.hpp:37)
    highest_mass: jax.Array    # (P,) i32
    cells_eaten: jax.Array     # (P,) i32
    viruses_eaten: jax.Array   # (P,) i32

    # --- cells (P, Cc = max_cells) ---
    cell_pos: jax.Array        # (P, Cc, 2) f32
    cell_vel: jax.Array        # (P, Cc, 2) f32
    cell_split_vel: jax.Array  # (P, Cc, 2) f32 — splitting_velocity (Entities.hpp)
    cell_mass: jax.Array       # (P, Cc) i32
    cell_alive: jax.Array      # (P, Cc) bool
    cell_id: jax.Array         # (P, Cc) i32 — monotonic creation id (Ball.hpp:97)
    cell_recombine_at: jax.Array  # (P, Cc) i32 — elapsed_ticks when mergeable (SPEC D3)
    next_cell_id: jax.Array    # () i32 — per-env id counter

    # --- pellets (Np,) ---
    # One int32 key per slot replaces (pos f32x2, alive bool): pellets never
    # move, so the whole pellet state is [qx:15][qy:15] arena-normalized
    # quantized coordinates (SPEC "Pellet position quantization"), dead = -1:
    # 4 bytes per pellet instead of 9. Decode with pellet_xy_alive(cfg) /
    # decode_pellet_xy; encode with encode_pellet_key.
    pellet_key: jax.Array      # (Np,) i32

    # --- viruses (Nv,) ---
    virus_pos: jax.Array       # (Nv, 2) f32
    virus_vel: jax.Array       # (Nv, 2) f32
    virus_mass: jax.Array      # (Nv,) i32
    virus_hits: jax.Array      # (Nv,) i32 — food-hit counter (Entities.hpp:110-112)
    virus_alive: jax.Array     # (Nv,) bool

    # --- foods / ejected mass (Nf,) ---
    food_pos: jax.Array        # (Nf, 2) f32
    food_vel: jax.Array        # (Nf, 2) f32
    food_alive: jax.Array      # (Nf,) bool
    food_next: jax.Array       # () i32 — ring pointer (SPEC Q14)

    # --- globals ---
    ticks: jax.Array           # () i32 — engine tick counter (GameState.hpp)
    seed: jax.Array            # () u32 — RNG stream seed (SPEC D2)
    dones: jax.Array           # (A,) bool — per-agent done flags
    main_respawned: jax.Array  # () bool — screen-env respawn flag

    def replace(self, **changes) -> "GameState":
        """A copy with the given fields swapped (the state is immutable)."""
        return dataclasses.replace(self, **changes)

    @property
    def num_players(self) -> int:
        return self.target.shape[0]

    @property
    def max_cells(self) -> int:
        return self.cell_pos.shape[1]

    def player_mass(self) -> jax.Array:
        """(..., P) i32 — total mass per player (Player.hpp:121-126).

        Negative axes so the helpers also work on vmap-batched states."""
        return jnp.sum(jnp.where(self.cell_alive, self.cell_mass, 0), axis=-1)

    def player_alive(self) -> jax.Array:
        """(..., P) bool — a player is dead when it has no cells
        (Player.hpp:88)."""
        return jnp.any(self.cell_alive, axis=-1)

    def player_centroid(self) -> jax.Array:
        """(P, 2) f32 — mass-weighted cell centroid (Player.hpp:102-114).

        Pinned form (SPEC "Backends"): anchor + sum((pos - anchor) * m) /
        sum(m), the anchor being the player's first live cell slot. A
        one-cell player's centroid is then its cell's position exactly;
        sum(pos * m) / sum(m) rounds, and the GPU's division rounds
        differently from the CPU's. oracle.cpp::centroid mirrors it.
        Dead players get (0, 0) (reference would divide by zero; callers
        only use centroids of live players).
        """
        alive = self.cell_alive
        w = jnp.where(alive, self.cell_mass, 0).astype(jnp.float32)
        total = jnp.sum(w, axis=-1, keepdims=True)
        first = jnp.argmax(alive, axis=-1)[..., None, None]
        anchor = jnp.take_along_axis(self.cell_pos, first, axis=-2)[..., 0, :]
        off = jnp.sum((self.cell_pos - anchor[..., None, :]) * w[..., None],
                      axis=-2)
        c = anchor + off / jnp.maximum(total, 1.0)
        return jnp.where(jnp.any(alive, axis=-1)[..., None], c, 0.0)

    def cell_rank(self) -> jax.Array:
        """(P, Cc) i32 — rank of each live cell among its player's cells by id.

        This is the pinned "vector order" used for all order-dependent
        resolutions (SPEC M1-M7). Dead cells rank after all live ones.
        """
        big = jnp.int32(2**30)
        key = jnp.where(self.cell_alive, self.cell_id, big)
        # counting rank (ids unique): cheaper to fuse than a double argsort
        lower = key[..., :, None] > key[..., None, :]
        return jnp.sum(lower, axis=-1).astype(jnp.int32)

    def pellet_xy_alive(self, cfg: EnvConfig):
        """Decoded ((..., Np, 2) f32, (..., Np) bool) pellet view."""
        return decode_pellet_xy(cfg, self.pellet_key)

    @property
    def pellet_alive(self) -> jax.Array:
        """(..., Np) bool — alive mask derived from the key sign."""
        return self.pellet_key >= 0


jax.tree_util.register_dataclass(
    GameState, data_fields=[f.name for f in dataclasses.fields(GameState)],
    meta_fields=[])


def zero_state(cfg: EnvConfig) -> GameState:
    """All-empty state with the correct static shapes."""
    P = cfg.num_players
    Cc = cfg.max_cells
    Np = cfg.pellet_capacity
    Nv = cfg.virus_capacity
    Nf = cfg.food_capacity
    K = cfg.virus_ticks_capacity
    f32, i32 = jnp.float32, jnp.int32
    return GameState(
        target=jnp.zeros((P, 2), f32),
        action=jnp.zeros((P,), i32),
        split_cooldown=jnp.zeros((P,), i32),
        feed_cooldown=jnp.zeros((P,), i32),
        elapsed_ticks=jnp.zeros((P,), i32),
        last_decay_tick=jnp.zeros((P,), i32),
        anti_team_decay=jnp.ones((P,), f32),
        virus_eaten_ticks=jnp.full((P, K), -(2**30), i32),
        virus_eaten_ptr=jnp.zeros((P,), i32),
        food_eaten=jnp.zeros((P,), i32),
        highest_mass=jnp.full((P,), C.CELL_MIN_SIZE, i32),
        cells_eaten=jnp.zeros((P,), i32),
        viruses_eaten=jnp.zeros((P,), i32),
        cell_pos=jnp.zeros((P, Cc, 2), f32),
        cell_vel=jnp.zeros((P, Cc, 2), f32),
        cell_split_vel=jnp.zeros((P, Cc, 2), f32),
        cell_mass=jnp.zeros((P, Cc), i32),
        cell_alive=jnp.zeros((P, Cc), bool),
        cell_id=jnp.zeros((P, Cc), i32),
        cell_recombine_at=jnp.zeros((P, Cc), i32),
        next_cell_id=jnp.zeros((), i32),
        pellet_key=jnp.full((Np,), DEAD_PELLET_KEY, i32),
        virus_pos=jnp.zeros((Nv, 2), f32),
        virus_vel=jnp.zeros((Nv, 2), f32),
        virus_mass=jnp.full((Nv,), C.VIRUS_INITIAL_MASS, i32),
        virus_hits=jnp.zeros((Nv,), i32),
        virus_alive=jnp.zeros((Nv,), bool),
        food_pos=jnp.zeros((Nf, 2), f32),
        food_vel=jnp.zeros((Nf, 2), f32),
        food_alive=jnp.zeros((Nf,), bool),
        food_next=jnp.zeros((), i32),
        ticks=jnp.zeros((), i32),
        seed=jnp.zeros((), jnp.uint32),
        dones=jnp.zeros((cfg.num_agents,), bool),
        main_respawned=jnp.zeros((), bool),
    )
