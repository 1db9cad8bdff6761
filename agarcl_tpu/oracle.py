"""ctypes binding for the C++ parity oracle (oracle/oracle.cpp).

The oracle is an independent scalar implementation of the pinned tick spec
(SPEC.md); parity tests run the JAX engine and the oracle side by side from
the same seed and compare trajectories. Builds `liboracle.so` from
`oracle.cpp` on first use with `make`, under a file lock so that parallel test
workers build it once.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess

import numpy as np

from agarcl_tpu.config import EnvConfig

_ORACLE_DIR = os.environ.get("AGARCL_ORACLE_DIR") or os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "oracle")
_LIB_PATH = os.path.join(_ORACLE_DIR, "liboracle.so")

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(os.path.join(_ORACLE_DIR, "oracle.cpp")):
        raise FileNotFoundError(
            f"parity oracle sources not found at {_ORACLE_DIR}. The oracle is "
            "a development/parity-test tool that lives in the repository "
            "checkout, not the installed wheel; run from a checkout or set "
            "AGARCL_ORACLE_DIR to the oracle/ directory.")
    with open(os.path.join(_ORACLE_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if (not os.path.exists(_LIB_PATH)
                or os.path.getmtime(_LIB_PATH)
                < os.path.getmtime(os.path.join(_ORACLE_DIR, "oracle.cpp"))):
            subprocess.run(["make", "-C", _ORACLE_DIR], check=True,
                           capture_output=True)
        lib = ctypes.CDLL(_LIB_PATH)
    lib.oracle_create.restype = ctypes.c_void_p
    lib.oracle_create.argtypes = [ctypes.c_int] * 13 + [
        ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 8
    lib.oracle_destroy.argtypes = [ctypes.c_void_p]
    lib.oracle_reset.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
    lib.oracle_tick.argtypes = [ctypes.c_void_p]
    lib.oracle_set_respawn_main.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.oracle_step.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_float),
                                ctypes.POINTER(ctypes.c_double),
                                ctypes.POINTER(ctypes.c_uint8)]
    F = ctypes.POINTER(ctypes.c_float)
    I = ctypes.POINTER(ctypes.c_int)
    U = ctypes.POINTER(ctypes.c_uint8)
    lib.oracle_get_state.argtypes = (
        [ctypes.c_void_p]
        + [F, I, I, I, I, I, F, I, I, I, I]      # player fields
        + [F, F, F, I, U, I, I]                  # cell fields
        + [F, U]                                 # pellets
        + [F, F, I, I, U]                        # viruses
        + [F, F, U]                              # foods
        + [ctypes.POINTER(ctypes.c_int64)])
    lib.oracle_set_state.argtypes = (
        [ctypes.c_void_p]
        + [F, I, I, I, I, I, F, I, I, I, I, I, I]    # player fields
        + [F, F, F, I, U, I, I, ctypes.c_int]        # cell fields
        + [F, U]                                     # pellets
        + [F, F, I, I, U]                            # viruses
        + [F, F, U, ctypes.c_int]                    # foods
        + [ctypes.c_int64, ctypes.c_uint32, U, ctypes.c_int])
    _lib = lib
    return lib


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


class OracleEnv:
    """Scalar single-env oracle with the same reset/step API as env.py."""

    def __init__(self, cfg: EnvConfig, respawn_main_during_obs: bool = False):
        self.cfg = cfg
        lib = _load()
        ms = cfg.mode_spec
        bots = np.asarray(cfg.bot_types(), np.int32)
        self._h = lib.oracle_create(
            cfg.num_agents, cfg.ticks_per_step, cfg.arena_size,
            cfg.num_pellets, cfg.num_viruses, cfg.mode,
            int(cfg.reward_type), cfg.c_death, cfg.max_cells,
            cfg.pellet_capacity, cfg.virus_capacity, cfg.food_capacity,
            cfg.virus_ticks_capacity,
            _ptr(bots, ctypes.c_int), cfg.num_players,
            int(ms.mass_decay), int(ms.squared_pellets), int(ms.pellet_regen),
            ms.agent_mass, int(ms.respawn_all), int(ms.done_on_death),
            int(ms.done_on_max_mass))
        lib.oracle_set_respawn_main(self._h, int(respawn_main_during_obs))
        self._lib = lib

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.oracle_destroy(self._h)
            self._h = None

    def reset(self, seed: int):
        self._lib.oracle_reset(self._h, ctypes.c_uint32(seed))

    def tick(self):
        self._lib.oracle_tick(self._h)

    def step(self, actions):
        """actions: (A, 3) -> (rewards (A,), dones (A,) bool)."""
        A = self.cfg.num_agents
        acts = np.ascontiguousarray(np.asarray(actions, np.float32)
                                    .reshape(A, 3))
        rewards = np.zeros((A,), np.float64)
        dones = np.zeros((A,), np.uint8)
        self._lib.oracle_step(self._h, _ptr(acts, ctypes.c_float),
                              _ptr(rewards, ctypes.c_double),
                              _ptr(dones, ctypes.c_uint8))
        return rewards, dones.astype(bool)

    def set_state(self, state) -> None:
        """Load one env's GameState (unbatched) into the oracle."""
        cfg = self.cfg

        def arr(x, dtype):
            return np.ascontiguousarray(np.asarray(x), dtype=dtype)

        f32, i32, u8 = np.float32, np.int32, np.uint8
        ppos, palive = state.pellet_xy_alive(cfg)
        bufs = [
            arr(state.target, f32), arr(state.action, i32),
            arr(state.split_cooldown, i32), arr(state.feed_cooldown, i32),
            arr(state.elapsed_ticks, i32), arr(state.last_decay_tick, i32),
            arr(state.anti_team_decay, f32),
            arr(state.virus_eaten_ticks, i32), arr(state.virus_eaten_ptr, i32),
            arr(state.food_eaten, i32), arr(state.highest_mass, i32),
            arr(state.cells_eaten, i32), arr(state.viruses_eaten, i32),
            arr(state.cell_pos, f32), arr(state.cell_vel, f32),
            arr(state.cell_split_vel, f32), arr(state.cell_mass, i32),
            arr(state.cell_alive, u8), arr(state.cell_id, i32),
            arr(state.cell_recombine_at, i32),
            int(state.next_cell_id),
            arr(ppos, f32), arr(palive, u8),
            arr(state.virus_pos, f32), arr(state.virus_vel, f32),
            arr(state.virus_mass, i32), arr(state.virus_hits, i32),
            arr(state.virus_alive, u8),
            arr(state.food_pos, f32), arr(state.food_vel, f32),
            arr(state.food_alive, u8), int(state.food_next),
            int(state.ticks), int(state.seed),
            arr(state.dones, u8), int(state.main_respawned)]
        ctype = {f32: ctypes.c_float, i32: ctypes.c_int, u8: ctypes.c_uint8}
        args = [_ptr(b, ctype[b.dtype.type]) if isinstance(b, np.ndarray)
                else b for b in bufs]
        self._lib.oracle_set_state(self._h, *args)

    def get_state(self) -> dict:
        """Export the full state as numpy arrays shaped like GameState."""
        cfg = self.cfg
        P, Cc = cfg.num_players, cfg.max_cells
        Np, Nv, Nf = cfg.pellet_capacity, cfg.virus_capacity, cfg.food_capacity
        out = dict(
            target=np.zeros((P, 2), np.float32),
            action=np.zeros((P,), np.int32),
            split_cooldown=np.zeros((P,), np.int32),
            feed_cooldown=np.zeros((P,), np.int32),
            elapsed_ticks=np.zeros((P,), np.int32),
            last_decay_tick=np.zeros((P,), np.int32),
            anti_team_decay=np.zeros((P,), np.float32),
            food_eaten=np.zeros((P,), np.int32),
            highest_mass=np.zeros((P,), np.int32),
            cells_eaten=np.zeros((P,), np.int32),
            viruses_eaten=np.zeros((P,), np.int32),
            cell_pos=np.zeros((P, Cc, 2), np.float32),
            cell_vel=np.zeros((P, Cc, 2), np.float32),
            cell_split_vel=np.zeros((P, Cc, 2), np.float32),
            cell_mass=np.zeros((P, Cc), np.int32),
            cell_alive=np.zeros((P, Cc), np.uint8),
            cell_id=np.zeros((P, Cc), np.int32),
            cell_recombine_at=np.zeros((P, Cc), np.int32),
            pellet_pos=np.zeros((Np, 2), np.float32),
            _pellet_alive=np.zeros((Np,), np.uint8),
            virus_pos=np.zeros((Nv, 2), np.float32),
            virus_vel=np.zeros((Nv, 2), np.float32),
            virus_mass=np.zeros((Nv,), np.int32),
            virus_hits=np.zeros((Nv,), np.int32),
            virus_alive=np.zeros((Nv,), np.uint8),
            food_pos=np.zeros((Nf, 2), np.float32),
            food_vel=np.zeros((Nf, 2), np.float32),
            food_alive=np.zeros((Nf,), np.uint8),
            ticks=np.zeros((1,), np.int64),
        )
        f32, i32, u8 = ctypes.c_float, ctypes.c_int, ctypes.c_uint8
        self._lib.oracle_get_state(
            self._h,
            _ptr(out["target"], f32), _ptr(out["action"], i32),
            _ptr(out["split_cooldown"], i32), _ptr(out["feed_cooldown"], i32),
            _ptr(out["elapsed_ticks"], i32), _ptr(out["last_decay_tick"], i32),
            _ptr(out["anti_team_decay"], f32), _ptr(out["food_eaten"], i32),
            _ptr(out["highest_mass"], i32), _ptr(out["cells_eaten"], i32),
            _ptr(out["viruses_eaten"], i32),
            _ptr(out["cell_pos"], f32), _ptr(out["cell_vel"], f32),
            _ptr(out["cell_split_vel"], f32), _ptr(out["cell_mass"], i32),
            _ptr(out["cell_alive"], u8), _ptr(out["cell_id"], i32),
            _ptr(out["cell_recombine_at"], i32),
            _ptr(out["pellet_pos"], f32), _ptr(out["_pellet_alive"], u8),
            _ptr(out["virus_pos"], f32), _ptr(out["virus_vel"], f32),
            _ptr(out["virus_mass"], i32), _ptr(out["virus_hits"], i32),
            _ptr(out["virus_alive"], u8),
            _ptr(out["food_pos"], f32), _ptr(out["food_vel"], f32),
            _ptr(out["food_alive"], u8),
            out["ticks"].ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        # pellet state is keyed in GameState (state.py quantization); the
        # oracle stores pre-quantized coords, so encode() is exact and the
        # exported dict mirrors GameState field-for-field.
        alive = out.pop("_pellet_alive").astype(bool)
        out["pellet_alive"] = alive
        sx = np.float32(32768.0 / self.cfg.arena_width)
        sy = np.float32(32768.0 / self.cfg.arena_height)
        qx = np.clip(np.floor(out["pellet_pos"][:, 0] * sx), 0,
                     32767).astype(np.int32)
        qy = np.clip(np.floor(out["pellet_pos"][:, 1] * sy), 0,
                     32767).astype(np.int32)
        out["pellet_key"] = np.where(alive, (qx << 15) | qy,
                                     np.int32(-1))
        return out
