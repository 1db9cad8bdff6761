"""Batched (vmapped) environments — the accelerator replacement for the
reference's one-process-one-game model and its ThreadPool bot evaluator
(/root/reference/agario/bots/benchmark.cpp:134-171, SURVEY §2 item 7).

Thousands of lockstep games run per device under one jit; `parallel.mesh`
shards the env axis across devices and hosts.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from agarcl_tpu import prng
from agarcl_tpu.config import EnvConfig
from agarcl_tpu.env import env_reset, env_step
from agarcl_tpu.obs.grid import GridObsConfig, grid_frame
from agarcl_tpu.obs.ram import RamObsConfig, ram_frame
from agarcl_tpu.state import GameState


def make_obs_fn(cfg: EnvConfig, obs_type: str, obs_config=None):
    """Returns (frame_fn, num_frames) for an observation type
    ('none' | 'ram' | 'grid' | 'screen' | 'gobigger')."""
    if obs_type == "none":
        return None, 1
    if obs_type == "ram":
        ocfg = obs_config or RamObsConfig()
        return functools.partial(ram_frame, cfg, ocfg), 1
    if obs_type == "grid":
        ocfg = obs_config or GridObsConfig()
        return functools.partial(grid_frame, cfg, ocfg), ocfg.num_frames
    if obs_type == "screen":
        from agarcl_tpu.obs.screen import ScreenObsConfig, screen_frame
        ocfg = obs_config or ScreenObsConfig()
        return functools.partial(screen_frame, cfg, ocfg), ocfg.num_frames
    if obs_type == "gobigger":
        # structured dict frame (a pytree of fixed-shape arrays + masks) —
        # vmaps/scan-stacks like any tensor obs; use
        # obs.gobigger.batch_player_states for the host-side rim conversion
        from agarcl_tpu.obs.gobigger import GoBiggerObsConfig, gobigger_frame
        ocfg = obs_config or GoBiggerObsConfig()
        return functools.partial(gobigger_frame, cfg, ocfg), 1
    raise ValueError(f"unknown obs_type {obs_type!r}")


class VecEnv:
    """N lockstep environments, jitted + vmapped.

    reset(seed) -> (states, obs); step(states, actions) ->
    (states, obs, rewards, dones). actions: (N, A, 3) float (dx, dy, act).
    With auto_reset=True, finished envs are re-seeded and reset in-step
    (episodic training loops); otherwise dones pass through (continual RL,
    the reference's default for gym env_type != 0).
    """

    def __init__(self, cfg: EnvConfig, num_envs: int, obs_type: str = "ram",
                 obs_config=None, auto_reset: bool = False,
                 respawn_main_during_obs: bool = False, donate: bool = True):
        self.cfg = cfg
        self.num_envs = num_envs
        self.obs_type = obs_type
        frame_fn, num_frames = make_obs_fn(cfg, obs_type, obs_config)
        self._frame_fn = frame_fn
        self.num_frames = num_frames
        self.auto_reset = auto_reset
        self.respawn_main_during_obs = respawn_main_during_obs

        def _step_one(state, actions):
            out = env_step(cfg, state, actions,
                           respawn_main_during_obs=respawn_main_during_obs,
                           obs_fn=frame_fn, num_frames=num_frames)
            if frame_fn is None:
                state, rewards, dones = out
                obs = None
            else:
                state, obs, rewards, dones = out
            if auto_reset:
                done_all = jnp.any(dones)
                # derive the fresh seed on device (no host transfer per step)
                reset_seed = prng.hash_u32(state.seed, 7,
                                           state.ticks.astype(jnp.uint32),
                                           0, 0)
                fresh = env_reset(cfg, reset_seed)
                state = jax.tree.map(
                    lambda f, s: jnp.where(
                        jnp.reshape(done_all, (1,) * s.ndim), f, s),
                    fresh, state)
            return state, obs, rewards, dones

        step_b = jax.vmap(_step_one)
        donate_argnums = (0,) if donate else ()
        self._reset_b = jax.jit(jax.vmap(functools.partial(env_reset, cfg)))
        self._step_b = jax.jit(step_b, donate_argnums=donate_argnums)
        self._obs_b = (jax.jit(jax.vmap(frame_fn))
                       if frame_fn is not None else None)

        def _multi_step(states, actions, k):
            # chain k env-steps inside one program (amortizes dispatch; the
            # shape a fused actor-learner loop would use). obs is stacked
            # per step — keeping it in the output forces it to be computed
            # every step (discarding it would let XLA dead-code the whole
            # observation path and overstate throughput).
            def body(s, _):
                s, obs, rewards, dones = step_b(s, actions)
                return s, (obs, rewards, dones)
            states, (obs, rewards, dones) = jax.lax.scan(
                body, states, None, length=k)
            return states, obs, rewards, dones

        self._multi_step = jax.jit(_multi_step, static_argnums=(2,),
                                   donate_argnums=donate_argnums)

    def reset(self, seed: int = 0):
        seeds = jnp.arange(self.num_envs, dtype=jnp.uint32) + jnp.uint32(
            (seed * 0x9E3779B9) & 0xFFFFFFFF)
        states = self._reset_b(seeds)
        obs = self._obs_b(states) if self._obs_b is not None else None
        return states, obs

    def step(self, states: GameState, actions):
        """actions: (N, A, 3). Returns (states, obs, rewards, dones)."""
        return self._step_b(states, jnp.asarray(actions, jnp.float32))

    def multi_step(self, states: GameState, actions, k: int):
        """Run k env-steps in one device program with the same actions —
        the dispatch-amortized path for throughput-critical loops.
        Returns (states, obs (k, N, ...) or None, rewards (k, N, A),
        dones (k, N, A)); obs is produced every step (never dead-coded)."""
        return self._multi_step(states, jnp.asarray(actions, jnp.float32), k)
