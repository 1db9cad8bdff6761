"""agarcl_tpu — a JAX re-implementation of the AgarCL continual-RL benchmark
platform.

The reference (machado-research/AgarCL) is a C++17 header-only Agar.io engine
with pybind11-bound RL environments; this package rebuilds the same
capabilities as a pure-functional, shape-static simulation that runs thousands
of lockstep games per device under `jit`/`vmap` and shards the env batch
across devices and hosts. See SPEC.md for the pinned determinism contract.
"""

from agarcl_tpu.config import EnvConfig, ModeSpec
from agarcl_tpu.state import GameState, zero_state
from agarcl_tpu.env import (apply_actions, env_reset, env_step,
                            jit_env_reset, jit_env_step, respawn_players)

__version__ = "0.1.0"

__all__ = [
    "EnvConfig", "ModeSpec", "GameState", "zero_state", "env_reset",
    "env_step", "jit_env_reset", "jit_env_step", "apply_actions",
    "respawn_players", "VecEnv", "__version__",
]


def __getattr__(name):
    # lazy convenience exports (avoid importing jax-heavy modules eagerly)
    if name == "VecEnv":
        from agarcl_tpu.vec import VecEnv
        return VecEnv
    if name == "AgarioEnv":
        from agarcl_tpu.gym_env import AgarioEnv
        return AgarioEnv
    raise AttributeError(name)
