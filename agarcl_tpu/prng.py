"""Counter-based deterministic RNG, bit-identical in JAX and the C++ oracle.

The reference mixes `std::rand`, `mt19937_64` and `random_device` reseeds
(/root/reference/agario/engine/Engine.hpp:49,108,242-245, bots/Bot.hpp:94-96);
SPEC.md pin D2 replaces all of them with this single stateless hash so every
random draw is a pure function of (seed, stream, tick, slot, axis).

The mix is the public-domain `lowbias32` finalizer applied to a running
xor/multiply accumulation of the counters. It is a few elementwise uint32
ops, fully vectorized on any backend, and ~10 lines of C++ in the oracle.
"""

from __future__ import annotations

import jax.numpy as jnp

# Stream identifiers (must match oracle/src/prng.h).
STREAM_PELLET = 1
STREAM_VIRUS = 2
STREAM_RESPAWN = 3
STREAM_BOT = 4
STREAM_FOOD_VIRUS = 5
STREAM_INIT = 6

_GOLDEN = jnp.uint32(0x9E3779B9)


def _mix(h):
    """lowbias32 finalizer (public domain, Chris Wellons)."""
    h = jnp.uint32(h)
    h = h ^ (h >> 16)
    h = h * jnp.uint32(0x7FEB352D)
    h = h ^ (h >> 15)
    h = h * jnp.uint32(0x846CA68B)
    h = h ^ (h >> 16)
    return h


def hash_u32(seed, stream, tick, slot, axis=0):
    """uint32 hash of the 5 counters; broadcasts over array arguments."""
    h = jnp.uint32(seed) * _GOLDEN
    for v in (stream, tick, slot, axis):
        h = _mix(h ^ (jnp.asarray(v).astype(jnp.uint32) * _GOLDEN))
    return h


def uniform(seed, stream, tick, slot, axis=0):
    """float32 uniform in [0, 1) with 24 bits of entropy."""
    bits = hash_u32(seed, stream, tick, slot, axis) >> jnp.uint32(8)
    return bits.astype(jnp.float32) * jnp.float32(1.0 / (1 << 24))


def uniform_range(lo, hi, seed, stream, tick, slot, axis=0):
    """float32 uniform in [lo, hi)."""
    return lo + (hi - lo) * uniform(seed, stream, tick, slot, axis)


def uniform_q(nq, seed, stream, tick, slot, axis=0):
    """int32 in [0, nq) from the top 24 hash bits via exact integer
    multiply-shift: (u24 * nq) >> 24, computed in two 12-bit halves
    (floor(floor(x/2^12)/2^12) == floor(x/2^24)) so nothing overflows
    int32 for nq <= 2^15. Unlike `floor(uniform_range(...) * scale)`,
    this is bit-exact across XLA programs, backends and C++ — float
    mul+add chains can be FMA-contracted differently per program, and a
    1-ulp difference amplifies to a full cell through floor. Used for
    the quantized pellet-key spawn coordinates (state.py)."""
    u24 = (hash_u32(seed, stream, tick, slot, axis)
           >> jnp.uint32(8)).astype(jnp.int32)
    nq = jnp.asarray(nq).astype(jnp.int32)
    hi = u24 >> 12
    lo = u24 & 0xFFF
    return (hi * nq + ((lo * nq) >> 12)) >> 12


def randint_mod(n, seed, stream, tick, slot, axis=0):
    """int32 in [0, n) via modulo (mirrors reference's `rand() % n`)."""
    bits = hash_u32(seed, stream, tick, slot, axis)
    return (bits % jnp.asarray(n).astype(jnp.uint32)).astype(jnp.int32)
