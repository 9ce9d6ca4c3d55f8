"""Counter-based per-lane RNG.

The reference uses stateless wang_hash chains on both the CPU wavefront
(wf_math.h:35-49) and the GPU (device_programs.cu:112-125), seeded per pixel
and frame (`wang_hash((pixel+1) ^ (frame*9781+1))`, device_programs.cu:256;
`wang_hash(pixel_seed ^ (s*9781+1))`, wf_pt_cpu.cpp:91).

A uint32 state per lane advanced by branchless integer ops — no cross-lane
interaction, fully deterministic, and bit-exact between the megakernel and wavefront integrators
(the parity-test foundation, SURVEY.md §4).  We keep the exact wang-hash
recurrence so radiometric tests can be seeded reproducibly; jax.random
(threefry) wrappers are provided for consumers who want JAX-native keys.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_U32 = jnp.uint32


def wang_hash(x: jnp.ndarray) -> jnp.ndarray:
    """Vectorized Wang hash over uint32 lanes (wf_math.h:35-44)."""
    x = x.astype(_U32)
    x = (x ^ _U32(61)) ^ (x >> 16)
    x = x * _U32(9)
    x = x ^ (x >> 4)
    x = x * _U32(0x27D4EB2D)
    x = x ^ (x >> 15)
    return x


def seed_paths(pixel_index: jnp.ndarray, frame_index) -> jnp.ndarray:
    """Per-path RNG state for a frame (device_programs.cu:256:
    `wang_hash((pixel + 1) ^ (frameIndex * 9781 + 1))`)."""
    p = pixel_index.astype(_U32) + _U32(1)
    f = _U32(frame_index) * _U32(9781) + _U32(1) if isinstance(frame_index, int) \
        else frame_index.astype(_U32) * _U32(9781) + _U32(1)
    return wang_hash(p ^ f)


def seed_samples(pixel_seed: jnp.ndarray, sample_index) -> jnp.ndarray:
    """Per-(pixel, sample) state (wf_pt_cpu.cpp:91:
    `wang_hash(pixel_seed ^ (s*9781+1))`)."""
    s = _U32(sample_index) if isinstance(sample_index, int) else sample_index.astype(_U32)
    return wang_hash(pixel_seed.astype(_U32) ^ (s * _U32(9781) + _U32(1)))


def next_float(state: jnp.ndarray):
    """Advance each lane and return (new_state, uniform in [0,1)).

    Matches rng_next01 (device_programs.cu:122-125): 24 low bits / 2^24.
    """
    state = wang_hash(state)
    # Route the cast through int32: the masked value fits in 24 bits.
    bits = (state & _U32(0x00FFFFFF)).astype(jnp.int32)
    u = bits.astype(jnp.float32) * jnp.float32(1.0 / 16777216.0)
    return state, u


def next_float2(state: jnp.ndarray):
    state, u1 = next_float(state)
    state, u2 = next_float(state)
    return state, u1, u2


# --- jax.random interop -----------------------------------------------------

def key_fold(key: jax.Array, *data: int) -> jax.Array:
    """Derive a subkey by folding integers into a threefry key."""
    for d in data:
        key = jax.random.fold_in(key, d)
    return key


def uniform_lanes(key: jax.Array, shape) -> jnp.ndarray:
    """Threefry uniforms for consumers that prefer JAX-native RNG."""
    return jax.random.uniform(key, shape, dtype=jnp.float32)
