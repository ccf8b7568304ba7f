"""HyperLogLog: APPROX_COUNT_DISTINCT with mergeable bounded state.

The exact COUNT(DISTINCT) paths are already fast on one chip (sorts are
the engine's cheapest primitive), but their MERGE state grows with the
distinct count — per-chunk sorted-unique sets for streaming, shuffled
value sets for the mesh.  HyperLogLog bounds the per-group state at
``m`` one-byte registers (4 KB at m=4096) that merge by elementwise
max — exactly the mergeable-partial shape the engine's streaming and
distributed tiers are built around (see CLAUDE.md architecture
invariants: the partial form is the merge unit).

Device mapping:

* values hash through their ``float_sort_key`` image, so the distinct
  semantics match the exact kernels bit-for-bit (-0.0 ≡ +0.0, every
  NaN is ONE value, string codes hash per the table's shared
  vocabulary);
* the register update is ONE scatter-max of ``seg·m + bucket`` — the
  same per-update-bounded scatter the midrange GROUP BY rides;
* the estimator (harmonic mean + linear-counting correction) is pure
  elementwise work over the (G, m) register table, vectorized
  across groups.

Standard error ≈ 1.04/√m → ~1.6% at the default m=4096.  The reference
has no approximate aggregates (its GROUP BY is a single-thread O(N·G)
loop, jit.cpp:179-246); this is a production-engine extension.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from jax import lax

__all__ = ["HLL_P", "HLL_M", "hll_hash", "hll_rho_bucket",
           "hll_grouped_registers", "hll_estimate", "hll_estimate_np"]

HLL_P = 12               # register-index bits
HLL_M = 1 << HLL_P       # 4096 registers, ~1.6% standard error


def hll_hash(u: jnp.ndarray) -> jnp.ndarray:
    """murmur3 fmix32 over a u32 word — full-avalanche finalizer, so
    low bits (bucket) and high bits (rho) are independently mixed."""
    h = u.astype(jnp.uint32)
    h = h ^ (h >> 16)
    h = h * jnp.uint32(0x85EBCA6B)
    h = h ^ (h >> 13)
    h = h * jnp.uint32(0xC2B2AE35)
    h = h ^ (h >> 16)
    return h


def hll_rho_bucket(h: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(rho, bucket) from a mixed hash: bucket = low p bits; rho = the
    1-based position of the leftmost 1 among the remaining 32-p bits
    (all-zero → 32-p+1, the standard saturation)."""
    bucket = (h & jnp.uint32(HLL_M - 1)).astype(jnp.int32)
    w = (h >> HLL_P).astype(jnp.int32)  # top 20 bits, zero-extended
    # clz over the 32-bit word counts 12 guaranteed-zero high bits.
    rho = lax.clz(w) - jnp.int32(HLL_P - 1)
    return rho, bucket


def hll_grouped_registers(seg, skey_u32, valid, capacity: int):
    """Scatter-max HLL registers for ``capacity`` groups.

    ``seg``: i32 per-row group id in ascending-key order (invalid rows
    anywhere out of [0, capacity)); ``skey_u32``: the value's
    float_sort_key image (u32).  Returns i32[capacity, HLL_M]."""
    rho, bucket = hll_rho_bucket(hll_hash(skey_u32))
    slot = seg * jnp.int32(HLL_M) + bucket
    oob = jnp.int32(capacity * HLL_M)
    slot = jnp.where(valid, slot, oob)
    regs = (
        jnp.zeros((capacity * HLL_M,), jnp.int32)
        .at[slot]
        .max(rho, mode="drop")
    )
    return regs.reshape(capacity, HLL_M)


def _alpha(m: int) -> float:
    return 0.7213 / (1.0 + 1.079 / m)


def hll_estimate(regs: jnp.ndarray) -> jnp.ndarray:
    """Per-group cardinality estimates from (G, m) registers (device).

    Harmonic-mean raw estimate with the standard small-range
    linear-counting correction (E ≤ 2.5m with empty registers present).
    The 2^32-range correction is omitted: 32-bit hashes over f32/string
    -code domains cannot approach it."""
    m = regs.shape[1]
    rf = regs.astype(jnp.float32)
    z = jnp.sum(jnp.exp2(-rf), axis=1)
    raw = jnp.float32(_alpha(m) * m * m) / z
    zeros = jnp.sum((regs == 0).astype(jnp.float32), axis=1)
    linear = jnp.float32(m) * jnp.log(jnp.float32(m) / jnp.maximum(zeros, 1))
    use_linear = jnp.logical_and(raw <= 2.5 * m, zeros > 0)
    return jnp.where(use_linear, linear, raw)


def hll_estimate_np(regs: np.ndarray) -> np.ndarray:
    """NumPy twin of :func:`hll_estimate` for merged streaming partials
    — f32 throughout, mirroring the device estimator, so a streamed
    estimate matches the in-memory one to float precision (the register
    merge by max is exactly lossless; only estimator arithmetic could
    diverge, and it is kept in lockstep)."""
    regs = np.asarray(regs)
    m = regs.shape[1]
    rf = regs.astype(np.float32)
    z = np.sum(np.exp2(-rf), axis=1, dtype=np.float32)
    raw = np.float32(_alpha(m) * m * m) / z
    zeros = np.sum(regs == 0, axis=1).astype(np.float32)
    linear = np.float32(m) * np.log(
        np.float32(m) / np.maximum(zeros, 1)
    ).astype(np.float32)
    use_linear = (raw <= 2.5 * m) & (zeros > 0)
    return np.where(use_linear, linear, raw).astype(np.float32)
