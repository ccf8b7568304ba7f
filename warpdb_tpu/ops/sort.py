"""Sort / top-k kernels (ORDER BY, LIMIT).

Replaces the reference's single-GPU-thread O(n²) bubble sorts
(jit.cpp:248-307: ``jit_sort_pairs`` / ``jit_sort_float``) with XLA's
O(n log n) vectorized sort and ``lax.top_k`` for LIMIT-k pulls.

All functions take padded arrays plus a validity mask; invalid (padding
or filtered-out) rows are forced to an "infinity" sentinel so they sort
to the back regardless of direction.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

__all__ = [
    "sort_values", "sort_pairs", "sort_by_keys", "top_k_values",
    "order_key", "float_sort_key", "int_sort_key", "sort_key_any",
]

_F32_INF = jnp.float32(jnp.inf)
_U32_MAX = jnp.uint32(0xFFFFFFFF)


def _sentineled(values: jax.Array, mask: jax.Array, ascending: bool) -> jax.Array:
    """Map invalid lanes to +inf (asc) / -inf (desc) so they land last.
    Used by the top-k pull, which works in value space; NaN values rank
    above +inf under lax.top_k (documented caveat)."""
    sentinel = _F32_INF if ascending else -_F32_INF
    return jnp.where(mask, values, sentinel)


def order_key(values: jax.Array, mask, ascending: bool) -> jax.Array:
    """Direction-aware u32 sort key with an invalid-last sentinel.

    Sorting in ``float_sort_key`` space (a total order where NaN ranks
    above +inf) rather than raw f32 keeps valid rows with NaN keys IN
    the result ahead of the invalid sentinel — a raw ±inf sentinel would
    let NaN-keyed valid rows sort behind it and fall off the row-count
    slice.  (A valid key whose u32 image is exactly the sentinel — only
    an all-ones-payload NaN — still collides; accepted.)

    Integer inputs key through ``int_sort_key`` instead — an f32 cast
    would collide (and mis-order) values beyond 2^24."""
    if jnp.issubdtype(values.dtype, jnp.integer):
        k = int_sort_key(values)
    else:
        k = float_sort_key(values)
    if not ascending:
        k = ~k
    if mask is None:
        return k
    return jnp.where(mask, k, _U32_MAX)


def sort_values(values: jax.Array, mask: jax.Array, ascending: bool) -> jax.Array:
    """Sort valid values; invalid lanes sort to the back.

    Direct analogue of jit_sort_float (jit.cpp:283-307)."""
    k = order_key(values, mask, ascending)
    _, out = lax.sort((k, values), num_keys=1, is_stable=True)
    return out


def sort_pairs(
    keys: jax.Array, values: jax.Array, mask: jax.Array, ascending: bool
):
    """Sort ``values`` by ``keys``; returns (values_sorted, mask_sorted).

    Stable, so equal keys preserve row order (the reference's bubble sort,
    jit.cpp:248-281, was also stable).  Invalid lanes sort last."""
    k = order_key(keys, mask, ascending)
    _, v_sorted, m_sorted = lax.sort(
        (k, values, mask.astype(jnp.int32)), num_keys=1, is_stable=True
    )
    return v_sorted, m_sorted.astype(jnp.bool_)


def sort_by_keys(keys_dirs, values: jax.Array, mask: jax.Array) -> jax.Array:
    """Sort ``values`` by multiple (key, ascending) terms, stable, with
    invalid lanes last — the device path for multi-term
    ``ORDER BY a, b DESC, …`` (extension over the reference's single
    ORDER BY expression, expression.cpp:474-513)."""
    ks = []
    for i, (k, asc) in enumerate(keys_dirs):
        ks.append(order_key(k, mask if i == 0 else None, asc))
    sorted_ops = lax.sort(
        (*ks, values, mask.astype(jnp.int32)),
        num_keys=len(ks),
        is_stable=True,
    )
    return sorted_ops[len(ks)]


def top_k_values(values: jax.Array, mask: jax.Array, k: int, ascending: bool):
    """First ``k`` values of the sorted order — ORDER BY … LIMIT k without
    a full materialised sort when k ≪ N.

    Two-stage hierarchical pull for large inputs: a lane-parallel
    ``top_k`` over row blocks shrinks N to blocks·k candidates, then one
    small ``top_k`` finishes — O(N log k) work, parallel across row
    blocks, instead of a single monolithic pass."""
    v = _sentineled(values, mask, ascending)
    # Work in descending-priority space: u's k largest are the answer.
    u = -v if ascending else v
    # Callers gate this fast path to order keys that provably cannot be
    # NaN (finite stats interval); value-space top-k cannot represent
    # the sort paths' NaN total order.
    n = u.shape[0]
    # Stage 1: per-block candidates from a blocked top_k (few wide rows:
    # the block size is untuned on the current device).
    if n >= (1 << 16) and k <= 1024:
        block = 1 << max(13, min(18, (n // 128).bit_length() - 1))
        while block < 8 * k:
            block *= 2
        if n % block == 0 and n // block > 1:
            u = lax.top_k(u.reshape(n // block, block), k)[0].reshape(-1)
    out, _ = lax.top_k(u, k)  # descending in u-space
    return -out if ascending else out


def int_sort_key(values: jax.Array) -> jax.Array:
    """Order-preserving bijection int32 → uint32 (sign-bit flip)."""
    bits = lax.bitcast_convert_type(values.astype(jnp.int32), jnp.uint32)
    return bits ^ jnp.uint32(0x80000000)


def sort_key_any(values: jax.Array) -> jax.Array:
    """Order-preserving u32 key in the array's own domain: raw int bits
    for integer arrays (exact beyond f32's 2^24 integer ceiling —
    csv_loader.hpp:13 declares Int32/Int64 first-class), the f32
    total-order key otherwise.  Every kernel that groups/joins/orders in
    u32 key space dispatches through this, so raw int keys are exact
    end-to-end."""
    if jnp.issubdtype(values.dtype, jnp.integer):
        return int_sort_key(values)
    return float_sort_key(values)


def float_sort_key(values: jax.Array) -> jax.Array:
    """Order-preserving bijection f32 → uint32 (for radix-style keying and
    exact float grouping): flips the sign bit for non-negatives and all
    bits for negatives, so unsigned integer order == float order.
    Normalises -0.0 to +0.0, and every NaN to the positive canonical NaN
    (XLA freely produces negative-sign NaNs — e.g. 0/0 inside jit on CPU
    — whose raw bits would rank below -inf and group apart), so zeros and
    NaNs each form one group and NaN ranks last."""
    v = jnp.where(values == 0.0, jnp.float32(0.0), values)
    v = jnp.where(jnp.isnan(v), jnp.float32(jnp.nan), v)
    bits = lax.bitcast_convert_type(v, jnp.uint32)
    flipped = jnp.where(
        bits >= jnp.uint32(0x80000000),
        ~bits,
        bits | jnp.uint32(0x80000000),
    )
    return flipped
