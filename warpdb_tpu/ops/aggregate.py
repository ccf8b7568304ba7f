"""Grouped aggregation (GROUP BY / HAVING / DISTINCT) and window
aggregates.

The reference's GROUP BY kernel is a **single GPU thread** doing an
O(N·G) linear key scan (jit.cpp:179-246), hardcoded to one schema and
supporting only SUM; HAVING/MIN/MAX/AVG/COUNT lived in a broken host
loop (warpdb.cpp:373-437).  The design here is a sort-based segmented
aggregate — fully vectorized, deterministic, one fused XLA program:

1. keys are made radix-sortable (``float_sort_key``), invalid rows get a
   MAX sentinel so they sort to the back;
2. one ``lax.sort`` groups equal keys into contiguous segments,
   carrying the values and the original f32 keys;
3. segment boundaries → group ids via prefix sum;
4. scatter-add/min/max into a fixed ``capacity``-sized output (padding
   groups dropped via out-of-range indices).

Group order in the output is ascending by key — the deterministic
default the repaired reference semantics pin
(sql_features_test.cpp:11-21 recomputes expectations via ``std::map``,
i.e. key-ascending).

All five aggregates are computed in one pass; AVG = SUM/COUNT at the
consumer.  DISTINCT is the same machinery with values as keys
(matching the reference's host ``sort+unique``, warpdb.cpp:463-468).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from .sort import float_sort_key, sort_key_any as _sort_key_any

__all__ = [
    "GroupResult",
    "sorted_first_flags",
    "ValueAggregates",
    "group_aggregate",
    "midrange_group_aggregate",
    "count_distinct",
    "distinct_values",
    "window_aggregate",
]

_U32_MAX = jnp.uint32(0xFFFFFFFF)


class ValueAggregates(NamedTuple):
    """Per-group aggregates of one value column."""

    sums: jax.Array  # f32[capacity]
    mins: jax.Array  # f32[capacity]
    maxs: jax.Array  # f32[capacity]


class GroupResult(NamedTuple):
    """Fixed-capacity aggregate table; rows ≥ num_groups are padding.
    Groups are ordered ascending by key."""

    keys: tuple                           # tuple of f32[capacity] key columns
    counts: jax.Array                     # i32[capacity] — rows per group
    values: tuple                         # tuple[ValueAggregates, ...]
    num_groups: jax.Array                 # i32 scalar


def _as_key_tuple(keys) -> tuple:
    if isinstance(keys, (tuple, list)):
        return tuple(keys)
    return (keys,)



def sorted_first_flags(skeys_s: tuple) -> jax.Array:
    """Row-starts-a-new-key-run flags over lexicographically sorted key
    columns (position 0 is always a start).  Shared by every segmented
    operator so boundary semantics cannot drift between paths."""
    first = jnp.zeros(skeys_s[0].shape, jnp.bool_).at[0].set(True)
    for sk in skeys_s:
        first = jnp.logical_or(first, jnp.concatenate(
            [jnp.zeros((1,), jnp.bool_), sk[1:] != sk[:-1]]
        ))
    return first

def group_sort_stage(keys, values_list, mask: jax.Array, skeys=None):
    """The expensive half of a segmented aggregate: ONE stable sort by
    key tuple carrying every value column, plus segment ids and the
    distinct-group count.

    Returned arrays stay on device, so the executor's two-phase capacity
    protocol only transfers the scalar ``num_groups`` between phases and
    the scatter phase reuses this sort instead of re-sorting
    (historically the count pass and the aggregate pass each paid a full
    O(N log² N) sort).

    ``skeys`` overrides the u32 sort keys (callers pass
    ``int_sort_key(raw_column)`` for bare integer keys, whose values
    beyond f32's 2^24 integer ceiling would collide under the default
    ``float_sort_key(f32 cast)`` — csv_loader.hpp:13 declares Int64 a
    first-class type); the invalid-row sentinel is applied here either
    way."""
    keys = _as_key_tuple(keys)
    values_list = tuple(values_list)
    valid = mask
    if skeys is None:
        skeys = tuple(
            jnp.where(valid, _sort_key_any(k), _U32_MAX) for k in keys
        )
    else:
        skeys = tuple(
            jnp.where(valid, sk, _U32_MAX) for sk in _as_key_tuple(skeys)
        )
    nk = len(skeys)

    sorted_ops = lax.sort(
        skeys + keys + (valid.astype(jnp.int32),) + values_list,
        num_keys=nk,
        is_stable=True,
    )
    skeys_s = sorted_ops[:nk]
    keys_s = sorted_ops[nk : 2 * nk]
    valid_s = sorted_ops[2 * nk].astype(jnp.bool_)
    vals_s = sorted_ops[2 * nk + 1 :]

    first = jnp.logical_and(sorted_first_flags(skeys_s), valid_s)
    seg = jnp.cumsum(first.astype(jnp.int32)) - 1
    num_groups = jnp.sum(first.astype(jnp.int32))
    return keys_s, vals_s, valid_s, seg, num_groups


def group_scatter_stage(
    keys_s, vals_s, valid_s, seg, num_groups, capacity: int,
    need: tuple = ("sum", "min", "max"),
) -> GroupResult:
    """Scatter the pre-sorted segments into capacity-sized aggregate
    tables (pairs with :func:`group_sort_stage`).  At high cardinality
    the scatters dominate, so ``need`` prunes the min/max passes a
    SUM-only query never reads."""
    # Invalid rows (sentinel block at the back) scatter out of range.
    seg = jnp.where(valid_s, seg, capacity)
    counts = jnp.zeros((capacity,), jnp.int32).at[seg].add(1, mode="drop")
    keys_out = tuple(
        jnp.full(
            (capacity,), jnp.iinfo(jnp.int32).max, k.dtype
        ).at[seg].min(k, mode="drop")
        if jnp.issubdtype(k.dtype, jnp.integer)
        else jnp.full(
            (capacity,), jnp.inf, jnp.float32
        ).at[seg].min(k, mode="drop")
        for k in keys_s
    )
    inf = jnp.full((capacity,), jnp.inf, jnp.float32)
    per_value = []
    for v in vals_s:
        sums = (
            slot_sums(seg, v, capacity)
            if "sum" in need
            else jnp.zeros((capacity,), jnp.float32)
        )
        mins = (
            inf.at[seg].min(v, mode="drop") if "min" in need else inf
        )
        maxs = (
            (-inf).at[seg].max(v, mode="drop") if "max" in need else -inf
        )
        per_value.append(ValueAggregates(sums, mins, maxs))
    return GroupResult(keys_out, counts, tuple(per_value), num_groups)


def group_aggregate(
    keys, values_list, mask: jax.Array, capacity: int
) -> GroupResult:
    """Aggregate each value column in ``values_list`` per distinct key
    tuple.  ``keys`` may be one f32 array or a tuple for composite
    GROUP BY keys (the reference parses multi-key GROUP BY,
    expression.cpp:419-447, but only ever executes the first key).

    One sort serves every aggregate in the query (SELECT + HAVING +
    ORDER BY aggregates all ride the same segmented pass)."""
    keys = _as_key_tuple(keys)
    values_list = tuple(values_list)
    valid = mask
    skeys = tuple(
        jnp.where(valid, _sort_key_any(k), _U32_MAX) for k in keys
    )
    nk = len(skeys)

    sorted_ops = lax.sort(
        skeys + keys + (valid.astype(jnp.int32),) + values_list,
        num_keys=nk,
        is_stable=True,
    )
    skeys_s = sorted_ops[:nk]
    keys_s = sorted_ops[nk : 2 * nk]
    valid_s = sorted_ops[2 * nk].astype(jnp.bool_)
    vals_s = sorted_ops[2 * nk + 1 :]

    first = jnp.logical_and(sorted_first_flags(skeys_s), valid_s)
    seg = jnp.cumsum(first.astype(jnp.int32)) - 1
    # Invalid rows (sentinel block at the back) scatter out of range.
    seg = jnp.where(valid_s, seg, capacity)

    counts = jnp.zeros((capacity,), jnp.int32).at[seg].add(1, mode="drop")
    keys_out = tuple(
        jnp.full(
            (capacity,), jnp.iinfo(jnp.int32).max, k.dtype
        ).at[seg].min(k, mode="drop")
        if jnp.issubdtype(k.dtype, jnp.integer)
        else jnp.full(
            (capacity,), jnp.inf, jnp.float32
        ).at[seg].min(k, mode="drop")
        for k in keys_s
    )
    per_value = []
    for v in vals_s:
        sums = slot_sums(seg, v, capacity)
        mins = jnp.full((capacity,), jnp.inf, jnp.float32).at[seg].min(v, mode="drop")
        maxs = jnp.full((capacity,), -jnp.inf, jnp.float32).at[seg].max(v, mode="drop")
        per_value.append(ValueAggregates(sums, mins, maxs))
    num_groups = jnp.sum(first.astype(jnp.int32))
    return GroupResult(keys_out, counts, tuple(per_value), num_groups)


def count_distinct(keys, mask: jax.Array) -> jax.Array:
    """Number of distinct valid key tuples (two-phase capacity sizing)."""
    keys = _as_key_tuple(keys)
    skeys = tuple(jnp.where(mask, _sort_key_any(k), _U32_MAX) for k in keys)
    nk = len(skeys)
    sorted_ops = lax.sort(
        skeys + (mask.astype(jnp.int32),), num_keys=nk, is_stable=False
    )
    skeys_s = sorted_ops[:nk]
    valid_s = sorted_ops[nk].astype(jnp.bool_)
    first = sorted_first_flags(skeys_s)
    return jnp.sum(jnp.logical_and(first, valid_s).astype(jnp.int32))


def slot_sums(seg: jax.Array, values: jax.Array, num_slots: int) -> jax.Array:
    """Per-slot f32 sums of ``values`` at slot ``seg`` (``seg >=
    num_slots`` drops the row), privatised: the rows split into B
    contiguous blocks, each block scatter-adds into its own copy of the
    table, and the B copies reduce as a tree.  One shared table would
    take up to N/G additions per slot in sequence, and on the GPU
    (atomics) that lost 6e-4 relative at 2^26 rows × 32 slots.  B keeps
    the copies within 2^22 slots in all and each block ≥ 1024 rows."""
    n = seg.shape[0]
    b = max(1, min(1024, (1 << 22) // max(num_slots, 1), n // 1024))
    block = jnp.arange(n, dtype=jnp.int32) // jnp.int32(-(-n // b))
    idx = jnp.where(seg < num_slots, block * num_slots + seg, b * num_slots)
    part = jnp.zeros((b * num_slots,), jnp.float32).at[idx].add(
        values, mode="drop"
    )
    return jnp.sum(part.reshape(b, num_slots), axis=0)


# Up to this many slots the slot tables come from a compare sweep over
# row chunks instead of scatters: no atomics, so reruns are
# bit-identical, and faster where many rows share a slot (2^25 rows on
# an H100 80GB HBM3 at 400 W: 2.094 vs 9.638 ms at 32 slots, 12.602 vs
# 10.345 ms at 256).
SWEEP_MAX_SLOTS = 128
# Rows × slots one scan step compares (bounds the step's scratch:
# XLA:GPU materialises the step's row-to-slot matrix).
_SWEEP_STEP_ELEMS = 1 << 24


def _sweep_tables(seg, values_list, num_slots: int, need):
    """Counts and per-value (sum, min, max) tables for slot ids ``seg``
    (``seg >= num_slots`` drops the row): the rows split into chunks of
    C rows with C·G ≤ ``_SWEEP_STEP_ELEMS``, and a scan reduces each
    chunk's (C, G) comparison in turn."""
    n = seg.shape[0]
    c = 1
    while c * 2 * num_slots <= _SWEEP_STEP_ELEMS and c * 2 <= n:
        c *= 2
    pad = -n % c
    if pad:
        seg = jnp.concatenate([seg, jnp.full((pad,), num_slots, seg.dtype)])
        values_list = tuple(
            jnp.concatenate([v, jnp.zeros((pad,), v.dtype)])
            for v in values_list
        )
    slot_ids = jnp.arange(num_slots, dtype=seg.dtype)
    inf = jnp.float32(jnp.inf)

    def step(carry, x):
        s, vs = x
        eq = s[:, None] == slot_ids[None, :]
        counts = carry[0] + jnp.sum(eq, axis=0, dtype=jnp.int32)
        acc = []
        for (sm, mn, mx), v in zip(carry[1], vs):
            v2 = v[:, None]
            if "sum" in need:
                sm = sm + jnp.sum(jnp.where(eq, v2, 0.0), axis=0)
            if "min" in need:
                mn = jnp.minimum(mn, jnp.min(jnp.where(eq, v2, inf), axis=0))
            if "max" in need:
                mx = jnp.maximum(mx, jnp.max(jnp.where(eq, v2, -inf), axis=0))
            acc.append((sm, mn, mx))
        return (counts, tuple(acc)), None

    zeros = jnp.zeros((num_slots,), jnp.float32)
    init = (
        jnp.zeros((num_slots,), jnp.int32),
        tuple((zeros, zeros + inf, zeros - inf) for _ in values_list),
    )
    xs = (seg.reshape(-1, c), tuple(v.reshape(-1, c) for v in values_list))
    (counts, acc), _ = lax.scan(step, init, xs)
    return counts, tuple(ValueAggregates(*a) for a in acc)


def _scatter_tables(seg, values_list, num_slots: int, need):
    """The same tables as :func:`_sweep_tables` by scatters: one pass
    per reduction, sums privatised (:func:`slot_sums`)."""
    counts = jnp.zeros((num_slots,), jnp.int32).at[seg].add(1, mode="drop")
    inf = jnp.full((num_slots,), jnp.inf, jnp.float32)
    zeros = jnp.zeros((num_slots,), jnp.float32)
    per_value = []
    for v in values_list:
        sums = slot_sums(seg, v, num_slots) if "sum" in need else zeros
        mins = inf.at[seg].min(v, mode="drop") if "min" in need else inf
        maxs = (-inf).at[seg].max(v, mode="drop") if "max" in need else -inf
        per_value.append(ValueAggregates(sums, mins, maxs))
    return counts, tuple(per_value)


def slot_tables(seg, values_list, num_slots: int, need):
    """``(counts, per-value ValueAggregates)`` for rows at slot ``seg``
    (``seg >= num_slots`` drops the row) — a compare sweep up to
    ``SWEEP_MAX_SLOTS`` slots, scatters beyond.  Reductions not in
    ``need`` come back as their identities."""
    tables = _sweep_tables if num_slots <= SWEEP_MAX_SLOTS else _scatter_tables
    return tables(seg, tuple(values_list), num_slots, need)


def _mxu_chunk(n: int) -> int:
    """Largest power-of-two row chunk ≤ 2^15 dividing ``n`` (0 = no
    chunking).  2^15 rows keeps each one-hot operand ≤ 16 MB while the
    contracting dimension stays deep enough for the matmul units."""
    for c in (1 << 15, 1 << 14, 1 << 13, 1 << 12, 1 << 11, 1 << 10):
        if n % c == 0 and n > c:
            return c
    return 0


def _mxu_counts_sums(gid, values_list, valid, num_slots: int, need):
    """Histogram + per-slot sums on the matmul units via a factorized
    one-hot matmul: split ``gid`` into hi/lo digits, then
    ``counts2d = onehot(hi)ᵀ @ onehot(lo)`` — each (row, slot) pair
    contributes exactly where hi AND lo match, so the (GHI, GLO) result
    IS the dense histogram.  Sums ride the same contraction with the lo
    one-hot scaled by the value column.

    The tier replaces per-row scatters with one contraction (whether it
    still pays against scatter-add is ROADMAP Design 3).  Counts use
    bf16 operands (0/1 entries
    are exact; accumulation is f32, and the per-chunk i32 carry below
    keeps totals exact past 2^24).  Sums use f32 operands with
    ``precision=HIGHEST`` so value mantissas are not truncated to bf16.
    """
    n = gid.shape[0]
    glo = 128 if num_slots <= (1 << 14) else 256
    ghi = -(-num_slots // glo)
    # Invalid rows → hi digit out of range → an all-zero one-hot row.
    gid = jnp.where(valid, gid, jnp.int32(ghi * glo))
    hi = gid // glo
    lo = jnp.where(valid, gid % glo, 0)
    iota_hi = jnp.arange(ghi, dtype=jnp.int32)
    iota_lo = jnp.arange(glo, dtype=jnp.int32)
    want_sums = "sum" in need and len(values_list) > 0

    def block(h, l, vs):
        a16 = (h[:, None] == iota_hi[None, :]).astype(jnp.bfloat16)
        b16 = (l[:, None] == iota_lo[None, :]).astype(jnp.bfloat16)
        dn = (((0,), (0,)), ((), ()))
        cnt = lax.dot_general(
            a16, b16, dn, preferred_element_type=jnp.float32
        ).astype(jnp.int32)
        sums = ()
        if want_sums:
            a32 = a16.astype(jnp.float32)
            b32 = b16.astype(jnp.float32)
            sums = tuple(
                lax.dot_general(
                    a32, b32 * v[:, None], dn,
                    precision=lax.Precision.HIGHEST,
                    preferred_element_type=jnp.float32,
                )
                for v in vs
            )
        return cnt, sums

    chunk = _mxu_chunk(n)
    if chunk:
        steps = n // chunk
        xs = (
            hi.reshape(steps, chunk),
            lo.reshape(steps, chunk),
            tuple(v.reshape(steps, chunk) for v in values_list),
        )

        def body(carry, x):
            cnt_acc, sum_acc = carry
            cnt, sums = block(x[0], x[1], x[2])
            # i32 count carry: per-chunk counts ≤ 2^15 are exact in the
            # matmul's f32 accumulator; integer accumulation across chunks
            # stays exact past f32's 2^24 integer ceiling.
            return (
                cnt_acc + cnt,
                tuple(a + s for a, s in zip(sum_acc, sums)),
            ), None

        init = (
            jnp.zeros((ghi, glo), jnp.int32),
            tuple(jnp.zeros((ghi, glo), jnp.float32) for _ in values_list)
            if want_sums
            else (),
        )
        (cnt2d, sums2d), _ = lax.scan(body, init, xs)
    else:
        cnt2d, sums2d = block(hi, lo, tuple(values_list))

    counts = cnt2d.reshape(-1)[:num_slots]
    sums = tuple(s.reshape(-1)[:num_slots] for s in sums2d)
    return counts, sums


def midrange_group_aggregate(
    keys: jax.Array,
    values_list,
    mask: jax.Array,
    base: int,
    num_slots: int,
    need: tuple = ("sum", "min", "max"),
    use_mxu: bool = False,
) -> GroupResult:
    """Sort-free GROUP BY for stats-bounded integer keys whose range is
    materializable as a dense slot table (the dense tier, up to 4096
    slots, and the mid-range tier, up to ~2^20 slots).  Nothing here
    builds a whole (N, G) row-to-slot matrix: XLA:GPU materialises one
    (128 GiB at 2^25 rows × 4096 slots).

    Group id = key - base; aggregates land directly in their slot —
    no O(N log² N) comparator sorts, no segment machinery.  Two engines:

    * general (:func:`slot_tables`): a chunked compare sweep up to
      ``SWEEP_MAX_SLOTS`` slots, one ``.at[gid].op`` pass per needed
      reduction beyond;
    * one-hot matmul (``use_mxu``, SUM/COUNT-only queries): factorized
      one-hot matmuls (see :func:`_mxu_counts_sums`) in place of the
      scatters.

    Contract matches :func:`group_aggregate`: GroupResult with slots
    ordered by key ascending, empty slots count 0, keys reported as
    ``base + slot``.  Callers compact occupied slots (on device — see
    the executor's two-phase midrange protocol)."""
    values_list = tuple(values_list)
    gid = keys.astype(jnp.int32) - jnp.int32(base)
    valid = jnp.logical_and(mask, jnp.logical_and(gid >= 0, gid < num_slots))

    if use_mxu:
        counts, sums = _mxu_counts_sums(gid, values_list, valid,
                                        num_slots, need)
        inf = jnp.full((num_slots,), jnp.inf, jnp.float32)
        zeros = jnp.zeros((num_slots,), jnp.float32)
        per_value = tuple(
            ValueAggregates(
                sums[i] if sums else zeros, inf, -inf
            )
            for i in range(len(values_list))
        )
    else:
        seg = jnp.where(valid, gid, num_slots)
        counts, per_value = slot_tables(seg, values_list, num_slots, need)

    slot_ids = jnp.arange(num_slots, dtype=jnp.int32)
    # Integer key inputs reconstruct exactly in int32 (base + slot is
    # in-range by the planner's int32 guard); f32 reconstruction would
    # collide slot keys beyond 2^24.
    if jnp.issubdtype(keys.dtype, jnp.integer):
        keys_out = (jnp.int32(base) + slot_ids,)
    else:
        keys_out = (jnp.float32(base) + slot_ids.astype(jnp.float32),)
    num_groups = jnp.sum((counts > 0).astype(jnp.int32))
    return GroupResult(keys_out, counts, per_value, num_groups)


def is_integral(values: jax.Array, mask: jax.Array) -> jax.Array:
    """Device check: every valid value is integral (enables the dense
    GROUP BY path for float columns whose stats bound the range)."""
    ok = jnp.logical_or(jnp.logical_not(mask), values == jnp.floor(values))
    return jnp.all(ok)


def distinct_values(values: jax.Array, mask: jax.Array, capacity: int):
    """Sorted unique valid values → (values[capacity], count).

    Matches the reference's host ``std::sort`` + ``std::unique``
    (warpdb.cpp:463-468): output ascending."""
    g = group_aggregate(values, (values,), mask, capacity)
    return g.keys[0], g.num_groups


# Slot-table reductions each window aggregate reads.
WINDOW_NEED = {"sum": ("sum",), "avg": ("sum",), "count": (),
               "min": ("min",), "max": ("max",)}


def dense_window_aggregate(
    part_key: jax.Array,
    values: jax.Array,
    mask: jax.Array,
    agg: str,
    base: int,
    num_slots: int,
) -> jax.Array:
    """``AGG(values) OVER (PARTITION BY key)`` for stats-bounded integer
    partition keys — the window analogue of the dense GROUP BY tier.

    The sort-based :func:`window_aggregate` pays a full O(N log² N)
    comparator sort plus a scatter-back through the inverse
    permutation.  When stats bound the partition key to a small
    integral range neither is needed: the per-partition table comes from
    :func:`slot_tables` (as in dense GROUP BY) and the per-row result is
    a small-table gather.  Rows keep their original order throughout —
    no inverse permutation exists."""
    need = WINDOW_NEED.get(agg)
    if need is None:
        raise ValueError(f"Unknown window aggregate: {agg}")
    gid = part_key.astype(jnp.int32) - jnp.int32(base)
    valid = jnp.logical_and(mask, jnp.logical_and(gid >= 0, gid < num_slots))
    seg = jnp.where(valid, gid, num_slots)  # invalid rows drop
    counts, (va,) = slot_tables(seg, (values,), num_slots, need)
    counts = counts.astype(jnp.float32)
    table = {"sum": va.sums, "count": counts, "min": va.mins,
             "max": va.maxs}.get(agg)
    if agg == "avg":
        table = va.sums / jnp.maximum(counts, 1.0)
    win = table[jnp.clip(gid, 0, num_slots - 1)]
    return jnp.where(valid, win, 0.0)


def _partition_boundaries(skeys_s: tuple, valid_s: jax.Array) -> jax.Array:
    """Row-starts-a-new-partition mask over lexicographically sorted keys."""
    first = jnp.ones(skeys_s[0].shape, jnp.bool_).at[1:].set(False)
    for sk in skeys_s:
        first = jnp.logical_or(
            first,
            jnp.concatenate([jnp.zeros((1,), jnp.bool_), sk[1:] != sk[:-1]]),
        )
    return jnp.logical_and(first, valid_s)


def window_aggregate(
    part_keys,
    values: jax.Array,
    mask: jax.Array,
    agg: str,
    capacity: int,
) -> jax.Array:
    """Per-row window aggregate ``AGG(values) OVER (PARTITION BY keys)``.

    Executes what the reference only parses (expression.hpp:112-121
    codegen stub).  Sort-based: group, aggregate, then gather each row's
    partition aggregate back through the inverse permutation.
    ``part_keys`` may be one f32 array or a tuple (composite partitions).
    """
    part_keys = _as_key_tuple(part_keys)
    n = values.shape[0]
    valid = mask
    skeys = tuple(
        jnp.where(valid, _sort_key_any(k), _U32_MAX) for k in part_keys
    )
    nk = len(skeys)
    idx = jnp.arange(n, dtype=jnp.int32)

    sorted_ops = lax.sort(
        skeys + (values, idx, valid.astype(jnp.int32)),
        num_keys=nk,
        is_stable=True,
    )
    skeys_s = sorted_ops[:nk]
    val_s, idx_s = sorted_ops[nk], sorted_ops[nk + 1]
    valid_s = sorted_ops[nk + 2].astype(jnp.bool_)
    first = _partition_boundaries(skeys_s, valid_s)
    seg = jnp.cumsum(first.astype(jnp.int32)) - 1
    seg = jnp.where(valid_s, seg, capacity)

    if agg == "sum" or agg == "avg":
        table = jnp.zeros((capacity + 1,), jnp.float32).at[seg].add(val_s, mode="promise_in_bounds")
    elif agg == "count":
        table = jnp.zeros((capacity + 1,), jnp.float32).at[seg].add(1.0, mode="promise_in_bounds")
    elif agg == "min":
        table = jnp.full((capacity + 1,), jnp.inf, jnp.float32).at[seg].min(val_s, mode="promise_in_bounds")
    elif agg == "max":
        table = jnp.full((capacity + 1,), -jnp.inf, jnp.float32).at[seg].max(val_s, mode="promise_in_bounds")
    else:
        raise ValueError(f"Unknown window aggregate: {agg}")
    if agg == "avg":
        cnt = jnp.zeros((capacity + 1,), jnp.float32).at[seg].add(1.0, mode="promise_in_bounds")
        table = table / jnp.maximum(cnt, 1.0)

    per_row_sorted = table[jnp.minimum(seg, capacity)]
    # Inverse permutation: row idx_s[i] came from sorted slot i.
    out = jnp.zeros((n,), jnp.float32).at[idx_s].set(per_row_sorted)
    return jnp.where(valid, out, 0.0)


def window_rank(
    part_keys,
    order_keys: jax.Array,
    mask: jax.Array,
    kind: str,
    ascending: bool = True,
) -> jax.Array:
    """``ROW_NUMBER()`` / ``RANK()`` / ``DENSE_RANK()``
    OVER (PARTITION BY … ORDER BY …).

    Sort once by (partition keys…, order key); a row's number is its
    offset from its partition's first position (+1); RANK snaps tied
    order keys to the run's first row-number; DENSE_RANK counts the
    DISTINCT order keys up to the row within its partition (no gaps).
    All scans are the fused ``lax.cummax``/``cumsum`` primitives (see
    the associative_scan note above)."""
    if kind not in ("row_number", "rank", "dense_rank"):
        raise ValueError(f"Unknown ranking window function: {kind}")
    part_keys = _as_key_tuple(part_keys)
    n = order_keys.shape[0]
    valid = mask
    pkeys = tuple(
        jnp.where(valid, _sort_key_any(k), _U32_MAX) for k in part_keys
    )
    nk = len(pkeys)
    okey = _sort_key_any(order_keys)
    if not ascending:
        # Invert in u32 space so NaN keeps its "largest value" rank
        # (negating the f32 key would leave NaN last under DESC).
        okey = ~okey
    idx = jnp.arange(n, dtype=jnp.int32)

    sorted_ops = lax.sort(
        pkeys + (okey, idx, valid.astype(jnp.int32)),
        num_keys=nk + 1,
        is_stable=True,
    )
    pkeys_s = sorted_ops[:nk]
    okey_s, idx_s = sorted_ops[nk], sorted_ops[nk + 1]
    valid_s = sorted_ops[nk + 2].astype(jnp.bool_)

    part_first = _partition_boundaries(pkeys_s, valid_s)
    pos = jnp.arange(n, dtype=jnp.int32)
    part_start = lax.cummax(jnp.where(part_first, pos, 0))
    row_number = pos - part_start + 1

    if kind == "row_number":
        out_s = row_number
    else:
        okey_first = jnp.logical_or(
            part_first,
            jnp.concatenate(
                [jnp.ones((1,), jnp.bool_), okey_s[1:] != okey_s[:-1]]
            ),
        )
        if kind == "dense_rank":
            # Dense rank = distinct order keys seen in the partition up
            # to the row: a global cumsum of run starts, re-based at
            # each partition start (the re-base value forward-fills via
            # cummax — the cumsum is nondecreasing).
            runs = jnp.cumsum(okey_first.astype(jnp.int32))
            base = lax.cummax(jnp.where(part_first, runs, 0))
            out_s = runs - base + 1
        else:
            # Rank = row number at the first row of the tied run.  The
            # scan carries the run-start POSITION (globally
            # nondecreasing, so cummax is valid across partition
            # boundaries) and re-bases it per partition afterwards.
            run_start = lax.cummax(jnp.where(okey_first, pos, 0))
            out_s = run_start - part_start + 1

    out = jnp.zeros((n,), jnp.float32).at[idx_s].set(
        out_s.astype(jnp.float32)
    )
    return jnp.where(valid, out, 0.0)


def segmented_inclusive_scan(v: jax.Array, first: jax.Array, op, identity):
    """True segmented inclusive scan via Hillis–Steele doubling.

    ``lax.associative_scan`` unrolls a Python-built slice tree whose XLA
    compile time grows super-linearly with n, and there is no
    segmented-scan primitive.  Explicit doubling sticks
    to concatenate/where/``op`` — log2(n) O(n) passes that compile
    instantly and stream at HBM speed: element i combines with element
    i−s iff both lie in the same segment (distance into the segment
    ≥ s), the classic flag-free formulation using the distance from the
    segment start."""
    n = v.shape[0]
    pos = jnp.arange(n, dtype=jnp.int32)
    seg_start = lax.cummax(jnp.where(first, pos, 0))
    off = pos - seg_start  # distance into own segment
    ident = jnp.full((1,), identity, v.dtype)
    shift = 1
    while shift < n:
        prev = jnp.concatenate(
            [jnp.broadcast_to(ident, (shift,)), v[:-shift]]
        )
        v = jnp.where(off >= shift, op(v, prev), v)
        shift *= 2
    return v


def window_shift(
    part_keys,
    order_keys: jax.Array,
    values: jax.Array,
    mask: jax.Array,
    offset: int,
    ascending: bool = True,
) -> jax.Array:
    """``LAG(expr, k)`` (offset=+k) / ``LEAD(expr, k)`` (offset=-k)
    ``OVER (PARTITION BY … ORDER BY …)``: the value k rows back/ahead
    within the partition, NaN where no such row exists (the engine's
    missing-value marker).

    Sort once by (partition keys…, order key); the neighbour is then a
    static shift of the sorted values, masked by a partition-id match,
    scattered back through the inverse permutation."""
    part_keys = _as_key_tuple(part_keys)
    n = values.shape[0]
    valid = mask
    pkeys = tuple(
        jnp.where(valid, _sort_key_any(k), _U32_MAX) for k in part_keys
    )
    nk = len(pkeys)
    okey = _sort_key_any(order_keys)
    if not ascending:
        okey = ~okey
    idx = jnp.arange(n, dtype=jnp.int32)
    sorted_ops = lax.sort(
        pkeys + (okey, values, idx, valid.astype(jnp.int32)),
        num_keys=nk + 1,
        is_stable=True,
    )
    pkeys_s = sorted_ops[:nk]
    val_s, idx_s = sorted_ops[nk + 1], sorted_ops[nk + 2]
    valid_s = sorted_ops[nk + 3].astype(jnp.bool_)
    first = _partition_boundaries(pkeys_s, valid_s)
    pid = jnp.cumsum(first.astype(jnp.int32))

    nan = jnp.float32(jnp.nan)
    k = min(abs(int(offset)), n)  # static shift distance
    if offset > 0:  # LAG: k-th previous sorted row
        shifted = jnp.concatenate([jnp.full((k,), nan), val_s[: n - k]])
        same = jnp.concatenate(
            [jnp.zeros((k,), jnp.bool_), pid[k:] == pid[: n - k]]
        )
        shifted_valid = jnp.concatenate(
            [jnp.zeros((k,), jnp.bool_), valid_s[: n - k]]
        )
    else:  # LEAD: k-th next sorted row
        shifted = jnp.concatenate([val_s[k:], jnp.full((k,), nan)])
        same = jnp.concatenate(
            [pid[k:] == pid[: n - k], jnp.zeros((k,), jnp.bool_)]
        )
        shifted_valid = jnp.concatenate(
            [valid_s[k:], jnp.zeros((k,), jnp.bool_)]
        )
    ok = jnp.logical_and(
        valid_s, jnp.logical_and(same, shifted_valid)
    )
    out_s = jnp.where(ok, shifted, nan)
    out = jnp.zeros((n,), jnp.float32).at[idx_s].set(out_s)
    return jnp.where(valid, out, 0.0)


def window_edge_value(
    part_keys,
    order_keys: jax.Array,
    values: jax.Array,
    mask: jax.Array,
    last: bool = False,
    ascending: bool = True,
) -> jax.Array:
    """``FIRST_VALUE(expr)`` / ``LAST_VALUE(expr)``
    ``OVER (PARTITION BY … ORDER BY …)``: the expression's value at the
    partition's first (or last) row in order-key order, broadcast to
    every partition row.  LAST_VALUE deliberately uses the
    whole-partition frame (see AggregationType docs).

    One sort by (validity, partition keys…, order key, position), then a
    log₂(n) segmented copy-scan broadcasts the segment-head value —
    gather-free (per-row gathers cost ~0.2 s per 2²⁵ rows on this
    hardware; the scan passes stream at HBM speed)."""
    part_keys = _as_key_tuple(part_keys)
    n = values.shape[0]
    valid = mask
    # Validity leads the sort so padded/filtered rows can never
    # interleave a NaN-keyed partition (NaN keys map to the same u32 as
    # the invalid sentinel).
    vkey = (~valid).astype(jnp.uint32)
    pkeys = tuple(float_sort_key(k) for k in part_keys)
    nk = len(pkeys)
    okey = _sort_key_any(order_keys)
    if not ascending:
        okey = ~okey
    pos = jnp.arange(n, dtype=jnp.uint32)
    if last:
        # Whole-partition LAST ≡ FIRST under fully reversed order:
        # invert the order key and the tie-breaking position.
        okey = ~okey
        tie = ~pos
    else:
        tie = pos
    idx = jnp.arange(n, dtype=jnp.int32)
    sorted_ops = lax.sort(
        (vkey,) + pkeys + (okey, tie, values, idx, valid.astype(jnp.int32)),
        num_keys=nk + 3,
        is_stable=False,  # the position tie-break is already total
    )
    pkeys_s = sorted_ops[: nk + 1]  # validity + partition keys
    val_s, idx_s = sorted_ops[nk + 3], sorted_ops[nk + 4]
    valid_s = sorted_ops[nk + 5].astype(jnp.bool_)
    first = _partition_boundaries(pkeys_s, valid_s)
    edge = segmented_inclusive_scan(
        val_s, first, lambda cur, prev: prev, jnp.float32(0.0)
    )
    out = jnp.zeros((n,), jnp.float32).at[idx_s].set(edge)
    return jnp.where(valid, out, 0.0)


def window_ntile(
    part_keys,
    order_keys: jax.Array,
    mask: jax.Array,
    n_buckets: int,
    ascending: bool = True,
) -> jax.Array:
    """``NTILE(n) OVER (PARTITION BY … ORDER BY …)``: bucket 1..n per
    partition row, sizes as even as possible with earlier buckets taking
    the remainder (standard SQL).

    One sort, a cummax row-number, and a backward segmented copy-scan
    for the partition size — no gathers, no scatter beyond the final
    inverse-permutation write-back shared by every window op."""
    part_keys = _as_key_tuple(part_keys)
    n = order_keys.shape[0]
    valid = mask
    vkey = (~valid).astype(jnp.uint32)
    pkeys = tuple(float_sort_key(k) for k in part_keys)
    nk = len(pkeys)
    okey = _sort_key_any(order_keys)
    if not ascending:
        okey = ~okey
    idx = jnp.arange(n, dtype=jnp.int32)
    sorted_ops = lax.sort(
        (vkey,) + pkeys + (okey, idx, valid.astype(jnp.int32)),
        num_keys=nk + 2,
        is_stable=True,
    )
    pkeys_s = sorted_ops[: nk + 1]
    idx_s = sorted_ops[nk + 2]
    valid_s = sorted_ops[nk + 3].astype(jnp.bool_)
    first = _partition_boundaries(pkeys_s, valid_s)
    pos = jnp.arange(n, dtype=jnp.int32)
    part_start = lax.cummax(jnp.where(first, pos, 0))
    r0 = pos - part_start  # 0-based row number within the partition
    # Partition size = r0 at the segment's last row + 1, broadcast back
    # via a copy-scan over the reversed arrays (reversed seg-last ≡
    # seg-first).
    # A row ends its segment when the next row starts a new partition OR
    # flips validity (`first` is masked to valid rows, so the final
    # valid partition's end needs the explicit validity transition).
    last_row = jnp.concatenate([
        jnp.logical_or(first[1:], valid_s[1:] != valid_s[:-1]),
        jnp.ones((1,), jnp.bool_),
    ])
    cnt = jnp.flip(
        segmented_inclusive_scan(
            jnp.flip(r0), jnp.flip(last_row),
            lambda cur, prev: prev, jnp.int32(0),
        )
    ) + 1
    nb = jnp.int32(n_buckets)
    small = cnt // nb
    rem = cnt - small * nb
    big = small + 1
    cut = rem * big  # rows 0..cut-1 live in the (small+1)-sized buckets
    bucket = jnp.where(
        r0 < cut,
        r0 // jnp.maximum(big, 1),
        rem + (r0 - cut) // jnp.maximum(small, 1),
    ) + 1
    out = jnp.zeros((n,), jnp.float32).at[idx_s].set(
        bucket.astype(jnp.float32)
    )
    return jnp.where(valid, out, 0.0)


def window_relative_rank(
    part_keys,
    order_keys: jax.Array,
    mask: jax.Array,
    kind: str,
    ascending: bool = True,
) -> jax.Array:
    """``PERCENT_RANK()`` / ``CUME_DIST()``
    ``OVER (PARTITION BY … ORDER BY …)`` (standard):

    * PERCENT_RANK = (rank − 1) / (partition count − 1), 0 for a
      single-row partition;
    * CUME_DIST = (number of partition rows with order key ≤ current,
      peers included) / partition count.

    One sort by (validity, partition keys…, order key), then cummax
    scans for the tied-run start (rank) and two backward segmented
    copy-scans broadcasting the partition size and the peer-run end —
    the same gather-free machinery as NTILE/RANK."""
    if kind not in ("percent_rank", "cume_dist"):
        raise ValueError(f"Unknown relative-rank window function: {kind}")
    part_keys = _as_key_tuple(part_keys)
    n = order_keys.shape[0]
    valid = mask
    vkey = (~valid).astype(jnp.uint32)
    pkeys = tuple(float_sort_key(k) for k in part_keys)
    nk = len(pkeys)
    okey = _sort_key_any(order_keys)
    if not ascending:
        okey = ~okey
    idx = jnp.arange(n, dtype=jnp.int32)
    sorted_ops = lax.sort(
        (vkey,) + pkeys + (okey, idx, valid.astype(jnp.int32)),
        num_keys=nk + 2,
        is_stable=True,
    )
    pkeys_s = sorted_ops[: nk + 1]  # validity + partition keys
    okey_s, idx_s = sorted_ops[nk + 1], sorted_ops[nk + 2]
    valid_s = sorted_ops[nk + 3].astype(jnp.bool_)
    first = _partition_boundaries(pkeys_s, valid_s)
    pos = jnp.arange(n, dtype=jnp.int32)
    part_start = lax.cummax(jnp.where(first, pos, 0))
    r0 = pos - part_start
    # Partition size: r0 at the segment's last row + 1, broadcast back
    # via a reversed copy-scan (see window_ntile for the validity-
    # transition subtlety in `last_row`).
    last_row = jnp.concatenate([
        jnp.logical_or(first[1:], valid_s[1:] != valid_s[:-1]),
        jnp.ones((1,), jnp.bool_),
    ])
    cnt = jnp.flip(
        segmented_inclusive_scan(
            jnp.flip(r0), jnp.flip(last_row),
            lambda cur, prev: prev, jnp.int32(0),
        )
    ) + 1
    okey_first = jnp.logical_or(
        first,
        jnp.concatenate(
            [jnp.ones((1,), jnp.bool_), okey_s[1:] != okey_s[:-1]]
        ),
    )
    if kind == "percent_rank":
        # Rank = row number at the first row of the tied run (cummax of
        # run-start positions, nondecreasing across partitions).
        run_start = lax.cummax(jnp.where(okey_first, pos, 0))
        rank = run_start - part_start + 1
        out_s = (rank - 1).astype(jnp.float32) / jnp.maximum(
            cnt - 1, 1
        ).astype(jnp.float32)
    else:  # cume_dist
        # Peer-run end position broadcast back over the run (validity
        # transitions close a run even when keys happen to match).
        run_last = jnp.logical_or(
            jnp.concatenate([okey_first[1:], jnp.ones((1,), jnp.bool_)]),
            last_row,
        )
        run_end = jnp.flip(
            segmented_inclusive_scan(
                jnp.flip(pos), jnp.flip(run_last),
                lambda cur, prev: prev, jnp.int32(0),
            )
        )
        out_s = (run_end - part_start + 1).astype(
            jnp.float32
        ) / cnt.astype(jnp.float32)
    out = jnp.zeros((n,), jnp.float32).at[idx_s].set(out_s)
    return jnp.where(valid, out, 0.0)


def window_nth_value(
    part_keys,
    order_keys: jax.Array,
    values: jax.Array,
    mask: jax.Array,
    nth: int,
    ascending: bool = True,
) -> jax.Array:
    """``NTH_VALUE(expr, n) OVER (PARTITION BY … ORDER BY …)``: the
    expression's value at the partition's n-th row in order-key order,
    broadcast to every partition row (whole-partition frame, matching
    FIRST_VALUE/LAST_VALUE — see AggregationType docs); NaN where the
    partition holds fewer than n rows.

    One sort, then the n-th row's value reaches every partition row
    with two segmented scans: a forward sum-scan of the value masked to
    the n-th row (a partition has exactly one such row, so the running
    sum IS the value), and a reversed copy-scan broadcasting the
    segment-end total back over the whole partition — gather-free."""
    part_keys = _as_key_tuple(part_keys)
    n = values.shape[0]
    valid = mask
    vkey = (~valid).astype(jnp.uint32)
    pkeys = tuple(float_sort_key(k) for k in part_keys)
    nk = len(pkeys)
    okey = _sort_key_any(order_keys)
    if not ascending:
        okey = ~okey
    pos_u = jnp.arange(n, dtype=jnp.uint32)
    idx = jnp.arange(n, dtype=jnp.int32)
    sorted_ops = lax.sort(
        (vkey,) + pkeys + (okey, pos_u, values, idx,
                           valid.astype(jnp.int32)),
        num_keys=nk + 3,
        is_stable=False,  # the position tie-break is already total
    )
    pkeys_s = sorted_ops[: nk + 1]
    val_s, idx_s = sorted_ops[nk + 3], sorted_ops[nk + 4]
    valid_s = sorted_ops[nk + 5].astype(jnp.bool_)
    first = _partition_boundaries(pkeys_s, valid_s)
    pos = jnp.arange(n, dtype=jnp.int32)
    part_start = lax.cummax(jnp.where(first, pos, 0))
    r0 = pos - part_start
    hit = jnp.logical_and(valid_s, r0 == jnp.int32(nth - 1))
    seq = jnp.where(hit, val_s, 0.0)
    # Whole-partition sum of the single-row mask == the n-th value
    # (counted separately so a genuine 0.0 survives).
    run_val = segmented_inclusive_scan(
        seq, first, lambda cur, prev: cur + prev, jnp.float32(0.0)
    )
    run_hit = segmented_inclusive_scan(
        hit.astype(jnp.int32), first,
        lambda cur, prev: cur + prev, jnp.int32(0),
    )
    last_row = jnp.concatenate([
        jnp.logical_or(first[1:], valid_s[1:] != valid_s[:-1]),
        jnp.ones((1,), jnp.bool_),
    ])

    def back(v, ident):
        return jnp.flip(
            segmented_inclusive_scan(
                jnp.flip(v), jnp.flip(last_row),
                lambda cur, prev: prev, ident,
            )
        )

    nth_all = back(run_val, jnp.float32(0.0))
    present = back(run_hit, jnp.int32(0)) > 0
    out_s = jnp.where(present, nth_all, jnp.float32(jnp.nan))
    out = jnp.zeros((n,), jnp.float32).at[idx_s].set(out_s)
    return jnp.where(valid, out, 0.0)


def window_running(
    part_keys,
    order_keys: jax.Array,
    values: jax.Array,
    mask: jax.Array,
    agg: str,
    ascending: bool = True,
) -> jax.Array:
    """Running window aggregate
    ``AGG(values) OVER (PARTITION BY part ORDER BY ord)`` — each row sees
    the aggregate of all partition rows up to and including itself in
    ``order_keys`` order (ROWS semantics: ties are not merged).
    ``part_keys`` may be one f32 array or a tuple (composite partitions).

    Sort once by (partition keys…, order key), then a true segmented
    inclusive scan (:func:`segmented_inclusive_scan` — no
    associative_scan compile hazard), then scatter back through the
    inverse permutation.  Supports SUM/COUNT/AVG/MIN/MAX."""
    if agg not in ("sum", "count", "avg", "min", "max"):
        raise ValueError(f"Running window aggregate '{agg}' not supported")
    part_keys = _as_key_tuple(part_keys)
    n = values.shape[0]
    valid = mask
    pkeys = tuple(
        jnp.where(valid, _sort_key_any(k), _U32_MAX) for k in part_keys
    )
    nk = len(pkeys)
    okey = _sort_key_any(order_keys)
    if not ascending:
        okey = ~okey  # u32-space inversion: NaN stays "largest"
    idx = jnp.arange(n, dtype=jnp.int32)

    sorted_ops = lax.sort(
        pkeys + (okey, values, idx, valid.astype(jnp.int32)),
        num_keys=nk + 1,
        is_stable=True,
    )
    pkeys_s = sorted_ops[:nk]
    val_s, idx_s = sorted_ops[nk + 1], sorted_ops[nk + 2]
    valid_s = sorted_ops[nk + 3].astype(jnp.bool_)
    first = _partition_boundaries(pkeys_s, valid_s)

    ones = valid_s.astype(jnp.float32)

    # A global cumsum minus a per-segment base would catastrophically
    # cancel in f32 once the global sum dwarfs individual running
    # values — the segmented scan combines only within segments.
    if agg == "min":
        v = jnp.where(valid_s, val_s, jnp.inf)
        out_s = segmented_inclusive_scan(v, first, jnp.minimum, jnp.inf)
    elif agg == "max":
        v = jnp.where(valid_s, val_s, -jnp.inf)
        out_s = segmented_inclusive_scan(v, first, jnp.maximum, -jnp.inf)
    else:
        v = jnp.where(valid_s, val_s, 0.0)
        run_sum = segmented_inclusive_scan(
            v, first, lambda a, b: a + b, 0.0
        )
        if agg == "sum":
            out_s = run_sum
        else:
            run_cnt = segmented_inclusive_scan(
                ones, first, lambda a, b: a + b, 0.0
            )
            out_s = (
                run_cnt
                if agg == "count"
                else run_sum / jnp.maximum(run_cnt, 1.0)
            )

    out = jnp.zeros((n,), jnp.float32).at[idx_s].set(out_s)
    return jnp.where(valid, out, 0.0)


def _shift_fwd(x: jax.Array, s: int, fill) -> jax.Array:
    """``x`` shifted forward by ``s`` positions (result[i] = x[i-s]),
    front-filled with ``fill``.  Static ``s`` — compiles to one pad+slice."""
    if s == 0:
        return x
    return jnp.concatenate(
        [jnp.full((s,), fill, x.dtype), x[:-s]]
    )


def _segment_offsets(first: jax.Array) -> jax.Array:
    """0-based distance of each row from its segment start."""
    n = first.shape[0]
    pos = jnp.arange(n, dtype=jnp.int32)
    return pos - lax.cummax(jnp.where(first, pos, 0))


def _trailing_sum(S: jax.Array, off: jax.Array, w) -> jax.Array:
    """Sum over the ``w`` trailing rows (current row included), clamped at
    the segment start.  ``S`` is the segmented inclusive cumsum; the
    clamped window sum is ``S[i] − S[i−w]`` with the subtrahend dropped
    when the window start precedes the segment start.  ``w=None`` means
    unbounded (the running sum itself)."""
    if w is None:
        return S
    return S - jnp.where(off >= w, _shift_fwd(S, w, 0.0), 0.0)


def _trailing_comb(v, first, off, w, op, ident):
    """``op``-combine over the ``w`` trailing rows (current included),
    clamped at the segment start.  ``op`` must be idempotent (min/max):
    the sparse-table doubling builds windows of 2^k rows, then covers a
    general ``w`` with two overlapping power-of-two windows — overlap is
    harmless only for idempotent ops.  O(log w) shift+select passes.
    ``w=None`` → unbounded (segmented running scan)."""
    if w is None:
        return segmented_inclusive_scan(v, first, op, ident)
    f = v
    m = 1
    while m * 2 <= w:
        # f covers min(2^k, off+1) trailing rows; doubling: combine with
        # the window ending m rows earlier (guard keeps it in-segment;
        # that earlier window is itself clamped at the segment start).
        f = jnp.where(off >= m, op(f, _shift_fwd(f, m, ident)), f)
        m *= 2
    if m < w:
        f = jnp.where(off >= (w - m), op(f, _shift_fwd(f, w - m, ident)), f)
    return f


def _strict_leading(trail_w: jax.Array, off: jax.Array, ident) -> jax.Array:
    """Given a trailing-window combine of width ``w`` (current row
    included), produce the combine over the ``w`` rows STRICTLY BEFORE
    the current row: the width-``w`` window ending one row earlier."""
    return jnp.where(off >= 1, _shift_fwd(trail_w, 1, ident), ident)


def window_frame(
    part_keys,
    order_keys: jax.Array,
    values: jax.Array,
    mask: jax.Array,
    agg: str,
    preceding,
    following,
    ascending: bool = True,
) -> jax.Array:
    """Framed window aggregate ``AGG(v) OVER (PARTITION BY p ORDER BY o
    ROWS BETWEEN <preceding> PRECEDING AND <following> FOLLOWING)`` —
    ``preceding``/``following`` are static row counts (``None`` =
    UNBOUNDED on that side).  The reference never parses past OVER
    (expression.cpp:296-329).

    Shape: one stable sort by (partition…, order), then the frame
    decomposes into [i−prec, i] ∪ (i, i+foll]:

    * the PRECEDING half is a trailing window in sorted order — a
      difference of segmented cumsums for SUM/COUNT/AVG, sparse-table
      doubling (O(log w) shifted selects) for MIN/MAX;
    * the FOLLOWING half is the same trailing machinery on the REVERSED
      sorted sequence, shifted one row to exclude the current row.

    Everything is shifts, selects and scans over static shapes — no
    gathers, no scatters beyond the final inverse-permutation
    scatter-back.  Rows removed by WHERE sort to the back of the array
    and never occupy frame positions (except inside NaN-keyed
    partitions, which share their sort key — same pinned semantics as
    :func:`window_running`)."""
    if agg not in ("sum", "count", "avg", "min", "max"):
        raise ValueError(f"Framed window aggregate '{agg}' not supported")
    part_keys = _as_key_tuple(part_keys)
    n = values.shape[0]
    valid = mask
    pkeys = tuple(
        jnp.where(valid, _sort_key_any(k), _U32_MAX) for k in part_keys
    )
    nk = len(pkeys)
    okey = _sort_key_any(order_keys)
    if not ascending:
        okey = ~okey
    idx = jnp.arange(n, dtype=jnp.int32)

    sorted_ops = lax.sort(
        pkeys + (okey, values, idx, valid.astype(jnp.int32)),
        num_keys=nk + 1,
        is_stable=True,
    )
    pkeys_s = sorted_ops[:nk]
    val_s, idx_s = sorted_ops[nk + 1], sorted_ops[nk + 2]
    valid_s = sorted_ops[nk + 3].astype(jnp.bool_)
    first = _partition_boundaries(pkeys_s, valid_s)
    off = _segment_offsets(first)

    # Reversed-sequence views for the FOLLOWING half.  A segment start
    # in reversed order is a segment END in sorted order: row j ends a
    # segment iff j == n−1 or first[j+1].
    first_r = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), first[::-1][:-1]]
    )
    off_r = _segment_offsets(first_r)

    def framed(v, op, ident, use_sum):
        """Combine over the clamped frame [i−prec, i+foll] of ``v``."""
        if use_sum:
            S = segmented_inclusive_scan(v, first, op, ident)
            a = _trailing_sum(
                S, off, None if preceding is None else preceding + 1
            )
        else:
            a = _trailing_comb(
                v, first, off,
                None if preceding is None else preceding + 1, op, ident,
            )
        if following == 0:
            return a
        vr = v[::-1]
        if use_sum:
            Sr = segmented_inclusive_scan(vr, first_r, op, ident)
            tr = _trailing_sum(Sr, off_r, following)
        else:
            tr = _trailing_comb(vr, first_r, off_r, following, op, ident)
        b = _strict_leading(tr, off_r, ident)[::-1]
        return op(a, b) if not use_sum else a + b

    if agg == "min":
        out_s = framed(
            jnp.where(valid_s, val_s, jnp.inf), jnp.minimum, jnp.inf, False
        )
    elif agg == "max":
        out_s = framed(
            jnp.where(valid_s, val_s, -jnp.inf), jnp.maximum, -jnp.inf, False
        )
    else:
        add = lambda a, b: a + b
        v = jnp.where(valid_s, val_s, 0.0)
        ones = valid_s.astype(jnp.float32)
        if agg == "sum":
            out_s = framed(v, add, 0.0, True)
        elif agg == "count":
            out_s = framed(ones, add, 0.0, True)
        else:  # avg over the VALID rows in the frame
            s = framed(v, add, 0.0, True)
            c = framed(ones, add, 0.0, True)
            out_s = s / jnp.maximum(c, 1.0)

    out = jnp.zeros((n,), jnp.float32).at[idx_s].set(out_s)
    return jnp.where(valid, out, 0.0)


def window_range_frame(
    part_keys,
    order_keys: jax.Array,
    values: jax.Array,
    mask: jax.Array,
    agg: str,
    preceding,
    following,
    ascending: bool = True,
) -> jax.Array:
    """Framed window aggregate ``AGG(v) OVER (PARTITION BY p ORDER BY o
    RANGE BETWEEN <preceding> PRECEDING AND <following> FOLLOWING)`` —
    the bounds are ORDER-KEY-VALUE offsets (floats; ``None`` =
    UNBOUNDED): row i's frame holds every partition row j with
    ``o_j ∈ [o_i − preceding, o_i + following]`` (peers — ties on the
    order key — are always inside).  The reference never parses past
    OVER (expression.cpp:296-329).

    Shape: the frame ends are RANKS of per-row value bounds in the
    partition-sorted order-key sequence, computed with ONE merged 3n
    sort (data ∪ lo-bounds ∪ hi-bounds) — the join's merged-rank
    pattern (ops/join.py:114-152; no ``searchsorted``).
    A lo bound ties BEFORE equal data keys and a hi bound AFTER, so the
    exclusive running reduction at each bound's merged position is
    exactly the frame-boundary prefix:

    * SUM/COUNT/AVG carry running sums IN the merged order and subtract
      the two prefixes — fully gather-free (counts accumulate in int32,
      exact where f32 would round past 2²⁴);
    * MIN/MAX build a sparse table (doubling, O(n log n) HBM) over the
      partition-sorted values and answer each row's [lo, hi) with one
      batched 2-row gather.

    NaN order keys form one peer group at the partition's end (NaN ±
    offset is NaN, which ``float_sort_key`` canonicalises), so NaN rows
    aggregate over exactly their NaN peers.  Rows removed by WHERE sort
    behind the partition sentinel and never occupy frame positions."""
    if agg not in ("sum", "count", "avg", "min", "max"):
        raise ValueError(f"Framed window aggregate '{agg}' not supported")
    part_keys = _as_key_tuple(part_keys)
    n = values.shape[0]
    valid = mask
    pkeys = tuple(
        jnp.where(valid, _sort_key_any(k), _U32_MAX) for k in part_keys
    )
    nk = len(pkeys)
    o = order_keys.astype(jnp.float32)
    okey = float_sort_key(o)
    # Value-space frame ends.  The data sorts ascending by value
    # regardless of the ORDER BY direction — DESC only swaps which
    # offset extends toward smaller values.
    below = preceding if ascending else following
    above = following if ascending else preceding
    lo_key = (
        jnp.zeros_like(okey)
        if below is None
        else float_sort_key(o - jnp.float32(below))
    )
    hi_key = (
        jnp.full_like(okey, _U32_MAX)
        if above is None
        else float_sort_key(o + jnp.float32(above))
    )

    idx = jnp.arange(n, dtype=jnp.int32)
    zeros_f = jnp.zeros((n,), jnp.float32)
    zeros_i = jnp.zeros((n,), jnp.int32)

    def cat(a, b, c):
        return jnp.concatenate([a, b, c])

    keys_m = tuple(cat(pk, pk, pk) for pk in pkeys)
    okey_m = cat(okey, lo_key, hi_key)
    # Tie rank: lo bound (0) < data (1) < hi bound (2) at equal keys.
    tie = cat(jnp.full((n,), 1, jnp.int32), zeros_i,
              jnp.full((n,), 2, jnp.int32))
    # Un-merge order: lo bounds to [0, n), hi bounds to [n, 2n).
    um = cat(idx + 2 * n, idx, idx + n)

    use_sum = agg in ("sum", "avg")
    use_cnt = agg in ("count", "avg")
    streams: list = []
    if use_sum:
        v = jnp.where(valid, values.astype(jnp.float32), 0.0)
        streams.append(cat(v, zeros_f, zeros_f))
    if use_cnt:
        streams.append(cat(valid.astype(jnp.int32), zeros_i, zeros_i))

    ops = lax.sort(
        keys_m + (okey_m, tie, um) + tuple(streams),
        num_keys=nk + 2,
        is_stable=True,
    )
    tie_s, um_s = ops[nk + 1], ops[nk + 2]

    if agg in ("min", "max"):
        # Frame ends as positions in the data-only sorted sequence:
        # exclusive running count of data rows at each bound's slot.
        is_data = (tie_s == 1).astype(jnp.int32)
        pos = jnp.cumsum(is_data) - is_data
        srt = lax.sort((um_s, pos), num_keys=1, is_stable=True)[1]
        lo_u, hi_u = srt[:n], srt[n:2 * n]
        return _range_minmax(pkeys, okey, values, valid, lo_u, hi_u, agg, n)

    prefixes = []
    for k, s in enumerate(streams):
        s_s = ops[nk + 3 + k]
        prefixes.append(jnp.cumsum(s_s) - s_s)  # exclusive running sum
    srt = lax.sort((um_s, *prefixes), num_keys=1, is_stable=True)
    if agg == "sum":
        p = srt[1]
        out = p[n:2 * n] - p[:n]
    elif agg == "count":
        p = srt[1]
        out = (p[n:2 * n] - p[:n]).astype(jnp.float32)
    else:  # avg
        pv, pc = srt[1], srt[2]
        s_diff = pv[n:2 * n] - pv[:n]
        c_diff = (pc[n:2 * n] - pc[:n]).astype(jnp.float32)
        out = s_diff / jnp.maximum(c_diff, 1.0)
    return jnp.where(valid, out, 0.0)


def _range_minmax(pkeys, okey, values, valid, lo, hi, agg, n):
    """MIN/MAX over per-row rank intervals [lo, hi) of the
    partition-sorted value sequence: sparse-table doubling + one batched
    2-row gather (the ranks are arbitrary, so static shifts cannot reach
    them; the table costs O(n log n) HBM — acceptable at bench scale,
    revisit with a block decomposition if it ever dominates)."""
    op = jnp.minimum if agg == "min" else jnp.maximum
    ident = jnp.float32(jnp.inf if agg == "min" else -jnp.inf)
    vfill = jnp.where(valid, values.astype(jnp.float32), ident)
    sorted_ops = lax.sort(
        pkeys + (okey, vfill), num_keys=len(pkeys) + 1, is_stable=True
    )
    val_s = sorted_ops[len(pkeys) + 1]

    levels = [val_s]
    shift = 1
    while shift < n:
        prev = levels[-1]
        shifted = jnp.concatenate(
            [prev[shift:], jnp.full((shift,), ident, jnp.float32)]
        )
        levels.append(op(prev, shifted))
        shift *= 2
    table = jnp.stack(levels)  # (K, n); level k covers [i, i + 2^k)

    length = jnp.maximum(hi - lo, 1)
    lf = length.astype(jnp.float32)
    e = (lax.bitcast_convert_type(lf, jnp.int32) >> 23) - 127
    pow2 = jnp.left_shift(jnp.int32(1), e)
    too_big = pow2 > length  # f32 rounding crossed a power of two
    e = jnp.where(too_big, e - 1, e)
    pow2 = jnp.where(too_big, pow2 >> 1, pow2)

    flat = table.reshape(-1)
    idx_a = e * n + lo
    idx_b = e * n + (hi - pow2)
    both = jnp.stack([idx_a, idx_b]).reshape(-1)
    bs = min(1024, both.shape[0])
    g = jnp.take(flat, both.reshape(-1, bs)).reshape(2, n)
    out = op(g[0], g[1])
    return jnp.where(valid, out, 0.0)
