"""Distributed GROUP BY via hash-partitioned all-to-all key shuffle.

The scalable alternative to the all_gather partial-merge in
``sharded.py``: when the number of distinct keys is large, gathering
G·n_dev partials to every device wastes interconnect bandwidth and
device memory.  The
classic database answer — re-shard *rows* by key hash so each device
owns a disjoint key range, then aggregate locally — maps directly onto
``jax.lax.all_to_all`` over the mesh (SURVEY.md §5 "distributed
communication backend": device collectives, not host staging).

Per shard, inside ``shard_map``:

1. destination = hash(key) mod n_dev;
2. one stable sort by destination groups outgoing rows; a static
   (n_dev, cap) gather builds equal-sized send buckets (fixed shapes —
   the XLA contract), with per-bucket send counts;
3. ``all_to_all`` exchanges bucket d with device d — a single fused
   exchange instead of n_dev point-to-point copies;
4. each device segment-aggregates the rows it now owns (every
   occurrence of a key lands on exactly one device).

Bucket overflow (data skew) is detected on device and surfaced; the
driver retries with a doubled capacity — the standard two-phase
static-shape protocol.

**Skew-proof combine-then-shuffle** (``combine_shuffle_grouped``): when
the per-shard distinct-key count fits a local capacity, each shard first
pre-aggregates (map-side combine) and shuffles *partials* instead of
rows.  A hot key then contributes at most ONE partial row per shard, so
pathological single-key skew cannot overflow a bucket, and exchange traffic
is bounded by capacity·n_dev regardless of row distribution.  The
executor tries this first and falls back to the row shuffle when local
pre-aggregation overflows (very high cardinality — exactly the regime
where skew is rare).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..engine.compiler import (
    _as_bool,
    _as_f32,
    build_evaluator,
    get_or_compile,
    raw_int_item,
    schema_signature,
)
from ..engine import udf as udf_mod
from ..errors import ExecutionError
from ..ops.aggregate import group_aggregate
from ..ops.sort import sort_key_any
from ..storage.table import DeviceTable
from .mesh import DATA_AXIS, data_mesh
from .sharded import _ensure_sharded, fetch_global

__all__ = [
    "shuffle_grouped",
    "combine_shuffle_grouped",
    "ShuffleGroupResult",
]

# Knuth multiplicative hash over the order-preserving key bits.
_HASH_MULT = jnp.uint32(2654435761)


def hash_dest(key_tuple, n_dev: int) -> jax.Array:
    """Destination shard of each row from its key TUPLE: per-column
    Knuth multiplicative hashes folded with a rotate-xor, so composite
    keys distribute even when individual columns are skewed.  Every
    shard computes the identical function — the invariant that routes
    all occurrences of one key tuple to one device."""
    h = jnp.zeros(key_tuple[0].shape, jnp.uint32)
    for k in key_tuple:
        kb = sort_key_any(k) * _HASH_MULT
        h = (h << jnp.uint32(5)) ^ (h >> jnp.uint32(27)) ^ kb
    return ((h >> jnp.uint32(16)).astype(jnp.int32)) % n_dev


class ShuffleGroupResult:
    """Merged groups on host: keys ascending (lexicographic over the key
    tuple), one row per distinct key tuple.  ``keys`` is a tuple of
    arrays, one per GROUP BY key."""

    def __init__(self, keys, counts, sums, mins, maxs):
        self.keys = keys
        self.counts = counts
        self.sums = sums
        self.mins = mins
        self.maxs = maxs

    @property
    def num_groups(self) -> int:
        return len(self.keys[0])



def _key_eval_fns(key_exprs, table):
    """Per-key evaluators: bare INT columns ride the exchange RAW
    (int32 — exact beyond 2^24, hashed/grouped via int_sort_key bits);
    everything else evaluates f32 as before."""
    fns = []
    for k in key_exprs:
        r = raw_int_item(k, table)
        if r is not None:
            fns.append(r[0])
        else:
            inner = build_evaluator(k)
            fns.append(lambda cols, _f=inner: _as_f32(_f(cols)))
    return fns

def _shuffle_kernel(key_fns, val_fns, cond_fn, n_dev, send_cap, group_cap,
                    overlap: bool = False):
    """Builds the per-shard shard_map body.

    ``overlap=True`` splits the exchange into two half-bucket
    ``all_to_all``s and aggregates the first half's rows while the
    second is still in flight — the two collectives have no data
    dependence on the first aggregation, so XLA's async collective
    scheduling (start/done pairs) can hide half the exchange time behind
    compute.  The halves produce two partial group tables merged by one
    payload re-aggregation (counts ride the 4096-radix hi/lo lanes so
    merged counts stay exact)."""

    def body(cols, num_rows):
        some = next(iter(cols.values()))
        n_local = some.shape[0]
        shard_id = lax.axis_index(DATA_AXIS).astype(jnp.int32)
        rows = shard_id * n_local + jnp.arange(n_local, dtype=jnp.int32)
        valid = rows < num_rows
        if cond_fn is not None:
            valid = jnp.logical_and(valid, _as_bool(cond_fn(cols)))

        keys = tuple(
            jnp.broadcast_to(f(cols), (n_local,)) for f in key_fns
        )
        vals = [jnp.broadcast_to(_as_f32(f(cols)), (n_local,)) for f in val_fns]

        # 1. destination shard by key-tuple hash.
        dest = hash_dest(keys, n_dev)
        dest = jnp.where(valid, dest, n_dev)  # invalid rows park in a sink

        # 2. stable sort rows by destination; build (n_dev, send_cap)
        #    equal-sized buckets with a static gather.
        order = lax.sort(
            (dest, jnp.arange(n_local, dtype=jnp.int32)), num_keys=1,
            is_stable=True,
        )[1]
        dest_sorted = dest[order]
        counts = jnp.zeros((n_dev + 1,), jnp.int32).at[dest_sorted].add(
            1, mode="drop"
        )[:n_dev]
        starts = jnp.cumsum(counts) - counts

        slot = jnp.arange(send_cap, dtype=jnp.int32)
        src = starts[:, None] + slot[None, :]
        send_valid = slot[None, :] < counts[:, None]
        src = jnp.clip(src, 0, n_local - 1)
        row_idx = order[src]  # (n_dev, send_cap)

        send_keys = [
            jnp.where(send_valid, k[row_idx], jnp.zeros((), k.dtype))
            for k in keys
        ]
        send_vals = [jnp.where(send_valid, v[row_idx], 0.0) for v in vals]
        overflow = jnp.max(counts) > send_cap

        # 3. the exchange: bucket d → device d.
        def exchange(sl):
            rk = [
                lax.all_to_all(k[:, sl], DATA_AXIS, 0, 0, tiled=False)
                for k in send_keys
            ]
            rvd = lax.all_to_all(
                send_valid[:, sl].astype(jnp.int32), DATA_AXIS, 0, 0,
                tiled=False,
            ).astype(jnp.bool_)
            rv = [
                lax.all_to_all(v[:, sl], DATA_AXIS, 0, 0, tiled=False)
                for v in send_vals
            ]
            return (
                tuple(k.reshape(-1) for k in rk),
                rvd.reshape(-1),
                tuple(v.reshape(-1) for v in rv),
            )

        if not overlap:
            flat_keys, flat_valid, flat_vals = exchange(slice(None))
            # 4. local aggregation over the keys this device now owns.
            g = group_aggregate(flat_keys, flat_vals, flat_valid, group_cap)
            counts_out = g.counts
            vals_out = tuple(
                (v.sums, v.mins, v.maxs) for v in g.values
            )
            local_overflow = jnp.logical_or(
                overflow, g.num_groups > group_cap
            )
        else:
            # Both exchanges issue BEFORE the first aggregation consumes
            # its data, so the second one's DMA overlaps the first
            # half's aggregation.
            half = send_cap // 2
            ex1 = exchange(slice(0, half))
            ex2 = exchange(slice(half, send_cap))
            g1 = group_aggregate(ex1[0], ex1[2], ex1[1], group_cap)
            g2 = group_aggregate(ex2[0], ex2[2], ex2[1], group_cap)

            slot_ids = jnp.arange(group_cap, dtype=jnp.int32)

            def table_rows(g):
                pvalid = slot_ids < jnp.minimum(g.num_groups, group_cap)
                payload = [
                    (g.counts // 4096).astype(jnp.float32),
                    (g.counts % 4096).astype(jnp.float32),
                ]
                for v in g.values:
                    payload.extend((v.sums, v.mins, v.maxs))
                return g.keys, payload, pvalid

            k1, p1, v1 = table_rows(g1)
            k2, p2, v2 = table_rows(g2)
            keys_cat = tuple(
                jnp.concatenate([a, b]) for a, b in zip(k1, k2)
            )
            pay_cat = tuple(
                jnp.concatenate([a, b]) for a, b in zip(p1, p2)
            )
            valid_cat = jnp.concatenate([v1, v2])
            g = group_aggregate(keys_cat, pay_cat, valid_cat, group_cap)
            counts_out = (
                jnp.rint(g.values[0].sums).astype(jnp.int32) * 4096
                + jnp.rint(g.values[1].sums).astype(jnp.int32)
            )
            vals_out = tuple(
                (
                    g.values[2 + 3 * i].sums,
                    g.values[3 + 3 * i].mins,
                    g.values[4 + 3 * i].maxs,
                )
                for i in range(len(val_fns))
            )
            local_overflow = jnp.logical_or(
                overflow,
                jnp.logical_or(
                    jnp.logical_or(
                        g1.num_groups > group_cap, g2.num_groups > group_cap
                    ),
                    g.num_groups > group_cap,
                ),
            )
        return (
            tuple(k[None] for k in g.keys),
            counts_out[None],
            tuple((s[None], mn[None], mx[None]) for s, mn, mx in vals_out),
            g.num_groups[None],
            local_overflow[None],
        )

    return body


def _combine_shuffle_kernel(key_fns, val_fns, cond_fn, n_dev, local_cap,
                            group_cap):
    """Per-shard body: local pre-aggregate (map-side combine), then
    shuffle ≤local_cap partial rows by key-tuple hash, then merge
    partials."""
    nv = len(val_fns)

    def body(cols, num_rows):
        some = next(iter(cols.values()))
        n_local = some.shape[0]
        shard_id = lax.axis_index(DATA_AXIS).astype(jnp.int32)
        rows = shard_id * n_local + jnp.arange(n_local, dtype=jnp.int32)
        valid = rows < num_rows
        if cond_fn is not None:
            valid = jnp.logical_and(valid, _as_bool(cond_fn(cols)))
        keys = tuple(
            jnp.broadcast_to(f(cols), (n_local,)) for f in key_fns
        )
        vals = tuple(
            jnp.broadcast_to(_as_f32(f(cols)), (n_local,)) for f in val_fns
        )

        # 1. Map-side combine: one partial row per local distinct key.
        local = group_aggregate(keys, vals, valid, local_cap)
        local_overflow = local.num_groups > local_cap
        pkeys = local.keys
        slot_ids = jnp.arange(local_cap, dtype=jnp.int32)
        pvalid = slot_ids < jnp.minimum(local.num_groups, local_cap)

        # Payload per partial: count (split into 4096-radix hi/lo lanes so
        # merged counts stay EXACT far beyond f32's 2^24 integer range) +
        # (sum, min, max) per value column.
        payload = [
            (local.counts // 4096).astype(jnp.float32),
            (local.counts % 4096).astype(jnp.float32),
        ]
        for v in local.values:
            payload.extend((v.sums, v.mins, v.maxs))

        # 2. Destination by key-tuple hash; bucketize.  send_cap ==
        #    local_cap, so a bucket can never overflow (skew-proof by
        #    construction).
        dest = hash_dest(pkeys, n_dev)
        dest = jnp.where(pvalid, dest, n_dev)
        order = lax.sort(
            (dest, jnp.arange(local_cap, dtype=jnp.int32)), num_keys=1,
            is_stable=True,
        )[1]
        dest_sorted = dest[order]
        counts = jnp.zeros((n_dev + 1,), jnp.int32).at[dest_sorted].add(
            1, mode="drop"
        )[:n_dev]
        starts = jnp.cumsum(counts) - counts
        slot = jnp.arange(local_cap, dtype=jnp.int32)
        src = jnp.clip(starts[:, None] + slot[None, :], 0, local_cap - 1)
        send_valid = slot[None, :] < counts[:, None]
        row_idx = order[src]

        send_keys = [
            jnp.where(send_valid, k[row_idx], jnp.zeros((), k.dtype))
            for k in pkeys
        ]
        send_payload = [jnp.where(send_valid, p[row_idx], 0.0) for p in payload]

        # 3. exchange.
        recv_keys = [
            lax.all_to_all(k, DATA_AXIS, 0, 0, tiled=False) for k in send_keys
        ]
        recv_valid = lax.all_to_all(
            send_valid.astype(jnp.int32), DATA_AXIS, 0, 0, tiled=False
        ).astype(jnp.bool_)
        recv_payload = [
            lax.all_to_all(p, DATA_AXIS, 0, 0, tiled=False)
            for p in send_payload
        ]

        flat_keys = tuple(k.reshape(-1) for k in recv_keys)
        flat_valid = recv_valid.reshape(-1)
        flat_payload = tuple(p.reshape(-1) for p in recv_payload)

        # 4. Merge partials: counts/sums add, mins/maxs fold.
        g = group_aggregate(flat_keys, flat_payload, flat_valid, group_cap)
        merged_counts = (
            jnp.rint(g.values[0].sums).astype(jnp.int32) * 4096
            + jnp.rint(g.values[1].sums).astype(jnp.int32)
        )
        merged_vals = tuple(
            (
                g.values[2 + 3 * i].sums,   # sum of partial sums
                g.values[3 + 3 * i].mins,   # min of partial mins
                g.values[4 + 3 * i].maxs,   # max of partial maxs
            )
            for i in range(nv)
        )
        out_vals = tuple(
            (s[None], mn[None], mx[None]) for s, mn, mx in merged_vals
        )
        return (
            tuple(k[None] for k in g.keys),
            merged_counts[None],
            out_vals,
            g.num_groups[None],
            local_overflow[None],
            (g.num_groups > group_cap)[None],
        )

    return body


def _as_expr_list(key_exprs):
    return list(key_exprs) if isinstance(key_exprs, (list, tuple)) else [
        key_exprs
    ]


def combine_shuffle_grouped(
    key_exprs,
    value_exprs,
    cond,
    table: DeviceTable,
    mesh=None,
    local_cap: int = 16384,
    group_cap: Optional[int] = None,
) -> Optional[ShuffleGroupResult]:
    """Skew-proof distributed GROUP BY: map-side combine, then an
    all-to-all exchange of ≤``local_cap`` partial rows per shard.

    ``key_exprs`` may be one expression or a list (composite GROUP BY
    keys ride the exchange side-by-side and hash as tuples).  Returns
    None when per-shard distinct key tuples exceed ``local_cap``
    (caller falls back to the row shuffle)."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    key_exprs = _as_expr_list(key_exprs)
    if mesh is None:
        mesh = data_mesh()
    n_dev = int(mesh.devices.size)
    table = _ensure_sharded(table, mesh) if n_dev > 1 else table
    if group_cap is None:
        group_cap = local_cap  # each device owns ~G/n_dev keys; generous

    val_canons = tuple(v.canonical() for v in value_exprs)
    for attempt in range(2):
        key = (
            "combine_shuffle_group",
            tuple(k.canonical() for k in key_exprs), val_canons,
            cond.canonical() if cond is not None else "",
            schema_signature(table.columns), n_dev, local_cap, group_cap,
            udf_mod.registry_version(),
        )

        def build():
            key_fns = _key_eval_fns(key_exprs, table)
            val_fns = [build_evaluator(v) for v in value_exprs]
            cond_fn = build_evaluator(cond) if cond is not None else None
            body = _combine_shuffle_kernel(
                key_fns, val_fns, cond_fn, n_dev, local_cap, group_cap
            )
            fn = shard_map(
                body,
                mesh=mesh,
                in_specs=(P(DATA_AXIS), P()),
                out_specs=(
                    tuple(P(DATA_AXIS) for _ in key_exprs), P(DATA_AXIS),
                    tuple(
                        (P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS))
                        for _ in value_exprs
                    ),
                    P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS),
                ),
                check_vma=False,
            )
            return jax.jit(fn)

        from ..utils.metrics import note_collective

        # Partial-row exchange: nk keys + (2 count lanes + 3 per value)
        # payload + validity, (n_dev, local_cap) each.
        note_collective(
            "all_to_all",
            n_dev * local_cap * 4
            * (len(key_exprs) + 3 + 3 * len(value_exprs)),
        )
        (keys_s, counts_s, vals_s, ngroups_s, local_ovf_s, merge_ovf_s) = (
            fetch_global(
                get_or_compile(key, build)(
                    table.columns, jnp.int32(table.num_rows)
                )
            )
        )
        if bool(np.any(local_ovf_s)):
            # Per-shard distinct keys exceed the combine capacity — no
            # group_cap retry can fix that; fall back to the row shuffle.
            return None
        if bool(np.any(merge_ovf_s)):
            if attempt == 0 and group_cap < local_cap * n_dev:
                group_cap *= 2
                continue
            return None

        return _merge_shard_tables(
            keys_s, counts_s, vals_s, ngroups_s, n_dev, len(value_exprs)
        )
    return None


def _sort_key_u32(a: np.ndarray) -> np.ndarray:
    """float_sort_key semantics on host: total order with -0≡+0, all
    NaNs equal and last — the exact order the device kernels group by.
    Integer arrays key on raw int bits (exact beyond 2^24), mirroring
    the device's sort_key_any dispatch."""
    a = np.asarray(a)
    if a.dtype.kind in "iu":
        return a.astype(np.int32).view(np.uint32) ^ np.uint32(0x80000000)
    a = np.asarray(a, np.float32)
    a = np.where(a == 0.0, np.float32(0.0), a)
    a = np.where(np.isnan(a), np.float32(np.nan), a)
    bits = a.view(np.uint32)
    return np.where(bits >= 0x80000000, ~bits, bits | 0x80000000)


def _merge_shard_tables(keys_s, counts_s, vals_s, ngroups_s, n_dev, nv):
    """Concatenate per-shard disjoint group tables, sorted ascending by
    key tuple (lexicographic in float_sort_key space, matching the
    single-program group order)."""
    nk = len(keys_s)
    keys_list = [[] for _ in range(nk)]
    counts_list = []
    sums_list, mins_list, maxs_list = [], [], []
    for d in range(n_dev):
        ng = int(ngroups_s[d])
        for ki in range(nk):
            keys_list[ki].append(keys_s[ki][d, :ng])
        counts_list.append(counts_s[d, :ng])
        sums_list.append(np.stack([vals_s[i][0][d, :ng] for i in range(nv)]))
        mins_list.append(np.stack([vals_s[i][1][d, :ng] for i in range(nv)]))
        maxs_list.append(np.stack([vals_s[i][2][d, :ng] for i in range(nv)]))
    keys = tuple(np.concatenate(kl) for kl in keys_list)
    counts = np.concatenate(counts_list)
    sums = np.concatenate(sums_list, axis=1)
    mins = np.concatenate(mins_list, axis=1)
    maxs = np.concatenate(maxs_list, axis=1)
    order = np.lexsort(tuple(_sort_key_u32(k) for k in reversed(keys)))
    return ShuffleGroupResult(
        tuple(k[order] for k in keys), counts[order],
        sums[:, order], mins[:, order], maxs[:, order],
    )


def shuffle_grouped(
    key_exprs,
    value_exprs,
    cond,
    table: DeviceTable,
    mesh=None,
    send_overcommit: float = 2.0,
    group_cap: Optional[int] = None,
) -> ShuffleGroupResult:
    """Distributed GROUP BY with an all-to-all key shuffle.

    ``key_exprs`` may be one expression or a list (composite keys).
    Returns the merged host-side group table (keys ascending).  Retries
    with doubled bucket capacity on skew-induced overflow."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    key_exprs = _as_expr_list(key_exprs)
    if mesh is None:
        mesh = data_mesh()
    n_dev = int(mesh.devices.size)
    table = _ensure_sharded(table, mesh) if n_dev > 1 else table

    from ..config import get_config

    overlap = bool(get_config().shuffle_overlap)
    n_local = table.padded_rows // max(n_dev, 1)
    send_cap = int(np.ceil(n_local / max(n_dev, 1) * send_overcommit))
    send_cap = max(128, send_cap)
    send_cap += send_cap % 2  # overlap halves split the slot axis evenly
    if group_cap is None:
        group_cap = max(1024, min(n_dev * send_cap, table.padded_rows))

    val_canons = tuple(v.canonical() for v in value_exprs)
    for attempt in range(4):
        key = (
            "shuffle_group", tuple(k.canonical() for k in key_exprs),
            val_canons,
            cond.canonical() if cond is not None else "",
            schema_signature(table.columns), n_dev, send_cap, group_cap,
            overlap,
            udf_mod.registry_version(),
        )

        def build():
            key_fns = _key_eval_fns(key_exprs, table)
            val_fns = [build_evaluator(v) for v in value_exprs]
            cond_fn = build_evaluator(cond) if cond is not None else None
            body = _shuffle_kernel(
                key_fns, val_fns, cond_fn, n_dev, send_cap, group_cap,
                overlap=overlap,
            )
            fn = shard_map(
                body,
                mesh=mesh,
                in_specs=(P(DATA_AXIS), P()),
                out_specs=(
                    tuple(P(DATA_AXIS) for _ in key_exprs), P(DATA_AXIS),
                    tuple(
                        (P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS))
                        for _ in value_exprs
                    ),
                    P(DATA_AXIS), P(DATA_AXIS),
                ),
                check_vma=False,
            )
            return jax.jit(fn)

        from ..utils.metrics import note_collective

        # Exchange volume (analytic, static shapes): keys + values +
        # validity ride (n_dev, send_cap) f32/i32 lanes per device.
        note_collective(
            "all_to_all",
            n_dev * send_cap * 4 * (len(key_exprs) + len(value_exprs) + 1),
        )
        keys_s, counts_s, vals_s, ngroups_s, overflow_s = fetch_global(
            get_or_compile(key, build)(
                table.columns, jnp.int32(table.num_rows)
            )
        )
        if bool(np.any(overflow_s)):
            send_cap *= 2
            group_cap *= 2
            continue

        # Merge per-shard disjoint key ranges on host (≤ G rows).
        return _merge_shard_tables(
            keys_s, counts_s, vals_s, ngroups_s, n_dev, len(value_exprs)
        )
    raise ExecutionError(
        "shuffle_grouped: bucket overflow persisted after retries "
        "(pathological key skew); use the all_gather merge path"
    )
