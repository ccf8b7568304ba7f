"""Sharded (multi-device) query execution.

Replaces the reference's multi-GPU executor (multi_gpu_utils.cpp:5-63):
where that code sliced the host table, uploaded to each GPU and
JIT-recompiled **sequentially per device per chunk**, here the columns
are laid out row-sharded over a ``Mesh`` once and a single jitted program
executes on all devices simultaneously — XLA partitions the fused
filter+projection kernel (embarrassingly parallel, zero collectives) and
inserts ``psum``-style collectives only where an operator genuinely
reduces (global aggregates, distributed GROUP BY).

Results concatenate in row order, matching the reference's deterministic
host-staged gather (multi_gpu_utils.cpp:55-56).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..engine.compiler import (
    _as_bool,
    _as_f32,
    build_evaluator,
    get_or_compile,
    schema_signature,
)
from ..engine import udf as udf_mod
from ..frontend.ast import Node
from ..ops.aggregate import group_aggregate
from ..storage.table import DeviceTable, HostTable
from .mesh import DATA_AXIS, data_mesh, row_sharding

__all__ = [
    "shard_table",
    "run_expression_sharded",
    "run_grouped_sharded",
    "run_topk_sharded",
]


def shard_table(host: HostTable, mesh=None, dicts_override=None) -> DeviceTable:
    """Upload a host table row-sharded over the mesh.  Padding is rounded
    up so every device gets an equal, lane-aligned shard.
    ``dicts_override`` forces string columns to encode against supplied
    vocabularies (cross-chunk streaming)."""
    if mesh is None:
        mesh = data_mesh()
    n_dev = mesh.devices.size
    pad = max(1024, 128 * n_dev)
    # Ensure divisibility by the device count.
    while pad % n_dev:
        pad *= 2
    return DeviceTable.from_host(
        host, pad_multiple=pad, sharding=row_sharding(mesh),
        dicts_override=dicts_override,
    )


def run_expression_sharded(
    table: DeviceTable,
    expr: Node,
    cond: Optional[Node],
    mesh=None,
    device_out: bool = False,
) -> np.ndarray:
    """Fused filter+projection over a row-sharded table.

    If the table isn't sharded yet it is re-laid-out across the mesh
    first (one host→HBM transfer per device, the analogue of the
    reference's per-device upload loop — but issued in parallel).

    ``device_out=True`` returns the (padded) device array without
    blocking on the device→host copy — the streaming path uses this to
    overlap chunk k+1's parse/upload with chunk k's compute."""
    from ..engine.executor import bind_strings

    if mesh is None:
        mesh = data_mesh()
    if mesh.devices.size > 1:
        table = _ensure_sharded(table, mesh)

    expr = bind_strings(expr, table)
    if cond is not None:
        cond = bind_strings(cond, table)

    key = (
        "sharded_filter_project",
        expr.canonical(),
        cond.canonical() if cond is not None else "",
        schema_signature(table.columns),
        mesh.devices.size,
        udf_mod.registry_version(),
    )

    def build():
        expr_fn = build_evaluator(expr)
        cond_fn = build_evaluator(cond) if cond is not None else None

        @jax.jit
        def kernel(cols, num_rows):
            some = next(iter(cols.values()))
            n_pad = some.shape[0]
            out = jnp.broadcast_to(_as_f32(expr_fn(cols)), (n_pad,))
            valid = jnp.arange(n_pad, dtype=jnp.int32) < num_rows
            if cond_fn is not None:
                valid = jnp.logical_and(valid, _as_bool(cond_fn(cols)))
            return jnp.where(valid, out, jnp.float32(0.0))

        return kernel

    out = get_or_compile(key, build)(table.columns, jnp.int32(table.num_rows))
    if device_out:
        return out  # async: caller slices to num_rows after transfer
    return np.asarray(out)[: table.num_rows]


def fetch_global(tree):
    """``jax.device_get`` that also works for arrays sharded across
    PROCESSES: multi-host shards are non-addressable locally, so the
    fetch rides ``process_allgather`` (every host receives the full
    array — callers only fetch O(groups)-sized results)."""
    if jax.process_count() == 1:
        return jax.device_get(tree)
    from jax.experimental import multihost_utils

    def one(x):
        arr = jnp.asarray(x)
        if all(
            d.process_index == jax.process_index()
            for d in arr.sharding.device_set
        ):
            return jax.device_get(arr)
        return np.asarray(multihost_utils.process_allgather(arr, tiled=True))

    return jax.tree.map(one, tree)


def _ensure_sharded(table: DeviceTable, mesh) -> DeviceTable:
    sharding = row_sharding(mesh)
    n_dev = mesh.devices.size
    if table.padded_rows % n_dev == 0:
        cols = {
            name: jax.device_put(arr, sharding)
            for name, arr in table.columns.items()
        }
        return DeviceTable(
            cols, table.dtypes, table.num_rows, table.padded_rows,
            table.stats, table.host, table.dicts,
        )
    if table.host is None:
        raise RuntimeError(
            "Cannot reshard a padded table with no host mirror; "
            "pad to a multiple of the device count at load time"
        )
    return shard_table(table.host, mesh)


def run_topk_sharded(
    select_expr: Node,
    cond: Optional[Node],
    table: DeviceTable,
    k: int,
    ascending: bool,
    mesh=None,
) -> np.ndarray:
    """Distributed ORDER BY … LIMIT k: each shard pulls its local top-k,
    an ``all_gather`` ships only k·n_dev candidates, and one tiny final
    top-k finishes —
    the classic two-level pull, never materialising a global sort."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from ..ops.sort import top_k_values

    if mesh is None:
        mesh = data_mesh()
    table = _ensure_sharded(table, mesh) if mesh.devices.size > 1 else table

    key = (
        "sharded_topk",
        select_expr.canonical(),
        cond.canonical() if cond is not None else "",
        schema_signature(table.columns),
        int(k),
        bool(ascending),
        mesh.devices.size,
        udf_mod.registry_version(),
    )

    def build():
        sel_fn = build_evaluator(select_expr)
        cond_fn = build_evaluator(cond) if cond is not None else None
        n_dev = mesh.devices.size

        def body(cols, num_rows):
            some = next(iter(cols.values()))
            n_local = some.shape[0]
            shard_id = jax.lax.axis_index(DATA_AXIS).astype(jnp.int32)
            rows = shard_id * n_local + jnp.arange(n_local, dtype=jnp.int32)
            valid = rows < num_rows
            if cond_fn is not None:
                valid = jnp.logical_and(valid, _as_bool(cond_fn(cols)))
            vals = jnp.broadcast_to(_as_f32(sel_fn(cols)), (n_local,))
            local = top_k_values(vals, valid, k, ascending)
            n_match = jnp.sum(valid.astype(jnp.int32))
            cand = jax.lax.all_gather(local, DATA_AXIS)          # (n_dev, k)
            counts = jax.lax.all_gather(n_match, DATA_AXIS)      # (n_dev,)
            # Exact candidate validity from the per-shard match counts —
            # sentinel ±inf padding is indistinguishable from real
            # infinite data values, so isfinite() would drop real rows.
            slot = jnp.arange(k, dtype=jnp.int32)[None, :]
            mask = slot < jnp.minimum(counts, k)[:, None]
            top = top_k_values(cand.reshape(-1), mask.reshape(-1), k, ascending)
            return top, jnp.sum(counts)

        fn = shard_map(
            body,
            mesh=mesh,
            in_specs=(P(DATA_AXIS), P()),
            out_specs=(P(), P()),
            check_vma=False,
        )
        return jax.jit(fn)

    out, total = get_or_compile(key, build)(
        table.columns, jnp.int32(table.num_rows)
    )
    return np.asarray(out), int(total)


def run_grouped_sharded(
    keys_fn_exprs,
    value_exprs,
    cond: Optional[Node],
    table: DeviceTable,
    capacity: int,
    mesh=None,
):
    """Distributed GROUP BY: per-shard segmented aggregation inside
    ``shard_map``, then a capacity-sized cross-device merge.

    The local phase is the same one-sort aggregate as single-chip; the
    merge re-aggregates the G·n_dev partials — the classic two-level
    tree, with the cross-shard exchange as one ``all_gather``
    (SURVEY.md §5 "distributed communication backend").
    """
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    if mesh is None:
        mesh = data_mesh()
    table = _ensure_sharded(table, mesh) if mesh.devices.size > 1 else table

    key = (
        "sharded_group",
        tuple(k.canonical() for k in keys_fn_exprs),
        tuple(v.canonical() for v in value_exprs),
        cond.canonical() if cond is not None else "",
        schema_signature(table.columns),
        capacity,
        mesh.devices.size,
        udf_mod.registry_version(),
    )

    def build():
        from .shuffle import _key_eval_fns

        key_fns = _key_eval_fns(keys_fn_exprs, table)
        val_fns = [build_evaluator(v) for v in value_exprs]
        cond_fn = build_evaluator(cond) if cond is not None else None
        n_dev = mesh.devices.size

        def local_phase(cols, num_rows):
            some = next(iter(cols.values()))
            n_local = some.shape[0]
            shard_id = jax.lax.axis_index(DATA_AXIS)
            #

            # Global row ids for this contiguous shard.
            base = shard_id.astype(jnp.int32) * n_local
            rows = base + jnp.arange(n_local, dtype=jnp.int32)
            valid = rows < num_rows
            if cond_fn is not None:
                valid = jnp.logical_and(valid, _as_bool(cond_fn(cols)))
            keys = tuple(
                jnp.broadcast_to(f(cols), (n_local,)) for f in key_fns
            )
            vals = tuple(
                jnp.broadcast_to(_as_f32(f(cols)), (n_local,)) for f in val_fns
            )
            local = group_aggregate(keys, vals, valid, capacity)
            # Gather partials from every shard: [n_dev * capacity].
            g_keys = tuple(
                jax.lax.all_gather(k, DATA_AXIS).reshape(-1) for k in local.keys
            )
            g_counts = jax.lax.all_gather(local.counts, DATA_AXIS).reshape(-1)
            g_valid = g_counts > 0
            # Merge: re-aggregate partials (sums add; mins/maxs fold;
            # counts add).  Each partial behaves as a pre-weighted row.
            merged_counts = group_aggregate(
                g_keys,
                (g_counts.astype(jnp.float32),),
                g_valid,
                capacity,
            )
            out_keys = merged_counts.keys
            out_counts = merged_counts.values[0].sums.astype(jnp.int32)
            merged_vals = []
            for vi in range(len(val_fns)):
                va = local.values[vi]
                g_sums = jax.lax.all_gather(va.sums, DATA_AXIS).reshape(-1)
                g_mins = jax.lax.all_gather(va.mins, DATA_AXIS).reshape(-1)
                g_maxs = jax.lax.all_gather(va.maxs, DATA_AXIS).reshape(-1)
                m = group_aggregate(g_keys, (g_sums, g_mins, g_maxs), g_valid, capacity)
                merged_vals.append(
                    (m.values[0].sums, m.values[1].mins, m.values[2].maxs)
                )
            return (
                out_keys,
                out_counts,
                tuple(merged_vals),
                merged_counts.num_groups,
            )

        fn = shard_map(
            local_phase,
            mesh=mesh,
            in_specs=(P(DATA_AXIS), P()),
            out_specs=(P(), P(), P(), P()),
            check_vma=False,
        )
        return jax.jit(fn)

    from ..utils.metrics import note_collective

    # all_gather merge: every device receives all shards' capacity-sized
    # partial tables (nk keys + counts + 3 per value column).
    note_collective(
        "all_gather",
        mesh.devices.size * capacity * 4
        * (len(keys_fn_exprs) + 1 + 3 * len(value_exprs)),
    )
    return get_or_compile(key, build)(table.columns, jnp.int32(table.num_rows))
