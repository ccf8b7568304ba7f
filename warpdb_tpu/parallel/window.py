"""Distributed window functions over the device mesh.

The partition-aggregate family — ``AGG(e) OVER (PARTITION BY k)`` for
SUM/AVG/COUNT/MIN/MAX with a stats-bounded integral partition key —
distributes with near-zero interconnect cost: each shard builds its LOCAL dense
per-partition slot table, the tables merge with one ``psum`` /
``pmin`` / ``pmax`` over the data axis (num_slots scalars per
collective, not rows), and the merged table broadcasts back per-row
with a small-table gather.  No row ever crosses the interconnect —
the collective answer to "hash-shuffle rows by partition key": for
associative window aggregates the shuffle is unnecessary, only the
O(G) partial tables move (SURVEY §5 row 7; the reference stubbed
windows entirely, expression.hpp:112-121).

Ordered windows (ranking / frames / LAG / edge values) need a global
per-partition order; they stay on the GSPMD single-program path where
XLA inserts the distributed-sort collectives itself.

Output contract matches the single-device ``_run_window``: rows in
original global order (shard-major == global order for the contiguous
row sharding), compacted under WHERE to a ``send_cap``-sized block per
shard, host-concatenated.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..engine.compiler import (
    _as_bool,
    build_evaluator,
    get_or_compile,
    schema_signature,
)
from ..engine import udf as udf_mod
from ..ops.aggregate import WINDOW_NEED, slot_tables
from .mesh import DATA_AXIS
from .sharded import _ensure_sharded, fetch_global

__all__ = ["run_window_partition_agg_sharded"]


def run_window_partition_agg_sharded(
    select, where, table, base: int, num_slots: int, part_fn, mesh
):
    """Distributed ``AGG(e) OVER (PARTITION BY k)`` (dense key tier).

    Returns the per-row window column, WHERE-compacted in original row
    order (np.float32), or raises on overflow (callers pre-gate sizes).
    ``part_fn`` evaluates the partition key (raw ints or runtime-
    integral f32, same contract as the dense GROUP BY key fn).
    """
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    table = _ensure_sharded(table, mesh)
    n_dev = int(mesh.devices.size)
    agg = select.agg.value
    need = WINDOW_NEED[agg]
    cols = table.columns
    n_local = table.padded_rows // n_dev

    key = (
        "dist_window", select.canonical(),
        where.canonical() if where is not None else "",
        schema_signature(cols), base, num_slots, n_dev,
        udf_mod.registry_version(),
    )

    def build():
        val_fn = build_evaluator(select.expr)
        cond_fn = build_evaluator(where) if where is not None else None

        def body(cols, num_rows):
            some = next(iter(cols.values()))
            nl = some.shape[0]
            shard = lax.axis_index(DATA_AXIS).astype(jnp.int32)
            rows = shard * nl + jnp.arange(nl, dtype=jnp.int32)
            valid = rows < num_rows
            if cond_fn is not None:
                valid = jnp.logical_and(valid, _as_bool(cond_fn(cols)))
            vals = jnp.broadcast_to(
                jnp.asarray(val_fn(cols)).astype(jnp.float32), (nl,)
            )
            pk = jnp.broadcast_to(part_fn(cols), (nl,))
            gid = pk.astype(jnp.int32) - jnp.int32(base)
            in_range = jnp.logical_and(gid >= 0, gid < num_slots)
            ok = jnp.logical_and(valid, in_range)
            seg = jnp.where(ok, gid, num_slots)

            # Local per-partition slot tables (the rows stream once;
            # ops/aggregate.slot_tables), merged across the mesh.
            cnts, (va,) = slot_tables(seg, (vals,), num_slots, need)
            if agg == "min":
                tablev = lax.pmin(va.mins, DATA_AXIS)
            elif agg == "max":
                tablev = lax.pmax(va.maxs, DATA_AXIS)
            elif agg == "sum":
                tablev = lax.psum(va.sums, DATA_AXIS)
            elif agg == "count":
                tablev = lax.psum(cnts.astype(jnp.float32), DATA_AXIS)
            else:  # avg
                tablev = lax.psum(va.sums, DATA_AXIS) / jnp.maximum(
                    lax.psum(cnts.astype(jnp.float32), DATA_AXIS), 1.0)

            # Per-row broadcast back: small-table gather (per-column
            # 1-D — the ≤4K-source rule, docs/DESIGN.md §2).
            win = jnp.take(
                tablev, jnp.clip(gid, 0, num_slots - 1), mode="clip"
            )
            win = jnp.where(ok, win, jnp.float32(0.0))

            # Order-preserving local compaction (stable position sort);
            # shard-major concatenation restores global row order.
            pos = jnp.arange(nl, dtype=jnp.uint32)
            ck = jnp.where(valid, pos, jnp.uint32(0xFFFFFFFF))
            _, win_c = lax.sort((ck, win), num_keys=1, is_stable=True)
            count = jnp.sum(valid.astype(jnp.int32))
            return win_c[None], count[None]

        fn = shard_map(
            body,
            mesh=mesh,
            in_specs=(P(DATA_AXIS), P()),
            out_specs=(P(DATA_AXIS), P(DATA_AXIS)),
            check_vma=False,
        )
        return jax.jit(fn)

    from ..utils.metrics import note_collective

    n_psums = {"sum": 1, "count": 1, "min": 1, "max": 1, "avg": 2}[agg]
    note_collective("psum", num_slots * 4 * n_psums)
    win_s, counts_s = fetch_global(
        get_or_compile(key, build)(cols, jnp.int32(table.num_rows))
    )
    win_s = np.asarray(win_s).reshape(n_dev, n_local)
    counts = np.asarray(counts_s).reshape(-1)
    return np.concatenate(
        [win_s[d, : int(counts[d])] for d in range(n_dev)]
    ).astype(np.float32)
