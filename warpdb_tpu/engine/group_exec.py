"""Grouped aggregation execution: plan → partials → finish.

Split out of engine/executor.py (same subsystem, own module): the
grouped pipeline's static planning, the strategy ladder (distributed
all_gather/shuffle, dense and midrange scatter/one-hot slot tables,
sorted segmented aggregation), COUNT(DISTINCT)/MEDIAN/PERCENTILE order
statistics, and the host-side finishing pass.  The partial form
(keys, counts, sum/min/max per value expression) is the merge unit
shared with the distributed and out-of-core streaming paths — keep it
mergeable.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..errors import ExecutionError, UnsupportedError
from ..frontend.ast import (
    Aggregation,
    AggregationType,
    Alias,
    BinaryOp,
    CaseWhen,
    Constant,
    FunctionCall,
    Node,
    NotNull,
    Query,
    Star as _Star,
    Variable,
    unalias,
    walk,
)
from ..ops.aggregate import is_integral, midrange_group_aggregate
from ..storage.table import DeviceTable
from . import udf as udf_mod
from .compiler import (
    _as_bool,
    _as_f32,
    build_evaluator,
    get_or_compile,
    schema_signature,
)
from .executor import _broadcast, _cached_count, _next_pow2, _valid_mask

# ---------------------------------------------------------------------------
# Aggregation helpers
# ---------------------------------------------------------------------------


class _AggSpec:
    """One (agg type, value-expression[, parameter]) triple needed by a
    query."""

    def __init__(self, agg: AggregationType, expr: Node, param=None):
        self.agg = agg
        self.expr = expr
        self.param = param
        self.key = (agg.value, expr.canonical(), param)


def _collect_agg_specs(nodes: Sequence[Node]) -> list[_AggSpec]:
    specs: dict = {}
    for node in nodes:
        if node is None:
            continue
        for n in walk(node):
            if isinstance(n, Aggregation):
                spec = _AggSpec(n.agg, n.expr, getattr(n, "param", None))
                specs.setdefault(spec.key, spec)
    return list(specs.values())


def _group_level_eval(
    node: Node,
    key_canon: dict,
    agg_values: dict,
) -> np.ndarray:
    """NumPy evaluator over the (small) per-group aggregate table.
    Used for select items, HAVING and group-level ORDER BY — the repaired
    intent of the reference's host ``eval_having_node`` (warpdb.cpp:387-427),
    except each aggregate evaluates over its *own* expression."""
    if isinstance(node, Alias):
        return _group_level_eval(node.expr, key_canon, agg_values)
    if isinstance(node, Aggregation):
        return agg_values[
            (node.agg.value, node.expr.canonical(),
             getattr(node, "param", None))
        ]
    # Expression group keys (GROUP BY k * 2, EXTRACT(...)) match by
    # canonical BEFORE structural recursion — recursing into a BinaryOp
    # key would dead-end at its bare column leaves.
    canon_early = node.canonical()
    if canon_early in key_canon:
        return key_canon[canon_early]
    if isinstance(node, Constant):
        v = float(node.value)
        if v.is_integer() and abs(v) >= 2**24 and abs(v) <= 2**53:
            # f32 would round large integer literals (HAVING k = 2^24+1
            # must compare exactly against int keys).
            return np.float64(v)
        return np.float32(v)
    if isinstance(node, BinaryOp):
        l = _group_level_eval(node.left, key_canon, agg_values)
        r = _group_level_eval(node.right, key_canon, agg_values)
        op = node.op
        if op == "+":
            return l + r
        if op == "-":
            return l - r
        if op == "*":
            return l * r
        if op == "/":
            # 0/0 → NaN is defined behavior (e.g. sample VARIANCE of a
            # single row); don't warn for it.
            with np.errstate(divide="ignore", invalid="ignore"):
                return l / r
        if op == "%":
            with np.errstate(invalid="ignore"):
                return np.fmod(l, r)
        if op == "&&":
            return np.logical_and(l != 0, r != 0)
        if op == "||":
            return np.logical_or(l != 0, r != 0)
        cmp = {
            ">": np.greater, "<": np.less, ">=": np.greater_equal,
            "<=": np.less_equal, "==": np.equal, "=": np.equal,
            "!=": np.not_equal,
        }[op]
        return cmp(l, r)
    canon = node.canonical()
    if canon in key_canon:
        return key_canon[canon]
    if isinstance(node, CaseWhen):
        out = (
            np.asarray(
                _group_level_eval(node.default, key_canon, agg_values),
                np.float32,
            )
            if node.default is not None
            else np.float32(0.0)
        )
        for c, v in zip(reversed(node.conditions), reversed(node.values)):
            m = np.asarray(_group_level_eval(c, key_canon, agg_values))
            m = m if m.dtype == bool else m != 0
            out = np.where(
                m,
                np.asarray(
                    _group_level_eval(v, key_canon, agg_values), np.float32
                ),
                out,
            )
        return out
    if isinstance(node, FunctionCall):
        args = [
            np.asarray(_group_level_eval(a, key_canon, agg_values), np.float32)
            for a in node.args
        ]
        return np.asarray(udf_mod.resolve_udf(node.name)(*args), np.float32)
    raise UnsupportedError(
        "Grouped SELECT/HAVING/ORDER BY expressions must reference the "
        f"GROUP BY key or aggregates; got: {canon}"
    )


def _provably_not_null(expr, table) -> bool:
    """True when load/join stats prove the bare column ``expr`` holds no
    NULLs in ``table`` — then COUNT(expr) can ride the exact i32 COUNT(*)
    counts with no indicator lane at all.  This also removes the false
    NULLs the -1 marker test would report for legitimate -1 values in
    plain INT columns (ADVICE r4: -1 only means NULL for dict codes and
    LEFT-JOIN fills, both of which the stats record)."""
    e = unalias(expr)
    if table is None or not isinstance(e, Variable):
        return False
    name = e.name if e.name in getattr(table, "stats", {}) else e.unqualified
    st = getattr(table, "stats", {}).get(name)
    if st is None:
        return False
    if name in getattr(table, "dicts", {}):
        # Dict codes are ≥0 at load; only the LEFT-JOIN miss fill
        # introduces -1 (and extends stats.min to -1, _left_fill_stats).
        return st.min is not None and st.min >= 0
    return st.null_count == 0


def _agg_value_from_result(spec: _AggSpec, counts, value_aggs) -> np.ndarray:
    counts_f = counts.astype(np.float32)
    if spec.agg is AggregationType.COUNT:
        if value_aggs is None:
            return counts_f  # COUNT(*): plain row counts
        # COUNT(expr) skips NULLs: exact i32 row counts minus the summed
        # IS-NULL indicator (exact until a group holds 2^24 NULLs; the
        # former summed NOT-null indicator lost exactness at 2^24
        # non-null rows per group, ADVICE r4).  Subtract in f64 — an f32
        # cast of counts would round BEFORE the subtraction and report
        # 2^24−1 for a (2^24+1)-row group with one NULL.
        return (
            counts.astype(np.float64) - value_aggs[0].astype(np.float64)
        ).astype(np.float32)
    sums, mins, maxs = value_aggs
    if spec.agg is AggregationType.SUM:
        return sums
    if spec.agg is AggregationType.AVG:
        return sums / np.maximum(counts_f, 1.0)
    if spec.agg is AggregationType.MIN:
        return mins
    if spec.agg is AggregationType.MAX:
        return maxs
    raise ExecutionError(f"Unknown aggregation {spec.agg}")





def _run_grouped(query: Query, table: DeviceTable, mesh=None) -> np.ndarray:
    """First select item of the grouped pipeline (reference query_sql
    returns only the first expression's values, warpdb.cpp:349-371)."""
    return _run_grouped_multi(
        query, table, [unalias(query.select_list[0])], mesh=mesh
    )[0]


def _grouped_plan(query: Query, select_items: list, table=None) -> dict:
    """Static planning for a grouped query: aggregate specs, deduped value
    expressions, and required reductions.

    ``table`` (optional) enables the stats-gated COUNT(expr) →
    COUNT(*) rewrite for provably-non-NULL columns; callers that plan
    once for many tables (streaming chunks) pass None and take the
    conservative indicator lane.  Device tables are immutable, so any
    table-derived decision here is stable for every memo keyed on the
    table instance."""
    group_keys = list(query.group_by.keys)
    order_terms = query.order_by.terms if query.order_by else ()
    specs = _collect_agg_specs(
        [*select_items, query.having, *(t.expr for t in order_terms)]
    )
    # Map each non-COUNT spec to a value column (dedup by expression
    # canonical); COUNT reads the always-produced per-group counts.
    vexpr_canons: list[str] = []
    vexpr_nodes: list[Node] = []
    spec_to_vidx: dict = {}
    cd_specs: list[_AggSpec] = []
    for spec in specs:
        if spec.agg is AggregationType.COUNT:
            if isinstance(unalias(spec.expr), (_Star, Constant)):
                spec_to_vidx[spec.key] = None  # COUNT(*): plain counts
                continue
            # SQL COUNT(expr) skips NULLs.  Stats-proven non-NULL bare
            # columns take the plain i32 counts (exact, no extra lane,
            # no false NULLs on legitimate -1 INT values — ADVICE r4);
            # everything else rides the SUM machinery over a NEGATED
            # is-NULL indicator (finish computes counts − Σ indicator),
            # so every grouped path (dense, sorted, device finish,
            # streaming partials, distributed) inherits the semantics.
            if _provably_not_null(spec.expr, table):
                spec_to_vidx[spec.key] = None
                continue
            ind = NotNull(spec.expr, negated=True)
            c = ind.canonical()
            if c not in vexpr_canons:
                vexpr_canons.append(c)
                vexpr_nodes.append(ind)
            spec_to_vidx[spec.key] = vexpr_canons.index(c)
            continue
        if spec.agg is AggregationType.COUNT_DISTINCT:
            spec_to_vidx[spec.key] = "cd"
            cd_specs.append(spec)
            continue
        if spec.agg in (
            AggregationType.MEDIAN,
            AggregationType.PERCENTILE,
            AggregationType.STRING_AGG,
            AggregationType.APPROX_COUNT_DISTINCT,
        ):
            spec_to_vidx[spec.key] = "cd"
            cd_specs.append(spec)
            continue
        c = spec.expr.canonical()
        if c not in vexpr_canons:
            vexpr_canons.append(c)
            vexpr_nodes.append(spec.expr)
        spec_to_vidx[spec.key] = vexpr_canons.index(c)
    if not vexpr_nodes:
        # Keys/counts-only query; distributed + dense kernels expect at
        # least one value column.
        vexpr_canons = ["1.0f"]
        vexpr_nodes = [Constant("1")]

    # Which reductions the query actually needs (SUM-only queries skip
    # the min/max passes in the dense kernel).
    need = set()
    for spec in specs:
        if spec.agg in (AggregationType.SUM, AggregationType.AVG):
            need.add("sum")
        elif (
            spec.agg is AggregationType.COUNT
            and spec_to_vidx[spec.key] is not None
        ):
            need.add("sum")  # NULL-skipping COUNT sums its indicator
        elif spec.agg is AggregationType.MIN:
            need.add("min")
        elif spec.agg is AggregationType.MAX:
            need.add("max")
    return {
        "group_keys": group_keys,
        "keys_canon": tuple(k.canonical() for k in group_keys),
        "specs": specs,
        "spec_to_vidx": spec_to_vidx,
        "vexpr_nodes": vexpr_nodes,
        "vexpr_canons": vexpr_canons,
        "cd_specs": cd_specs,
        "need": tuple(sorted(need)),
    }


def _grouped_partials(
    query: Query, table: DeviceTable, plan: dict, mesh=None,
    final: bool = True,
) -> "_HostGroupResult":
    """Compute the per-group aggregate table (keys, counts, sum/min/max
    per value expression) on device — the mergeable partial form shared
    by the single-table, distributed, and out-of-core streaming paths.

    ``final=False`` (streaming per-chunk partials) disables the
    device-side HAVING/ORDER-BY-LIMIT finish: pruning a chunk's groups
    by its PARTIAL aggregates would be wrong — only the merged totals
    decide (the ascending-key ``limit_cap`` pushdown stays legal:
    the global first-k groups are contained in the union of per-chunk
    first-k groups)."""
    group_keys = plan["group_keys"]
    vexpr_nodes = plan["vexpr_nodes"]
    vexpr_canons = plan["vexpr_canons"]
    where_canon = query.where.canonical() if query.where is not None else ""

    result = None
    if mesh is not None and mesh.devices.size > 1:
        result = _distributed_group(query, table, group_keys, vexpr_nodes,
                                    mesh)
    if result is None:
        # Fast path: dense integer-key aggregation (no sort) when
        # stats bound a single key to a small integral range.
        # LIMIT pushdown is legal when groups emerge in the default
        # ascending-key order and nothing downstream re-filters/re-orders.
        limit_cap = None
        # Groups emerge ascending by key, so the pushdown is also legal
        # when ORDER BY names the (single) group key ascending — the
        # default order restated.
        order_is_default = query.order_by is None or (
            len(query.order_by.terms) == 1
            and query.order_by.ascending
            and len(plan["group_keys"]) == 1
            and query.order_by.expr.canonical()
            == plan["group_keys"][0].canonical()
        )
        if (
            query.limit is not None
            and query.having is None
            and order_is_default
            and not query.distinct
            and not plan["cd_specs"]
        ):
            limit_cap = query.limit + (query.offset or 0)
        # Device finish: HAVING + single-term ORDER BY + LIMIT prune and
        # order the groups ON DEVICE (midrange tier), shipping O(limit)
        # instead of O(G).  Expressibility over the partials is checked
        # inside the midrange run; anything else falls back unchanged.
        from ..config import get_config

        device_finish = None
        if (
            final
            and get_config().grouped_device_finish
            and limit_cap is None
            and query.limit is not None
            and not query.distinct
            and not plan["cd_specs"]
            and query.order_by is not None
            and len(query.order_by.terms) == 1
            # Aggregate order terms only: a bare raw-int KEY order would
            # rank through the f32-cast key values, which collide beyond
            # 2^24 (key-ascending limits take the limit_cap pushdown
            # instead; everything else finishes on host).
            and any(
                isinstance(n, Aggregation)
                for n in walk(query.order_by.terms[0].expr)
            )
        ):
            device_finish = {
                "limit": query.limit + (query.offset or 0),
                "order": query.order_by.terms[0],
                "having": query.having,
            }
        result = _try_dense_group(query, table, group_keys, vexpr_nodes,
                                  vexpr_canons, where_canon, plan["need"],
                                  limit_cap=limit_cap,
                                  device_finish=device_finish)
        if result is None:
            result = _sorted_group(
                query, table, group_keys, vexpr_nodes, vexpr_canons,
                where_canon, plan["keys_canon"], plan["need"],
                device_finish=device_finish,
            )
    for spec in plan["cd_specs"]:
        if spec.agg is AggregationType.STRING_AGG:
            result.dcounts[spec.key] = _grouped_string_agg(
                query, table, group_keys, spec, result.num_groups,
                plan["keys_canon"], where_canon,
                raw_int_key=getattr(result, "raw_int_key", False),
            )
            continue
        if spec.agg is AggregationType.APPROX_COUNT_DISTINCT:
            # Streaming per-chunk partials (final=False) ship the raw
            # u8 registers — the mergeable form (elementwise max) —
            # instead of estimates; the stream merge estimates once
            # over the merged registers.
            result.dcounts[spec.key] = _grouped_hll(
                query, table, group_keys, spec.expr, result.num_groups,
                plan["keys_canon"], where_canon,
                raw_int_key=getattr(result, "raw_int_key", False),
                want_registers=not final,
            )
            continue
        result.dcounts[spec.key] = _grouped_value_order_stat(
            query, table, group_keys, spec.expr, result.num_groups,
            plan["keys_canon"], where_canon, spec.agg,
            raw_int_key=getattr(result, "raw_int_key", False),
            param=spec.param,
        )
    return result


def _run_grouped_multi(
    query: Query, table: DeviceTable, select_items: list, mesh=None
) -> list[np.ndarray]:
    """Grouped pipeline for any number of select items.  Each item may be
    an aggregate, the group key itself, or any arithmetic over them
    (``SELECT quantity, SUM(price), SUM(price)/COUNT(*) …``) — exceeds the
    reference, which required a lone aggregate (warpdb.cpp:350-353)."""
    plan = _grouped_plan(query, select_items, table=table)
    result = _grouped_partials(query, table, plan, mesh=mesh)
    return _finish_grouped(query, select_items, plan["specs"],
                           plan["spec_to_vidx"], result, plan["keys_canon"])


def _distributed_group(query, table, group_keys, vexpr_nodes, mesh):
    """Mesh-distributed GROUP BY (single or composite keys).  Picks the
    all_gather partial-merge for small stats-bounded key-space products
    and the all-to-all hash shuffle otherwise — composite keys hash and
    exchange as tuples (VERDICT r1 item 7)."""
    from ..parallel.shuffle import shuffle_grouped
    from ..parallel.sharded import run_grouped_sharded
    from .optimizer import expr_range

    from ..config import get_config

    # Key-space bound: product of per-key ranges (None = unbounded).
    space = 1
    for k in group_keys:
        rng = expr_range(k, table.stats)
        if rng is None or not (
            np.isfinite(rng[0]) and np.isfinite(rng[1])
        ):
            space = None
            break
        space *= max(int(rng[1] - rng[0] + 1), 1)
        if space > get_config().distributed_small_keys:
            break
    small = space is not None and space <= get_config().distributed_small_keys

    if small:
        capacity = _next_pow2(max(space, 16))
        out_keys, out_counts, out_vals, num_groups = run_grouped_sharded(
            list(group_keys), vexpr_nodes, query.where, table, capacity,
            mesh=mesh,
        )
        host = jax.device_get((out_keys, out_counts, out_vals, num_groups))
        out_keys, out_counts, out_vals, num_groups = host
        ng = int(num_groups)
        return _HostGroupResult(
            tuple(k[:ng] for k in out_keys),
            out_counts[:ng],
            tuple((v[0][:ng], v[1][:ng], v[2][:ng]) for v in out_vals),
            ng,
        )

    # Skew-proof map-side combine first: a hot key sends at most one
    # partial per shard, so data skew cannot overflow an exchange bucket.
    from ..parallel.shuffle import combine_shuffle_grouped

    res = combine_shuffle_grouped(
        list(group_keys), vexpr_nodes, query.where, table, mesh=mesh
    )
    if res is None:
        # Per-shard distinct keys exceeded the combine capacity (very
        # high cardinality): exchange raw rows instead.
        res = shuffle_grouped(
            list(group_keys), vexpr_nodes, query.where, table, mesh=mesh
        )
    return _HostGroupResult(
        tuple(res.keys),
        res.counts,
        tuple(
            (res.sums[i], res.mins[i], res.maxs[i])
            for i in range(len(vexpr_nodes))
        ),
        res.num_groups,
    )


def _integral_key_check(table, key_expr) -> tuple:
    """``(integral_static, ok)`` for a dense/midrange-path key:
    integrality is guaranteed for int/string-code columns and
    runtime-checked (memoised per immutable table instance) for float
    expressions."""
    key_dtype = None
    if isinstance(key_expr, Variable):
        key_dtype = table.dtypes.get(key_expr.name) or table.dtypes.get(
            key_expr.unqualified
        )
    integral_static = key_dtype is not None and key_dtype.value in (
        "int32",
        "int64",
        "string",  # dictionary codes are int32 by construction
    )
    if integral_static:
        return True, True
    cols = table.columns
    key_canon = key_expr.canonical()
    memo = getattr(table, "_integral_memo", None)
    if memo is None:
        memo = table._integral_memo = {}
    if key_canon not in memo:
        ikey = ("group_integral", key_canon, schema_signature(cols),
                udf_mod.registry_version())

        def build_intcheck():
            key_fn = build_evaluator(key_expr)

            @jax.jit
            def kernel(cols, num_rows):
                valid = _valid_mask(cols, num_rows)
                k = _broadcast(_as_f32(key_fn(cols)), cols)
                return is_integral(k, valid)

            return kernel

        memo[key_canon] = bool(
            get_or_compile(ikey, build_intcheck)(
                cols, jnp.int32(table.num_rows)
            )
        )
    return False, memo[key_canon]


def _dense_key_plan(table, group_keys):
    """Plan the dense/midrange key: stats-bounded integral range(s).

    Single keys keep the historical behavior.  COMPOSITE keys (r3) pack
    into one dense gid — ``Σ (kᵢ − baseᵢ)·strideᵢ`` with strides the
    suffix products of the per-key widths — when the PRODUCT of the
    stats-proven widths fits the midrange tier: ascending packed order
    is exactly lexicographic ascending per-key order, so group order
    matches the sort path.  Returns None (→ sort path) or a dict with
    ``make_key_fn`` / ``canon`` / ``base`` / ``num_slots`` /
    ``unpack(np keys) -> tuple`` / ``raw_int_key``."""
    from ..config import get_config
    from .optimizer import expr_range

    cfg = get_config()
    infos = []
    total = 1
    for key_expr in group_keys:
        rng = expr_range(key_expr, table.stats)
        if rng is None:
            return None
        lo, hi = rng
        if not (np.isfinite(lo) and np.isfinite(hi)):
            return None
        b = int(np.floor(lo))
        w = int(np.floor(hi)) - b + 1
        if w < 1:
            return None
        if not (-(2**31) <= b and b + w <= 2**31 - 1):
            # Key values outside int32: the dense gid arithmetic would
            # overflow at trace time; the sort path handles these fine.
            return None
        integral_static, ok = _integral_key_check(table, key_expr)
        if not ok:
            return None
        total *= w
        if total > cfg.midrange_group_max_slots:
            return None
        infos.append((key_expr, b, w, integral_static))

    if len(infos) == 1:
        key_expr, base, num_slots, integral_static = infos[0]
        return {
            "make_key_fn": lambda: _raw_or_f32_key_fn(
                key_expr, integral_static
            ),
            "canon": key_expr.canonical(),
            "base": base,
            "num_slots": num_slots,
            "unpack": lambda arr: (arr,),
            "unpack_dev": lambda arr: (arr,),
            "raw_int_key": bool(
                isinstance(key_expr, Variable) and integral_static
            ),
        }

    strides = [1] * len(infos)
    for i in range(len(infos) - 2, -1, -1):
        strides[i] = strides[i + 1] * infos[i + 1][2]

    def make_key_fn():
        parts = [
            (_raw_or_f32_key_fn(k, st), b, s)
            for (k, b, _w, st), s in zip(infos, strides)
        ]

        def key_fn(cols):
            acc = None
            for f, b, s in parts:
                # Cast BEFORE the base shift: stats bound every key value
                # inside int32, so the cast is exact for raw ints and for
                # runtime-integral f32 expressions alike.
                kv = jnp.asarray(f(cols)).astype(jnp.int32)
                term = (kv - jnp.int32(b)) * jnp.int32(s)
                acc = term if acc is None else acc + term
            return acc

        return key_fn

    def unpack(arr):
        g = np.asarray(arr).astype(np.int64)
        outs = []
        for (k, b, w, st), s in zip(infos, strides):
            v = b + (g // s) % w
            outs.append(
                v if st else v.astype(np.float32)
            )
        return tuple(outs)

    def unpack_dev(arr):
        g = arr.astype(jnp.int32)
        return tuple(
            ((g // jnp.int32(s)) % jnp.int32(w) + jnp.int32(b)).astype(
                jnp.float32
            )
            for (_k, b, w, _st), s in zip(infos, strides)
        )

    canon = "__pack[" + "; ".join(
        f"{k.canonical()}@{b}+{w}" for k, b, w, _st in infos
    ) + "]"
    return {
        "make_key_fn": make_key_fn,
        "canon": canon,
        "base": 0,
        "num_slots": total,
        "unpack": unpack,
        "unpack_dev": unpack_dev,
        "raw_int_key": all(
            isinstance(k, Variable) and st for k, _b, _w, st in infos
        ),
    }


def _partials_fn(node, keys_canon, vexpr_canons):
    """Compile an expression over GROUP PARTIALS into ``fn(env) -> jnp``
    evaluated per slot on device, where ``env`` holds the slot tables
    (``counts`` f32, ``sums``/``mins``/``maxs`` per value expression,
    ``keys`` per group key).  Returns None when the expression needs
    anything beyond SUM/AVG/COUNT/MIN/MAX partials, keys, constants,
    arithmetic/comparisons/logicals, and registered scalar functions —
    callers then fall back to the host finish."""
    from ..frontend.ast import Star as _Star

    if node is None:
        return None
    node = unalias(node)
    if isinstance(node, Constant):
        v = jnp.float32(float(node.value))
        return lambda env: v
    if isinstance(node, Variable):
        c = node.canonical()
        if c in keys_canon:
            i = keys_canon.index(c)
            return lambda env: env["keys"][i]
        return None
    if isinstance(node, Aggregation):
        if node.agg is AggregationType.COUNT:
            if isinstance(unalias(node.expr), (_Star, Constant)):
                return lambda env: env["counts"]
            # NULL-skipping COUNT(expr): counts minus the summed IS-NULL
            # indicator the planner registered; when the planner proved
            # the column non-NULL it registered no lane and COUNT(expr)
            # IS the plain row count (see _grouped_plan).
            ci = NotNull(node.expr, negated=True).canonical()
            if ci in vexpr_canons:
                j = vexpr_canons.index(ci)
                return lambda env: env["counts"] - env["sums"][j]
            return lambda env: env["counts"]
        if isinstance(node.expr, _Star):
            return None
        c = node.expr.canonical()
        if c not in vexpr_canons:
            return None
        i = vexpr_canons.index(c)
        if node.agg is AggregationType.SUM:
            return lambda env: env["sums"][i]
        if node.agg is AggregationType.AVG:
            return lambda env: (
                env["sums"][i] / jnp.maximum(env["counts"], 1.0)
            )
        if node.agg is AggregationType.MIN:
            return lambda env: env["mins"][i]
        if node.agg is AggregationType.MAX:
            return lambda env: env["maxs"][i]
        return None
    if isinstance(node, BinaryOp):
        lf = _partials_fn(node.left, keys_canon, vexpr_canons)
        rf = _partials_fn(node.right, keys_canon, vexpr_canons)
        if lf is None or rf is None:
            return None
        op = node.op
        if op in ("&&", "||"):
            comb = jnp.logical_and if op == "&&" else jnp.logical_or
            return lambda env: comb(_as_bool(lf(env)), _as_bool(rf(env)))
        cmp = {
            ">": jnp.greater, "<": jnp.less, ">=": jnp.greater_equal,
            "<=": jnp.less_equal, "==": jnp.equal, "=": jnp.equal,
            "!=": jnp.not_equal,
        }.get(op)
        if cmp is not None:
            return lambda env: cmp(_as_f32(lf(env)), _as_f32(rf(env)))
        arith = {
            "+": jnp.add, "-": jnp.subtract, "*": jnp.multiply,
            "/": jnp.divide, "%": jnp.fmod,
        }.get(op)
        if arith is None:
            return None
        return lambda env: arith(_as_f32(lf(env)), _as_f32(rf(env)))
    if isinstance(node, FunctionCall):
        arg_fns = [
            _partials_fn(a, keys_canon, vexpr_canons) for a in node.args
        ]
        if any(f is None for f in arg_fns):
            return None
        name = node.name

        def call(env):
            fn = udf_mod.resolve_udf(name)
            return _as_f32(fn(*[a(env) for a in arg_fns]))

        return call
    return None


def _try_dense_group(query, table, group_keys, vexpr_nodes, vexpr_canons,
                     where_canon, need=("sum", "min", "max"),
                     limit_cap=None, device_finish=None):
    """Attempt the sort-free GROUP BY ladder — slot tables shipped whole
    for small key ranges, compacted on device for mid-range ones; returns
    None when stats can't prove integral key range(s) narrow enough
    (falls back to the sort path).  Composite keys pack into one gid
    (see _dense_key_plan)."""
    from ..config import get_config

    kp = _dense_key_plan(table, group_keys)
    if kp is None:
        return None
    cfg = get_config()
    base, num_slots = kp["base"], kp["num_slots"]
    key_canon = kp["canon"]

    cols = table.columns
    n_rows = jnp.int32(table.num_rows)

    if num_slots > cfg.dense_group_max_slots:
        if (
            num_slots > cfg.midrange_group_base_slots
            and num_slots > table.num_rows
        ):
            # Beyond the unconditional tier, a slot table wider than
            # the input loses to the sort path (measured — see the
            # config knob's docstring): fall back.
            return None
        return _midrange_group_run(
            query, table, kp, vexpr_nodes, vexpr_canons, where_canon,
            need, limit_cap, device_finish,
        )

    gkey = ("dense_group", key_canon, tuple(vexpr_canons), where_canon,
            schema_signature(cols), base, num_slots, need,
            udf_mod.registry_version())

    def build_dense():
        key_fn = kp["make_key_fn"]()
        val_fns = [build_evaluator(v) for v in vexpr_nodes]
        cond_fn = build_evaluator(query.where) if query.where is not None else None

        @jax.jit
        def kernel(cols, num_rows):
            valid = _valid_mask(cols, num_rows)
            if cond_fn is not None:
                valid = jnp.logical_and(valid, _as_bool(cond_fn(cols)))
            keys = _broadcast(key_fn(cols), cols)
            vals = tuple(_broadcast(_as_f32(f(cols)), cols) for f in val_fns)
            return midrange_group_aggregate(
                keys, vals, valid, base, num_slots, need
            )

        return kernel

    result = jax.device_get(get_or_compile(gkey, build_dense)(cols, n_rows))
    # Dense slots include empty groups; compact to occupied slots so the
    # output contract matches the sort path.
    counts = result.counts
    occ = counts > 0
    keys = kp["unpack"](result.keys[0][occ])
    values = tuple(
        (v.sums[occ], v.mins[occ], v.maxs[occ]) for v in result.values
    )
    out = _HostGroupResult(keys, counts[occ], values, int(occ.sum()))
    # COUNT(DISTINCT) kernels must group keys exactly the way this path
    # did: raw ints when the dense kernel read the raw column(s).
    out.raw_int_key = kp["raw_int_key"]
    return out


def _raw_or_f32_key_fn(key_expr, integral_static: bool):
    """Key evaluator for the dense/midrange paths: bare integer/string
    columns feed kernels as raw ints (f32 would corrupt ids beyond 2^24);
    everything else evaluates to f32."""
    if isinstance(key_expr, Variable) and integral_static:
        kname, kuname = key_expr.name, key_expr.unqualified

        def key_fn(cols):
            arr = cols.get(kname)
            if arr is None:
                arr = cols.get(kuname)
            return arr

        return key_fn
    inner = build_evaluator(key_expr)
    return lambda cols: _as_f32(inner(cols))


def _midrange_group_run(query, table, kp, vexpr_nodes, vexpr_canons,
                        where_canon, need, limit_cap=None,
                        device_finish=None):
    """Mid-range sort-free GROUP BY: scatter/one-hot matmul into a dense
    slot table (ops/aggregate.midrange_group_aggregate), then a
    device-side occupancy compaction so the device→host transfer is
    O(groups), not O(slots).

    Two-phase: phase A aggregates and ships only the ``num_groups``
    scalar; phase B sorts occupied slots to the front (a tiny
    capacity-sized sort) and ships a power-of-two compacted table.
    ``limit_cap`` (LIMIT pushdown — legal when there is no HAVING /
    ORDER BY / DISTINCT / COUNT-DISTINCT, since groups emerge in the
    default ascending-key order) truncates phase B to the first
    ``limit_cap`` groups, making ``GROUP BY k LIMIT 5`` ship 5 rows
    instead of 2^16."""
    from ..config import get_config

    from .optimizer import expr_range

    cols = table.columns
    n_rows = jnp.int32(table.num_rows)
    base, num_slots = kp["base"], kp["num_slots"]
    key_canon = kp["canon"]
    # The one-hot engine scales one-hot columns by the value, so a ±inf/NaN
    # value would poison OTHER slots through 0·inf = NaN — it only runs
    # when stats PROVE every summed expression finite (same gate as the
    # value-space top-k); the scatter engine folds non-finite values
    # exactly.
    import math

    def _finite_range(e):
        r = expr_range(e, table.stats)
        return (
            r is not None and math.isfinite(r[0]) and math.isfinite(r[1])
        )

    values_finite = all(_finite_range(v) for v in vexpr_nodes)
    use_mxu = (
        set(need) <= {"sum"}
        and num_slots <= get_config().mxu_group_max_slots
        and ("sum" not in need or values_finite)
    )

    # Device finish (r3): HAVING + ORDER BY over partial-evaluable
    # expressions + LIMIT run ON DEVICE over the slot table — the host
    # receives O(limit) groups instead of O(G).  Pruned/failing slots sort to the back
    # under a sentinel in float_sort_key space; ties break on slot id
    # for determinism.  Host finishing then re-applies HAVING/ORDER BY
    # over the k survivors — a no-op by construction.
    keys_canon_df = tuple(k.canonical() for k in query.group_by.keys)
    df = None
    if device_finish is not None:
        term = device_finish["order"]
        ord_fn = _partials_fn(term.expr, keys_canon_df, tuple(vexpr_canons))
        hav = device_finish["having"]
        hav_fn = (
            _partials_fn(hav, keys_canon_df, tuple(vexpr_canons))
            if hav is not None
            else False
        )
        if ord_fn is not None and hav_fn is not None:
            df = {
                "limit": device_finish["limit"],
                "ord_fn": ord_fn,
                "asc": term.ascending,
                "hav_fn": hav_fn if hav is not None else None,
                "canon": (
                    term.expr.canonical(),
                    term.ascending,
                    hav.canonical() if hav is not None else "",
                    device_finish["limit"],
                ),
            }

    # With LIMIT pushdown the output capacity is static, so aggregation
    # and occupancy compaction fuse into ONE dispatch — no intermediate
    # num_groups host↔device sync.  Without a limit the
    # two-phase protocol sizes the compacted transfer from the scalar.
    fused_cap = (
        min(_next_pow2(max(min(limit_cap, num_slots), 16)), num_slots)
        if limit_cap is not None
        else 0
    )
    if df is not None:
        fused_cap = min(
            _next_pow2(max(min(df["limit"], num_slots), 16)), num_slots
        )

    def _compact(res, out_cap):
        counts = res.counts
        slots = jnp.arange(num_slots, dtype=jnp.int32)
        okey = jnp.where(counts > 0, slots, jnp.int32(0x7FFFFFFF))
        ops = (okey, res.keys[0], counts) + tuple(
            x for v in res.values for x in (v.sums, v.mins, v.maxs)
        )
        sorted_ops = lax.sort(ops, num_keys=1, is_stable=False)
        return tuple(o[:out_cap] for o in sorted_ops[1:])

    def _finish_device(res, out_cap):
        """HAVING + ORDER-BY top-k over the slot table: survivors sort
        to the front by the order expression, everything else under a
        sentinel; returns the compacted ops + survivor count."""
        from ..ops.sort import float_sort_key

        counts = res.counts.astype(jnp.float32)
        env = {
            "counts": counts,
            "sums": [v.sums for v in res.values],
            "mins": [v.mins for v in res.values],
            "maxs": [v.maxs for v in res.values],
            "keys": list(kp["unpack_dev"](res.keys[0])),
        }
        mask = res.counts > 0
        if df["hav_fn"] is not None:
            mask = jnp.logical_and(mask, _as_bool(df["hav_fn"](env)))
        oku = float_sort_key(_as_f32(df["ord_fn"](env)))
        if not df["asc"]:
            oku = jnp.uint32(0xFFFFFFFF) - oku
        # Sentinel: strictly above every float_sort_key image (NaN maps
        # to 0xFFC00000; the DESC inversion tops out there too).
        oku = jnp.where(mask, oku, jnp.uint32(0xFFFFFFFF))
        slots = jnp.arange(num_slots, dtype=jnp.int32)
        ops = (oku, slots, res.keys[0], res.counts) + tuple(
            x for v in res.values for x in (v.sums, v.mins, v.maxs)
        )
        sorted_ops = lax.sort(ops, num_keys=2, is_stable=False)
        n_surv = jnp.sum(mask.astype(jnp.int32))
        return tuple(o[:out_cap] for o in sorted_ops[2:]) + (n_surv,)

    gkey = ("midrange_group", key_canon, tuple(vexpr_canons), where_canon,
            schema_signature(cols), base, num_slots, need, use_mxu,
            fused_cap, df["canon"] if df is not None else None,
            udf_mod.registry_version())

    def build():
        key_fn = kp["make_key_fn"]()
        val_fns = [build_evaluator(v) for v in vexpr_nodes]
        cond_fn = (
            build_evaluator(query.where) if query.where is not None else None
        )

        @jax.jit
        def kernel(cols, num_rows):
            valid = _valid_mask(cols, num_rows)
            if cond_fn is not None:
                valid = jnp.logical_and(valid, _as_bool(cond_fn(cols)))
            keys = _broadcast(key_fn(cols), cols)
            vals = tuple(_broadcast(_as_f32(f(cols)), cols) for f in val_fns)
            res = midrange_group_aggregate(
                keys, vals, valid, base, num_slots, need, use_mxu
            )
            if df is not None:
                return _finish_device(res, fused_cap)
            if fused_cap:
                return _compact(res, fused_cap) + (res.num_groups,)
            return res

        return kernel

    if fused_cap:
        out = jax.device_get(get_or_compile(gkey, build)(cols, n_rows))
        ng = int(out[-1])
        out = out[:-1]
        ng_eff = min(ng, df["limit"] if df is not None else limit_cap)
    else:
        res = get_or_compile(gkey, build)(cols, n_rows)
        ng = _cached_count(
            table,
            ("midrange_ng", key_canon, where_canon, base, num_slots,
             udf_mod.registry_version()),
            lambda: jax.device_get(res.num_groups),
        )
        ng_eff = ng
        out_cap = min(_next_pow2(max(ng_eff, 16)), num_slots)

        ckey = ("midrange_compact", num_slots, out_cap, len(vexpr_canons),
                need)

        def build_compact():
            @jax.jit
            def kernel(res):
                return _compact(res, out_cap)

            return kernel

        out = jax.device_get(get_or_compile(ckey, build_compact)(res))
    keys_c, counts_c = out[0], out[1]
    vals_flat = out[2:]
    values = tuple(
        (
            vals_flat[3 * i][:ng_eff],
            vals_flat[3 * i + 1][:ng_eff],
            vals_flat[3 * i + 2][:ng_eff],
        )
        for i in range(len(vexpr_nodes))
    )
    result = _HostGroupResult(
        kp["unpack"](keys_c[:ng_eff]), counts_c[:ng_eff], values, ng_eff
    )
    result.raw_int_key = kp["raw_int_key"]
    return result


class _HostGroupResult:
    """GroupResult already pulled to host and compacted."""

    def __init__(self, keys, counts, values, num_groups, dcounts=None):
        self.keys = keys
        self.counts = counts
        self.values = values
        self.num_groups = num_groups
        # COUNT(DISTINCT e) per-group counts, keyed by spec key.
        self.dcounts: dict = dcounts or {}
        # Whether the producing path grouped on raw integer keys (dense
        # fast path) — COUNT(DISTINCT) kernels must match it exactly.
        self.raw_int_key: bool = False


def _grouped_string_agg(query, table, group_keys, spec, num_groups,
                        keys_canon, where_canon,
                        raw_int_key: bool = False) -> np.ndarray:
    """STRING_AGG(expr, sep): one sort by (group keys…, value) puts each
    group's values contiguous and ascending; the device ships the
    sorted values plus per-group counts (O(N) — inherent: the result
    content is every value), and the host decodes + joins.  Segments
    emerge in the same ascending key order as every other grouped path,
    so the object array aligns with the aggregate table row-for-row.
    Values concatenate in ascending value order (deterministic); string
    expressions decode through their vocabulary, numeric expressions
    format with %g.  Empty groups (FILTER'd variants) yield ""."""
    from ..ops.sort import float_sort_key, int_sort_key
    from ..storage.strings import decode_codes

    expr = spec.expr
    cols = table.columns
    n_rows = jnp.int32(table.num_rows)
    capacity = _next_pow2(max(int(num_groups), 16))

    # Vocabulary of the value expression (bare string column or CodeMap).
    from ..frontend.ast import CodeMap, Variable as _Var

    node = unalias(expr)
    vocab = None
    if isinstance(node, CodeMap):
        vocab = node.out_vocab
    elif isinstance(node, _Var) and table.dicts:
        vocab = table.dicts.get(node.name)
        if vocab is None:
            vocab = table.dicts.get(node.unqualified)

    key = ("group_string_agg", keys_canon, expr.canonical(), where_canon,
           schema_signature(cols), capacity, raw_int_key,
           udf_mod.registry_version())

    def build():
        if raw_int_key:
            kvar = group_keys[0]
            kname, kuname = kvar.name, kvar.unqualified

            def raw_key(cols):
                arr = cols.get(kname)
                if arr is None:
                    arr = cols.get(kuname)
                return arr

            key_fns = [raw_key]
        else:
            key_fns = [build_evaluator(k) for k in group_keys]
        val_fn = build_evaluator(expr)
        cond_fn = (
            build_evaluator(query.where) if query.where is not None else None
        )
        u32_max = jnp.uint32(0xFFFFFFFF)

        @jax.jit
        def kernel(cols, num_rows):
            valid = _valid_mask(cols, num_rows)
            if cond_fn is not None:
                valid = jnp.logical_and(valid, _as_bool(cond_fn(cols)))
            if raw_int_key:
                keys = tuple(_broadcast(f(cols), cols) for f in key_fns)
                skeys = tuple(
                    jnp.where(valid, int_sort_key(k), u32_max) for k in keys
                )
            else:
                keys = tuple(
                    _broadcast(_as_f32(f(cols)), cols) for f in key_fns
                )
                skeys = tuple(
                    jnp.where(valid, float_sort_key(k), u32_max)
                    for k in keys
                )
            vals = _broadcast(_as_f32(val_fn(cols)), cols)
            sval = float_sort_key(vals)
            nk = len(skeys)
            sorted_ops = jax.lax.sort(
                skeys + (sval, valid.astype(jnp.int32), vals),
                num_keys=nk + 1,
                is_stable=True,
            )
            skeys_s = sorted_ops[:nk]
            valid_s = sorted_ops[nk + 1].astype(jnp.bool_)
            vals_s = sorted_ops[nk + 2]
            from ..ops.aggregate import sorted_first_flags

            key_first = jnp.logical_and(
                sorted_first_flags(skeys_s), valid_s
            )
            seg = jnp.cumsum(key_first.astype(jnp.int32)) - 1
            seg = jnp.where(valid_s, seg, capacity)
            counts = (
                jnp.zeros((capacity,), jnp.int32)
                .at[seg]
                .add(1, mode="drop")
            )
            n_valid = jnp.sum(valid_s.astype(jnp.int32))
            return vals_s, counts, n_valid

        return kernel

    vals_s, counts, n_valid = jax.device_get(
        get_or_compile(key, build)(cols, n_rows)
    )
    n_valid = int(n_valid)
    vals_s = vals_s[:n_valid]
    counts = counts[: int(num_groups)]
    sep = "" if spec.param is None else str(spec.param)
    if vocab is not None:
        parts = decode_codes(vals_s, vocab)
    else:
        parts = [f"{v:g}" for v in vals_s]
    out = np.empty(int(num_groups), dtype=object)
    pos = 0
    for g, c in enumerate(counts):
        out[g] = sep.join(parts[pos : pos + int(c)])
        pos += int(c)
    return out


def _grouped_hll(query, table, group_keys, expr, num_groups,
                 keys_canon, where_canon, raw_int_key: bool = False,
                 want_registers: bool = False):
    """Per-group APPROX_COUNT_DISTINCT (HyperLogLog, ops/hll.py).

    One sort by the group keys yields ascending segment ids (the same
    group order every other grouped path emits); values hash through
    their ``float_sort_key`` image and scatter-max rho into a
    ``(capacity, m)`` register table — ONE scatter of N updates, the
    midrange GROUP BY's cost class.  The estimate evaluates ON DEVICE
    and ships O(groups) scalars.

    ``want_registers=True`` (the streaming partial form) ships the raw
    u8 registers instead — they merge across chunks/hosts by
    elementwise max with zero precision loss, bounding out-of-core
    DISTINCT state at 4 KB/group regardless of cardinality.

    Groups beyond ``capacity·m ≤ 2^23`` would blow the register table's
    HBM footprint; those fall back to the EXACT sorted kernel (approx
    is for high value cardinality, not high group counts — the exact
    path is already one sort there)."""
    from ..ops.hll import HLL_M, hll_estimate, hll_grouped_registers

    cols = table.columns
    n_rows = jnp.int32(table.num_rows)
    capacity = _next_pow2(max(int(num_groups), 16))
    if capacity * HLL_M > (1 << 23):
        if want_registers:
            # Streaming partials cannot silently switch representation
            # (registers merge by max; exact counts don't): refuse with
            # the remedy.  Register state at this group count would be
            # G x 4 KB anyway — the approx form is the wrong tool.
            from ..errors import UnsupportedError

            raise UnsupportedError(
                "APPROX_COUNT_DISTINCT streaming supports up to "
                f"{(1 << 23) // HLL_M} groups per chunk (got "
                f"{int(num_groups)}); use COUNT(DISTINCT ...) — its "
                "streamed state is bounded by the distinct count"
            )
        return _grouped_value_order_stat(
            query, table, group_keys, expr, num_groups, keys_canon,
            where_canon, AggregationType.COUNT_DISTINCT,
            raw_int_key=raw_int_key,
        )

    key = ("group_hll", keys_canon, expr.canonical(), where_canon,
           schema_signature(cols), capacity, raw_int_key, want_registers,
           udf_mod.registry_version())

    def build():
        from ..ops.sort import float_sort_key, int_sort_key

        if raw_int_key:
            kvar = group_keys[0]
            kname, kuname = kvar.name, kvar.unqualified

            def raw_key(cols):
                arr = cols.get(kname)
                if arr is None:
                    arr = cols.get(kuname)
                return arr

            key_fns = [raw_key]
        else:
            key_fns = [build_evaluator(k) for k in group_keys]
        val_fn = build_evaluator(expr)
        cond_fn = (
            build_evaluator(query.where) if query.where is not None else None
        )
        u32_max = jnp.uint32(0xFFFFFFFF)

        @jax.jit
        def kernel(cols, num_rows):
            valid = _valid_mask(cols, num_rows)
            if cond_fn is not None:
                valid = jnp.logical_and(valid, _as_bool(cond_fn(cols)))
            if raw_int_key:
                keys = tuple(_broadcast(f(cols), cols) for f in key_fns)
                skeys = tuple(
                    jnp.where(valid, int_sort_key(k), u32_max) for k in keys
                )
            else:
                keys = tuple(
                    _broadcast(_as_f32(f(cols)), cols) for f in key_fns
                )
                skeys = tuple(
                    jnp.where(valid, float_sort_key(k), u32_max)
                    for k in keys
                )
            vals = _broadcast(_as_f32(val_fn(cols)), cols)
            sval = float_sort_key(vals)
            nk = len(skeys)
            sorted_ops = jax.lax.sort(
                skeys + (valid.astype(jnp.int32), sval),
                num_keys=nk,
                is_stable=True,
            )
            skeys_s = sorted_ops[:nk]
            valid_s = sorted_ops[nk].astype(jnp.bool_)
            sval_s = sorted_ops[nk + 1]
            from ..ops.aggregate import sorted_first_flags

            key_first = jnp.logical_and(
                sorted_first_flags(skeys_s), valid_s
            )
            seg = jnp.cumsum(key_first.astype(jnp.int32)) - 1
            regs = hll_grouped_registers(seg, sval_s, valid_s, capacity)
            if want_registers:
                return regs.astype(jnp.uint8)
            return hll_estimate(regs)

        return kernel

    out = jax.device_get(get_or_compile(key, build)(cols, n_rows))
    if want_registers:
        return out[: max(int(num_groups), 0)]
    return np.asarray(out[: int(num_groups)], np.float32)


def _grouped_value_order_stat(query, table, group_keys, expr, num_groups,
                              keys_canon, where_canon, agg,
                              raw_int_key: bool = False,
                              param=None) -> np.ndarray:
    """Per-group statistics needing values SORTED WITHIN each group —
    COUNT(DISTINCT expr) and MEDIAN(expr) — from one sort by
    (group keys…, value).  Distinct counts scatter-add value-boundary
    flags per key segment; medians gather the middle element(s) of each
    segment.  Segments emerge in the same ascending key order as every
    other grouped path, so the output aligns with the main aggregate
    table row-for-row."""
    from ..ops.sort import float_sort_key

    cols = table.columns
    n_rows = jnp.int32(table.num_rows)
    capacity = _next_pow2(max(int(num_groups), 16))

    key = ("group_order_stat", agg.value, param, keys_canon,
           expr.canonical(), where_canon, schema_signature(cols), capacity,
           raw_int_key, udf_mod.registry_version())

    def build():
        from ..ops.sort import int_sort_key

        if raw_int_key:
            # Mirror the dense path: group on the raw integer column so
            # ids beyond f32's 2^24 integer range stay distinct.
            kvar = group_keys[0]
            kname, kuname = kvar.name, kvar.unqualified

            def raw_key(cols):
                arr = cols.get(kname)
                if arr is None:
                    arr = cols.get(kuname)
                return arr

            key_fns = [raw_key]
        else:
            key_fns = [build_evaluator(k) for k in group_keys]
        val_fn = build_evaluator(expr)
        cond_fn = build_evaluator(query.where) if query.where is not None else None
        u32_max = jnp.uint32(0xFFFFFFFF)

        @jax.jit
        def kernel(cols, num_rows):
            valid = _valid_mask(cols, num_rows)
            if cond_fn is not None:
                valid = jnp.logical_and(valid, _as_bool(cond_fn(cols)))
            if raw_int_key:
                keys = tuple(_broadcast(f(cols), cols) for f in key_fns)
                skeys = tuple(
                    jnp.where(valid, int_sort_key(k), u32_max) for k in keys
                )
            else:
                keys = tuple(
                    _broadcast(_as_f32(f(cols)), cols) for f in key_fns
                )
                skeys = tuple(
                    jnp.where(valid, float_sort_key(k), u32_max)
                    for k in keys
                )
            vals = _broadcast(_as_f32(val_fn(cols)), cols)
            sval = float_sort_key(vals)
            nk = len(skeys)
            sorted_ops = jax.lax.sort(
                skeys + (sval, valid.astype(jnp.int32), vals),
                num_keys=nk + 1,
                is_stable=True,
            )
            skeys_s = sorted_ops[:nk]
            sval_s = sorted_ops[nk]
            valid_s = sorted_ops[nk + 1].astype(jnp.bool_)
            sorted_vals_ref = (sorted_ops[nk + 2],)
            from ..ops.aggregate import sorted_first_flags

            key_first = sorted_first_flags(skeys_s)
            val_first = jnp.logical_or(
                key_first,
                jnp.concatenate(
                    [jnp.ones((1,), jnp.bool_), sval_s[1:] != sval_s[:-1]]
                ),
            )
            key_first = jnp.logical_and(key_first, valid_s)
            val_first = jnp.logical_and(val_first, valid_s)
            seg = jnp.cumsum(key_first.astype(jnp.int32)) - 1
            seg = jnp.where(valid_s, seg, capacity)
            if agg is AggregationType.COUNT_DISTINCT:
                return (
                    jnp.zeros((capacity,), jnp.int32)
                    .at[seg]
                    .add(val_first.astype(jnp.int32), mode="drop")
                ).astype(jnp.float32)
            # MEDIAN: values are sorted within each segment; gather the
            # middle element(s) via per-group start positions + counts.
            n_pad = sval_s.shape[0]
            pos = jnp.arange(n_pad, dtype=jnp.int32)
            starts = (
                jnp.zeros((capacity,), jnp.int32)
                .at[jnp.where(key_first, seg, capacity)]
                .max(pos, mode="drop")
            )
            counts = (
                jnp.zeros((capacity,), jnp.int32)
                .at[seg]
                .add(1, mode="drop")
            )
            c = jnp.maximum(counts, 1)
            # Linear interpolation at q·(c−1) — numpy's default scheme;
            # MEDIAN is q = 0.5 (reduces to the mean of the two middle
            # values for even counts).
            q = 0.5 if agg is AggregationType.MEDIAN else float(param)
            pos = q * (c - 1).astype(jnp.float32)
            lo_off = jnp.floor(pos).astype(jnp.int32)
            frac = pos - lo_off.astype(jnp.float32)
            lo_idx = jnp.clip(starts + lo_off, 0, n_pad - 1)
            hi_idx = jnp.clip(
                starts + jnp.minimum(lo_off + 1, c - 1), 0, n_pad - 1
            )
            vals_sorted = sorted_vals_ref[0]
            return (
                vals_sorted[lo_idx] * (1.0 - frac)
                + vals_sorted[hi_idx] * frac
            )

        return kernel

    out = np.asarray(get_or_compile(key, build)(cols, n_rows))
    return out[: int(num_groups)].astype(np.float32)


def _sorted_group(query, table, group_keys, vexpr_nodes, vexpr_canons,
                  where_canon, keys_canon, need=("sum", "min", "max"),
                  device_finish=None):
    from ..ops.aggregate import group_scatter_stage, group_sort_stage

    cols = table.columns
    n_rows = jnp.int32(table.num_rows)

    # Phase 1: ONE stable sort carrying keys + values, plus segment ids
    # and the distinct count.  The sorted arrays stay on device; only the
    # scalar count crosses to host to pick the capacity bucket — the
    # count pass and the aggregate pass share the sort (previously each
    # paid its own full O(N log² N) sort).
    #
    # A bare integer/string-code key column sorts on its RAW int bits
    # (int_sort_key): casting to f32 first would collide ids beyond 2^24
    # — exactly the high-cardinality ids that reach this path.
    raw_int = False
    if len(group_keys) == 1 and isinstance(group_keys[0], Variable):
        kd = table.dtypes.get(group_keys[0].name) or table.dtypes.get(
            group_keys[0].unqualified
        )
        raw_int = kd is not None and kd.value in ("int32", "int64", "string")

    skey = ("group_sort", keys_canon, tuple(vexpr_canons), where_canon,
            schema_signature(cols), raw_int, udf_mod.registry_version())

    def build_sort():
        from ..ops.sort import int_sort_key

        key_fns = [build_evaluator(k) for k in group_keys]
        raw_fn = _raw_or_f32_key_fn(group_keys[0], True) if raw_int else None
        val_fns = [build_evaluator(v) for v in vexpr_nodes]
        cond_fn = build_evaluator(query.where) if query.where is not None else None

        @jax.jit
        def kernel(cols, num_rows):
            valid = _valid_mask(cols, num_rows)
            if cond_fn is not None:
                valid = jnp.logical_and(valid, _as_bool(cond_fn(cols)))
            vals = tuple(_broadcast(_as_f32(f(cols)), cols) for f in val_fns)
            if raw_int:
                # Carry the RAW int key through the sort/scatter — an
                # f32 carry would emit collided key VALUES beyond 2^24
                # even though the int_sort_key grouping itself is exact.
                raw = _broadcast(raw_fn(cols), cols)
                return group_sort_stage(
                    (raw,), vals, valid, skeys=(int_sort_key(raw),)
                )
            keys = tuple(_broadcast(_as_f32(f(cols)), cols) for f in key_fns)
            return group_sort_stage(keys, vals, valid)

        return kernel

    keys_s, vals_s, valid_s, seg, ng_dev = get_or_compile(skey, build_sort)(
        cols, n_rows
    )
    if table.padded_rows <= 4096:
        capacity = table.padded_rows
    else:
        ng = _cached_count(
            table,
            ("group_ng", keys_canon, where_canon, raw_int,
             udf_mod.registry_version()),
            lambda: ng_dev,
        )
        capacity = _next_pow2(max(ng, 16))

    # Device finish (r3, mirrors the midrange one): HAVING + single-term
    # ORDER BY + LIMIT prune and order the group table ON DEVICE, so the
    # host receives O(limit) groups instead of O(G) — the win that makes
    # ORDER BY SUM(...) DESC LIMIT k usable at millions of groups.
    df = None
    if device_finish is not None:
        term = device_finish["order"]
        ord_fn = _partials_fn(term.expr, keys_canon, tuple(vexpr_canons))
        hav = device_finish["having"]
        hav_fn = (
            _partials_fn(hav, keys_canon, tuple(vexpr_canons))
            if hav is not None
            else False
        )
        if ord_fn is not None and hav_fn is not None:
            df = {
                "limit": device_finish["limit"],
                "ord_fn": ord_fn,
                "asc": term.ascending,
                "hav_fn": hav_fn if hav is not None else None,
                "canon": (
                    term.expr.canonical(),
                    term.ascending,
                    hav.canonical() if hav is not None else "",
                    device_finish["limit"],
                ),
            }

    # Phase 2: scatter the pre-sorted segments into capacity-sized tables.
    gkey = ("group_scatter", len(keys_canon), len(vexpr_canons),
            table.padded_rows, capacity, need,
            df["canon"] if df is not None else None)
    lim_cap = (
        min(_next_pow2(max(min(df["limit"], capacity), 16)), capacity)
        if df is not None
        else capacity
    )

    def build_scatter():
        from ..ops.sort import float_sort_key

        @jax.jit
        def kernel(keys_s, vals_s, valid_s, seg, ng):
            res = group_scatter_stage(
                tuple(keys_s), tuple(vals_s), valid_s, seg, ng, capacity,
                need,
            )
            if df is None:
                return res
            env = {
                "counts": res.counts.astype(jnp.float32),
                "sums": [v.sums for v in res.values],
                "mins": [v.mins for v in res.values],
                "maxs": [v.maxs for v in res.values],
                "keys": list(res.keys),
            }
            mask = res.counts > 0
            if df["hav_fn"] is not None:
                mask = jnp.logical_and(mask, _as_bool(df["hav_fn"](env)))
            oku = float_sort_key(_as_f32(df["ord_fn"](env)))
            if not df["asc"]:
                oku = jnp.uint32(0xFFFFFFFF) - oku
            oku = jnp.where(mask, oku, jnp.uint32(0xFFFFFFFF))
            slots = jnp.arange(capacity, dtype=jnp.int32)
            ops = (oku, slots) + tuple(res.keys) + (res.counts,) + tuple(
                x for v in res.values for x in (v.sums, v.mins, v.maxs)
            )
            sorted_ops = lax.sort(ops, num_keys=2, is_stable=False)
            n_surv = jnp.sum(mask.astype(jnp.int32))
            return tuple(o[:lim_cap] for o in sorted_ops[2:]) + (n_surv,)

        return kernel

    got = get_or_compile(gkey, build_scatter)(
        tuple(keys_s), tuple(vals_s), valid_s, seg, ng_dev
    )
    if df is not None:
        out_t = jax.device_get(got)
        n_surv = int(out_t[-1])
        ng_eff = min(n_surv, df["limit"])
        nk = len(keys_canon)
        keys = tuple(k[:ng_eff] for k in out_t[:nk])
        counts = out_t[nk][:ng_eff]
        vals_flat = out_t[nk + 1:-1]
        values = tuple(
            (
                vals_flat[3 * i][:ng_eff],
                vals_flat[3 * i + 1][:ng_eff],
                vals_flat[3 * i + 2][:ng_eff],
            )
            for i in range(len(vexpr_nodes))
        )
        out = _HostGroupResult(keys, counts, values, ng_eff)
        out.raw_int_key = raw_int
        return out

    result = jax.device_get(got)

    num_groups = int(result.num_groups)
    keys = tuple(k[:num_groups] for k in result.keys)
    counts = result.counts[:num_groups]
    values = tuple(
        (v.sums[:num_groups], v.mins[:num_groups], v.maxs[:num_groups])
        for v in result.values
    )
    out = _HostGroupResult(keys, counts, values, num_groups)
    # COUNT(DISTINCT)/MEDIAN kernels must group keys exactly as this
    # path did — on raw int bits when the sort did.
    out.raw_int_key = raw_int
    return out


def _finish_grouped(query, select_items, specs, spec_to_vidx,
                    result: "_HostGroupResult", keys_canon) -> list[np.ndarray]:
    """Host-side finishing on the ≤G-sized aggregate table: evaluate each
    select item over (keys, aggregates), then HAVING, ORDER BY over
    groups, DISTINCT.  One list entry per select item, row-aligned."""
    num_groups = result.num_groups
    counts = result.counts
    key_arrays = [k for k in result.keys]
    agg_values = {}
    for spec in specs:
        vidx = spec_to_vidx[spec.key]
        if vidx == "cd":
            agg_values[spec.key] = result.dcounts[spec.key]
        else:
            agg_values[spec.key] = _agg_value_from_result(
                spec, counts, None if vidx is None else result.values[vidx]
            )
    key_canon_map = {c: key_arrays[i] for i, c in enumerate(keys_canon)}

    mask = np.ones(num_groups, dtype=bool)
    if query.having is not None:
        hv = _group_level_eval(query.having, key_canon_map, agg_values)
        hv = np.asarray(hv)
        mask &= hv if hv.dtype == bool else hv != 0

    order = None
    if query.order_by is not None:
        # Multi-term lexicographic sort; descending terms negate their
        # key (stable within ties, matching Python's reverse=True).
        # Keys sort in f64: exact for f32 values AND for int32/int64
        # group keys (an f32 cast would collide keys beyond 2^24).
        keys = []
        for t in query.order_by.terms:
            v = _group_level_eval(t.expr, key_canon_map, agg_values)
            v = np.broadcast_to(
                np.asarray(v, dtype=np.float64), (num_groups,)
            )[mask]
            keys.append(v if t.ascending else -v)
        order = np.lexsort(tuple(reversed(keys)))
    # Default order is ascending by group key (groups emerge key-sorted).

    outs = []
    for item in select_items:
        vals = _group_level_eval(item, key_canon_map, agg_values)
        arr = np.asarray(vals)
        if arr.dtype == object or arr.dtype.kind in "US":
            # String-valued aggregate (STRING_AGG): object array, no
            # float cast; ordering/masking/distinct apply positionally.
            vals = np.broadcast_to(arr, (num_groups,))[mask]
        elif arr.dtype.kind in "iu":
            # Integer group keys stay integer end-to-end (exact beyond
            # 2^24 — the whole point of the raw-int key carry).
            vals = np.broadcast_to(arr, (num_groups,))[mask]
        else:
            vals = np.broadcast_to(
                np.asarray(vals, dtype=np.float32), (num_groups,)
            )[mask]
        if order is not None:
            vals = vals[order]
        if query.distinct:
            if vals.dtype == object or vals.dtype.kind in "US":
                vals = np.unique(vals.astype(str)).astype(object)
            else:
                vals = np.unique(vals)
            if query.order_by is not None and not query.order_by.ascending:
                vals = vals[::-1]
        if vals.dtype == object or vals.dtype.kind in "US":
            outs.append(np.asarray(vals, dtype=object))
        elif vals.dtype.kind in "iu":
            outs.append(np.ascontiguousarray(vals))
        else:
            outs.append(np.ascontiguousarray(vals, dtype=np.float32))
    return outs


