"""EXPLAIN: human-readable physical-plan description.

Observability beyond the reference (whose only introspection was
``std::cout`` result dumps, SURVEY.md §5).  ``explain_query`` runs the
same plan decisions as the executor — stats verdicts, dense-vs-sorted
GROUP BY selection, top-k eligibility, distribution strategy — without
touching the device, and renders them as an indented plan tree.
"""

from __future__ import annotations

from typing import Optional

from ..config import get_config
from ..frontend.ast import (
    Aggregation,
    Query,
    StringLiteral,
    WindowFunction,
    unalias,
    walk,
)
from ..ops.aggregate import SWEEP_MAX_SLOTS
from ..storage.table import DeviceTable

__all__ = ["explain_query", "explain_expression"]


def _fmt(node) -> str:
    return node.canonical()


def explain_expression(table: DeviceTable, expr, cond) -> str:
    from .optimizer import analyze_condition, fold_constants

    lines = ["Expression plan (fused filter+projection, one XLA program):"]
    expr = fold_constants(expr)
    lines.append(f"  project: {_fmt(expr)}")
    if cond is not None:
        verdict = analyze_condition(fold_constants(cond), table.stats)
        if verdict is False:
            lines.append(
                f"  filter:  {_fmt(cond)}  [stats: always false -> scan skipped]"
            )
        elif verdict is True:
            lines.append(
                f"  filter:  {_fmt(cond)}  [stats: always true -> dropped from kernel]"
            )
        else:
            lines.append(f"  filter:  {_fmt(cond)}  [fused into kernel]")
    lines.append(
        f"  scan: {table.num_rows} rows (padded {table.padded_rows}), "
        f"columns on device"
    )
    return "\n".join(lines)


def explain_query(
    query: Query,
    table: DeviceTable,
    catalog: Optional[dict] = None,
    mesh=None,
) -> str:
    from .executor import _expand_stars
    from .optimizer import analyze_condition, expr_range, fold_constants

    cfg = get_config()
    catalog = catalog or {}
    lines = [f"Plan for: {query.canonical()}"]

    if query.joins:
        # Show the plan the executor will actually run: implicit-join
        # equality conjuncts lift out of WHERE into ON conditions.
        from .join_exec import _lift_implicit_join_conditions

        query = _lift_implicit_join_conditions(query, table, catalog)

    if getattr(query, "from_subquery", None) is not None:
        lines.append(
            f"  from: derived table '{query.from_table}' — the inner "
            "SELECT materialises first (stats recomputed, so the outer "
            "query keeps every stats-gated fast path; memoised per "
            "source table)"
        )

    current = table
    for join in query.joins:
        right = catalog.get(join.table, table)
        if mesh is not None and getattr(mesh.devices, "size", 1) > 1:
            how = (
                f"DISTRIBUTED hash-partitioned all-to-all shuffle join "
                f"({mesh.devices.size} devices)"
            )
        else:
            from .executor import _equality_pairs

            try:
                n_pairs = len(_equality_pairs(join.condition))
            except Exception:
                n_pairs = 0
            small = (
                (n_pairs == 1 or join.condition is None)
                and right.num_rows <= cfg.join_dense_build_max
            )
            if small:
                how = (
                    "dense phase 1 (virtual (N, K) compare, no probe "
                    "sorts); 1:1 joins degrade to a probe-preserving "
                    "lookup"
                )
            else:
                how = (
                    "sort-merge: match-count -> pow2 capacity -> gather"
                )
        jk = {
            "left": "left outer",
            "right": "right outer",
            "full": "full outer",
            "cross": "cross",
        }.get(getattr(join, "kind", "inner"), "inner")
        if join.condition is None:
            lines.append(
                f"  join: cross join with '{join.table}' "
                f"(cartesian product via a constant-key equi-join) "
                f"[{how}; build side {right.num_rows} rows]"
            )
        else:
            lines.append(
                f"  join: {jk} equi-join with '{join.table}' on "
                f"{_fmt(join.condition)} "
                f"[{how}; build side {right.num_rows} rows]"
            )

    if (
        query.joins
        and query.where is not None
        and cfg.join_filter_pushdown
        and not (mesh is not None and getattr(mesh.devices, "size", 1) > 1)
    ):
        from .join_exec import _classify_build_conjuncts

        by_rel, _rest, _p, implied = _classify_build_conjuncts(
            query, table, catalog
        )
        for rname, conjs in by_rel.items():
            pred = " AND ".join(_fmt(c) for c in conjs)
            lines.append(
                f"  pushdown: {pred} -> compacts '{rname}' BEFORE the "
                "join (two-phase count + position sort; skipped at "
                ">= 50% selectivity)"
            )
        for rname, disjs in implied.items():
            pred = " AND ".join(_fmt(c) for c in disjs)
            lines.append(
                f"  pushdown (implied): {pred} -> pre-shrinks '{rname}' "
                "(derived from an OR conjunct; the original stays in "
                "WHERE)"
            )

    select_items = [
        unalias(s)
        for s in _expand_stars(
            query.select_list, current, query.from_table
        )
    ]

    verdict = None
    if query.where is not None:
        verdict = analyze_condition(fold_constants(query.where), current.stats)
        tag = {True: "always true -> dropped", False: "always false -> empty result",
               None: "fused into kernel"}[verdict]
        lines.append(f"  where: {_fmt(query.where)}  [stats: {tag}]")

    uses_strings = any(
        isinstance(n, StringLiteral)
        for item in select_items + [query.where, query.having]
        if item is not None
        for n in walk(item)
    )
    if uses_strings or current.dicts:
        dict_cols = ", ".join(sorted(current.dicts)) or "-"
        lines.append(
            f"  strings: dictionary-encoded columns [{dict_cols}]; literals "
            "bind to codes at lowering"
        )

    if getattr(query, "qualify", None) is not None:
        lines.append(
            f"  qualify: {_fmt(query.qualify)}  [window predicate: each "
            "comparison side rides the window pipeline as a hidden "
            "select item; boolean filter host-side over O(result) rows]"
        )

    if query.group_by is not None and query.group_by.sets is not None:
        ks = query.group_by.keys
        rendered = ", ".join(
            "(" + ", ".join(_fmt(ks[i]) for i in s) + ")"
            for s in query.group_by.sets
        )
        lines.append(
            f"  group by grouping sets: {rendered}"
        )
        lines.append(
            f"    strategy: {len(query.group_by.sets)} grouped passes "
            "(one per set) through the dense/midrange/sort ladder; rolled-up "
            "keys read NULL; O(groups) host-side concat + order/limit"
        )
    elif query.group_by is not None:
        keys = ", ".join(_fmt(k) for k in query.group_by.keys)
        lines.append(f"  group by: {keys}")
        if mesh is not None and getattr(mesh.devices, "size", 1) > 1:
            rng = (
                expr_range(query.group_by.keys[0], current.stats)
                if len(query.group_by.keys) == 1
                else None
            )
            small = rng is not None and (
                rng[1] - rng[0] + 1
            ) <= cfg.distributed_small_keys
            if small:
                lines.append(
                    f"    strategy: DISTRIBUTED shard_map partial aggregation "
                    f"+ all_gather merge ({mesh.devices.size} devices; "
                    f"key range {int(rng[0])}..{int(rng[1])})"
                )
            else:
                lines.append(
                    f"    strategy: DISTRIBUTED all-to-all hash shuffle "
                    f"({mesh.devices.size} devices)"
                )
        else:
            import math

            # Mirror _dense_key_plan: the product of the per-key
            # stats-proven widths sizes the packed slot space (single
            # keys are the width itself).
            slots = 1
            for k in query.group_by.keys:
                rng = expr_range(k, current.stats)
                if rng is None or not (
                    math.isfinite(rng[0]) and math.isfinite(rng[1])
                ):
                    slots = None
                    break
                slots *= int(rng[1]) - int(rng[0]) + 1
                if slots > cfg.midrange_group_max_slots:
                    slots = None
                    break
            packed = (
                ", packed composite key"
                if len(query.group_by.keys) > 1
                else ""
            )
            if slots is not None and slots <= cfg.dense_group_max_slots:
                lines.append(
                    f"    strategy: DENSE integer-key aggregation "
                    f"({slots} slots, stats-bounded{packed}; no sort — "
                    + ("compare sweep" if slots <= SWEEP_MAX_SLOTS
                       else "scatter")
                    + " into a slot table)"
                )
            elif slots is not None and (
                slots <= cfg.midrange_group_base_slots
                or slots <= current.num_rows
            ):
                engine = (
                    "one-hot matmul histogram"
                    if slots <= cfg.mxu_group_max_slots
                    else "scatter slot table"
                )
                lines.append(
                    f"    strategy: MIDRANGE sort-free aggregation "
                    f"({slots} slots, stats-bounded{packed}; {engine} for "
                    "SUM/COUNT, scatter for MIN/MAX; device-side "
                    "occupancy compaction)"
                )
            else:
                lines.append(
                    "    strategy: SORTED segmented aggregation "
                    "(radix-sortable keys -> lax.sort -> segment reduce)"
                )
        aggs = {
            n.canonical()
            for item in select_items + [query.having] + [
                t.expr for t in (query.order_by.terms if query.order_by else ())
            ]
            if item is not None
            for n in walk(item)
            if isinstance(n, Aggregation)
        }
        lines.append(f"    aggregates (one pass): {', '.join(sorted(aggs)) or '-'}")
        if (
            cfg.grouped_device_finish
            and query.limit is not None
            and not query.distinct
            and query.order_by is not None
            and len(query.order_by.terms) == 1
            and any(
                isinstance(n, Aggregation)
                for n in walk(query.order_by.terms[0].expr)
            )
            and not (
                mesh is not None and getattr(mesh.devices, "size", 1) > 1
            )
        ):
            lines.append(
                "    finish: HAVING + ORDER BY + LIMIT on device when "
                "expressible over the partials — ships O(limit) groups, "
                "not O(G)"
            )
        if query.having is not None:
            lines.append(
                f"  having: {_fmt(query.having)}  [host, over <=G aggregate table]"
            )
    elif select_items and isinstance(select_items[0], WindowFunction):
        w = select_items[0]
        if w.order_by:
            kind = "running (segmented scan)"
        else:
            kind = "partition broadcast (sort-based)"
            if (
                w.agg.value in ("sum", "avg", "count", "min", "max")
                and len(w.partition_by) <= 1
            ):
                import math

                rng = (
                    expr_range(w.partition_by[0], current.stats)
                    if w.partition_by
                    else (0.0, 0.0)
                )
                if rng is not None and not (
                    math.isfinite(rng[0]) and math.isfinite(rng[1])
                ):
                    rng = None
                if rng is not None and (
                    int(rng[1]) - int(rng[0]) + 1
                ) <= cfg.dense_group_max_slots:
                    kind = (
                        "DENSE partition broadcast (stats-bounded key; "
                        "no sort, no scatter-back)"
                    )
        lines.append(f"  window: {_fmt(w)}  [{kind}]")
    elif select_items and isinstance(select_items[0], Aggregation):
        lines.append(
            f"  global aggregate: {_fmt(select_items[0])}  [single fused reduction]"
        )
    else:
        lines.append(
            f"  project: {', '.join(_fmt(s) for s in select_items)}"
        )

    if query.order_by is not None:
        terms = ", ".join(
            f"{_fmt(t.expr)} {'ASC' if t.ascending else 'DESC'}"
            for t in query.order_by.terms
        )
        limit_total = (query.limit or 0) + (query.offset or 0)
        single = len(query.order_by.terms) == 1
        same = (
            single
            and select_items
            and query.order_by.expr.canonical() == select_items[0].canonical()
        )
        if (
            query.group_by is None
            and same
            and not query.distinct
            and query.limit is not None
            and 0 < limit_total < current.padded_rows // 2
        ):
            lines.append(
                f"  order by: {terms}  [two-stage top-k pull, k~{limit_total}]"
            )
        elif query.group_by is not None:
            lines.append(f"  order by: {terms}  [host lexsort over groups]")
        else:
            lines.append(f"  order by: {terms}  [device stable multi-key sort]")
    if query.distinct:
        import math

        drng = (
            expr_range(select_items[0], current.stats)
            if select_items and query.group_by is None
            else None
        )
        if drng is not None and not (
            math.isfinite(drng[0]) and math.isfinite(drng[1])
        ):
            drng = None
        if drng is not None and (
            int(drng[1]) - int(drng[0]) + 1
        ) <= cfg.midrange_group_max_slots:
            lines.append(
                "  distinct: DENSE/MIDRANGE occupancy if integral "
                "(stats-bounded; no sort, O(distinct) transfer), else "
                "sort-unique"
            )
        else:
            lines.append("  distinct: sort-unique on device")
    if query.offset is not None or query.limit is not None:
        lines.append(
            f"  offset/limit: offset={query.offset or 0} limit={query.limit}"
            "  [host-side, after sort]"
        )
    lines.append(
        f"  scan: {current.num_rows} rows (padded {current.padded_rows}); "
        "kernel cached by canonical plan"
    )
    return "\n".join(lines)
