"""Out-of-core streaming execution.

The reference streams CSVs in chunks through the multi-GPU path
(warpdb.cpp:544-590 / main.cu:25-52): load chunk → upload → recompile →
launch → copy back, strictly sequentially.  Here each chunk is uploaded
row-sharded and dispatched through the *cached* jitted kernel; JAX's
asynchronous dispatch overlaps chunk k+1's host parse/upload with chunk
k's device compute automatically (double buffering for free), and no
recompilation happens after the first chunk of a given shape.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..api import _split_where
from ..errors import ParseError, TokenizeError, WarpDBError
from ..frontend import parse_expression, tokenize, validate_expression
from ..storage.chunks import iter_table_chunks, table_column_names
from ..storage.table import DeviceTable
from .mesh import data_mesh
from .sharded import run_expression_sharded, shard_table

__all__ = ["run_streaming_csv", "run_streaming_sql"]


def run_streaming_csv(
    csv_path: str,
    expr: str,
    rows_per_chunk: Optional[int] = None,
    mesh=None,
    schema=None,
) -> np.ndarray:
    """Stream ``csv_path`` in chunks, evaluating ``expr [WHERE cond]`` on
    every chunk across all devices; results concatenate in row order."""
    if not expr or not expr.strip():
        raise WarpDBError("Empty query expression")
    if rows_per_chunk is None:
        from ..config import get_config

        rows_per_chunk = get_config().rows_per_chunk
    if mesh is None:
        mesh = data_mesh()

    expr_part, where_part = _split_where(expr)
    try:
        expr_ast = parse_expression(tokenize(expr_part))
    except (ParseError, TokenizeError) as e:
        raise ParseError(f"Failed to parse expression: {e}") from None
    cond_ast = None
    if where_part is not None and where_part.strip():
        try:
            cond_ast = parse_expression(tokenize(where_part))
        except (ParseError, TokenizeError) as e:
            raise ParseError(f"Failed to parse WHERE clause: {e}") from None

    # Validate against the header/schema before reading any data
    # (reference validated against hardcoded {price, quantity},
    # warpdb.cpp:560 — we use the real schema).
    columns = set(table_column_names(csv_path))
    validate_expression(expr_ast, columns)
    if cond_ast is not None:
        validate_expression(cond_ast, columns)

    # Bounded in-flight window: dispatch runs ahead of the device and the
    # device→host copies, so chunk k+1's CSV parse + upload overlap chunk
    # k's compute (true double buffering; the reference was strictly
    # sequential, warpdb.cpp:580-587).  The window bounds HBM residency
    # so datasets larger than device memory still stream.
    max_in_flight = 2
    in_flight: list = []  # (device_array, num_rows)
    pieces: list[np.ndarray] = []

    def drain_one() -> None:
        dev, n_rows = in_flight.pop(0)
        pieces.append(np.asarray(dev)[:n_rows])

    for chunk in iter_table_chunks(csv_path, rows_per_chunk, schema):
        if mesh.devices.size > 1:
            dt = shard_table(chunk, mesh)
        else:
            dt = DeviceTable.from_host(chunk, keep_host=False)
        if dt.dicts:
            raise WarpDBError(
                "Streaming expressions do not support string columns "
                "(per-chunk dictionaries are not comparable across chunks)"
            )
        out = run_expression_sharded(
            dt, expr_ast, cond_ast, mesh=mesh, device_out=True
        )
        in_flight.append((out, dt.num_rows))
        if len(in_flight) >= max_in_flight:
            drain_one()
    while in_flight:
        drain_one()
    if not pieces:
        return np.zeros(0, dtype=np.float32)
    return np.concatenate(pieces)


def run_streaming_sql(
    csv_path: str,
    sql: str,
    rows_per_chunk: Optional[int] = None,
    mesh=None,
    schema=None,
    dims: Optional[dict] = None,
    _ast=None,
) -> dict:
    """Out-of-core SQL aggregation: stream a CSV in chunks, aggregate each
    chunk on device into a per-group partial table (keys, counts,
    sum/min/max per value expression), merge partials on host, and apply
    HAVING / ORDER BY / LIMIT to the merged table.

    Supports grouped and global aggregation queries — including
    DISTINCT and COUNT(DISTINCT), whose per-chunk sorted-unique partials
    merge exactly with state bounded by the distinct count — over
    datasets far larger than device memory: the out-of-core analogue of
    GROUP BY that the reference never had (its streaming path only ran
    per-row projection, warpdb.cpp:544-590).  Per-row queries stream
    too: plain projection/WHERE concatenates in stream order (with a
    LIMIT stopping the stream early), and ``ORDER BY … LIMIT k`` runs a
    running top-k merge with O(k) state and transfer (see
    ``_stream_perrow``).  Window / MEDIAN / PERCENTILE queries and
    ORDER BY without LIMIT are rejected (they need global row state);
    JOINs run against in-memory ``dims`` tables.

    ``dims`` maps table names to in-memory ``HostTable`` dimension
    tables: the streamed fact chunks JOIN against them (the canonical
    out-of-core star-schema workload — each chunk takes the usual join
    fast paths, typically the probe-preserving lookup).  Joins against
    tables not present in ``dims`` are rejected.

    Returns ``{column_name: list}`` like ``query_sql_table``.
    """
    import copy as _copy

    from ..engine.executor import (
        _HostGroupResult,
        _finish_grouped,
        _grouped_partials,
        _grouped_plan,
        result_column_name,
    )
    from ..errors import UnsupportedError
    from ..frontend import parse_query, validate_query
    from ..frontend.ast import (
        Aggregation,
        AggregationType,
        Constant,
        GroupBy,
        WindowFunction,
        unalias,
        walk,
    )

    if rows_per_chunk is None:
        from ..config import get_config

        rows_per_chunk = get_config().rows_per_chunk

    ast = _ast if _ast is not None else parse_query(tokenize(sql))
    if getattr(ast, "set_ops", None):
        raise UnsupportedError(
            "Streaming SQL does not support UNION/EXCEPT/INTERSECT"
        )
    if ast.group_by is not None and ast.group_by.sets is not None:
        raise UnsupportedError(
            "Streaming SQL does not support GROUPING SETS / ROLLUP / "
            "CUBE — run one streaming query per grouping set"
        )
    dims = dims or {}
    for j in ast.joins:
        if (j.source or j.table) not in dims:
            raise UnsupportedError(
                "Streaming SQL joins require the build table in `dims` "
                f"(got JOIN {j.source or j.table})"
            )
        if getattr(j, "kind", "inner") in ("right", "full"):
            # Per-chunk build-side misses would duplicate across chunks:
            # whether a dimension row is unmatched is a whole-stream
            # property.  INNER and LEFT are chunk-local (each probe row
            # lives in exactly one chunk).
            raise UnsupportedError(
                "Streaming SQL supports INNER and LEFT joins only"
            )
    if _streaming_windows_eligible(ast, csv_path):
        # Partition-aggregate windows stream in two passes (VERDICT r4
        # #6): the per-partition slot tables that make windows
        # distribute merge across chunks exactly like grouped partials.
        return _stream_windowed(
            ast, csv_path, rows_per_chunk, mesh, schema, dims,
        )
    for item in [*ast.select_list, ast.having,
                 *(t.expr for t in (ast.order_by.terms if ast.order_by else ()))]:
        if item is None:
            continue
        for n in walk(item):
            if isinstance(n, WindowFunction):
                raise UnsupportedError(
                    "Streaming SQL supports only the partition-aggregate "
                    "window family (SUM/AVG/COUNT/MIN/MAX OVER "
                    "(PARTITION BY bare columns)) — ordered/framed "
                    "windows need global row order"
                )
            if isinstance(n, Aggregation) and n.agg in (
                AggregationType.MEDIAN, AggregationType.PERCENTILE,
                AggregationType.STRING_AGG,
            ):
                # Per-chunk medians are not mergeable (an exact merge
                # needs every value) and STRING_AGG's state is the whole
                # value multiset; COUNT(DISTINCT) IS mergeable via
                # per-chunk sorted-unique pair sets — see below.
                raise UnsupportedError(
                    f"Streaming SQL does not support {n.agg.name}"
                )

    columns = set(table_column_names(csv_path))
    catalog_dev: dict = {}
    if ast.joins:
        for name, ht in dims.items():
            dt_dim = (
                shard_table(ht, mesh)
                if mesh is not None and mesh.devices.size > 1
                else DeviceTable.from_host(ht)
            )
            catalog_dev[name] = dt_dim
            for col in dt_dim.dtypes:
                columns.add(col)
                columns.add(f"{name}.{col}")
    validate_query(
        ast,
        columns,
        {ast.from_table, *catalog_dev.keys(),
         *(j.table for j in ast.joins)},
    )

    query = _copy.copy(ast)
    # Per-row queries (no aggregation/grouping/distinct): stream chunks
    # through the full engine — projection, WHERE, and ORDER BY…LIMIT
    # (a mergeable running top-k) all work out-of-core.
    if (
        query.group_by is None
        and not query.distinct
        and query.having is None
        and not any(
            isinstance(n, Aggregation)
            for item in [
                *query.select_list,
                *(t.expr for t in
                  (query.order_by.terms if query.order_by else ())),
            ]
            for n in walk(unalias(item))
        )
    ):
        return _stream_perrow(
            query, csv_path, rows_per_chunk, schema, mesh, catalog_dev
        )
    if query.distinct:
        # SELECT DISTINCT e1, e2, … ≡ GROUP BY e1, e2, … selecting the
        # keys: the per-chunk group keys are exactly the chunk's
        # distinct tuples and the u32-keyed merge below unions them
        # exactly (lexicographic over all key columns).
        sels = [unalias(s) for s in query.select_list]
        if any(
            isinstance(n, Aggregation) for s in sels for n in walk(s)
        ):
            raise UnsupportedError(
                "Streaming SQL does not support DISTINCT over aggregates"
            )
        keys, seen_canon = [], set()
        for s in sels:
            c = s.canonical()
            if c not in seen_canon:
                seen_canon.add(c)
                keys.append(s)
        query.distinct = False
        query.group_by = GroupBy(tuple(keys))
    if query.group_by is None:
        # Global aggregates = one synthetic constant group.
        if not all(
            isinstance(unalias(s), Aggregation) for s in query.select_list
        ):
            raise UnsupportedError(
                "Streaming SQL supports aggregation queries only "
                "(per-row results need the expression streaming path)"
            )
        query.group_by = GroupBy((Constant("1"),))

    # String columns need codes comparable ACROSS chunks: a host-side
    # pre-pass over the (cheap, parse-only) chunk stream builds one
    # global vocabulary shared by every string column, and each chunk
    # then encodes against it.
    global_dicts: dict = {}
    str_col_names: list = []
    uniques: set = set()
    for chunk in iter_table_chunks(csv_path, rows_per_chunk, schema):
        for col in chunk.columns:
            if not col.dtype.is_numeric:
                if col.name not in str_col_names:
                    str_col_names.append(col.name)
                uniques.update(
                    "" if v is None else str(v) for v in col.data
                )
        if not str_col_names:
            break  # first chunk defines the schema; no strings anywhere
    bind_dicts = dict(global_dicts)
    for name, dt_dim in catalog_dev.items():
        for col, vocab_d in dt_dim.dicts.items():
            bind_dicts[f"{name}.{col}"] = vocab_d
            bind_dicts.setdefault(col, vocab_d)
    if str_col_names:
        vocab = np.asarray(sorted(uniques))
        global_dicts = {name: vocab for name in str_col_names}
        bind_dicts.update({name: vocab for name in str_col_names})
    if bind_dicts:
        from types import SimpleNamespace

        from ..engine.executor import _bind_query_strings

        query = _bind_query_strings(
            query, SimpleNamespace(dicts=bind_dicts)
        )

    q_join = None
    if query.joins:
        q_join = query
        query = _copy.copy(query)
        query.joins = []

    select_items = [unalias(s) for s in query.select_list]
    plan = _grouped_plan(query, select_items)
    nv = len(plan["vexpr_nodes"])

    # COUNT(DISTINCT e): mergeable via per-chunk sorted-unique
    # (group keys…, e) pair sets — each chunk contributes its distinct
    # pairs (computed on device as the group keys of a synthetic
    # GROUP BY (keys…, e) COUNT query), the u32 merge unions them, and
    # the final per-group count is a bincount over key-tuple ids.
    # State is bounded by the DISTINCT pair count, not the row count.
    cd_runs = []
    hll_specs = []
    for spec in plan["cd_specs"]:
        if spec.agg is AggregationType.APPROX_COUNT_DISTINCT:
            # APPROX_COUNT_DISTINCT: per-chunk u8 HLL registers arrive
            # in the chunk partials (``_grouped_partials(final=False)``)
            # and merge by elementwise max — 4 KB of state per group
            # regardless of value cardinality (the whole point of the
            # approx variant out-of-core).
            hll_specs.append(spec)
            continue
        q_cd = _copy.copy(query)
        q_cd.group_by = GroupBy((*query.group_by.keys, spec.expr))
        items_cd = [Aggregation(AggregationType.COUNT, Constant("1"))]
        cd_runs.append((spec, q_cd, _grouped_plan(q_cd, items_cd)))

    def _u32_keys(key_cols) -> np.ndarray:
        """per-key arrays → lexicographically orderable u32 matrix.
        Float keys use float_sort_key semantics (-0.0 ≡ +0.0, all NaNs
        equal & last); INT keys use raw int bits (exact beyond 2^24) —
        the exact grouping the device kernels use, so the host merge can
        never split or duplicate a group."""
        rows = []
        for a in key_cols:
            a = np.asarray(a)
            if a.dtype.kind in "iu":
                rows.append(
                    a.astype(np.int32).view(np.uint32)
                    ^ np.uint32(0x80000000)
                )
                continue
            a = np.asarray(a, np.float32)
            a = np.where(a == 0.0, np.float32(0.0), a)
            a = np.where(np.isnan(a), np.float32(np.nan), a)
            bits = a.view(np.uint32)
            rows.append(
                np.where(bits >= 0x80000000, ~bits, bits | 0x80000000)
            )
        return np.stack(rows, axis=0) if rows else np.zeros((0, 0), np.uint32)

    nk = len(plan["keys_canon"])
    # Keys accumulate as per-key 1-D arrays (NOT one stacked f32 matrix)
    # so INT keys keep their dtype — exact beyond 2^24; dtypes bind on
    # the first chunk.
    acc_keys = None
    acc_counts = np.zeros(0, np.int64)
    acc_sums = [np.zeros(0, np.float64) for _ in range(nv)]
    acc_mins = [np.zeros(0, np.float32) for _ in range(nv)]
    acc_maxs = [np.zeros(0, np.float32) for _ in range(nv)]
    acc_cd = {spec.key: None for spec, _q, _p in cd_runs}
    from ..ops.hll import HLL_M, hll_estimate_np

    acc_hll = {spec.key: np.zeros((0, HLL_M), np.uint8)
               for spec in hll_specs}

    if mesh is None:
        mesh = data_mesh()
    for chunk in iter_table_chunks(csv_path, rows_per_chunk, schema):
        if mesh.devices.size > 1:
            dt = shard_table(chunk, mesh, dicts_override=global_dicts or None)
        else:
            dt = DeviceTable.from_host(
                chunk, keep_host=False,
                dicts_override=global_dicts or None,
            )
        chunk_mesh = mesh if mesh.devices.size > 1 else None
        if q_join is not None:
            from ..engine.join_exec import _materialize_joins

            dt = _materialize_joins(q_join, dt, catalog_dev, mesh=chunk_mesh)
        part = _grouped_partials(query, dt, plan, mesh=chunk_mesh,
                                  final=False)
        ng = int(part.num_groups)
        ck = [np.asarray(k)[:ng] for k in part.keys]

        # Vectorized merge: concatenate accumulated + chunk groups, then
        # re-reduce per unique key tuple (u32 space).  O(G log G) NumPy
        # instead of the former per-group Python loop.
        if acc_keys is None:
            keys_all = ck
        else:
            keys_all = [
                np.concatenate([a, c]) for a, c in zip(acc_keys, ck)
            ]
        counts_all = np.concatenate(
            [acc_counts, np.asarray(part.counts)[:ng].astype(np.int64)]
        )
        # Keyless (global) aggregates merge as ONE group: an empty-row
        # u32 matrix must still carry the column count.
        u = (
            _u32_keys(keys_all)
            if nk
            else np.zeros((0, counts_all.shape[0]), np.uint32)
        )
        _, idx, inv = np.unique(
            u, axis=1, return_index=True, return_inverse=True
        )
        inv = inv.reshape(-1)
        m = idx.shape[0]
        new_counts = np.zeros(m, np.int64)
        np.add.at(new_counts, inv, counts_all)
        new_keys = [k[idx] for k in keys_all]
        for i in range(nv):
            s_all = np.concatenate(
                [acc_sums[i],
                 np.asarray(part.values[i][0])[:ng].astype(np.float64)]
            )
            acc = np.zeros(m, np.float64)
            np.add.at(acc, inv, s_all)
            acc_sums[i] = acc
            mn_all = np.concatenate(
                [acc_mins[i], np.asarray(part.values[i][1])[:ng]]
            )
            mn = np.full(m, np.inf, np.float32)
            np.minimum.at(mn, inv, mn_all)
            acc_mins[i] = mn
            mx_all = np.concatenate(
                [acc_maxs[i], np.asarray(part.values[i][2])[:ng]]
            )
            mx = np.full(m, -np.inf, np.float32)
            np.maximum.at(mx, inv, mx_all)
            acc_maxs[i] = mx
        for spec in hll_specs:
            # Same [acc, chunk] concatenation order as counts_all, so
            # the main merge's ``inv`` aligns the register rows too.
            regs_chunk = np.asarray(part.dcounts[spec.key])[:ng]
            regs_all = np.concatenate([acc_hll[spec.key], regs_chunk])
            merged = np.zeros((m, HLL_M), np.uint8)
            np.maximum.at(merged, inv, regs_all)
            acc_hll[spec.key] = merged
        acc_keys, acc_counts = new_keys, new_counts

        for spec, q_cd, plan_cd in cd_runs:
            part_cd = _grouped_partials(q_cd, dt, plan_cd,
                                         mesh=chunk_mesh, final=False)
            ng_cd = int(part_cd.num_groups)
            pairs = [np.asarray(k)[:ng_cd] for k in part_cd.keys]
            prev = acc_cd[spec.key]
            both = (
                pairs
                if prev is None
                else [np.concatenate([a, c]) for a, c in zip(prev, pairs)]
            )
            _, pidx = np.unique(_u32_keys(both), axis=1, return_index=True)
            acc_cd[spec.key] = [b[pidx] for b in both]

    ngroups = acc_counts.shape[0]
    if acc_keys is None:
        acc_keys = [np.zeros(0, np.float32) for _ in range(nk)]
    if ngroups == 0 and ast.group_by is None and not ast.distinct:
        # Global aggregate over zero surviving rows: one empty group, so
        # COUNT()=0 / SUM()=0 / MIN()=inf / MAX()=-inf — matching the
        # in-memory global-aggregate path.
        ngroups = 1
        acc_keys = [np.ones(1, np.float32) for _ in range(nk)]
        acc_counts = np.zeros(1, np.int64)
        acc_sums = [np.zeros(1, np.float64) for _ in range(nv)]
        acc_mins = [np.full(1, np.inf, np.float32) for _ in range(nv)]
        acc_maxs = [np.full(1, -np.inf, np.float32) for _ in range(nv)]
        acc_cd = {k: None for k in acc_cd}
        acc_hll = {k: np.zeros((1, HLL_M), np.uint8) for k in acc_hll}

    merged_keys = tuple(acc_keys[i] for i in range(nk))
    merged_vals = tuple(
        (acc_sums[i].astype(np.float32), acc_mins[i], acc_maxs[i])
        for i in range(nv)
    )
    result = _HostGroupResult(merged_keys, acc_counts, merged_vals, ngroups)
    for spec, _q, _p in cd_runs:
        pairs = acc_cd[spec.key]
        # Group id of each distinct pair: unique over the key rows only.
        # The same chunks and WHERE produced both tables, so the group
        # sets coincide and the u32-lexicographic order matches the
        # merged ascending key order.
        if pairs is not None and len(pairs[0]):
            _, ginv = np.unique(
                _u32_keys(pairs[:nk]), axis=1, return_inverse=True
            )
            dc = np.bincount(
                ginv.reshape(-1), minlength=ngroups
            ).astype(np.float32)
        else:
            dc = np.zeros(ngroups, np.float32)
        result.dcounts[spec.key] = dc
    for spec in hll_specs:
        # Merged registers are aligned with the merged ascending group
        # order (same ``inv`` as every other partial); estimate once.
        result.dcounts[spec.key] = hll_estimate_np(acc_hll[spec.key])
    outs = _finish_grouped(
        query, select_items, plan["specs"], plan["spec_to_vidx"], result,
        plan["keys_canon"],
    )

    from ..frontend.ast import Variable
    from ..storage.strings import decode_codes

    table_out: dict = {}
    for i, (item, vals) in enumerate(zip(ast.select_list, outs)):
        if query.offset is not None:
            vals = vals[query.offset:] if query.offset < len(vals) else vals[:0]
        if query.limit is not None and query.limit < len(vals):
            vals = vals[: query.limit]
        node = unalias(item)
        if (
            isinstance(node, Variable)
            and (node.name in global_dicts or node.unqualified in global_dicts)
            and np.all(np.isfinite(vals))
        ):
            out_vals = decode_codes(
                vals,
                global_dicts.get(node.name, global_dicts.get(node.unqualified)),
            )
        else:
            out_vals = vals.tolist()
        table_out[result_column_name(item, i, table_out)] = out_vals
    return table_out


def _perrow_sort_key(vals: list, ascending: bool) -> np.ndarray:
    """One ORDER BY term's host-merge sort key: u32 ranks ascending.

    Numeric columns go through the float_sort_key bit transform (the
    exact total order the device sorts use: -0.0 ≡ +0.0, NaN above
    +inf); string columns arrive DECODED (each chunk decodes at its own
    boundary), and Python-string lexicographic order equals dictionary
    code order, so a dense rank over the strings reproduces it."""
    arr = np.asarray(vals)
    if arr.dtype.kind in "OUS":
        _, inv = np.unique(arr.astype(str), return_inverse=True)
        u = inv.reshape(-1).astype(np.uint32)
    else:
        a = arr.astype(np.float32)
        a = np.where(a == 0.0, np.float32(0.0), a)
        a = np.where(np.isnan(a), np.float32(np.nan), a)
        bits = a.view(np.uint32)
        u = np.where(bits >= 0x80000000, ~bits, bits | 0x80000000)
    if not ascending:
        u = np.iinfo(np.uint32).max - u
    return u


def _stream_perrow(
    query, csv_path, rows_per_chunk, schema, mesh, catalog_dev,
    augment=None,
) -> dict:
    """Out-of-core per-row SQL: ``SELECT exprs FROM t [JOIN dims…]
    [WHERE c] [ORDER BY o LIMIT k] [LIMIT n]``.

    Each chunk runs through the ordinary engine (all fast paths live);
    results merge on host:

    * no ORDER BY — chunks concatenate in stream order, and a LIMIT
      stops the stream as soon as enough rows survive (the reference
      streamed blindly to EOF, warpdb.cpp:580-587);
    * ORDER BY … LIMIT k — a running top-k: every chunk ships at most
      its own top k rows (device sort + slice, O(k) transfer), and the
      host keeps the best k of the union via a stable lexsort on the
      same total order the device uses.  State is O(k), not O(N).

    ORDER BY without LIMIT is rejected: it needs an external sort of
    the whole stream — O(N) host state AND O(N) transfer, which the
    engine's transfer contract (host↔device transfers are O(result))
    deliberately refuses.
    """
    import copy as _copy

    from ..api import decode_result_column
    from ..engine.executor import (
        expand_stars_query,
        resolve_order_aliases,
        result_column_name,
        run_query_table,
    )
    from ..errors import UnsupportedError

    query = resolve_order_aliases(query)
    order = query.order_by
    limit = query.limit
    offset = query.offset or 0
    if order is not None and limit is None:
        raise UnsupportedError(
            "Streaming SQL supports ORDER BY only together with LIMIT "
            "(a full out-of-core sort would materialise the stream)"
        )
    keep = None if limit is None else limit + offset
    terms = order.terms if order is not None else ()

    if mesh is None:
        mesh = data_mesh()
    chunk_mesh = mesh if mesh.devices.size > 1 else None

    q_chunk = None
    n_vis = 0
    vis_items: list = []
    acc: list[list] = []
    total = 0
    for chunk in iter_table_chunks(csv_path, rows_per_chunk, schema):
        if augment is not None:
            # Streaming windows (pass 2): append the per-row broadcast
            # of the merged per-partition aggregates as real columns
            # before upload — the chunk then runs through the ordinary
            # engine with the window references resolving as columns.
            chunk = augment(chunk)
        if mesh.devices.size > 1:
            dt = shard_table(chunk, mesh)
        else:
            dt = DeviceTable.from_host(chunk, keep_host=False)
        if q_chunk is None:
            # First chunk fixes the schema: expand stars, then append
            # the order-key expressions as hidden select items so the
            # host merge sees the keys for every candidate row.
            q_chunk = _copy.copy(query)
            vis_items = list(
                expand_stars_query(query, dt, catalog_dev or None)
            )
            n_vis = len(vis_items)
            q_chunk.select_list = [*vis_items, *(t.expr for t in terms)]
            q_chunk.offset = None
            q_chunk.limit = keep
            acc = [[] for _ in q_chunk.select_list]
        out = run_query_table(
            q_chunk, dt, catalog_dev or None, mesh=chunk_mesh
        )
        # Decode string-valued columns against THIS chunk's vocabulary:
        # decoded strings (unlike raw per-chunk codes) compare
        # consistently across chunks, so the host top-k merge and the
        # final output are both vocabulary-independent.
        cols = [
            decode_result_column(item, vals, dt, catalog_dev or None)
            for item, vals in zip(q_chunk.select_list, out.values())
        ]
        got = len(cols[0]) if cols else 0
        for a, c in zip(acc, cols):
            a.extend(c)
        total += got
        if order is not None and keep is not None and total > keep:
            # Running top-k: stable lexsort (primary term major) on the
            # hidden keys, truncate to the best `keep` candidates.
            mats = [
                _perrow_sort_key(acc[n_vis + i], t.ascending)
                for i, t in enumerate(terms)
            ]
            perm = np.lexsort(tuple(reversed(mats)))[:keep]
            acc = [[a[j] for j in perm] for a in acc]
            total = len(perm)
        elif order is None and keep is not None and total >= keep:
            break  # LIMIT satisfied: stop reading the stream

    if q_chunk is None:
        # Empty stream: preserve output column names from the raw list.
        vis_items = list(query.select_list)
        acc = [[] for _ in vis_items]
    if order is not None and total > 0:
        mats = [
            _perrow_sort_key(acc[n_vis + i], t.ascending)
            for i, t in enumerate(terms)
        ]
        perm = np.lexsort(tuple(reversed(mats)))
        acc = [[a[j] for j in perm] for a in acc]

    table_out: dict = {}
    for i, item in enumerate(vis_items):
        vals = acc[i]
        if offset:
            vals = vals[offset:]
        if limit is not None:
            vals = vals[:limit]
        table_out[result_column_name(item, i, table_out)] = vals
    return table_out
def _streaming_windows_eligible(ast, csv_path) -> bool:
    """True when every window in the query is a mergeable
    partition-aggregate (SUM/AVG/COUNT/MIN/MAX, no ORDER BY/frame) over
    BARE streamed columns, in an ungrouped per-row query — the family
    _stream_windowed handles out-of-core."""
    from ..frontend.ast import (
        Aggregation,
        Variable,
        WindowFunction,
        unalias,
        walk,
    )

    if ast.group_by is not None or ast.distinct or ast.having is not None:
        return False
    if getattr(ast, "qualify", None) is not None:
        return False
    items = [
        *ast.select_list,
        *(t.expr for t in (ast.order_by.terms if ast.order_by else ())),
    ]
    wins = [
        n for it in items for n in walk(unalias(it))
        if isinstance(n, WindowFunction)
    ]
    if not wins:
        return False
    cols = set(table_column_names(csv_path))
    for w in wins:
        if (
            w.agg.value not in ("sum", "avg", "count", "min", "max")
            or w.order_by is not None
            or w.frame is not None
        ):
            return False
        for pk in (w.partition_by or ()):
            e = unalias(pk)
            if not isinstance(e, Variable) or (
                e.name not in cols and e.unqualified not in cols
            ):
                return False
    # Plain (non-window) aggregates cannot mix into a per-row stream.
    for it in items:
        for n in walk(unalias(it)):
            if isinstance(n, Aggregation):
                return False
    return True


def _stream_windowed(
    ast, csv_path, rows_per_chunk, mesh, schema, dims
) -> dict:
    """Out-of-core partition-aggregate windows, two streaming passes
    (VERDICT r4 #6; legal out-of-core — state is O(partitions)):

    1. one streaming GROUP BY per distinct PARTITION BY signature
       computes the merged per-partition aggregates (the same chunk
       partials the grouped path merges — AVG rides as SUM+COUNT);
    2. the per-row stream re-reads the chunks, broadcasting each row's
       partition aggregate from the merged table (vectorized host
       lookup on the chunk's key columns) as a real column, and the
       rewritten query (window → column reference) runs through the
       ordinary per-row machinery, keeping its WHERE/ORDER BY…LIMIT
       top-k behavior.

    The reference's out-of-core path was scans-only
    (/root/reference/src/warpdb.cpp:544-590)."""
    import copy as _copy

    from ..frontend.ast import (
        Aggregation,
        AggregationType,
        Alias,
        Constant,
        GroupBy,
        OrderBy,
        Variable,
        WindowFunction,
        transform,
        unalias,
    )

    # Distinct windows and their partition signatures.
    wins: dict = {}
    nodes: list = []

    def repl(n):
        if isinstance(n, WindowFunction):
            c = n.canonical()
            if c not in wins:
                wins[c] = len(nodes)
                nodes.append(n)
            return Variable(f"__winS{wins[c]}")
        return n

    q2 = _copy.copy(ast)
    q2.select_list = [transform(s, repl) for s in ast.select_list]
    if ast.order_by is not None:
        terms = [
            OrderBy(transform(t.expr, repl), t.ascending)
            for t in ast.order_by.terms
        ]
        head, *rest = terms
        q2.order_by = OrderBy(head.expr, head.ascending, tuple(rest))

    # Group windows by partition signature: one pass-1 stream each.
    groups: dict = {}
    for j, w in enumerate(nodes):
        keys = tuple(unalias(p) for p in (w.partition_by or ()))
        sig = tuple(k.canonical() for k in keys)
        groups.setdefault(sig, {"keys": keys, "wins": []})
        groups[sig]["wins"].append(j)

    merged: dict = {}
    for sig, g in groups.items():
        keys = g["keys"]
        sel: list = [
            Alias(k, f"__pk{i}") for i, k in enumerate(keys)
        ]
        for j in g["wins"]:
            w = nodes[j]
            if w.agg.value == "avg":
                sel.append(Alias(
                    Aggregation(AggregationType.SUM, w.expr),
                    f"__ws{j}",
                ))
                sel.append(Alias(
                    Aggregation(AggregationType.COUNT, Constant("1")),
                    f"__wc{j}",
                ))
            elif w.agg.value == "count":
                # COUNT(*) / COUNT(expr) OVER: per-partition row count
                # (matching the in-memory window kernels, which count
                # partition rows).
                sel.append(Alias(
                    Aggregation(AggregationType.COUNT, Constant("1")),
                    f"__wv{j}",
                ))
            else:
                agg = {
                    "sum": AggregationType.SUM,
                    "min": AggregationType.MIN,
                    "max": AggregationType.MAX,
                }[w.agg.value]
                sel.append(Alias(Aggregation(agg, w.expr), f"__wv{j}"))
        q_agg = _copy.copy(ast)
        q_agg.select_list = sel
        q_agg.order_by = None
        q_agg.limit = None
        q_agg.offset = None
        q_agg.group_by = GroupBy(
            tuple(keys) if keys else (Constant("1"),)
        )
        out = run_streaming_sql(
            csv_path, "", rows_per_chunk, mesh, schema, dims,
            _ast=q_agg,
        )
        key_arrays = [
            np.asarray(out[f"__pk{i}"]) for i in range(len(keys))
        ]
        vals: dict = {}
        for j in g["wins"]:
            w = nodes[j]
            if w.agg.value == "avg":
                s = np.asarray(out[f"__ws{j}"], np.float64)
                c = np.asarray(out[f"__wc{j}"], np.float64)
                vals[j] = s / np.maximum(c, 1.0)
            else:
                vals[j] = np.asarray(out[f"__wv{j}"], np.float64)
        merged[sig] = {
            "key_names": [k.unqualified for k in keys],
            "keys": key_arrays,
            "vals": vals,
        }

    def _codes(col_m, col_c):
        """Joint integer codes for one key column over merged ∪ chunk
        values (exact for strings, ints, and floats; NaNs collapse to
        one partition, matching the engine's NaN-key semantics)."""
        a = np.asarray(col_m)
        b = np.asarray(col_c)
        if a.dtype.kind in "OUS" or b.dtype.kind in "OUS":
            a = np.asarray([str(x) for x in a])
            b = np.asarray([str(x) for x in b])
            allv = np.concatenate([a, b])
            _, inv = np.unique(allv, return_inverse=True)
        else:
            allv = np.concatenate(
                [a.astype(np.float64), b.astype(np.float64)]
            )
            allv = allv + 0.0  # -0.0 ≡ +0.0 (engine key semantics)
            _, inv = np.unique(allv, return_inverse=True, equal_nan=True)
        return inv[: len(a)], inv[len(a):], int(inv.max(initial=0)) + 1

    from ..storage.table import HostTable

    def augment(chunk):
        data = {c.name: c.data for c in chunk.columns}
        n = chunk.num_rows
        for sig, g in groups.items():
            info = merged[sig]
            names = info["key_names"]
            G = len(info["keys"][0]) if info["keys"] else 1
            comb_m = np.zeros(G, np.int64)
            comb_c = np.zeros(n, np.int64)
            for km, name in zip(info["keys"], names):
                cm, cc, base = _codes(km, data[name][:n])
                comb_m = comb_m * base + cm
                comb_c = comb_c * base + cc
            order = np.argsort(comb_m, kind="stable")
            sm = comb_m[order]
            pos = np.clip(
                np.searchsorted(sm, comb_c), 0, max(G - 1, 0)
            )
            hit = sm[pos] == comb_c if G else np.zeros(n, bool)
            for j in g["wins"]:
                v = info["vals"][j]
                if len(v) == 0:
                    out = np.full(n, np.nan, np.float32)
                else:
                    out = np.where(
                        hit, v[order][pos], np.nan
                    ).astype(np.float32)
                data[f"__winS{j}"] = out
        return HostTable.from_dict(data)

    if mesh is None:
        mesh = data_mesh()
    catalog_dev: dict = {}
    if ast.joins:
        for name, ht in (dims or {}).items():
            catalog_dev[name] = (
                shard_table(ht, mesh)
                if mesh.devices.size > 1
                else DeviceTable.from_host(ht)
            )
    return _stream_perrow(
        q2, csv_path, rows_per_chunk, schema, mesh,
        catalog_dev or None, augment=augment,
    )
