"""Public engine facade — the ``WarpDB`` class.

API parity with the reference facade (warpdb.hpp:11-48): constructor with
extension-dispatch loading, ``query``, ``query_sql``, multi-device and
streaming-CSV entry points, and Arrow result export.  Names follow the
reference where the semantics match; device-topology-specific names map
as ``query_multi_gpu`` → ``query_sharded`` (the original name is kept as
an alias).
"""

from __future__ import annotations

import re
from typing import Optional, Sequence

import numpy as np

from .errors import ParseError, TokenizeError, ValidationError, WarpDBError
from .frontend import (
    parse_expression,
    parse_query,
    tokenize,
    validate_expression,
    validate_query,
)
from .storage import DataType, DeviceTable, HostTable, load_table

__all__ = ["WarpDB"]

_WHERE_SPLIT = re.compile(r"\bWHERE\b", re.IGNORECASE)


def _split_where(expr: str) -> tuple[str, Optional[str]]:
    """Split ``"<expr> WHERE <cond>"``.

    The reference splits on the first uppercase substring ``WHERE``
    (warpdb.cpp:204-213) — which would also split inside an identifier
    like ``nowhere``; we use a word boundary (documented deviation)."""
    m = _WHERE_SPLIT.search(expr)
    if m is None:
        return expr, None
    return expr[: m.start()], expr[m.end() :]


def decode_result_column(item, values: np.ndarray, table, catalog=None) -> list:
    """Decode a result column's dictionary codes back to strings when the
    select item is string-valued (bare string column, MIN/MAX of one, or
    a string scalar function); numeric columns pass through as floats.
    Shared by the facade, set-operation branches, and the streaming
    per-row path (each chunk decodes against its own table)."""
    from .frontend.ast import (
        Aggregation,
        AggregationType,
        CodeMap,
        FunctionCall,
        Variable,
        unalias,
    )
    from .storage.strings import decode_codes

    node = unalias(item)
    # MIN/MAX of a string column: the lexicographic extreme's code.
    if isinstance(node, Aggregation) and node.agg in (
        AggregationType.MIN,
        AggregationType.MAX,
    ):
        node = node.expr
    if isinstance(node, FunctionCall):
        # String scalar function (UPPER/SUBSTR/CONCAT/…): rebind to
        # recover its output vocabulary (the transform is
        # deterministic per (function, args, source vocabulary)) and
        # decode the result codes through it.
        from .engine.executor import bind_strings
        from .errors import WarpDBError
        from .storage.strfuncs import is_string_func

        if is_string_func(node.name):
            try:
                cm = bind_strings(node, table)
            except WarpDBError:
                cm = None
            if isinstance(cm, CodeMap) and cm.out_vocab is not None:
                vals_arr = np.asarray(values, np.float64)
                if not np.all(np.isfinite(vals_arr)):
                    vals_arr = np.where(
                        np.isfinite(vals_arr), vals_arr, -1.0
                    )
                return decode_codes(vals_arr, cm.out_vocab)
    if isinstance(node, Variable):
        vals_arr = np.asarray(values)
        if vals_arr.dtype.kind == "f" and not np.all(
            np.isfinite(vals_arr)
        ):
            # Empty-aggregate sentinels (±inf) have no string form.
            return vals_arr.tolist()
        vocab = table.dicts.get(node.name)
        if vocab is None:
            vocab = table.dicts.get(node.unqualified)
        if vocab is None and node.qualifier is not None:
            t = (catalog or {}).get(node.qualifier)
            if t is not None:
                vocab = t.dicts.get(node.unqualified)
        if vocab is not None:
            return decode_codes(np.asarray(values), vocab)
    return np.asarray(values).tolist()


class Catalog(dict):
    """Relation-name catalog: name -> DeviceTable.

    ``strict`` starts False (reference demo semantics: any FROM name
    resolves to the primary table, warpdb.hpp:22-23) and flips True the
    moment the user registers a table — from then on an unknown
    FROM/JOIN/subquery relation raises ``Unknown table: X`` instead of
    silently executing against the wrong relation."""

    strict = False


class WarpDB:
    """A columnar table loaded onto the device, queryable with expressions or SQL.

    The primary (constructor) table is registered under its own name
    (the file stem, or "table" for in-memory sources) and under the
    reserved alias ``t`` — so ``FROM t`` always means the primary
    relation, even after other tables are registered.

    Example::

        db = WarpDB("data/test.csv")
        db.query("price * quantity WHERE price > 10")
        db.query_sql("SELECT SUM(price) FROM test GROUP BY quantity")
    """

    def __init__(
        self,
        filepath_or_table,
        schema: Optional[Sequence[DataType]] = None,
        sharding=None,
        mesh=None,
    ):
        if isinstance(filepath_or_table, HostTable):
            self._host = filepath_or_table
            self._name = "table"
        elif type(filepath_or_table).__module__.startswith("pyarrow"):
            # pyarrow.Table / RecordBatch accepted directly.
            from .storage.arrow import host_table_from_arrow

            self._host = host_table_from_arrow(filepath_or_table)
            self._name = "table"
        else:
            self._host = load_table(str(filepath_or_table), schema)
            base = str(filepath_or_table).rsplit("/", 1)[-1]
            self._name = base.rsplit(".", 1)[0] or "table"
        self._mesh = mesh
        if mesh is not None and sharding is None:
            from .parallel.sharded import shard_table

            self._table = shard_table(self._host, mesh)
        else:
            self._table = DeviceTable.from_host(self._host, sharding=sharding)
        self._catalog: Catalog = Catalog(
            {self._name: self._table, "t": self._table}
        )

    @classmethod
    def from_device_table(
        cls, table: DeviceTable, mesh=None, name: str = "table"
    ) -> "WarpDB":
        """Wrap an already-assembled (possibly globally-sharded)
        DeviceTable — the multi-host entry point: each process builds the
        global table via ``parallel.multihost.make_global_table`` and
        queries it through the normal SQL surface."""
        db = cls.__new__(cls)
        db._host = table.host
        db._name = name
        db._mesh = mesh
        db._table = table
        db._catalog = Catalog({name: table, "t": table})
        return db

    def distribute(self, mesh=None) -> "WarpDB":
        """Re-lay the table row-sharded over ``mesh`` (all local devices by
        default); subsequent queries execute distributed.  The mesh
        successor of the reference's per-device upload loop
        (multi_gpu_utils.cpp:27-60)."""
        from .parallel.mesh import data_mesh
        from .parallel.sharded import shard_table

        self._mesh = mesh if mesh is not None else data_mesh()
        self._table = shard_table(self._host, self._mesh)
        self._catalog[self._name] = self._table
        if self._catalog.get("t") is not None:
            self._catalog["t"] = self._table
        return self

    # -- introspection -----------------------------------------------------
    @property
    def num_rows(self) -> int:
        return self._table.num_rows

    @property
    def column_names(self) -> list[str]:
        return list(self._table.dtypes.keys())

    @property
    def table(self) -> DeviceTable:
        return self._table

    @property
    def table_name(self) -> str:
        """The FROM name of the base relation (file stem or "table")."""
        return self._name

    @property
    def stats(self) -> dict:
        return self._table.stats

    def register_table(self, name: str, source, schema=None) -> None:
        """Register an additional table for JOINs (exceeds the reference,
        which resolved every JOIN to the same table, warpdb.hpp:22-23).

        Registering any table turns strict relation resolution on:
        unknown FROM/JOIN/subquery names raise ``Unknown table: X``
        from then on (the primary stays reachable via its own name and
        the reserved ``t`` alias)."""
        if isinstance(source, DeviceTable):
            self._catalog[name] = source
        elif isinstance(source, HostTable):
            self._catalog[name] = DeviceTable.from_host(source)
        else:
            self._catalog[name] = DeviceTable.from_host(
                load_table(str(source), schema)
            )
        self._catalog.strict = True

    # -- expression path (reference WarpDB::query, warpdb.cpp:199-256) ------
    def _parse_expr_query(self, expr: str):
        if not expr or not expr.strip():
            raise WarpDBError("Empty query expression")
        expr_part, where_part = _split_where(expr)
        try:
            expr_ast = parse_expression(tokenize(expr_part))
        except (ParseError, TokenizeError) as e:
            raise ParseError(f"Failed to parse expression: {e}") from None

        cols = set(self._table.dtypes.keys())
        validate_expression(expr_ast, cols, {self._name})

        cond_ast = None
        if where_part is not None and where_part.strip():
            try:
                cond_ast = parse_expression(tokenize(where_part))
            except (ParseError, TokenizeError) as e:
                raise ParseError(f"Failed to parse WHERE clause: {e}") from None
            validate_expression(cond_ast, cols, {self._name})
        return expr_ast, cond_ast

    def _bytes_scanned(self, *asts, table=None) -> int:
        from .frontend import column_refs

        if table is None:
            table = self._table
        names = set()
        for ast in asts:
            if ast is None:
                continue
            for ref in column_refs(ast):
                names.add(ref.name)
                names.add(ref.unqualified)
        return sum(
            arr.dtype.itemsize * arr.shape[0]
            for name, arr in table.columns.items()
            if name in names
        )

    def query(self, expr: str) -> list:
        """Evaluate ``"<expr> [WHERE <cond>]"`` → length-N list of float32.

        Rows failing the filter return 0.0 (defined, unlike the
        reference's uninitialized slots — jit.cpp:56-58)."""
        return self.query_np(expr).tolist()

    def query_np(self, expr: str) -> np.ndarray:
        """Like :meth:`query` but returns the NumPy array directly."""
        from .engine.executor import run_expression
        from .utils.metrics import timed_query

        expr_ast, cond_ast = self._parse_expr_query(expr)
        with timed_query(
            expr, "expression", self._table.num_rows,
            self._bytes_scanned(expr_ast, cond_ast),
        ) as out_rows:
            result = run_expression(self._table, expr_ast, cond_ast)
            out_rows[0] = len(result)
        return result

    def _base_table(self, ast, catalog=None):
        """The FROM relation, routed through the registered-table
        catalog.  A derived table's ``from_table`` is its ALIAS — never
        a catalog lookup.  With only the primary table registered, any
        FROM name resolves to it (the reference's demo semantics,
        warpdb.hpp:22-23); once tables are registered, an unknown name
        raises (see executor._validate_relations)."""
        if getattr(ast, "from_subquery", None) is not None:
            return self._table
        if catalog is None:
            catalog = self._catalog
        name = getattr(ast, "from_source", None) or ast.from_table
        if name not in catalog and getattr(
            catalog, "strict", len(catalog) > 2
        ):
            raise ValidationError(f"Unknown table: {name}")
        return catalog.get(name, self._table)

    def _decode_base(self, ast, base, catalog):
        """The relation result decode reads vocabularies from: the
        materialised derived table when the statement's FROM is a
        subquery (its string columns re-encode with fresh vocabularies
        the outer base knows nothing about), else the FROM relation.
        Post-execution this is a memo hit — no recompute."""
        if getattr(ast, "from_subquery", None) is None:
            return base
        from .engine.executor import _resolve_from_subquery

        _q2, derived = _resolve_from_subquery(
            ast, base, catalog, self._mesh
        )
        return derived

    def _alias_catalog(self, ast, catalog):
        """Extend a statement's catalog with relation-alias entries
        (``JOIN nation n1`` / ``FROM lineitem l1``) pointing at their
        source tables, so string decode can resolve ``n1.n_name``
        through the alias qualifier (the alias is otherwise invisible
        to the catalog and the dictionary lookup returned raw codes).
        Copy-on-write: the facade catalog itself is never mutated."""
        pairs = []
        src = getattr(ast, "from_source", None)
        if src and ast.from_table != src:
            pairs.append((ast.from_table, src))
        for j in getattr(ast, "joins", ()) or ():
            jsrc = getattr(j, "source", None)
            if jsrc and j.table != jsrc:
                pairs.append((j.table, jsrc))
        added = [
            (alias, s)
            for alias, s in pairs
            if alias not in catalog and s in catalog
        ]
        if not added:
            return catalog
        strict = getattr(catalog, "strict", len(catalog) > 2)
        out = Catalog(catalog)
        out.strict = strict
        for alias, s in added:
            out[alias] = catalog[s]
        return out

    def _resolve_ctes(self, ast, catalog=None) -> dict:
        """Materialise a statement's ``WITH`` CTEs (extension; the
        reference has no CTEs) into an extended per-statement catalog.
        Each CTE validates and runs against the catalog built so far
        (later CTEs and the main query see earlier ones as ordinary
        table names; a CTE body may carry its own nested WITH).
        Memoised per (canonical, source-uid) on this facade — CTE
        inputs are immutable DeviceTables, the same rationale as the
        join and derived-table caches."""
        if catalog is None:
            catalog = self._catalog
        ctes = getattr(ast, "ctes", ())
        if not ctes:
            return catalog
        import copy as _copy
        from collections import OrderedDict

        from .engine.executor import materialize_query_table, query_dep_key

        memo = getattr(self, "_cte_memo", None)
        if memo is None:
            memo = self._cte_memo = OrderedDict()
        strict = getattr(catalog, "strict", len(catalog) > 2)
        catalog = Catalog(catalog)
        catalog.strict = strict
        for name, q in ctes:
            inner = self._resolve_ctes(q, catalog)  # nested WITH
            if getattr(q, "ctes", None):
                q = _copy.copy(q)
                q.ctes = []
            self._validate_sql(q, catalog=inner)
            base = self._base_table(q, inner)
            from .engine.executor import result_column_name

            names: list = []
            for i, item in enumerate(q.select_list):
                names.append(result_column_name(item, i, set(names)))
            # Output names are part of the key — canonical() drops
            # aliases, and the materialised schema is alias-derived.
            mkey = (name, tuple(names)) + query_dep_key(
                q, base, inner, self._mesh
            )
            hit = memo.get(mkey)
            if hit is None:
                if getattr(q, "set_ops", None):
                    hit = self._setop_device_table(q, inner)
                else:
                    hit = materialize_query_table(q, base, inner, self._mesh)
                memo[mkey] = hit
                while len(memo) > 8:
                    memo.popitem(last=False)
            else:
                memo.move_to_end(mkey)
            catalog[name] = hit
        return catalog

    def _maybe_decode(self, item, values: np.ndarray, table=None,
                      catalog=None) -> list:
        """Decode dictionary codes back to strings when the select item is
        a bare string column (extension: the reference cannot query string
        columns at all, csv_loader.cpp:151-155).  ``table`` overrides the
        source relation (UNION branches read their own FROM table);
        ``catalog`` overrides the facade catalog (per-statement catalogs
        carry CTE and relation-alias entries the decode must see)."""
        return decode_result_column(
            item, values, self._table if table is None else table,
            self._catalog if catalog is None else catalog,
        )

    # -- SQL path (reference WarpDB::query_sql, warpdb.cpp:297-498) ----------
    def query_sql(self, sql: str) -> list:
        from .engine.executor import run_query
        from .utils.metrics import timed_query

        ddl = self._maybe_ddl(sql)
        if ddl is not None:
            return []
        try:
            ast = parse_query(tokenize(sql))
        except (ParseError, TokenizeError) as e:
            raise ParseError(f"Failed to parse SQL: {e}") from None

        catalog = self._resolve_ctes(ast)
        catalog = self._alias_catalog(ast, catalog)
        self._validate_sql(ast, catalog=catalog)
        if getattr(ast, "set_ops", None):
            with timed_query(
                sql, "sql", self._table.num_rows, 0
            ) as out_rows:
                out = self._setop_table(ast, catalog)
                first = next(iter(out.values()), [])
                out_rows[0] = len(first)
            return list(first)
        # FROM routes through the registered-table catalog (the primary
        # table is the fallback) — ``FROM <registered>`` queries that
        # table directly, matching the set-op branch semantics.
        base = self._base_table(ast, catalog)
        scanned = self._bytes_scanned(
            *ast.select_list, ast.where, ast.having,
            *(t.expr for t in (ast.order_by.terms if ast.order_by else ())),
            *(ast.group_by.keys if ast.group_by else ()),
            table=base,
        )
        if getattr(ast, "ctes", None):
            import copy as _copy

            ast = _copy.copy(ast)
            ast.ctes = []  # resolved into ``catalog`` above
        with timed_query(sql, "sql", base.num_rows, scanned) as out_rows:
            result = run_query(ast, base, catalog, mesh=self._mesh)
            out_rows[0] = len(result)
        from .engine.executor import expand_stars_query

        first = expand_stars_query(ast, base, catalog)[0]
        return self._maybe_decode(
            first, result, table=self._decode_base(ast, base, catalog),
            catalog=catalog,
        )

    def _validate_sql(self, ast, table=None, catalog=None) -> None:
        """Clause validation; derived tables validate the inner query
        against the real schema and the outer against the subquery's
        OUTPUT column names.  ``table`` overrides the FROM relation
        (UNION branches validate against their own table); ``catalog``
        is the per-statement catalog (CTEs extend it)."""
        if catalog is None:
            catalog = self._catalog
        from .engine.executor import _validate_relations

        _validate_relations(ast, catalog)
        if table is None:
            table = self._base_table(ast, catalog)
        cols = set(table.dtypes.keys())
        sub = getattr(ast, "from_subquery", None)
        if sub is not None:
            # The inner query routes its own FROM (it may read any
            # registered table, not just the outer's base relation).
            self._validate_sql(sub, catalog=catalog)
            from .engine.executor import result_column_name
            from .frontend.ast import Star, unalias

            if any(isinstance(unalias(x), Star) for x in sub.select_list):
                derived = set(cols)
            else:
                derived = set()
                for i, item in enumerate(sub.select_list):
                    derived.add(result_column_name(item, i, derived))
            cols = derived
        table_names = {self._name, ast.from_table, *catalog.keys()}
        table_names |= {j.table for j in ast.joins}
        validate_query(
            ast, cols | self._join_columns(ast, catalog), table_names
        )
        set_ops = getattr(ast, "set_ops", ())
        for i, (_op, _all_flag, branch) in enumerate(set_ops):
            # Each set-op branch validates against its OWN FROM relation.
            # The final branch carries the whole chain's trailing
            # ORDER BY/LIMIT/OFFSET — those reference OUTPUT columns and
            # are checked at execution (`_setop_table`), not here.
            if i == len(set_ops) - 1 and branch.order_by is not None:
                import copy as _copy

                branch = _copy.copy(branch)
                branch.order_by = None
            self._validate_sql(branch, catalog=catalog)

    def _join_columns(self, ast, catalog=None) -> set:
        if catalog is None:
            catalog = self._catalog
        out: set = set()
        for j in ast.joins:
            t = catalog.get(j.source or j.table)
            if t is None and j.source is not None:
                t = catalog.get(j.table)
            if t is not None:
                out |= set(t.dtypes.keys())
                out |= {f"{j.table}.{c}" for c in t.dtypes.keys()}
            else:
                out |= {f"{j.table}.{c}" for c in self._table.dtypes.keys()}
        return out

    def explain(self, query: str, analyze: bool = False) -> str:
        """Physical-plan description (observability beyond the
        reference; SURVEY.md §5).  Accepts either a SQL statement or a
        ``"<expr> [WHERE cond]"`` expression.

        ``analyze=True`` EXECUTES the query and appends the measured
        profile: wall-clock, rows/s, and the per-operator kernel trace
        with compile-cache hit/miss per dispatch (EXPLAIN ANALYZE)."""
        from .engine.explain import explain_expression, explain_query

        if query.strip().upper().startswith(("SELECT", "WITH")):
            try:
                ast = parse_query(tokenize(query))
            except (ParseError, TokenizeError) as e:
                raise ParseError(f"Failed to parse SQL: {e}") from None
            catalog = self._resolve_ctes(ast)
            self._validate_sql(ast, catalog=catalog)
            plan = explain_query(
                ast, self._base_table(ast, catalog), catalog, mesh=self._mesh
            )
            if getattr(ast, "ctes", None):
                names = ", ".join(n for n, _q in ast.ctes)
                plan += (
                    f"\n  ctes: {names} (materialised once per "
                    "statement; memoised on immutable inputs)"
                )
            if getattr(ast, "set_ops", None):
                ops = " ".join(op for op, _a, _b in ast.set_ops)
                plan += (
                    f"\n  set-ops: {len(ast.set_ops) + 1} branches "
                    f"({ops}; plan above is the first; host-side "
                    "O(result) merge; INTERSECT binds tighter)"
                )
            if analyze:
                plan += "\n" + self._analyze(lambda: self.query_sql(query))
            return plan
        expr_ast, cond_ast = self._parse_expr_query(query)
        plan = explain_expression(self._table, expr_ast, cond_ast)
        if analyze:
            plan += "\n" + self._analyze(lambda: self.query(query))
        return plan

    def _analyze(self, run) -> str:
        """Execute ``run`` and render the recorded metrics as the
        EXPLAIN ANALYZE trailer."""
        from .utils.metrics import last

        result = run()
        m = last()
        lines = ["Execution (measured):"]
        if m is None:
            lines.append(f"  rows returned: {len(result)}")
            return "\n".join(lines)
        lines.append(
            f"  wall: {m.wall_s * 1e3:.2f} ms  "
            f"({m.rows_per_s / 1e6:.1f} M rows/s, {m.gb_per_s:.2f} GB/s)"
        )
        lines.append(
            f"  rows: {m.rows} scanned -> {m.output_rows} returned"
        )
        if m.operators:
            ops = ", ".join(
                f"{name}{'' if hit else ' [compiled]'}"
                for name, hit in m.operators
            )
            lines.append(f"  operators: {ops}")
        if m.collectives:
            cs = ", ".join(
                f"{op} {nbytes / 1024:.1f} KiB/device"
                for op, nbytes in m.collectives
            )
            lines.append(f"  collectives: {cs}")
        return "\n".join(lines)

    # -- multi-device path (reference query_multi_gpu, warpdb.cpp:508-542) --
    def query_sharded(self, expr: str, mesh=None) -> list:
        """Evaluate an expression across all local devices via a 1-D data
        mesh.  Falls back to single-device execution on one chip, like the
        reference (multi_gpu_utils.cpp:10-21)."""
        from .parallel.sharded import run_expression_sharded

        expr_ast, cond_ast = self._parse_expr_query(expr)
        return run_expression_sharded(
            self._table, expr_ast, cond_ast, mesh=mesh
        ).tolist()

    # Reference-parity alias.
    query_multi_gpu = query_sharded

    @staticmethod
    def query_streaming_csv(
        csv_path: str,
        expr: str,
        rows_per_chunk: Optional[int] = None,
        mesh=None,
    ) -> list:
        """Stream a CSV in chunks across all devices (out-of-core path;
        reference query_multi_gpu_csv, warpdb.cpp:544-590)."""
        from .parallel.streaming import run_streaming_csv

        return run_streaming_csv(csv_path, expr, rows_per_chunk, mesh=mesh).tolist()

    # Reference-parity alias.
    query_multi_gpu_csv = query_streaming_csv

    @staticmethod
    def query_streaming_sql(
        csv_path: str,
        sql: str,
        rows_per_chunk: Optional[int] = None,
        mesh=None,
        dims: Optional[dict] = None,
        schema: Optional[Sequence[DataType]] = None,
    ) -> dict:
        """Out-of-core SQL aggregation: per-chunk device aggregation with
        host-side partial merge — GROUP BY / global aggregates over CSVs
        far larger than device memory (the reference's streaming path
        could only project rows, warpdb.cpp:544-590).

        ``dims`` maps table names to in-memory :class:`HostTable`
        dimension tables; the streamed fact chunks JOIN against them
        (out-of-core star schema).  Returns ``{column: list}`` like
        :meth:`query_sql_table`."""
        from .parallel.streaming import run_streaming_sql

        return run_streaming_sql(
            csv_path, sql, rows_per_chunk, mesh=mesh, dims=dims,
            schema=schema,
        )

    # -- Arrow interchange (reference query_arrow, warpdb.cpp:500-505) -------
    def query_arrow(self, expr: str, shared_memory: bool = False):
        """Run :meth:`query` and export the result through the Arrow C
        Data Interface.  Returns ``(array_capsule, schema_capsule)``
        consumable by ``pyarrow.Array._import_from_c`` — same contract as
        the reference binding (pywarpdb.cpp:18-37).  With
        ``shared_memory=True`` the buffer lives in POSIX shm
        (``/warpdb_result``) for cross-process sharing."""
        from .interchange.arrow_export import export_to_arrow_capsules

        values = self.query_np(expr)
        return export_to_arrow_capsules(values, use_shared_memory=shared_memory)

    def query_arrow_table(self, sql: str):
        """Run :meth:`query_sql_table` and export every result column as
        one Arrow **struct array** through the C Data Interface —
        ``(array_capsule, schema_capsule)`` for
        ``pa.Array._import_from_c`` / ``pa.RecordBatch.from_struct_array``.
        Exceeds the reference (single-f32-vector export)."""
        from .engine.executor import expand_stars_query
        from .frontend.ast import Variable, unalias
        from .interchange.arrow_export import export_table_to_arrow_capsules

        out = self.query_sql_table(sql)
        # Column type comes from the schema (select item → string column),
        # not from value inspection — an empty string column must still
        # export as utf8.
        try:
            ast = parse_query(tokenize(sql))
            items = expand_stars_query(ast, self._table, self._catalog)
        except (ParseError, TokenizeError):
            items = [None] * len(out)

        def is_string_item(item) -> bool:
            node = unalias(item) if item is not None else None
            if not isinstance(node, Variable):
                return False
            if node.name in self._table.dicts or (
                node.unqualified in self._table.dicts
            ):
                return True
            if node.qualifier is not None:
                t = self._catalog.get(node.qualifier)
                return t is not None and node.unqualified in t.dicts
            return False

        columns = {}
        for item, (name, vals) in zip(items, out.items()):
            if is_string_item(item):
                columns[name] = [str(v) for v in vals]
            else:
                columns[name] = np.asarray(vals, dtype=np.float32)
        return export_table_to_arrow_capsules(columns)

    def query_record_batch(self, sql: str):
        """Convenience: result of :meth:`query_arrow_table` as a
        ``pyarrow.RecordBatch``."""
        import pyarrow as pa

        arr_c, schema_c = self.query_arrow_table(sql)
        struct = pa.Array._import_from_c(
            _capsule_address(arr_c), _capsule_address(schema_c)
        )
        return pa.RecordBatch.from_struct_array(struct)

    def query_arrow_array(self, expr: str):
        """Convenience: result as a ``pyarrow.Array`` (zero extra copy)."""
        import pyarrow as pa

        arr_capsule, schema_capsule = self.query_arrow(expr)
        return pa.Array._import_from_c(
            _capsule_address(arr_capsule), _capsule_address(schema_capsule)
        )

    def __repr__(self) -> str:
        return f"WarpDB({self._name!r}, {self._table!r})"


def _capsule_address(capsule) -> int:
    import ctypes

    ctypes.pythonapi.PyCapsule_GetName.restype = ctypes.c_char_p
    ctypes.pythonapi.PyCapsule_GetName.argtypes = [ctypes.py_object]
    ctypes.pythonapi.PyCapsule_GetPointer.restype = ctypes.c_void_p
    ctypes.pythonapi.PyCapsule_GetPointer.argtypes = [
        ctypes.py_object,
        ctypes.c_char_p,
    ]
    name = ctypes.pythonapi.PyCapsule_GetName(capsule)
    return ctypes.pythonapi.PyCapsule_GetPointer(capsule, name)


_DDL_CREATE = None  # compiled lazily in _facade_maybe_ddl
_DDL_DROP = None


def _facade_maybe_ddl(self, sql: str):
    """Handle ``CREATE TABLE|VIEW <name> AS <select>`` and
    ``DROP TABLE|VIEW [IF EXISTS] <name>`` (extension — the reference
    grammar is SELECT-only).  Device tables are immutable, so a VIEW's
    lazily-evaluated result can never diverge from its defining query —
    both spellings materialise through the full facade (CTEs, set ops,
    grouping sets, QUALIFY all work in the body) and register in the
    statement catalog for later FROM/JOIN use.  Returns ``{}`` when the
    statement was DDL, else None."""
    global _DDL_CREATE, _DDL_DROP
    import re

    if _DDL_CREATE is None:
        _DDL_CREATE = re.compile(
            r"^\s*CREATE\s+(TABLE|VIEW)\s+([A-Za-z_]\w*)\s+AS\s+(.+)$",
            re.IGNORECASE | re.DOTALL,
        )
        _DDL_DROP = re.compile(
            r"^\s*DROP\s+(TABLE|VIEW)\s+(IF\s+EXISTS\s+)?([A-Za-z_]\w*)\s*;?\s*$",
            re.IGNORECASE,
        )
    m = _DDL_CREATE.match(sql)
    if m is not None:
        name = m.group(2)
        if name == self._name:
            raise ValidationError(
                f"Cannot CREATE over the base relation: {name}"
            )
        out = self.query_sql_table(m.group(3))
        arrays = {
            col: np.asarray(
                vals,
                dtype=object
                if any(isinstance(x, str) for x in vals)
                else np.float32,
            )
            for col, vals in out.items()
        }
        self.register_table(name, HostTable.from_dict(arrays))
        return {}
    m = _DDL_DROP.match(sql)
    if m is not None:
        name = m.group(3)
        if name in self._catalog:
            del self._catalog[name]
        elif not m.group(2):
            raise ValidationError(f"Unknown table: {name}")
        return {}
    return None


WarpDB._maybe_ddl = _facade_maybe_ddl


def _facade_query_sql_table(self, sql: str) -> dict:
    """Execute a SELECT and return every select-list item as a named
    column (``{name: list[float]}``) — exceeds the reference, which
    returned only the first expression's values."""
    from .engine.executor import run_query_table
    from .errors import ParseError as _PE, TokenizeError as _TE

    ddl = self._maybe_ddl(sql)
    if ddl is not None:
        return ddl
    try:
        ast = parse_query(tokenize(sql))
    except (_PE, _TE) as e:
        raise ParseError(f"Failed to parse SQL: {e}") from None
    catalog = self._resolve_ctes(ast)
    catalog = self._alias_catalog(ast, catalog)
    self._validate_sql(ast, catalog=catalog)
    if getattr(ast, "set_ops", None):
        return self._setop_table(ast, catalog)
    from .engine.executor import expand_stars_query

    base = self._base_table(ast, catalog)
    if getattr(ast, "ctes", None):
        import copy as _copy

        ast = _copy.copy(ast)
        ast.ctes = []  # resolved into ``catalog`` above
    result = run_query_table(ast, base, catalog, mesh=self._mesh)
    select_items = expand_stars_query(ast, base, catalog)
    decode_base = self._decode_base(ast, base, catalog)
    return {
        name: self._maybe_decode(
            item, vals, table=decode_base, catalog=catalog
        )
        for item, (name, vals) in zip(select_items, result.items())
    }


def _facade_setop_table(self, ast, catalog=None) -> dict:
    """Execute a ``UNION / EXCEPT / INTERSECT [ALL]`` chain (extension;
    the reference has no set operations).  Each branch runs through the
    full engine against its own FROM relation (different tables per
    branch are fine); the decoded branch results merge HOST-side — the
    merge is O(result), which is the transfer-cost contract every
    result path keeps.

    Semantics (standard SQL): INTERSECT binds tighter than
    UNION/EXCEPT, which chain left-to-right.  Distinct variants dedup
    (first occurrence wins; NaNs compare equal for dedup, as SQL treats
    NULL duplicates); ALL variants use bag semantics (EXCEPT ALL
    subtracts multiplicities, INTERSECT ALL keeps the minimum).  The
    final branch's ORDER BY/LIMIT/OFFSET apply to the whole result;
    ORDER BY must reference output columns (NaNs sort last ascending,
    matching the engine's total order)."""
    import copy as _copy
    from collections import Counter

    from .engine.executor import expand_stars_query, run_query_table
    from .errors import UnsupportedError, ValidationError

    if catalog is None:
        catalog = self._catalog
    branches = [("UNION", False, ast)] + list(ast.set_ops)
    parts: list[list[list]] = []
    names: Optional[list] = None
    order_by = limit = offset = None
    for i, (_op, _flag, q) in enumerate(branches):
        qq = _copy.copy(q)
        qq.set_ops = []
        qq.ctes = []  # resolved into ``catalog`` by the caller
        if i == len(branches) - 1:
            order_by, limit, offset = qq.order_by, qq.limit, qq.offset
            qq.order_by = None
            qq.limit = None
            qq.offset = None
        table = self._base_table(qq, catalog)
        res = run_query_table(qq, table, catalog, mesh=self._mesh)
        items = expand_stars_query(qq, table, catalog)
        cols = [
            self._maybe_decode(item, vals, table=table, catalog=catalog)
            for item, (_nm, vals) in zip(items, res.items())
        ]
        if names is None:
            names = list(res.keys())
        elif len(cols) != len(names):
            raise ValidationError(
                "UNION/EXCEPT/INTERSECT branches must select the same "
                "number of columns"
            )
        parts.append(cols)

    def rows_of(cols):
        if not cols:
            return []
        return list(zip(*cols))

    def dedup_key(row):
        return tuple(
            "\0nan" if isinstance(v, float) and v != v else v for v in row
        )

    def dedup(rows):
        seen = set()
        out = []
        for r in rows:
            k = dedup_key(r)
            if k not in seen:
                seen.add(k)
                out.append(r)
        return out

    def except_rows(left, right, all_flag):
        if all_flag:
            budget = Counter(dedup_key(r) for r in right)
            out = []
            for r in left:
                k = dedup_key(r)
                if budget[k] > 0:
                    budget[k] -= 1
                else:
                    out.append(r)
            return out
        drop = {dedup_key(r) for r in right}
        return [r for r in dedup(left) if dedup_key(r) not in drop]

    def intersect_rows(left, right, all_flag):
        if all_flag:
            budget = Counter(dedup_key(r) for r in right)
            out = []
            for r in left:
                k = dedup_key(r)
                if budget[k] > 0:
                    budget[k] -= 1
                    out.append(r)
            return out
        keep = {dedup_key(r) for r in right}
        return [r for r in dedup(left) if dedup_key(r) in keep]

    # INTERSECT binds tighter: fold each INTERSECT into the segment to
    # its left, then chain the UNION/EXCEPT segments left-to-right.
    segments: list[tuple[str, bool, list]] = []
    for (op, all_flag, _q), cols in zip(branches, parts):
        rows = rows_of(cols)
        if op == "INTERSECT" and segments:
            prev_op, prev_all, prev_rows = segments[-1]
            segments[-1] = (
                prev_op,
                prev_all,
                intersect_rows(prev_rows, rows, all_flag),
            )
        else:
            segments.append((op, all_flag, rows))

    acc = segments[0][2]
    for op, all_flag, rows in segments[1:]:
        if op == "EXCEPT":
            acc = except_rows(acc, rows, all_flag)
        else:
            acc = acc + rows
            if not all_flag:
                acc = dedup(acc)

    if order_by is not None:
        keys = []
        for term in order_by.terms:
            name = term.expr.canonical()
            if name.endswith("[idx]"):
                name = name[: -len("[idx]")]
            if name not in names:
                raise UnsupportedError(
                    "Set-operation ORDER BY must reference an output "
                    f"column (got {name})"
                )
            keys.append((names.index(name), term.ascending))

        def sort_key(idx):
            def k(row):
                v = row[idx]
                if isinstance(v, float) and v != v:
                    return (1, 0.0)
                return (0, v)

            return k

        for idx, asc in reversed(keys):
            acc = sorted(acc, key=sort_key(idx), reverse=not asc)

    if offset:
        acc = acc[offset:]
    if limit is not None:
        acc = acc[:limit]
    return {
        nm: [row[i] for row in acc] for i, nm in enumerate(names)
    }


def _facade_setop_device_table(self, ast, catalog=None) -> DeviceTable:
    """Land a set-operation chain's result as a DeviceTable (CTE bodies
    may be UNION/EXCEPT/INTERSECT chains).  String columns re-encode
    with a fresh vocabulary; stats are computed so downstream
    stats-gated fast paths stay live."""
    out = self._setop_table(ast, catalog)
    arrays: dict = {}
    dtypes: dict = {}
    for name, vals in out.items():
        if any(isinstance(v, str) for v in vals):
            arrays[name] = np.asarray(list(vals), dtype=object)
            dtypes[name] = DataType.STRING
        else:
            arrays[name] = np.asarray(list(vals), np.float32)
    return DeviceTable.from_host(
        HostTable.from_dict(arrays, dtypes=dtypes or None)
    )


WarpDB.query_sql_table = _facade_query_sql_table
WarpDB._setop_table = _facade_setop_table
WarpDB._setop_device_table = _facade_setop_device_table
