"""Plan executor: lowers parsed queries onto the physical operators.

This is the device-side replacement for the coherent halves of
``WarpDB::query`` / ``WarpDB::query_sql`` (warpdb.cpp:199-256, 297-498).
Each query shape compiles (once, via the plan-keyed kernel cache) into
one or two fused XLA programs:

* scalar path (``run_expression``): fused filter+projection over padded
  columns — returns a length-N float32 vector like the reference's
  ``query`` (filtered-out slots are a defined 0.0, not garbage);
* relational path (``run_query``): WHERE → (JOIN …) → GROUP BY/HAVING
  or projection → DISTINCT → ORDER BY → OFFSET/LIMIT, with all O(N)
  work on device and only the ≤G-sized aggregate table pulled to host.

Dynamic cardinalities (filter/group/join outputs) use the two-phase
static-shape protocol: a counting kernel picks a power-of-two capacity
bucket, so each query shape compiles at most O(log N) times ever.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..errors import ExecutionError, UnsupportedError, ValidationError
from ..frontend.ast import (
    Aggregation,
    AggregationType,
    Alias,
    BinaryOp,
    CaseWhen,
    CodeMap,
    Constant,
    ExistsSubquery,
    FunctionCall,
    GroupBy,
    InCodeSet,
    InSubquery,
    InValueSet,
    Join,
    LikePattern,
    Node,
    OrderBy,
    Query,
    QuantifiedComparison,
    ScalarSubquery,
    Star,
    StringLiteral,
    Variable,
    WindowFunction,
    transform,
    unalias,
    walk,
)
from ..ops.aggregate import (
    count_distinct,
    window_aggregate,
)
from ..ops.sort import sort_pairs, sort_values, top_k_values
from ..storage.table import DeviceTable
from . import udf as udf_mod
from .compiler import (
    _as_bool,
    _as_f32,
    build_evaluator,
    get_or_compile,
    schema_signature,
)

__all__ = ["run_expression", "run_query", "run_query_table"]


def _next_pow2(n: int) -> int:
    if n <= 1:
        return 1
    return 1 << (int(n - 1).bit_length())


def _cached_count(table, key, compute) -> int:
    """Memoise a counted cardinality per immutable table instance.

    Device tables never mutate, so a count that depends only on the
    table and a canonical plan fragment (match counts, distinct counts,
    group counts) is deterministic — repeated queries skip the counting
    dispatch AND the blocking host sync between the two-phase protocol's
    phases."""
    memo = getattr(table, "_count_memo", None)
    if memo is None:
        memo = table._count_memo = {}
    if key not in memo:
        memo[key] = int(compute())
    return memo[key]


def _valid_mask(cols: dict, num_rows) -> jax.Array:
    n_pad = next(iter(cols.values())).shape[0]
    return jnp.arange(n_pad, dtype=jnp.int32) < num_rows


def _broadcast(x: jax.Array, cols: dict) -> jax.Array:
    n_pad = next(iter(cols.values())).shape[0]
    return jnp.broadcast_to(x, (n_pad,))


# ---------------------------------------------------------------------------
# String-literal binding (dictionary codes)
# ---------------------------------------------------------------------------

_CMP_OPS = (">", "<", ">=", "<=", "==", "=", "!=")


def _vocab_of(node: Node, table: DeviceTable):
    if isinstance(node, Variable):
        v = table.dicts.get(node.name)
        if v is None:
            v = table.dicts.get(node.unqualified)
        return v
    if isinstance(node, CodeMap):
        return node.out_vocab
    return None


def bind_strings(node: Optional[Node], table: DeviceTable) -> Optional[Node]:
    """Rewrite string literals into dictionary-code constants against
    ``table``'s vocabularies.  A literal is only meaningful when compared
    to a string column; the sorted vocabulary makes every comparison
    operator order-correct (see storage/strings.py)."""
    if node is None:
        return None
    if isinstance(node, StringLiteral):
        raise ValidationError(
            f"String literal {node.canonical()} can only be used in a "
            "comparison with a string column"
        )
    if isinstance(node, Alias):
        return Alias(bind_strings(node.expr, table), node.name)
    if isinstance(node, BinaryOp):
        l, r = node.left, node.right
        lit = None
        if isinstance(l, StringLiteral) or isinstance(r, StringLiteral):
            from ..storage.strings import literal_code

            if node.op not in _CMP_OPS:
                raise ValidationError(
                    "String literals only support comparison operators; "
                    f"got '{node.op}'"
                )
            lit, other = (l, r) if isinstance(l, StringLiteral) else (r, l)
            # Bind the other side first: a string FUNCTION over a coded
            # column only exposes its output vocabulary once lowered to
            # a CodeMap (UPPER(name) = 'APPLE' binds against UPPER's
            # transformed vocabulary).
            other_b = bind_strings(other, table)
            vocab = _vocab_of(other_b, table)
            if vocab is None or vocab.dtype.kind in "iu":
                # int64-coded columns carry an INT vocabulary — a string
                # literal never compares to one.
                raise ValidationError(
                    f"String literal {lit.canonical()} compared to "
                    "a non-string expression"
                )
            const = Constant(repr(literal_code(vocab, lit.text)))
            new_l = const if l is lit else other_b
            new_r = const if r is lit else other_b
            return BinaryOp(node.op, new_l, new_r)
        if node.op in _CMP_OPS:
            l, r = bind_strings(l, table), bind_strings(r, table)
            lv, rv = _vocab_of(l, table), _vocab_of(r, table)
            if lv is not None and rv is not None and lv is not rv:
                # Same-table string columns share one vocabulary (codes
                # comparable by construction); across tables the codes
                # are unrelated — only JOIN conditions translate them.
                if len(lv) != len(rv) or not np.array_equal(lv, rv):
                    raise ValidationError(
                        "Comparing string columns with different "
                        "dictionaries is only supported as a JOIN "
                        "condition"
                    )
            elif (lv is None) != (rv is None):
                # One coded side.  A wide-int64 column compared to a
                # NUMERIC CONSTANT binds the constant into code space
                # (literal_code: exact code for members, rank−0.5 for
                # non-members — order-correct for every operator, the
                # string-literal scheme applied to numbers).
                from ..storage.strings import literal_code
                from .compiler import _const_value

                v = lv if lv is not None else rv
                if v.dtype.kind in "iu":
                    cv = _const_value(r if lv is not None else l)
                    if cv is not None:
                        const = Constant(repr(literal_code(v, cv)))
                        return BinaryOp(
                            node.op,
                            l if lv is not None else const,
                            const if lv is not None else r,
                        )
                    # Any NON-constant other side would compare
                    # dictionary CODES against values — silently wrong
                    # rows.  Refuse loudly (the "widen or refuse" rule).
                    raise ValidationError(
                        "Comparing an int64 column beyond the int32 "
                        "range with a non-constant expression is not "
                        "supported (its device representation is "
                        "dictionary codes); compare against literals "
                        "or JOIN on it"
                    )
                if isinstance(l, Variable) and isinstance(r, Variable):
                    raise ValidationError(
                        "Comparing a string column with a numeric column"
                    )
            return BinaryOp(node.op, l, r)  # already bound above
        lb, rb = bind_strings(l, table), bind_strings(r, table)
        if node.op not in ("&&", "||"):
            # Arithmetic over a wide-int64 column would operate on its
            # dictionary CODES, not its values — and the values exceed
            # exact f32 anyway.  Refuse loudly (the order/key operators
            # — GROUP BY, JOIN, ORDER BY, comparisons — all work).
            for side in (lb, rb):
                sv = _vocab_of(side, table)
                if sv is not None and sv.dtype.kind in "iu":
                    raise ValidationError(
                        "Arithmetic over an int64 column beyond the "
                        "int32 range is not supported (its values "
                        "exceed the exact f32 device range); use it as "
                        "a key (GROUP BY/JOIN/ORDER BY/comparisons) or "
                        "pre-scale it at load"
                    )
        return BinaryOp(node.op, lb, rb)
    if isinstance(node, LikePattern):
        import re

        like_expr = bind_strings(node.expr, table)
        vocab = _vocab_of(like_expr, table)
        if vocab is None:
            raise ValidationError(
                "LIKE requires a string column on its left side"
            )
        flags = re.IGNORECASE if getattr(node, "ci", False) else 0
        if getattr(node, "regex", False):
            # REGEXP / RLIKE: the pattern IS a regular expression;
            # re.search semantics (unanchored), per MySQL/PostgreSQL ~.
            try:
                rx = re.compile(node.pattern, flags)
            except re.error as e:
                raise ValidationError(
                    f"Invalid REGEXP pattern {node.pattern!r}: {e}"
                ) from None
            codes = tuple(
                int(i) for i, s in enumerate(vocab) if rx.search(str(s))
            )
            return InCodeSet(like_expr, codes, len(vocab))
        # SQL LIKE wildcards: % = any sequence, _ = one character.
        # Everything else is literal — escape it so regex/glob
        # metacharacters ([, ], *, ?, .) in patterns or data match
        # literally.
        rx = re.compile(
            "".join(
                ".*" if ch == "%" else "." if ch == "_" else re.escape(ch)
                for ch in node.pattern
            ),
            flags,
        )
        codes = tuple(
            int(i) for i, s in enumerate(vocab) if rx.fullmatch(str(s))
        )
        return InCodeSet(like_expr, codes, len(vocab))
    if isinstance(node, CaseWhen):
        return CaseWhen(
            tuple(bind_strings(c, table) for c in node.conditions),
            tuple(bind_strings(v, table) for v in node.values),
            bind_strings(node.default, table),
        )
    if isinstance(node, FunctionCall):
        from ..storage.strfuncs import bind_string_func, is_string_func

        # String predicate functions (extension): STARTS_WITH /
        # ENDS_WITH / CONTAINS / REGEXP_MATCHES(s, 'lit') bind to a
        # static code set against the vocabulary — the same one-LUT
        # lowering as LIKE, usable as a WHERE predicate or a 0/1 value.
        fname = node.name.lower()
        if (
            fname in ("starts_with", "ends_with", "contains",
                      "regexp_matches")
            and len(node.args) == 2
            and isinstance(node.args[1], StringLiteral)
        ):
            sexpr = bind_strings(node.args[0], table)
            vocab = _vocab_of(sexpr, table)
            if vocab is None:
                raise ValidationError(
                    f"{node.name.upper()} requires a string column as "
                    "its first argument"
                )
            pat = node.args[1].text
            if fname == "regexp_matches":
                import re

                try:
                    rx = re.compile(pat)
                except re.error as e:
                    raise ValidationError(
                        f"Invalid REGEXP pattern {pat!r}: {e}"
                    ) from None
                pred = lambda s: rx.search(s) is not None  # noqa: E731
            elif fname == "starts_with":
                pred = lambda s: s.startswith(pat)  # noqa: E731
            elif fname == "ends_with":
                pred = lambda s: s.endswith(pat)  # noqa: E731
            else:
                pred = lambda s: pat in s  # noqa: E731
            codes = tuple(
                int(i) for i, s in enumerate(vocab) if pred(str(s))
            )
            return InCodeSet(sexpr, codes, len(vocab))

        if is_string_func(node.name):
            # String-function literal args (CONCAT(name, '!'), REPLACE
            # patterns) stay literals — they are consumed host-side by
            # the vocabulary transform, never compared to codes.
            args = tuple(
                a if isinstance(a, StringLiteral) else bind_strings(a, table)
                for a in node.args
            )
            cm = bind_string_func(FunctionCall(node.name, args), table)
            if cm is not None:
                return cm
        bargs = tuple(bind_strings(a, table) for a in node.args)
        for a in bargs:
            fv = _vocab_of(a, table)
            if fv is not None and fv.dtype.kind in "iu":
                # A scalar function would operate on dictionary CODES
                # and leak them as answers (ABS(k) once returned raw
                # codes) — refuse loudly like arithmetic.
                raise ValidationError(
                    f"{node.name.upper()} over an int64 column beyond "
                    "the int32 range is not supported (its device "
                    "representation is dictionary codes); use it as a "
                    "key (GROUP BY/JOIN/ORDER BY/comparisons)"
                )
        return FunctionCall(node.name, bargs)
    if isinstance(node, Aggregation):
        be = bind_strings(node.expr, table)
        if node.agg in (
            AggregationType.SUM,
            AggregationType.AVG,
            AggregationType.MEDIAN,
            AggregationType.PERCENTILE,
            AggregationType.STRING_AGG,
        ):
            # SUM/AVG would sum codes; MEDIAN/PERCENTILE interpolate
            # between codes; STRING_AGG expects a str vocabulary —
            # all would leak dictionary codes as answers.
            av = _vocab_of(be, table)
            if av is not None and av.dtype.kind in "iu":
                raise ValidationError(
                    f"{node.agg.name} over an int64 column beyond the "
                    "int32 range is not supported (its values exceed "
                    "the exact f32 device range); COUNT/MIN/MAX/"
                    "COUNT(DISTINCT) and key usage remain exact"
                )
        return Aggregation(node.agg, be, node.param)
    if isinstance(node, WindowFunction):
        return WindowFunction(
            node.agg,
            bind_strings(node.expr, table),
            tuple(bind_strings(p, table) for p in node.partition_by),
            None
            if node.order_by is None
            else OrderBy(
                bind_strings(node.order_by.expr, table),
                node.order_by.ascending,
            ),
            node.frame,
            node.frame_type,
            node.param,
        )
    return node


def _bind_query_strings(query: Query, table: DeviceTable) -> Query:
    """Bind string literals in every clause (joins are bound separately in
    ``_materialize_join``, where both tables are known)."""
    if not table.dicts and not any(
        isinstance(n, (StringLiteral, LikePattern)) for item in [
            *query.select_list, query.where, query.having,
            *(t.expr for t in (query.order_by.terms if query.order_by else ())),
            *(query.group_by.keys if query.group_by else ()),
        ] if item is not None for n in walk(item)
    ):
        return query
    import copy as _copy

    q = _copy.copy(query)
    q.select_list = [bind_strings(s, table) for s in query.select_list]
    q.where = bind_strings(query.where, table)
    q.having = bind_strings(query.having, table)
    if query.order_by is not None:
        q.order_by = OrderBy(
            bind_strings(query.order_by.expr, table),
            query.order_by.ascending,
            tuple(
                OrderBy(bind_strings(t.expr, table), t.ascending)
                for t in query.order_by.then
            ),
        )
    if query.group_by is not None:
        q.group_by = GroupBy(
            tuple(bind_strings(k, table) for k in query.group_by.keys)
        )
    return q


# ---------------------------------------------------------------------------
# Scalar expression path (WarpDB::query semantics)
# ---------------------------------------------------------------------------


def run_expression(
    table: DeviceTable, expr: Node, cond: Optional[Node]
) -> np.ndarray:
    """Fused filter+project; returns exactly ``num_rows`` float32 values
    (filtered-out rows = 0.0, documented deviation from the reference's
    uninitialized slots, jit.cpp:56-58).

    Stats-driven pruning (the reference optimizer's intended behavior,
    optimizer.cpp:38-47): a provably-false filter skips the device
    launch entirely; a provably-true one is dropped from the kernel."""
    from .compiler import compile_filter_project
    from .optimizer import analyze_condition, fold_constants

    expr = fold_constants(bind_strings(expr, table))
    if cond is not None:
        cond = bind_strings(cond, table)
    if cond is not None:
        cond = fold_constants(cond)
        verdict = analyze_condition(cond, table.stats)
        if verdict is False:
            return np.zeros(table.num_rows, dtype=np.float32)
        if verdict is True:
            cond = None

    kernel = compile_filter_project(expr, cond, table.columns)
    out = kernel(table.columns, jnp.int32(table.num_rows))
    return np.asarray(out)[: table.num_rows]



def query_dep_key(q, base, catalog, mesh):
    """Memo-key tail capturing everything that can change a
    materialised query result: the plan canonical, the base and every
    join-table instance (tables are immutable; identity IS content),
    the UDF registry version, and the mesh width (CLAUDE.md invariant:
    anything result-changing must be in the memo key)."""
    from . import udf as udf_mod
    from .join_exec import _table_uid

    join_uids = tuple(
        (j.table, _table_uid((catalog or {}).get(j.source or j.table, base)))
        for j in q.joins
    )
    branch_uids = tuple(
        (b.from_table, _table_uid(_from_relation(b, catalog, base)))
        + tuple(
            (j.table,
             _table_uid((catalog or {}).get(j.source or j.table, base)))
            for j in b.joins
        )
        for _op, _all, b in getattr(q, "set_ops", ())
    )
    return (
        q.canonical(), _table_uid(base), join_uids, branch_uids,
        udf_mod.registry_version(),
        None if mesh is None else int(mesh.devices.size),
    )


def materialize_query_table(sub, base, catalog, mesh) -> "DeviceTable":
    """Run ``sub`` against ``base`` and land the result as a fresh
    DeviceTable (stats computed, so every stats-gated fast path stays
    live downstream).  Bare string columns decode and re-encode with a
    fresh vocabulary.  Shared by derived tables and CTEs."""
    out = run_query_table(sub, base, catalog, mesh=mesh)
    items = expand_stars_query(sub, base, catalog)
    arrays: dict = {}
    dtypes: dict = {}
    # decode_result_column owns the full string-decode policy (bare
    # column — incl. join-qualified through the catalog —, MIN/MAX of a
    # string, string scalar functions like SUBSTR); anything it decodes
    # to str re-encodes here with a fresh vocabulary.  Lazy import:
    # api.py imports this module.
    from ..api import decode_result_column
    from ..storage.table import DataType

    for item, (name, vals) in zip(items, out.items()):
        decoded = decode_result_column(
            item, np.asarray(vals, np.float32), base, catalog
        )
        if decoded and isinstance(decoded[0], str):
            arrays[name] = np.asarray(decoded, dtype=object)
            dtypes[name] = DataType.STRING
        else:
            arrays[name] = np.asarray(vals, np.float32)
    from ..storage.table import HostTable

    return DeviceTable.from_host(
        HostTable.from_dict(arrays, dtypes=dtypes or None)
    )


def _from_relation(q, catalog, default):
    """Resolve a query's FROM relation through the catalog, honouring a
    FROM alias (``FROM sales AS s`` looks up "sales", not "s")."""
    name = getattr(q, "from_source", None) or q.from_table
    return (catalog or {}).get(name, default)


def _resolve_alias_catalog(query, table, catalog):
    """Extend the catalog with this statement's relation aliases bound to
    their resolved table instances (``FROM x AS a`` / ``JOIN y AS b``) —
    downstream (join materialisation, star expansion, qualified refs,
    distribution) then works purely in alias names.  Self-joins fall out
    naturally: two aliases may name the same immutable table."""
    if query.from_source is None and not any(j.source for j in query.joins):
        return catalog
    catalog = dict(catalog or {})
    if query.from_source is not None:
        catalog[query.from_table] = table  # alias shadows any real name
    for j in query.joins:
        if j.source:
            catalog[j.table] = catalog.get(j.source, table)
    return catalog


def _validate_relations(query, catalog, outer_names=frozenset()) -> None:
    """Strict relation-name resolution: every FROM / JOIN / subquery
    relation must be a registered catalog name.

    Until the user registers a table the reference's demo semantics
    stay: any FROM name resolves to the primary table ("loads the same
    table for demonstration", warpdb.hpp:22-23).  Once a catalog is
    strict (``api.Catalog.strict``, set by register_table), that
    fallback would silently execute against the wrong relation — here
    it raises ``Unknown table: X`` instead.  Plain-dict catalogs (CTE /
    internal copies) count as strict when they hold more than the
    primary + its reserved ``t`` alias.
    """
    if catalog is None:
        return
    strict = getattr(catalog, "strict", None)
    if strict is None:
        strict = len(catalog) > 2
    if not strict:
        return
    names = set(catalog) | set(outer_names)
    local: set = set()

    def check(real_name, alias=None):
        if real_name and real_name not in names:
            raise ValidationError(f"Unknown table: {real_name}")
        if real_name:
            local.add(real_name)
        if alias:
            local.add(alias)

    if getattr(query, "from_subquery", None) is not None:
        _validate_relations(query.from_subquery, catalog, names)
        local.add(query.from_table)  # derived-table alias
    else:
        check(
            getattr(query, "from_source", None) or query.from_table,
            query.from_table,
        )
    for j in query.joins:
        if j.table.startswith(_CORR_PREFIX):
            continue  # decorrelation plumbing, not a user relation
        check(j.source or j.table, j.table)
    for _op, _all_flag, branch in getattr(query, "set_ops", ()) or ():
        _validate_relations(branch, catalog, names)
    clause_nodes = [
        *query.select_list, query.where, query.having,
        getattr(query, "qualify", None),
        *(query.group_by.keys if query.group_by else ()),
        *((t.expr for t in query.order_by.terms) if query.order_by else ()),
    ]
    for n in clause_nodes:
        if n is None:
            continue
        for x in walk(n):
            if isinstance(x, (ScalarSubquery, InSubquery, ExistsSubquery)):
                # Subqueries may name outer relations (correlation).
                _validate_relations(x.query, catalog, names | local)


def _resolve_from_subquery(query, table, catalog, mesh):
    """Materialise a derived table (``FROM (SELECT …) AS alias``): run
    the inner query through the normal table pipeline, land its columns
    as a fresh DeviceTable (stats computed, so every stats-gated fast
    path stays live on the outer query), and return the rewritten
    outer query.  Memoised per source-table instance (immutable inputs,
    same rationale as the join cache)."""
    from collections import OrderedDict

    from .join_exec import _table_uid

    sub = query.from_subquery
    memo = getattr(table, "_subq_memo", None)
    if memo is None:
        memo = table._subq_memo = OrderedDict()

    names: list = []
    for i, item in enumerate(sub.select_list):
        names.append(result_column_name(item, i, set(names)))
    base = _from_relation(sub, catalog, table)
    mkey = (tuple(names),) + query_dep_key(sub, base, catalog, mesh)
    derived = None
    hit = memo.get(mkey)
    if hit is not None:
        memo.move_to_end(mkey)
        derived = hit
    if derived is None:
        derived = materialize_query_table(sub, base, catalog, mesh)
        memo[mkey] = derived
        while len(memo) > 4:
            memo.popitem(last=False)

    import copy as _copy

    q2 = _copy.copy(query)
    q2.from_subquery = None
    return q2, derived


_IN_SUBQUERY_MAX_VALUES = 65536
_IN_SUBQUERY_MAX_STRINGS = 1024


def _resolve_expr_subqueries(query, table, catalog, mesh):
    """Resolve uncorrelated expression subqueries (extension; the
    reference has no subqueries at all) before plan lowering:

    * ``(SELECT …)`` scalar → :class:`Constant` (numeric) or
      :class:`StringLiteral` (string; binds to codes downstream).
      0 rows → NaN (the engine's missing-value marker).
    * ``expr IN (SELECT …)`` numeric → :class:`InValueSet` (deduped,
      NaN-free — IEEE ``==`` never matches NaN, matching the OR-chain
      the literal IN list would build).
    * ``expr IN (SELECT …)`` string → an OR-chain of StringLiteral
      equalities, so ``bind_strings`` binds them against whatever table
      (including a joined one) the expression lands on.

    The resolved values participate in ``canonical()`` and therefore in
    every kernel/plan cache key."""
    clause_nodes = [
        *query.select_list, query.where, query.having,
        *(query.group_by.keys if query.group_by else ()),
        *(
            (t.expr for t in query.order_by.terms)
            if query.order_by
            else ()
        ),
    ]
    if not any(
        n is not None
        and any(
            isinstance(
                x,
                (ScalarSubquery, InSubquery, ExistsSubquery,
                 QuantifiedComparison),
            )
            for x in walk(n)
        )
        for n in clause_nodes
    ):
        return query

    def exec_sub(q):
        base = _from_relation(q, catalog, table)
        out = run_query_table(q, base, catalog, mesh=mesh)
        if len(out) != 1:
            raise ValidationError(
                "Subquery used as a value must select exactly one column"
            )
        ((_name, vals),) = out.items()
        vals = np.asarray(vals)
        node = unalias(q.select_list[0]) if q.select_list else None
        if isinstance(node, Aggregation) and node.agg in (
            AggregationType.MIN, AggregationType.MAX,
        ):
            node = node.expr
        vocab = None
        if isinstance(node, Variable) and q.from_subquery is None:
            vocab = base.dicts.get(node.name)
            if vocab is None:
                vocab = base.dicts.get(node.unqualified)
            if vocab is None and node.qualifier is not None:
                t = (catalog or {}).get(node.qualifier)
                if t is not None:
                    vocab = t.dicts.get(node.unqualified)
        if vocab is not None:
            if vals.dtype.kind == "f" and not np.all(np.isfinite(vals)):
                raise ExecutionError(
                    "String subquery produced a non-finite sentinel "
                    "(empty aggregate has no string form)"
                )
            from ..storage.strings import decode_codes

            # Wide-int64 columns decode to Python ints — numeric, not
            # strings (is_str False); scalar()/in_set() preserve their
            # full precision instead of the f32 device cast.
            return (
                decode_codes(vals, vocab),
                vocab.dtype.kind not in "iu",
            )
        return vals, False

    def scalar(node: ScalarSubquery):
        vals, is_str = exec_sub(node.query)
        if len(vals) > 1:
            raise ExecutionError(
                f"Scalar subquery returned {len(vals)} rows"
            )
        if is_str:
            if len(vals) == 0:
                raise ExecutionError(
                    "Scalar string subquery returned no rows"
                )
            return StringLiteral(str(vals[0]))
        if len(vals) == 0:
            return Constant("nan")
        v0 = vals[0]
        if v0 is None:
            return Constant("nan")  # wide-int64 NULL (join-miss decode)
        if isinstance(v0, (int, np.integer)):
            # Wide-int64 scalar: keep full integer precision — the CMP
            # binding re-expresses it in code space exactly.
            return Constant(repr(int(v0)))
        return Constant(repr(float(np.float32(v0))))

    def in_set(node: InSubquery):
        expr = rw(node.expr)
        vals, is_str = exec_sub(node.query)
        if is_str:
            uniq = sorted(set(str(v) for v in vals))
            if len(uniq) > _IN_SUBQUERY_MAX_STRINGS:
                raise UnsupportedError(
                    f"IN (SELECT …) with {len(uniq)} distinct strings "
                    f"(max {_IN_SUBQUERY_MAX_STRINGS}) — use a JOIN"
                )
            if not uniq:
                return Constant("0")  # empty set: matches nothing
            out = None
            for s in uniq:
                eq = BinaryOp("==", expr, StringLiteral(s))
                out = eq if out is None else BinaryOp("||", out, eq)
            return out
        vlist = [v for v in vals if v is not None]
        if vlist and all(isinstance(v, (int, np.integer)) for v in vlist):
            # Wide-int64 subquery values: if the OUTER expression is a
            # coded wide-int column, re-express the set in ITS code
            # space via literal_code (exact for members, matches
            # nothing for non-members) — comparing raw codes against
            # f32-rounded values would corrupt membership.
            ev = _vocab_of(expr, table)
            if ev is not None and ev.dtype.kind in "iu":
                from ..storage.strings import literal_code

                arr = sorted({literal_code(ev, int(v)) for v in vlist})
                if len(arr) > _IN_SUBQUERY_MAX_VALUES:
                    raise UnsupportedError(
                        f"IN (SELECT …) with {len(arr)} distinct values "
                        f"(max {_IN_SUBQUERY_MAX_VALUES}) — use a JOIN"
                    )
                return InValueSet(expr, tuple(arr))
            # Non-coded OUTER expression: the InValueSet sweep compares
            # in f32, so keep only set values that round-trip f32 —
            # a non-round-tripping int (e.g. 2147483650) can never
            # EXACTLY equal any f32/i32 outer value, and letting it
            # round would fabricate matches (2147483650 ≈ f32
            # 2147483648 once spuriously matched an int32 2147483647).
            vlist = [
                v for v in vlist if float(np.float32(v)) == float(v)
            ]
        arr = np.unique(np.asarray(vlist, np.float32))
        arr = arr[~np.isnan(arr)]
        if arr.shape[0] > _IN_SUBQUERY_MAX_VALUES:
            raise UnsupportedError(
                f"IN (SELECT …) with {arr.shape[0]} distinct values "
                f"(max {_IN_SUBQUERY_MAX_VALUES}) — use a JOIN"
            )
        return InValueSet(expr, tuple(float(v) for v in arr))

    def exists(node: ExistsSubquery):
        q = _copy.copy(node.query)  # _copy binds before rw() runs below
        if q.limit is None or q.limit > 1:
            q.limit = 1  # existence needs at most one surviving row
        base = _from_relation(q, catalog, table)
        out = run_query_table(q, base, catalog, mesh=mesh)
        n = len(next(iter(out.values()), ()))
        return Constant("1" if n > 0 else "0")

    def quantified(node: QuantifiedComparison):
        """expr op ANY|ALL (SELECT …) → min/max bound comparison, IN /
        NOT IN, or a constant (empty set: ANY false, ALL true; NaN
        subquery elements are dropped — the engine approximates SQL's
        three-valued NULL logic with NaN-compares-false)."""
        expr = rw(node.expr)
        op = "==" if node.op == "=" else node.op
        if op == "==" and node.quantifier == "ANY":
            return in_set(InSubquery(expr, node.query))
        vals, is_str = exec_sub(node.query)
        if is_str:
            items = sorted(str(v) for v in vals)
            empty = not items
        else:
            arr = np.asarray(vals, np.float32)
            arr = arr[~np.isnan(arr)]
            empty = arr.shape[0] == 0
        if empty:
            return Constant("0" if node.quantifier == "ANY" else "1")

        def lit(v):
            if is_str:
                return StringLiteral(str(v))
            return Constant(repr(float(np.float32(v))))

        if is_str:
            lo, hi = items[0], items[-1]
            n_distinct = len(set(items))
        else:
            lo, hi = float(arr.min()), float(arr.max())
            n_distinct = int(np.unique(arr).shape[0])
        if op == "!=":
            if node.quantifier == "ALL":
                positive = in_set(InSubquery(expr, node.query))
                return BinaryOp("==", positive, Constant("0"))  # NOT IN
            if n_distinct > 1:
                return Constant("1")  # some element always differs
            return BinaryOp("!=", expr, lit(lo))
        if op == "==":  # = ALL
            if n_distinct > 1:
                return Constant("0")
            return BinaryOp("==", expr, lit(lo))
        bound = {
            (">", "ANY"): lo, (">=", "ANY"): lo,
            ("<", "ANY"): hi, ("<=", "ANY"): hi,
            (">", "ALL"): hi, (">=", "ALL"): hi,
            ("<", "ALL"): lo, ("<=", "ALL"): lo,
        }[(op, node.quantifier)]
        return BinaryOp(op, expr, lit(bound))

    def rw(node):
        if node is None:
            return None
        if isinstance(node, ScalarSubquery):
            return scalar(node)
        if isinstance(node, InSubquery):
            return in_set(node)
        if isinstance(node, ExistsSubquery):
            return exists(node)
        if isinstance(node, QuantifiedComparison):
            return quantified(node)
        if isinstance(node, Alias):
            return Alias(rw(node.expr), node.name)
        if isinstance(node, BinaryOp):
            return BinaryOp(node.op, rw(node.left), rw(node.right))
        if isinstance(node, CaseWhen):
            return CaseWhen(
                tuple(rw(c) for c in node.conditions),
                tuple(rw(v) for v in node.values),
                rw(node.default),
            )
        if isinstance(node, FunctionCall):
            return FunctionCall(node.name, tuple(rw(a) for a in node.args))
        if isinstance(node, Aggregation):
            return Aggregation(node.agg, rw(node.expr), node.param)
        if isinstance(node, WindowFunction):
            return WindowFunction(
                node.agg,
                rw(node.expr),
                tuple(rw(p) for p in node.partition_by),
                None
                if node.order_by is None
                else OrderBy(
                    rw(node.order_by.expr), node.order_by.ascending
                ),
                node.frame,
                node.frame_type,
                node.param,
            )
        if isinstance(node, (InValueSet, InCodeSet, LikePattern)):
            return type(node)(
                rw(node.expr),
                *[
                    getattr(node, f)
                    for f in ("values", "codes", "pattern", "vocab_size")
                    if hasattr(node, f)
                ],
            )
        return node

    import copy as _copy

    q2 = _copy.copy(query)
    q2.select_list = [rw(s) for s in query.select_list]
    q2.where = rw(query.where)
    q2.having = rw(query.having)
    if query.group_by is not None:
        q2.group_by = GroupBy(tuple(rw(k) for k in query.group_by.keys))
    if query.order_by is not None:
        q2.order_by = OrderBy(
            rw(query.order_by.expr),
            query.order_by.ascending,
            tuple(
                OrderBy(rw(t.expr), t.ascending)
                for t in query.order_by.then
            ),
        )
    return q2


_CORR_PREFIX = "__corr"


def _and_conjuncts(node) -> list:
    """Flatten a top-level AND chain into its conjuncts."""
    if isinstance(node, BinaryOp) and node.op == "&&":
        return _and_conjuncts(node.left) + _and_conjuncts(node.right)
    return [node]


def _and_chain(nodes: list):
    out = None
    for n in nodes:
        out = n if out is None else BinaryOp("&&", out, n)
    return out


def _decorrelate_subqueries(query, table, catalog, mesh):
    """Rewrite single-level CORRELATED expression subqueries into LEFT
    JOINs against grouped derived tables — classic decorrelation,
    static-shape form: the derived side groups on the correlation keys, so the
    added join has unique build keys and takes the probe-preserving
    lookup path (one grouped build + one column lookup instead of a
    per-outer-row rescan; rescanning would be O(N·M) and unbatchable).

    Supported forms (extension — the reference has no subqueries at
    all, expression.hpp:99-143):

    * ``[NOT] EXISTS (SELECT … FROM u WHERE u.k = t.k [AND …])`` —
      derived ``SELECT k, COUNT(*) AS __hit … GROUP BY k``; EXISTS
      becomes ``__hit IS NOT NULL`` after the LEFT join.
    * scalar ``(SELECT AGG(x) FROM u WHERE u.k = t.k [AND …])`` —
      derived ``SELECT k, AGG(x) AS __v … GROUP BY k``; COUNT-family
      aggregates coalesce to 0 on empty match sets (standard), the
      rest read NaN (the engine's missing-value marker).
    * ``e [NOT] IN (SELECT x FROM u WHERE u.k = t.k [AND …])`` — the
      inner item joins the correlation keys (e and x must be bare
      columns); membership is an extra-key EXISTS.

    Correlation predicates must be top-level AND-ed column equalities
    between the inner relation and the outer row; NaN keys never match
    (IEEE ``==``), consistent with the engine's join semantics.  Inner
    GROUP BY/HAVING/set-ops stay unsupported in the correlated case.
    """
    clause_nodes = [
        *query.select_list, query.where, query.having,
        *(query.group_by.keys if query.group_by else ()),
        *(
            (t.expr for t in query.order_by.terms)
            if query.order_by
            else ()
        ),
    ]
    sub_nodes: list = []
    seen_ids = set()
    for n in clause_nodes:
        if n is None:
            continue
        for x in walk(n):
            if isinstance(
                x, (ScalarSubquery, InSubquery, ExistsSubquery)
            ) and id(x) not in seen_ids:
                seen_ids.add(id(x))
                sub_nodes.append(x)
    if not sub_nodes:
        return query, catalog

    catalog = catalog or {}
    # Outer namespace: the FROM relation's columns plus every joined
    # relation's (qualified and free names), mirroring the joined-table
    # namespace the outer query executes in.
    outer_rels = {query.from_table} | {j.table for j in query.joins}
    outer_cols = set()
    for n in table.dtypes:
        outer_cols.add(n)
        outer_cols.add(n.rsplit(".", 1)[-1])
    for j in query.joins:
        right = catalog.get(j.table, table)
        for n in right.dtypes:
            outer_cols.add(n.rsplit(".", 1)[-1])
            outer_cols.add(f"{j.table}.{n.rsplit('.', 1)[-1]}")

    def _inner_namespace(sub: Query):
        """(relation names, addressable column names) of the subquery's
        own scope.  An unknown FROM name falls back to the outer table
        (reference behaviour), making every unqualified name inner."""
        rels = {sub.from_table} | {j.table for j in sub.joins}
        if sub.from_source:
            rels.add(sub.from_source)
        cols = set()
        base = catalog.get(sub.from_source or sub.from_table, table)
        for n in base.dtypes:
            cols.add(n)
            cols.add(n.rsplit(".", 1)[-1])
            cols.add(f"{sub.from_table}.{n.rsplit('.', 1)[-1]}")
        for j in sub.joins:
            jt = catalog.get(j.source or j.table)
            if jt is not None:
                for n in jt.dtypes:
                    cols.add(n.rsplit(".", 1)[-1])
                    cols.add(f"{j.table}.{n.rsplit('.', 1)[-1]}")
        return rels, cols

    def _is_outer(v: Variable, inner_rels, inner_cols) -> bool:
        if v.qualifier is not None:
            if v.qualifier in inner_rels:
                return False
            return v.qualifier in outer_rels
        if v.name in inner_cols:
            return False  # inner scope shadows outer (standard)
        return v.name in outer_cols

    def _outer_refs_in(node, inner_rels, inner_cols) -> list:
        if node is None:
            return []
        return [
            v
            for v in walk(node)
            if isinstance(v, Variable)
            and _is_outer(v, inner_rels, inner_cols)
        ]

    replacements: dict = {}
    new_joins: list = []
    derived_tables: dict = {}

    def _decorrelate_one(node) -> None:
        sub = node.query
        inner_rels, inner_cols = _inner_namespace(sub)
        non_where = [
            *sub.select_list, sub.having,
            *(sub.group_by.keys if sub.group_by else ()),
            *(
                (t.expr for t in sub.order_by.terms)
                if sub.order_by
                else ()
            ),
        ]
        where_refs = _outer_refs_in(sub.where, inner_rels, inner_cols)
        other_refs = [
            r
            for n in non_where
            for r in _outer_refs_in(n, inner_rels, inner_cols)
        ]
        if not where_refs and not other_refs:
            return  # uncorrelated: the constant-folding resolver owns it
        if other_refs:
            raise UnsupportedError(
                "Correlated subqueries may reference outer columns only "
                "in WHERE equality predicates (got outer reference "
                f"{other_refs[0].name} elsewhere)"
            )
        if sub.group_by is not None or sub.having is not None or getattr(
            sub, "set_ops", None
        ) or getattr(sub, "ctes", None):
            raise UnsupportedError(
                "Correlated subqueries do not support their own "
                "GROUP BY/HAVING/set operations"
            )

        pairs: list = []  # (inner Variable, outer Variable)
        neq_pairs: list = []  # (inner Variable, outer Variable) for <>
        residual: list = []
        for c in _and_conjuncts(sub.where):
            refs = _outer_refs_in(c, inner_rels, inner_cols)
            if not refs:
                residual.append(c)
                continue
            two_cols = (
                isinstance(c, BinaryOp)
                and isinstance(c.left, Variable)
                and isinstance(c.right, Variable)
            )
            ok = two_cols and c.op in ("=", "==", "!=")
            if ok:
                lo = _is_outer(c.left, inner_rels, inner_cols)
                ro = _is_outer(c.right, inner_rels, inner_cols)
                ok = lo != ro
            # One inner.col <> outer.col conjunct is allowed for EXISTS
            # (TPC-H q21's "another supplier on the same order"): it
            # decorrelates through per-group MIN/MAX of the inner column
            # (∃ row ≠ v  ⟺  count > 0 ∧ ¬(min = v ∧ max = v)).  Two
            # such conjuncts would need a row satisfying BOTH at once,
            # which min/max marginals cannot witness — rejected.
            if ok and c.op == "!=":
                if not isinstance(node, ExistsSubquery) or neq_pairs:
                    raise UnsupportedError(
                        "Correlated <> predicates are supported only in "
                        "EXISTS subqueries, at most one per subquery; "
                        f"got: {c.canonical()}"
                    )
                inner_v, outer_v = (
                    (c.right, c.left) if lo else (c.left, c.right)
                )
                neq_pairs.append((inner_v, outer_v))
                continue
            if not ok:
                raise UnsupportedError(
                    "Correlated subquery predicates must be column "
                    f"equalities (inner.col = outer.col); got: "
                    f"{c.canonical()}"
                )
            inner_v, outer_v = (
                (c.right, c.left) if lo else (c.left, c.right)
            )
            pairs.append((inner_v, outer_v))
        if neq_pairs and not pairs:
            raise UnsupportedError(
                "Correlated EXISTS with a <> predicate needs at least "
                "one equality correlation key alongside it"
            )

        name = f"{_CORR_PREFIX}{len(new_joins)}"
        if isinstance(node, InSubquery):
            if not isinstance(unalias(node.expr), Variable):
                raise UnsupportedError(
                    "Correlated IN requires a bare column on the left "
                    "of IN"
                )
            if len(sub.select_list) != 1 or not isinstance(
                unalias(sub.select_list[0]), Variable
            ):
                raise UnsupportedError(
                    "Correlated IN (SELECT …) must select a single bare "
                    "column"
                )
            pairs.append(
                (unalias(sub.select_list[0]), unalias(node.expr))
            )

        import copy as _copy

        dq = _copy.copy(sub)
        dq.where = _and_chain(residual)
        dq.select_list = [
            Alias(iv, f"__k{j}") for j, (iv, _ov) in enumerate(pairs)
        ]
        dq.group_by = GroupBy(tuple(iv for iv, _ov in pairs))
        dq.order_by = None
        dq.limit = None
        dq.offset = None
        dq.distinct = False
        if isinstance(node, ScalarSubquery):
            if len(sub.select_list) != 1:
                raise ValidationError(
                    "Subquery used as a value must select exactly one "
                    "column"
                )
            sel = unalias(sub.select_list[0])
            # The value may be any expression OVER aggregates (TPC-H
            # q17/q20: ``0.2 * AVG(l_quantity)``): each distinct
            # aggregate becomes a derived column and the surrounding
            # expression re-binds to them after the LEFT join.  Dedupe
            # by canonical so one aggregate used twice computes once.
            aggs: dict = {}
            for x in walk(sel):
                if isinstance(x, Aggregation):
                    aggs.setdefault(x.canonical(), x)
            if not aggs:
                raise UnsupportedError(
                    "Correlated scalar subqueries must select a single "
                    "aggregate (e.g. (SELECT MAX(x) FROM …)); bare "
                    "columns are ambiguous per outer row"
                )

            def _vars_outside_aggs(n) -> list:
                if isinstance(n, Aggregation):
                    return []
                if isinstance(n, Variable):
                    return [n]
                out = []
                for ch in n.children():
                    out.extend(_vars_outside_aggs(ch))
                return out

            bare = _vars_outside_aggs(sel)
            if bare:
                raise UnsupportedError(
                    "Correlated scalar subqueries may reference columns "
                    "only inside aggregates (bare "
                    f"{bare[0].name} is ambiguous per outer row)"
                )
            agg_cols: dict = {}
            for j, (canon, a) in enumerate(aggs.items()):
                dq.select_list.append(Alias(a, f"__v{j}"))
                col: Node = Variable(f"{name}.__v{j}")
                if a.agg in (
                    AggregationType.COUNT, AggregationType.COUNT_DISTINCT
                ):
                    # COUNT over an empty match set is 0, not NULL.
                    col = FunctionCall("coalesce", (col, Constant("0")))
                agg_cols[canon] = col
            replacement: Node = transform(
                sel,
                lambda n: agg_cols[n.canonical()]
                if isinstance(n, Aggregation)
                else n,
            )
        else:
            dq.select_list.append(
                Alias(Aggregation(AggregationType.COUNT, Star()), "__hit")
            )
            # [NOT] EXISTS / IN → hit IS NOT NULL after the LEFT join
            # (outer NOT wrappers compose around the boolean).
            replacement = BinaryOp(
                "==",
                FunctionCall("isnan", (Variable(f"{name}.__hit"),)),
                Constant("0"),
            )
            if neq_pairs:
                # ∃ row with inner_col ≠ outer_col ⟺ the group matched
                # AND its inner_col values are not all equal to the
                # outer value: ¬(min = v ∧ max = v).
                iv, ov = neq_pairs[0]
                dq.select_list.append(
                    Alias(Aggregation(AggregationType.MIN, iv), "__nqmin")
                )
                dq.select_list.append(
                    Alias(Aggregation(AggregationType.MAX, iv), "__nqmax")
                )
                differs = BinaryOp(
                    "||",
                    BinaryOp("!=", Variable(f"{name}.__nqmin"), ov),
                    BinaryOp("!=", Variable(f"{name}.__nqmax"), ov),
                )
                replacement = BinaryOp("&&", replacement, differs)

        base = _from_relation(dq, catalog, table)
        # Memoised per source-table instance like FROM (SELECT …) —
        # repeated statements skip the derived-side grouping entirely.
        from collections import OrderedDict

        memo = getattr(base, "_subq_memo", None)
        if memo is None:
            memo = base._subq_memo = OrderedDict()
        mkey = ("decorr",) + query_dep_key(dq, base, catalog, mesh)
        derived = memo.get(mkey)
        if derived is not None:
            memo.move_to_end(mkey)
        else:
            derived = materialize_query_table(dq, base, catalog, mesh)
            memo[mkey] = derived
            while len(memo) > 4:
                memo.popitem(last=False)

        cond = _and_chain(
            [
                BinaryOp("=", ov, Variable(f"{name}.__k{j}"))
                for j, (_iv, ov) in enumerate(pairs)
            ]
        )
        derived_tables[name] = derived
        new_joins.append(Join(name, cond, "left", None))
        replacements[id(node)] = replacement

    for node in sub_nodes:
        _decorrelate_one(node)
    if not replacements:
        return query, catalog

    def rw(node):
        if node is None:
            return None
        rep = replacements.get(id(node))
        if rep is not None:
            return rep
        if isinstance(node, Alias):
            return Alias(rw(node.expr), node.name)
        if isinstance(node, BinaryOp):
            return BinaryOp(node.op, rw(node.left), rw(node.right))
        if isinstance(node, CaseWhen):
            return CaseWhen(
                tuple(rw(c) for c in node.conditions),
                tuple(rw(v) for v in node.values),
                rw(node.default),
            )
        if isinstance(node, FunctionCall):
            return FunctionCall(node.name, tuple(rw(a) for a in node.args))
        if isinstance(node, Aggregation):
            return Aggregation(node.agg, rw(node.expr), node.param)
        if isinstance(node, WindowFunction):
            return WindowFunction(
                node.agg,
                rw(node.expr),
                tuple(rw(p) for p in node.partition_by),
                None
                if node.order_by is None
                else OrderBy(
                    rw(node.order_by.expr), node.order_by.ascending
                ),
                node.frame,
                node.frame_type,
                node.param,
            )
        if isinstance(node, (InValueSet, InCodeSet, LikePattern)):
            return type(node)(
                rw(node.expr),
                *[
                    getattr(node, f)
                    for f in ("values", "codes", "pattern", "vocab_size")
                    if hasattr(node, f)
                ],
            )
        if isinstance(node, InSubquery):
            return InSubquery(rw(node.expr), node.query)
        return node

    import copy as _copy

    q2 = _copy.copy(query)
    q2.select_list = [rw(s) for s in query.select_list]
    q2.where = rw(query.where)
    q2.having = rw(query.having)
    if query.group_by is not None:
        q2.group_by = GroupBy(tuple(rw(k) for k in query.group_by.keys))
    if query.order_by is not None:
        q2.order_by = OrderBy(
            rw(query.order_by.expr),
            query.order_by.ascending,
            tuple(
                OrderBy(rw(t.expr), t.ascending)
                for t in query.order_by.then
            ),
        )
    q2.joins = list(query.joins) + new_joins
    catalog = dict(catalog)
    catalog.update(derived_tables)
    return q2, catalog


# ---------------------------------------------------------------------------
# JOIN execution lives in engine/join_exec.py (same subsystem, split for
# reviewability); names re-exported here for back-compat.
# ---------------------------------------------------------------------------

from .join_exec import (  # noqa: E402
    _equality_pairs,
    _left_fill_stats,
    _materialize_join,
    _materialize_join_distributed,
    _materialize_join_local,
    _materialize_joins,
    _lift_implicit_join_conditions,
    _pushdown_build_filters,
    _split_join_residuals,
    _pushdown_join_where,
    _resolve_column,
    _resolve_join_sides,
    _table_uid,
    _translated_right_key,
    _try_eager_join_aggregate,
)


# ---------------------------------------------------------------------------
# The relational pipeline (query_sql semantics)
# ---------------------------------------------------------------------------


def _expand_stars(select_list, table: DeviceTable, from_name=None) -> list:
    """Expand ``*`` / ``t.*`` select items to every
    (unqualified-addressable) column of ``table``.  A qualified star
    must name the FROM relation (``from_name``); join-aware qualified
    expansion lives in :func:`expand_stars_query`.  Returns the original
    list object when no expansion is needed."""
    if not any(isinstance(unalias(s), Star) for s in select_list):
        return select_list
    out: list = []
    for s in select_list:
        node = unalias(s)
        if isinstance(node, Star):
            if node.table is not None and node.table != from_name:
                raise ValidationError(f"Unknown table: {node.table}")
            out.extend(Variable(n) for n in table.dtypes if "." not in n)
        else:
            out.append(s)
    return out


def expand_stars_query(query: Query, table: DeviceTable, catalog=None) -> list:
    """Catalog-aware ``SELECT *`` expansion: covers joined tables without
    materialising the join (right-side columns appear unqualified when
    free, else qualified — mirroring the joined-table namespace)."""
    if not any(isinstance(unalias(s), Star) for s in query.select_list):
        return query.select_list
    if not query.joins:
        return _expand_stars(query.select_list, table, query.from_table)
    catalog = catalog or {}
    base_names = [n for n in table.dtypes if "." not in n]
    seen = set(base_names)
    join_names: dict = {}
    for join in query.joins:
        if join.table.startswith(_CORR_PREFIX):
            # Decorrelation joins are plumbing, not user relations —
            # ``SELECT *`` must not expose their __k/__hit/__v columns.
            continue
        right = catalog.get(join.table, table)
        lst = join_names.setdefault(join.table, [])
        for n in right.dtypes:
            if "." in n:
                continue
            if n in seen:
                lst.append(f"{join.table}.{n}")
            else:
                lst.append(n)
                seen.add(n)
    out: list = []
    for s in query.select_list:
        node = unalias(s)
        if isinstance(node, Star):
            if node.table is None:
                out.extend(Variable(n) for n in base_names)
                for lst in join_names.values():
                    out.extend(Variable(n) for n in lst)
            elif node.table == query.from_table:
                out.extend(Variable(n) for n in base_names)
            elif node.table in join_names:
                out.extend(Variable(n) for n in join_names[node.table])
            else:
                raise ValidationError(f"Unknown table: {node.table}")
        else:
            out.append(s)
    return out




def run_query(
    query: Query,
    table: DeviceTable,
    catalog: Optional[dict] = None,
    mesh=None,
) -> np.ndarray:
    """Execute a parsed SELECT against ``table`` (the FROM relation).

    JOIN table names resolve through ``catalog``; unknown names fall back
    to ``table`` itself — mirroring the reference's "loads the same table
    for demonstration" (warpdb.hpp:22-23), except the join actually runs.

    With ``mesh`` (>1 device), GROUP BY runs distributed: per-shard
    partial aggregation merged over ``all_gather`` for small key counts,
    or the hash-partitioned all-to-all shuffle for large ones.
    """
    from .optimizer import analyze_condition, fold_constants

    import copy as _copy

    if getattr(query, "set_ops", None):
        raise UnsupportedError(
            "Set operations (UNION/EXCEPT/INTERSECT) execute at the "
            "facade: use WarpDB.query_sql / query_sql_table"
        )
    if getattr(query, "ctes", None):
        raise UnsupportedError(
            "WITH (CTEs) resolve at the facade: use WarpDB.query_sql / "
            "query_sql_table"
        )
    if (
        (query.group_by is not None and query.group_by.sets is not None)
        or getattr(query, "qualify", None) is not None
        or (
            query.group_by is None
            and any(_has_nested_window(it) for it in query.select_list)
        )
    ):
        # GROUPING SETS / QUALIFY / window-expression selects produce
        # finished result tables; the table API owns them — return the
        # first column (reference single-vector contract,
        # warpdb.cpp:447-459).
        out = run_query_table(query, table, catalog, mesh=mesh)
        first = next(iter(out.values()), None)
        return np.zeros(0, np.float32) if first is None else first
    query = resolve_order_aliases(query, table.columns)
    _validate_relations(query, catalog)
    if getattr(query, "from_subquery", None) is not None:
        query, table = _resolve_from_subquery(query, table, catalog, mesh)
    catalog = _resolve_alias_catalog(query, table, catalog)
    query, catalog = _decorrelate_subqueries(query, table, catalog, mesh)
    query = _resolve_expr_subqueries(query, table, catalog, mesh)

    if any(isinstance(s, Alias) for s in query.select_list):
        query = _copy.copy(query)
        query.select_list = [unalias(s) for s in query.select_list]

    catalog = catalog or {}
    expanded = expand_stars_query(query, table, catalog)
    if expanded is not query.select_list:
        query = _copy.copy(query)
        query.select_list = expanded

    if query.joins:
        query = _lift_implicit_join_conditions(query, table, catalog)
        query = _split_join_residuals(query)
        # Build-side pushdown first: stripping single-relation conjuncts
        # can leave an all-probe WHERE the probe pushdown then takes.
        query, catalog = _pushdown_build_filters(query, table, catalog, mesh)
        query, table = _pushdown_join_where(query, table, catalog, mesh)
        if query.group_by is not None:
            rewritten = _try_eager_join_aggregate(query, table, catalog, mesh)
            if rewritten is not None:
                query, catalog = rewritten

    current = _materialize_joins(query, table, catalog, mesh=mesh)

    query = _bind_query_strings(query, current)

    if not query.select_list:
        raise ExecutionError("Empty SELECT list")

    if query.where is not None:
        query_where = fold_constants(query.where)
        verdict = analyze_condition(query_where, current.stats)
        is_global_agg = query.group_by is None and not isinstance(
            query.select_list[0], WindowFunction
        ) and any(
            isinstance(n, Aggregation) for n in walk(query.select_list[0])
        )
        if verdict is False and not is_global_agg:
            return np.zeros(0, dtype=np.float32)  # filter eliminates all rows
        import copy as _copy

        query = _copy.copy(query)
        query.where = None if verdict is True else query_where

    if query.group_by is not None:
        values = _run_grouped(query, current, mesh=mesh)
        if query.distinct:
            # DISTINCT over grouped output (SELECT DISTINCT SUM(x) …
            # GROUP BY k): dedup the O(groups) result host-side.
            values = _dedup_rows(
                [values], ordered=query.order_by is not None
            )[0]
    else:
        values = _run_projection(query, current, mesh=mesh)

    # OFFSET then LIMIT, host-side (reference warpdb.cpp:485-495).
    if query.offset is not None:
        values = values[query.offset :] if query.offset < len(values) else values[:0]
    if query.limit is not None and query.limit < len(values):
        values = values[: query.limit]
    return values
# ---------------------------------------------------------------------------
# Grouped aggregation lives in engine/group_exec.py (same subsystem,
# split for reviewability); names re-exported here for back-compat.
# ---------------------------------------------------------------------------

from .group_exec import (  # noqa: E402
    _AggSpec,
    _HostGroupResult,
    _agg_value_from_result,
    _collect_agg_specs,
    _distributed_group,
    _finish_grouped,
    _group_level_eval,
    _grouped_partials,
    _grouped_plan,
    _grouped_value_order_stat,
    _integral_key_check,
    _midrange_group_run,
    _raw_or_f32_key_fn,
    _run_grouped,
    _run_grouped_multi,
    _sorted_group,
    _try_dense_group,
)


from .compiler import raw_int_item as _raw_int_item  # noqa: E402


def _run_projection_multi(
    query: Query, table: DeviceTable, select_items: list
) -> list[np.ndarray]:
    """Non-grouped multi-item SELECT: ALL select expressions evaluate in
    one fused kernel, ride one stable sort (values carried side-by-side
    through the same comparator network) and one batched device→host
    transfer — row-aligned by construction."""
    cols = table.columns
    n_rows = jnp.int32(table.num_rows)
    where = query.where
    where_canon = where.canonical() if where is not None else ""
    order = query.order_by
    order_terms = order.terms if order is not None else ()
    items_canon = tuple(s.canonical() for s in select_items)
    order_canon = order.canonical() if order is not None else ""

    # Sorted result + LIMIT → static device-side prefix slice, so the
    # transfer is O(limit) per column, never O(N).
    limit_total = (query.limit or 0) + (query.offset or 0)
    sort_cap = 0
    if order is not None and query.limit is not None and limit_total > 0:
        sort_cap = min(table.padded_rows, _next_pow2(max(limit_total, 16)))

    # Order-preserving filtered multi-projection: two-phase compaction
    # so every column ships O(matches) (see _run_projection).
    filter_cap = 0
    if order is None and where is not None:
        ckey = ("project_count", where_canon, schema_signature(cols),
                udf_mod.registry_version())

        def build_count():
            cond_fn = build_evaluator(where)

            @jax.jit
            def kernel(cols, num_rows):
                valid = jnp.logical_and(
                    _valid_mask(cols, num_rows), _as_bool(cond_fn(cols))
                )
                return jnp.sum(valid.astype(jnp.int32))

            return kernel

        n_match = _cached_count(
            table,
            ("where_count", where.canonical(), udf_mod.registry_version()),
            lambda: jax.device_get(
                get_or_compile(ckey, build_count)(cols, n_rows)
            ),
        )
        filter_cap = min(_next_pow2(max(n_match, 16)), table.padded_rows)

    pkey = ("project_multi", items_canon, where_canon, order_canon, sort_cap,
            filter_cap, schema_signature(cols), udf_mod.registry_version())

    raw_specs = [_raw_int_item(s, table) for s in select_items]

    def build():
        sel_fns = [
            r[0] if r is not None else build_evaluator(s)
            for s, r in zip(select_items, raw_specs)
        ]
        cond_fn = build_evaluator(where) if where is not None else None
        ord_fns = []
        for t in order_terms:
            r = _raw_int_item(t.expr, table)
            ord_fns.append(
                (r[0] if r is not None else build_evaluator(t.expr),
                 t.ascending)
            )

        @jax.jit
        def kernel(cols, num_rows):
            # Bare INT columns ride raw (int32); everything else f32.
            outs = tuple(
                _broadcast(
                    f(cols) if r is not None else _as_f32(f(cols)), cols
                )
                for f, r in zip(sel_fns, raw_specs)
            )
            valid = _valid_mask(cols, num_rows)
            if cond_fn is not None:
                valid = jnp.logical_and(valid, _as_bool(cond_fn(cols)))
            count = jnp.sum(valid.astype(jnp.int32))
            if not ord_fns:
                if cond_fn is None:
                    return outs, None, count
                # Stable position-sort compaction carrying every select
                # column; slice to the counted capacity.
                n_pad = outs[0].shape[0]
                pos = jnp.arange(n_pad, dtype=jnp.uint32)
                ck = jnp.where(valid, pos, jnp.uint32(0xFFFFFFFF))
                sorted_ops = jax.lax.sort(
                    (ck, *outs), num_keys=1, is_stable=True
                )
                return (
                    tuple(o[:filter_cap] for o in sorted_ops[1:]),
                    None,
                    count,
                )
            from ..ops.sort import order_key

            keys = []
            for i, (f, asc) in enumerate(ord_fns):
                kk = _broadcast(f(cols), cols)
                if not jnp.issubdtype(kk.dtype, jnp.integer):
                    kk = _as_f32(kk)
                # order_key dispatches: int arrays key on raw int bits
                # (exact beyond 2^24), floats on the f32 total order.
                keys.append(order_key(kk, valid if i == 0 else None, asc))
            nk = len(keys)
            sorted_ops = jax.lax.sort(
                (*keys, *outs, valid.astype(jnp.int32)),
                num_keys=nk,
                is_stable=True,
            )
            outs_s = sorted_ops[nk:-1]
            if sort_cap:
                outs_s = tuple(o[:sort_cap] for o in outs_s)
            return tuple(outs_s), None, count

        return kernel

    outs, _valid, count = jax.device_get(
        get_or_compile(pkey, build)(cols, n_rows)
    )
    count = int(count)
    return [
        out[:count].astype(np.float32 if r is None else r[1])
        for out, r in zip(outs, raw_specs)
    ]


def _run_projection(query: Query, table: DeviceTable, mesh=None) -> np.ndarray:
    """Non-grouped SELECT: one fused device program covering projection,
    WHERE filtering, ORDER BY (full sort or top-k) and DISTINCT, then a
    single batched device→host transfer.

    Filtering never uses device-side scatter compaction — instead
    every downstream operator consumes the
    validity mask directly (sorts/distinct push invalid lanes to the
    back via sentinels), and the order-preserving plain-projection case
    compacts with a two-phase stable position sort so the transfer is
    O(matches), never O(N)."""
    select = query.select_list[0]
    cols = table.columns
    n_rows = jnp.int32(table.num_rows)
    where = query.where
    where_canon = where.canonical() if where is not None else ""

    if isinstance(select, WindowFunction):
        return _run_window(query, table, mesh=mesh)
    if isinstance(select, Aggregation):
        # Global aggregate without GROUP BY: one group, whole table.
        return _run_global_agg(query, table)
    if any(isinstance(n, Aggregation) for n in walk(select)):
        # Expression over aggregates (SUM(x)/COUNT(x), VARIANCE, …).
        return _run_global_agg_expr(query, table)

    order = query.order_by
    order_terms = order.terms if order is not None else ()
    single_term = len(order_terms) == 1
    select_canon = select.canonical()
    order_canon = order.canonical() if order is not None else ""
    same_expr = (
        single_term and order_terms[0].expr.canonical() == select_canon
    )
    distinct = query.distinct
    if distinct:
        return _run_distinct(query, table, select)

    # ORDER BY ... LIMIT k on the select expression itself → top-k pull
    # instead of a full sort (the reference bubble-sorted everything,
    # jit.cpp:283-307).
    limit_total = (query.limit or 0) + (query.offset or 0)
    # The value-space top-k pull cannot represent the sort paths' NaN
    # total order, so it only runs when stats PROVE the order key is
    # finite (expr_range returns a finite interval: no NaN-able division
    # / UDFs / NaN-bearing columns); otherwise the full sort handles
    # NaN placement exactly.
    from .optimizer import expr_range

    order_nan_free = bool(
        order is not None
        and single_term
        and expr_range(order_terms[0].expr, table.stats) is not None
    )
    raw_spec = _raw_int_item(select, table)
    use_topk = (
        same_expr
        and not distinct
        and order_nan_free
        and query.limit is not None
        and 0 < limit_total < table.padded_rows // 2
        # The value-space top-k pull works in f32 (±inf sentinels) —
        # raw INT selects take the exact sort path instead.
        and raw_spec is None
    )
    topk_k = _next_pow2(max(limit_total, 16)) if use_topk else 0

    if use_topk and mesh is not None and mesh.devices.size > 1:
        # Distributed two-level pull: local top-k per shard, all_gather
        # of k*n_dev candidates, tiny finish.
        from ..parallel.sharded import run_topk_sharded

        out, total = run_topk_sharded(
            select, where, table, topk_k, order.ascending, mesh
        )
        return out[: min(limit_total, total)].astype(np.float32)

    # Full-sort path with a LIMIT: the sorted result is a prefix, so the
    # kernel slices to a static power-of-two cap on device — the
    # device→host transfer stays O(limit), never O(N).
    sort_cap = 0
    if (
        order is not None
        and not use_topk
        and query.limit is not None
        and limit_total > 0
    ):
        sort_cap = min(table.padded_rows, _next_pow2(max(limit_total, 16)))

    # Order-preserving filtered projection (no ORDER BY): two-phase so
    # the device→host transfer is O(matches), not O(N), at the cost of
    # a counting pass + the stable position-sort compaction (the same
    # protocol the filtered-window path uses).
    filter_cap = 0
    if order is None and where is not None and not distinct:
        ckey = ("project_count", where_canon, schema_signature(cols),
                udf_mod.registry_version())

        def build_count():
            cond_fn = build_evaluator(where)

            @jax.jit
            def kernel(cols, num_rows):
                valid = jnp.logical_and(
                    _valid_mask(cols, num_rows), _as_bool(cond_fn(cols))
                )
                return jnp.sum(valid.astype(jnp.int32))

            return kernel

        n_match = _cached_count(
            table,
            ("where_count", where.canonical(), udf_mod.registry_version()),
            lambda: jax.device_get(
                get_or_compile(ckey, build_count)(cols, n_rows)
            ),
        )
        filter_cap = min(_next_pow2(max(n_match, 16)), table.padded_rows)

    pkey = ("project", select_canon, where_canon, order_canon, distinct,
            None if order is None else order.ascending, topk_k, sort_cap,
            filter_cap, schema_signature(cols), udf_mod.registry_version())

    def build():
        from ..ops.sort import sort_by_keys

        sel_fn = raw_spec[0] if raw_spec is not None else build_evaluator(
            select
        )
        cond_fn = build_evaluator(where) if where is not None else None
        ord_fns = None
        if order is not None and not same_expr:
            ord_fns = []
            for t in order_terms:
                r = _raw_int_item(t.expr, table)
                ord_fns.append(
                    (r[0] if r is not None else build_evaluator(t.expr),
                     t.ascending)
                )

        def _order_operand(x):
            # order_key / sort_* dispatch on dtype: raw int arrays key
            # exactly, anything else evaluates f32 as before.
            return x if jnp.issubdtype(x.dtype, jnp.integer) else _as_f32(x)

        @jax.jit
        def kernel(cols, num_rows):
            vals = _broadcast(
                sel_fn(cols) if raw_spec is not None
                else _as_f32(sel_fn(cols)),
                cols,
            )
            n_pad = vals.shape[0]
            valid = _valid_mask(cols, num_rows)
            if cond_fn is not None:
                valid = jnp.logical_and(valid, _as_bool(cond_fn(cols)))
            count = jnp.sum(valid.astype(jnp.int32))

            if order is not None:
                if ord_fns is None:
                    if topk_k:
                        out = top_k_values(vals, valid, topk_k, order.ascending)
                    else:
                        out = sort_values(vals, valid, order.ascending)
                elif single_term:
                    okeys = _order_operand(
                        _broadcast(ord_fns[0][0](cols), cols)
                    )
                    out, _ = sort_pairs(okeys, vals, valid, order.ascending)
                else:
                    keys = [
                        (_order_operand(_broadcast(f(cols), cols)), asc)
                        for f, asc in ord_fns
                    ]
                    out = sort_by_keys(keys, vals, valid)
                if sort_cap:
                    out = out[:sort_cap]
                return out, None, count
            if cond_fn is None:
                # Dense already: rows [0, num_rows) are the result.
                return vals, None, count
            # Order-preserving compaction: stable sort on original
            # position with an invalid-last key, sliced to the counted
            # capacity — the transfer is O(matches).
            pos = jnp.arange(n_pad, dtype=jnp.uint32)
            ck = jnp.where(valid, pos, jnp.uint32(0xFFFFFFFF))
            _, vals_c = jax.lax.sort((ck, vals), num_keys=1, is_stable=True)
            return vals_c[:filter_cap], None, count

        return kernel

    out, valid, count = jax.device_get(
        get_or_compile(pkey, build)(cols, n_rows)
    )
    count = int(count)

    out_dtype = np.float32 if raw_spec is None else raw_spec[1]
    if use_topk:
        return out[: min(limit_total, count)].astype(out_dtype)
    if valid is not None:
        return out[valid].astype(out_dtype)
    return out[:count].astype(out_dtype)


def _run_distinct(query: Query, table: DeviceTable, select) -> np.ndarray:
    """DISTINCT with the two-phase static-shape protocol: a counting pass
    sizes a power-of-two capacity, the second pass returns only a
    capacity-sized buffer — so the device→host transfer is O(distinct),
    not O(N) (a 33M-row DISTINCT of 32 values previously shipped the full
    padded column)."""
    cols = table.columns
    n_rows = jnp.int32(table.num_rows)
    where = query.where
    where_canon = where.canonical() if where is not None else ""
    select_canon = select.canonical()
    order = query.order_by

    # Sort-free DISTINCT: a stats-bounded integral expression is just a
    # GROUP BY on itself with COUNT-only reductions — the dense/midrange
    # ladder (scatter / one-hot histogram slot tables) returns the occupied
    # keys with no sort and an O(distinct) transfer.  LIMIT pushes down
    # when the ascending default order is what ships.
    limit_cap = None
    if query.limit is not None and (order is None or order.ascending):
        limit_cap = query.limit + (query.offset or 0)
    raw_spec = _raw_int_item(select, table)
    out_dtype = np.float32 if raw_spec is None else raw_spec[1]
    dres = _try_dense_group(
        query, table, [select], [Constant("1")], ["1.0f"], where_canon,
        need=(), limit_cap=limit_cap,
    )
    if dres is not None:
        values = np.asarray(dres.keys[0]).astype(out_dtype)
        if order is not None and not order.ascending:
            values = values[::-1].copy()
        return values

    from ..ops.aggregate import group_scatter_stage, group_sort_stage

    # Phase 1: one sort (shared with the scatter phase, like GROUP BY).
    ckey = ("distinct_sort", select_canon, where_canon,
            schema_signature(cols), udf_mod.registry_version())

    def build_sort():
        sel_fn = raw_spec[0] if raw_spec is not None else build_evaluator(
            select
        )
        cond_fn = build_evaluator(where) if where is not None else None

        @jax.jit
        def kernel(cols, num_rows):
            valid = _valid_mask(cols, num_rows)
            if cond_fn is not None:
                valid = jnp.logical_and(valid, _as_bool(cond_fn(cols)))
            vals = _broadcast(
                sel_fn(cols) if raw_spec is not None
                else _as_f32(sel_fn(cols)),
                cols,
            )
            return group_sort_stage((vals,), (), valid)

        return kernel

    keys_s, _vals_s, valid_s, seg, ng_dev = get_or_compile(
        ckey, build_sort
    )(cols, n_rows)
    n_uniq = _cached_count(
        table,
        ("distinct_ng", select_canon, where_canon,
         udf_mod.registry_version()),
        lambda: ng_dev,
    )
    capacity = min(_next_pow2(max(n_uniq, 16)), table.padded_rows)

    dkey = ("distinct_scatter", table.padded_rows, capacity)

    def build_scatter():
        @jax.jit
        def kernel(keys_s, valid_s, seg, ng):
            g = group_scatter_stage(
                tuple(keys_s), (), valid_s, seg, ng, capacity, need=()
            )
            return g.keys[0], g.num_groups

        return kernel

    uniq, n = jax.device_get(
        get_or_compile(dkey, build_scatter)(
            tuple(keys_s), valid_s, seg, ng_dev
        )
    )
    values = uniq[: int(n)]
    # Reference order: DISTINCT produces ascending (host sort+unique,
    # warpdb.cpp:463-468); ORDER BY then re-sorts — meaningful when it
    # names the same expression (having_distinct_test.cpp:9-11).
    if order is not None and not order.ascending:
        values = values[::-1].copy()
    return values.astype(out_dtype)


def _global_agg_value(agg, param, vals, valid):
    """One global aggregate, evaluated inside an already-traced kernel
    (``vals`` padded f32, ``valid`` the row mask).  Shared by the
    single-aggregate and expression-over-aggregates global paths."""
    # Counts accumulate in i32 (exact to 2^31; an f32 accumulation
    # saturates at 2^24 — ADVICE r4) and convert only for the f32 maths.
    cnt_i = jnp.sum(valid.astype(jnp.int32))
    cnt = cnt_i.astype(jnp.float32)
    if agg == "count_nullsub":
        # NULL-skipping COUNT(expr): exact row count minus the summed
        # IS-NULL indicator (``vals``); see _count_rewrite.  The
        # subtraction stays in i32 — casting cnt to f32 first would
        # round before subtracting; only the final f32 output rounds.
        nulls = jnp.sum(jnp.where(valid, vals, 0.0)).astype(jnp.int32)
        return (cnt_i - nulls).astype(jnp.float32)
    if agg is AggregationType.COUNT_DISTINCT:
        return count_distinct((vals,), valid).astype(jnp.float32)
    if agg is AggregationType.APPROX_COUNT_DISTINCT:
        from ..ops.hll import hll_estimate, hll_grouped_registers
        from ..ops.sort import float_sort_key

        # One group: the register table is (1, m) and the whole thing
        # (hash + scatter-max + estimate) fuses into this kernel.
        regs = hll_grouped_registers(
            jnp.zeros(vals.shape, jnp.int32),
            float_sort_key(vals),
            valid,
            1,
        )
        return hll_estimate(regs)[0]
    if agg in (AggregationType.MEDIAN, AggregationType.PERCENTILE):
        v = sort_values(vals, valid, ascending=True)
        c = jnp.maximum(cnt.astype(jnp.int32), 1)
        q = 0.5 if agg is AggregationType.MEDIAN else float(param)
        pos = q * (c - 1).astype(jnp.float32)
        lo_off = jnp.floor(pos).astype(jnp.int32)
        frac = pos - lo_off.astype(jnp.float32)
        lo = v[jnp.clip(lo_off, 0, v.shape[0] - 1)]
        hi = v[jnp.clip(jnp.minimum(lo_off + 1, c - 1), 0, v.shape[0] - 1)]
        return lo * (1.0 - frac) + hi * frac
    if agg is AggregationType.COUNT:
        return cnt
    if agg is AggregationType.SUM:
        return jnp.sum(jnp.where(valid, vals, 0.0))
    if agg is AggregationType.AVG:
        return jnp.sum(jnp.where(valid, vals, 0.0)) / jnp.maximum(cnt, 1.0)
    if agg is AggregationType.MIN:
        return jnp.min(jnp.where(valid, vals, jnp.inf))
    return jnp.max(jnp.where(valid, vals, -jnp.inf))


def _count_rewrite(agg, expr, table=None):
    """SQL COUNT(expr) skips NULLs.  Stats-proven non-NULL columns keep
    the plain exact row count; otherwise rewrite to
    ``cnt − SUM(IsNull(expr))`` (the "count_nullsub" pseudo-aggregate in
    ``_global_agg_value``) — exact until 2^24 NULLs, where the former
    summed not-null indicator lost exactness at 2^24 non-null ROWS
    (ADVICE r4).  Grouped queries do the same in
    group_exec._grouped_plan.  The stats decision is table-derived:
    callers must fold ``_provably_not_null`` into their kernel cache
    keys."""
    from ..frontend.ast import NotNull, Star, unalias
    from .group_exec import _provably_not_null

    if agg is AggregationType.COUNT and not isinstance(
        unalias(expr), (Star, Constant)
    ):
        if _provably_not_null(expr, table):
            return AggregationType.COUNT, expr
        return "count_nullsub", NotNull(expr, negated=True)
    return agg, expr


def _run_global_agg(query: Query, table: DeviceTable) -> np.ndarray:
    """SELECT AGG(expr) with no GROUP BY → single scalar."""
    select = query.select_list[0]
    cols = table.columns
    where = query.where
    from .group_exec import _provably_not_null

    key = ("global_agg", select.canonical(),
           where.canonical() if where else "",
           schema_signature(cols), udf_mod.registry_version(),
           # stats-derived COUNT rewrite decision (changes results when
           # the column is nullable — must be in the cache key)
           _provably_not_null(select.expr, table))

    def build():
        agg, expr = _count_rewrite(select.agg, select.expr, table)
        val_fn = build_evaluator(expr)
        cond_fn = build_evaluator(where) if where is not None else None
        param = select.param

        @jax.jit
        def kernel(cols, num_rows):
            valid = _valid_mask(cols, num_rows)
            if cond_fn is not None:
                valid = jnp.logical_and(valid, _as_bool(cond_fn(cols)))
            vals = _broadcast(_as_f32(val_fn(cols)), cols)
            return _global_agg_value(agg, param, vals, valid)

        return kernel

    out = get_or_compile(key, build)(cols, jnp.int32(table.num_rows))
    return np.asarray([float(out)], dtype=np.float32)


def _run_global_agg_expr(query: Query, table: DeviceTable) -> np.ndarray:
    """SELECT <expression over aggregates> with no GROUP BY (extension —
    e.g. ``SUM(x)/COUNT(x)`` or the VARIANCE/STDDEV rewrites): every
    distinct aggregate evaluates in ONE fused scan, then the surrounding
    arithmetic finishes host-side on the scalars (same group-level
    evaluator HAVING uses)."""
    from .group_exec import _collect_agg_specs, _group_level_eval

    select = query.select_list[0]
    specs = _collect_agg_specs([select])
    cols = table.columns
    where = query.where
    from .group_exec import _provably_not_null

    key = ("global_agg_expr", select.canonical(),
           where.canonical() if where else "",
           schema_signature(cols), udf_mod.registry_version(),
           tuple(_provably_not_null(s.expr, table) for s in specs))

    def build():
        rewritten = [_count_rewrite(s.agg, s.expr, table) for s in specs]
        val_fns = [build_evaluator(e) for _a, e in rewritten]
        cond_fn = build_evaluator(where) if where is not None else None
        agg_params = [
            (a, s.param) for (a, _e), s in zip(rewritten, specs)
        ]

        @jax.jit
        def kernel(cols, num_rows):
            valid = _valid_mask(cols, num_rows)
            if cond_fn is not None:
                valid = jnp.logical_and(valid, _as_bool(cond_fn(cols)))
            outs = []
            for (agg, param), fn in zip(agg_params, val_fns):
                vals = _broadcast(_as_f32(fn(cols)), cols)
                outs.append(_global_agg_value(agg, param, vals, valid))
            return tuple(outs)

        return kernel

    outs = jax.device_get(
        get_or_compile(key, build)(cols, jnp.int32(table.num_rows))
    )
    agg_values = {
        s.key: np.float32(o) for s, o in zip(specs, outs)
    }
    val = _group_level_eval(select, {}, agg_values)
    return np.asarray([val], dtype=np.float32).reshape(1)


def _window_flags(select: "WindowFunction") -> dict:
    """Static dispatch flags for one window node.  Validates the
    agg/ORDER-BY/frame combinations (raises UnsupportedError early, at
    plan time, never inside a trace)."""
    shift_dir = {
        AggregationType.LAG: 1,
        AggregationType.LEAD: -1,
    }.get(select.agg, 0)
    if shift_dir:
        if select.order_by is None:
            raise UnsupportedError(
                "LAG/LEAD require an ORDER BY inside OVER (...)"
            )
        shift_dir *= int(select.param or 1)
    edge_last = select.agg is AggregationType.LAST_VALUE
    is_edge = edge_last or select.agg is AggregationType.FIRST_VALUE
    nth_n = 0
    if select.agg is AggregationType.NTH_VALUE:
        nth_n = int(select.param or 1)
        if select.order_by is None:
            raise UnsupportedError(
                "NTH_VALUE requires an ORDER BY inside OVER (...)"
            )
    ntile_n = 0
    if select.agg is AggregationType.NTILE:
        if not isinstance(select.expr, Constant):
            raise UnsupportedError(
                "NTILE requires a constant bucket count"
            )
        ntile_n = int(select.expr.value)
        if select.order_by is None:
            raise UnsupportedError(
                "NTILE requires an ORDER BY inside OVER (...)"
            )
    if select.frame is not None:
        fword = select.frame_type.upper()
        if select.order_by is None:
            raise UnsupportedError(
                f"A {fword} frame requires an ORDER BY inside OVER (...)"
            )
        if select.agg.value not in ("sum", "avg", "count", "min", "max"):
            raise UnsupportedError(
                f"{fword} frames support SUM/AVG/COUNT/MIN/MAX, "
                f"not {select.agg.name}"
            )
    return {
        "shift_dir": shift_dir,
        "edge_last": edge_last,
        "is_edge": is_edge,
        "nth_n": nth_n,
        "ntile_n": ntile_n,
    }


def _build_window_value_fn(select, part_exprs, dense_cfg, capacity):
    """Build the TRACEABLE ``(cols, valid) -> per-row window values``
    core for one window node — shared by the bare-window path
    (_run_window) and the fused window-expression / QUALIFY kernels
    (VERDICT r4 #5: the combining arithmetic joins the same program, so
    ONE column ships instead of one per window/referenced column)."""
    from ..ops.aggregate import (
        dense_window_aggregate,
        window_edge_value,
        window_frame,
        window_nth_value,
        window_ntile,
        window_range_frame,
        window_rank,
        window_relative_rank,
        window_running,
        window_shift,
    )

    f = _window_flags(select)
    shift_dir = f["shift_dir"]
    edge_last, is_edge = f["edge_last"], f["is_edge"]
    nth_n, ntile_n = f["nth_n"], f["ntile_n"]
    ranking = select.agg in (
        AggregationType.ROW_NUMBER,
        AggregationType.RANK,
        AggregationType.DENSE_RANK,
    )
    rel_rank = select.agg in (
        AggregationType.PERCENT_RANK,
        AggregationType.CUME_DIST,
    )
    val_fn = build_evaluator(select.expr)
    part_fns = [build_evaluator(p) for p in part_exprs]
    ord_fn = (
        build_evaluator(select.order_by.expr)
        if select.order_by is not None
        else None
    )
    ord_asc = select.order_by.ascending if select.order_by else True
    agg_name = select.agg.value
    dense_part_fn = (
        _raw_or_f32_key_fn(part_exprs[0], dense_cfg[2])
        if dense_cfg is not None and part_exprs
        else None
    )

    def win_fn(cols, valid):
        vals = _broadcast(_as_f32(val_fn(cols)), cols)
        if dense_cfg is not None:
            pk = (
                _broadcast(dense_part_fn(cols), cols)
                if dense_part_fn is not None
                else jnp.zeros_like(vals)
            )
            return dense_window_aggregate(
                pk, vals, valid, agg_name, dense_cfg[0], dense_cfg[1]
            )
        if part_fns:
            part = tuple(
                _broadcast(_as_f32(fn(cols)), cols) for fn in part_fns
            )
        else:
            part = (jnp.zeros_like(vals),)
        if ord_fn is not None:
            okeys = _broadcast(_as_f32(ord_fn(cols)), cols)
        else:
            okeys = None
        if shift_dir:
            return window_shift(
                part, okeys, vals, valid, shift_dir, ascending=ord_asc
            )
        if is_edge:
            n_pad = vals.shape[0]
            ok = (
                okeys
                if okeys is not None
                else jnp.arange(n_pad, dtype=jnp.float32)
            )
            return window_edge_value(
                part, ok, vals, valid, last=edge_last,
                ascending=ord_asc if okeys is not None else True,
            )
        if nth_n:
            return window_nth_value(
                part, okeys, vals, valid, nth_n, ascending=ord_asc
            )
        if ntile_n:
            return window_ntile(
                part, okeys, valid, ntile_n, ascending=ord_asc
            )
        if rel_rank:
            # PERCENT_RANK/CUME_DIST; without ORDER BY, row order
            # decides (consistent with the RANK family below).
            n_pad = vals.shape[0]
            ok = (
                okeys
                if okeys is not None
                else jnp.arange(n_pad, dtype=jnp.float32)
            )
            return window_relative_rank(
                part, ok, valid, agg_name,
                ascending=ord_asc if okeys is not None else True,
            )
        if ranking:
            # ROW_NUMBER/RANK; without ORDER BY, row order decides.
            n_pad = vals.shape[0]
            ok = (
                okeys
                if okeys is not None
                else jnp.arange(n_pad, dtype=jnp.float32)
            )
            return window_rank(
                part, ok, valid, agg_name,
                ascending=ord_asc if okeys is not None else True,
            )
        if select.frame is not None:
            if select.frame_type == "groups":
                # GROUPS frame (SQL:2011): bounds count PEER GROUPS.
                # Lower to a RANGE frame over the DENSE RANK of the
                # order key — rank distance IS peer-group distance,
                # and RANGE's peers-always-in rule matches GROUPS'
                # whole-group semantics exactly.
                dr = window_rank(
                    part, okeys, valid, "dense_rank", ascending=ord_asc
                )
                lo = (
                    None if select.frame[0] is None
                    else float(select.frame[0])
                )
                hi = (
                    None if select.frame[1] is None
                    else float(select.frame[1])
                )
                return window_range_frame(
                    part, dr, vals, valid, agg_name, lo, hi,
                    ascending=True,
                )
            # Explicit ROWS/RANGE frame (moving aggregates).
            framer = (
                window_range_frame
                if select.frame_type == "range"
                else window_frame
            )
            return framer(
                part, okeys, vals, valid, agg_name,
                select.frame[0], select.frame[1], ascending=ord_asc,
            )
        if okeys is not None:
            # Running aggregate over the window's ORDER BY — what the
            # reference parsed and threw away (expression.cpp:296-329).
            return window_running(
                part, okeys, vals, valid, agg_name, ascending=ord_asc
            )
        return window_aggregate(part, vals, valid, agg_name, capacity)

    return win_fn


def _window_dense_cfg(select, part_exprs, table):
    """Sort-free dense window gate: (base, num_slots, integral_static)
    when stats bound a single integer partition key to a small range,
    else None (see _run_window)."""
    if (
        select.order_by is not None
        or select.agg.value not in ("sum", "avg", "count", "min", "max")
        or len(part_exprs) > 1
        or select.frame is not None
    ):
        return None
    from ..config import get_config
    from .optimizer import expr_range

    if not part_exprs:
        return (0, 1, True)
    rng = expr_range(part_exprs[0], table.stats)
    if rng is None or not np.isfinite(rng[0]) or not np.isfinite(rng[1]):
        return None
    base = int(np.floor(rng[0]))
    num_slots = int(np.floor(rng[1])) - base + 1
    if (
        1 <= num_slots <= get_config().dense_group_max_slots
        and -(2**31) <= base
        and base + num_slots <= 2**31 - 1
    ):
        integral_static, ok = _integral_key_check(table, part_exprs[0])
        if ok:
            return (base, num_slots, integral_static)
    return None


def _run_window(query: Query, table: DeviceTable, mesh=None) -> np.ndarray:
    """SELECT AGG(e) OVER (PARTITION BY …) — executes what the reference
    stubbed (expression.hpp:112-121).

    On a >1-device mesh the dense partition-aggregate family routes to
    the distributed kernel (parallel/window.py: per-shard slot tables
    merged with psum/pmin/pmax — no row movement); everything
    else executes as one GSPMD program over the sharded columns."""
    select: WindowFunction = query.select_list[0]
    cols = table.columns
    where = query.where
    if not select.partition_by:
        part_exprs: tuple = ()
    else:
        part_exprs = select.partition_by
    outer_order = query.order_by

    # Two-phase when a WHERE can shrink the result: count survivors,
    # then the window kernel compacts valid rows to the front (stable
    # sort on original position — order-preserving) and returns only a
    # capacity-sized buffer, so the device→host transfer is O(matches),
    # not O(N).
    out_cap = table.padded_rows
    if where is not None:
        ckey = ("window_count", where.canonical(),
                schema_signature(cols), udf_mod.registry_version())

        def build_count():
            cond_fn = build_evaluator(where)

            @jax.jit
            def kernel(cols, num_rows):
                valid = jnp.logical_and(
                    _valid_mask(cols, num_rows), _as_bool(cond_fn(cols))
                )
                return jnp.sum(valid.astype(jnp.int32))

            return kernel

        n_match = _cached_count(
            table,
            ("where_count", where.canonical(), udf_mod.registry_version()),
            lambda: jax.device_get(
                get_or_compile(ckey, build_count)(
                    cols, jnp.int32(table.num_rows)
                )
            ),
        )
        out_cap = min(_next_pow2(max(n_match, 16)), table.padded_rows)

    # Sort-free window path: a plain partition aggregate over a
    # stats-bounded integer partition key needs neither the partition
    # sort nor the scatter-back (ops/aggregate.dense_window_aggregate).
    dense_cfg = _window_dense_cfg(select, part_exprs, table)

    if (
        dense_cfg is not None
        and mesh is not None
        and int(mesh.devices.size) > 1
        and outer_order is None
    ):
        from ..parallel.window import run_window_partition_agg_sharded

        part_fn = (
            _raw_or_f32_key_fn(part_exprs[0], dense_cfg[2])
            if part_exprs
            else (lambda cols: jnp.zeros(
                (next(iter(cols.values())).shape[0],), jnp.int32
            ))
        )
        return run_window_partition_agg_sharded(
            select, where, table, dense_cfg[0], dense_cfg[1], part_fn,
            mesh,
        )

    key = ("window", select.canonical(),
           where.canonical() if where else "",
           outer_order.canonical() if outer_order else "",
           schema_signature(cols), table.padded_rows, out_cap, dense_cfg,
           udf_mod.registry_version())

    _window_flags(select)  # validate early (raises UnsupportedError)

    def build():
        win_fn = _build_window_value_fn(
            select, part_exprs, dense_cfg, table.padded_rows
        )
        cond_fn = build_evaluator(where) if where is not None else None
        outer_fns = (
            [
                (build_evaluator(t.expr), t.ascending)
                for t in outer_order.terms
            ]
            if outer_order is not None
            else None
        )

        def _finish(win, valid, cols):
            if outer_fns is not None:
                # Outer ORDER BY over the per-row window results.
                from ..ops.sort import sort_by_keys

                keys = [
                    (_broadcast(_as_f32(f(cols)), cols), asc)
                    for f, asc in outer_fns
                ]
                win_sorted = sort_by_keys(keys, win, valid)
                count = jnp.sum(valid.astype(jnp.int32))
                return win_sorted[:out_cap], None, count
            if cond_fn is not None:
                # Compact survivors to the front, preserving row order:
                # stable sort on original position with an invalid-last
                # key.
                n_pad = win.shape[0]
                pos = jnp.arange(n_pad, dtype=jnp.uint32)
                ck = jnp.where(valid, pos, jnp.uint32(0xFFFFFFFF))
                _, win_c = jax.lax.sort((ck, win), num_keys=1, is_stable=True)
                count = jnp.sum(valid.astype(jnp.int32))
                return win_c[:out_cap], None, count
            return win, valid, None

        @jax.jit
        def kernel(cols, num_rows):
            valid = _valid_mask(cols, num_rows)
            if cond_fn is not None:
                valid = jnp.logical_and(valid, _as_bool(cond_fn(cols)))
            win = win_fn(cols, valid)
            return _finish(win, valid, cols)

        return kernel

    win, valid, count = jax.device_get(
        get_or_compile(key, build)(cols, jnp.int32(table.num_rows))
    )
    if valid is None:
        # Outer ORDER BY path: valid rows sorted to the front.
        return win[: int(count)].astype(np.float32)
    # Host boolean gather (order-preserving; no device scatter).
    return win[valid].astype(np.float32)


def result_column_name(item, i: int, taken) -> str:
    """Output column name for a select item: its alias, else its
    canonical form minus the ``[idx]`` suffix; collisions get ``_i``.
    Shared by the in-memory table API and the streaming SQL path so both
    label identical SQL identically."""
    if isinstance(item, Alias):
        name = item.name
    else:
        name = item.canonical()
        if name.endswith("[idx]"):
            name = name[: -len("[idx]")]
    if name in taken:
        name = f"{name}_{i}"
    return name


def _dedup_rows(arrays: list, ordered: bool) -> list:
    """Host-side row dedup over aligned result columns.

    O(result) — every path that reaches here already reduced to
    O(groups) rows (or the user asked for DISTINCT over per-row window
    output, where one lexsort is the floor).  With ``ordered`` the first
    occurrence wins (the input arrived in ORDER BY order); otherwise
    rows emerge lexicographically ascending — the reference's DISTINCT
    convention (host sort+unique, warpdb.cpp:463-468).  NaNs compare
    equal (one NULL row survives), matching the grouped pipeline's
    NaN-key semantics."""
    if not arrays or len(arrays[0]) == 0:
        return list(arrays)
    cols = [np.asarray(a) for a in arrays]
    n = len(cols[0])
    order = np.lexsort(tuple(reversed(cols)))
    newgrp = np.zeros(n, dtype=bool)
    newgrp[0] = True
    for c in cols:
        s = c[order]
        a, b = s[1:], s[:-1]
        eq = a == b
        if c.dtype.kind == "f":
            eq |= np.isnan(a) & np.isnan(b)
        newgrp[1:] |= ~eq
    if ordered:
        starts = np.flatnonzero(newgrp)
        firsts = np.minimum.reduceat(order, starts)
        idx = np.sort(firsts)
    else:
        idx = order[newgrp]
    return [c[idx] for c in cols]


def _is_string_key(expr: Node, table: DeviceTable, catalog) -> bool:
    """True when a grouping-key expression is a bare reference to a
    dictionary-encoded (string) column of the FROM relation or any
    catalog table — decides the NULL fill ("" vs NaN) for rolled-up
    keys."""
    expr = unalias(expr)
    if not isinstance(expr, Variable):
        return False
    cands = {expr.name, expr.unqualified}
    tables = [table]
    for t in (catalog or {}).values():
        if isinstance(t, DeviceTable):
            tables.append(t)
    for t in tables:
        for c in cands:
            if c in t.dicts:
                return True
    return False


def _is_row_free(expr: Node) -> bool:
    """True when an expression references no columns, aggregates, or
    windows — its value is a per-query constant (possibly NaN via
    nullval())."""
    for n in walk(expr):
        if isinstance(n, (Variable, Aggregation, WindowFunction, Star)):
            return False
    return True


def _eval_scalar(expr: Node) -> float:
    """Evaluate a row-free expression to its scalar value through the
    same evaluator the compiler jits (so NaN propagation, builtins, and
    CASE behave identically on the fill and exec paths)."""
    from .compiler import build_evaluator

    return float(np.asarray(jax.device_get(build_evaluator(expr)({}))))


def _run_grouping_sets(
    query: Query, table: DeviceTable, catalog, mesh
) -> dict:
    """GROUP BY GROUPING SETS / ROLLUP / CUBE (extension — the reference
    grammar has plain GROUP BY only, expression.hpp:132-143).

    One grouped pass per set through the ordinary grouped pipeline —
    each reuses the dense/midrange/sort ladder, the plan cache, the join
    memos, and the mesh paths — then the O(groups) per-set results
    concatenate host-side.  Standard semantics in the engine's
    missing-value representation: a rolled-up key reads NaN (numeric)
    or "" (string) in its set's rows, and rolled-up references OUTSIDE
    aggregates lower to nullval() so NULL propagates through arithmetic;
    references inside aggregates keep the real column (SUM(b) for a set
    excluding b aggregates actual b values).  GROUPING(key) lowers to a
    per-set 0/1 constant (usable in SELECT, HAVING, and — via the
    select list — ORDER BY)."""
    import copy as _copy

    gb = query.group_by
    keys = list(gb.keys)
    key_canon = [k.canonical() for k in keys]
    if query.distinct:
        raise UnsupportedError(
            "DISTINCT with GROUPING SETS is not supported"
        )
    for it in query.select_list:
        for n in walk(it):
            if isinstance(n, WindowFunction):
                raise UnsupportedError(
                    "Window functions with GROUPING SETS are not "
                    "supported"
                )

    names: list[str] = []
    for i, item in enumerate(query.select_list):
        names.append(result_column_name(item, i, names))
    n_items = len(query.select_list)
    combined: list[list] = [[] for _ in range(n_items)]
    is_str_fill = [
        _is_string_key(it, table, catalog) for it in query.select_list
    ]

    for s in gb.sets:
        in_set = {key_canon[i] for i in s}
        rolled = {c for c in key_canon if c not in in_set}

        def subst(node, in_set=in_set, rolled=rolled):
            if (
                isinstance(node, FunctionCall)
                and node.name.upper() == "GROUPING"
                and len(node.args) == 1
            ):
                c = node.args[0].canonical()
                if c in in_set:
                    return Constant("0")
                if c in rolled:
                    return Constant("1")
                raise ValidationError(
                    "GROUPING() argument must be a GROUP BY key"
                )
            if node.canonical() in rolled:
                return FunctionCall("nullval", ())
            return node

        exec_items: list[Node] = []
        exec_pos: list[int] = []
        fills: dict[int, object] = {}
        for pos, item in enumerate(query.select_list):
            new = transform(unalias(item), subst, prune=(Aggregation,))
            if (
                isinstance(new, FunctionCall)
                and new.name == "nullval"
                and not new.args
            ):
                # String keys travel as dictionary codes until the API
                # boundary decodes them: code -1 IS the missing marker
                # (decodes to ""); numeric NULL is NaN.
                fills[pos] = -1.0 if is_str_fill[pos] else float("nan")
            elif isinstance(new, Constant):
                fills[pos] = new.value
            elif _is_row_free(new):
                # Rolled-up keys inside arithmetic (``quantity + 1`` in
                # the grand-total set) leave a variable-free expression;
                # evaluate it host-side to its per-set constant — mixing
                # a per-row item into an aggregate-only set query would
                # produce ragged columns.  NaN propagates (NULL
                # semantics); COALESCE-style rescues evaluate correctly.
                fills[pos] = _eval_scalar(new)
            else:
                exec_items.append(new)
                exec_pos.append(pos)

        having = (
            transform(query.having, subst, prune=(Aggregation,))
            if query.having is not None
            else None
        )
        q2 = _copy.copy(query)
        q2.order_by = None
        q2.limit = None
        q2.offset = None
        q2.group_by = GroupBy(tuple(keys[i] for i in s)) if s else None
        q2.having = having if s else None
        items = list(exec_items)
        having_pos = None
        having_const = None
        if not s and having is not None:
            # Global-aggregate set: HAVING has no grouped pipeline to run
            # in — evaluate it as an extra aggregate item and filter the
            # single row host-side (NULL/NaN verdicts drop it, standard).
            if _is_row_free(having):
                having_const = _eval_scalar(having)
            else:
                having_pos = len(items)
                items.append(having)
        if not items:
            items.append(Aggregation(AggregationType.COUNT, Star()))
        q2.select_list = items
        out = run_query_table(q2, table, catalog, mesh=mesh)
        vals = list(out.values())
        n = len(vals[0]) if vals else 0
        if having_pos is not None and n:
            hv = float(vals[having_pos][0])
            if not (hv == hv and hv != 0.0):  # NaN or false → drop row
                n = 0
        if having_const is not None:
            hv = float(having_const)
            if not (hv == hv and hv != 0.0):
                n = 0
        for j, pos in enumerate(exec_pos):
            v = vals[j][:n] if having_pos is not None else vals[j]
            combined[pos].extend(
                v.tolist() if hasattr(v, "tolist") else list(v)
            )
        for pos, fv in fills.items():
            combined[pos].extend([fv] * n)

    # ORDER BY / LIMIT / OFFSET over the combined rows, host-side
    # (O(total groups), not O(rows)).
    return _host_order_and_slice(
        query, names, combined, "ORDER BY with GROUPING SETS"
    )


def _has_nested_window(item) -> bool:
    """True when a select item mixes a window function into a larger
    expression (``v - AVG(v) OVER (…)``) — the window pipeline lowers
    only BARE window items, so these route through _run_window_exprs."""
    it = unalias(item)
    if isinstance(it, WindowFunction):
        return False
    return any(isinstance(n, WindowFunction) for n in walk(it))


def _run_window_exprs(
    query: Query, table: DeviceTable, catalog, mesh
) -> dict:
    """Select items mixing window functions with row arithmetic
    (``v - AVG(v) OVER (PARTITION BY k)`` — deviation-from-mean and
    friends).  Each distinct window function and each referenced column
    rides the window pipeline as a hidden select item (sharing its
    partition sorts via the plan cache, rows aligned by contract), then
    the arithmetic evaluates host-side with NumPy over the O(N)
    columns — a window select already ships O(N) rows, so this adds
    bandwidth-bound host math, not a new transfer class."""
    import copy as _copy

    if query.group_by is not None:
        raise UnsupportedError(
            "Window functions inside expressions are not supported in "
            "grouped queries (use a bare AGG(..) OVER item)"
        )

    wins: dict[str, int] = {}
    win_nodes: list = []
    cols: dict[str, Node] = {}

    def extract(item):
        def repl(n):
            if isinstance(n, WindowFunction):
                c = n.canonical()
                if c not in wins:
                    wins[c] = len(win_nodes)
                    win_nodes.append(n)
                return Variable(f"__winx{wins[c]}")
            return n

        return transform(unalias(item), repl)

    new_items = [extract(it) for it in query.select_list]
    for it in new_items:
        for n in walk(it):
            if isinstance(n, Aggregation):
                raise UnsupportedError(
                    "Mixing plain aggregates with window functions in "
                    "one ungrouped expression is not supported"
                )
            if isinstance(n, Variable) and not n.name.startswith("__winx"):
                cols.setdefault(n.canonical(), n)

    hidden = [Alias(w, f"__winx{i}") for i, w in enumerate(win_nodes)]
    hidden += [Alias(v, f"__colx{j}") for j, v in enumerate(cols.values())]

    # ORDER BY terms resolve against the ORIGINAL select items (alias/
    # canonical) or ride along as extra hidden columns, mirroring
    # _run_qualify.
    extra_order: list = []
    new_terms: list = []
    if query.order_by is not None:
        sel_canon = {unalias(it).canonical() for it in query.select_list}
        alias_names = {
            it.name for it in query.select_list if isinstance(it, Alias)
        }
        for i, t in enumerate(query.order_by.terms):
            e = unalias(t.expr)
            if (
                isinstance(e, Variable) and e.name in alias_names
            ) or e.canonical() in sel_canon:
                new_terms.append((t.expr, t.ascending))
                continue
            hname = f"__ord{i}"
            extra_order.append(Alias(t.expr, hname))
            new_terms.append((Variable(hname), t.ascending))

    fused = _try_fused_window_exprs(
        query, table, mesh, win_nodes, new_items,
        [a.expr for a in extra_order],
    )
    if fused is not None:
        # Device-fused path (VERDICT r4 #5): every window value AND the
        # combining arithmetic evaluate in ONE program; one column ships
        # per select item / hidden order term, WHERE-compacted on
        # device, instead of one O(N) column per window + per referenced
        # column.
        result_cols, ord_cols = fused
    else:
        q2 = _copy.copy(query)
        q2.order_by = None
        q2.limit = None
        q2.offset = None
        q2.select_list = [*hidden, *extra_order]
        out = run_query_table(q2, table, catalog, mesh=mesh)
        from ..utils import metrics as _metrics

        _metrics.note_transfer(
            sum(np.asarray(v).nbytes for v in out.values())
        )

        def _f64(v):
            try:
                return np.asarray(v, dtype=np.float64)
            except (ValueError, TypeError):
                return np.asarray(v, dtype=object)  # string column reference

        vals = [_f64(v) for v in out.values()]
        env: dict = {}
        for i in range(len(win_nodes)):
            env[f"__winx{i}[idx]"] = vals[i]
        for j, c in enumerate(cols):
            env[c] = vals[len(win_nodes) + j]

        from .group_exec import _group_level_eval

        n_rows = len(vals[0]) if vals else 0
        result_cols = []
        for it in new_items:
            v = _group_level_eval(it, env, {})
            result_cols.append(
                np.broadcast_to(np.asarray(v, np.float64), (n_rows,))
            )
        ord_cols = [vals[len(hidden) + k] for k in range(len(extra_order))]

    names: list = []
    for i, item in enumerate(query.select_list):
        names.append(result_column_name(item, i, set(names)))
    ord_names = [h.name for h in extra_order]

    if query.distinct:
        # SELECT DISTINCT over window expressions: dedupe the finished
        # O(N) rows host-side.  Standard SQL requires DISTINCT ORDER BY
        # terms to appear in the select list, so hidden order columns
        # are rejected rather than deduped along.
        if extra_order:
            raise UnsupportedError(
                "DISTINCT ORDER BY terms must appear in the select list"
            )
        result_cols = _dedup_rows(result_cols, ordered=False)

    q_sort = _copy.copy(query)
    q_sort.select_list = [*query.select_list, *extra_order]
    if new_terms:
        head, *rest = new_terms
        q_sort.order_by = OrderBy(
            head[0], head[1], tuple(OrderBy(e, a) for e, a in rest)
        )
    sliced = _host_order_and_slice(
        q_sort,
        [*names, *ord_names],
        [*result_cols, *ord_cols],
        "ORDER BY with window expressions",
    )
    return dict(list(sliced.items())[: len(query.select_list)])


def _try_fused_window_exprs(
    query: Query, table: DeviceTable, mesh, win_nodes, new_items,
    order_exprs, pred=None,
):
    """Fused device path for window-expression selects and QUALIFY
    (VERDICT r4 #5): compute every distinct window value AND the
    combining arithmetic in ONE jitted program, compact by WHERE (and
    the QUALIFY predicate ``pred``, itself an expression over __winx
    placeholders) on device, and ship exactly one column per select
    item / hidden order term (O(match) each).

    Returns (result_cols, ord_cols) as host arrays, or None to fall back
    to the hidden-column host path (multi-device mesh, string-typed
    references, or anything bind refuses)."""
    if mesh is not None and int(mesh.devices.size) > 1:
        return None
    tcols = table.columns
    for root in [*new_items, *win_nodes, *order_exprs, pred, query.where]:
        if root is None:
            continue
        for n in walk(root):
            if isinstance(n, Variable) and not n.name.startswith("__winx"):
                nm = n.name if n.name in tcols else n.unqualified
                if nm not in tcols or nm in table.dicts:
                    return None  # unknown / string-coded → host path
    from ..errors import WarpDBError

    try:
        b_wins = [bind_strings(w, table) for w in win_nodes]
        b_items = [bind_strings(it, table) for it in new_items]
        b_order = [bind_strings(e, table) for e in order_exprs]
        b_pred = bind_strings(pred, table) if pred is not None else None
        where = (
            bind_strings(query.where, table)
            if query.where is not None
            else None
        )
    except WarpDBError:
        return None
    for w in b_wins:
        _window_flags(w)  # validate early; raises like the bare path

    out_cap = table.padded_rows
    # Stats-derived per-window dense configs: computed ONCE here because
    # they are baked into the traced programs and must therefore appear
    # in EVERY kernel cache key below — the count kernel included (a
    # same-schema table with different stats once reused a stale count
    # kernel and silently truncated QUALIFY results).
    dense_cfgs = tuple(
        _window_dense_cfg(w, w.partition_by or (), table) for w in b_wins
    )
    if b_pred is not None:
        # QUALIFY filters AFTER windows evaluate — counting survivors
        # needs the window pass itself (compute-only, no transfer; the
        # count is memoized per immutable table so repeats are free).
        # It buys an O(result) transfer.
        ckey = ("qualify_countk",
                tuple(w.canonical() for w in b_wins),
                b_pred.canonical(),
                where.canonical() if where is not None else "",
                schema_signature(tcols), table.padded_rows, dense_cfgs,
                udf_mod.registry_version())

        def build_qcount():
            win_fns_c = [
                _build_window_value_fn(
                    w, w.partition_by or (), cfg, table.padded_rows,
                )
                for w, cfg in zip(b_wins, dense_cfgs)
            ]
            pred_fn = build_evaluator(b_pred)
            cond_fn = build_evaluator(where) if where is not None else None

            @jax.jit
            def kernel(cols, num_rows):
                valid = _valid_mask(cols, num_rows)
                if cond_fn is not None:
                    valid = jnp.logical_and(valid, _as_bool(cond_fn(cols)))
                env = dict(cols)
                for i, wf in enumerate(win_fns_c):
                    env[f"__winx{i}"] = wf(cols, valid)
                mask = jnp.logical_and(valid, _as_bool(pred_fn(env)))
                return jnp.sum(mask.astype(jnp.int32))

            return kernel

        n_match = _cached_count(
            table,
            ("qualify_count",
             tuple(w.canonical() for w in b_wins), b_pred.canonical(),
             where.canonical() if where is not None else "",
             dense_cfgs, udf_mod.registry_version()),
            lambda: jax.device_get(
                get_or_compile(ckey, build_qcount)(
                    tcols, jnp.int32(table.num_rows)
                )
            ),
        )
        out_cap = min(_next_pow2(max(n_match, 16)), table.padded_rows)
    elif where is not None:
        ckey = ("window_count", where.canonical(),
                schema_signature(tcols), udf_mod.registry_version())

        def build_count():
            cond_fn = build_evaluator(where)

            @jax.jit
            def kernel(cols, num_rows):
                valid = jnp.logical_and(
                    _valid_mask(cols, num_rows), _as_bool(cond_fn(cols))
                )
                return jnp.sum(valid.astype(jnp.int32))

            return kernel

        n_match = _cached_count(
            table,
            ("where_count", where.canonical(), udf_mod.registry_version()),
            lambda: jax.device_get(
                get_or_compile(ckey, build_count)(
                    tcols, jnp.int32(table.num_rows)
                )
            ),
        )
        out_cap = min(_next_pow2(max(n_match, 16)), table.padded_rows)

    key = (
        "window_exprs",
        tuple(it.canonical() for it in b_items),
        tuple(w.canonical() for w in b_wins),
        tuple(e.canonical() for e in b_order),
        b_pred.canonical() if b_pred is not None else "",
        where.canonical() if where is not None else "",
        schema_signature(tcols), table.padded_rows, out_cap, dense_cfgs,
        udf_mod.registry_version(),
    )

    def build():
        win_fns = [
            _build_window_value_fn(
                w, w.partition_by or (), cfg, table.padded_rows
            )
            for w, cfg in zip(b_wins, dense_cfgs)
        ]
        item_fns = [build_evaluator(it) for it in b_items]
        ord_fns = [build_evaluator(e) for e in b_order]
        pred_fn = build_evaluator(b_pred) if b_pred is not None else None
        cond_fn = build_evaluator(where) if where is not None else None

        @jax.jit
        def kernel(cols, num_rows):
            valid = _valid_mask(cols, num_rows)
            if cond_fn is not None:
                valid = jnp.logical_and(valid, _as_bool(cond_fn(cols)))
            env = dict(cols)
            for i, wf in enumerate(win_fns):
                env[f"__winx{i}"] = wf(cols, valid)
            outs = [
                _broadcast(_as_f32(f(env)), cols)
                for f in [*item_fns, *ord_fns]
            ]
            # QUALIFY filters AFTER the windows evaluate.
            mask = valid
            if pred_fn is not None:
                mask = jnp.logical_and(mask, _as_bool(pred_fn(env)))
            count = jnp.sum(mask.astype(jnp.int32))
            if cond_fn is None and pred_fn is None:
                # No filter: valid rows are already the leading prefix.
                return tuple(outs), count
            # One stable sort on original position compacts EVERY
            # output column together (order-preserving).
            n_pad = next(iter(cols.values())).shape[0]
            pos = jnp.arange(n_pad, dtype=jnp.uint32)
            ck = jnp.where(mask, pos, jnp.uint32(0xFFFFFFFF))
            packed = jax.lax.sort((ck, *outs), num_keys=1, is_stable=True)
            return tuple(s[:out_cap] for s in packed[1:]), count

        return kernel

    arrs, count = jax.device_get(
        get_or_compile(key, build)(tcols, jnp.int32(table.num_rows))
    )
    from ..utils import metrics as _metrics

    _metrics.note_transfer(sum(a.nbytes for a in arrs))
    n = int(count)
    host = [np.asarray(a[:n], np.float64) for a in arrs]
    return host[: len(b_items)], host[len(b_items):]



def _run_qualify(query: Query, table: DeviceTable, catalog, mesh) -> dict:
    """QUALIFY <predicate> (extension — the Snowflake/BigQuery/DuckDB
    clause; the reference grammar stops at HAVING).  Filters rows AFTER
    window functions evaluate: the predicate runs as one extra select
    item through the ordinary window pipeline (sharing its partition
    sorts via the plan cache), then rows are kept host-side where it is
    true — O(result) extra work on top of the window select the query
    already pays for.  ORDER BY terms that aren't select items ride
    along as hidden columns, so ordering by arbitrary expressions
    works."""
    import copy as _copy

    qualify = query.qualify
    if not any(isinstance(n, WindowFunction) for n in walk(qualify)):
        raise ValidationError(
            "QUALIFY requires a window function (use WHERE or HAVING "
            "for row/group predicates)"
        )

    hidden: list = []
    new_terms: list = []
    if query.order_by is not None:
        sel_canon = {unalias(it).canonical() for it in query.select_list}
        alias_names = {
            it.name for it in query.select_list if isinstance(it, Alias)
        }
        for i, t in enumerate(query.order_by.terms):
            e = unalias(t.expr)
            if (
                isinstance(e, Variable) and e.name in alias_names
            ) or e.canonical() in sel_canon:
                new_terms.append((t.expr, t.ascending))
                continue
            hname = f"__ord{i}"
            hidden.append(Alias(t.expr, hname))
            new_terms.append((Variable(hname), t.ascending))

    # Device-fused path first (VERDICT r4 #5): windows + the predicate +
    # the select arithmetic evaluate in ONE program, the predicate masks
    # the device compaction, and each select column ships at O(result).
    wins_f: dict = {}
    win_nodes_f: list = []

    def _extract_f(e):
        def repl(n):
            if isinstance(n, WindowFunction):
                c = n.canonical()
                if c not in wins_f:
                    wins_f[c] = len(win_nodes_f)
                    win_nodes_f.append(n)
                return Variable(f"__winx{wins_f[c]}")
            return n

        return transform(unalias(e), repl)

    f_items = [_extract_f(it) for it in query.select_list]
    f_order = [_extract_f(h.expr) for h in hidden]
    f_pred = _extract_f(qualify)
    if not any(
        isinstance(n, Aggregation)
        for it in [*f_items, *f_order, f_pred]
        for n in walk(it)
    ):
        fused = _try_fused_window_exprs(
            query, table, mesh, win_nodes_f, f_items, f_order,
            pred=f_pred,
        )
        if fused is not None:
            result_cols, ord_cols = fused
            fcols = [*result_cols, *ord_cols]
            if query.distinct:
                if hidden:
                    raise UnsupportedError(
                        "DISTINCT ORDER BY terms must appear in the "
                        "select list"
                    )
                fcols = _dedup_rows(fcols, ordered=False)
            q_sort = _copy.copy(query)
            q_sort.select_list = [*query.select_list, *hidden]
            if new_terms:
                head, *rest = new_terms
                q_sort.order_by = OrderBy(
                    head[0], head[1],
                    tuple(OrderBy(e, a) for e, a in rest),
                )
            names: list = []
            for i, item in enumerate(q_sort.select_list):
                names.append(result_column_name(item, i, set(names)))
            sliced = _host_order_and_slice(
                q_sort, names, fcols, "ORDER BY with QUALIFY"
            )
            return dict(list(sliced.items())[: len(query.select_list)])

    # The window pipeline lowers BARE window items only (expressions
    # over windows are not row-level kernels) — so each comparison side
    # of the predicate ships as its own hidden select item and the
    # boolean structure (cmp / AND / OR) evaluates host-side over the
    # finished O(result) columns.
    leaves: list = []

    def leaf(e) -> int:
        leaves.append(Alias(e, f"__q{len(leaves)}"))
        return len(leaves) - 1

    _CMPS = {
        ">": np.greater, "<": np.less, ">=": np.greater_equal,
        "<=": np.less_equal, "==": np.equal, "=": np.equal,
        "!=": np.not_equal,
    }

    def plan(e):
        """Compile the predicate into a host closure over leaf arrays."""
        if isinstance(e, BinaryOp) and e.op in ("&&", "||"):
            lf, rf = plan(e.left), plan(e.right)
            comb = np.logical_and if e.op == "&&" else np.logical_or
            return lambda vs: comb(lf(vs), rf(vs))
        if isinstance(e, BinaryOp) and e.op in _CMPS:
            op = _CMPS[e.op]

            def side(x):
                if isinstance(x, Constant):
                    c = np.float32(x.value)
                    return lambda vs: c
                i = leaf(x)
                return lambda vs: vs[i]

            lf, rf = side(e.left), side(e.right)
            return lambda vs: op(lf(vs), rf(vs))
        i = leaf(e)  # bare boolean-valued window expression
        return lambda vs: np.nan_to_num(vs[i], nan=0.0) != 0.0

    pred = plan(qualify)

    q2 = _copy.copy(query)
    q2.qualify = None
    q2.order_by = None
    q2.limit = None
    q2.offset = None
    q2.select_list = [*query.select_list, *hidden, *leaves]
    out = run_query_table(q2, table, catalog, mesh=mesh)
    vals = list(out.values())
    n_leaf = len(leaves)
    leaf_vals = [
        np.asarray(v, dtype=np.float64)
        for v in (vals[len(vals) - n_leaf:] if n_leaf else [])
    ]
    keep = np.where(pred(leaf_vals))[0]
    cols = []
    for v in vals[: len(vals) - n_leaf]:
        arr = np.asarray(v) if not isinstance(v, list) else None
        if arr is not None and arr.dtype.kind in "fiub":
            cols.append(arr[keep])
        else:
            seq = list(v)
            cols.append([seq[i] for i in keep])

    if query.distinct:
        # SELECT DISTINCT ... QUALIFY: dedupe the qualifying rows
        # host-side (O(result)).  Hidden ORDER BY columns would make
        # the dedupe ambiguous — standard SQL requires DISTINCT ORDER
        # BY terms to appear in the select list.
        if hidden:
            raise UnsupportedError(
                "DISTINCT ORDER BY terms must appear in the select list"
            )
        cols = _dedup_rows(cols, ordered=False)

    q_sort = _copy.copy(query)
    q_sort.select_list = [*query.select_list, *hidden]
    if new_terms:
        head, *rest = new_terms
        q_sort.order_by = OrderBy(
            head[0], head[1], tuple(OrderBy(e, a) for e, a in rest)
        )
    names = list(out.keys())[: len(vals) - n_leaf]
    sliced = _host_order_and_slice(
        q_sort, names, cols, "ORDER BY with QUALIFY"
    )
    n_vis = len(query.select_list)
    return dict(list(sliced.items())[:n_vis])


def _host_order_and_slice(
    query: Query, names: list, columns: list, ctx: str
) -> dict:
    """Apply ORDER BY / LIMIT / OFFSET host-side to already-finished
    result columns (lists or arrays, one per select item).  ORDER BY
    terms must reference select-list items (by alias or canonical) —
    the values are already computed.  NaN follows the engine's total
    order (largest: last ASC, first DESC); a missing string is ""."""
    order = None
    if query.order_by is not None and columns and len(columns[0]):
        sort_keys: list[np.ndarray] = []
        for t in query.order_by.terms:
            e = unalias(t.expr)
            target = None
            if isinstance(e, Variable):
                for i, item in enumerate(query.select_list):
                    if isinstance(item, Alias) and item.name == e.name:
                        target = i
                        break
            if target is None:
                c = e.canonical()
                for i, item in enumerate(query.select_list):
                    if unalias(item).canonical() == c:
                        target = i
                        break
            if target is None:
                raise UnsupportedError(
                    f"{ctx} must reference select-list items"
                )
            col = list(columns[target])
            # ``sort_keys`` collects in significance order (term-major;
            # within a numeric term the NaN flag outranks the value);
            # np.lexsort takes its LAST key as primary, so it gets the
            # reversed list.
            if any(isinstance(x, str) for x in col):
                arr = np.array(
                    ["" if isinstance(x, float) else x for x in col]
                )
                codes = np.unique(arr, return_inverse=True)[1]
                sort_keys.append(codes if t.ascending else -codes)
            else:
                arr = np.asarray(col, dtype=np.float64)
                nan = np.isnan(arr)
                filled = np.where(nan, 0.0, arr)
                if t.ascending:
                    sort_keys.append(nan)  # NaN last
                    sort_keys.append(filled)
                else:
                    sort_keys.append(~nan)  # NaN first
                    sort_keys.append(-filled)
        if sort_keys:
            order = np.lexsort(sort_keys[::-1])
    out: dict = {}
    off = query.offset or 0
    end = None if query.limit is None else off + query.limit
    for name, col in zip(names, columns):
        col = list(col)
        if order is not None:
            col = [col[i] for i in order]
        out[name] = col[off:end]
    return out


def resolve_order_aliases(query: Query, columns=None) -> Query:
    """Rewrite ORDER BY terms (and bare HAVING column references, the
    MySQL/DuckDB convenience) naming a select-list alias into the
    aliased expression (standard output-column resolution: the alias
    wins over an input column of the same name, as in PostgreSQL).
    With ``columns`` (the input schema) GROUP BY keys also resolve
    aliases — but there an input column of the same name wins (the
    PostgreSQL rule: GROUP BY binds input columns first, output
    aliases as a fallback).  Extension — the reference never connects
    clauses to aliases (expression.hpp:145-151).  Returns ``query``
    unchanged (identity — plan-cache keys survive) when nothing
    references an alias."""
    alias_map = {
        item.name: unalias(item)
        for item in query.select_list
        if isinstance(item, Alias)
    }
    if not alias_map:
        return query
    import copy as _copy

    changed = False
    new_order = query.order_by
    if query.order_by is not None:
        new_terms = []
        order_changed = False
        for t in query.order_by.terms:
            e = t.expr
            if (
                isinstance(e, Variable)
                and e.qualifier is None
                and e.name in alias_map
            ):
                new_terms.append((alias_map[e.name], t.ascending))
                order_changed = True
            else:
                new_terms.append((e, t.ascending))
        if order_changed:
            head, *rest = new_terms
            new_order = OrderBy(
                head[0], head[1], tuple(OrderBy(e, a) for e, a in rest)
            )
            changed = True

    new_having = query.having
    if query.having is not None:

        def subst(node):
            if (
                isinstance(node, Variable)
                and node.qualifier is None
                and node.name in alias_map
            ):
                return alias_map[node.name]
            return node

        # Prune aggregate arguments: inside AGG(...) an input column of
        # the same name wins over the alias (MySQL resolution order).
        rewritten = transform(query.having, subst, prune=(Aggregation,))
        if rewritten is not query.having:
            new_having = rewritten
            changed = True

    new_group = query.group_by
    if (
        columns is not None
        and query.group_by is not None
        and query.group_by.sets is None
    ):
        cols = set(columns)
        new_keys = []
        group_changed = False
        for k in query.group_by.keys:
            if (
                isinstance(k, Variable)
                and k.qualifier is None
                and k.name in alias_map
                and k.name not in cols
            ):
                new_keys.append(alias_map[k.name])
                group_changed = True
            else:
                new_keys.append(k)
        if group_changed:
            new_group = GroupBy(tuple(new_keys))
            changed = True

    if not changed:
        return query
    query = _copy.copy(query)
    query.order_by = new_order
    query.having = new_having
    query.group_by = new_group
    return query


def run_query_table(
    query: Query,
    table: DeviceTable,
    catalog: Optional[dict] = None,
    mesh=None,
) -> dict:
    """Execute a SELECT returning every select-list item as a named
    column (the reference returned only the first expression's values,
    warpdb.cpp:447-459 — this exceeds it).

    Rows stay aligned across columns: each item runs through the same
    WHERE/ORDER machinery (stable sorts over identical masks/keys).
    Multi-column DISTINCT rewrites to GROUP BY over the select list
    (device-side dedup); DISTINCT over aggregate/window outputs dedups
    the finished result rows host-side.
    """
    import copy as _copy

    query = resolve_order_aliases(query, table.columns)

    if getattr(query, "set_ops", None):
        raise UnsupportedError(
            "Set operations (UNION/EXCEPT/INTERSECT) execute at the "
            "facade: use WarpDB.query_sql / query_sql_table"
        )
    if getattr(query, "ctes", None):
        raise UnsupportedError(
            "WITH (CTEs) resolve at the facade: use WarpDB.query_sql / "
            "query_sql_table"
        )

    _validate_relations(query, catalog)
    if getattr(query, "from_subquery", None) is not None:
        query, table = _resolve_from_subquery(query, table, catalog, mesh)
    catalog = _resolve_alias_catalog(query, table, catalog)
    query, catalog = _decorrelate_subqueries(query, table, catalog, mesh)
    query = _resolve_expr_subqueries(query, table, catalog, mesh)

    expanded = expand_stars_query(query, table, catalog)
    if expanded is not query.select_list:
        query = _copy.copy(query)
        query.select_list = expanded

    if getattr(query, "qualify", None) is not None:
        return _run_qualify(query, table, catalog, mesh)

    if query.group_by is not None and query.group_by.sets is not None:
        return _run_grouping_sets(query, table, catalog, mesh)

    if query.group_by is None and not query.joins and any(
        _has_nested_window(it) for it in query.select_list
    ):
        return _run_window_exprs(query, table, catalog, mesh)

    if query.group_by is None and any(
        isinstance(n, Aggregation) and n.agg is AggregationType.STRING_AGG
        for item in [*query.select_list, query.having]
        if item is not None
        for n in walk(item)
    ):
        # Global STRING_AGG: the scalar global-aggregate path is
        # float-typed — route through the grouped machinery with a
        # constant key (one group == the whole table).
        query = _copy.copy(query)
        query.group_by = GroupBy((Constant("1"),))

    if query.joins:
        query = _lift_implicit_join_conditions(query, table, catalog)
        query = _split_join_residuals(query)
        query, catalog = _pushdown_build_filters(query, table, catalog, mesh)
        query, table = _pushdown_join_where(query, table, catalog, mesh)
        if query.group_by is not None:
            rewritten = _try_eager_join_aggregate(query, table, catalog, mesh)
            if rewritten is not None:
                query, catalog = rewritten
        # Materialise the join chain ONCE, then execute the join-free
        # remainder on the joined table — previously each select item
        # re-ran the whole join (kernels were cached; the device work
        # was not).
        joined = _materialize_joins(query, table, catalog, mesh=mesh)
        q2 = _copy.copy(query)
        q2.joins = ()
        return run_query_table(q2, joined, catalog, mesh=mesh)

    if query.distinct and (
        len(query.select_list) > 1 or query.group_by is not None
    ):
        items = [unalias(s) for s in query.select_list]
        has_agg = query.group_by is not None or any(
            isinstance(n, (Aggregation, WindowFunction))
            for it in items
            for n in walk(it)
        )
        if not has_agg:
            # SELECT DISTINCT a, b, … ≡ SELECT a, b, … GROUP BY a, b, …
            # — the grouped pipeline dedups on device (sort-free
            # dense/midrange ladder when stats allow) and ships O(distinct).
            keys, seen_canon = [], set()
            for it in items:
                c = it.canonical()
                if c not in seen_canon:
                    seen_canon.add(c)
                    keys.append(it)
            query = _copy.copy(query)
            query.distinct = False
            query.group_by = GroupBy(keys=tuple(keys))
        else:
            # DISTINCT over aggregate/window outputs: run the query,
            # then dedup the finished rows host-side (grouped results
            # are O(groups); ordered results keep first occurrence).
            q2 = _copy.copy(query)
            q2.distinct = False
            q2.limit = None
            q2.offset = None
            out = run_query_table(q2, table, catalog, mesh=mesh)
            names = list(out.keys())
            deduped = _dedup_rows(
                [out[k] for k in names], ordered=query.order_by is not None
            )
            off = query.offset or 0
            end = None if query.limit is None else off + query.limit
            return {k: v[off:end] for k, v in zip(names, deduped)}

    out_name = result_column_name

    def empty_result() -> dict:
        out: dict = {}
        for i, item in enumerate(query.select_list):
            out[out_name(item, i, out)] = np.zeros(0, np.float32)
        return out

    if query.group_by is not None and not query.joins:
        # One grouped pass serves every select item (row-aligned columns).
        q = _bind_query_strings(query, table)
        if q is query:
            q = _copy.copy(query)
        if q.where is not None:
            from .optimizer import analyze_condition, fold_constants

            w = fold_constants(q.where)
            verdict = analyze_condition(w, table.stats)
            q.where = None if verdict is True else w
            if verdict is False:
                return empty_result()
        items = [unalias(s) for s in q.select_list]
        cols = _run_grouped_multi(q, table, items, mesh=mesh)
        out = {}
        for i, (item, vals) in enumerate(zip(query.select_list, cols)):
            if query.offset is not None:
                vals = (
                    vals[query.offset :]
                    if query.offset < len(vals)
                    else vals[:0]
                )
            if query.limit is not None and query.limit < len(vals):
                vals = vals[: query.limit]
            out[out_name(item, i, out)] = vals
        return out

    # Non-grouped, join-free multi-item SELECT: one fused kernel, one
    # sort, one transfer for every column.
    items = [unalias(s) for s in query.select_list]
    simple = (
        query.group_by is None
        and not query.joins
        and not query.distinct
        and len(items) > 1
        and all(
            not isinstance(n, (Aggregation, WindowFunction))
            for item in items
            for n in walk(item)
        )
    )
    if simple:
        q = _copy.copy(query)
        if query.where is not None:
            from .optimizer import analyze_condition, fold_constants

            w = fold_constants(query.where)
            verdict = analyze_condition(w, table.stats)
            if verdict is False:
                return empty_result()
            q.where = None if verdict is True else w
        q = _bind_query_strings(q, table)
        cols_out = _run_projection_multi(
            q, table, [unalias(s) for s in q.select_list]
        )
        out = {}
        for i, (item, vals) in enumerate(zip(query.select_list, cols_out)):
            if query.offset is not None:
                vals = (
                    vals[query.offset :]
                    if query.offset < len(vals)
                    else vals[:0]
                )
            if query.limit is not None and query.limit < len(vals):
                vals = vals[: query.limit]
            out[out_name(item, i, out)] = vals
        return out

    out = {}
    for i, item in enumerate(query.select_list):
        q = _copy.copy(query)
        q.select_list = [item]
        out[out_name(item, i, out)] = run_query(q, table, catalog, mesh=mesh)
    return out
