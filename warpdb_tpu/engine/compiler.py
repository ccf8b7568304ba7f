"""Expression compiler: AST → traced JAX function → fused XLA kernel.

This layer replaces the reference's NVRTC JIT (jit.cpp:48-174).  Where the
reference assembled CUDA source strings (``output[idx] = EXPR;`` /
``if (COND) { output[idx] = EXPR; }``) and recompiled + recreated a CUDA
context on *every* call — its dominant perf flaw (jit.cpp:98-157) — this
compiler:

* walks the AST once, building a Python closure over jnp ops;
* lets ``jax.jit`` trace it into a single fused XLA kernel (filter and
  projection fuse exactly like the reference's generated ``user_kernel``,
  jit.cpp:81-83, but XLA also vectorises it for the device);
* memoises the jitted executable keyed on
  (canonical expression, schema signature, padded length, UDF registry
  version) — recompilation happens once per plan shape, not per query.

Numeric semantics: every column and constant is evaluated in float32,
matching the reference's all-``float`` pipeline (expression.hpp:32-38,
cuda kernels take ``float*``), so results are bit-comparable where the
reference is deterministic.  ONE deliberate exception: comparisons whose
operands are both integral (INT column / dictionary code / integral
literal) compare in int32 — an f32 comparison would collide key values
beyond 2^24 (the reference's Int32/Int64 DataTypes, csv_loader.hpp:13,
promise exact integer semantics).
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from ..errors import ExecutionError, ValidationError
from ..frontend.ast import (
    Aggregation,
    Alias,
    unalias,
    BinaryOp,
    CaseWhen,
    Constant,
    FunctionCall,
    InCodeSet,
    InSubquery,
    InValueSet,
    LikePattern,
    CodeMap,
    Node,
    NotNull,
    ExistsSubquery,
    ScalarSubquery,
    Star,
    Variable,
    WindowFunction,
)
from . import udf as udf_mod

__all__ = [
    "build_evaluator",
    "raw_int_item",
    "compile_filter_project",
    "schema_signature",
    "clear_cache",
    "cache_stats",
]


def _as_bool(x):
    if x.dtype == jnp.bool_:
        return x
    return x != 0


def _as_f32(x):
    if x.dtype == jnp.bool_ or x.dtype != jnp.float32:
        return x.astype(jnp.float32)
    return x


def _const_value(node):
    """Fold an all-Constant arithmetic subtree in f64 (exact for integer
    literals: the grammar has no unary minus, so ``-16777217`` arrives
    as ``0 - 16777217`` — an f32 fold would round it).  None when the
    subtree isn't constant."""
    if isinstance(node, Alias):
        return _const_value(node.expr)
    if isinstance(node, Constant):
        return float(node.value)
    if isinstance(node, BinaryOp) and node.op in ("+", "-", "*", "/"):
        l = _const_value(node.left)
        r = _const_value(node.right)
        if l is None or r is None:
            return None
        if node.op == "+":
            return l + r
        if node.op == "-":
            return l - r
        if node.op == "*":
            return l * r
        return l / r if r != 0 else None
    return None


def _raw_operand(node):
    """Evaluator for a COMPARISON operand preserving exactness:

    * bare Variable -> the raw device array (int32 for INT/string-code
      columns, f32 otherwise);
    * constant subtree -> the Python float (f64: integer literals stay
      exact, including parenthesised/negated forms);
    * anything else -> the normal f32 evaluator.
    """
    if isinstance(node, Alias):
        return _raw_operand(node.expr)
    cval = _const_value(node)
    if cval is not None:
        return lambda cols: cval
    if isinstance(node, Variable):
        name, uname = node.name, node.unqualified

        def raw_var(cols):
            arr = cols.get(name)
            if arr is None:
                arr = cols.get(uname)
            if arr is None:
                raise ValidationError(f"Unknown column: {name}")
            return arr

        return raw_var
    return build_evaluator(node)


def _exact_compare(cmp, op, lhs, rhs):
    """Comparison with integer-exact semantics where possible.

    int-array vs int-array (or integral scalar) compares in int32 (f32
    would collide values beyond 2^24); int-array vs NON-integral scalar
    rewrites to the equivalent exact integer comparison
    (``k < 2.5`` ⟺ ``k <= 2``); everything else compares in f32 as the
    reference does."""

    def is_int_arr(x):
        return hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.integer)

    def as_arr_f32(x):
        return jnp.float32(x) if isinstance(x, float) else _as_f32(x)

    import math

    li, ri = is_int_arr(lhs), is_int_arr(rhs)
    if li and ri:
        return cmp(lhs, rhs)
    for a, b, swap in ((lhs, rhs, False), (rhs, lhs, True)):
        if not (is_int_arr(a) and isinstance(b, float)):
            continue
        if float(b).is_integer() and -(2.0**31) <= b <= 2.0**31 - 1:
            bi = jnp.int32(int(b))
            return cmp(a, bi) if not swap else cmp(bi, a)
        if op in ("==", "="):
            return jnp.zeros(a.shape, jnp.bool_)
        if op == "!=":
            return jnp.ones(a.shape, jnp.bool_)
        if math.isfinite(b) and -(2.0**31) < b < 2.0**31 - 1:
            # int-array <op> non-integral scalar: exact integer rewrite
            # in the array's frame (``k < 2.5`` ⟺ ``k <= 2``).
            effective = op if not swap else {
                "<": ">", "<=": ">=", ">": "<", ">=": "<="
            }[op]
            if effective in ("<", "<="):
                return a <= jnp.int32(int(math.floor(b)))
            return a >= jnp.int32(int(math.ceil(b)))
        break  # out-of-int32-range scalar: f32 handles the ±inf regime
    return cmp(as_arr_f32(lhs), as_arr_f32(rhs))


def raw_int_item(item, table):
    """``(raw evaluator, np output dtype)`` when ``item`` is a bare INT
    column whose device array is integer-typed, else None.

    Such items evaluate/carry/emit RAW int32 (the reference's
    Int32/Int64 DataTypes, csv_loader.hpp:13, promise exact integer
    values; an f32 carry collides beyond 2^24).  Joined/derived tables
    may have demoted an INT column to f32 (outer-join NaN fills) — the
    device dtype is the authority, so those fall back to f32 here."""
    import numpy as np

    node = unalias(item)
    if not isinstance(node, Variable):
        return None
    dt = table.dtypes.get(node.name) or table.dtypes.get(node.unqualified)
    if dt is None or getattr(dt, "value", None) not in ("int32", "int64"):
        return None
    arr = table.columns.get(node.name)
    if arr is None:
        arr = table.columns.get(node.unqualified)
    if arr is None or not np.issubdtype(np.dtype(arr.dtype), np.integer):
        return None
    name, uname = node.name, node.unqualified

    def raw_fn(cols):
        a = cols.get(name)
        return a if a is not None else cols[uname]

    return raw_fn, (np.int64 if dt.value == "int64" else np.int32)


def build_evaluator(node: Node) -> Callable[[dict], jax.Array]:
    """Build a closure ``columns -> array`` evaluating ``node`` rowwise.

    Comparisons yield bool arrays; bools are promoted to f32 {0,1} when
    used arithmetically or returned — identical to how the reference's
    generated CUDA promotes ``(a > b)`` when assigned to ``float``.
    Aggregation / window nodes are plan-level constructs and must be
    lowered by the executor, not here.
    """

    if isinstance(node, Alias):
        return build_evaluator(node.expr)
    if isinstance(node, Star):
        # COUNT(*)'s argument: every row counts as 1 (no NULLs here).
        one = jnp.float32(1.0)
        return lambda cols: one
    if isinstance(node, Constant):
        val = jnp.float32(node.value)
        return lambda cols: val
    if isinstance(node, Variable):
        name = node.name
        uname = node.unqualified

        def var_fn(cols):
            arr = cols.get(name)
            if arr is None:
                arr = cols.get(uname)
            if arr is None:
                raise ValidationError(f"Unknown column: {name}")
            return _as_f32(arr)

        return var_fn
    if isinstance(node, BinaryOp):
        left = build_evaluator(node.left)
        right = build_evaluator(node.right)
        op = node.op
        if op in ("&&", "||"):
            combine = jnp.logical_and if op == "&&" else jnp.logical_or
            return lambda cols: combine(_as_bool(left(cols)), _as_bool(right(cols)))
        if op in (">", "<", ">=", "<=", "==", "!=", "="):
            cmp = {
                ">": jnp.greater,
                "<": jnp.less,
                ">=": jnp.greater_equal,
                "<=": jnp.less_equal,
                "==": jnp.equal,
                "=": jnp.equal,
                "!=": jnp.not_equal,
            }[op]
            lraw = _raw_operand(node.left)
            rraw = _raw_operand(node.right)
            return lambda cols: _exact_compare(
                cmp, op, lraw(cols), rraw(cols)
            )
        arith = {
            "+": jnp.add,
            "-": jnp.subtract,
            "*": jnp.multiply,
            "/": jnp.divide,
            # SQL % is C fmod (sign of the dividend), not Python mod.
            "%": jnp.fmod,
        }.get(op)
        if arith is None:
            raise ValidationError(f"Unsupported operator: {op}")
        return lambda cols: arith(_as_f32(left(cols)), _as_f32(right(cols)))
    if isinstance(node, FunctionCall):
        arg_fns = [build_evaluator(a) for a in node.args]
        name = node.name

        def call_fn(cols):
            fn = udf_mod.resolve_udf(name)
            return _as_f32(fn(*[a(cols) for a in arg_fns]))

        return call_fn
    if isinstance(node, NotNull):
        # Not-NULL indicator (SQL COUNT(expr) NULL-skipping): bare
        # Variables read RAW so the missing-value marker stays visible —
        # i32 columns (string codes, exact ints) carry -1 for the
        # LEFT-JOIN fill (join_exec.left_fill); float columns carry NaN.
        # Computed f32 expressions propagate NaN, so ``x == x`` covers
        # them.
        raw = _raw_operand(node.expr)
        neg = getattr(node, "negated", False)

        def notnull_fn(cols):
            arr = raw(cols)
            if not hasattr(arr, "dtype"):  # constant subtree
                isnull = float(arr) != float(arr)
                return jnp.float32(
                    (1.0 if isnull else 0.0) if neg else
                    (0.0 if isnull else 1.0)
                )
            if arr.dtype.kind in "iu":
                ind = (arr == -1) if neg else (arr != -1)
            else:
                ind = (arr != arr) if neg else (arr == arr)
            return ind.astype(jnp.float32)

        return notnull_fn
    if isinstance(node, CaseWhen):
        cond_fns = [build_evaluator(c) for c in node.conditions]
        val_fns = [build_evaluator(v) for v in node.values]
        default_fn = (
            build_evaluator(node.default) if node.default is not None else None
        )

        def case_fn(cols):
            out = (
                _as_f32(default_fn(cols))
                if default_fn is not None
                else jnp.float32(0.0)
            )
            # First matching branch wins: fold right-to-left.
            for c, v in zip(reversed(cond_fns), reversed(val_fns)):
                out = jnp.where(_as_bool(c(cols)), _as_f32(v(cols)), out)
            return out

        return case_fn
    if isinstance(node, InCodeSet):
        import numpy as _np

        inner = build_evaluator(node.expr)
        lut_np = _np.zeros(max(node.vocab_size, 1), _np.bool_)
        if node.codes:
            lut_np[list(node.codes)] = True
        lut = jnp.asarray(lut_np)

        def in_codes_fn(cols):
            codes = inner(cols).astype(jnp.int32)
            return jnp.take(lut, jnp.clip(codes, 0, lut.shape[0] - 1))

        return in_codes_fn
    if isinstance(node, CodeMap):
        import numpy as _np

        inner = build_evaluator(node.expr)
        n_entries = len(node.values)
        lut = jnp.asarray(_np.asarray(node.values, _np.float32))
        # Missing codes (outer-join misses: -1 / NaN) stay missing:
        # -1 for code-valued results (decodes as ""), NaN for numeric.
        miss = jnp.float32(-1.0 if node.out_vocab is not None else _np.nan)

        def codemap_fn(cols):
            c = _as_f32(inner(cols))
            if n_entries == 0:
                return jnp.full(c.shape, miss)
            ci = jnp.clip(c.astype(jnp.int32), 0, n_entries - 1)
            out = jnp.take(lut, ci)
            return jnp.where(c >= 0, out, miss)

        return codemap_fn
    if isinstance(node, InValueSet):
        import numpy as _np

        inner = build_evaluator(node.expr)
        vals_np = _np.asarray(node.values, _np.float32)
        k = int(vals_np.shape[0])

        def in_values_fn(cols):
            x = _as_f32(inner(cols))
            if k == 0:
                return jnp.zeros(x.shape, jnp.bool_)
            # Virtual (N, K) compare sweep in ≤1024-lane chunks — the
            # tiny-table trade (docs/DESIGN.md): per-row gathers or
            # sorts lose badly to K broadcast-compare lanes at the set
            # sizes an IN (SELECT …) produces.
            hit = jnp.zeros(x.shape, jnp.bool_)
            for s in range(0, k, 1024):
                v = jnp.asarray(vals_np[s : s + 1024])
                hit = jnp.logical_or(
                    hit, jnp.any(x[:, None] == v[None, :], axis=1)
                )
            return hit

        return in_values_fn
    if isinstance(node, (ScalarSubquery, InSubquery, ExistsSubquery)):
        raise ExecutionError(
            "Unresolved subquery reached the compiler — subqueries are "
            "resolved by the executor before kernel compilation"
        )
    if isinstance(node, LikePattern):
        raise ExecutionError(
            "LIKE requires a string column (binding against the table's "
            "dictionary did not occur — is the column numeric?)"
        )
    if isinstance(node, (Aggregation, WindowFunction)):
        raise ExecutionError(
            f"{type(node).__name__} is not a row-level expression; "
            "it must be lowered by the plan executor"
        )
    raise ExecutionError(f"Cannot compile node type {type(node).__name__}")


# ---------------------------------------------------------------------------
# Jit cache
# ---------------------------------------------------------------------------

_cache_lock = threading.Lock()
# LRU-bounded: long-running services touch many (plan, schema, capacity)
# combinations; without a cap the executable cache grows without bound.
_CACHE_MAX_ENTRIES = 1024
from collections import OrderedDict as _OrderedDict

_kernel_cache: "_OrderedDict" = _OrderedDict()
_cache_hits = 0
_cache_misses = 0


def schema_signature(columns: dict) -> tuple:
    """Hashable signature of a device column dict: name, dtype, shape."""
    return tuple(
        (name, str(arr.dtype), arr.shape) for name, arr in sorted(columns.items())
    )


def clear_cache() -> None:
    global _cache_hits, _cache_misses
    with _cache_lock:
        _kernel_cache.clear()
        _cache_hits = 0
        _cache_misses = 0


def cache_stats() -> dict:
    with _cache_lock:
        return {
            "entries": len(_kernel_cache),
            "hits": _cache_hits,
            "misses": _cache_misses,
        }


def get_or_compile(key: tuple, build: Callable[[], Callable]) -> Callable:
    """Plan-keyed kernel cache — the fix for the reference's
    recompile-per-call (jit.cpp:98-157).  ``build`` runs at most once per
    distinct key."""
    from ..utils.metrics import note_operator

    global _cache_hits, _cache_misses
    with _cache_lock:
        fn = _kernel_cache.get(key)
        if fn is not None:
            _kernel_cache.move_to_end(key)
            _cache_hits += 1
            note_operator(str(key[0]), True)
            return fn
    fn = build()
    with _cache_lock:
        _kernel_cache[key] = fn
        _kernel_cache.move_to_end(key)
        while len(_kernel_cache) > _CACHE_MAX_ENTRIES:
            _kernel_cache.popitem(last=False)
        _cache_misses += 1
    note_operator(str(key[0]), False)
    return fn


# ---------------------------------------------------------------------------
# The fused filter+projection kernel (the reference's generated user_kernel)
# ---------------------------------------------------------------------------


def compile_filter_project(
    expr: Node,
    cond: Optional[Node],
    columns: dict,
) -> Callable[[dict, jax.Array], jax.Array]:
    """Compile ``output = cond ? expr : 0`` over padded columns.

    Direct analogue of jit_compile_and_launch's generated kernel
    (jit.cpp:55-83) with one documented deviation: rows failing the filter
    (and padding rows) yield **0.0** rather than uninitialized memory
    (the reference leaves ``output[idx]`` garbage, jit.cpp:56-58 +
    warpdb.cpp:243-244).

    The returned callable takes ``(columns, num_rows)`` where ``num_rows``
    is a traced int32 scalar — the same executable serves every valid-row
    count at a given padded size (no retrace).
    """
    expr_key = expr.canonical()
    cond_key = cond.canonical() if cond is not None else ""
    key = (
        "filter_project",
        expr_key,
        cond_key,
        schema_signature(columns),
        udf_mod.registry_version(),
    )

    def build():
        expr_fn = build_evaluator(expr)
        cond_fn = build_evaluator(cond) if cond is not None else None

        @jax.jit
        def kernel(cols, num_rows):
            out = _as_f32(expr_fn(cols))
            some = next(iter(cols.values()))
            n_pad = some.shape[0]
            out = jnp.broadcast_to(out, (n_pad,))
            valid = jnp.arange(n_pad, dtype=jnp.int32) < num_rows
            if cond_fn is not None:
                valid = jnp.logical_and(valid, _as_bool(cond_fn(cols)))
            return jnp.where(valid, out, jnp.float32(0.0))

        return kernel

    return get_or_compile(key, build)
