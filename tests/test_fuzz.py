"""Property-based fuzzing: random expression/query ASTs, engine vs the
independent NumPy oracle.  Seeded (deterministic in CI); goes beyond the
reference's fixed golden tests (SURVEY.md §4: "What does NOT exist: …
no fuzzing")."""

import numpy as np
import pytest

import oracle
from warpdb_tpu import WarpDB
from warpdb_tpu.frontend import parse_expression_text, parse_query_text
from warpdb_tpu.storage import HostTable

COLS = ["price", "quantity"]
_ARITH = ["+", "-", "*", "/"]
_CMP = [">", "<", ">=", "<=", "==", "!="]


def _rand_arith(rng, depth: int) -> str:
    if depth <= 0 or rng.uniform() < 0.3:
        if rng.uniform() < 0.5:
            return rng.choice(COLS)
        return f"{rng.uniform(0.1, 20):.3f}"
    r = rng.uniform()
    if r < 0.1:
        # CASE WHEN branch.
        c = _rand_cond(rng, 1)
        a = _rand_arith(rng, depth - 1)
        b = _rand_arith(rng, depth - 1)
        return f"CASE WHEN {c} THEN {a} ELSE {b} END"
    if r < 0.2:
        fn = rng.choice(["abs", "sqrt", "floor", "ceil", "trunc", "sign"])
        return f"{fn}({_rand_arith(rng, depth - 1)})"
    if r < 0.26:
        # Unary minus (extension).
        return f"(-{_rand_arith(rng, depth - 1)})"
    if r < 0.32:
        # NULL round-trip: NULLIF makes NaNs, COALESCE removes them.
        a = _rand_arith(rng, depth - 1)
        b = _rand_arith(rng, 0)
        return f"COALESCE(NULLIF({a}, {b}), {_rand_arith(rng, 0)})"
    if r < 0.38:
        fn = rng.choice(["greatest", "least"])
        return (
            f"{fn}({_rand_arith(rng, depth - 1)}, "
            f"{_rand_arith(rng, depth - 1)})"
        )
    if r < 0.44:
        # Modulo against a literal (C fmod semantics both sides).
        return f"({rng.choice(COLS)} % {rng.uniform(2.0, 10.0):.3f})"
    a = _rand_arith(rng, depth - 1)
    b = _rand_arith(rng, depth - 1)
    op = rng.choice(_ARITH)
    return f"({a} {op} {b})"


def _rand_cond(rng, depth: int) -> str:
    if depth <= 0 or rng.uniform() < 0.4:
        return f"({_rand_arith(rng, 1)} {rng.choice(_CMP)} {_rand_arith(rng, 1)})"
    a = _rand_cond(rng, depth - 1)
    b = _rand_cond(rng, depth - 1)
    return f"({a} {rng.choice(['AND', 'OR'])} {b})"


@pytest.fixture(scope="module")
def fuzz_db():
    rng = np.random.default_rng(99)
    n = 3000
    table = {
        # Strictly positive columns keep division finite; the grammar's
        # f32 pipeline is compared at 1e-4 relative tolerance.
        "price": rng.uniform(0.5, 100, n).astype(np.float32),
        "quantity": rng.integers(1, 20, n).astype(np.float32),
    }
    return WarpDB(HostTable.from_dict(table)), table


@pytest.mark.parametrize("seed", range(25))
def test_fuzz_expression(fuzz_db, seed):
    db, table = fuzz_db
    rng = np.random.default_rng(1000 + seed)
    expr = _rand_arith(rng, 3)
    cond = _rand_cond(rng, 2) if rng.uniform() < 0.7 else None
    text = expr if cond is None else f"{expr} WHERE {cond}"

    got = np.asarray(db.query_np(text))
    want = oracle.query_expression(
        table,
        parse_expression_text(expr),
        parse_expression_text(cond) if cond else None,
    )
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("seed", range(50))
def test_fuzz_sql(fuzz_db, seed):
    db, table = fuzz_db
    rng = np.random.default_rng(2000 + seed)
    expr = _rand_arith(rng, 2)
    parts = [f"SELECT {expr} FROM t"]
    if rng.uniform() < 0.6:
        parts.append(f"WHERE {_rand_cond(rng, 1)}")
    order_expr = rng.choice([expr, "price", "quantity"])
    asc = rng.choice(["ASC", "DESC"])
    parts.append(f"ORDER BY {order_expr} {asc}")
    if rng.uniform() < 0.5:
        parts.append(f"LIMIT {rng.integers(1, 50)}")
    if rng.uniform() < 0.3:
        parts.append(f"OFFSET {rng.integers(0, 10)}")
    sql = " ".join(parts)

    got = np.asarray(db.query_sql(sql), dtype=np.float32)
    want = oracle.query_sql(table, parse_query_text(sql))
    assert got.shape == want.shape, sql
    # Tie-aware ROW-ORDER comparison (VERDICT r1 item 10): both sides
    # sort stably, so rows must match position-for-position EXCEPT
    # within runs of equal order keys (where the f32-rounded key may tie
    # differently than the oracle's f64 key) — sort within oracle-key
    # runs on both sides, then compare elementwise.  A NaN-able order
    # key (sqrt of a negative subtree) falls back to the multiset
    # compare: the engine's DESC NaN-first total order differs from the
    # oracle's negate-then-sort placement by design.
    q = parse_query_text(sql)
    n = len(next(iter(table.values())))
    mask = np.ones(n, bool)
    if q.where is not None:
        mask = oracle.eval_expr(q.where, table, n) != 0
    okey = np.asarray(
        oracle.eval_expr(q.order_by.terms[0].expr, table, n), np.float32
    )
    okey = np.broadcast_to(okey, (n,))[mask]
    if np.isnan(okey).any():
        np.testing.assert_allclose(
            np.sort(got), np.sort(want), rtol=1e-4, atol=1e-5, err_msg=sql
        )
        return
    okey_sorted = np.sort(okey)[:: 1 if asc == "ASC" else -1]
    off = q.offset or 0
    okey_out = okey_sorted[off : off + len(got)] if q.limit is not None or off \
        else okey_sorted
    assert len(okey_out) == len(got), sql

    def _runs_sorted(vals):
        out = vals.copy()
        i = 0
        while i < len(out):
            j = i + 1
            while j < len(out) and okey_out[j] == okey_out[i]:
                j += 1
            out[i:j] = np.sort(out[i:j])
            i = j
        return out

    np.testing.assert_allclose(
        _runs_sorted(got), _runs_sorted(want), rtol=1e-4, atol=1e-5,
        err_msg=sql,
    )


@pytest.mark.parametrize("seed", range(10))
def test_fuzz_grouped(fuzz_db, seed):
    db, table = fuzz_db
    rng = np.random.default_rng(3000 + seed)
    agg = rng.choice(["SUM", "AVG", "COUNT", "MIN", "MAX"])
    expr = _rand_arith(rng, 2)
    parts = [f"SELECT {agg}({expr}) FROM t"]
    if rng.uniform() < 0.5:
        parts.append(f"WHERE {_rand_cond(rng, 1)}")
    parts.append("GROUP BY quantity ORDER BY quantity ASC")
    sql = " ".join(parts)

    got = np.asarray(db.query_sql(sql), dtype=np.float32)
    want = oracle.query_sql(table, parse_query_text(sql))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4, err_msg=sql)


@pytest.mark.parametrize("seed", range(10))
def test_fuzz_string_predicates(seed):
    from warpdb_tpu import DataType

    rng = np.random.default_rng(4000 + seed)
    words = ["apple", "berry", "cherry", "date", "elder", "fig"]
    n = 2000
    cat = rng.choice(words, n)
    price = rng.uniform(0, 100, n).astype(np.float32)
    db = WarpDB(
        HostTable.from_dict(
            {"cat": cat.astype(object), "price": price},
            dtypes={"cat": DataType.STRING},
        )
    )
    op = rng.choice([">", "<", ">=", "<=", "==", "!="])
    # Literal may be outside the vocabulary (tests half-code ranking).
    lit = rng.choice(words + ["banana", "aaaa", "zzzz"])
    got = np.asarray(
        db.query_sql(f"SELECT price FROM t WHERE cat {op} '{lit}'"),
        dtype=np.float32,
    )
    cmpf = {
        ">": np.greater, "<": np.less, ">=": np.greater_equal,
        "<=": np.less_equal, "==": np.equal, "!=": np.not_equal,
    }[op]
    want = price[cmpf(cat, lit)]
    np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=f"{op} {lit}")


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_string_group(seed):
    from warpdb_tpu import DataType

    rng = np.random.default_rng(5000 + seed)
    words = ["a", "bb", "ccc", "dd", "e"]
    n = 3000
    cat = rng.choice(words, n)
    price = rng.uniform(0, 50, n).astype(np.float32)
    db = WarpDB(
        HostTable.from_dict(
            {"cat": cat.astype(object), "price": price},
            dtypes={"cat": DataType.STRING},
        )
    )
    out = db.query_sql_table(
        "SELECT cat, SUM(price) AS s, COUNT(*) AS n FROM t "
        "GROUP BY cat ORDER BY cat ASC"
    )
    uniq = sorted(set(cat.tolist()))
    assert out["cat"] == uniq
    want_s = [float(price[cat == u].sum()) for u in uniq]
    np.testing.assert_allclose(out["s"], want_s, rtol=1e-4)
    assert out["n"] == [int((cat == u).sum()) for u in uniq]


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_join_vs_numpy(seed):
    rng = np.random.default_rng(6000 + seed)
    nl, nr = rng.integers(50, 400), rng.integers(20, 200)
    lk = rng.integers(0, 20, nl).astype(np.float32)
    rk = rng.integers(0, 25, nr).astype(np.float32)
    lv = rng.uniform(0, 100, nl).astype(np.float32)
    rv = rng.uniform(0, 100, nr).astype(np.float32)
    left = WarpDB(HostTable.from_dict({"k": lk, "v": lv}))
    left.register_table("r", HostTable.from_dict({"k": rk, "w": rv}))
    out = left.query_sql_table("SELECT v, r.w FROM t JOIN r ON k = r.k")

    want = sorted(
        (float(lv[i]), float(rv[j]))
        for i in range(nl)
        for j in range(nr)
        if lk[i] == rk[j]
    )
    got = sorted(zip(out["v"], out["r.w"]))
    assert len(got) == len(want)
    np.testing.assert_allclose(
        np.asarray(got, np.float32), np.asarray(want, np.float32), rtol=1e-6
    )


@pytest.mark.parametrize("seed", range(5))
def test_fuzz_join_groupby(seed):
    rng = np.random.default_rng(7000 + seed)
    nl = 600
    lk = rng.integers(0, 8, nl).astype(np.float32)
    lv = rng.uniform(0, 10, nl).astype(np.float32)
    rk = np.arange(8, dtype=np.float32)
    rw = rng.uniform(1, 2, 8).astype(np.float32)
    left = WarpDB(HostTable.from_dict({"k": lk, "v": lv}))
    left.register_table("r", HostTable.from_dict({"k": rk, "w": rw}))
    out = left.query_sql_table(
        "SELECT k, SUM(v) AS s, COUNT(*) AS n FROM t JOIN r ON k = r.k "
        "WHERE r.w > 1.5 GROUP BY k ORDER BY k ASC"
    )
    keep = rw > 1.5
    uniq = [float(k) for k in rk[keep] if (lk == k).any()]
    assert out["k"] == sorted(uniq)
    for i, k in enumerate(out["k"]):
        m = lk == k
        np.testing.assert_allclose(out["s"][i], float(lv[m].sum()), rtol=1e-4)
        assert out["n"][i] == int(m.sum())


@pytest.mark.parametrize("seed", range(10))
def test_fuzz_semicompact_join_vs_numpy(seed):
    """Unique build keys with a randomized match rate: sweeps the
    lookup (100% match) / semicompact (partial match) / empty (0%)
    boundaries of the 1:1 inner-join ladder, with a string build
    column and a chained GROUP BY over the compacted output."""
    rng = np.random.default_rng(41000 + seed)
    nl = int(rng.integers(200, 2000))
    m = int(rng.integers(8, 300))
    stride = int(rng.choice([1, 2, 5]))  # 1 → every probe row matches
    bk = (np.arange(m) * stride).astype(np.float32)
    lk = rng.integers(0, max(int(bk[-1]) + 2, 2), nl).astype(np.float32)
    if rng.random() < 0.2:
        lk += 10_000.0  # zero matches
    lv = rng.uniform(-5, 5, nl).astype(np.float32)
    w = rng.uniform(0.5, 1.5, m).astype(np.float32)
    tag = np.array(["x", "y", "z"], dtype=object)[np.arange(m) % 3]
    db = WarpDB(HostTable.from_dict({"k": lk, "v": lv}))
    db.register_table(
        "d", HostTable.from_dict({"k": bk, "w": w, "tag": tag})
    )

    out = db.query_sql_table(
        "SELECT v, d.w, d.tag FROM t JOIN d ON k = d.k"
    )
    wmap = {float(k): (float(x), str(s)) for k, x, s in zip(bk, w, tag)}
    mask = np.isin(lk, bk)
    assert len(out["v"]) == int(mask.sum())
    # The engine preserves probe order for 1:1 joins — compare aligned.
    np.testing.assert_allclose(
        out["v"], lv[mask].astype(np.float32), rtol=1e-6
    )
    np.testing.assert_allclose(
        out["d.w"],
        np.asarray([wmap[float(k)][0] for k in lk[mask]], np.float32),
        rtol=1e-6,
    )
    assert out["d.tag"] == [wmap[float(k)][1] for k in lk[mask]]

    grp = db.query_sql_table(
        "SELECT d.tag, SUM(v * d.w) AS s, COUNT(*) AS n FROM t "
        "JOIN d ON k = d.k GROUP BY d.tag ORDER BY d.tag ASC"
    )
    want: dict = {}
    for k, v in zip(lk[mask], lv[mask]):
        wv, t = wmap[float(k)]
        s, n = want.get(t, (0.0, 0))
        want[t] = (s + float(v) * wv, n + 1)
    assert grp["d.tag"] == sorted(want)
    for i, t in enumerate(grp["d.tag"]):
        np.testing.assert_allclose(grp["s"][i], want[t][0], rtol=1e-3)
        assert grp["n"][i] == want[t][1]


@pytest.mark.parametrize("seed", range(12))
def test_fuzz_special_values(seed):
    """NaN / ±inf data values through WHERE / ORDER BY / aggregates
    (VERDICT r1 item 10): the engine's f32 pipeline must agree with the
    oracle elementwise, NaNs included, when the order key itself is
    NaN-free."""
    rng = np.random.default_rng(8000 + seed)
    n = 2000
    price = rng.uniform(-50, 100, n).astype(np.float32)
    special = rng.integers(0, 12, n)
    price[special == 0] = np.nan
    price[special == 1] = np.inf
    price[special == 2] = -np.inf
    quantity = rng.integers(0, 6, n).astype(np.float32)
    table = {"price": price, "quantity": quantity}
    db = WarpDB(HostTable.from_dict(table))

    # Projection with WHERE on the clean column, ORDER BY clean key:
    # stable sorts both sides → exact row order, NaNs aligned.
    sql = (
        "SELECT price FROM t WHERE quantity > 2 "
        "ORDER BY quantity ASC LIMIT 500"
    )
    got = np.asarray(db.query_sql(sql), dtype=np.float32)
    want = oracle.query_sql(table, parse_query_text(sql))
    np.testing.assert_allclose(got, want, rtol=1e-6, equal_nan=True)

    # Comparisons against NaN are false → NaN rows never pass the filter.
    got = np.asarray(db.query_sql("SELECT quantity FROM t WHERE price > 0"))
    want = quantity[np.greater(price, 0, where=~np.isnan(price),
                               out=np.zeros(n, bool))]
    np.testing.assert_allclose(got, want, rtol=1e-6)

    # MIN/MAX propagate NaN (NaN is a value, not SQL NULL — DESIGN §8)
    # and fold infinities like np.max.
    got = float(db.query_sql("SELECT MAX(price) FROM t WHERE quantity < 3")[0])
    want = float(price[quantity < 3].max())
    assert got == want or (np.isnan(got) and np.isnan(want)) or (
        np.isinf(got) and np.isinf(want)
    )


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_left_join_vs_numpy(seed):
    rng = np.random.default_rng(10_000 + seed)
    nl, nr = int(rng.integers(50, 400)), int(rng.integers(10, 100))
    lk = rng.integers(0, 30, nl).astype(np.float32)
    rk = rng.integers(0, 25, nr).astype(np.float32)
    lv = rng.uniform(0, 100, nl).astype(np.float32)
    rv = rng.uniform(0, 100, nr).astype(np.float32)
    db = WarpDB(HostTable.from_dict({"k": lk, "v": lv}))
    db.register_table("r", HostTable.from_dict({"k": rk, "w": rv}))
    out = db.query_sql_table("SELECT v, r.w FROM t LEFT JOIN r ON k = r.k")

    want = []
    for i in range(nl):
        matches = [float(rv[j]) for j in range(nr) if rk[j] == lk[i]]
        if matches:
            want.extend((float(lv[i]), m) for m in matches)
        else:
            want.append((float(lv[i]), None))
    got = list(zip(out["v"], out["r.w"]))
    assert len(got) == len(want)

    def key(t):
        return (t[0], -np.inf if (t[1] is None or np.isnan(t[1])) else t[1])

    got_s = sorted(got, key=key)
    want_s = sorted(want, key=key)
    for (gv, gw), (wv, ww) in zip(got_s, want_s):
        assert abs(gv - wv) < 1e-4
        if ww is None:
            assert np.isnan(gw)
        else:
            assert abs(gw - ww) < 1e-4


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_outer_joins_vs_numpy(seed):
    """RIGHT/FULL OUTER row multisets vs a NumPy oracle (NaN = miss)."""
    rng = np.random.default_rng(20_000 + seed)
    nl, nr = int(rng.integers(50, 400)), int(rng.integers(10, 100))
    lk = rng.integers(0, 30, nl).astype(np.float32)
    rk = rng.integers(0, 40, nr).astype(np.float32)  # keys 30-39 always miss
    lv = rng.uniform(0, 100, nl).astype(np.float32)
    rv = rng.uniform(0, 100, nr).astype(np.float32)
    db = WarpDB(HostTable.from_dict({"k": lk, "v": lv}))
    db.register_table("r", HostTable.from_dict({"k": rk, "w": rv}))

    inner = [
        (float(lv[i]), float(rv[j]))
        for i in range(nl)
        for j in range(nr)
        if lk[i] == rk[j]
    ]
    left_miss = [
        (float(lv[i]), None)
        for i in range(nl)
        if not np.any(rk == lk[i])
    ]
    right_miss = [
        (None, float(rv[j]))
        for j in range(nr)
        if not np.any(lk == rk[j])
    ]

    def norm(rows):
        return sorted(
            (-1e30 if a is None or np.isnan(a) else round(float(a), 3),
             -1e30 if b is None or np.isnan(b) else round(float(b), 3))
            for a, b in rows
        )

    for kind, want in (
        ("RIGHT", inner + right_miss),
        ("FULL", inner + left_miss + right_miss),
    ):
        out = db.query_sql_table(
            f"SELECT v, r.w FROM t {kind} JOIN r ON k = r.k"
        )
        got = list(zip(out["v"], out["r.w"]))
        assert norm(got) == norm(want), kind


# --- differential fuzz: fast paths vs forced slow paths -----------------------

_DIFF_SHAPES = [
    "group", "join_group", "left_join", "window", "distinct", "derived",
    # r3 paths: packed composite dense keys, device-side HAVING/ORDER-BY
    # top-k finish, build-side predicate pushdown.
    "multi_group", "agg_topk", "dim_filter",
]


def _diff_query(rng):
    """One random query over columns g (6 groups), k (join key), v."""
    agg = rng.choice(["SUM", "AVG", "MIN", "MAX", "COUNT"])
    agg2 = rng.choice(["SUM", "AVG", "MIN", "MAX", "COUNT"])
    cond = f"WHERE v > {rng.uniform(0, 30):.2f}" if rng.uniform() < 0.6 else ""
    lim = f" LIMIT {int(rng.integers(1, 6))}" if rng.uniform() < 0.3 else ""
    shape = _DIFF_SHAPES[int(rng.integers(0, len(_DIFF_SHAPES)))]
    if shape == "group":
        hav = (
            f" HAVING COUNT(v) > {int(rng.integers(0, 4))}"
            if rng.uniform() < 0.3
            else ""
        )
        return (
            f"SELECT g, {agg}(v), {agg2}(v + g) FROM t {cond} "
            f"GROUP BY g{hav} ORDER BY g ASC{lim}"
        )
    if shape == "join_group":
        return (
            f"SELECT g, {agg}(v * d.w) FROM t JOIN d ON k = d.k {cond} "
            f"GROUP BY g ORDER BY g ASC{lim}"
        )
    if shape == "left_join":
        return (
            f"SELECT g, COUNT(v), {agg}(d.w) FROM t LEFT JOIN d ON k = d.k "
            f"{cond} GROUP BY g ORDER BY g ASC{lim}"
        )
    if shape == "window":
        low = agg if agg != "COUNT" else "SUM"
        return f"SELECT {low}(v) OVER (PARTITION BY g) FROM t {cond}"
    if shape == "distinct":
        return f"SELECT DISTINCT g FROM t {cond} ORDER BY g ASC{lim}"
    if shape == "multi_group":
        # Composite keys: packed dense/midrange vs sorted composite.
        return (
            f"SELECT g, k, {agg}(v), COUNT(*) FROM t {cond} "
            f"GROUP BY g, k ORDER BY g ASC, k ASC{lim}"
        )
    if shape == "agg_topk":
        # Device finish: ORDER BY aggregate + LIMIT (+ HAVING).
        low = agg if agg != "COUNT" else "SUM"
        hav = (
            f" HAVING COUNT(*) > {int(rng.integers(0, 3))}"
            if rng.uniform() < 0.5
            else ""
        )
        d = "DESC" if rng.uniform() < 0.5 else "ASC"
        k = int(rng.integers(1, 7))
        return (
            f"SELECT k, {low}(v) FROM t {cond} GROUP BY k{hav} "
            f"ORDER BY {low}(v) {d} LIMIT {k}"
        )
    if shape == "dim_filter":
        # Single-relation conjuncts on both sides: build-side pushdown
        # strips d.w, then the probe pushdown may take the remainder.
        wlo = rng.uniform(0.5, 1.8)
        pc = f" AND v > {rng.uniform(0, 30):.2f}" if rng.uniform() < 0.5 \
            else ""
        return (
            f"SELECT g, {agg}(v * d.w) FROM t JOIN d ON k = d.k "
            f"WHERE d.w < {wlo:.3f}{pc} GROUP BY g ORDER BY g ASC{lim}"
        )
    return (
        f"SELECT {agg}(x) FROM (SELECT g, v * 2 AS x FROM t {cond}) "
        f"GROUP BY g ORDER BY g ASC{lim}"
    )


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_differential_fast_vs_slow_paths(seed):
    """Every stats-gated fast path (dense/midrange/one-hot GROUP BY, dense
    phase-1 joins, eager join aggregation) must be result-equivalent to
    the general machinery (sorted segmented aggregation, full sort-merge
    join).  Each random query runs twice — fast paths enabled vs all
    forced off — and the results must agree.  Offline campaigns ran
    clean: 400 seeds on 2026-08-17, and 300 fresh seeds (plus 100
    join-vs-numpy, 50 string-predicate, 40 string-group) on 2026-08-20
    after the r5 pushdown/COUNT/wide-int64 changes; these 8 seeds keep
    the equivalence regress-visible in CI."""
    import dataclasses

    from warpdb_tpu.config import EngineConfig, get_config, set_config

    rng = np.random.default_rng(900_000 + seed)
    n = int(rng.integers(50, 3000))
    nk = int(rng.integers(2, 60))
    host = HostTable.from_dict({
        "g": rng.integers(0, 6, n).astype(np.float32),
        "k": rng.integers(0, nk + 3, n).astype(np.float32),
        "v": rng.uniform(0.0, 50.0, n).astype(np.float32),
    })
    dup = int(rng.integers(1, 3))
    dim = HostTable.from_dict({
        "k": np.tile(np.arange(nk, dtype=np.float32), dup),
        "w": rng.uniform(0.5, 2.0, nk * dup).astype(np.float32),
    })
    sql = _diff_query(rng)

    base = get_config()
    outs = []
    try:
        for slow in (False, True):
            cfg = EngineConfig(**{
                f.name: getattr(base, f.name)
                for f in dataclasses.fields(EngineConfig)
            })
            cfg.join_cache_entries = 0  # keep the memo out of the diff
            if slow:
                cfg.dense_group_max_slots = 0
                cfg.midrange_group_max_slots = 0
                cfg.mxu_group_max_slots = 0
                cfg.join_dense_build_max = 0
                cfg.eager_join_aggregation = False
                cfg.join_filter_pushdown = False
                cfg.grouped_device_finish = False
            set_config(cfg)
            db = WarpDB(host)
            db.register_table("d", dim)
            outs.append(np.asarray(db.query_sql(sql), np.float64))
    finally:
        set_config(base)
    fast, slow = outs
    assert fast.shape == slow.shape, sql
    np.testing.assert_allclose(
        fast, slow, rtol=2e-4, atol=1e-3, equal_nan=True, err_msg=sql
    )


# ---------------------------------------------------------------------------
# FILTER clauses, grouping sets, QUALIFY (round-2 SQL surface)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(10))
def test_fuzz_aggregate_filter(seed):
    """AGG(x) FILTER (WHERE c) vs a per-group masked NumPy oracle,
    including zero-match groups (NULL per the standard)."""
    rng = np.random.default_rng(7000 + seed)
    n = 2000
    k = rng.integers(0, 8, n).astype(np.float32)
    v = rng.uniform(0.5, 100, n).astype(np.float32)
    w = rng.uniform(0.5, 100, n).astype(np.float32)
    db = WarpDB(HostTable.from_dict({"k": k, "v": v, "w": w}))
    thresh = rng.uniform(0, 120)  # sometimes filters everything out
    agg = rng.choice(["COUNT", "SUM", "AVG", "MIN", "MAX"])
    arg = "*" if agg == "COUNT" and rng.uniform() < 0.5 else "v"
    sql = (
        f"SELECT k, {agg}({arg}) FILTER (WHERE w > {thresh:.3f}) "
        "FROM t GROUP BY k ORDER BY k"
    )
    out = db.query_sql_table(sql)
    keys = np.asarray(list(out.values())[0], np.float32)
    got = np.asarray(list(out.values())[1], np.float64)
    exp = []
    for kk in sorted(set(k.tolist())):
        m = (k == kk) & (w > np.float32(thresh))
        sel = v[m]
        if agg == "COUNT":
            exp.append(float(m.sum()))
        elif sel.size == 0:
            exp.append(np.nan)
        elif agg == "SUM":
            exp.append(float(np.sum(sel, dtype=np.float32)))
        elif agg == "AVG":
            exp.append(
                float(np.sum(sel, dtype=np.float32)) / float(m.sum())
            )
        elif agg == "MIN":
            exp.append(float(sel.min()))
        else:
            exp.append(float(sel.max()))
    assert keys.tolist() == sorted(set(k.tolist()))
    np.testing.assert_allclose(got, exp, rtol=1e-4, equal_nan=True)


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_grouping_sets(seed):
    """ROLLUP/CUBE/GROUPING SETS row multisets vs per-set oracles."""
    rng = np.random.default_rng(7100 + seed)
    n = 1500
    a = rng.integers(0, 5, n).astype(np.float32)
    b = rng.integers(0, 4, n).astype(np.float32)
    v = rng.uniform(0.5, 50, n).astype(np.float32)
    db = WarpDB(HostTable.from_dict({"a": a, "b": b, "v": v}))
    kind = ["ROLLUP(a, b)", "CUBE(a, b)",
            "GROUPING SETS ((a), (b), ())",
            "a, ROLLUP(b)"][seed % 4]
    out = db.query_sql_table(
        f"SELECT a, b, SUM(v) FROM t GROUP BY {kind}"
    )
    cols = [np.asarray(c, np.float64) for c in out.values()]
    got = {}
    for x, y, s in zip(*cols):
        gk = (
            "N" if np.isnan(x) else round(x, 3),
            "N" if np.isnan(y) else round(y, 3),
        )
        got[gk] = s
    sets = {
        0: [("a", "b"), ("a",), ()],
        1: [("a", "b"), ("a",), ("b",), ()],
        2: [("a",), ("b",), ()],
        3: [("a", "b"), ("a",)],
    }[seed % 4]
    exp = {}
    vals = {"a": a, "b": b}
    for ks in sets:
        m = {}
        for i in range(n):
            key = tuple(float(vals[c][i]) for c in ks)
            m[key] = np.float32(m.get(key, np.float32(0))) + v[i]
        for key, s in m.items():
            d = dict(zip(ks, key))
            ek = (
                round(d["a"], 3) if "a" in d else "N",
                round(d["b"], 3) if "b" in d else "N",
            )
            exp[ek] = float(s)
    assert set(got) == set(exp)
    for gk in exp:
        np.testing.assert_allclose(got[gk], exp[gk], rtol=1e-4)


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_qualify_topn(seed):
    """QUALIFY ROW_NUMBER top-N per partition vs a NumPy oracle."""
    rng = np.random.default_rng(7200 + seed)
    n = 1200
    k = rng.integers(0, 7, n).astype(np.float32)
    v = rng.uniform(0, 1000, n).astype(np.float32)
    topn = int(rng.integers(1, 5))
    desc = bool(rng.integers(0, 2))
    direction = "DESC" if desc else "ASC"
    db = WarpDB(HostTable.from_dict({"k": k, "v": v}))
    out = db.query_sql_table(
        f"SELECT k, v FROM t QUALIFY ROW_NUMBER() OVER "
        f"(PARTITION BY k ORDER BY v {direction}) <= {topn} "
        "ORDER BY k, v"
    )
    got = list(zip(*[np.asarray(c, np.float64) for c in out.values()]))
    exp = []
    for kk in sorted(set(k.tolist())):
        sel = sorted(v[k == kk], reverse=desc)[:topn]
        exp += [(float(kk), float(x)) for x in sorted(sel)]
    np.testing.assert_allclose(np.array(got), np.array(exp), rtol=1e-6)


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_pushdown_or_shapes(seed):
    """Differential fuzz for the r5 join-pushdown surface: random
    multi-dimension joins under mixed AND/OR WHERE clauses run with the
    pushdown rewrites on vs off and must agree (a 200-seed offline
    campaign ran clean on 2026-08-20)."""
    from warpdb_tpu.config import get_config

    rng = np.random.default_rng(7_000_000 + seed)
    n = int(rng.integers(100, 4000))
    nk1, nk2 = int(rng.integers(3, 20)), int(rng.integers(3, 20))
    db = WarpDB(HostTable.from_dict({
        "a": rng.integers(0, nk1, n).astype(np.float32),
        "b": rng.integers(0, nk2, n).astype(np.float32),
        "v": np.round(rng.uniform(0, 50, n), 2).astype(np.float32),
    }))
    db.register_table("d1", HostTable.from_dict({
        "a": np.arange(nk1, dtype=np.float32),
        "x": np.round(rng.uniform(0, 10, nk1), 2).astype(np.float32),
        "s": np.array([f"c{i%5}" for i in range(nk1)]),
    }))
    db.register_table("d2", HostTable.from_dict({
        "b": np.arange(nk2, dtype=np.float32),
        "y": np.round(rng.uniform(0, 10, nk2), 2).astype(np.float32),
    }))
    j1 = "JOIN" if rng.choice(["inner", "left"]) == "inner" else "LEFT JOIN"
    t1, t2 = float(rng.uniform(0, 10)), float(rng.uniform(0, 10))
    vth = float(rng.uniform(0, 50))
    shapes = [
        f"(d1.x > {t1:.2f} AND d2.y < {t2:.2f}) "
        f"OR (d1.x < {t1:.2f} AND d2.y > {t2:.2f})",
        f"v > {vth:.2f} AND (d1.s = 'c1' OR d1.s = 'c3')",
        f"(d1.x > {t1:.2f} OR d2.y > {t2:.2f}) AND v < {vth:.2f}",
        f"v > {vth:.2f} AND d1.x > {t1:.2f} "
        f"AND (d2.y < {t2:.2f} OR d2.y > 9.00)",
    ]
    wh = shapes[int(rng.integers(0, len(shapes)))]
    agg = rng.choice(["SUM(v)", "COUNT(*)", "MIN(v)", "MAX(v)"])
    sql = (f"SELECT a, {agg} FROM t {j1} d1 ON a = d1.a "
           f"JOIN d2 ON b = d2.b WHERE {wh} GROUP BY a ORDER BY a ASC")
    cfg = get_config()
    try:
        outs = []
        for flag in (True, False):
            cfg.join_filter_pushdown = flag
            outs.append(db.query_sql_table(sql))
    finally:
        cfg.join_filter_pushdown = True
    ka, kb = outs
    assert list(ka.keys()) == list(kb.keys())
    for c in ka:
        np.testing.assert_allclose(
            np.asarray(ka[c], np.float64), np.asarray(kb[c], np.float64),
            rtol=1e-4, atol=1e-4,
        )
