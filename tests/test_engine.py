"""End-to-end engine tests: reference-parity queries (sql_features_test,
having_distinct_test, extended_types_test), randomized oracle
comparisons, JOIN execution, window functions, and error paths."""

import math
import numpy as np
import pytest

import oracle
from warpdb_tpu import WarpDB, DataType
from warpdb_tpu.errors import (
    ExecutionError,
    ParseError,
    UnsupportedError,
    ValidationError,
    WarpDBError,
)
from warpdb_tpu.frontend import parse_expression_text, parse_query_text
from warpdb_tpu.storage import HostTable


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    return WarpDB("data/test.csv")


@pytest.fixture(scope="module")
def test_table():
    return {
        "price": np.array([10.5, 20.0, 15.25, 30.0], np.float32),
        "quantity": np.array([3.0, 4.0, 2.0, 5.0], np.float32),
    }


# --- WarpDB::query parity (warpdb.cpp:199-256) -------------------------------


@pytest.mark.parametrize(
    "expr",
    [
        "price * quantity",
        "price + 1",
        "price WHERE price > 15",
        "price * 0.9 WHERE price > 20",
        "price * quantity * 1.08",
        "discount(price, 0.9)",
        "price WHERE price > 10 AND quantity < 5",
        "price WHERE price > 25 OR quantity <= 2",
        "(price + quantity) * 2",
        "price / quantity",
        "price - quantity WHERE price != 20",
        "quantity WHERE price >= 15.25",
    ],
)
def test_query_vs_oracle(db, test_table, expr):
    got = np.asarray(db.query_np(expr))
    from warpdb_tpu.api import _split_where
    from warpdb_tpu.frontend import parse_expression_text

    e, w = _split_where(expr)
    expr_ast = parse_expression_text(e)
    cond_ast = parse_expression_text(w) if w else None
    want = oracle.query_expression(test_table, expr_ast, cond_ast)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_query_empty_expression(db):
    with pytest.raises(WarpDBError, match="Empty query expression"):
        db.query("")


def test_query_unknown_column(db):
    with pytest.raises(ValidationError, match="Unknown column: bogus"):
        db.query("bogus + 1")


def test_query_parse_error_wrapped(db):
    with pytest.raises(ParseError, match="Failed to parse expression"):
        db.query("1 2")
    with pytest.raises(ParseError, match="Failed to parse WHERE clause"):
        db.query("price WHERE 1 2")


# --- query_sql parity: sql_features_test.cpp ----------------------------------


def test_group_by_sum(db, test_table):
    res = db.query_sql(
        "SELECT SUM(price) FROM test GROUP BY quantity ORDER BY quantity ASC"
    )
    groups = {}
    for p, q in zip(test_table["price"], test_table["quantity"]):
        groups[q] = groups.get(q, 0.0) + float(p)
    expected = [groups[k] for k in sorted(groups)]
    assert res == pytest.approx(expected, abs=1e-5)


def test_order_by_desc_limit(db, test_table):
    res = db.query_sql("SELECT price FROM test ORDER BY price DESC LIMIT 2")
    prices = sorted(test_table["price"], reverse=True)
    assert res == pytest.approx(prices[:2], abs=1e-5)


def test_offset_limit(db):
    res = db.query_sql(
        "SELECT price FROM test ORDER BY price DESC OFFSET 1 LIMIT 2"
    )
    assert len(res) == 2
    assert res == pytest.approx([20.0, 15.25], abs=1e-5)


def test_having_sum(db):
    res = db.query_sql(
        "SELECT SUM(price) FROM test GROUP BY quantity "
        "HAVING SUM(price) > 15 ORDER BY quantity ASC"
    )
    assert len(res) == 3
    assert res == pytest.approx([15.25, 20.0, 30.0], abs=1e-5)


# --- having_distinct_test.cpp --------------------------------------------------


def test_having_count_empty(db):
    res = db.query_sql(
        "SELECT SUM(price) FROM test GROUP BY quantity HAVING COUNT(price) > 1"
    )
    assert res == []


def test_aggregate_filter_clause(db):
    # AGG(x) FILTER (WHERE c) — masked mergeable partials (standard).
    res = db.query_sql_table(
        "SELECT COUNT(*) FILTER (WHERE price > 15) AS n, "
        "SUM(price) FILTER (WHERE quantity > 3) AS s, "
        "AVG(price) FILTER (WHERE price > 100) AS a, "
        "MIN(price) FILTER (WHERE quantity < 4) AS lo, "
        "MAX(price) FILTER (WHERE price < 0) AS hi "
        "FROM test"
    )
    # price 10.5/20/15.25/30, quantity 3/4/2/5
    assert list(res["n"]) == [3.0]
    assert list(res["s"]) == [50.0]
    assert math.isnan(res["a"][0])  # zero matches → NULL
    assert list(res["lo"]) == [10.5]
    assert math.isnan(res["hi"][0])


def test_aggregate_filter_grouped(db):
    res = db.query_sql_table(
        "SELECT quantity, COUNT(*) FILTER (WHERE price > 15) "
        "FROM test GROUP BY quantity ORDER BY quantity"
    )
    # quantity 2→15.25 (1), 3→10.5 (0), 4→20 (1), 5→30 (1)
    assert list(list(res.values())[1]) == [1.0, 0.0, 1.0, 1.0]


def test_aggregate_filter_rejects_order_stats(db):
    with pytest.raises(WarpDBError):
        db.query_sql("SELECT MEDIAN(price) FILTER (WHERE price > 1) FROM test")
    with pytest.raises(WarpDBError):
        db.query_sql(
            "SELECT COUNT(DISTINCT price) FILTER (WHERE price > 1) FROM test"
        )


def test_filter_stays_usable_as_identifier():
    q = parse_query_text("SELECT filter FROM t WHERE filter > 1")
    assert q.select_list[0].canonical() == "filter[idx]"


def test_order_by_ordinal(db):
    # ORDER BY 1-based select-list positions (standard).
    res = db.query_sql_table(
        "SELECT quantity, SUM(price) FROM test GROUP BY quantity "
        "ORDER BY 2 DESC"
    )
    totals = list(res.values())[1]
    assert list(totals) == sorted(totals, reverse=True)
    with pytest.raises(WarpDBError):
        db.query_sql("SELECT price FROM test ORDER BY 3")


def test_order_by_nulls_placement(db):
    # Engine defaults match PostgreSQL (NaN last ASC / first DESC);
    # the non-default placements flip via an IS-NULL flag term.
    res = db.query_sql_table(
        "SELECT NULLIF(quantity, 4) AS k FROM test ORDER BY k NULLS FIRST"
    )
    k = list(res.values())[0]
    assert math.isnan(k[0]) and list(k[1:]) == sorted(k[1:])
    res = db.query_sql_table(
        "SELECT NULLIF(quantity, 4) AS k FROM test ORDER BY k DESC NULLS LAST"
    )
    k = list(res.values())[0]
    assert math.isnan(k[-1]) and list(k[:-1]) == sorted(k[:-1], reverse=True)


def test_simple_case_form(db):
    res = db.query_sql_table(
        "SELECT CASE quantity WHEN 3 THEN 30 WHEN 5 THEN 50 ELSE 0 END "
        "FROM test"
    )
    # quantity: 3, 4, 2, 5
    assert list(list(res.values())[0]) == [30.0, 0.0, 0.0, 50.0]


def test_order_by_select_alias(db):
    # Standard output-column resolution: ORDER BY may name a select
    # alias (extension; the reference never connects the two).
    res = db.query_sql_table(
        "SELECT quantity, SUM(price) AS total FROM test "
        "GROUP BY quantity ORDER BY total DESC"
    )
    totals = list(res.values())[1]
    assert list(totals) == sorted(totals, reverse=True)


def test_order_by_alias_plain_projection(db):
    res = db.query_sql_table(
        "SELECT price * quantity AS revenue FROM test ORDER BY revenue"
    )
    rev = list(res.values())[0]
    assert list(rev) == sorted(rev)


def test_order_by_alias_shadows_column(db):
    # Alias wins over the input column of the same name (PostgreSQL
    # output-column rule).
    res = db.query_sql_table(
        "SELECT quantity, price AS quantity_2, quantity AS price "
        "FROM test ORDER BY price"
    )
    q = list(res.values())[0]
    assert list(q) == sorted(q)


def test_group_by_select_alias(db):
    # GROUP BY may name a select alias (PostgreSQL fallback rule:
    # input columns bind first, output aliases second).
    res = db.query_sql_table(
        "SELECT quantity * 2 AS qq, SUM(price) AS s FROM test "
        "GROUP BY qq ORDER BY qq ASC"
    )
    # quantity: 3, 4, 2, 5 — all distinct, doubled.
    assert list(res["qq"]) == [4.0, 6.0, 8.0, 10.0]
    assert list(res["s"]) == [15.25, 10.5, 20.0, 30.0]


def test_group_by_alias_column_wins(db):
    # When the alias name collides with an input column, GROUP BY binds
    # the COLUMN (PostgreSQL: aliases are a fallback only).
    res = db.query_sql_table(
        "SELECT quantity + 100 AS quantity, COUNT(*) AS n FROM test "
        "GROUP BY quantity ORDER BY quantity ASC"
    )
    # Grouped by the raw column (4 distinct values), selected +100.
    assert list(res["quantity"]) == [102.0, 103.0, 104.0, 105.0]
    assert list(res["n"]) == [1.0, 1.0, 1.0, 1.0]


def test_group_by_expression_key_in_select(db):
    # An expression GROUP BY key is referencable by the same expression
    # in SELECT/HAVING/ORDER BY (canonical-form matching).
    res = db.query_sql_table(
        "SELECT quantity * 2, SUM(price) FROM test "
        "GROUP BY quantity * 2 HAVING quantity * 2 > 4 "
        "ORDER BY quantity * 2 DESC"
    )
    assert list(list(res.values())[0]) == [10.0, 8.0, 6.0]


def test_distinct_order_desc(db):
    res = db.query_sql("SELECT DISTINCT quantity FROM test ORDER BY quantity DESC")
    assert len(res) == 4
    assert res[0] > res[-1]
    assert res == sorted(res, reverse=True)


def test_distinct_multi_column(random_db):
    # SELECT DISTINCT a, b rewrites to GROUP BY a, b (device-side dedup);
    # rows come back lexicographically ascending.
    db, table = random_db
    res = db.query_sql_table(
        "SELECT DISTINCT quantity, quantity / 4 FROM t WHERE price > 50"
    )
    cols = list(res.values())
    got = sorted(zip(*[np.asarray(c, np.float32) for c in cols]))
    q = table["quantity"][table["price"] > 50]
    exp = sorted({(float(x), float(np.float32(x) / np.float32(4))) for x in q})
    assert got == pytest.approx(exp)
    # Lexicographic ascending default order.
    assert got == list(zip(*[np.asarray(c, np.float32) for c in cols]))


def test_distinct_multi_column_order_limit(random_db):
    db, _ = random_db
    res = db.query_sql_table(
        "SELECT DISTINCT quantity, quantity * 2 FROM t "
        "ORDER BY quantity DESC LIMIT 3"
    )
    q = np.asarray(list(res.values())[0], np.float32)
    assert q.tolist() == [19.0, 18.0, 17.0]


def test_distinct_duplicate_select_items(db):
    # Duplicate expressions collapse to one group key but both columns ship.
    res = db.query_sql_table("SELECT DISTINCT quantity, quantity FROM test")
    cols = list(res.values())
    assert len(cols) == 2
    assert np.asarray(cols[0]).tolist() == np.asarray(cols[1]).tolist()
    assert np.asarray(cols[0]).tolist() == [2.0, 3.0, 4.0, 5.0]


def test_distinct_over_grouped_aggregate(random_db):
    # DISTINCT over aggregate outputs dedups the finished O(groups) rows.
    db, table = random_db
    got = np.asarray(
        db.query_sql("SELECT DISTINCT COUNT(price) FROM t GROUP BY quantity"),
        np.float32,
    )
    counts = {
        float(np.sum(table["quantity"] == g))
        for g in np.unique(table["quantity"])
    }
    assert sorted(got.tolist()) == sorted(counts)
    assert got.tolist() == sorted(got.tolist())  # ascending default


def test_distinct_grouped_multi_item_ordered(random_db):
    db, table = random_db
    res = db.query_sql_table(
        "SELECT DISTINCT quantity, COUNT(*) FROM t GROUP BY quantity "
        "ORDER BY quantity DESC LIMIT 5"
    )
    q = np.asarray(list(res.values())[0], np.float32)
    c = np.asarray(list(res.values())[1], np.float32)
    assert q.tolist() == [19.0, 18.0, 17.0, 16.0, 15.0]
    exp = [float(np.sum(table["quantity"] == g)) for g in q]
    assert c.tolist() == exp


# --- extended_types_test.cpp -----------------------------------------------------


def test_extended_types():
    schema = [DataType.FLOAT32, DataType.INT32, DataType.FLOAT32]
    db = WarpDB("data/extended.csv", schema)
    res = db.query("price * discount")
    assert len(res) == 4
    assert int(res[0]) == 1  # 10.5 * 0.1 ≈ 1.05


# --- more aggregates ------------------------------------------------------------


@pytest.mark.parametrize("agg", ["SUM", "AVG", "COUNT", "MIN", "MAX"])
def test_all_aggregates_vs_oracle(db, test_table, agg):
    sql = f"SELECT {agg}(price) FROM test GROUP BY quantity ORDER BY quantity ASC"
    got = db.query_sql(sql)
    want = oracle.query_sql(test_table, parse_query_text(sql))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("agg", ["SUM", "AVG", "COUNT", "MIN", "MAX"])
def test_global_aggregate(db, test_table, agg):
    sql = f"SELECT {agg}(price * quantity) FROM test"
    got = db.query_sql(sql)
    want = oracle.query_sql(test_table, parse_query_text(sql))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_group_by_with_where(db, test_table):
    sql = (
        "SELECT SUM(price) FROM test WHERE price > 12 "
        "GROUP BY quantity ORDER BY quantity ASC"
    )
    got = db.query_sql(sql)
    want = oracle.query_sql(test_table, parse_query_text(sql))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_order_by_aggregate(db, test_table):
    sql = "SELECT SUM(price) FROM test GROUP BY quantity ORDER BY SUM(price) DESC"
    got = db.query_sql(sql)
    want = oracle.query_sql(test_table, parse_query_text(sql))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_non_group_where_filters_rows(db, test_table):
    sql = "SELECT price FROM test WHERE quantity > 2"
    got = db.query_sql(sql)
    want = oracle.query_sql(test_table, parse_query_text(sql))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert len(got) == 3  # compacted, unlike query()


# --- randomized oracle sweep -----------------------------------------------------


@pytest.fixture(scope="module")
def random_db():
    rng = np.random.default_rng(42)
    n = 5000
    table = {
        "price": rng.uniform(0, 100, n).astype(np.float32),
        "quantity": rng.integers(0, 20, n).astype(np.float32),
    }
    host = HostTable.from_dict(table)
    return WarpDB(host), table


RANDOM_SQL = [
    "SELECT SUM(price) FROM t GROUP BY quantity ORDER BY quantity ASC",
    "SELECT AVG(price) FROM t GROUP BY quantity ORDER BY quantity DESC",
    "SELECT COUNT(price) FROM t WHERE price > 50 GROUP BY quantity ORDER BY quantity ASC",
    "SELECT MAX(price * quantity) FROM t GROUP BY quantity ORDER BY quantity ASC",
    "SELECT MIN(price) FROM t GROUP BY quantity HAVING COUNT(price) > 200 ORDER BY quantity ASC",
    "SELECT price FROM t WHERE price > 90 ORDER BY price DESC LIMIT 10",
    "SELECT price * quantity FROM t WHERE quantity == 5 ORDER BY price ASC LIMIT 7 OFFSET 3",
    "SELECT DISTINCT quantity FROM t ORDER BY quantity DESC",
    "SELECT price FROM t WHERE price > 99.5",
    "SELECT SUM(price) FROM t GROUP BY quantity HAVING SUM(price) > 12000 ORDER BY SUM(price) ASC",
]


@pytest.mark.parametrize("sql", RANDOM_SQL)
def test_random_sql_vs_oracle(random_db, sql):
    db, table = random_db
    got = np.asarray(db.query_sql(sql), dtype=np.float32)
    want = oracle.query_sql(table, parse_query_text(sql))
    np.testing.assert_allclose(got, want, rtol=1e-4)


# --- JOIN execution (exceeds reference) --------------------------------------------


def test_self_join(db):
    # Self-join on quantity: every row matches exactly itself (unique keys).
    res = db.query_sql(
        "SELECT price FROM test JOIN test ON quantity = test.quantity "
        "ORDER BY price ASC"
    )
    assert res == pytest.approx([10.5, 15.25, 20.0, 30.0], abs=1e-5)


def test_registered_join():
    db = WarpDB("data/test.csv")
    items = HostTable.from_dict(
        {
            "qty": np.array([2.0, 3.0, 4.0, 5.0, 7.0], np.float32),
            "weight": np.array([1.0, 2.0, 3.0, 4.0, 9.0], np.float32),
        }
    )
    db.register_table("items", items)
    res = db.query_sql(
        "SELECT price * items.weight FROM test JOIN items ON quantity = items.qty "
        "ORDER BY price ASC"
    )
    # matches: (10.5,q3,w2), (15.25,q2,w1), (20,q4,w3), (30,q5,w4)
    assert res == pytest.approx([21.0, 15.25, 60.0, 120.0], abs=1e-4)


def test_join_with_duplicates():
    left = HostTable.from_dict(
        {"k": np.array([1.0, 2.0, 2.0], np.float32),
         "v": np.array([10.0, 20.0, 30.0], np.float32)}
    )
    right = HostTable.from_dict(
        {"k": np.array([2.0, 2.0, 3.0], np.float32),
         "w": np.array([100.0, 200.0, 300.0], np.float32)}
    )
    db = WarpDB(left)
    db.register_table("r", right)
    res = db.query_sql(
        "SELECT v + r.w FROM table JOIN r ON k = r.k ORDER BY v + r.w ASC"
    )
    # rows 2 & 3 each match both right rows: 20+100,20+200,30+100,30+200
    assert res == pytest.approx([120.0, 130.0, 220.0, 230.0], abs=1e-4)


# --- window functions (reference parses only; we execute) ---------------------------


def test_window_sum_over_partition(db, test_table):
    sql = "SELECT SUM(price) OVER (PARTITION BY quantity) FROM test"
    got = db.query_sql(sql)
    want = oracle.query_sql(test_table, parse_query_text(sql))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_window_no_partition(db, test_table):
    sql = "SELECT SUM(price) OVER () FROM test"
    got = db.query_sql(sql)
    # single partition: every row gets the global sum
    np.testing.assert_allclose(got, [75.75] * 4, rtol=1e-5)


def test_window_with_duplicates():
    table = {
        "price": np.array([1.0, 2.0, 3.0, 4.0, 5.0, 6.0], np.float32),
        "quantity": np.array([1.0, 1.0, 2.0, 2.0, 2.0, 3.0], np.float32),
    }
    db = WarpDB(HostTable.from_dict(table))
    got = db.query_sql("SELECT AVG(price) OVER (PARTITION BY quantity) FROM table")
    np.testing.assert_allclose(got, [1.5, 1.5, 4.0, 4.0, 4.0, 6.0], rtol=1e-6)


# --- SQL error paths ------------------------------------------------------------------


def test_sql_parse_error_wrapped(db):
    with pytest.raises(ParseError, match="Failed to parse SQL"):
        db.query_sql("SELECT price")


def test_sql_unknown_column_context(db):
    with pytest.raises(ValidationError, match="SELECT clause: Unknown column"):
        db.query_sql("SELECT bogus FROM test")
    with pytest.raises(ValidationError, match="GROUP BY: Unknown column"):
        db.query_sql("SELECT SUM(price) FROM test GROUP BY bogus")


def test_group_by_requires_group_level_select(db):
    # A select item that is neither the group key nor an aggregate is
    # rejected (it has no single value per group).
    from warpdb_tpu.errors import UnsupportedError

    with pytest.raises(UnsupportedError, match="GROUP BY key or aggregates"):
        db.query_sql("SELECT price FROM test GROUP BY quantity")


# --- jit cache behavior ------------------------------------------------------------


def test_kernel_cache_hit(db):
    from warpdb_tpu.engine.compiler import cache_stats

    db.query("price + 2")
    before = cache_stats()
    db.query("price + 2")
    after = cache_stats()
    assert after["hits"] > before["hits"]
    assert after["misses"] == before["misses"]


def test_udf_custom_py(db):
    # custom.py at repo root defines discount() — the custom.cu analogue.
    res = db.query("discount(price, 0.5)")
    assert res == pytest.approx([5.25, 10.0, 7.625, 15.0], abs=1e-5)


# --- sort-path coverage (dense fast path must not steal these) ---------------


def test_group_by_fractional_keys():
    """Fractional keys defeat the dense integer path → sort path."""
    table = {
        "price": np.array([1.0, 2.0, 3.0, 4.0], np.float32),
        "k": np.array([0.5, 1.5, 0.5, 2.5], np.float32),
    }
    db = WarpDB(HostTable.from_dict(table))
    res = db.query_sql("SELECT SUM(price) FROM t GROUP BY k ORDER BY k ASC")
    assert res == pytest.approx([4.0, 2.0, 4.0])


def test_group_by_wide_range_keys():
    """Key span > midrange-slot limit → sort path."""
    rng = np.random.default_rng(5)
    n = 3000
    keys = rng.integers(0, 10_000_000, n).astype(np.float32)
    vals = rng.uniform(0, 10, n).astype(np.float32)
    db = WarpDB(HostTable.from_dict({"v": vals, "k": keys}))
    res = np.asarray(db.query_sql("SELECT SUM(v) FROM t GROUP BY k ORDER BY k ASC"))
    uniq = np.sort(np.unique(keys))
    want = np.array([vals[keys == k].sum() for k in uniq], np.float32)
    assert len(res) == len(uniq)
    np.testing.assert_allclose(res, want, rtol=1e-4)


def test_dense_path_selected_for_int_range():
    """Verify the dense kernel actually handles the stats-bounded case."""
    from warpdb_tpu.engine.executor import _try_dense_group
    from warpdb_tpu.frontend import parse_query_text

    db = WarpDB("data/test.csv")
    q = parse_query_text("SELECT SUM(price) FROM test GROUP BY quantity")
    res = _try_dense_group(
        q, db.table, list(q.group_by.keys),
        [q.select_list[0].expr], [q.select_list[0].expr.canonical()], ""
    )
    assert res is not None
    assert res.num_groups == 4
    np.testing.assert_allclose(res.keys[0], [2.0, 3.0, 4.0, 5.0])
    np.testing.assert_allclose(res.values[0][0], [15.25, 10.5, 20.0, 30.0])


# --- multi-key GROUP BY and multi-column results -------------------------------


def test_multi_key_group_by():
    table = {
        "a": np.array([1, 1, 2, 2, 1, 2], np.float32),
        "b": np.array([1, 2, 1, 1, 1, 2], np.float32),
        "v": np.array([10, 20, 30, 40, 50, 60], np.float32),
    }
    db = WarpDB(HostTable.from_dict(table))
    res = db.query_sql("SELECT SUM(v) FROM t GROUP BY a, b")
    # groups (a,b): (1,1)=60, (1,2)=20, (2,1)=70, (2,2)=60 — key-ascending
    assert res == pytest.approx([60.0, 20.0, 70.0, 60.0])


def test_query_sql_table_multi_column(db):
    out = db.query_sql_table(
        "SELECT price, quantity FROM test WHERE price > 12 ORDER BY price ASC"
    )
    assert out["price"] == pytest.approx([15.25, 20.0, 30.0])
    assert out["quantity"] == pytest.approx([2.0, 4.0, 5.0])


def test_join_then_group():
    left = HostTable.from_dict(
        {"k": np.array([1, 1, 2, 2], np.float32),
         "v": np.array([1.0, 2.0, 3.0, 4.0], np.float32)}
    )
    right = HostTable.from_dict(
        {"k": np.array([1, 2], np.float32),
         "w": np.array([10.0, 100.0], np.float32)}
    )
    db = WarpDB(left)
    db.register_table("r", right)
    res = db.query_sql(
        "SELECT SUM(v * r.w) FROM table JOIN r ON k = r.k GROUP BY k "
        "ORDER BY k ASC"
    )
    assert res == pytest.approx([30.0, 700.0])


def test_having_alias(db):
    # HAVING may reference select aliases (MySQL/DuckDB convenience);
    # inside aggregate arguments the input column wins.
    res = db.query_sql_table(
        "SELECT quantity, SUM(price) AS total FROM test "
        "GROUP BY quantity HAVING total > 16 ORDER BY total"
    )
    assert list(zip(*res.values())) == [(4.0, 20.0), (5.0, 30.0)]
    res = db.query_sql_table(
        "SELECT quantity AS price, SUM(price) AS s FROM test "
        "GROUP BY quantity HAVING SUM(price) > 16 ORDER BY s"
    )
    # SUM(price) aggregates the COLUMN price, not the alias.
    assert list(zip(*res.values())) == [(4.0, 20.0), (5.0, 30.0)]


def test_implicit_comma_join():
    """FROM a, b WHERE a.k = b.k (SQL-89): equality conjuncts lift out
    of WHERE into INNER equi-join conditions; residue stays in WHERE."""
    rng = np.random.default_rng(31)
    n = 6000
    k = rng.integers(0, 16, n).astype(np.float32)
    p = rng.uniform(0, 100, n).astype(np.float32)
    db = WarpDB(HostTable.from_dict({"k": k, "p": p}))
    db.register_table(
        "d",
        HostTable.from_dict(
            {
                "k": np.arange(16, dtype=np.float32),
                "w": (np.arange(16) * 3.0).astype(np.float32),
            }
        ),
    )
    a = db.query_sql_table(
        "SELECT p, w FROM t, d WHERE t.k = d.k AND p > 80 "
        "ORDER BY p DESC LIMIT 10"
    )
    b = db.query_sql_table(
        "SELECT p, w FROM t JOIN d ON t.k = d.k WHERE p > 80 "
        "ORDER BY p DESC LIMIT 10"
    )
    assert list(zip(*a.values())) == list(zip(*b.values()))
    # The plan actually lifts (no cartesian product).
    plan = db.explain("SELECT p, w FROM t, d WHERE t.k = d.k")
    assert "inner equi-join" in plan and "cross join" not in plan
    # Three relations chain left-to-right.
    db.register_table(
        "e",
        HostTable.from_dict(
            {
                "w": (np.arange(16) * 3.0).astype(np.float32),
                "z": np.arange(16, dtype=np.float32),
            }
        ),
    )
    out = db.query_sql_table(
        "SELECT k, z FROM t, d, e WHERE t.k = d.k AND d.w = e.w "
        "ORDER BY p LIMIT 3"
    )
    kk, zz = list(out.values())
    assert list(kk) == list(zz)  # z == w/3 == k by construction


def test_implicit_join_without_condition_is_cartesian():
    db = WarpDB(
        HostTable.from_dict({"a": np.array([1.0, 2.0], np.float32)})
    )
    db.register_table(
        "u", HostTable.from_dict({"b": np.array([10.0, 20.0, 30.0], np.float32)})
    )
    out = db.query_sql_table("SELECT a, b FROM t, u ORDER BY a, b")
    assert len(list(out.values())[0]) == 6  # 2 x 3 product


def test_create_table_as_and_drop():
    db = WarpDB("data/test.csv")
    assert db.query_sql_table(
        "CREATE TABLE summary AS SELECT quantity, SUM(price) AS total "
        "FROM test GROUP BY quantity"
    ) == {}
    out = db.query_sql_table(
        "SELECT quantity, total FROM summary ORDER BY total DESC LIMIT 2"
    )
    assert list(zip(*out.values())) == [(5.0, 30.0), (4.0, 20.0)]
    # The created table joins like any registered relation.
    out = db.query_sql_table(
        "SELECT t.price, s.total FROM test t JOIN summary s "
        "ON t.quantity = s.quantity ORDER BY t.price LIMIT 1"
    )
    assert list(zip(*out.values())) == [(10.5, 10.5)]
    # CREATE VIEW is a synonym (tables are immutable, so a lazily
    # evaluated view could never diverge from its defining query).
    db.query_sql("CREATE VIEW v AS SELECT price FROM test WHERE price > 15")
    assert db.query_sql("SELECT price FROM v ORDER BY price") == [
        15.25, 20.0, 30.0,
    ]
    db.query_sql("DROP TABLE summary")
    db.query_sql("DROP VIEW v")
    with pytest.raises(WarpDBError):
        db.query_sql("DROP TABLE summary")  # already gone
    db.query_sql("DROP TABLE IF EXISTS summary")  # idempotent


def test_create_table_as_string_columns():
    db = WarpDB(
        HostTable.from_dict(
            {
                "name": np.array(["b", "a", "b"], dtype=object),
                "v": np.array([1.0, 2.0, 3.0], np.float32),
            }
        )
    )
    db.query_sql(
        "CREATE TABLE agg AS SELECT name, SUM(v) AS s FROM t GROUP BY name"
    )
    out = db.query_sql_table("SELECT name, s FROM agg ORDER BY name")
    assert list(out.values())[0] == ["a", "b"]
    assert list(out.values())[1] == [2.0, 4.0]


def test_create_over_base_table_rejected():
    db = WarpDB("data/test.csv")
    with pytest.raises(WarpDBError):
        db.query_sql("CREATE TABLE test AS SELECT price FROM test")


def test_cli_repl(capsys, monkeypatch):
    from warpdb_tpu.__main__ import main

    lines = iter(
        [
            "SELECT quantity, SUM(price) AS total FROM test "
            "GROUP BY quantity ORDER BY total DESC",
            ".tables",
            ".schema",
            ".explain SELECT SUM(price) FROM test GROUP BY quantity",
            ".quit",
        ]
    )
    monkeypatch.setattr("builtins.input", lambda prompt="": next(lines))
    rc = main(["--repl", "data/test.csv"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "quantity" in out and "total" in out
    assert "(4 rows)" in out
    assert "test" in out  # .tables
    assert "FLOAT32" in out  # .schema
    assert "Plan for:" in out  # .explain


def test_cli_demo(capsys):
    from warpdb_tpu.__main__ import main

    rc = main(["--demo", "price * quantity", "data/test.csv"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Row 0:" in out
    assert "Filtered rows (price > 25.0): 1" in out
    assert "Revenue[0] = 31.5" in out
    assert "demo done" in out


def test_window_running_sum():
    from warpdb_tpu.frontend import parse_query_text
    from warpdb_tpu.engine.executor import run_query
    from warpdb_tpu.storage import DeviceTable

    table = {
        "price": np.array([1.0, 2.0, 3.0, 4.0, 5.0, 6.0], np.float32),
        "quantity": np.array([1.0, 1.0, 2.0, 2.0, 1.0, 2.0], np.float32),
    }
    db = WarpDB(HostTable.from_dict(table))
    got = db.query_sql(
        "SELECT SUM(price) OVER (PARTITION BY quantity ORDER BY price ASC) FROM t"
    )
    # partition q=1: prices 1,2,5 → running 1,3,8 ; q=2: 3,4,6 → 3,7,13
    assert got == pytest.approx([1.0, 3.0, 3.0, 7.0, 8.0, 13.0])


def test_window_running_avg_count():
    table = {
        "v": np.array([10.0, 20.0, 30.0], np.float32),
        "p": np.array([1.0, 1.0, 1.0], np.float32),
    }
    db = WarpDB(HostTable.from_dict(table))
    got = db.query_sql("SELECT COUNT(v) OVER (PARTITION BY p ORDER BY v ASC) FROM t")
    assert got == pytest.approx([1.0, 2.0, 3.0])
    got2 = db.query_sql("SELECT AVG(v) OVER (PARTITION BY p ORDER BY v ASC) FROM t")
    assert got2 == pytest.approx([10.0, 15.0, 20.0])


def _frame_oracle(k, v, t, prec, foll, agg, where=None, descending=False):
    """Naive per-partition ROWS-frame oracle (row-at-a-time numpy)."""
    n = len(k)
    sel = np.ones(n, bool) if where is None else where
    idxs = np.nonzero(sel)[0]
    kk, vv, tt = k[idxs], v[idxs], t[idxs]
    res = np.zeros(len(idxs), np.float32)
    for part in np.unique(kk):
        pidx = np.nonzero(kk == part)[0]
        key = -tt[pidx] if descending else tt[pidx]
        order = pidx[np.argsort(key, kind="stable")]
        for r, i in enumerate(order):
            lo = 0 if prec is None else max(0, r - prec)
            hi = len(order) - 1 if foll is None else min(
                len(order) - 1, r + foll
            )
            w = vv[order[lo:hi + 1]]
            res[i] = {
                "sum": np.sum, "min": np.min, "max": np.max,
                "avg": np.mean, "count": len,
            }[agg](w)
    return res


def test_window_rows_frames():
    """ROWS BETWEEN frames: every agg, every bound shape, vs a naive
    oracle.  The engine computes these as differences of segmented
    cumsums (SUM/COUNT/AVG) or sparse-table doubling (MIN/MAX) — see
    ops/aggregate.window_frame."""
    rng = np.random.default_rng(17)
    n = 300
    k = rng.integers(0, 6, n).astype(np.float32)
    v = rng.normal(10, 3, n).astype(np.float32)
    t = rng.permutation(n).astype(np.float32)
    db = WarpDB(HostTable.from_dict({"k": k, "v": v, "t": t}))

    cases = [
        ("SUM", "BETWEEN 3 PRECEDING AND CURRENT ROW", 3, 0),
        ("AVG", "BETWEEN 2 PRECEDING AND 2 FOLLOWING", 2, 2),
        ("MIN", "BETWEEN 5 PRECEDING AND 1 FOLLOWING", 5, 1),
        ("MAX", "BETWEEN UNBOUNDED PRECEDING AND 2 FOLLOWING", None, 2),
        ("COUNT", "BETWEEN CURRENT ROW AND UNBOUNDED FOLLOWING", 0, None),
        ("SUM", "BETWEEN CURRENT ROW AND CURRENT ROW", 0, 0),
        ("MIN", "BETWEEN UNBOUNDED PRECEDING AND UNBOUNDED FOLLOWING",
         None, None),
    ]
    for agg, frame, prec, foll in cases:
        sql = (
            f"SELECT {agg}(v) OVER (PARTITION BY k ORDER BY t "
            f"ROWS {frame}) FROM t"
        )
        got = np.asarray(db.query_sql(sql), dtype=np.float32)
        want = _frame_oracle(k, v, t, prec, foll, agg.lower())
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4,
                                   err_msg=sql)

    # Shorthand ROWS <n> PRECEDING ≡ BETWEEN <n> PRECEDING AND CURRENT ROW
    got = np.asarray(db.query_sql(
        "SELECT MAX(v) OVER (PARTITION BY k ORDER BY t ROWS 7 PRECEDING)"
        " FROM t"
    ), dtype=np.float32)
    np.testing.assert_allclose(
        got, _frame_oracle(k, v, t, 7, 0, "max"), rtol=1e-4, atol=1e-4
    )

    # No partition: one global frame sequence.
    got = np.asarray(db.query_sql(
        "SELECT AVG(v) OVER (ORDER BY t ROWS BETWEEN 4 PRECEDING AND"
        " CURRENT ROW) FROM t"
    ), dtype=np.float32)
    want = _frame_oracle(np.zeros(n, np.float32), v, t, 4, 0, "avg")
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

    # WHERE: filtered rows occupy no frame positions; O(matches) result.
    where = v > 9
    got = np.asarray(db.query_sql(
        "SELECT SUM(v) OVER (PARTITION BY k ORDER BY t ROWS BETWEEN"
        " 2 PRECEDING AND 1 FOLLOWING) FROM t WHERE v > 9"
    ), dtype=np.float32)
    want = _frame_oracle(k, v, t, 2, 1, "sum", where=where)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

    # DESC ordering reverses the frame direction.
    got = np.asarray(db.query_sql(
        "SELECT SUM(v) OVER (PARTITION BY k ORDER BY t DESC ROWS BETWEEN"
        " 3 PRECEDING AND CURRENT ROW) FROM t"
    ), dtype=np.float32)
    want = _frame_oracle(k, v, t, 3, 0, "sum", descending=True)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_fuzz_window_rows_frames():
    """Randomised frame bounds × aggs × filters vs the naive oracle."""
    for seed in range(8):
        rng = np.random.default_rng(9100 + seed)
        n = int(rng.integers(50, 400))
        k = rng.integers(0, int(rng.integers(1, 8)), n).astype(np.float32)
        v = rng.normal(0, 50, n).astype(np.float32)
        t = rng.permutation(n).astype(np.float32)
        db = WarpDB(HostTable.from_dict({"k": k, "v": v, "t": t}))
        agg = str(rng.choice(["SUM", "AVG", "COUNT", "MIN", "MAX"]))
        prec = (
            None if rng.uniform() < 0.2 else int(rng.integers(0, 12))
        )
        foll = (
            None if rng.uniform() < 0.2 else int(rng.integers(0, 12))
        )
        lo = "UNBOUNDED PRECEDING" if prec is None else (
            "CURRENT ROW" if prec == 0 else f"{prec} PRECEDING"
        )
        hi = "UNBOUNDED FOLLOWING" if foll is None else (
            "CURRENT ROW" if foll == 0 else f"{foll} FOLLOWING"
        )
        where = rng.uniform() < 0.4
        sql = (
            f"SELECT {agg}(v) OVER (PARTITION BY k ORDER BY t "
            f"ROWS BETWEEN {lo} AND {hi}) FROM t"
        )
        mask = None
        if where:
            sql += " WHERE v > 0"
            mask = v > 0
        got = np.asarray(db.query_sql(sql), dtype=np.float32)
        want = _frame_oracle(k, v, t, prec, foll, agg.lower(), where=mask)
        np.testing.assert_allclose(
            got, want, rtol=1e-3, atol=1e-3, err_msg=f"seed {seed}: {sql}"
        )


def _range_oracle(k, v, t, prec, foll, agg, where=None, descending=False):
    """Naive per-partition RANGE-frame oracle: row j is in row i's frame
    iff its order key lies within [o_i − prec, o_i + foll] (value
    distance; peers always included)."""
    n = len(k)
    sel = np.ones(n, bool) if where is None else where
    idxs = np.nonzero(sel)[0]
    kk, vv, tt = k[idxs], v[idxs], t[idxs]
    res = np.zeros(len(idxs), np.float32)
    fns = {"sum": np.sum, "min": np.min, "max": np.max, "avg": np.mean,
           "count": len}
    for part in np.unique(kk):
        pidx = np.nonzero(kk == part)[0]
        for i in pidx:
            o = tt[i]
            if descending:
                lo = -np.inf if foll is None else o - foll
                hi = np.inf if prec is None else o + prec
            else:
                lo = -np.inf if prec is None else o - prec
                hi = np.inf if foll is None else o + foll
            m = (tt[pidx] >= lo) & (tt[pidx] <= hi)
            w = vv[pidx[m]]
            res[i] = fns[agg](w)
    return res


def test_window_range_frames():
    """RANGE BETWEEN frames (order-key-value distances, peers included):
    every agg, every bound shape, vs a naive oracle.  The engine ranks
    per-row value bounds with one merged 3n sort and differences running
    sums (SUM/COUNT/AVG) or answers rank intervals from a sparse table
    (MIN/MAX) — see ops/aggregate.window_range_frame."""
    rng = np.random.default_rng(31)
    n = 300
    k = rng.integers(0, 5, n).astype(np.float32)
    v = rng.normal(10, 3, n).astype(np.float32)
    t = (rng.random(n) * 50).round(1).astype(np.float32)
    db = WarpDB(HostTable.from_dict({"k": k, "v": v, "t": t}))

    cases = [
        ("SUM", "BETWEEN 3 PRECEDING AND CURRENT ROW", 3.0, 0.0),
        ("AVG", "BETWEEN 2.5 PRECEDING AND 2.5 FOLLOWING", 2.5, 2.5),
        ("MIN", "BETWEEN 5 PRECEDING AND 1 FOLLOWING", 5.0, 1.0),
        ("MAX", "BETWEEN UNBOUNDED PRECEDING AND 2 FOLLOWING", None, 2.0),
        ("COUNT", "BETWEEN CURRENT ROW AND UNBOUNDED FOLLOWING", 0.0, None),
        ("SUM", "BETWEEN CURRENT ROW AND CURRENT ROW", 0.0, 0.0),
    ]
    for agg, frame, prec, foll in cases:
        sql = (
            f"SELECT {agg}(v) OVER (PARTITION BY k ORDER BY t "
            f"RANGE {frame}) FROM t"
        )
        got = np.asarray(db.query_sql(sql), dtype=np.float32)
        want = _range_oracle(k, v, t, prec, foll, agg.lower())
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3,
                                   err_msg=sql)

    # DESC reverses which offset extends toward smaller values.
    got = np.asarray(db.query_sql(
        "SELECT SUM(v) OVER (PARTITION BY k ORDER BY t DESC "
        "RANGE 3 PRECEDING) FROM t"
    ), dtype=np.float32)
    want = _range_oracle(k, v, t, 3.0, 0.0, "sum", descending=True)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)

    # WHERE: filtered rows occupy no frame positions.
    got = np.asarray(db.query_sql(
        "SELECT AVG(v) OVER (PARTITION BY k ORDER BY t "
        "RANGE BETWEEN 4 PRECEDING AND 4 FOLLOWING) FROM t WHERE v > 9"
    ), dtype=np.float32)
    want = _range_oracle(k, v, t, 4.0, 4.0, "avg", where=v > 9)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)

    # Peers: tied order keys are always inside each other's frame —
    # CURRENT ROW..CURRENT ROW counts the whole tie group.
    t2 = np.repeat(np.arange(30), 10).astype(np.float32)[:n]
    db2 = WarpDB(HostTable.from_dict({"v": v, "t": t2}))
    got = np.asarray(db2.query_sql(
        "SELECT COUNT(v) OVER (ORDER BY t RANGE BETWEEN CURRENT ROW "
        "AND CURRENT ROW) FROM t"
    ), dtype=np.float32)
    want = _range_oracle(np.zeros(n, np.float32), v, t2, 0.0, 0.0, "count")
    np.testing.assert_allclose(got, want)

    # NaN order keys form one peer group (engine's pinned NaN grouping).
    t3 = t.copy()
    t3[:40] = np.nan
    db3 = WarpDB(HostTable.from_dict({"v": v, "t": t3}))
    got = np.asarray(db3.query_sql(
        "SELECT COUNT(v) OVER (ORDER BY t RANGE 1 PRECEDING) FROM t"
    ), dtype=np.float32)
    nan_rows = np.isnan(t3)
    assert np.all(got[nan_rows] == 40.0)
    fin = ~nan_rows
    want_fin = _range_oracle(
        np.zeros(fin.sum(), np.float32), v[fin], t3[fin], 1.0, 0.0, "count"
    )
    np.testing.assert_allclose(got[fin], want_fin)


def test_fuzz_window_range_frames():
    """Randomised RANGE bounds × aggs × filters vs the naive oracle."""
    for seed in range(8):
        rng = np.random.default_rng(9400 + seed)
        n = int(rng.integers(50, 400))
        k = rng.integers(0, int(rng.integers(1, 8)), n).astype(np.float32)
        v = rng.normal(0, 50, n).astype(np.float32)
        t = (rng.random(n) * 40).round(1).astype(np.float32)
        db = WarpDB(HostTable.from_dict({"k": k, "v": v, "t": t}))
        agg = str(rng.choice(["SUM", "AVG", "COUNT", "MIN", "MAX"]))
        prec = (
            None if rng.uniform() < 0.2
            else float(rng.integers(0, 24)) / 2.0
        )
        foll = (
            None if rng.uniform() < 0.2
            else float(rng.integers(0, 24)) / 2.0
        )
        lo = "UNBOUNDED PRECEDING" if prec is None else (
            "CURRENT ROW" if prec == 0 else f"{prec} PRECEDING"
        )
        hi = "UNBOUNDED FOLLOWING" if foll is None else (
            "CURRENT ROW" if foll == 0 else f"{foll} FOLLOWING"
        )
        desc = rng.uniform() < 0.3
        sql = (
            f"SELECT {agg}(v) OVER (PARTITION BY k ORDER BY t "
            f"{'DESC ' if desc else ''}RANGE BETWEEN {lo} AND {hi}) FROM t"
        )
        mask = None
        if rng.uniform() < 0.4:
            sql += " WHERE v > 0"
            mask = v > 0
        got = np.asarray(db.query_sql(sql), dtype=np.float32)
        want = _range_oracle(k, v, t, prec, foll, agg.lower(), where=mask,
                             descending=desc)
        np.testing.assert_allclose(
            got, want, rtol=1e-3, atol=1e-3, err_msg=f"seed {seed}: {sql}"
        )


def _groups_oracle(k, v, t, prec, foll, agg, descending=False):
    """Naive GROUPS-frame oracle: row j is in row i's frame iff its peer
    group (dense rank of the order key within the partition) lies within
    ``prec`` groups before / ``foll`` groups after row i's group."""
    n = len(k)
    res = np.zeros(n, np.float32)
    fns = {"sum": np.sum, "min": np.min, "max": np.max, "avg": np.mean,
           "count": len}
    for part in np.unique(k):
        pidx = np.nonzero(k == part)[0]
        uniq = sorted(set(t[pidx].tolist()), reverse=descending)
        rank = {val: r for r, val in enumerate(uniq)}
        pranks = np.array([rank[x] for x in t[pidx]])
        for j, i in enumerate(pidx):
            lo = -np.inf if prec is None else pranks[j] - prec
            hi = np.inf if foll is None else pranks[j] + foll
            m = (pranks >= lo) & (pranks <= hi)
            res[i] = fns[agg](v[pidx[m]])
    return res


def test_window_groups_frames():
    """GROUPS BETWEEN frames (SQL:2011 — bounds count peer groups):
    every agg and bound shape vs a naive oracle.  The engine lowers
    GROUPS to a RANGE frame over the order key's dense rank."""
    rng = np.random.default_rng(77)
    n = 300
    k = rng.integers(0, 5, n).astype(np.float32)
    v = rng.normal(10, 3, n).astype(np.float32)
    # Coarse order keys so peer groups have real width.
    t = rng.integers(0, 15, n).astype(np.float32)
    db = WarpDB(HostTable.from_dict({"k": k, "v": v, "t": t}))

    cases = [
        ("SUM", "BETWEEN 1 PRECEDING AND 1 FOLLOWING", 1, 1),
        ("AVG", "BETWEEN 2 PRECEDING AND CURRENT ROW", 2, 0),
        ("MIN", "BETWEEN CURRENT ROW AND 2 FOLLOWING", 0, 2),
        ("MAX", "BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW", None, 0),
        ("COUNT", "BETWEEN CURRENT ROW AND UNBOUNDED FOLLOWING", 0, None),
        ("COUNT", "BETWEEN CURRENT ROW AND CURRENT ROW", 0, 0),
    ]
    for agg, frame, prec, foll in cases:
        sql = (
            f"SELECT {agg}(v) OVER (PARTITION BY k ORDER BY t "
            f"GROUPS {frame}) FROM t"
        )
        got = np.asarray(db.query_sql(sql), dtype=np.float32)
        want = _groups_oracle(k, v, t, prec, foll, agg.lower())
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3,
                                   err_msg=sql)

    # DESC: PRECEDING now walks toward larger order keys.
    got = np.asarray(db.query_sql(
        "SELECT SUM(v) OVER (PARTITION BY k ORDER BY t DESC "
        "GROUPS 1 PRECEDING) FROM t"
    ), dtype=np.float32)
    want = _groups_oracle(k, v, t, 1, 0, "sum", descending=True)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)

    # GROUPS requires an ORDER BY (SQL:2011; rank is undefined without).
    with pytest.raises(ParseError, match="GROUPS mode requires"):
        db.query_sql("SELECT SUM(v) OVER (PARTITION BY k GROUPS "
                     "BETWEEN 1 PRECEDING AND 1 FOLLOWING) FROM t")


def test_window_range_frame_errors():
    db = WarpDB(HostTable.from_dict({
        "v": np.array([1.0, 2.0, 3.0], np.float32),
        "t": np.array([3.0, 1.0, 2.0], np.float32),
    }))
    with pytest.raises(UnsupportedError):
        db.query_sql("SELECT SUM(v) OVER (RANGE 2 PRECEDING) FROM t")
    with pytest.raises(ParseError):
        db.query_sql(
            "SELECT SUM(v) OVER (ORDER BY t RANGE BETWEEN 1 FOLLOWING"
            " AND 2 FOLLOWING) FROM t"
        )
    with pytest.raises(UnsupportedError):
        db.query_sql(
            "SELECT RANK() OVER (ORDER BY t RANGE 2 PRECEDING) FROM t"
        )


def test_window_rows_frame_errors_and_contextual_names():
    db = WarpDB(HostTable.from_dict({
        "k": np.array([1.0, 1.0, 2.0], np.float32),
        "v": np.array([1.0, 2.0, 3.0], np.float32),
        "rows": np.array([3.0, 1.0, 2.0], np.float32),
    }))
    # Frame requires ORDER BY.
    with pytest.raises(UnsupportedError):
        db.query_sql(
            "SELECT SUM(v) OVER (PARTITION BY k ROWS 2 PRECEDING) FROM t"
        )
    # Frames only make sense for SUM/AVG/COUNT/MIN/MAX.
    with pytest.raises(UnsupportedError):
        db.query_sql(
            "SELECT RANK() OVER (ORDER BY v ROWS 2 PRECEDING) FROM t"
        )
    # Frame must include the current row.
    with pytest.raises(ParseError):
        db.query_sql(
            "SELECT SUM(v) OVER (ORDER BY v ROWS BETWEEN 1 FOLLOWING"
            " AND 2 FOLLOWING) FROM t"
        )
    with pytest.raises(ParseError):
        db.query_sql(
            "SELECT SUM(v) OVER (ORDER BY v ROWS BETWEEN UNBOUNDED"
            " PRECEDING AND 1 PRECEDING) FROM t"
        )
    # ROWS is contextual, not reserved: a column named "rows" works as
    # an order key, a partition key, and alongside a frame.
    got = db.query_sql(
        "SELECT SUM(v) OVER (ORDER BY rows ROWS 1 PRECEDING) FROM t"
    )
    # order by rows: v=2 (rows=1), v=3 (rows=2), v=1 (rows=3)
    # frames of width 2: [2]=2, [2,3]=5, [3,1]=4 → row order v:1,2,3
    assert got == pytest.approx([4.0, 2.0, 5.0])
    got = db.query_sql("SELECT SUM(rows) FROM t")
    assert got == pytest.approx([6.0])


# --- determinism (SURVEY §5: the reference's atomicAdd compaction was
# nondeterministic; every path here must be bit-stable run-to-run) ---------


def test_repeat_query_bit_identical():
    rng = np.random.default_rng(77)
    t = {"price": rng.uniform(0, 100, 20000).astype(np.float32),
         "quantity": rng.integers(0, 13, 20000).astype(np.float32)}
    db = WarpDB(HostTable.from_dict(t))
    queries = [
        ("q", "price * quantity WHERE price > 50"),
        ("s", "SELECT price FROM t WHERE quantity == 5 ORDER BY price DESC LIMIT 20"),
        ("s", "SELECT SUM(price) FROM t GROUP BY quantity ORDER BY quantity ASC"),
    ]
    for kind, q in queries:
        run = db.query if kind == "q" else db.query_sql
        a = np.asarray(run(q))
        b = np.asarray(run(q))
        np.testing.assert_array_equal(a, b)


def test_metrics_roofline():
    from warpdb_tpu.utils.metrics import last, report, roofline_fraction

    db = WarpDB("data/test.csv")
    db.query("price + 1")
    m = last()
    assert m is not None and m.bytes_scanned > 0
    # The CPU backend has no data-sheet peak: no fraction, "n/a" in the
    # report — never a share of an assumed peak.
    assert roofline_fraction(m) is None
    rep = report()
    assert "price + 1"[:8] in rep
    assert rep.splitlines()[-1].endswith("n/a")


@pytest.mark.parametrize(
    "kind,peak",
    [
        ("NVIDIA H100 80GB HBM3", 3.35e12),
        ("NVIDIA H100 PCIe", 2.0e12),
        ("cpu", None),
        ("NVIDIA H100", None),
        ("NVIDIA A100-SXM4-80GB", None),
    ],
)
def test_peak_hbm_by_device_kind(kind, peak):
    from warpdb_tpu.utils.metrics import peak_hbm_bytes_per_s

    assert peak_hbm_bytes_per_s(kind) == peak


# --- grouped multi-column SELECT, COUNT(*), aliases, agg arithmetic ------------
# (exceeds the reference, which required a lone aggregate — warpdb.cpp:350-353)


def test_grouped_select_key_column(db, test_table):
    # First select item is the group key → query_sql returns key values.
    got = db.query_sql(
        "SELECT quantity, SUM(price) FROM test GROUP BY quantity ORDER BY quantity ASC"
    )
    assert got == pytest.approx(sorted(set(test_table["quantity"].tolist())))


def test_grouped_table_multi_aggregate(db, test_table):
    out = db.query_sql_table(
        "SELECT quantity AS q, SUM(price) AS total, COUNT(*) AS n, "
        "SUM(price)/COUNT(*) AS avg_price "
        "FROM test GROUP BY quantity ORDER BY quantity ASC"
    )
    assert set(out) == {"q", "total", "n", "avg_price"}
    groups = {}
    for p, q in zip(test_table["price"], test_table["quantity"]):
        groups.setdefault(float(q), []).append(float(p))
    ks = sorted(groups)
    assert out["q"] == pytest.approx(ks)
    assert out["total"] == pytest.approx([sum(groups[k]) for k in ks], abs=1e-5)
    assert out["n"] == pytest.approx([len(groups[k]) for k in ks])
    assert out["avg_price"] == pytest.approx(
        [sum(groups[k]) / len(groups[k]) for k in ks], abs=1e-5
    )


def test_count_star_global(db):
    assert db.query_sql("SELECT COUNT(*) FROM test") == [4.0]
    assert db.query_sql("SELECT COUNT(*) FROM test WHERE price > 15") == [3.0]


def test_count_star_grouped_vs_oracle(random_db):
    db, table = random_db
    sql = (
        "SELECT COUNT(*) FROM t WHERE price > 50 "
        "GROUP BY quantity ORDER BY quantity ASC"
    )
    got = np.asarray(db.query_sql(sql), dtype=np.float32)
    want = oracle.query_sql(table, parse_query_text(sql))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_grouped_agg_arithmetic_vs_oracle(random_db):
    db, table = random_db
    sql = (
        "SELECT SUM(price * quantity) / SUM(quantity) FROM t "
        "WHERE quantity >= 1 GROUP BY quantity ORDER BY quantity ASC"
    )
    got = np.asarray(db.query_sql(sql), dtype=np.float32)
    want = oracle.query_sql(table, parse_query_text(sql))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_alias_projection_table(db):
    out = db.query_sql_table(
        "SELECT price AS p, price * quantity AS revenue FROM test "
        "WHERE price > 15 ORDER BY price DESC LIMIT 2"
    )
    assert out["p"] == pytest.approx([30.0, 20.0])
    assert out["revenue"] == pytest.approx([150.0, 80.0])


def test_alias_is_cache_key_neutral(db):
    # Alias wrappers must not change plan canonicalization.
    a = db.query_sql("SELECT price AS x FROM test ORDER BY price ASC")
    b = db.query_sql("SELECT price FROM test ORDER BY price ASC")
    assert a == b


def test_window_multi_partition():
    table = {
        "v": np.array([1.0, 2.0, 3.0, 4.0, 5.0, 6.0], np.float32),
        "a": np.array([1.0, 1.0, 1.0, 2.0, 2.0, 2.0], np.float32),
        "b": np.array([0.0, 1.0, 0.0, 1.0, 0.0, 1.0], np.float32),
    }
    db = WarpDB(HostTable.from_dict(table))
    got = db.query_sql("SELECT SUM(v) OVER (PARTITION BY a, b) FROM t")
    # partitions: (1,0)->{1,3}=4, (1,1)->{2}=2, (2,1)->{4,6}=10, (2,0)->{5}=5
    assert got == pytest.approx([4.0, 2.0, 4.0, 10.0, 5.0, 10.0])


# --- multi-key ORDER BY and SELECT * (extensions) -----------------------------


def test_order_by_multi_key():
    table = {
        "a": np.array([2.0, 1.0, 2.0, 1.0, 2.0], np.float32),
        "b": np.array([5.0, 7.0, 3.0, 9.0, 4.0], np.float32),
    }
    db = WarpDB(HostTable.from_dict(table))
    out = db.query_sql_table("SELECT a, b FROM t ORDER BY a ASC, b DESC")
    assert out["a"] == pytest.approx([1.0, 1.0, 2.0, 2.0, 2.0])
    assert out["b"] == pytest.approx([9.0, 7.0, 5.0, 4.0, 3.0])


def test_order_by_multi_key_vs_oracle(random_db):
    db, table = random_db
    sql = "SELECT price FROM t WHERE price > 80 ORDER BY quantity ASC, price DESC"
    got = np.asarray(db.query_sql(sql), dtype=np.float32)
    want = oracle.query_sql(table, parse_query_text(sql))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_order_by_multi_key_grouped(random_db):
    db, table = random_db
    sql = (
        "SELECT SUM(price) FROM t GROUP BY quantity "
        "ORDER BY COUNT(*) DESC, quantity ASC LIMIT 5"
    )
    got = np.asarray(db.query_sql(sql), dtype=np.float32)
    want = oracle.query_sql(table, parse_query_text(sql))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_select_star(db, test_table):
    out = db.query_sql_table("SELECT * FROM test WHERE price > 15")
    assert set(out) == {"price", "quantity"}
    assert out["price"] == pytest.approx([20.0, 15.25, 30.0])
    assert out["quantity"] == pytest.approx([4.0, 2.0, 5.0])
    # query_sql returns the first expanded column.
    got = db.query_sql("SELECT * FROM test ORDER BY price DESC LIMIT 2")
    assert got == pytest.approx([30.0, 20.0])


def test_dense_group_large_int_keys_exact():
    # Integer keys beyond 2^24 with a small range: f32 would round ids to
    # multiples of 4 at 2^25 and merge adjacent groups; the dense path
    # must group on the raw ints.
    base = 1 << 25
    n = 4096
    rng = np.random.default_rng(3)
    ids = (base + rng.integers(0, 8, n)).astype(np.int32)
    price = rng.uniform(0, 10, n).astype(np.float32)
    db = WarpDB(HostTable.from_dict({"id": ids, "price": price}))
    got = db.query_sql_table(
        "SELECT COUNT(*) AS n, SUM(price) AS s FROM t GROUP BY id ORDER BY id ASC"
    )
    uniq = np.sort(np.unique(ids))
    assert len(got["n"]) == len(uniq) == 8
    want_counts = [(ids == u).sum() for u in uniq]
    assert got["n"] == pytest.approx(want_counts)
    want_sums = [float(price[ids == u].sum()) for u in uniq]
    assert got["s"] == pytest.approx(want_sums, rel=1e-5)


def test_join_multi_key():
    # Composite ON a = x AND b = y (extension; the reference never even
    # executed single-key joins).
    left = WarpDB(
        HostTable.from_dict(
            {
                "a": np.array([1.0, 1.0, 2.0, 2.0], np.float32),
                "b": np.array([10.0, 20.0, 10.0, 20.0], np.float32),
                "v": np.array([1.0, 2.0, 3.0, 4.0], np.float32),
            }
        )
    )
    right = HostTable.from_dict(
        {
            "a": np.array([1.0, 2.0, 2.0], np.float32),
            "b": np.array([20.0, 10.0, 99.0], np.float32),
            "w": np.array([100.0, 200.0, 300.0], np.float32),
        }
    )
    left.register_table("r", right)
    out = left.query_sql_table(
        "SELECT v, r.w FROM t JOIN r ON a = r.a AND b = r.b"
    )
    pairs = sorted(zip(out["v"], out["r.w"]))
    assert pairs == [(2.0, 100.0), (3.0, 200.0)]


def test_join_condition_not_equality_outer_errors(db):
    """Outer-join ON decides matching, so non-equality conjuncts are
    rejected there (INNER theta joins are supported — see
    test_theta_join_*)."""
    from warpdb_tpu.errors import UnsupportedError

    with pytest.raises(UnsupportedError, match="Non-equality"):
        db.query_sql(
            "SELECT price FROM test LEFT JOIN test ON price > quantity"
        )


def test_theta_join_residual_predicate():
    """INNER JOIN with mixed equality + inequality ON conjuncts: the
    equi-join runs on the equality pairs, the residual filters the
    joined rows (exact INNER semantics)."""
    lk = np.array([1, 2, 2, 3], np.float32)
    lv = np.array([10, 20, 30, 40], np.float32)
    rk = np.array([2, 2, 3, 4], np.float32)
    rw = np.array([5, 25, 35, 1], np.float32)
    db = WarpDB(HostTable.from_dict({"k": lk, "v": lv}))
    db.register_table("r", HostTable.from_dict({"k": rk, "w": rw}))
    out = db.query_sql_table(
        "SELECT v, r.w FROM t JOIN r ON k = r.k AND v > r.w "
        "ORDER BY v, r.w"
    )
    got = list(zip(*[map(float, c) for c in out.values()]))
    exp = sorted(
        (float(a), float(b))
        for i, a in enumerate(lv)
        for j, b in enumerate(rw)
        if lk[i] == rk[j] and a > b
    )
    assert got == exp
    # Residual referencing only one side (Var cmp Const).
    out = db.query_sql_table(
        "SELECT v FROM t JOIN r ON k = r.k AND r.w > 20 ORDER BY v"
    )
    exp2 = sorted(
        float(a)
        for i, a in enumerate(lv)
        for j in range(len(rk))
        if lk[i] == rk[j] and rw[j] > 20
    )
    assert [float(x) for x in list(out.values())[0]] == exp2


def test_theta_join_pure_inequality():
    """ON with no equality conjunct at all executes as a general theta
    join (cross product + filter)."""
    lv = np.array([10, 20, 30, 40], np.float32)
    rw = np.array([5, 25, 35, 1], np.float32)
    db = WarpDB(HostTable.from_dict({"v": lv}))
    db.register_table("r", HostTable.from_dict({"w": rw}))
    out = db.query_sql_table(
        "SELECT v, r.w FROM t JOIN r ON v < r.w ORDER BY v, r.w"
    )
    got = list(zip(*[map(float, c) for c in out.values()]))
    exp = sorted(
        (float(a), float(b)) for a in lv for b in rw if a < b
    )
    assert got == exp


def test_select_star_join_includes_right_columns():
    left = WarpDB(
        HostTable.from_dict(
            {
                "k": np.array([1.0, 2.0], np.float32),
                "v": np.array([10.0, 20.0], np.float32),
            }
        )
    )
    right = HostTable.from_dict(
        {
            "k": np.array([1.0, 2.0], np.float32),
            "w": np.array([100.0, 200.0], np.float32),
        }
    )
    left.register_table("r", right)
    out = left.query_sql_table("SELECT * FROM t JOIN r ON k = r.k")
    assert set(out) == {"k", "v", "r.k", "w"}
    assert sorted(out["w"]) == [100.0, 200.0]


def test_duplicate_select_items_empty_result_schema(db):
    out = db.query_sql_table("SELECT price, price FROM test WHERE price > 1000")
    assert set(out) == {"price", "price_1"}
    assert out["price"] == [] and out["price_1"] == []


def test_group_by_multi_key_select_both():
    rng = np.random.default_rng(21)
    n = 4000
    table = {
        "a": rng.integers(0, 5, n).astype(np.float32),
        "b": rng.integers(0, 3, n).astype(np.float32),
        "v": rng.uniform(0, 10, n).astype(np.float32),
    }
    db = WarpDB(HostTable.from_dict(table))
    out = db.query_sql_table(
        "SELECT a, b, SUM(v) AS s, COUNT(*) AS n FROM t "
        "GROUP BY a, b ORDER BY a ASC, b ASC"
    )
    import itertools

    expect = []
    for ka, kb in itertools.product(sorted(set(table["a"])), sorted(set(table["b"]))):
        m = (table["a"] == ka) & (table["b"] == kb)
        if m.any():
            expect.append((ka, kb, float(table["v"][m].sum()), int(m.sum())))
    assert out["a"] == pytest.approx([e[0] for e in expect])
    assert out["b"] == pytest.approx([e[1] for e in expect])
    assert out["s"] == pytest.approx([e[2] for e in expect], rel=1e-4)
    assert out["n"] == pytest.approx([e[3] for e in expect])


def test_row_number_and_rank_windows():
    t = {
        "p": np.array([1, 1, 2, 2, 1], np.float32),
        "v": np.array([30, 10, 20, 20, 10], np.float32),
    }
    db = WarpDB(HostTable.from_dict(t))
    assert db.query_sql(
        "SELECT ROW_NUMBER() OVER (PARTITION BY p ORDER BY v ASC) FROM t"
    ) == [3.0, 1.0, 1.0, 2.0, 2.0]
    assert db.query_sql(
        "SELECT RANK() OVER (PARTITION BY p ORDER BY v ASC) FROM t"
    ) == [3.0, 1.0, 1.0, 1.0, 1.0]
    # Without ORDER BY, row order decides (deterministic).
    assert db.query_sql("SELECT ROW_NUMBER() OVER (PARTITION BY p) FROM t") == [
        1.0, 2.0, 1.0, 2.0, 3.0,
    ]
    # Descending order keys.
    assert db.query_sql(
        "SELECT RANK() OVER (PARTITION BY p ORDER BY v DESC) FROM t"
    ) == [1.0, 2.0, 1.0, 1.0, 2.0]
    from warpdb_tpu.errors import ParseError

    with pytest.raises(ParseError, match="OVER"):
        db.query_sql("SELECT ROW_NUMBER() FROM t")


def test_percent_rank_cume_dist_windows():
    t = {
        "p": np.array([1, 1, 2, 2, 1, 1], np.float32),
        "v": np.array([30, 10, 20, 20, 10, 40], np.float32),
    }
    db = WarpDB(HostTable.from_dict(t))
    # Partition p=1 sorted: 10,10,30,40 — ranks 1,1,3,4 over count 4.
    assert db.query_sql(
        "SELECT PERCENT_RANK() OVER (PARTITION BY p ORDER BY v) FROM t"
    ) == pytest.approx([2 / 3, 0.0, 0.0, 0.0, 0.0, 1.0])
    # CUME_DIST counts peers: p=2 has two tied rows -> 2/2 each.
    assert db.query_sql(
        "SELECT CUME_DIST() OVER (PARTITION BY p ORDER BY v) FROM t"
    ) == pytest.approx([3 / 4, 2 / 4, 1.0, 1.0, 2 / 4, 1.0])
    # Single-row partitions: PERCENT_RANK pins to 0, CUME_DIST to 1.
    db1 = WarpDB(HostTable.from_dict({
        "p": np.array([1, 2, 3], np.float32),
        "v": np.array([5, 7, 6], np.float32),
    }))
    assert db1.query_sql(
        "SELECT PERCENT_RANK() OVER (PARTITION BY p ORDER BY v) FROM t"
    ) == [0.0, 0.0, 0.0]
    assert db1.query_sql(
        "SELECT CUME_DIST() OVER (PARTITION BY p ORDER BY v) FROM t"
    ) == [1.0, 1.0, 1.0]


def test_nth_value_and_lag_lead_offsets():
    t = {
        "p": np.array([1, 1, 1, 1, 2, 2], np.float32),
        "v": np.array([30, 10, 20, 40, 7, 5], np.float32),
    }
    db = WarpDB(HostTable.from_dict(t))
    # p=1 sorted: 10,20,30,40 -> 2nd value 20 everywhere; p=2 has only
    # 2 rows, 2nd value 7.
    assert db.query_sql(
        "SELECT NTH_VALUE(v, 2) OVER (PARTITION BY p ORDER BY v) FROM t"
    ) == [20.0, 20.0, 20.0, 20.0, 7.0, 7.0]
    # n beyond the partition size -> NaN (the missing-value marker).
    got = db.query_sql(
        "SELECT NTH_VALUE(v, 3) OVER (PARTITION BY p ORDER BY v) FROM t"
    )
    assert got[:4] == [30.0] * 4 and np.isnan(got[4:]).all()
    # NTH_VALUE(v, 1) == FIRST_VALUE(v).
    assert db.query_sql(
        "SELECT NTH_VALUE(v, 1) OVER (PARTITION BY p ORDER BY v DESC) FROM t"
    ) == db.query_sql(
        "SELECT FIRST_VALUE(v) OVER (PARTITION BY p ORDER BY v DESC) FROM t"
    )
    # LAG/LEAD with explicit offsets (default stays 1).
    assert db.query_sql(
        "SELECT LAG(v, 2) OVER (PARTITION BY p ORDER BY v) FROM t"
    )[:4] == pytest.approx(
        [10.0, np.nan, np.nan, 20.0], nan_ok=True
    )
    assert db.query_sql(
        "SELECT LEAD(v, 3) OVER (PARTITION BY p ORDER BY v) FROM t"
    )[:4] == pytest.approx(
        [np.nan, 40.0, np.nan, np.nan], nan_ok=True
    )
    from warpdb_tpu.errors import ParseError

    with pytest.raises(ParseError, match="NTH_VALUE requires a row number"):
        db.query_sql("SELECT NTH_VALUE(v) OVER (ORDER BY v) FROM t")
    with pytest.raises(ParseError, match="positive integer"):
        db.query_sql("SELECT LAG(v, 0) OVER (ORDER BY v) FROM t")
    with pytest.raises(ParseError, match="positive integer"):
        db.query_sql("SELECT NTH_VALUE(v, 1.5) OVER (ORDER BY v) FROM t")


def test_fuzz_relative_rank_and_nth_value():
    """PERCENT_RANK/CUME_DIST/NTH_VALUE/LAG-k vs a naive oracle over
    random tables with tied keys, WHERE filters and DESC order."""
    rng = np.random.default_rng(97)
    for trial in range(6):
        n = int(rng.integers(30, 120))
        k = rng.integers(0, 4, n).astype(np.float32)
        v = (rng.random(n) * 10).round(0).astype(np.float32)  # many ties
        db = WarpDB(HostTable.from_dict({"k": k, "v": v}))
        where = rng.random() < 0.5
        desc = rng.random() < 0.5
        sel = v > 3.0 if where else np.ones(n, bool)
        sql_tail = (
            f"OVER (PARTITION BY k ORDER BY v {'DESC' if desc else 'ASC'})"
            f" FROM t{' WHERE v > 3' if where else ''}"
        )
        pr = np.array(db.query_sql(f"SELECT PERCENT_RANK() {sql_tail}"))
        cd = np.array(db.query_sql(f"SELECT CUME_DIST() {sql_tail}"))
        nv = np.array(db.query_sql(f"SELECT NTH_VALUE(v, 4) {sql_tail}"))
        lg = np.array(db.query_sql(f"SELECT LAG(v, 3) {sql_tail}"))
        idxs = np.nonzero(sel)[0]
        kk, vv = k[idxs], v[idxs]
        opr = np.zeros(len(idxs)); ocd = np.zeros(len(idxs))
        onv = np.full(len(idxs), np.nan); olg = np.full(len(idxs), np.nan)
        sgn = -1.0 if desc else 1.0
        for p in np.unique(kk):
            pix = np.nonzero(kk == p)[0]
            pv = vv[pix]
            c = len(pix)
            order = pix[np.argsort(sgn * pv, kind="stable")]
            for j, i in enumerate(order):
                rank = 1 + int(np.sum(sgn * pv < sgn * vv[i]))
                opr[i] = (rank - 1) / max(c - 1, 1)
                ocd[i] = np.sum(sgn * pv <= sgn * vv[i]) / c
                if c >= 4:
                    onv[i] = vv[order[3]]
                if j >= 3:
                    olg[i] = vv[order[j - 3]]
        assert np.allclose(pr, opr, atol=1e-6), (trial, "percent_rank")
        assert np.allclose(cd, ocd, atol=1e-6), (trial, "cume_dist")
        assert np.allclose(nv, onv, atol=1e-6, equal_nan=True), (
            trial, "nth_value",
        )
        # LAG ties: any peer ordering is valid when order keys tie, so
        # compare only rows whose 3-back neighbour is uniquely keyed —
        # cheap proxy: skip rows where the oracle's lag value ties with
        # another candidate at the same distance.  Row-identical here
        # because both engine and oracle break ties by original row
        # order (stable sorts), so compare exactly.
        assert np.allclose(lg, olg, atol=1e-6, equal_nan=True), (
            trial, "lag3",
        )


def test_window_with_outer_order_by():
    t = {
        "p": np.array([1, 1, 2, 2], np.float32),
        "v": np.array([5, 7, 1, 3], np.float32),
    }
    db = WarpDB(HostTable.from_dict(t))
    got = db.query_sql(
        "SELECT SUM(v) OVER (PARTITION BY p) FROM t ORDER BY v DESC LIMIT 3"
    )
    # window sums: p1 -> 12, p2 -> 4; rows ordered by v desc: 7,5,3 -> 12,12,4
    assert got == [12.0, 12.0, 4.0]


def _double_pallas_udf(interpret: bool):
    """Elementwise doubling as a Pallas kernel over 256-row blocks,
    compiled through Triton on a GPU or run by the Pallas interpreter."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    block = 256

    def _kernel(x_ref, o_ref):
        o_ref[...] = x_ref[...] * 2.0

    def double_pallas(x):
        return pl.pallas_call(
            _kernel,
            out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
            grid=(x.shape[0] // block,),
            in_specs=[pl.BlockSpec((block,), lambda i: (i,))],
            out_specs=pl.BlockSpec((block,), lambda i: (i,)),
            backend="triton",
            interpret=interpret,
        )(x)

    return double_pallas


def _check_pallas_udf(db, interpret: bool):
    from warpdb_tpu import register_udf

    register_udf("double_pallas", _double_pallas_udf(interpret))
    try:
        got = db.query("double_pallas(price)")
        assert got[:4] == pytest.approx([21.0, 40.0, 30.5, 60.0])
        got = db.query("double_pallas(price) WHERE quantity > 3")
        assert got == pytest.approx([0.0, 40.0, 0.0, 60.0])
    finally:
        register_udf("double_pallas", None)


def test_pallas_udf_escape_hatch(db):
    # The UDF registry accepts Pallas kernels (README claim): a blocked
    # doubling kernel registered as a UDF and fused into the query
    # pipeline, here through the Pallas interpreter.
    _check_pallas_udf(db, interpret=True)


@pytest.mark.gpu
def test_pallas_udf_compiled_on_gpu(db):
    # The same UDF compiled for the card through Pallas' Triton route.
    _check_pallas_udf(db, interpret=False)


def test_count_distinct(db, random_db):
    t = {
        "k": np.array([1, 1, 1, 2, 2], np.float32),
        "v": np.array([5, 5, 7, 3, 3], np.float32),
    }
    d = WarpDB(HostTable.from_dict(t))
    out = d.query_sql_table(
        "SELECT k, COUNT(DISTINCT v) AS d, COUNT(*) AS n FROM t GROUP BY k"
    )
    assert out["d"] == [2.0, 1.0] and out["n"] == [3.0, 2.0]
    assert d.query_sql("SELECT COUNT(DISTINCT v) FROM t") == [3.0]
    assert d.query_sql(
        "SELECT k FROM t GROUP BY k HAVING COUNT(DISTINCT v) > 1"
    ) == [1.0]

    # randomized vs oracle
    rdb, table = random_db
    sql = (
        "SELECT COUNT(DISTINCT price) FROM t WHERE price > 40 "
        "GROUP BY quantity ORDER BY quantity ASC"
    )
    got = np.asarray(rdb.query_sql(sql), dtype=np.float32)
    want = oracle.query_sql(table, parse_query_text(sql))
    np.testing.assert_allclose(got, want)


def test_approx_count_distinct():
    """APPROX_COUNT_DISTINCT (HyperLogLog, ops/hll.py): within the
    ~1.6%-per-sigma error envelope of the exact count at several
    cardinalities, across global / grouped / WHERE / HAVING / string
    forms.  5-sigma bounds keep the assertions seed-stable."""
    rng = np.random.default_rng(29)
    n = 120_000
    x = rng.integers(0, 30_000, n).astype(np.float32)
    g = rng.integers(0, 4, n).astype(np.float32)
    tag = np.array([f"u{i:04d}" for i in range(2_000)], dtype=object)[
        rng.integers(0, 2_000, n)
    ]
    d = WarpDB(HostTable.from_dict({"g": g, "x": x, "tag": tag}))

    def _close(approx, exact):
        assert abs(approx - exact) <= 5 * 0.0164 * exact + 2, (
            approx, exact
        )

    out = d.query_sql_table(
        "SELECT APPROX_COUNT_DISTINCT(x) AS a, COUNT(DISTINCT x) AS e "
        "FROM t"
    )
    _close(out["a"][0], out["e"][0])

    grp = d.query_sql_table(
        "SELECT g, APPROX_COUNT_DISTINCT(x) AS a, COUNT(DISTINCT x) AS e "
        "FROM t WHERE x > 100 GROUP BY g ORDER BY g ASC"
    )
    assert grp["g"] == [0.0, 1.0, 2.0, 3.0]
    for a, e in zip(grp["a"], grp["e"]):
        _close(a, e)

    st = d.query_sql_table(
        "SELECT APPROX_COUNT_DISTINCT(tag) AS a, COUNT(DISTINCT tag) AS e "
        "FROM t"
    )
    _close(st["a"][0], st["e"][0])

    # Tiny cardinalities ride the linear-counting correction — near
    # exact there.
    small = WarpDB(
        HostTable.from_dict(
            {"v": np.array([1, 2, 2, 3, 3, 3, np.nan, np.nan], np.float32)}
        )
    )
    a = small.query_sql("SELECT APPROX_COUNT_DISTINCT(v) FROM t")[0]
    # NaN counts as ONE distinct value, matching COUNT(DISTINCT).
    assert abs(a - 4.0) < 0.5, a

    # HAVING over the estimate.
    hv = d.query_sql_table(
        "SELECT g FROM t GROUP BY g "
        "HAVING APPROX_COUNT_DISTINCT(x) > 1 ORDER BY g ASC"
    )
    assert hv["g"] == [0.0, 1.0, 2.0, 3.0]


def test_concurrent_queries_thread_safe(db, test_table):
    # The reference's parser used file-static mutable state and was not
    # reentrant (expression.cpp:123-124); this engine must serve
    # concurrent queries from one table correctly.
    import concurrent.futures

    queries = [
        ("q", "price * quantity WHERE price > 15"),
        ("s", "SELECT SUM(price) FROM test GROUP BY quantity ORDER BY quantity ASC"),
        ("s", "SELECT price FROM test ORDER BY price DESC LIMIT 2"),
        ("q", "discount(price, 0.9)"),
    ] * 8

    def run(args):
        kind, text = args
        return (db.query if kind == "q" else db.query_sql)(text)

    expected = [run(q) for q in queries[:4]]
    with concurrent.futures.ThreadPoolExecutor(max_workers=8) as ex:
        results = list(ex.map(run, queries))
    for i, r in enumerate(results):
        assert r == pytest.approx(expected[i % 4], rel=1e-6)


def test_fuzz_window_vs_oracle(random_db):
    import oracle as _oracle

    db, table = random_db
    for seed in range(4):
        rng = np.random.default_rng(8000 + seed)
        agg = rng.choice(["SUM", "AVG", "COUNT", "MIN", "MAX"])
        sql = f"SELECT {agg}(price) OVER (PARTITION BY quantity) FROM t"
        if rng.uniform() < 0.5:
            sql += " WHERE price > 30"
        got = np.asarray(db.query_sql(sql), dtype=np.float32)
        want = _oracle.query_sql(table, parse_query_text(sql))
        np.testing.assert_allclose(got, want, rtol=1e-4, err_msg=sql)


def test_metrics_operator_trace():
    from warpdb_tpu.utils.metrics import last

    rng = np.random.default_rng(55)
    # Integral stats-bounded high-cardinality key → midrange path.
    t = {
        "price": rng.uniform(0, 100, 8000).astype(np.float32),
        "k": np.arange(8000, dtype=np.float32),
    }
    db = WarpDB(HostTable.from_dict(t))
    # LIMIT pushdown: aggregation + compaction fuse into ONE dispatch.
    db.query_sql("SELECT SUM(price) FROM t GROUP BY k LIMIT 3")
    ops = [name for name, _hit in last().operators]
    assert "midrange_group" in ops and "midrange_compact" not in ops
    # Without a LIMIT the two-phase protocol emits a separate compaction.
    db.query_sql("SELECT SUM(price) FROM t GROUP BY k")
    ops = [name for name, _hit in last().operators]
    assert "midrange_group" in ops and "midrange_compact" in ops
    # Second run: same operators, now cache hits.
    db.query_sql("SELECT SUM(price) FROM t GROUP BY k")
    assert all(hit for _name, hit in last().operators)

    # Non-integral key → the sort path, traced as group_sort/scatter.
    t2 = {
        "price": rng.uniform(0, 100, 8000).astype(np.float32),
        "k": np.arange(8000, dtype=np.float32) + 0.5,
    }
    db2 = WarpDB(HostTable.from_dict(t2))
    db2.query_sql("SELECT SUM(price) FROM t GROUP BY k LIMIT 3")
    ops2 = [name for name, _hit in last().operators]
    assert "group_sort" in ops2 and "group_scatter" in ops2


def test_median(db, random_db):
    t = {
        "k": np.array([1, 1, 1, 2, 2, 2, 2], np.float32),
        "v": np.array([5, 1, 9, 4, 2, 8, 6], np.float32),
    }
    d = WarpDB(HostTable.from_dict(t))
    out = d.query_sql_table("SELECT k, MEDIAN(v) AS m FROM t GROUP BY k")
    assert out["m"] == [5.0, 5.0]
    assert d.query_sql("SELECT MEDIAN(v) FROM t") == [5.0]
    assert d.query_sql("SELECT MEDIAN(v) FROM t WHERE k == 2") == [5.0]

    # randomized vs numpy oracle
    rdb, table = random_db
    sql = (
        "SELECT MEDIAN(price) FROM t WHERE price > 20 "
        "GROUP BY quantity ORDER BY quantity ASC"
    )
    got = np.asarray(rdb.query_sql(sql), dtype=np.float32)
    want = oracle.query_sql(table, parse_query_text(sql))
    np.testing.assert_allclose(got, want, rtol=1e-5)

    # a column named median still works
    d2 = WarpDB(HostTable.from_dict({"median": np.float32([3.0, 1.0])}))
    assert d2.query_sql("SELECT median FROM t ORDER BY median ASC") == [1.0, 3.0]


def test_order_by_nan_key_keeps_valid_rows():
    # A valid row whose ORDER BY key is NaN must stay in the result (it
    # sorts last among valid rows), not be displaced by padding.
    t = {
        "a": np.array([1.0, 0.0, 2.0], np.float32),
        "b": np.array([0.0, 0.0, 1.0], np.float32),
        "flag": np.array([1.0, 1.0, 1.0], np.float32),
    }
    db = WarpDB(HostTable.from_dict(t))
    # a/b: [inf, nan, 2.0] — row order by ratio ASC: 2.0, inf, nan
    got = db.query_sql("SELECT a FROM t WHERE flag > 0 ORDER BY a / b ASC")
    assert len(got) == 3
    assert got[0] == 2.0 and got[1] == 1.0 and got[2] == 0.0


def test_nan_stats_do_not_prune_filters(tmp_path):
    # A column containing NaN must not produce an "always true" verdict
    # from min/max stats — the NaN row evaluates False on device.
    t = HostTable.from_dict(
        {"x": np.array([1.0, 2.0, np.nan], np.float32)}
    )
    db = WarpDB(t)
    assert db.table.stats["x"].null_count == 1
    got = db.query_sql("SELECT x FROM t WHERE x < 100")
    assert len(got) == 2  # NaN row excluded, not blindly included


def test_topk_nan_semantics_match_full_sort():
    t = {
        "v": np.array([5.0, np.nan, 3.0, 8.0, 1.0], np.float32),
        "f": np.ones(5, np.float32),
    }
    db = WarpDB(HostTable.from_dict(t))
    # ASC: NaN ranks last → never in a small LIMIT.
    asc_topk = db.query_sql("SELECT v FROM t ORDER BY v ASC LIMIT 3")
    assert asc_topk == [1.0, 3.0, 5.0]
    full_asc = db.query_sql("SELECT v FROM t ORDER BY v ASC")
    assert full_asc[:3] == asc_topk and np.isnan(full_asc[-1])
    # DESC: NaN ranks first, consistent with the full sort.
    full_desc = db.query_sql("SELECT v FROM t ORDER BY v DESC")
    assert np.isnan(full_desc[0]) and full_desc[1:] == [8.0, 5.0, 3.0, 1.0]
    desc_topk = db.query_sql("SELECT v FROM t ORDER BY v DESC LIMIT 2")
    assert np.isnan(desc_topk[0]) and desc_topk[1] == 8.0


def test_case_when(db, test_table, random_db):
    got = db.query(
        "CASE WHEN price > 19 THEN 100 WHEN price > 12 THEN 50 ELSE 1 END"
    )
    assert got == [1.0, 100.0, 50.0, 100.0]
    # Conditional aggregation (the classic use).
    assert db.query_sql(
        "SELECT SUM(CASE WHEN price > 15 THEN price ELSE 0 END) FROM test"
    ) == [65.25]
    # No ELSE -> 0.0 default.
    assert db.query("CASE WHEN price > 19 THEN 7 END") == [
        0.0, 7.0, 0.0, 7.0,
    ]
    # Randomized vs oracle, inside WHERE and grouped select.
    rdb, table = random_db
    sql = (
        "SELECT SUM(CASE WHEN price > 50 THEN price ELSE 0 END) FROM t "
        "GROUP BY quantity ORDER BY quantity ASC"
    )
    got = np.asarray(rdb.query_sql(sql), dtype=np.float32)
    want = oracle.query_sql(table, parse_query_text(sql))
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_builtin_math_functions(db, test_table):
    got = np.asarray(db.query("sqrt(price)"))
    np.testing.assert_allclose(got, np.sqrt(test_table["price"]), rtol=1e-6)
    got = np.asarray(db.query("maximum(price, quantity * 5)"))
    np.testing.assert_allclose(
        got, np.maximum(test_table["price"], test_table["quantity"] * 5),
        rtol=1e-6,
    )
    assert db.query_sql("SELECT SUM(floor(price)) FROM test") == [
        float(np.floor(test_table["price"]).sum())
    ]
    # User UDFs shadow builtins.
    from warpdb_tpu import register_udf

    register_udf("sqrt", lambda x: x * 0 + 42.0)
    try:
        assert db.query("sqrt(price)") == [42.0] * 4
    finally:
        register_udf("sqrt", None)


def test_window_desc_nan_rank_consistent():
    # NaN order keys rank "largest" everywhere: first under DESC in both
    # plain ORDER BY and windows.
    t = {
        "k": np.array([1.0, np.nan, 3.0], np.float32),
        "v": np.array([10.0, 20.0, 30.0], np.float32),
    }
    db = WarpDB(HostTable.from_dict(t))
    rn = db.query_sql("SELECT ROW_NUMBER() OVER (ORDER BY k DESC) FROM t")
    assert rn == [3.0, 1.0, 2.0]  # nan row ranks first under DESC


def test_case_over_aggregates_grouped(db):
    got = db.query_sql(
        "SELECT CASE WHEN SUM(price) > 16 THEN 1 ELSE 0 END FROM test "
        "GROUP BY quantity ORDER BY quantity ASC"
    )
    # sums per quantity asc: 15.25, 10.5, 20, 30
    assert got == [0.0, 0.0, 1.0, 1.0]
    got = db.query_sql(
        "SELECT quantity FROM test GROUP BY quantity "
        "HAVING CASE WHEN SUM(price) > 16 THEN 1 ELSE 0 END > 0 "
        "ORDER BY quantity ASC"
    )
    assert got == [4.0, 5.0]


def test_uppercase_builtins(db, test_table):
    got = np.asarray(db.query("SQRT(price)"))
    np.testing.assert_allclose(got, np.sqrt(test_table["price"]), rtol=1e-6)


def test_join_propagates_stats_and_orderby_limit():
    # Joined tables carry conservative source stats, so the stats-gated
    # top-k path stays live after a join; the sorted-with-LIMIT fallback
    # slices on device — either way the result must match the oracle.
    rng = np.random.default_rng(11)
    n = 4000
    q = rng.integers(0, 16, n).astype(np.float32)
    price = rng.uniform(0, 100, n).astype(np.float32)
    db = WarpDB(HostTable.from_dict({"price": price, "quantity": q}))
    rates = HostTable.from_dict(
        {
            "quantity": np.arange(16, dtype=np.float32),
            "rate": np.linspace(0, 1, 16).astype(np.float32),
        }
    )
    db.register_table("rates", rates)
    got = db.query_sql(
        "SELECT price FROM t JOIN rates ON quantity = rates.quantity "
        "WHERE rates.rate > 0.5 ORDER BY price DESC LIMIT 5"
    )
    keep = price[np.linspace(0, 1, 16)[q.astype(int)] > 0.5]
    want = np.sort(keep)[::-1][:5]
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-6)

    # The joined table's stats interval contains every joined value.
    from warpdb_tpu.engine.executor import _materialize_join
    from warpdb_tpu.frontend import parse_query_text

    ast = parse_query_text(
        "SELECT price FROM t JOIN rates ON quantity = rates.quantity"
    )
    joined = _materialize_join(
        db.table, db._catalog["rates"], "rates", ast.joins[0].condition
    )
    st = joined.stats["price"]
    vals = np.asarray(joined.columns["price"])[: joined.num_rows]
    assert st.min <= vals.min() and vals.max() <= st.max


def test_sorted_limit_offset_device_slice(db):
    # ORDER BY (non-select expr) + LIMIT/OFFSET goes through the full-sort
    # path with a device-side prefix slice; results must be exact.
    got = db.query_sql(
        "SELECT quantity FROM test ORDER BY price ASC LIMIT 2 OFFSET 1"
    )
    # prices asc: 10.5, 15.25, 20, 30 -> quantities 3, 2, 4, 5
    assert got == [2.0, 4.0]
    got = db.query_sql_table(
        "SELECT price, quantity FROM test ORDER BY price DESC, quantity ASC "
        "LIMIT 3 OFFSET 1"
    )
    assert got["price"] == [20.0, 15.25, 10.5]
    assert got["quantity"] == [4.0, 2.0, 3.0]


def test_window_where_preserves_row_order():
    # The filtered-window two-phase path compacts survivors with a
    # stable position sort; output must stay in original row order.
    rng = np.random.default_rng(5)
    n = 3000
    q = rng.integers(0, 8, n).astype(np.float32)
    price = rng.uniform(0, 100, n).astype(np.float32)
    db = WarpDB(HostTable.from_dict({"price": price, "quantity": q}))
    got = np.asarray(db.query_sql(
        "SELECT SUM(price) OVER (PARTITION BY quantity) FROM t "
        "WHERE price > 90"
    ))
    m = price > 90
    sums = {u: price[m][q[m] == u].sum() for u in np.unique(q[m])}
    want = np.array([sums[u] for u in q[m]], np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_stacked_take_fallbacks():
    import jax.numpy as jnp

    from warpdb_tpu.ops.join import stacked_take

    rng = np.random.default_rng(9)
    # Small source -> per-column 1-D fallback.
    small = jnp.asarray(rng.uniform(0, 1, 64).astype(np.float32))
    idx = jnp.asarray(rng.integers(0, 64, 2048).astype(np.int32))
    valid = jnp.asarray(rng.uniform(0, 1, 2048) < 0.7)
    a, b = stacked_take((small, small * 2), idx, valid)
    np.testing.assert_allclose(
        np.asarray(a), np.where(valid, np.asarray(small)[idx], 0.0)
    )
    np.testing.assert_allclose(np.asarray(b), np.asarray(a) * 2)
    # Large lane-divisible source -> stacked 2-D take; int32 codes keep
    # their dtype through the u32 bitcast round-trip.
    big_f = jnp.asarray(rng.uniform(0, 1, 8192).astype(np.float32))
    big_i = jnp.asarray(rng.integers(-100, 100, 8192).astype(np.int32))
    idx2 = jnp.asarray(rng.integers(0, 8192, 1024).astype(np.int32))
    v2 = jnp.ones(1024, bool)
    f, i = stacked_take((big_f, big_i), idx2, v2)
    assert i.dtype == jnp.int32
    np.testing.assert_allclose(np.asarray(f), np.asarray(big_f)[idx2])
    np.testing.assert_array_equal(np.asarray(i), np.asarray(big_i)[idx2])
    # Non-lane-divisible index -> per-column fallback still correct.
    idx3 = jnp.asarray(rng.integers(0, 8192, 1000).astype(np.int32))
    f3, _ = stacked_take((big_f, big_i), idx3, jnp.ones(1000, bool))
    np.testing.assert_allclose(np.asarray(f3), np.asarray(big_f)[idx3])


# --- midrange (sort-free) GROUP BY, dense window, join fast paths -------------


def _group_oracle(keys, vals):
    uniq = np.sort(np.unique(keys))
    return uniq, {
        "sum": np.array([vals[keys == k].sum() for k in uniq], np.float32),
        "min": np.array(
            [vals[keys == k].min() for k in uniq], np.float32
        ),
        "count": np.array([(keys == k).sum() for k in uniq], np.float32),
    }


def test_midrange_group_mxu_sum_matches_oracle():
    """SUM-only stats-bounded key beyond the dense limit rides the
    one-hot matmul engine; totals must match the numpy oracle."""
    rng = np.random.default_rng(11)
    n = 50_000
    keys = rng.integers(0, 60_000, n).astype(np.float32)
    vals = rng.uniform(0, 100, n).astype(np.float32)
    db = WarpDB(HostTable.from_dict({"v": vals, "k": keys}))
    res = np.asarray(db.query_sql("SELECT SUM(v) FROM t GROUP BY k"))
    uniq, agg = _group_oracle(keys, vals.astype(np.float64))
    assert len(res) == len(uniq)
    np.testing.assert_allclose(res, agg["sum"], rtol=3e-5)


def test_midrange_group_scatter_min_count():
    """MIN forces the scatter engine (no one-hot reformulation for order
    statistics); counts and minima must both be exact."""
    rng = np.random.default_rng(12)
    n = 30_000
    keys = rng.integers(100, 40_000, n).astype(np.float32)
    vals = rng.uniform(0, 100, n).astype(np.float32)
    db = WarpDB(HostTable.from_dict({"v": vals, "k": keys}))
    res = np.asarray(
        db.query_sql("SELECT MIN(v) FROM t GROUP BY k")
    )
    uniq, agg = _group_oracle(keys, vals)
    np.testing.assert_allclose(res, agg["min"], rtol=1e-6)
    cnt = np.asarray(db.query_sql("SELECT COUNT(v) FROM t GROUP BY k"))
    np.testing.assert_array_equal(cnt, agg["count"])


def test_midrange_group_limit_pushdown():
    """GROUP BY ... LIMIT with no HAVING/ORDER BY ships only the first
    LIMIT groups (device-side compaction slice)."""
    rng = np.random.default_rng(13)
    n = 20_000
    keys = rng.integers(0, 30_000, n).astype(np.float32)
    vals = rng.uniform(0, 10, n).astype(np.float32)
    db = WarpDB(HostTable.from_dict({"v": vals, "k": keys}))
    uniq, agg = _group_oracle(keys, vals.astype(np.float64))
    res = np.asarray(db.query_sql("SELECT SUM(v) FROM t GROUP BY k LIMIT 7"))
    np.testing.assert_allclose(res, agg["sum"][:7], rtol=3e-5)
    # OFFSET composes with the pushdown.
    res = np.asarray(
        db.query_sql("SELECT SUM(v) FROM t GROUP BY k LIMIT 5 OFFSET 3")
    )
    np.testing.assert_allclose(res, agg["sum"][3:8], rtol=3e-5)
    # HAVING disables pushdown but stays correct through midrange.
    res = np.asarray(
        db.query_sql(
            "SELECT SUM(v) FROM t GROUP BY k HAVING COUNT(v) > 1 LIMIT 4"
        )
    )
    want = agg["sum"][agg["count"] > 1][:4]
    np.testing.assert_allclose(res, want, rtol=3e-5)
    # ORDER BY the group key ascending restates the default order, so
    # the pushdown still applies (and stays correct).
    res = np.asarray(
        db.query_sql(
            "SELECT SUM(v) FROM t GROUP BY k ORDER BY k ASC LIMIT 6"
        )
    )
    np.testing.assert_allclose(res, agg["sum"][:6], rtol=3e-5)
    # DESC needs the LAST groups — pushdown must NOT truncate.
    res = np.asarray(
        db.query_sql(
            "SELECT SUM(v) FROM t GROUP BY k ORDER BY k DESC LIMIT 6"
        )
    )
    np.testing.assert_allclose(res, agg["sum"][::-1][:6], rtol=3e-5)


def test_midrange_group_raw_int_keys_exact():
    """int32 keys beyond f32's 2^24 integer ceiling group exactly on the
    midrange path (raw integer gid arithmetic, no f32 round-trip)."""
    base = 40_000_000  # > 2^24: f32 cannot represent neighbors exactly
    ids = np.repeat(np.arange(base, base + 5000, dtype=np.int64), 3)
    vals = np.tile(np.array([1.0, 2.0, 4.0], np.float32), 5000)
    db = WarpDB(HostTable.from_dict({"v": vals, "id": ids}))
    res = np.asarray(db.query_sql("SELECT SUM(v) FROM t GROUP BY id"))
    assert len(res) == 5000
    np.testing.assert_allclose(res, np.full(5000, 7.0, np.float32))
    cnt = np.asarray(db.query_sql("SELECT COUNT(v) FROM t GROUP BY id"))
    np.testing.assert_array_equal(cnt, np.full(5000, 3.0, np.float32))


def test_dense_window_matches_sort_window():
    """Stats-bounded integer partition keys take the sort-free window
    path; results must be bit-comparable to the generic sort-based path
    (forced via a fractional key offset)."""
    rng = np.random.default_rng(14)
    n = 4000
    q = rng.integers(0, 50, n).astype(np.float32)
    p = rng.uniform(0, 100, n).astype(np.float32)
    db = WarpDB(HostTable.from_dict({"quantity": q, "price": p}))
    db_frac = WarpDB(
        HostTable.from_dict({"quantity": q + 0.5, "price": p})
    )
    for agg in ("SUM", "AVG", "COUNT", "MIN", "MAX"):
        sql = f"SELECT {agg}(price) OVER (PARTITION BY quantity) FROM t"
        dense = np.asarray(db.query_sql(sql))
        generic = np.asarray(db_frac.query_sql(sql))
        np.testing.assert_allclose(dense, generic, rtol=1e-5)


def test_dense_window_where_compaction():
    rng = np.random.default_rng(15)
    n = 3000
    q = rng.integers(0, 8, n).astype(np.float32)
    p = rng.uniform(0, 100, n).astype(np.float32)
    db = WarpDB(HostTable.from_dict({"quantity": q, "price": p}))
    out = np.asarray(
        db.query_sql(
            "SELECT SUM(price) OVER (PARTITION BY quantity) FROM t "
            "WHERE price > 75"
        )
    )
    m = p > 75
    sums = {k: p[m & (q == k)].sum() for k in np.unique(q)}
    want = np.array([sums[k] for k in q[m]], np.float32)
    np.testing.assert_allclose(out, want, rtol=1e-5)


def test_join_probe_preserving_lookup():
    """1:1 dimension join keeps probe rows in place (no expansion); the
    kernel trace must show the lookup operator, not the expansion."""
    from warpdb_tpu.utils.metrics import last

    rng = np.random.default_rng(16)
    n = 5000
    q = rng.integers(0, 32, n).astype(np.float32)
    p = rng.uniform(0, 100, n).astype(np.float32)
    db = WarpDB(HostTable.from_dict({"quantity": q, "price": p}))
    db.register_table(
        "rates",
        HostTable.from_dict(
            {
                "quantity": np.arange(32, dtype=np.float32),
                "rate": rng.uniform(0, 1, 32).astype(np.float32),
            }
        ),
    )
    out = np.asarray(
        db.query_sql(
            "SELECT price * rates.rate FROM t "
            "JOIN rates ON quantity = rates.quantity"
        )
    )
    ops = [name for name, _hit in last().operators]
    assert "join_lookup" in ops
    assert "join_expand_gather" not in ops
    assert len(out) == n


def test_join_lookup_values_correct():
    rng = np.random.default_rng(17)
    n = 4000
    q = rng.integers(0, 16, n).astype(np.float32)
    p = rng.uniform(0, 100, n).astype(np.float32)
    rate = rng.uniform(0, 1, 16).astype(np.float32)
    db = WarpDB(HostTable.from_dict({"quantity": q, "price": p}))
    db.register_table(
        "rates",
        HostTable.from_dict(
            {
                "quantity": np.arange(16, dtype=np.float32),
                "rate": rate,
            }
        ),
    )
    out = np.asarray(
        db.query_sql(
            "SELECT price * rates.rate FROM t "
            "JOIN rates ON quantity = rates.quantity"
        )
    )
    want = p * rate[q.astype(int)]
    np.testing.assert_allclose(out, want, rtol=1e-6)
    # Multi-column result table rides ONE join materialisation.
    tbl = db.query_sql_table(
        "SELECT price, rates.rate FROM t "
        "JOIN rates ON quantity = rates.quantity WHERE price > 50"
    )
    cols = list(tbl.values())
    m = p > 50
    np.testing.assert_allclose(cols[0], p[m], rtol=1e-6)
    np.testing.assert_allclose(cols[1], rate[q.astype(int)][m], rtol=1e-6)


def test_join_filter_pushdown_matches_filter_after_join():
    """Probe-side WHERE pushdown (compact before the join) must match
    the filter-after-join plan row for row, on INNER and LEFT joins,
    with string predicates, and through the GROUP BY pipeline."""
    from warpdb_tpu.config import get_config

    rng = np.random.default_rng(21)
    n = 8192
    q = rng.integers(0, 64, n).astype(np.float32)
    p = rng.uniform(0, 100, n).astype(np.float32)
    cat = np.array(["red", "green", "blue"], dtype=object)[
        rng.integers(0, 3, n)
    ]
    db = WarpDB(
        HostTable.from_dict(
            {"quantity": q, "price": p, "color": cat},
            dtypes={
                "quantity": DataType.FLOAT32,
                "price": DataType.FLOAT32,
                "color": DataType.STRING,
            },
        )
    )
    # Build side misses keys >= 48 so LEFT fills are exercised.
    db.register_table(
        "rates",
        HostTable.from_dict(
            {
                "quantity": np.arange(48, dtype=np.float32),
                "rate": rng.uniform(0, 1, 48).astype(np.float32),
            }
        ),
    )
    queries = [
        "SELECT price, rate FROM t JOIN rates ON quantity = rates.quantity "
        "WHERE price > 80 ORDER BY price LIMIT 50",
        "SELECT price, rate FROM t LEFT JOIN rates "
        "ON quantity = rates.quantity WHERE price > 95 ORDER BY price",
        "SELECT quantity, SUM(price * rate) FROM t "
        "JOIN rates ON quantity = rates.quantity "
        "WHERE color == 'red' GROUP BY quantity ORDER BY quantity",
        "SELECT COUNT(*) FROM t JOIN rates ON quantity = rates.quantity "
        "WHERE price > 90 AND quantity < 32",
    ]
    for sql in queries:
        get_config().join_filter_pushdown = False
        base = db.query_sql_table(sql)
        get_config().join_filter_pushdown = True
        try:
            pushed = db.query_sql_table(sql)
        finally:
            get_config().join_filter_pushdown = True
        assert list(base.keys()) == list(pushed.keys())
        for b, g in zip(base.values(), pushed.values()):
            np.testing.assert_allclose(
                np.asarray(b, np.float64),
                np.asarray(g, np.float64),
                rtol=1e-5,
                err_msg=sql,
            )
    # The pushdown engaged (memo populated on the probe table).
    assert len(getattr(db.table, "_prefilter_memo", {})) >= 1


def test_build_side_filter_pushdown_matches_filter_after_join():
    """Build-side predicate pushdown (r3): single-relation WHERE
    conjuncts compact their INNER-joined dimension before the join —
    results must match the filter-after-join plan, LEFT-join build
    sides must NOT be filtered, and stripping build conjuncts must
    still leave the probe conjuncts correct."""
    from warpdb_tpu.config import get_config

    rng = np.random.default_rng(27)
    n = 16384
    n_dim = 8192
    k = rng.integers(0, n_dim, n).astype(np.float32)
    p = rng.uniform(0, 100, n).astype(np.float32)
    w = rng.uniform(0, 1, n_dim).astype(np.float32)
    seg = np.array(["gold", "iron", "salt"], dtype=object)[
        rng.integers(0, 3, n_dim)
    ]
    db = WarpDB(HostTable.from_dict({"k": k, "p": p}))
    db.register_table(
        "d",
        HostTable.from_dict(
            {"k2": np.arange(n_dim, dtype=np.float32), "w": w, "seg": seg},
            dtypes={
                "k2": DataType.FLOAT32,
                "w": DataType.FLOAT32,
                "seg": DataType.STRING,
            },
        ),
    )
    queries = [
        # Pure build-side conjunct (numeric).
        "SELECT SUM(p * d.w) FROM t JOIN d ON k = d.k2 WHERE d.w < 0.25",
        # Build string predicate + probe conjunct: build strips, probe
        # pushdown then fires on the remainder.
        "SELECT COUNT(*) FROM t JOIN d ON k = d.k2 "
        "WHERE d.seg = 'gold' AND p > 50",
        # Unqualified build column (unique across the namespace).
        "SELECT SUM(w) FROM t JOIN d ON k = d.k2 WHERE w > 0.9",
        # LEFT join: the build conjunct must stay post-join (filtering
        # the dim would convert matches into NaN misses).
        "SELECT COUNT(*) FROM t LEFT JOIN d ON k = d.k2 WHERE d.w < 0.25",
    ]
    for sql in queries:
        get_config().join_filter_pushdown = False
        base = db.query_sql_table(sql)
        get_config().join_filter_pushdown = True
        try:
            pushed = db.query_sql_table(sql)
        finally:
            get_config().join_filter_pushdown = True
        for b, g in zip(base.values(), pushed.values()):
            np.testing.assert_allclose(
                np.asarray(b, np.float64), np.asarray(g, np.float64),
                rtol=1e-4, err_msg=sql,
            )
    # The dimension-side memo engaged.
    dim_table = db._catalog["d"]
    assert len(getattr(dim_table, "_prefilter_memo", {})) >= 1


def test_join_filter_pushdown_self_join_bails():
    """Self-joins must keep the build side unfiltered — the pushdown
    bails (memo stays empty) and results stay correct."""
    rng = np.random.default_rng(22)
    n = 8192
    k = rng.integers(0, 8, n).astype(np.float32)
    v = rng.uniform(0, 100, n).astype(np.float32)
    db = WarpDB(HostTable.from_dict({"k": k, "v": v}))
    out = db.query_sql_table(
        "SELECT COUNT(*) FROM t a JOIN t b ON a.k = b.k WHERE v > 50"
    )
    # Oracle: per-key pair counts, probe side filtered only.
    per_key = np.bincount(k.astype(int), minlength=8)
    probe = np.bincount(k[v > 50].astype(int), minlength=8)
    want = float(np.sum(probe * per_key))
    assert float(list(out.values())[0][0]) == want
    assert len(getattr(db.table, "_prefilter_memo", {})) == 0


def test_join_dense_phase1_duplicates_and_misses():
    """Small build side with duplicate keys and non-matching probe rows:
    dense phase 1 must agree with the generic sort-merge phase 1."""
    rng = np.random.default_rng(18)
    n = 3000
    q = rng.integers(0, 40, n).astype(np.float32)  # keys 32..39 miss
    p = rng.uniform(0, 100, n).astype(np.float32)
    db = WarpDB(HostTable.from_dict({"quantity": q, "price": p}))
    db.register_table(
        "dup",
        HostTable.from_dict(
            {
                "quantity": np.repeat(
                    np.arange(32, dtype=np.float32), 2
                ),
                "bonus": np.arange(64, dtype=np.float32),
            }
        ),
    )
    out = np.asarray(
        db.query_sql(
            "SELECT COUNT(price) FROM t "
            "JOIN dup ON quantity = dup.quantity "
            "GROUP BY quantity ORDER BY quantity ASC"
        )
    )
    want = np.array(
        [2 * (q == k).sum() for k in range(32)], np.float32
    )
    np.testing.assert_array_equal(out, want)


def test_sorted_group_large_int64_ids_exact_counts():
    """VERDICT r1 item 6: ids beyond f32's 2^24 integer ceiling with a
    key span too wide for the midrange slot table must still group
    exactly — the sort path sorts raw int bits, not f32 casts."""
    rng = np.random.default_rng(19)
    n = 1 << 20
    # 2^18 distinct ids spread over a ~2^27 span starting beyond 2^24:
    # consecutive ids differ by 512, but their f32 images collide in
    # blocks once values pass 2^25.
    ids = (1 << 25) + 512 * rng.integers(0, 1 << 18, n).astype(np.int64)
    vals = np.ones(n, np.float32)
    db = WarpDB(HostTable.from_dict({"v": vals, "id": ids}))
    res = np.asarray(db.query_sql("SELECT COUNT(v) FROM t GROUP BY id"))
    uniq, want = np.unique(ids, return_counts=True)
    assert len(res) == len(uniq)
    np.testing.assert_array_equal(res, want.astype(np.float32))


def test_join_memo_reuses_materialized_join():
    """Device tables are immutable, so repeated queries against the same
    join reuse the materialized join table (no phase-1/lookup relaunch);
    re-registering the build table invalidates by instance identity."""
    from warpdb_tpu.utils.metrics import last

    rng = np.random.default_rng(61)
    n = 4000
    q = rng.integers(0, 16, n).astype(np.float32)
    p = rng.uniform(0, 100, n).astype(np.float32)
    db = WarpDB(HostTable.from_dict({"quantity": q, "price": p}))
    rate = rng.uniform(0, 1, 16).astype(np.float32)
    db.register_table(
        "rates",
        HostTable.from_dict(
            {"quantity": np.arange(16, dtype=np.float32), "rate": rate}
        ),
    )
    sql = ("SELECT price * rates.rate FROM t "
           "JOIN rates ON quantity = rates.quantity")
    first = np.asarray(db.query_sql(sql))
    assert any("join" in name for name, _ in last().operators)
    second = np.asarray(db.query_sql(sql))
    assert not any("join" in name for name, _ in last().operators)
    np.testing.assert_array_equal(first, second)

    # New build-table instance → new uid → the join re-materializes.
    rate2 = rate * 2
    db.register_table(
        "rates",
        HostTable.from_dict(
            {"quantity": np.arange(16, dtype=np.float32), "rate": rate2}
        ),
    )
    third = np.asarray(db.query_sql(sql))
    assert any("join" in name for name, _ in last().operators)
    np.testing.assert_allclose(third, first * 2, rtol=1e-6)


def test_join_semicompact_unique_key_partial_match():
    """Unique build keys + partial match rate (the post-pushdown
    star-schema shape, TPC-H q3): the INNER join compacts the probe to
    matched rows instead of running the expansion machinery — asserted
    via the operator trace, verified against a NumPy oracle for
    aggregates, row projections, a string build column, and a chained
    second join over the compacted output."""
    from warpdb_tpu.utils.metrics import last

    rng = np.random.default_rng(77)
    n, m = 6000, 1500
    # Build keys unique (stride 3) → only ~1/3 of probe rows match.
    k = rng.integers(0, 3 * m, n).astype(np.float32)
    v = rng.uniform(0, 10, n).astype(np.float32)
    bk = (np.arange(m) * 3).astype(np.float32)
    w = rng.uniform(0, 1, m).astype(np.float32)
    tag = np.array(["red", "green", "blue"])[np.arange(m) % 3]
    db = WarpDB(HostTable.from_dict({"k": k, "v": v}))
    db.register_table(
        "b", HostTable.from_dict({"bk": bk, "w": w, "tag": tag})
    )

    db.query_sql("SELECT SUM(v) FROM t JOIN b ON k = b.bk")
    ops = [name for name, _ in last().operators]
    assert "join_semicompact" in ops, ops
    assert "join_expand_gather" not in ops, ops
    got = db.query_sql_table(
        "SELECT SUM(v * b.w) AS s, COUNT(*) AS c FROM t "
        "JOIN b ON k = b.bk"
    )
    mask = np.isin(k, bk)
    wmap = dict(zip(bk.tolist(), w.tolist()))
    want_s = sum(float(vv) * wmap[float(kk)] for kk, vv in zip(k[mask], v[mask]))
    np.testing.assert_allclose(got["s"][0], want_s, rtol=1e-4)
    assert got["c"][0] == mask.sum()

    # Row projection including a string build column, deterministic order.
    got2 = db.query_sql_table(
        "SELECT v, b.tag FROM t JOIN b ON k = b.bk ORDER BY v LIMIT 7"
    )
    tmap = dict(zip(bk.tolist(), tag.tolist()))
    order = np.argsort(v[mask], kind="stable")[:7]
    np.testing.assert_allclose(
        got2["v"], v[mask][order], rtol=1e-6
    )
    assert got2["b.tag"] == [tmap[float(x)] for x in k[mask][order]]

    # Chained second join consumes the compacted (num_rows < padded)
    # output as its probe side.
    db.register_table(
        "b2",
        HostTable.from_dict(
            {"bk2": (np.arange(m) * 6).astype(np.float32),
             "z": np.full(m, 2.0, np.float32)}
        ),
    )
    got3 = db.query_sql_table(
        "SELECT SUM(v * b2.z) AS s FROM t "
        "JOIN b ON k = b.bk JOIN b2 ON k = b2.bk2"
    )
    mask2 = np.isin(k, (np.arange(m) * 6).astype(np.float32))
    np.testing.assert_allclose(
        got3["s"][0], 2.0 * v[mask & mask2].sum(), rtol=1e-4
    )

    # Zero matches: empty result, no crash.
    db.register_table(
        "b3",
        HostTable.from_dict(
            {"bk3": np.array([-5.0, -8.0], np.float32),
             "z": np.array([1.0, 1.0], np.float32)}
        ),
    )
    got4 = db.query_sql_table(
        "SELECT v FROM t JOIN b3 ON k = b3.bk3"
    )
    assert len(got4["v"]) == 0


# --- LEFT OUTER JOIN ----------------------------------------------------------


def test_cross_join():
    """CROSS JOIN: cartesian product via a constant-key equi-join
    (dense phase 1 for small build sides, sort-merge beyond)."""
    db = WarpDB(HostTable.from_dict({"a": np.array([1, 2, 3], np.float32)}))
    db.register_table(
        "u", HostTable.from_dict({"b": np.array([10, 20], np.float32)})
    )
    t = db.query_sql_table("SELECT a, b FROM t CROSS JOIN u ORDER BY a, b")
    assert t["a"] == [1.0, 1.0, 2.0, 2.0, 3.0, 3.0]
    assert t["b"] == [10.0, 20.0, 10.0, 20.0, 10.0, 20.0]
    # Aggregates over the product: sum(a*b) = sum(a) * sum(b).
    assert db.query_sql("SELECT SUM(a * b) FROM t CROSS JOIN u") == [180.0]
    # Aliases + WHERE over the product.
    got = db.query_sql_table(
        "SELECT a, b FROM t AS x CROSS JOIN u y WHERE a > 1 ORDER BY a, b"
    )
    assert got["a"] == [2.0, 2.0, 3.0, 3.0]
    # Chained after an equi-join.
    db.register_table(
        "dim",
        HostTable.from_dict({
            "a": np.array([1, 2, 3], np.float32),
            "r": np.array([2, 4, 8], np.float32),
        }),
    )
    got2 = db.query_sql(
        "SELECT SUM(r * b) FROM t JOIN dim ON a = dim.a CROSS JOIN u"
    )
    assert got2 == [(2 + 4 + 8) * 30.0]
    from warpdb_tpu.errors import ParseError

    with pytest.raises(ParseError, match="CROSS JOIN takes no ON"):
        db.query_sql("SELECT a FROM t CROSS JOIN u ON a = b")
    # A relation aliased `cross` still parses everywhere else.
    assert db.query_sql("SELECT cross.a FROM t AS cross WHERE cross.a > 2") \
        == [3.0]


def test_cross_join_large_build_matches_oracle():
    """A build side past the dense-sweep cap exercises the sort-merge
    expansion with all-equal keys."""
    rng = np.random.default_rng(5)
    n, m = 97, 300  # m > join_dense_build_max on the default config
    a = rng.normal(0, 1, n).astype(np.float32)
    b = rng.normal(0, 1, m).astype(np.float32)
    db = WarpDB(HostTable.from_dict({"a": a}))
    db.register_table("u", HostTable.from_dict({"b": b}))
    got = db.query_sql_table(
        "SELECT COUNT(a) AS c, SUM(a + b) AS s FROM t CROSS JOIN u"
    )
    assert got["c"] == [n * m]
    want = float(m * a.astype(np.float64).sum() + n * b.astype(np.float64).sum())
    assert got["s"][0] == pytest.approx(want, rel=1e-4)


def test_cross_join_streaming(tmp_path):
    """Streaming SQL CROSS JOIN against an in-memory dimension (each
    probe chunk multiplies chunk-locally — no cross-chunk state)."""
    path = tmp_path / "facts.csv"
    path.write_text("a\n" + "\n".join(str(i) for i in range(17)) + "\n")
    dims = {"u": HostTable.from_dict({"b": np.array([1, 2, 4], np.float32)})}
    got = WarpDB.query_streaming_sql(
        str(path), "SELECT SUM(a * b) AS s FROM t CROSS JOIN u",
        rows_per_chunk=5, dims=dims,
    )
    assert got["s"] == [sum(range(17)) * 7.0]


def test_left_join_lookup_fills_nan():
    """LEFT JOIN against a unique-key dimension table: unmatched probe
    rows survive with build columns NaN (probe-preserving path)."""
    q = np.array([0, 1, 2, 3, 7, 1], np.float32)  # 3 and 7 miss
    p = np.array([10, 20, 30, 40, 50, 60], np.float32)
    db = WarpDB(HostTable.from_dict({"quantity": q, "price": p}))
    db.register_table(
        "rates",
        HostTable.from_dict(
            {
                "quantity": np.array([0, 1, 2], np.float32),
                "rate": np.array([0.5, 0.25, 2.0], np.float32),
            }
        ),
    )
    t = db.query_sql_table(
        "SELECT price, rates.rate FROM t "
        "LEFT JOIN rates ON quantity = rates.quantity"
    )
    cols = list(t.values())
    np.testing.assert_allclose(cols[0], p, rtol=1e-6)
    want = np.array([0.5, 0.25, 2.0, np.nan, np.nan, 0.25], np.float32)
    np.testing.assert_allclose(cols[1], want, rtol=1e-6, equal_nan=True)
    # Aggregates over the joined table see all probe rows.
    cnt = db.query_sql(
        "SELECT COUNT(price) FROM t LEFT JOIN rates "
        "ON quantity = rates.quantity"
    )
    assert cnt[0] == len(q)


def test_left_join_expansion_duplicates():
    """General LEFT expansion: duplicate build keys multiply matches,
    unmatched probe rows emit exactly one NaN-filled row."""
    q = np.array([1, 2, 9, 2], np.float32)
    p = np.array([10, 20, 30, 40], np.float32)
    db = WarpDB(HostTable.from_dict({"k": q, "p": p}))
    db.register_table(
        "r",
        HostTable.from_dict(
            {
                "k": np.array([1, 2, 2], np.float32),
                "w": np.array([100, 200, 300], np.float32),
            }
        ),
    )
    t = db.query_sql_table(
        "SELECT p, r.w FROM t LEFT JOIN r ON k = r.k"
    )
    got = sorted(
        zip(list(t.values())[0], list(t.values())[1]),
        key=lambda x: (x[0], x[1]),
    )
    # 1→(10,100); 2→(20,200),(20,300); 9→(30,NaN); 2→(40,200),(40,300)
    assert len(got) == 6
    vals = [g[0] for g in got]
    assert vals == [10.0, 20.0, 20.0, 30.0, 40.0, 40.0]
    assert np.isnan(got[3][1])
    assert {got[1][1], got[2][1]} == {200.0, 300.0}


def test_left_join_string_keys_decode_empty():
    from warpdb_tpu import DataType

    c = np.array(["a", "b", "zz", "a"], dtype=object)
    p = np.array([1, 2, 3, 4], np.float32)
    db = WarpDB(
        HostTable.from_dict(
            {"city": c, "price": p}, dtypes={"city": DataType.STRING}
        )
    )
    db.register_table(
        "geo",
        HostTable.from_dict(
            {
                "city": np.array(["a", "b"], dtype=object),
                "name": np.array(["alpha", "beta"], dtype=object),
            },
            dtypes={"city": DataType.STRING, "name": DataType.STRING},
        ),
    )
    t = db.query_sql_table(
        "SELECT price, geo.name FROM t LEFT JOIN geo ON city = geo.city"
    )
    cols = list(t.values())
    np.testing.assert_allclose(cols[0], p)
    assert cols[1] == ["alpha", "beta", "", "alpha"]


def test_right_join_appends_build_misses():
    """RIGHT JOIN keeps unmatched BUILD rows, probe columns NaN, after
    the inner rows (misses in build row order — deterministic)."""
    db = WarpDB(
        HostTable.from_dict(
            {
                "k": np.array([1, 2, 2], np.float32),
                "p": np.array([10, 20, 40], np.float32),
            }
        )
    )
    db.register_table(
        "r",
        HostTable.from_dict(
            {
                "k": np.array([2, 5, 7], np.float32),
                "w": np.array([200, 500, 700], np.float32),
            }
        ),
    )
    t = db.query_sql_table("SELECT p, r.w FROM t RIGHT JOIN r ON k = r.k")
    got = list(zip(*t.values()))
    assert len(got) == 4
    np.testing.assert_allclose(
        got[0], (20.0, 200.0)
    )
    np.testing.assert_allclose(got[1], (40.0, 200.0))
    assert np.isnan(got[2][0]) and got[2][1] == 500.0
    assert np.isnan(got[3][0]) and got[3][1] == 700.0
    # Aggregates see inner matches + build misses.
    cnt = db.query_sql(
        "SELECT COUNT(w) FROM t RIGHT JOIN r ON k = r.k"
    )
    assert cnt[0] == 4


def test_full_join_keeps_both_sides():
    """FULL OUTER JOIN = LEFT rows plus build-side misses; the build key
    column carries the miss row's key value."""
    db = WarpDB(
        HostTable.from_dict(
            {
                "k": np.array([1, 2, 2], np.float32),
                "p": np.array([10, 20, 40], np.float32),
            }
        )
    )
    db.register_table(
        "r",
        HostTable.from_dict(
            {
                "k": np.array([2, 5], np.float32),
                "w": np.array([200, 500], np.float32),
            }
        ),
    )
    t = db.query_sql_table(
        "SELECT p, r.k, r.w FROM t FULL OUTER JOIN r ON k = r.k"
    )
    got = list(zip(*t.values()))
    # probe-major LEFT rows, then the k=5 build miss appended.
    assert len(got) == 4
    assert got[0][0] == 10.0 and np.isnan(got[0][1]) and np.isnan(got[0][2])
    assert got[1] == (20.0, 2.0, 200.0)
    assert got[2] == (40.0, 2.0, 200.0)
    assert np.isnan(got[3][0]) and got[3][1] == 5.0 and got[3][2] == 500.0


def test_full_join_string_keys():
    """FULL JOIN on string keys: probe-side string columns decode ""
    on build-miss rows (code -1 = the engine's missing marker)."""
    from warpdb_tpu import DataType

    db = WarpDB(
        HostTable.from_dict(
            {
                "city": np.array(["a", "b"], dtype=object),
                "price": np.array([1, 2], np.float32),
            },
            dtypes={"city": DataType.STRING},
        )
    )
    db.register_table(
        "geo",
        HostTable.from_dict(
            {
                "city": np.array(["b", "zz"], dtype=object),
                "name": np.array(["beta", "zulu"], dtype=object),
            },
            dtypes={"city": DataType.STRING, "name": DataType.STRING},
        ),
    )
    t = db.query_sql_table(
        "SELECT city, price, geo.name FROM t "
        "FULL JOIN geo ON city = geo.city"
    )
    cols = list(t.values())
    assert cols[0] == ["a", "b", ""]
    assert cols[1][0] == 1.0 and cols[1][1] == 2.0 and np.isnan(cols[1][2])
    assert cols[2] == ["", "beta", "zulu"]


def test_right_join_matches_swapped_left_join():
    """RIGHT JOIN row multiset == LEFT JOIN with the tables swapped."""
    rng = np.random.default_rng(7)
    ka = rng.integers(0, 20, 200).astype(np.float32)
    va = rng.random(200).astype(np.float32)
    kb = rng.integers(0, 20, 50).astype(np.float32)
    vb = rng.random(50).astype(np.float32)

    db1 = WarpDB(HostTable.from_dict({"k": ka, "va": va}))
    db1.register_table("b", HostTable.from_dict({"k": kb, "vb": vb}))
    right = db1.query_sql_table(
        "SELECT va, b.vb FROM t RIGHT JOIN b ON k = b.k"
    )

    db2 = WarpDB(HostTable.from_dict({"k": kb, "vb": vb}))
    db2.register_table("b", HostTable.from_dict({"k": ka, "va": va}))
    left = db2.query_sql_table(
        "SELECT b.va, vb FROM t LEFT JOIN b ON k = b.k"
    )

    def norm(cols):
        a = np.stack([np.asarray(c, np.float64) for c in cols.values()])
        a = np.where(np.isnan(a), 1e30, a)
        return sorted(map(tuple, a.T))

    assert norm(right) == norm(left)


# --- UNION / UNION ALL --------------------------------------------------------


def test_union_all_concatenates():
    db = WarpDB(
        HostTable.from_dict({"p": np.array([1, 2, 2], np.float32)})
    )
    db.register_table(
        "u", HostTable.from_dict({"q": np.array([2, 9], np.float32)})
    )
    got = db.query_sql("SELECT p FROM t UNION ALL SELECT q FROM u")
    assert got == [1.0, 2.0, 2.0, 2.0, 9.0]


def test_union_dedups_combined():
    db = WarpDB(
        HostTable.from_dict({"p": np.array([1, 2, 2], np.float32)})
    )
    db.register_table(
        "u", HostTable.from_dict({"q": np.array([2, 9], np.float32)})
    )
    got = db.query_sql("SELECT p FROM t UNION SELECT q FROM u")
    assert got == [1.0, 2.0, 9.0]  # first occurrence wins
    # Left-to-right: UNION dedups, then UNION ALL appends duplicates.
    got = db.query_sql(
        "SELECT p FROM t UNION SELECT q FROM u UNION ALL SELECT q FROM u"
    )
    assert got == [1.0, 2.0, 9.0, 2.0, 9.0]


def test_union_trailing_order_limit_applies_to_whole():
    db = WarpDB(
        HostTable.from_dict(
            {
                "p": np.array([5, 1], np.float32),
                "v": np.array([50, 10], np.float32),
            }
        )
    )
    db.register_table(
        "u",
        HostTable.from_dict(
            {
                "p": np.array([3.0], np.float32),
                "v": np.array([30.0], np.float32),
            }
        ),
    )
    t = db.query_sql_table(
        "SELECT p, v FROM t UNION ALL SELECT p, v FROM u "
        "ORDER BY p DESC LIMIT 2"
    )
    assert list(t["p"]) == [5.0, 3.0]
    assert list(t["v"]) == [50.0, 30.0]
    # ORDER BY in a non-final branch is a parse error.
    with pytest.raises(ParseError, match="final"):
        db.query_sql(
            "SELECT p FROM t ORDER BY p ASC UNION SELECT p FROM u"
        )


def test_union_string_columns_across_vocabs():
    """UNION merges decoded strings — branch vocabularies differ."""
    db = WarpDB(
        HostTable.from_dict(
            {"c": np.array(["b", "a"], dtype=object)},
            dtypes={"c": DataType.STRING},
        )
    )
    db.register_table(
        "u",
        HostTable.from_dict(
            {"c": np.array(["a", "z"], dtype=object)},
            dtypes={"c": DataType.STRING},
        ),
    )
    got = db.query_sql("SELECT c FROM t UNION SELECT c FROM u")
    assert got == ["b", "a", "z"]


def test_union_aggregates_per_branch():
    db = WarpDB(
        HostTable.from_dict({"p": np.array([1, 2, 3], np.float32)})
    )
    got = db.query_sql(
        "SELECT MIN(p) FROM t UNION ALL SELECT MAX(p) FROM t"
    )
    assert got == [1.0, 3.0]


def test_union_column_count_mismatch_errors():
    db = WarpDB(
        HostTable.from_dict(
            {
                "p": np.array([1.0], np.float32),
                "v": np.array([2.0], np.float32),
            }
        )
    )
    with pytest.raises(ValidationError, match="same number"):
        db.query_sql_table("SELECT p, v FROM t UNION SELECT p FROM t")


def _setop_db():
    db = WarpDB(
        HostTable.from_dict(
            {"p": np.array([1, 2, 2, 3, 3, 3], np.float32)}
        )
    )
    db.register_table(
        "u", HostTable.from_dict({"q": np.array([2, 3, 3, 9], np.float32)})
    )
    return db


def test_except_distinct_and_all():
    db = _setop_db()
    got = db.query_sql("SELECT p FROM t EXCEPT SELECT q FROM u")
    assert got == [1.0]
    # Bag semantics: multiplicities subtract (2x2 - 1x2, 3x3 - 2x3).
    got = db.query_sql("SELECT p FROM t EXCEPT ALL SELECT q FROM u")
    assert got == [1.0, 2.0, 3.0]


def test_intersect_distinct_and_all():
    db = _setop_db()
    got = db.query_sql("SELECT p FROM t INTERSECT SELECT q FROM u")
    assert got == [2.0, 3.0]
    # Bag semantics: min multiplicity (2: min(2,1)=1; 3: min(3,2)=2).
    got = db.query_sql("SELECT p FROM t INTERSECT ALL SELECT q FROM u")
    assert got == [2.0, 3.0, 3.0]


def test_intersect_binds_tighter_than_union():
    db = _setop_db()
    # A UNION B INTERSECT C == A UNION (B INTERSECT C): the intersect
    # folds into the branch on its left, not the union's result.
    got = db.query_sql(
        "SELECT p FROM t WHERE p < 2 "
        "UNION SELECT p FROM t INTERSECT SELECT q FROM u"
    )
    assert got == [1.0, 2.0, 3.0]
    # Left-to-right without precedence would give ((A ∪ B) ∩ C) = {2,3}.


def test_except_chain_left_to_right():
    db = _setop_db()
    got = db.query_sql(
        "SELECT p FROM t EXCEPT SELECT q FROM u WHERE q > 5 "
        "EXCEPT SELECT q FROM u WHERE q < 3"
    )
    assert got == [1.0, 3.0]


def test_setop_trailing_order_by_applies_to_whole():
    db = _setop_db()
    t = db.query_sql_table(
        "SELECT p FROM t INTERSECT SELECT q FROM u ORDER BY p DESC"
    )
    assert list(t["p"]) == [3.0, 2.0]


def test_setop_strings():
    db = WarpDB(
        HostTable.from_dict(
            {"c": np.array(["a", "b", "c"], dtype=object)},
            dtypes={"c": DataType.STRING},
        )
    )
    db.register_table(
        "u",
        HostTable.from_dict(
            {"c": np.array(["b", "z"], dtype=object)},
            dtypes={"c": DataType.STRING},
        ),
    )
    assert db.query_sql("SELECT c FROM t EXCEPT SELECT c FROM u") == [
        "a",
        "c",
    ]
    assert db.query_sql("SELECT c FROM t INTERSECT SELECT c FROM u") == [
        "b"
    ]


# --- FROM routing over registered tables --------------------------------------


def test_from_registered_table_top_level():
    db = WarpDB(HostTable.from_dict({"p": np.array([1, 2, 3], np.float32)}))
    db.register_table(
        "u", HostTable.from_dict({"q": np.array([7, 8, 9], np.float32)})
    )
    assert db.query_sql("SELECT q FROM u") == [7.0, 8.0, 9.0]
    assert db.query_sql("SELECT SUM(q) FROM u WHERE q > 7") == [17.0]
    t = db.query_sql_table("SELECT q, q + 1 FROM u ORDER BY q DESC LIMIT 2")
    assert list(t["q"]) == [9.0, 8.0]
    # The primary table still resolves by its own name (and any other).
    assert db.query_sql("SELECT p FROM t") == [1.0, 2.0, 3.0]
    plan = db.explain("SELECT q FROM u")
    assert "3 rows" in plan


def test_from_registered_table_strings_and_groups():
    db = WarpDB(HostTable.from_dict({"p": np.array([1.0], np.float32)}))
    db.register_table(
        "u",
        HostTable.from_dict(
            {
                "c": np.array(["x", "y", "x"], dtype=object),
                "v": np.array([1, 2, 4], np.float32),
            },
            dtypes={"c": DataType.STRING, "v": DataType.FLOAT32},
        ),
    )
    t = db.query_sql_table(
        "SELECT c, SUM(v) FROM u GROUP BY c ORDER BY c ASC"
    )
    assert list(t["c"]) == ["x", "y"]
    assert list(t["SUM(v[idx])"]) == [5.0, 2.0]
    # Derived table over a registered table.
    got = db.query_sql(
        "SELECT s FROM (SELECT SUM(v) AS s FROM u GROUP BY c) AS d "
        "ORDER BY s ASC"
    )
    assert got == [2.0, 5.0]


# --- WITH (common table expressions) ------------------------------------------


def test_cte_basic():
    db = WarpDB(
        HostTable.from_dict({"p": np.array([1, 2, 3, 4], np.float32)})
    )
    got = db.query_sql(
        "WITH big AS (SELECT p FROM t WHERE p > 2) SELECT SUM(p) FROM big"
    )
    assert got == [7.0]


def test_cte_chained_and_join():
    db = WarpDB(
        HostTable.from_dict(
            {
                "k": np.array([1, 2, 1, 2], np.float32),
                "v": np.array([10, 20, 30, 40], np.float32),
            }
        )
    )
    t = db.query_sql_table(
        "WITH sums AS (SELECT k, SUM(v) AS s FROM t GROUP BY k), "
        "top AS (SELECT k, s FROM sums WHERE s > 45) "
        "SELECT t.v, top.s FROM t JOIN top ON t.k = top.k"
    )
    assert list(t["t.v"]) == [20.0, 40.0]
    assert list(t["top.s"]) == [60.0, 60.0]


def test_cte_strings_reencode():
    db = WarpDB(
        HostTable.from_dict(
            {
                "c": np.array(["b", "a", "b"], dtype=object),
                "v": np.array([1, 2, 4], np.float32),
            },
            dtypes={"c": DataType.STRING, "v": DataType.FLOAT32},
        )
    )
    got = db.query_sql(
        "WITH f AS (SELECT c, v FROM t WHERE v > 1) "
        "SELECT c FROM f ORDER BY c ASC"
    )
    assert got == ["a", "b"]
    got = db.query_sql(
        "WITH f AS (SELECT c, v FROM t) "
        "SELECT SUM(v) FROM f WHERE c = 'b'"
    )
    assert got == [5.0]


def test_cte_with_set_op_body():
    db = WarpDB(
        HostTable.from_dict({"p": np.array([1, 2, 3], np.float32)})
    )
    got = db.query_sql(
        "WITH u AS (SELECT p FROM t WHERE p < 2 "
        "UNION ALL SELECT p FROM t WHERE p > 2) "
        "SELECT SUM(p) FROM u"
    )
    assert got == [4.0]


def test_cte_memo_reuses_materialization():
    db = WarpDB(
        HostTable.from_dict({"p": np.array([1, 2, 3], np.float32)})
    )
    sql = "WITH c AS (SELECT p + 1 AS q FROM t) SELECT SUM(q) FROM c"
    assert db.query_sql(sql) == [9.0]
    memo = db._cte_memo
    assert len(memo) == 1
    first = next(iter(memo.values()))
    assert db.query_sql(sql) == [9.0]
    assert next(iter(memo.values())) is first  # same DeviceTable reused


def test_cte_unknown_column_errors():
    db = WarpDB(
        HostTable.from_dict({"p": np.array([1.0], np.float32)})
    )
    with pytest.raises(ValidationError, match="Unknown column"):
        db.query_sql("WITH c AS (SELECT nope FROM t) SELECT p FROM t")
    with pytest.raises(ParseError, match="AS"):
        db.query_sql("WITH c (SELECT p FROM t) SELECT p FROM t")


# --- correlated subqueries ----------------------------------------------------


def _corr_db():
    cust = HostTable.from_dict({
        "cid": np.array([1, 2, 3, 4], np.float32),
        "region": np.array([10, 20, 10, 30], np.float32),
    })
    orders = HostTable.from_dict({
        "ocid": np.array([1, 1, 2, 2, 2, 4], np.float32),
        "amt": np.array([5, 7, 3, 9, 2, 8], np.float32),
    })
    db = WarpDB(cust)
    db.register_table("orders", orders)
    return db


def test_correlated_exists():
    """[NOT] EXISTS with an equality correlation decorrelates into a
    LEFT lookup join against a COUNT-grouped derived table."""
    db = _corr_db()
    assert db.query_sql(
        "SELECT cid FROM t WHERE EXISTS "
        "(SELECT 1 FROM orders WHERE ocid = cid)"
    ) == [1.0, 2.0, 4.0]
    assert db.query_sql(
        "SELECT cid FROM t WHERE NOT EXISTS "
        "(SELECT 1 FROM orders WHERE ocid = cid)"
    ) == [3.0]
    # Residual inner predicates filter the derived build side.
    assert db.query_sql(
        "SELECT cid FROM t WHERE EXISTS "
        "(SELECT 1 FROM orders WHERE ocid = cid AND amt > 7)"
    ) == [2.0, 4.0]


def test_correlated_scalar_aggregates():
    db = _corr_db()
    got = db.query_sql_table(
        "SELECT cid, (SELECT SUM(amt) FROM orders WHERE ocid = cid) AS s "
        "FROM t"
    )
    np.testing.assert_allclose(
        got["s"], [12.0, 14.0, np.nan, 8.0], equal_nan=True
    )
    # COUNT over an empty match set is 0, not NULL (standard).
    got = db.query_sql_table(
        "SELECT cid, (SELECT COUNT(amt) FROM orders WHERE ocid = cid) AS c "
        "FROM t"
    )
    assert got["c"] == [2.0, 3.0, 0.0, 1.0]
    # Scalar subquery inside a comparison.
    assert db.query_sql(
        "SELECT cid FROM t WHERE "
        "(SELECT MAX(amt) FROM orders WHERE ocid = cid) > 7"
    ) == [2.0, 4.0]


def test_correlated_in():
    db = _corr_db()
    # Membership against the outer row's own match set.
    assert db.query_sql(
        "SELECT cid FROM t WHERE region IN "
        "(SELECT amt FROM orders WHERE ocid = cid)"
    ) == []
    db2 = WarpDB(HostTable.from_dict({
        "k": np.array([1, 2, 3], np.float32),
        "v": np.array([7, 8, 9], np.float32),
    }))
    db2.register_table("u", HostTable.from_dict({
        "uk": np.array([1, 1, 3], np.float32),
        "uv": np.array([7, 5, 2], np.float32),
    }))
    assert db2.query_sql(
        "SELECT k FROM t WHERE v IN (SELECT uv FROM u WHERE uk = k)"
    ) == [1.0]
    assert db2.query_sql(
        "SELECT k FROM t WHERE v NOT IN (SELECT uv FROM u WHERE uk = k)"
    ) == [2.0, 3.0]


def test_correlated_self_join_aliases():
    """The classic above-department-average query: self-correlation
    through relation aliases, string correlation keys."""
    emp = HostTable.from_dict({
        "name": np.array(["a", "b", "c", "d"], object),
        "dept": np.array(["x", "y", "x", "y"], object),
        "sal": np.array([10.0, 20.0, 30.0, 15.0], np.float32),
    })
    db = WarpDB(emp)
    db.register_table("emp", emp)
    got = db.query_sql_table(
        "SELECT name FROM emp e WHERE sal > "
        "(SELECT AVG(sal) FROM emp i WHERE i.dept = e.dept)"
    )
    assert got["name"] == ["b", "c"]
    # Correlated scalar in the SELECT list, broadcast per outer row.
    got = db.query_sql_table(
        "SELECT name, (SELECT MAX(sal) FROM emp i WHERE i.dept = e.dept) "
        "AS mx FROM emp e"
    )
    assert got["mx"] == [30.0, 20.0, 30.0, 20.0]
    # Grouped outer query over a correlated WHERE.
    got = db.query_sql_table(
        "SELECT dept, COUNT(name) AS n FROM emp e WHERE EXISTS "
        "(SELECT 1 FROM emp i WHERE i.dept = e.dept AND i.sal > 25) "
        "GROUP BY dept"
    )
    assert got["dept"] == ["x"] and got["n"] == [2.0]
    # SELECT * must not leak decorrelation plumbing columns.
    got = db.query_sql_table(
        "SELECT * FROM emp e WHERE EXISTS "
        "(SELECT 1 FROM emp i WHERE i.dept = e.dept AND i.sal > 25)"
    )
    assert set(got.keys()) == {"name", "dept", "sal"}


def test_correlated_unsupported_forms():
    db = _corr_db()
    from warpdb_tpu.errors import UnsupportedError

    with pytest.raises(UnsupportedError, match="column equalities"):
        db.query_sql(
            "SELECT cid FROM t WHERE EXISTS "
            "(SELECT 1 FROM orders WHERE amt > cid)"
        )
    with pytest.raises(UnsupportedError, match="GROUP BY"):
        db.query_sql(
            "SELECT cid FROM t WHERE EXISTS "
            "(SELECT SUM(amt) FROM orders WHERE ocid = cid GROUP BY amt)"
        )
    with pytest.raises(UnsupportedError, match="single aggregate"):
        db.query_sql(
            "SELECT cid, (SELECT amt FROM orders WHERE ocid = cid) FROM t"
        )


def test_correlated_scalar_expression_over_aggregates():
    """The scalar value may be any expression over aggregates (TPC-H
    q17/q20's ``0.2 * AVG(x)`` / ``0.5 * SUM(x)`` thresholds)."""
    db = _corr_db()
    got = db.query_sql_table(
        "SELECT cid, (SELECT 2 * SUM(amt) + COUNT(amt) FROM orders "
        "WHERE ocid = cid) AS s FROM t"
    )
    # cid 1: 2*12+2=26; cid 2: 2*14+3=31; cid 3: no match -> NaN;
    # cid 4: 2*8+1=17.
    np.testing.assert_allclose(
        got["s"], [26.0, 31.0, np.nan, 17.0], equal_nan=True
    )
    # q17 shape: comparison against a scaled AVG.
    assert db.query_sql(
        "SELECT cid FROM t WHERE cid < "
        "(SELECT 0.5 * AVG(amt) FROM orders WHERE ocid = cid)"
    ) == [1.0, 2.0]
    # Bare inner columns outside aggregates stay rejected.
    from warpdb_tpu.errors import UnsupportedError

    with pytest.raises(UnsupportedError, match="inside aggregates"):
        db.query_sql(
            "SELECT cid FROM t WHERE cid < "
            "(SELECT amt + SUM(amt) FROM orders WHERE ocid = cid)"
        )


def test_correlated_exists_neq():
    """EXISTS with one inner.col <> outer.col conjunct (TPC-H q21's
    "another supplier on the same order") decorrelates through
    per-group MIN/MAX of the compared column."""
    li = HostTable.from_dict({
        "okey": np.array([0, 0, 1, 2, 2, 3], np.float32),
        "skey": np.array([1, 2, 1, 1, 1, 2], np.float32),
    })
    db = WarpDB(li)
    db.register_table("lineitem", db.table)
    got = db.query_sql_table(
        "SELECT okey, skey FROM lineitem l1 WHERE EXISTS "
        "(SELECT * FROM lineitem l2 WHERE l2.okey = l1.okey "
        "AND l2.skey != l1.skey) ORDER BY okey ASC, skey ASC"
    )
    # Only order 0 has two distinct suppliers.
    assert got["okey"] == [0.0, 0.0]
    assert got["skey"] == [1.0, 2.0]
    # NOT EXISTS of the same predicate: every single-supplier order row.
    got = db.query_sql(
        "SELECT okey FROM lineitem l1 WHERE NOT EXISTS "
        "(SELECT * FROM lineitem l2 WHERE l2.okey = l1.okey "
        "AND l2.skey != l1.skey) ORDER BY okey ASC"
    )
    assert got == [1.0, 2.0, 2.0, 3.0]
    # With an inner residual filter (q21's late-arrival condition).
    db.register_table("ext", HostTable.from_dict({
        "eokey": np.array([0, 0, 1, 2], np.float32),
        "eskey": np.array([9, 2, 7, 1], np.float32),
        "late": np.array([1, 0, 1, 1], np.float32),
    }))
    got = db.query_sql(
        "SELECT okey FROM lineitem l1 WHERE EXISTS "
        "(SELECT * FROM ext WHERE eokey = l1.okey "
        "AND eskey != l1.skey AND late > 0) "
        "ORDER BY okey ASC"
    )
    # okey 0 rows: ext row (0, 9, late) differs from both suppliers;
    # okey 1 row skey=1: ext (1, 7, late) differs; okey 2 rows skey=1:
    # ext (2, 1, late) equals -> excluded.
    assert got == [0.0, 0.0, 1.0]
    from warpdb_tpu.errors import UnsupportedError

    with pytest.raises(UnsupportedError, match="at most one"):
        db.query_sql(
            "SELECT okey FROM lineitem l1 WHERE EXISTS "
            "(SELECT * FROM ext WHERE eokey != l1.okey "
            "AND eskey != l1.skey)"
        )
    with pytest.raises(UnsupportedError, match="equality correlation"):
        db.query_sql(
            "SELECT okey FROM lineitem l1 WHERE EXISTS "
            "(SELECT * FROM ext WHERE eskey != l1.skey)"
        )
    # <> in a scalar subquery stays rejected.
    with pytest.raises(UnsupportedError, match="only in EXISTS"):
        db.query_sql(
            "SELECT okey FROM lineitem l1 WHERE 1 < "
            "(SELECT COUNT(*) FROM ext WHERE eskey != l1.skey)"
        )


def test_fuzz_correlated_exists_neq_vs_oracle():
    """EXISTS-with-<> vs a NumPy nested-loop oracle (duplicates,
    misses, residuals)."""
    rng = np.random.default_rng(43)
    for _ in range(5):
        n, m = int(rng.integers(20, 60)), int(rng.integers(10, 50))
        k = rng.integers(0, 8, n).astype(np.float32)
        s = rng.integers(0, 4, n).astype(np.float32)
        uk = rng.integers(0, 8, m).astype(np.float32)
        us = rng.integers(0, 4, m).astype(np.float32)
        uf = rng.integers(0, 2, m).astype(np.float32)
        db = WarpDB(HostTable.from_dict({"k": k, "s": s}))
        db.register_table(
            "u", HostTable.from_dict({"uk": uk, "us": us, "uf": uf})
        )
        got = np.array(db.query_sql(
            "SELECT k FROM t WHERE EXISTS "
            "(SELECT * FROM u WHERE uk = k AND us != s AND uf > 0)"
        ), np.float32)
        want = k[np.array([
            bool(np.any((uk == kk) & (us != ss) & (uf > 0)))
            for kk, ss in zip(k, s)
        ])]
        np.testing.assert_allclose(np.sort(got), np.sort(want))


def test_fuzz_correlated_vs_oracle():
    """Correlated EXISTS / scalar aggregates vs a NumPy nested-loop
    oracle over random fact/dim tables (duplicate keys, misses,
    residual predicates)."""
    rng = np.random.default_rng(41)
    for trial in range(5):
        n, m = int(rng.integers(20, 60)), int(rng.integers(10, 50))
        k = rng.integers(0, 12, n).astype(np.float32)
        val = rng.normal(0, 10, n).round(1).astype(np.float32)
        uk = rng.integers(0, 12, m).astype(np.float32)
        uv = rng.normal(0, 10, m).round(1).astype(np.float32)
        db = WarpDB(HostTable.from_dict({"k": k, "val": val}))
        db.register_table(
            "u", HostTable.from_dict({"uk": uk, "uv": uv})
        )
        got = np.array(db.query_sql(
            "SELECT val FROM t WHERE EXISTS "
            "(SELECT 1 FROM u WHERE uk = k AND uv > 0)"
        ), np.float32)
        want = val[np.array([np.any((uk == kk) & (uv > 0)) for kk in k])]
        np.testing.assert_allclose(got, want, rtol=1e-6)

        got2 = np.array(db.query_sql_table(
            "SELECT (SELECT SUM(uv) FROM u WHERE uk = k) AS s FROM t"
        )["s"], np.float32)
        want2 = np.array([
            uv[uk == kk].sum() if np.any(uk == kk) else np.nan
            for kk in k
        ], np.float32)
        np.testing.assert_allclose(
            got2, want2, rtol=1e-4, equal_nan=True
        )


# --- uncorrelated subqueries --------------------------------------------------


def test_scalar_subquery_in_where():
    """WHERE p > (SELECT AVG(p) FROM t): resolved to a constant."""
    p = np.array([1, 2, 3, 4, 5, 6], np.float32)
    db = WarpDB(HostTable.from_dict({"p": p}))
    got = db.query_sql("SELECT p FROM t WHERE p > (SELECT AVG(p) FROM t)")
    np.testing.assert_allclose(got, [4, 5, 6])
    # Scalar subquery over another registered table.
    db.register_table(
        "lim", HostTable.from_dict({"cut": np.array([4.5], np.float32)})
    )
    got = db.query_sql(
        "SELECT p FROM t WHERE p > (SELECT cut FROM lim)"
    )
    np.testing.assert_allclose(got, [5, 6])
    # In the select list, arithmetic with the outer rows.
    got = db.query_sql(
        "SELECT p - (SELECT MIN(p) FROM t) FROM t ORDER BY p ASC"
    )
    np.testing.assert_allclose(got, [0, 1, 2, 3, 4, 5])


def test_scalar_subquery_multi_row_errors():
    db = WarpDB(
        HostTable.from_dict({"p": np.array([1, 2], np.float32)})
    )
    with pytest.raises(ExecutionError, match="2 rows"):
        db.query_sql("SELECT p FROM t WHERE p > (SELECT p FROM t)")


def test_in_subquery_numeric():
    """k IN (SELECT …) over another table; NOT IN negates."""
    k = np.array([1, 2, 3, 4, 5], np.float32)
    v = np.array([10, 20, 30, 40, 50], np.float32)
    db = WarpDB(HostTable.from_dict({"k": k, "v": v}))
    db.register_table(
        "good",
        HostTable.from_dict(
            {
                "k": np.array([2, 4, 9], np.float32),
                "flag": np.array([1, 1, 0], np.float32),
            }
        ),
    )
    got = db.query_sql(
        "SELECT v FROM t WHERE k IN (SELECT k FROM good WHERE flag > 0)"
    )
    np.testing.assert_allclose(got, [20, 40])
    got = db.query_sql(
        "SELECT v FROM t WHERE k NOT IN (SELECT k FROM good)"
    )
    np.testing.assert_allclose(got, [10, 30, 50])
    # Empty subquery result: IN matches nothing, NOT IN matches all.
    got = db.query_sql(
        "SELECT v FROM t WHERE k IN (SELECT k FROM good WHERE flag > 5)"
    )
    assert len(got) == 0


def test_in_subquery_strings():
    from warpdb_tpu import DataType

    c = np.array(["ams", "ber", "cdg", "lhr"], dtype=object)
    p = np.array([1, 2, 3, 4], np.float32)
    db = WarpDB(
        HostTable.from_dict(
            {"city": c, "price": p}, dtypes={"city": DataType.STRING}
        )
    )
    db.register_table(
        "eu",
        HostTable.from_dict(
            {
                "city": np.array(["ams", "cdg", "muc"], dtype=object),
            },
            dtypes={"city": DataType.STRING},
        ),
    )
    got = db.query_sql(
        "SELECT price FROM t WHERE city IN (SELECT city FROM eu)"
    )
    np.testing.assert_allclose(got, [1, 3])


def test_in_subquery_matches_in_list(db):
    """IN (SELECT …) and a literal IN list produce identical results
    (same canonical machinery after resolution)."""
    a = db.query_sql("SELECT price FROM test WHERE quantity IN (3, 5)")
    db.register_table(
        "pick",
        HostTable.from_dict({"q": np.array([3, 5], np.float32)}),
    )
    b = db.query_sql(
        "SELECT price FROM test WHERE quantity IN (SELECT q FROM pick)"
    )
    assert a == b


def test_qualify_top_n_per_group():
    """QUALIFY filters on window results (top-2 per partition)."""
    rng = np.random.default_rng(27)
    n = 2000
    k = rng.integers(0, 10, n).astype(np.float32)
    v = rng.uniform(0, 100, n).astype(np.float32)
    db = WarpDB(HostTable.from_dict({"k": k, "v": v}))
    out = db.query_sql_table(
        "SELECT k, v FROM t QUALIFY "
        "ROW_NUMBER() OVER (PARTITION BY k ORDER BY v DESC) <= 2 "
        "ORDER BY k, v DESC"
    )
    rows = [
        (round(a, 3), round(b, 3)) for a, b in zip(*out.values())
    ]
    exp = []
    for kk in range(10):
        for x in sorted(v[k == kk], reverse=True)[:2]:
            exp.append((float(kk), round(float(np.float32(x)), 3)))
    assert rows == exp


def test_qualify_and_chain_and_hidden_order():
    rng = np.random.default_rng(28)
    n = 500
    k = rng.integers(0, 5, n).astype(np.float32)
    v = rng.uniform(0, 100, n).astype(np.float32)
    db = WarpDB(HostTable.from_dict({"k": k, "v": v}))
    # AND of a window predicate and a row predicate; ORDER BY an
    # expression not in the select list rides as a hidden column.
    out = db.query_sql_table(
        "SELECT k FROM t QUALIFY "
        "RANK() OVER (PARTITION BY k ORDER BY v DESC) == 1 AND v > 10 "
        "ORDER BY v DESC"
    )
    got = list(list(out.values())[0])
    maxes = [(float(np.max(v[k == kk])), float(kk)) for kk in range(5)]
    exp = [kk for mv, kk in sorted(maxes, reverse=True) if mv > 10]
    assert got == exp


def test_qualify_requires_window():
    db = WarpDB("data/test.csv")
    with pytest.raises(WarpDBError):
        db.query_sql("SELECT price FROM test QUALIFY price > 10")


def test_qualify_with_where(db):
    # WHERE filters rows BEFORE the window evaluates; QUALIFY after.
    res = db.query_sql_table(
        "SELECT price FROM test WHERE quantity > 2 QUALIFY "
        "ROW_NUMBER() OVER (ORDER BY price DESC) == 1"
    )
    # quantities 3/4/5 pass → prices 10.5/20/30 → top by price = 30.
    assert list(list(res.values())[0]) == [30.0]


def test_window_in_expression():
    """Window functions embedded in row arithmetic: deviation-from-mean
    and z-scores (each window rides the pipeline as a hidden item; the
    arithmetic evaluates host-side over aligned columns)."""
    rng = np.random.default_rng(41)
    n = 1500
    k = rng.integers(0, 6, n).astype(np.float32)
    v = rng.uniform(0, 100, n).astype(np.float32)
    db = WarpDB(HostTable.from_dict({"k": k, "v": v}))
    out = db.query_sql_table(
        "SELECT k, v - AVG(v) OVER (PARTITION BY k) AS dev FROM t "
        "ORDER BY dev DESC LIMIT 5"
    )
    means = {kk: np.float32(v[k == kk].astype(np.float64).mean())
             for kk in range(6)}
    dev = np.array(
        [np.float32(v[i]) - means[int(k[i])] for i in range(n)]
    )
    exp = sorted(dev, reverse=True)[:5]
    np.testing.assert_allclose(
        list(out.values())[1], exp, rtol=1e-3
    )
    # Two windows in one expression (z-score), WHERE applies first.
    out = db.query_sql_table(
        "SELECT (v - AVG(v) OVER ()) / STDDEV(v) OVER () AS z FROM t "
        "WHERE k < 3 ORDER BY z LIMIT 3"
    )
    sel = v[k < 3].astype(np.float64)
    exp_z = sorted((sel - sel.mean()) / sel.std(ddof=1))[:3]
    np.testing.assert_allclose(list(out.values())[0], exp_z, rtol=1e-3)


def test_variance_window():
    # STDDEV/VARIANCE OVER (...) rewrite to SUM/COUNT windows.
    rng = np.random.default_rng(42)
    n = 900
    k = rng.integers(0, 3, n).astype(np.float32)
    v = rng.uniform(0, 50, n).astype(np.float32)
    db = WarpDB(HostTable.from_dict({"k": k, "v": v}))
    out = db.query_sql_table(
        "SELECT k, STDDEV(v) OVER (PARTITION BY k) FROM t ORDER BY k"
    )
    kk, sd = list(out.values())
    for g in range(3):
        want = v[k == g].astype(np.float64).std(ddof=1)
        got = [s for key, s in zip(kk, sd) if key == g]
        assert got == pytest.approx([want] * len(got), rel=1e-3)


def test_window_expression_mixed_agg_rejected():
    db = WarpDB("data/test.csv")
    with pytest.raises(WarpDBError):
        db.query_sql("SELECT SUM(price) + AVG(price) OVER () FROM test")


def test_named_window_clause():
    """WINDOW w AS (spec) + OVER w (SQL:2003 named windows)."""
    rng = np.random.default_rng(29)
    n = 400
    k = rng.integers(0, 4, n).astype(np.float32)
    v = rng.uniform(0, 100, n).astype(np.float32)
    db = WarpDB(HostTable.from_dict({"k": k, "v": v}))
    named = db.query_sql_table(
        "SELECT k, v, ROW_NUMBER() OVER w FROM t "
        "WINDOW w AS (PARTITION BY k ORDER BY v DESC) "
        "QUALIFY ROW_NUMBER() OVER w == 1 ORDER BY k"
    )
    inline = db.query_sql_table(
        "SELECT k, v, ROW_NUMBER() OVER (PARTITION BY k ORDER BY v DESC) "
        "FROM t QUALIFY "
        "ROW_NUMBER() OVER (PARTITION BY k ORDER BY v DESC) == 1 "
        "ORDER BY k"
    )
    for a, b in zip(named.values(), inline.values()):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b))
    # Two named windows in one statement.
    out = db.query_sql_table(
        "SELECT SUM(v) OVER w1, RANK() OVER w2 FROM t "
        "WINDOW w1 AS (PARTITION BY k), "
        "w2 AS (PARTITION BY k ORDER BY v) LIMIT 2"
    )
    assert len(out) == 2
    with pytest.raises(WarpDBError):
        db.query_sql("SELECT RANK() OVER nope FROM t")


def test_quantified_any_all(db):
    """expr op ANY|SOME|ALL (SELECT …) — min/max/IN resolution.
    prices 10.5/20/15.25/30, quantities 3/4/2/5."""
    # > ALL: greater than max(quantity)=5 → every price.
    assert db.query_sql(
        "SELECT price FROM test WHERE price > ALL (SELECT quantity FROM test)"
    ) == [10.5, 20.0, 15.25, 30.0]
    # < ANY: less than max(quantity)=5 → none.
    assert db.query_sql(
        "SELECT price FROM test WHERE price < ANY (SELECT quantity FROM test)"
    ) == []
    # = ANY ≡ IN.
    assert db.query_sql(
        "SELECT price FROM test WHERE quantity = ANY "
        "(SELECT quantity FROM test WHERE price > 19)"
    ) == [20.0, 30.0]
    # <> ALL ≡ NOT IN.
    assert db.query_sql(
        "SELECT price FROM test WHERE quantity != ALL "
        "(SELECT quantity FROM test WHERE price > 19)"
    ) == [10.5, 15.25]
    # SOME is a synonym for ANY; empty set: ANY → false, ALL → true.
    assert db.query_sql(
        "SELECT price FROM test WHERE price > SOME "
        "(SELECT price FROM test WHERE price > 100)"
    ) == []
    assert db.query_sql(
        "SELECT price FROM test WHERE price > ALL "
        "(SELECT price FROM test WHERE price > 100)"
    ) == [10.5, 20.0, 15.25, 30.0]
    # = ALL over a single-valued set; multi-valued set is always false.
    assert db.query_sql(
        "SELECT price FROM test WHERE quantity = ALL "
        "(SELECT quantity FROM test WHERE quantity == 4)"
    ) == [20.0]
    assert db.query_sql(
        "SELECT price FROM test WHERE quantity = ALL "
        "(SELECT quantity FROM test)"
    ) == []
    # != ANY with a multi-valued set is always true.
    assert db.query_sql(
        "SELECT price FROM test WHERE quantity != ANY "
        "(SELECT quantity FROM test)"
    ) == [10.5, 20.0, 15.25, 30.0]


def test_quantified_any_all_strings():
    db = WarpDB(
        HostTable.from_dict(
            {
                "name": np.array(["ant", "bee", "cow", "dog"], dtype=object),
                "v": np.array([1, 2, 3, 4], np.float32),
            },
            dtypes={"name": DataType.STRING, "v": DataType.FLOAT32},
        )
    )
    out = db.query_sql_table(
        "SELECT v FROM t WHERE name > ALL "
        "(SELECT name FROM t WHERE v < 3)"
    )
    # name > max('ant','bee') = 'bee' → cow, dog.
    assert list(list(out.values())[0]) == [3.0, 4.0]
    out = db.query_sql_table(
        "SELECT v FROM t WHERE name = ANY (SELECT name FROM t WHERE v > 3)"
    )
    assert list(list(out.values())[0]) == [4.0]


def test_inner_join_keyword_variants(db):
    a = db.query_sql(
        "SELECT price FROM test JOIN test ON quantity = quantity "
        "ORDER BY price ASC"
    )
    b = db.query_sql(
        "SELECT price FROM test INNER JOIN test ON quantity = quantity "
        "ORDER BY price ASC"
    )
    assert a == b


def test_running_window_min_max():
    """Running MIN/MAX over ordered partitions (r2: segmented doubling
    scan replaced the associative_scan, unlocking order statistics)."""
    k = np.array([1, 1, 1, 2, 2], np.float32)
    o = np.array([1, 2, 3, 1, 2], np.float32)
    v = np.array([5.0, 3.0, 4.0, 7.0, 9.0], np.float32)
    db = WarpDB(HostTable.from_dict({"k": k, "o": o, "v": v}))
    got_min = np.asarray(
        db.query_sql("SELECT MIN(v) OVER (PARTITION BY k ORDER BY o) FROM t")
    )
    np.testing.assert_allclose(got_min, [5, 3, 3, 7, 7])
    got_max = np.asarray(
        db.query_sql("SELECT MAX(v) OVER (PARTITION BY k ORDER BY o) FROM t")
    )
    np.testing.assert_allclose(got_max, [5, 5, 5, 7, 9])
    # DESC order runs the scan over the reversed order.
    got_desc = np.asarray(
        db.query_sql(
            "SELECT MAX(v) OVER (PARTITION BY k ORDER BY o DESC) FROM t"
        )
    )
    np.testing.assert_allclose(got_desc, [5, 4, 4, 9, 9])


def test_running_window_scan_matches_numpy_large():
    rng = np.random.default_rng(71)
    n = 5000
    k = rng.integers(0, 7, n).astype(np.float32)
    o = rng.permutation(n).astype(np.float32)
    v = rng.uniform(-5, 5, n).astype(np.float32)
    db = WarpDB(HostTable.from_dict({"k": k, "o": o, "v": v}))
    got = np.asarray(
        db.query_sql("SELECT SUM(v) OVER (PARTITION BY k ORDER BY o) FROM t")
    )
    want = np.zeros(n, np.float64)
    for kk in np.unique(k):
        idx = np.where(k == kk)[0]
        order = idx[np.argsort(o[idx], kind="stable")]
        want[order] = np.cumsum(v[order].astype(np.float64))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


# --- eager join aggregation (aggregate pushdown through joins) ----------------


def _with_eja(flag):
    import dataclasses

    from warpdb_tpu.config import EngineConfig, get_config, set_config

    base = get_config()
    cfg = EngineConfig(**{
        f.name: getattr(base, f.name)
        for f in dataclasses.fields(EngineConfig)
    })
    cfg.eager_join_aggregation = flag
    cfg.join_cache_entries = 0
    return base, cfg


@pytest.mark.parametrize("seed", range(6))
def test_eager_join_aggregate_equivalence(seed):
    """The pushdown rewrite must be result-equivalent to the plain
    expansion join across aggregate shapes, duplicate build keys,
    missing probe keys and HAVING/ORDER BY."""
    from warpdb_tpu.config import set_config

    rng = np.random.default_rng(9000 + seed)
    n = 3000
    k = rng.integers(0, 25, n).astype(np.float32)   # keys 20..24 miss dim
    p = rng.uniform(1, 10, n).astype(np.float32)
    g = rng.integers(0, 6, n).astype(np.float32)
    dimk = np.repeat(np.arange(20, dtype=np.float32),
                     rng.integers(1, 4, 20))        # duplicate build keys
    w = rng.uniform(0.5, 2.0, len(dimk)).astype(np.float32)

    db = WarpDB(HostTable.from_dict({"k": k, "p": p, "g": g}))
    db.register_table("dim", HostTable.from_dict({"k": dimk, "w": w}))

    sqls = [
        "SELECT SUM(p * dim.w) FROM t JOIN dim ON k = dim.k "
        "GROUP BY g ORDER BY g ASC",
        "SELECT COUNT(p) FROM t JOIN dim ON k = dim.k "
        "GROUP BY g ORDER BY g ASC",
        "SELECT AVG(p) FROM t JOIN dim ON k = dim.k "
        "GROUP BY g ORDER BY g ASC",
        "SELECT SUM(p), MIN(p), MAX(dim.w) FROM t JOIN dim ON k = dim.k "
        "WHERE p > 3 GROUP BY g ORDER BY g ASC",
        "SELECT SUM(dim.w) FROM t JOIN dim ON k = dim.k "
        "GROUP BY g HAVING COUNT(p) > 50 ORDER BY SUM(dim.w) DESC",
        "SELECT g, SUM(p * dim.w) / COUNT(p) FROM t "
        "JOIN dim ON k = dim.k GROUP BY g ORDER BY g ASC",
    ]
    base, cfg_on = _with_eja(True)
    _, cfg_off = _with_eja(False)
    try:
        for sql in sqls:
            set_config(cfg_on)
            got = db.query_sql_table(sql)
            set_config(cfg_off)
            want = db.query_sql_table(sql)
            for (kn, gv), (_, wv) in zip(got.items(), want.items()):
                np.testing.assert_allclose(
                    np.asarray(gv, np.float32),
                    np.asarray(wv, np.float32),
                    rtol=2e-4, atol=1e-3, err_msg=f"{sql} :: {kn}",
                )
    finally:
        set_config(base)


def test_eager_join_aggregate_trace_avoids_expansion():
    """With the rewrite on, the 1:N join never expands — the trace shows
    the pre-aggregation + lookup, not join_expand_gather."""
    from warpdb_tpu.config import set_config
    from warpdb_tpu.utils.metrics import last

    rng = np.random.default_rng(91)
    n = 4000
    k = rng.integers(0, 16, n).astype(np.float32)
    p = rng.uniform(0, 10, n).astype(np.float32)
    db = WarpDB(HostTable.from_dict({"k": k, "p": p}))
    db.register_table(
        "dim",
        HostTable.from_dict(
            {
                "k": np.tile(np.arange(16, dtype=np.float32), 3),
                "w": rng.uniform(0, 1, 48).astype(np.float32),
            }
        ),
    )
    base, cfg_on = _with_eja(True)
    try:
        set_config(cfg_on)
        db.query_sql(
            "SELECT SUM(p * dim.w) FROM t JOIN dim ON k = dim.k "
            "GROUP BY k ORDER BY k ASC"
        )
        ops = [name for name, _hit in last().operators]
        assert "join_expand_gather" not in ops, ops
        assert "join_lookup" in ops, ops
    finally:
        set_config(base)


def test_eager_join_aggregate_string_key():
    from warpdb_tpu import DataType
    from warpdb_tpu.config import set_config

    rng = np.random.default_rng(92)
    n = 2000
    cities = np.array(["ams", "ber", "cdg"], dtype=object)
    c = cities[rng.integers(0, 3, n)]
    p = rng.uniform(0, 10, n).astype(np.float32)
    db = WarpDB(
        HostTable.from_dict(
            {"city": c, "p": p}, dtypes={"city": DataType.STRING}
        )
    )
    db.register_table(
        "geo",
        HostTable.from_dict(
            {
                "city": np.array(
                    ["ber", "ams", "cdg", "ams"], dtype=object
                ),
                "w": np.array([1.0, 2.0, 3.0, 4.0], np.float32),
            },
            dtypes={"city": DataType.STRING},
        ),
    )
    base, cfg_on = _with_eja(True)
    _, cfg_off = _with_eja(False)
    try:
        sql = ("SELECT SUM(p * geo.w) FROM t JOIN geo ON city = geo.city "
               "GROUP BY city ORDER BY city ASC")
        set_config(cfg_on)
        got = np.asarray(db.query_sql(sql))
        set_config(cfg_off)
        want = np.asarray(db.query_sql(sql))
        np.testing.assert_allclose(got, want, rtol=1e-4)
    finally:
        from warpdb_tpu.config import set_config as _sc

        _sc(base)


def test_dense_rank():
    k = np.array([1, 1, 1, 1, 2, 2], np.float32)
    o = np.array([10, 10, 20, 30, 5, 5], np.float32)
    db = WarpDB(HostTable.from_dict({"k": k, "o": o}))
    got = np.asarray(
        db.query_sql(
            "SELECT DENSE_RANK() OVER (PARTITION BY k ORDER BY o) FROM t"
        )
    )
    np.testing.assert_allclose(got, [1, 1, 2, 3, 1, 1])
    got_rank = np.asarray(
        db.query_sql("SELECT RANK() OVER (PARTITION BY k ORDER BY o) FROM t")
    )
    np.testing.assert_allclose(got_rank, [1, 1, 3, 4, 1, 1])
    # A column named dense_rank stays an ordinary identifier.
    db2 = WarpDB(
        HostTable.from_dict({"dense_rank": np.array([7.0, 8.0], np.float32)})
    )
    np.testing.assert_allclose(
        np.asarray(db2.query_sql("SELECT dense_rank FROM t")), [7.0, 8.0]
    )


def test_lag_lead():
    k = np.array([1, 1, 1, 2, 2], np.float32)
    o = np.array([1, 2, 3, 1, 2], np.float32)
    v = np.array([10.0, 20.0, 30.0, 40.0, 50.0], np.float32)
    db = WarpDB(HostTable.from_dict({"k": k, "o": o, "v": v}))
    lag = np.asarray(
        db.query_sql("SELECT LAG(v) OVER (PARTITION BY k ORDER BY o) FROM t")
    )
    np.testing.assert_allclose(
        lag, [np.nan, 10, 20, np.nan, 40], equal_nan=True
    )
    lead = np.asarray(
        db.query_sql("SELECT LEAD(v) OVER (PARTITION BY k ORDER BY o) FROM t")
    )
    np.testing.assert_allclose(
        lead, [20, 30, np.nan, 50, np.nan], equal_nan=True
    )
    # DESC order reverses the neighbour direction.
    lag_d = np.asarray(
        db.query_sql(
            "SELECT LAG(v) OVER (PARTITION BY k ORDER BY o DESC) FROM t"
        )
    )
    np.testing.assert_allclose(
        lag_d, [20, 30, np.nan, 50, np.nan], equal_nan=True
    )
    # LAG without ORDER BY is rejected; a bare `lag` column still works.
    from warpdb_tpu.errors import UnsupportedError

    with pytest.raises(UnsupportedError, match="LAG/LEAD"):
        db.query_sql("SELECT LAG(v) OVER (PARTITION BY k) FROM t")
    db3 = WarpDB(HostTable.from_dict({"lag": np.array([3.0], np.float32)}))
    np.testing.assert_allclose(
        np.asarray(db3.query_sql("SELECT lag FROM t")), [3.0]
    )


def test_percentile_aggregate():
    rng = np.random.default_rng(93)
    n = 4000
    k = rng.integers(0, 5, n).astype(np.float32)
    v = rng.uniform(0, 100, n).astype(np.float32)
    db = WarpDB(HostTable.from_dict({"k": k, "v": v}))
    for q in (0.0, 0.25, 0.9, 1.0):
        got = np.asarray(
            db.query_sql(
                f"SELECT PERCENTILE(v, {q}) FROM t GROUP BY k "
                "ORDER BY k ASC"
            )
        )
        want = np.array(
            [np.percentile(v[k == kk].astype(np.float64), q * 100)
             for kk in np.unique(k)],
            np.float32,
        )
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    # Global form + equivalence of MEDIAN and PERCENTILE 0.5.
    g = float(db.query_sql("SELECT PERCENTILE(v, 0.95) FROM t")[0])
    assert abs(g - np.percentile(v.astype(np.float64), 95)) < 1e-2
    m = float(db.query_sql("SELECT MEDIAN(v) FROM t")[0])
    p50 = float(db.query_sql("SELECT PERCENTILE(v, 0.5) FROM t")[0])
    assert abs(m - p50) < 1e-4
    # Quantile bounds validated at parse time.
    from warpdb_tpu.errors import ParseError

    with pytest.raises(ParseError, match="between 0 and 1"):
        db.query_sql("SELECT PERCENTILE(v, 1.5) FROM t")
    # A column named percentile keeps working.
    db2 = WarpDB(
        HostTable.from_dict({"percentile": np.array([4.0], np.float32)})
    )
    np.testing.assert_allclose(
        np.asarray(db2.query_sql("SELECT percentile FROM t")), [4.0]
    )


def test_infinite_stats_bounds_fall_back_safely():
    """Columns containing ±inf give infinite stats bounds; every
    stats-gated fast path must fall back (not crash on int(inf)) and
    produce correct results via the sort paths."""
    rng = np.random.default_rng(6)
    n = 3000
    g = rng.integers(0, 10, n).astype(np.float32)
    g[5] = np.inf
    v = rng.uniform(0, 10, n).astype(np.float32)
    db = WarpDB(HostTable.from_dict({"g": g, "v": v}))
    out = np.asarray(
        db.query_sql("SELECT COUNT(v) FROM t GROUP BY g ORDER BY g ASC")
    )
    uniq, want = np.unique(g, return_counts=True)
    assert len(out) == len(uniq)
    np.testing.assert_array_equal(out, want.astype(np.float32))
    # window over the inf-bounded partition key
    win = np.asarray(
        db.query_sql("SELECT SUM(v) OVER (PARTITION BY g) FROM t")
    )
    sums = {k: v[g == k].sum() for k in uniq}
    np.testing.assert_allclose(
        win, [sums[k] for k in g], rtol=1e-4
    )
    # DISTINCT and EXPLAIN over the same column
    d = np.asarray(db.query_sql("SELECT DISTINCT g FROM t"))
    np.testing.assert_allclose(d, uniq)
    assert "Plan for" in db.explain(
        "SELECT SUM(v) FROM t GROUP BY g"
    )
    assert "window" in db.explain(
        "SELECT SUM(v) OVER (PARTITION BY g) FROM t"
    )
    assert "distinct" in db.explain("SELECT DISTINCT g FROM t")


def test_nan_group_keys_form_one_group():
    """All NaNs group together (canonical-NaN float_sort_key semantics)
    and rank last in the default ascending group order, on both the
    sorted and dense-window paths."""
    k = np.array([1.0, np.nan, 2.0, np.nan, 1.0], np.float32)
    v = np.array([10.0, 5.0, 20.0, 7.0, 30.0], np.float32)
    db = WarpDB(HostTable.from_dict({"k": k, "v": v}))
    out = np.asarray(db.query_sql("SELECT SUM(v) FROM t GROUP BY k"))
    np.testing.assert_allclose(out, [40.0, 20.0, 12.0])
    cnt = np.asarray(db.query_sql("SELECT COUNT(v) FROM t GROUP BY k"))
    np.testing.assert_allclose(cnt, [2.0, 1.0, 2.0])
    # Window partitions group NaN keys together too (sort path — stats
    # have null_count>0 so the dense gate stays off).
    win = np.asarray(
        db.query_sql("SELECT SUM(v) OVER (PARTITION BY k) FROM t")
    )
    np.testing.assert_allclose(win, [40.0, 12.0, 20.0, 12.0, 40.0])
    # DISTINCT keeps one NaN.
    d = np.asarray(db.query_sql("SELECT DISTINCT k FROM t"))
    assert len(d) == 3 and np.isnan(d[2])


# --- derived tables (FROM subqueries) -----------------------------------------


def test_from_subquery_basic():
    rng = np.random.default_rng(95)
    q = rng.integers(0, 10, 4000).astype(np.float32)
    p = rng.uniform(0, 100, 4000).astype(np.float32)
    db = WarpDB(HostTable.from_dict({"quantity": q, "price": p}))
    out = np.asarray(
        db.query_sql(
            "SELECT s FROM (SELECT quantity AS k, SUM(price) AS s "
            "FROM t GROUP BY quantity) AS agg "
            "WHERE s > 15000 ORDER BY s DESC"
        )
    )
    sums = {kk: p[q == kk].sum() for kk in np.unique(q)}
    want = sorted([v for v in sums.values() if v > 15000], reverse=True)
    np.testing.assert_allclose(out, want, rtol=1e-4)
    # Aggregate over the derived table (aggregation of aggregates).
    mx = float(
        db.query_sql(
            "SELECT MAX(s) FROM (SELECT SUM(price) AS s FROM t "
            "GROUP BY quantity) AS agg"
        )[0]
    )
    assert abs(mx - max(sums.values())) < 1e-1
    # Multi-column outer select stays row-aligned.
    t = db.query_sql_table(
        "SELECT k, s FROM (SELECT quantity AS k, SUM(price) AS s FROM t "
        "GROUP BY quantity) AS agg ORDER BY k ASC"
    )
    cols = list(t.values())
    np.testing.assert_allclose(cols[0], sorted(sums))
    np.testing.assert_allclose(
        cols[1], [sums[kk] for kk in sorted(sums)], rtol=1e-4
    )


def test_from_subquery_nested_and_strings():
    from warpdb_tpu import DataType

    c = np.array(["b", "a", "b", "c", "a"], dtype=object)
    v = np.array([1.0, 2.0, 3.0, 4.0, 5.0], np.float32)
    db = WarpDB(
        HostTable.from_dict(
            {"cat": c, "v": v}, dtypes={"cat": DataType.STRING}
        )
    )
    # String column passes through the derived table (re-encoded) and
    # still binds literals in the outer WHERE.
    out = db.query_sql_table(
        "SELECT cat, total FROM (SELECT cat, SUM(v) AS total FROM t "
        "GROUP BY cat) AS agg WHERE cat != 'c' ORDER BY cat ASC"
    )
    assert out["cat"] == ["a", "b"]
    np.testing.assert_allclose(out["total"], [7.0, 4.0])
    # Two levels of nesting.
    out2 = np.asarray(
        db.query_sql(
            "SELECT MAX(total) FROM (SELECT cat, total FROM "
            "(SELECT cat, SUM(v) AS total FROM t GROUP BY cat) AS inner1"
            ") AS outer1"
        )
    )
    np.testing.assert_allclose(out2, [7.0])
    # Unknown outer column errors cleanly.
    from warpdb_tpu.errors import ValidationError

    with pytest.raises(ValidationError, match="Unknown column"):
        db.query_sql(
            "SELECT nope FROM (SELECT SUM(v) AS total FROM t) AS agg"
        )
    # EXPLAIN renders the derived-table line.
    assert "derived table" in db.explain(
        "SELECT total FROM (SELECT SUM(v) AS total FROM t GROUP BY cat) "
        "AS agg ORDER BY total ASC"
    )


def test_from_subquery_memoised():
    from warpdb_tpu.utils.metrics import last

    rng = np.random.default_rng(96)
    q = rng.integers(0, 6, 2000).astype(np.float32)
    p = rng.uniform(0, 10, 2000).astype(np.float32)
    db = WarpDB(HostTable.from_dict({"quantity": q, "price": p}))
    sql = ("SELECT s FROM (SELECT SUM(price) AS s FROM t "
           "GROUP BY quantity) AS agg ORDER BY s ASC")
    a = db.query_sql(sql)
    b = db.query_sql(sql)
    assert a == b
    # Second run reuses the materialized derived table: every operator
    # in the trace is a cache hit and no grouped kernel re-runs on the
    # base table.
    assert all(hit for _n, hit in last().operators)


def test_eager_join_aggregate_keeps_column_names():
    """The eager-aggregation rewrite must be invisible in the result
    schema: rewritten items keep their original display names, and the
    per-table rewrite memo must not share entries between queries that
    differ only by AS aliases (canonical() is alias-insensitive)."""
    rng = np.random.default_rng(97)
    n = 500
    db = WarpDB(HostTable.from_dict({
        "g": rng.integers(0, 5, n).astype(np.float32),
        "k": rng.integers(0, 10, n).astype(np.float32),
        "v": rng.uniform(0, 50, n).astype(np.float32),
    }))
    db.register_table("d", HostTable.from_dict({
        "k": np.arange(10, dtype=np.float32),
        "w": rng.uniform(0.5, 2, 10).astype(np.float32),
    }))
    base = "FROM t JOIN d ON k = d.k GROUP BY g ORDER BY g ASC"
    out = db.query_sql_table(f"SELECT g, AVG(v * d.w) {base}")
    assert list(out) == ["g", "AVG((v[idx] * d.w[idx]))"]
    out = db.query_sql_table(f"SELECT g, SUM(v * d.w) {base}")
    assert list(out) == ["g", "SUM((v[idx] * d.w[idx]))"]
    # Same canonical plan, different alias: the memo must not leak the
    # bare name (nor vice versa on the repeat of the bare form).
    out = db.query_sql_table(f"SELECT g, SUM(v * d.w) AS s {base}")
    assert list(out) == ["g", "s"]
    out = db.query_sql_table(f"SELECT g, SUM(v * d.w) {base}")
    assert list(out) == ["g", "SUM((v[idx] * d.w[idx]))"]


# --- scalar-expression extensions: unary minus, %, NULL handling, CAST,
# --- variance family ---------------------------------------------------------


def test_unary_minus_and_modulo(db):
    p = np.array([10.5, 20.0, 15.25, 30.0])
    np.testing.assert_allclose(db.query_sql("SELECT -price FROM test"), -p)
    np.testing.assert_allclose(
        db.query_sql("SELECT price % 7 FROM test"), np.fmod(p, 7), rtol=1e-6
    )
    # Unary minus composes with precedence: -2 * -3 = 6.
    np.testing.assert_allclose(
        db.query_sql("SELECT 1 + -2 * -3 FROM test LIMIT 1"), [7.0]
    )
    # fmod keeps the dividend's sign (C semantics, not Python floor-mod).
    np.testing.assert_allclose(
        db.query_sql("SELECT (0 - price) % 7 FROM test"),
        np.fmod(-p, 7),
        rtol=1e-6,
    )


def test_is_null_and_null_literal():
    t = HostTable.from_dict({
        "v": np.array([1.0, np.nan, 3.0, np.nan], np.float32),
        "k": np.array([0.0, 1.0, 2.0, 3.0], np.float32),
    })
    db = WarpDB(t)
    assert db.query_sql("SELECT k FROM t WHERE v IS NULL") == [1.0, 3.0]
    assert db.query_sql("SELECT k FROM t WHERE v IS NOT NULL") == [0.0, 2.0]
    # Bare NULL literal evaluates to NaN (the engine's missing marker).
    out = db.query_sql("SELECT CASE WHEN v IS NULL THEN NULL ELSE v END FROM t")
    assert out[0] == 1.0 and np.isnan(out[1]) and out[2] == 3.0


def test_coalesce_nullif_greatest_least():
    t = HostTable.from_dict({
        "a": np.array([1.0, np.nan, np.nan], np.float32),
        "b": np.array([10.0, 20.0, np.nan], np.float32),
    })
    db = WarpDB(t)
    out = db.query_sql("SELECT COALESCE(a, b, 0) FROM t")
    np.testing.assert_allclose(out, [1.0, 20.0, 0.0])
    out = db.query_sql("SELECT NULLIF(b, 20) FROM t")
    assert out[0] == 10.0 and np.isnan(out[1]) and np.isnan(out[2])
    out = db.query_sql("SELECT GREATEST(a, b, 5) FROM t")
    np.testing.assert_allclose(out[:2], [10.0, np.nan])
    out = db.query_sql("SELECT LEAST(b, 15) FROM t")
    np.testing.assert_allclose(out[:2], [10.0, 15.0])


def test_cast(db):
    np.testing.assert_allclose(
        db.query_sql("SELECT CAST(price AS INT) FROM test"),
        [10.0, 20.0, 15.0, 30.0],
    )
    np.testing.assert_allclose(
        db.query_sql("SELECT CAST(price AS FLOAT) FROM test"),
        [10.5, 20.0, 15.25, 30.0],
    )
    np.testing.assert_allclose(
        db.query_sql("SELECT CAST(price AS BOOLEAN) FROM test"),
        [1.0, 1.0, 1.0, 1.0],
    )
    # Truncation is toward zero (C semantics).
    np.testing.assert_allclose(
        db.query_sql("SELECT CAST(0 - price AS INT) FROM test"),
        [-10.0, -20.0, -15.0, -30.0],
    )
    with pytest.raises(ParseError, match="Unsupported CAST type"):
        db.query_sql("SELECT CAST(price AS BLOB) FROM test")


def test_composite_key_dense_group():
    """Composite GROUP BY keys pack into one dense gid when the product
    of the stats-proven widths fits the dense/midrange tier (r3) —
    group order and results must match the sort path exactly."""
    rng = np.random.default_rng(41)
    n = 20_000
    a = rng.integers(0, 7, n).astype(np.float32)
    b = rng.integers(100, 130, n).astype(np.float32)
    v = rng.normal(10, 5, n).astype(np.float32)
    db2 = WarpDB(HostTable.from_dict({"a": a, "b": b, "v": v}))
    sql = ("SELECT a, b, SUM(v), COUNT(*), MIN(v) FROM t "
           "GROUP BY a, b ORDER BY a ASC, b ASC")
    plan = db2.explain(sql)
    assert "packed composite key" in plan, plan
    out = db2.query_sql_table(sql)
    want = {}
    for ai, bi, vi in zip(a, b, v):
        want.setdefault((ai, bi), []).append(vi)
    keys = sorted(want)
    np.testing.assert_allclose(out["a"], [k[0] for k in keys])
    np.testing.assert_allclose(out["b"], [k[1] for k in keys])
    np.testing.assert_allclose(
        out["SUM(v[idx])"],
        [np.float64(np.asarray(want[k], np.float64).sum()) for k in keys],
        rtol=1e-3,
    )
    np.testing.assert_allclose(
        out["COUNT(*)"], [len(want[k]) for k in keys])
    np.testing.assert_allclose(
        out["MIN(v[idx])"], [min(want[k]) for k in keys], rtol=1e-6)

    # Midrange tier: product in the tens of thousands of slots.
    b2 = rng.integers(0, 3000, n).astype(np.float32)
    db3 = WarpDB(HostTable.from_dict({"a": a, "b": b2, "v": v}))
    sql2 = "SELECT a, b, SUM(v) FROM t GROUP BY a, b ORDER BY a ASC, b ASC"
    plan2 = db3.explain(sql2)
    assert "MIDRANGE" in plan2 and "packed composite key" in plan2, plan2
    out2 = db3.query_sql_table(sql2)
    want2 = {}
    for ai, bi, vi in zip(a, b2, v):
        want2[(ai, bi)] = want2.get((ai, bi), 0.0) + np.float64(vi)
    keys2 = sorted(want2)
    np.testing.assert_allclose(out2["a"], [k[0] for k in keys2])
    np.testing.assert_allclose(out2["b"], [k[1] for k in keys2])
    np.testing.assert_allclose(
        out2["SUM(v[idx])"], [want2[k] for k in keys2], rtol=1e-3)

    # Wide keys (no provable narrow range) still fall back to sorts.
    c = rng.normal(0, 1e6, n).astype(np.float32)
    db4 = WarpDB(HostTable.from_dict({"a": a, "c": c, "v": v}))
    plan3 = db4.explain("SELECT a, c, SUM(v) FROM t GROUP BY a, c")
    assert "SORTED segmented" in plan3, plan3

    # Non-integral composite keys pass the range gate but fail the
    # runtime integrality check — execution must fall back and stay
    # correct (explain is optimistic there by design).
    c2 = rng.uniform(0, 3, n).round(2).astype(np.float32)
    db5 = WarpDB(HostTable.from_dict({"a": a, "c": c2, "v": v}))
    out5 = db5.query_sql_table(
        "SELECT a, c, COUNT(*) FROM t GROUP BY a, c ORDER BY a ASC, c ASC")
    want5 = {}
    for ai, ci in zip(a, c2):
        want5[(ai, ci)] = want5.get((ai, ci), 0) + 1
    keys5 = sorted(want5)
    np.testing.assert_allclose(out5["a"], [k[0] for k in keys5])
    np.testing.assert_allclose(out5["c"], [k[1] for k in keys5], rtol=1e-6)
    np.testing.assert_allclose(out5["COUNT(*)"], [want5[k] for k in keys5])


def test_grouped_device_finish_matches_host():
    """HAVING + ORDER BY <aggregate> + LIMIT finish ON DEVICE for the
    midrange and sorted group tiers (r3): the host receives O(limit)
    groups instead of O(G).  Results must match the host finish exactly
    across tiers, directions, HAVING forms, and OFFSET."""
    rng = np.random.default_rng(53)
    n = 120_000

    def oracle(k, v, having, order_key, asc, limit, offset=0):
        sums, cnts, mins = {}, {}, {}
        for ki, vi in zip(k, v):
            sums[ki] = sums.get(ki, 0.0) + np.float64(vi)
            cnts[ki] = cnts.get(ki, 0) + 1
            mins[ki] = min(mins.get(ki, np.inf), vi)
        rows = [
            (ki, sums[ki], cnts[ki], mins[ki])
            for ki in sums
            if having(sums[ki], cnts[ki], mins[ki])
        ]
        rows.sort(key=order_key, reverse=not asc)
        return rows[offset:offset + limit]

    # Midrange tier (stats-bounded int keys, ~30k slots).
    k = rng.integers(0, 30_000, n).astype(np.float32)
    v = rng.normal(50, 20, n).astype(np.float32)
    db2 = WarpDB(HostTable.from_dict({"k": k, "v": v}))
    out = db2.query_sql_table(
        "SELECT k, SUM(v) AS s FROM t GROUP BY k "
        "HAVING COUNT(*) >= 5 ORDER BY s DESC LIMIT 11")
    want = oracle(k, v, lambda s, c, m: c >= 5, lambda r: r[1], False, 11)
    np.testing.assert_allclose(out["s"], [r[1] for r in want], rtol=1e-4)

    # Sorted tier (continuous keys — no stats bound).
    k2 = rng.uniform(0, 1e6, n).round(2).astype(np.float32)
    db3 = WarpDB(HostTable.from_dict({"k": k2, "v": v}))
    out = db3.query_sql_table(
        "SELECT k, AVG(v) AS a FROM t GROUP BY k "
        "HAVING MIN(v) > 10 ORDER BY a ASC LIMIT 6 OFFSET 2")
    want = oracle(k2, v, lambda s, c, m: m > 10,
                  lambda r: r[1] / r[2], True, 6, offset=2)
    np.testing.assert_allclose(
        out["a"], [r[1] / r[2] for r in want], rtol=1e-4)

    # Expression order key over two aggregates.
    out = db2.query_sql_table(
        "SELECT k, SUM(v) / COUNT(*) AS m FROM t GROUP BY k "
        "ORDER BY SUM(v) / COUNT(*) DESC LIMIT 4")
    want = oracle(k, v, lambda s, c, m: True,
                  lambda r: r[1] / r[2], False, 4)
    np.testing.assert_allclose(
        out["m"], [r[1] / r[2] for r in want], rtol=1e-4)


def test_scalar_math_builtins(db):
    """The standard scalar math surface: logs, powers, trig, rounding
    with decimals (r3 extensions; all lower to jnp builtins).  rtol is
    1e-4: XLA's f32 transcendentals (log/pow/trig) are device
    approximations that can differ from the host's libm by up to ~3e-5
    relative — accuracy parity with the device's native ops, not with
    libm, is the contract."""
    p = np.array([10.5, 20.0, 15.25, 30.0])
    one = lambda sql: db.query_sql(f"SELECT {sql} FROM test LIMIT 1")[0]
    np.testing.assert_allclose(
        db.query_sql("SELECT LN(price) FROM test"), np.log(p), rtol=1e-4)
    np.testing.assert_allclose(
        db.query_sql("SELECT LOG2(price) FROM test"), np.log2(p), rtol=1e-4)
    np.testing.assert_allclose(
        db.query_sql("SELECT LOG10(price) FROM test"), np.log10(p),
        rtol=1e-4)
    # LOG: one arg = natural (back-compat); two args = LOG(base, x).
    np.testing.assert_allclose(one("LOG(2, 8)"), 3.0, rtol=1e-4)
    np.testing.assert_allclose(
        db.query_sql("SELECT POWER(price, 2) FROM test"), p * p, rtol=1e-4)
    np.testing.assert_allclose(one("MOD(7, 3)"), 1.0)
    np.testing.assert_allclose(one("CBRT(27)"), 3.0, rtol=1e-4)
    np.testing.assert_allclose(one("CEILING(1.2)"), 2.0)
    np.testing.assert_allclose(one("SIN(0)"), 0.0, atol=1e-7)
    np.testing.assert_allclose(one("COS(0)"), 1.0, rtol=1e-4)
    np.testing.assert_allclose(one("ATAN2(1, 1)"), np.pi / 4, rtol=1e-4)
    np.testing.assert_allclose(one("DEGREES(PI())"), 180.0, rtol=1e-4)
    np.testing.assert_allclose(one("RADIANS(180)"), np.pi, rtol=1e-4)
    np.testing.assert_allclose(one("TANH(0.5)"), np.tanh(0.5), rtol=1e-4)
    np.testing.assert_allclose(one("ASIN(1)"), np.pi / 2, rtol=1e-4)
    # Two-arg ROUND/TRUNC take a decimals count (negative = tens).
    np.testing.assert_allclose(
        db.query_sql("SELECT ROUND(price, 1) FROM test"),
        np.round(p, 1), rtol=1e-4)
    np.testing.assert_allclose(one("TRUNC(1.279, 2)"), 1.27, rtol=1e-5)
    np.testing.assert_allclose(one("ROUND(1234.5, -2)"), 1200.0)


def test_true_false_literals(db):
    """TRUE/FALSE literals work as conditions (prunable by the interval
    optimizer) and as 0/1 values; contextual, so true(...) stays a UDF
    call position."""
    assert db.query_sql("SELECT price FROM test WHERE FALSE") == []
    np.testing.assert_allclose(
        db.query_sql("SELECT price FROM test WHERE TRUE"),
        [10.5, 20.0, 15.25, 30.0])
    np.testing.assert_allclose(
        db.query_sql("SELECT price FROM test WHERE TRUE AND price > 25"),
        [30.0])
    out = db.query_sql_table("SELECT TRUE, FALSE FROM test LIMIT 1")
    assert list(out.values()) == [[1.0], [0.0]]


def test_bool_and_or_any_value():
    """BOOL_AND/BOOL_OR rewrite to MIN/MAX over the predicate's 0/1 CASE
    form (so they group/distribute/stream); ANY_VALUE picks the
    deterministic minimum witness."""
    t = HostTable.from_dict({
        "k": np.array([0, 0, 1, 1, 2], np.float32),
        "v": np.array([5.0, 7.0, -1.0, 4.0, 9.0], np.float32),
    })
    db = WarpDB(t)
    out = db.query_sql_table(
        "SELECT BOOL_AND(v > 0) AS a, BOOL_OR(v > 8) AS o, "
        "ANY_VALUE(k) AS w FROM t")
    assert out["a"] == [0.0] and out["o"] == [1.0] and out["w"] == [0.0]
    out = db.query_sql_table(
        "SELECT k, BOOL_AND(v > 0) AS a, BOOL_OR(v < 0) AS o FROM t "
        "GROUP BY k ORDER BY k")
    assert out["a"] == [1.0, 0.0, 1.0]
    assert out["o"] == [0.0, 1.0, 0.0]


def test_variance_stddev_global(db):
    p = np.array([10.5, 20.0, 15.25, 30.0])
    np.testing.assert_allclose(
        db.query_sql("SELECT VARIANCE(price) FROM test"),
        [np.var(p, ddof=1)], rtol=1e-4,
    )
    np.testing.assert_allclose(
        db.query_sql("SELECT VAR_POP(price) FROM test"),
        [np.var(p)], rtol=1e-4,
    )
    np.testing.assert_allclose(
        db.query_sql("SELECT STDDEV(price) FROM test"),
        [np.std(p, ddof=1)], rtol=1e-4,
    )
    np.testing.assert_allclose(
        db.query_sql("SELECT STDDEV_POP(price) FROM test"),
        [np.std(p)], rtol=1e-4,
    )
    # WHERE applies before the aggregate.
    np.testing.assert_allclose(
        db.query_sql("SELECT VARIANCE(price) FROM test WHERE price > 12"),
        [np.var(p[p > 12], ddof=1)], rtol=1e-4,
    )
    # Sample variance of zero rows is NaN (SQL NULL).
    assert np.isnan(
        db.query_sql("SELECT STDDEV(price) FROM test WHERE price > 100")[0]
    )


def test_variance_grouped_matches_numpy():
    rng = np.random.default_rng(11)
    k = rng.integers(0, 7, 3000).astype(np.float32)
    v = rng.uniform(0, 100, 3000).astype(np.float32)
    db = WarpDB(HostTable.from_dict({"k": k, "v": v}))
    out = db.query_sql_table(
        "SELECT k, VAR_POP(v) AS vp, STDDEV(v) AS sd FROM t "
        "GROUP BY k ORDER BY k ASC"
    )
    keys = np.asarray(out["k"])
    for i, key in enumerate(keys):
        grp = v[k == key]
        np.testing.assert_allclose(out["vp"][i], np.var(grp), rtol=2e-3)
        np.testing.assert_allclose(
            out["sd"][i], np.std(grp, ddof=1), rtol=2e-3
        )


def test_global_agg_expression(db):
    p = np.array([10.5, 20.0, 15.25, 30.0])
    np.testing.assert_allclose(
        db.query_sql("SELECT SUM(price) / COUNT(price) FROM test"),
        [p.mean()], rtol=1e-6,
    )
    np.testing.assert_allclose(
        db.query_sql("SELECT MAX(price) - MIN(price) FROM test"),
        [p.max() - p.min()], rtol=1e-6,
    )
    # Function over aggregates, and a parameterised one in the mix.
    np.testing.assert_allclose(
        db.query_sql("SELECT sqrt(SUM(price * price)) FROM test"),
        [np.sqrt((p * p).sum())], rtol=1e-5,
    )
    np.testing.assert_allclose(
        db.query_sql(
            "SELECT MAX(price) - PERCENTILE(price, 0.5) FROM test"
        ),
        [p.max() - np.percentile(p, 50)], rtol=1e-5,
    )


def test_exists_subquery():
    db = WarpDB(HostTable.from_dict({
        "price": np.array([10.5, 20.0, 15.25, 30.0], np.float32),
        "quantity": np.array([3.0, 4.0, 2.0, 5.0], np.float32),
    }))
    db.register_table(
        "other", HostTable.from_dict({"x": np.array([1.0, 2.0], np.float32)})
    )
    assert db.query_sql(
        "SELECT price FROM t WHERE EXISTS (SELECT x FROM other WHERE x > 1)"
    ) == [10.5, 20.0, 15.25, 30.0]
    assert db.query_sql(
        "SELECT price FROM t WHERE EXISTS (SELECT x FROM other WHERE x > 5)"
    ) == []
    assert db.query_sql(
        "SELECT price FROM t "
        "WHERE NOT EXISTS (SELECT x FROM other WHERE x > 5)"
    ) == [10.5, 20.0, 15.25, 30.0]
    # Composes with other predicates and with CASE.
    assert db.query_sql(
        "SELECT price FROM t WHERE "
        "EXISTS (SELECT x FROM other) AND price > 16"
    ) == [20.0, 30.0]
    assert db.query_sql(
        "SELECT CASE WHEN EXISTS (SELECT x FROM other WHERE x > 5) "
        "THEN 1 ELSE 2 END FROM t LIMIT 1"
    ) == [2.0]
    # EXISTS over a grouped/HAVING subquery.
    assert db.query_sql(
        "SELECT price FROM t WHERE EXISTS ("
        "SELECT SUM(x) FROM other GROUP BY x HAVING SUM(x) > 1)"
    ) == [10.5, 20.0, 15.25, 30.0]
    # A column named exists and an exists() UDF keep working.
    db2 = WarpDB(HostTable.from_dict({"exists": np.array([1.0, 0.0], np.float32)}))
    assert db2.query_sql("SELECT exists FROM t WHERE exists > 0") == [1.0]


def test_qualified_star():
    db = WarpDB(HostTable.from_dict({
        "k": np.array([0.0, 1.0, 2.0], np.float32),
        "v": np.array([5.0, 6.0, 7.0], np.float32),
    }))
    db.register_table("d", HostTable.from_dict({
        "k": np.array([0.0, 1.0, 2.0], np.float32),
        "w": np.array([9.0, 8.0, 7.0], np.float32),
    }))
    out = db.query_sql_table("SELECT t.* FROM t")
    assert list(out) == ["k", "v"]
    # Qualified star over a join expands only that table's columns,
    # mirroring the joined-table namespace (clashing names qualify).
    out = db.query_sql_table("SELECT d.*, t.v FROM t JOIN d ON k = d.k")
    assert list(out) == ["d.k", "w", "t.v"]
    assert out["w"] == [9.0, 8.0, 7.0]
    out = db.query_sql_table("SELECT t.*, d.w FROM t JOIN d ON k = d.k")
    assert list(out) == ["k", "v", "d.w"]
    with pytest.raises(ValidationError, match="Unknown table: nope"):
        db.query_sql("SELECT nope.* FROM t")


def test_unknown_table_raises_once_catalog_registered():
    """Strict relation resolution (VERDICT r3 #2): without registered
    tables any FROM name resolves to the primary (reference demo
    semantics, warpdb.hpp:22-23); the moment a table is registered an
    unknown FROM / JOIN / subquery relation must raise — a silent
    fallback would execute against the wrong table."""
    db = WarpDB(HostTable.from_dict({
        "k": np.array([0.0, 1.0, 2.0], np.float32),
        "v": np.array([5.0, 6.0, 7.0], np.float32),
    }))
    # Lenient while nothing is registered.
    assert db.query_sql("SELECT v FROM anything WHERE k > 0") == [6.0, 7.0]
    db.register_table("d", HostTable.from_dict({
        "k": np.array([0.0, 1.0], np.float32),
        "w": np.array([9.0, 8.0], np.float32),
    }))
    # The primary stays reachable by its name and the reserved alias.
    assert db.query_sql("SELECT v FROM t WHERE k > 0") == [6.0, 7.0]
    assert db.query_sql("SELECT v FROM table WHERE k > 0") == [6.0, 7.0]
    with pytest.raises(ValidationError, match="Unknown table: nosuchtable"):
        db.query_sql("SELECT v FROM nosuchtable")
    with pytest.raises(ValidationError, match="Unknown table: nodim"):
        db.query_sql("SELECT v FROM t JOIN nodim ON k = nodim.k")
    with pytest.raises(ValidationError, match="Unknown table: nosub"):
        db.query_sql(
            "SELECT v FROM t WHERE EXISTS (SELECT * FROM nosub "
            "WHERE nosub.k = k)"
        )
    with pytest.raises(ValidationError, match="Unknown table: noref"):
        db.query_sql_table("SELECT * FROM (SELECT v FROM noref) sub")


# --- table aliases and self-joins -------------------------------------------


def test_from_alias():
    db = WarpDB(HostTable.from_dict({
        "price": np.array([10.5, 20.0, 15.25, 30.0], np.float32),
        "quantity": np.array([3.0, 4.0, 2.0, 5.0], np.float32),
    }))
    assert db.query_sql("SELECT s.price FROM t AS s WHERE s.price > 15") == [
        20.0, 15.25, 30.0,
    ]
    # Bare alias (no AS) and mixing alias-qualified with unqualified.
    assert db.query_sql("SELECT s.price FROM t s WHERE price > 15") == [
        20.0, 15.25, 30.0,
    ]
    out = db.query_sql_table("SELECT s.* FROM t s LIMIT 2")
    assert list(out) == ["price", "quantity"]


def test_join_alias():
    db = WarpDB(HostTable.from_dict({
        "price": np.array([10.5, 20.0, 15.25, 30.0], np.float32),
        "quantity": np.array([3.0, 4.0, 2.0, 5.0], np.float32),
    }))
    db.register_table("d", HostTable.from_dict({
        "k": np.array([2.0, 3.0, 4.0, 5.0], np.float32),
        "w": np.array([0.5, 1.0, 1.5, 2.0], np.float32),
    }))
    out = db.query_sql_table(
        "SELECT price, x.w FROM t JOIN d AS x ON quantity = x.k "
        "ORDER BY price ASC"
    )
    assert out["x.w"] == [1.0, 0.5, 1.5, 2.0]


def test_self_join_duplicate_keys_matches_oracle():
    rng = np.random.default_rng(5)
    k = rng.integers(0, 6, 40).astype(np.float32)
    v = rng.uniform(0, 10, 40).astype(np.float32).round(2)
    db = WarpDB(HostTable.from_dict({"k": k, "v": v}))
    out = db.query_sql_table(
        "SELECT a.v, b.v FROM t a JOIN t b ON a.k = b.k"
    )
    got = sorted(zip(out["a.v"], out["b.v"]))
    want = sorted(
        (float(v[i]), float(v[j]))
        for i in range(40)
        for j in range(40)
        if k[i] == k[j]
    )
    assert len(got) == len(want)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5)


def test_self_join_strings_and_left_alias():
    db = WarpDB(HostTable.from_dict(
        {
            "name": np.array(["a", "b", "c", "b"], object),
            "x": np.array([1.0, 2.0, 3.0, 4.0], np.float32),
        },
        dtypes={"name": DataType.STRING, "x": DataType.FLOAT32},
    ))
    out = db.query_sql_table(
        "SELECT p.x, q.x FROM t p JOIN t q ON p.name = q.name"
    )
    assert sorted(zip(out["p.x"], out["q.x"])) == [
        (1.0, 1.0), (2.0, 2.0), (2.0, 4.0),
        (3.0, 3.0), (4.0, 2.0), (4.0, 4.0),
    ]
    db2 = WarpDB(HostTable.from_dict({"k": np.array([1.0, 2.0, 3.0], np.float32)}))
    db2.register_table("r", HostTable.from_dict({
        "k": np.array([2.0, 3.0], np.float32),
        "w": np.array([20.0, 30.0], np.float32),
    }))
    out = db2.query_sql_table(
        "SELECT t.k, s.w FROM t LEFT JOIN r AS s ON k = s.k ORDER BY t.k ASC"
    )
    assert out["t.k"] == [1.0, 2.0, 3.0]
    assert np.isnan(out["s.w"][0]) and out["s.w"][1:] == [20.0, 30.0]


def test_alias_grouped_self_join():
    db = WarpDB(HostTable.from_dict({
        "price": np.array([10.5, 20.0, 15.25, 30.0], np.float32),
        "quantity": np.array([3.0, 4.0, 2.0, 5.0], np.float32),
    }))
    out = db.query_sql_table(
        "SELECT a.quantity, COUNT(*) FROM t a JOIN t b "
        "ON a.quantity = b.quantity GROUP BY a.quantity "
        "ORDER BY a.quantity ASC"
    )
    assert out["a.quantity"] == [2.0, 3.0, 4.0, 5.0]
    assert out["COUNT(*)"] == [1.0, 1.0, 1.0, 1.0]


def test_alias_in_cte_body():
    rng = np.random.default_rng(6)
    k = rng.integers(0, 4, 30).astype(np.float32)
    v = rng.uniform(0, 10, 30).astype(np.float32)
    db = WarpDB(HostTable.from_dict({"k": k, "v": v}))
    out = db.query_sql(
        "WITH big AS (SELECT k, v FROM t WHERE v > 5) "
        "SELECT a.v FROM big a JOIN big b ON a.k = b.k LIMIT 3"
    )
    assert len(out) == 3


# --- FIRST_VALUE / LAST_VALUE / NTILE window functions ----------------------


def _window_oracle_tables():
    rng = np.random.default_rng(7)
    n = 500
    k = rng.integers(0, 5, n).astype(np.float32)
    o = rng.uniform(0, 100, n).astype(np.float32)
    v = rng.uniform(0, 10, n).astype(np.float32)
    return n, k, o, v


def test_first_last_value_window():
    n, k, o, v = _window_oracle_tables()
    db = WarpDB(HostTable.from_dict({"k": k, "o": o, "v": v}))

    def oracle(last):
        out = np.zeros(n, np.float32)
        for key in np.unique(k):
            m = np.where(k == key)[0]
            order = m[np.argsort(o[m], kind="stable")]
            out[m] = v[order[-1 if last else 0]]
        return out

    got = np.array(db.query_sql(
        "SELECT FIRST_VALUE(v) OVER (PARTITION BY k ORDER BY o) FROM t"
    ))
    np.testing.assert_allclose(got, oracle(False), rtol=1e-6)
    got = np.array(db.query_sql(
        "SELECT LAST_VALUE(v) OVER (PARTITION BY k ORDER BY o) FROM t"
    ))
    np.testing.assert_allclose(got, oracle(True), rtol=1e-6)
    # DESC order flips which row is first.
    got = np.array(db.query_sql(
        "SELECT FIRST_VALUE(v) OVER (PARTITION BY k ORDER BY o DESC) FROM t"
    ))
    np.testing.assert_allclose(got, oracle(True), rtol=1e-6)


def test_ntile_window():
    n, k, o, v = _window_oracle_tables()
    db = WarpDB(HostTable.from_dict({"k": k, "o": o, "v": v}))

    def oracle(nb):
        out = np.zeros(n, np.float32)
        for key in np.unique(k):
            m = np.where(k == key)[0]
            order = m[np.argsort(o[m], kind="stable")]
            cnt = len(order)
            small, rem = cnt // nb, cnt % nb
            for r, i in enumerate(order):
                if r < rem * (small + 1):
                    out[i] = r // (small + 1) + 1
                else:
                    out[i] = rem + (r - rem * (small + 1)) // max(small, 1) + 1
        return out

    for nb in (2, 3, 7, 600):  # 600 > partition size: one row per bucket
        got = np.array(db.query_sql(
            f"SELECT NTILE({nb}) OVER (PARTITION BY k ORDER BY o) FROM t"
        ))
        np.testing.assert_allclose(got, oracle(nb))
    # Filtered, unpartitioned NTILE only numbers the surviving rows.
    got = np.array(db.query_sql(
        "SELECT NTILE(4) OVER (ORDER BY o) FROM t WHERE v > 5"
    ))
    assert len(got) == int((v > 5).sum())
    assert set(np.unique(got)) == {1.0, 2.0, 3.0, 4.0}
    with pytest.raises(ParseError, match="positive integer"):
        db.query_sql("SELECT NTILE(0) OVER (ORDER BY o) FROM t")
    with pytest.raises(ParseError, match="positive integer"):
        db.query_sql("SELECT NTILE(o) OVER (ORDER BY o) FROM t")


def test_distinct_with_qualify():
    """SELECT DISTINCT … QUALIFY dedups the qualifying rows."""
    rng = np.random.default_rng(29)
    n = 1200
    k = rng.integers(0, 6, n).astype(np.float32)
    v = rng.integers(0, 4, n).astype(np.float32)
    db = WarpDB(HostTable.from_dict({"k": k, "v": v}))
    out = db.query_sql_table(
        "SELECT DISTINCT k FROM t QUALIFY "
        "RANK() OVER (PARTITION BY k ORDER BY v DESC) <= 3 ORDER BY k"
    )
    got = list(list(out.values())[0])
    assert got == sorted(set(float(x) for x in k))
    # Multi-column DISTINCT through QUALIFY; no ORDER BY → engine's
    # lexicographic DISTINCT convention.
    out = db.query_sql_table(
        "SELECT DISTINCT k, v FROM t QUALIFY "
        "MAX(v) OVER (PARTITION BY k) == v"
    )
    rows = set(zip(*[map(float, c) for c in out.values()]))
    exp = set()
    for kk in np.unique(k):
        exp.add((float(kk), float(v[k == kk].max())))
    assert rows == exp
    # DISTINCT ordering by a non-select expression is rejected.
    with pytest.raises(UnsupportedError, match="select list"):
        db.query_sql_table(
            "SELECT DISTINCT k FROM t QUALIFY "
            "MAX(v) OVER (PARTITION BY k) == v ORDER BY v"
        )


def test_distinct_over_window_expression():
    """SELECT DISTINCT over a window-in-expression select item."""
    rng = np.random.default_rng(30)
    n = 800
    k = rng.integers(0, 2, n).astype(np.float32)
    v = rng.integers(0, 3, n).astype(np.float32)
    db = WarpDB(HostTable.from_dict({"k": k, "v": v}))
    out = db.query_sql_table(
        "SELECT DISTINCT v - MIN(v) OVER (PARTITION BY k) FROM t"
    )
    got = sorted(float(x) for x in list(out.values())[0])
    exp = set()
    for i in range(n):
        exp.add(float(v[i] - v[k == k[i]].min()))
    assert got == sorted(exp)


def test_count_column_skips_left_join_nulls():
    """SQL COUNT(expr) counts only non-NULL rows: after a LEFT JOIN,
    unmatched build-side values (NaN fill; string codes -1) must not
    count, while COUNT(*) counts every row (the planner routes
    COUNT(expr) through SUM of a NotNull indicator — grouped, device
    finish, and global paths all inherit it)."""
    import numpy as np

    from warpdb_tpu import WarpDB
    from warpdb_tpu.storage import HostTable

    db = WarpDB(HostTable.from_dict({
        "g": np.array([0, 0, 1, 1, 1], np.float32),
        "k": np.array([10, 11, 12, 13, 10], np.float32),
    }))
    db.register_table("d", HostTable.from_dict({
        "dk": np.array([10, 12], np.float32),
        "v": np.array([1.5, 2.5], np.float32),
        "s": np.array(["x", "y"]),
    }))
    out = db.query_sql_table(
        "SELECT g, COUNT(*) AS n, COUNT(d.v) AS nv, COUNT(d.s) AS ns "
        "FROM t LEFT JOIN d ON k = d.dk GROUP BY g ORDER BY g ASC"
    )
    assert out["n"] == [2.0, 3.0]
    assert out["nv"] == [1.0, 2.0]  # k=11 and k=13 miss -> NULL v
    assert out["ns"] == [1.0, 2.0]  # string codes -1 are NULL too
    # Global (ungrouped) COUNT agrees.
    got = db.query_sql("SELECT COUNT(d.v) FROM t LEFT JOIN d ON k = d.dk")
    assert got == [3.0]
    got = db.query_sql("SELECT COUNT(*) FROM t LEFT JOIN d ON k = d.dk")
    assert got == [5.0]


def test_conjunctwise_probe_pushdown_matches_unpushed():
    """r5: a WHERE mixing probe-only conjuncts with a multi-relation OR
    pushes just the probe conjuncts; results match the unpushed plan."""
    from warpdb_tpu.config import get_config

    rng = np.random.default_rng(17)
    n = 1 << 13
    db = WarpDB(HostTable.from_dict({
        "k": rng.integers(0, 8, n).astype(np.float32),
        "v": rng.uniform(0, 100, n).astype(np.float32),
    }))
    db.register_table("d", HostTable.from_dict({
        "k": np.arange(8, dtype=np.float32),
        "name": np.array(list("abcdefgh")),
        "w": rng.uniform(0, 1, 8).astype(np.float32),
    }))
    sql = (
        "SELECT SUM(v * d.w) FROM t JOIN d ON k = d.k "
        "WHERE v > 90 AND (d.name = 'b' OR d.name = 'e') "
        "GROUP BY k ORDER BY k ASC"
    )
    cfg = get_config()
    got = db.query_sql_table(sql)
    old = cfg.join_filter_pushdown
    try:
        cfg.join_filter_pushdown = False
        want = db.query_sql_table(sql)
    finally:
        cfg.join_filter_pushdown = old
    assert list(got.keys()) == list(want.keys())
    for c in got:
        np.testing.assert_allclose(
            np.asarray(got[c], np.float64),
            np.asarray(want[c], np.float64), rtol=1e-5,
        )


def test_or_implied_build_filter_matches_unpushed():
    """r5: (a=X AND b=Y) OR (a=Y AND b=X) over two aliased dimension
    joins derives per-relation IN filters; exact pairing preserved."""
    from warpdb_tpu.config import get_config

    rng = np.random.default_rng(23)
    n = 1 << 12
    db = WarpDB(HostTable.from_dict({
        "s": rng.integers(0, 16, n).astype(np.float32),
        "c": rng.integers(0, 16, n).astype(np.float32),
        "v": rng.uniform(0, 10, n).astype(np.float32),
    }))
    names = np.array([f"n{i:02d}" for i in range(16)])
    db.register_table("nat", HostTable.from_dict({
        "k": np.arange(16, dtype=np.float32), "name": names,
    }))
    sql = (
        "SELECT n1.name, n2.name, SUM(v) FROM t "
        "JOIN nat n1 ON s = n1.k JOIN nat n2 ON c = n2.k "
        "WHERE (n1.name = 'n03' AND n2.name = 'n05') "
        "OR (n1.name = 'n05' AND n2.name = 'n03') "
        "GROUP BY n1.name, n2.name ORDER BY n1.name ASC, n2.name ASC"
    )
    cfg = get_config()
    got = db.query_sql_table(sql)
    old = cfg.join_filter_pushdown
    try:
        cfg.join_filter_pushdown = False
        want = db.query_sql_table(sql)
    finally:
        cfg.join_filter_pushdown = old
    for c in got:
        if isinstance(got[c][0] if got[c] else 0.0, str):
            assert list(got[c]) == list(want[c])
        else:
            np.testing.assert_allclose(
                np.asarray(got[c], np.float64),
                np.asarray(want[c], np.float64), rtol=1e-5,
            )
    # The exact pairing survives: only the (n03, n05) and (n05, n03)
    # combinations appear.
    pairs = set(zip(got[list(got)[0]], got[list(got)[1]]))
    assert pairs <= {("n03", "n05"), ("n05", "n03")}
