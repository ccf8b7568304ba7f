"""COUNT(expr) NULL semantics (ADVICE r4).

Three properties pinned here:

1. A legitimate ``-1`` in a plain INT column is NOT a NULL — the -1
   marker only means NULL for dict codes and LEFT-JOIN fills (the old
   blanket ``!= -1`` test miscounted raw INT data).
2. COUNT(expr) stays exact past 2^24 rows per group: it reads the exact
   i32 row counts minus a summed IS-NULL indicator instead of summing a
   not-null indicator in f32 (which saturates at 16,777,216).
3. The 0/1 indicator has a finite static range, so grouped COUNT(expr)
   queries keep the stats-gated one-hot matmul group path.

Reference context: the reference's COUNT is a thrust::count_if over all
rows with no NULL concept at all (src/jit.cpp) — NULL skipping is an
extension, so these semantics are pinned by tests rather than parity.
"""

import numpy as np

from warpdb_tpu import WarpDB
from warpdb_tpu.storage import HostTable


def test_count_plain_int_minus_one_is_not_null():
    """-1 in a raw INT column is data, not NULL (grouped + global)."""
    k = np.array([0, 0, 1, 1, 1], np.float32)
    v = np.array([-1, 3, -1, -1, 7], np.int32)
    db = WarpDB(HostTable.from_dict({"k": k, "v": v}))
    got = db.query_sql_table("SELECT k, COUNT(v) AS n FROM t GROUP BY k")
    np.testing.assert_array_equal(np.asarray(got["n"]), [2, 3])
    glob = db.query_sql("SELECT COUNT(v) FROM t")
    assert float(glob[0]) == 5.0


def test_count_float_nan_is_null():
    """NaN in a float column IS a NULL: skipped grouped and globally."""
    k = np.array([0, 0, 1, 1], np.float32)
    v = np.array([1.0, np.nan, np.nan, 4.0], np.float32)
    db = WarpDB(HostTable.from_dict({"k": k, "v": v}))
    got = db.query_sql_table("SELECT k, COUNT(v) AS n FROM t GROUP BY k")
    np.testing.assert_array_equal(np.asarray(got["n"]), [1, 1])
    glob = db.query_sql("SELECT COUNT(v) FROM t")
    assert float(glob[0]) == 2.0


def test_count_left_join_fill_is_null():
    """LEFT-JOIN miss fills count as NULL for both a float build column
    (NaN fill) and a string build column (code -1 fill)."""
    db = WarpDB(
        HostTable.from_dict(
            {
                "q": np.array([0, 1, 2, 3, 1], np.float32),
                "p": np.array([10, 20, 30, 40, 50], np.float32),
            }
        )
    )
    db.register_table(
        "d",
        HostTable.from_dict(
            {
                "q": np.array([0, 1], np.float32),
                "rate": np.array([0.5, 0.25], np.float32),
                "name": np.array(["a", "b"]),
            }
        ),
    )
    got = db.query_sql(
        "SELECT COUNT(d.rate) FROM t LEFT JOIN d ON q = d.q"
    )
    assert float(got[0]) == 3.0  # rows with q in {0,1,1}
    got = db.query_sql(
        "SELECT COUNT(d.name) FROM t LEFT JOIN d ON q = d.q"
    )
    assert float(got[0]) == 3.0


def test_count_grouped_left_join_fill():
    """Grouped COUNT over a LEFT-JOIN-filled column skips only misses."""
    db = WarpDB(
        HostTable.from_dict(
            {
                "g": np.array([0, 0, 1, 1], np.float32),
                "q": np.array([0, 9, 1, 9], np.float32),
            }
        )
    )
    db.register_table(
        "d",
        HostTable.from_dict(
            {
                "q": np.array([0, 1], np.float32),
                "rate": np.array([0.5, 0.25], np.float32),
            }
        ),
    )
    got = db.query_sql_table(
        "SELECT g, COUNT(d.rate) AS n FROM t LEFT JOIN d ON q = d.q "
        "GROUP BY g ORDER BY g ASC"
    )
    np.testing.assert_array_equal(np.asarray(got["n"]), [1, 1])


def test_notnull_indicator_has_finite_range():
    """expr_range knows the indicator is in [0,1], keeping grouped
    COUNT(expr) on the stats-gated one-hot matmul path (ADVICE r4 #3)."""
    from warpdb_tpu.engine.optimizer import expr_range
    from warpdb_tpu.frontend.ast import NotNull, Variable

    assert expr_range(NotNull(Variable("x")), {}) == (0.0, 1.0)
    assert expr_range(NotNull(Variable("x"), negated=True), {}) == (
        0.0,
        1.0,
    )


def test_count_exact_past_f32_saturation():
    """COUNT(col) over one group with >2^24 non-null rows is exact:
    16,777,217 rows of a nullable float column (one NULL) must count
    16,777,216 — an f32 not-null-indicator sum saturates at 2^24 and
    would undercount.  The column carries one NaN so the stats gate
    cannot rewrite COUNT to the plain row count."""
    n = (1 << 24) + 1
    v = np.ones(n, np.float32)
    v[0] = np.nan
    k = np.zeros(n, np.float32)
    db = WarpDB(HostTable.from_dict({"k": k, "v": v}))
    got = db.query_sql_table("SELECT k, COUNT(v) AS n FROM t GROUP BY k")
    assert float(np.asarray(got["n"])[0]) == float(1 << 24)
    glob = db.query_sql("SELECT COUNT(v) FROM t")
    assert float(glob[0]) == float(1 << 24)
