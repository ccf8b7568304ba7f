"""Device-fused window expressions (VERDICT r4 #5).

A select item mixing window functions with row arithmetic used to ship
one hidden O(N) column per window AND per referenced column over the
host↔device link, combining host-side.  The fused path evaluates the
windows and the combining arithmetic in ONE program and ships exactly
one column per select item (WHERE-compacted on device, O(match)),
asserted here via utils/metrics.note_transfer accounting.
"""

import numpy as np
import pytest

from warpdb_tpu import WarpDB
from warpdb_tpu.storage import HostTable
from warpdb_tpu.utils import metrics


def _mk(n=1 << 14, parts=8):
    rng = np.random.default_rng(3)
    p = rng.integers(0, parts, n).astype(np.float32)
    v = rng.uniform(0.0, 100.0, n).astype(np.float32)
    return p, v, WarpDB(HostTable.from_dict({"p": p, "v": v}))


def _dev_oracle(p, v):
    """deviation-from-mean per partition, NumPy."""
    out = np.zeros_like(v, np.float64)
    for k in np.unique(p):
        m = p == k
        out[m] = v[m].astype(np.float64) - v[m].astype(np.float64).mean()
    return out


def test_window_expr_correct_and_single_column():
    p, v, db = _mk()
    n_pad = db.table.padded_rows
    before = metrics.transfer_bytes()
    out = db.query_sql_table(
        "SELECT (v - AVG(v) OVER (PARTITION BY p)) * 2 "
        "+ MIN(v) OVER (PARTITION BY p) AS z FROM t"
    )
    shipped = metrics.transfer_bytes() - before
    want = _dev_oracle(p, v) * 2
    for k in np.unique(p):
        want[p == k] += v[p == k].min()
    np.testing.assert_allclose(
        np.asarray(out["z"], np.float64), want, rtol=2e-4, atol=1e-3
    )
    # ONE f32 column (padded), not three (2 windows + v).
    assert shipped <= n_pad * 4 * 1.25, (
        f"shipped {shipped} bytes for one select item over {n_pad} rows"
    )


def test_window_expr_where_ships_o_match():
    p, v, db = _mk()
    sel = v > 99.0  # ~1% selectivity
    before = metrics.transfer_bytes()
    out = db.query_sql_table(
        "SELECT v - AVG(v) OVER (PARTITION BY p) AS d FROM t "
        "WHERE v > 99.0"
    )
    shipped = metrics.transfer_bytes() - before
    assert len(out["d"]) == int(sel.sum())
    # Compacted on device: transfer is O(match), nowhere near O(N).
    assert shipped < db.table.padded_rows * 4 / 4
    # Correctness: windows see only WHERE survivors.
    vm, pm = v[sel].astype(np.float64), p[sel]
    want = _dev_oracle(pm, vm)
    np.testing.assert_allclose(
        np.asarray(out["d"], np.float64), want, rtol=2e-4, atol=1e-3
    )


def test_window_expr_order_by_expression():
    p, v, db = _mk(1 << 10)
    out = db.query_sql_table(
        "SELECT v - AVG(v) OVER (PARTITION BY p) AS d FROM t "
        "ORDER BY v * -1 ASC LIMIT 5"
    )
    want = _dev_oracle(p, v)[np.argsort(-v, kind="stable")][:5]
    np.testing.assert_allclose(
        np.asarray(out["d"], np.float64), want, rtol=2e-4, atol=1e-3
    )


def test_window_expr_string_refs_fall_back():
    # A string column in the select list routes through the host path
    # (decode needs the vocabulary) — results stay correct.
    n = 64
    rng = np.random.default_rng(5)
    p = rng.integers(0, 4, n).astype(np.float32)
    v = rng.uniform(0, 10, n).astype(np.float32)
    s = np.array(["ab", "cd", "ef", "gh"])[
        rng.integers(0, 4, n)
    ]
    db = WarpDB(HostTable.from_dict({"p": p, "v": v, "s": s}))
    out = db.query_sql_table(
        "SELECT s, v - AVG(v) OVER (PARTITION BY p) AS d FROM t"
    )
    assert list(out["s"]) == list(s)
    np.testing.assert_allclose(
        np.asarray(out["d"], np.float64), _dev_oracle(p, v),
        rtol=2e-4, atol=1e-3,
    )


def test_window_expr_two_windows_ranking():
    p, v, db = _mk(1 << 10)
    out = db.query_sql_table(
        "SELECT RANK() OVER (PARTITION BY p ORDER BY v ASC) "
        "+ COUNT(v) OVER (PARTITION BY p) * 0 AS r FROM t"
    )
    got = np.asarray(out["r"], np.int64)
    want = np.zeros(len(v), np.int64)
    for k in np.unique(p):
        m = p == k
        vals = v[m]
        want[m] = [int((vals < x).sum()) + 1 for x in vals]
    np.testing.assert_array_equal(got, want)


def test_qualify_ships_o_result():
    """QUALIFY compacts on device: the transfer is O(qualifying rows)."""
    p, v, db = _mk()
    before = metrics.transfer_bytes()
    out = db.query_sql_table(
        "SELECT v FROM t "
        "QUALIFY v > MAX(v) OVER (PARTITION BY p) - 0.05"
    )
    shipped = metrics.transfer_bytes() - before
    # Tiny survivor set → far below one O(N) column.
    assert shipped < db.table.padded_rows * 4 / 4
    want = []
    for i in range(len(v)):
        if v[i] > v[p == p[i]].max() - 0.05:
            want.append(v[i])
    np.testing.assert_allclose(
        np.sort(np.asarray(out["v"], np.float64)),
        np.sort(np.asarray(want, np.float64)),
        rtol=1e-6,
    )


def test_qualify_rank_top_n_per_partition():
    p, v, db = _mk(1 << 10)
    out = db.query_sql_table(
        "SELECT p, v FROM t "
        "QUALIFY RANK() OVER (PARTITION BY p ORDER BY v DESC) <= 2 "
        "ORDER BY p ASC, v DESC"
    )
    want_p, want_v = [], []
    for k in sorted(np.unique(p)):
        top = np.sort(v[p == k])[::-1][:2]
        want_p += [k] * len(top)
        want_v += list(top)
    np.testing.assert_allclose(np.asarray(out["p"], np.float64), want_p)
    np.testing.assert_allclose(
        np.asarray(out["v"], np.float64), want_v, rtol=1e-6
    )
