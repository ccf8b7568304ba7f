"""End-to-end smoke run of the engine on an NVIDIA GPU.

Drives the main path through the entry points a user calls — ``WarpDB``
load, ``query`` / ``query_sql`` / ``query_sql_table`` and the HTTP
``QueryServer`` — at real data sizes, and checks every answer against an
independent oracle: ``tests/oracle.py`` for the reference query set,
``benchmarks/tpch.py``'s NumPy oracle for the TPC-H-derived suite, and
plain NumPy group/join references where the row-at-a-time oracle would
take hours.  All data is generated from ``--seed``.

    python chip_smoke.py                  # phases A-E on one GPU
    python chip_smoke.py --devices 4      # only the sharded paths, 4 GPUs
    python chip_smoke.py --rehearse [--devices 4]   # tiny CPU rehearsal

Phases (one card): A reference query set at 2^25 rows; B expansion joins
at 2^24 probe rows; C the 22 TPC-H-derived queries at 2^24 lineitem
rows; D the served path; E the tests marked ``gpu``.  ``--devices 4``
runs the row-sharded scan, both distributed GROUP BYs, the shuffle join
and the distributed window at 2^26 rows, each against the single-device
answer and the oracle.

Without a GPU the script fails; it never falls back to the CPU.  Only
``--rehearse`` runs on the CPU, at tiny sizes, and its last line names
the CPU.  One process drives the card(s).  Any failed phase or check
exits non-zero before the last line, which is one JSON object:
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import gc
import glob
import json
import os
import subprocess
import sys
import time
import urllib.request

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# Row counts: (full run, CPU rehearsal).
SIZES = {
    "A": (1 << 25, 1 << 14),
    "B": (1 << 24, 1 << 13),
    "C": (1 << 24, 1 << 13),
    "S": (1 << 26, 1 << 14),
}
TPCH_REHEARSAL = ("q1", "q3", "q6", "q13", "q18")
NVLINK_GBPS = 450.0  # H100 NVLink, each way (NVIDIA data sheet)

# Reference-set SQL, one former device-specific site each.
SQL_A = {
    "group_dense": "SELECT SUM(price) FROM t GROUP BY quantity ORDER BY quantity ASC",
    "group_mid_sumcount": (
        "SELECT k, SUM(price) AS s, COUNT(*) AS c FROM t "
        "GROUP BY k ORDER BY k ASC"
    ),
    "group_mid_min": (
        "SELECT k, MIN(price) AS mn, COUNT(*) AS c FROM t "
        "GROUP BY k ORDER BY k ASC"
    ),
    "orderby_limit": "SELECT price FROM t ORDER BY price DESC LIMIT 16",
    "window": (
        "SELECT SUM(price) OVER (PARTITION BY quantity) FROM t "
        "WHERE price > 99"
    ),
    "distinct": "SELECT DISTINCT quantity FROM t",
}
SERVED = (
    "SELECT quantity, SUM(price) AS s, COUNT(*) AS c FROM t "
    "GROUP BY quantity ORDER BY quantity ASC",
    "SELECT price, quantity FROM t ORDER BY price DESC LIMIT 16",
    "SELECT DISTINCT quantity FROM t",
)
JOIN_SQL = (
    "SELECT quantity, SUM(price * {d}.w) AS s, COUNT(*) AS c FROM t "
    "JOIN {d} ON k = {d}.k2 GROUP BY quantity ORDER BY quantity ASC"
)

# f32 sums: the engine accumulates in f32 in an order the device picks
# (atomics, tree reductions); the references accumulate in f64.  Up to
# ~10^6 terms per group keep the relative error well under 1e-4.
SUM_RTOL = 1e-4
# Elementwise f32 expressions: XLA may fuse or reorder the same f32
# operations on the GPU, so allow a few ulps.
EXPR_RTOL = 1e-6


def _log(msg: str) -> None:
    print(msg, flush=True)


def _bits(x) -> np.ndarray:
    a = np.asarray(x)
    if a.dtype.kind == "f":
        return np.asarray(a, np.float32).view(np.uint32)
    return a


def _identical(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(
            _identical(a[k], b[k]) for k in a
        )
    x, y = _bits(a), _bits(b)
    return x.shape == y.shape and bool(np.array_equal(x, y))


def _peak_bytes(jax) -> str:
    stats = jax.devices()[0].memory_stats()
    if not stats:
        return "n/a"
    return str(stats.get("peak_bytes_in_use", "n/a"))


def _run_twice(fn):
    """(first result, first-call wall incl. compile, steady wall,
    bit-identical?) of a blocking query call."""
    t0 = time.perf_counter()
    first = fn()
    t1 = time.perf_counter()
    second = fn()
    t2 = time.perf_counter()
    return first, t1 - t0, t2 - t1, _identical(first, second)


class Phase:
    """Per-phase accumulator of wall times and verdicts."""

    def __init__(self, name: str, rows: int):
        self.name, self.rows = name, rows
        self.first = self.steady = 0.0
        self.identical: dict = {}

    def run(self, label: str, fn, check):
        out, first, steady, same = _run_twice(fn)
        check(out)
        self.first += first
        self.steady += steady
        self.identical[label] = same
        _log(
            f"  {self.name}.{label}: first {first:.3f} s, steady "
            f"{steady:.3f} s, bit-identical rerun: {'yes' if same else 'NO'}"
            ", oracle: ok"
        )
        return out

    def summary(self, jax) -> None:
        _log(
            f"phase {self.name}: rows {self.rows}, first-call wall "
            f"{self.first:.3f} s, steady wall {self.steady:.3f} s, "
            f"peak_bytes_in_use {_peak_bytes(jax)}, oracle: pass"
        )
        if self.identical:
            diff = [k for k, v in self.identical.items() if not v]
            _log(
                f"phase {self.name} determinism: "
                + ("all reruns bit-identical" if not diff
                   else "NOT bit-identical: " + ", ".join(diff))
            )


# --- data -------------------------------------------------------------------


def make_table(rows: int, seed: int) -> dict:
    """bench.py's reference table: price U[0,100) f32, quantity 0..31,
    k 0..2^16-1 (integers stored as f32)."""
    rng = np.random.default_rng(seed)
    return {
        "price": rng.uniform(0.0, 100.0, rows).astype(np.float32),
        "quantity": rng.integers(0, 32, rows).astype(np.float32),
        "k": rng.integers(0, 1 << 16, rows).astype(np.float32),
    }


def np_group(keys: np.ndarray, vals: np.ndarray):
    """NumPy grouped reference: (keys, counts, f64 sums, mins)."""
    order = np.argsort(keys, kind="stable")
    ks, vs = keys[order], vals[order]
    uniq, starts = np.unique(ks, return_index=True)
    counts = np.diff(np.append(starts, len(ks)))
    sums = np.add.reduceat(vs.astype(np.float64), starts)
    mins = np.minimum.reduceat(vs, starts)
    return uniq, counts, sums, mins


def _col(out: dict, name: str, dtype=np.float64) -> np.ndarray:
    return np.asarray(out[name], dtype)


# --- phases -----------------------------------------------------------------


def phase_a(jax, rows: int, seed: int):
    """Reference query set: expressions (incl. the discount UDF) and one
    SQL query per former device-specific site."""
    import oracle
    from bench import EXPR_QUERIES

    from warpdb_tpu import WarpDB
    from warpdb_tpu.api import _split_where
    from warpdb_tpu.frontend import parse_expression_text, parse_query_text
    from warpdb_tpu.storage import HostTable

    table = make_table(rows, seed)
    db = WarpDB(HostTable.from_dict(table))
    ph = Phase("A", rows)

    for name, text in EXPR_QUERIES:
        e, w = _split_where(text)
        want = oracle.query_expression(
            table, parse_expression_text(e),
            parse_expression_text(w) if w else None,
        )

        def check(got, want=want):
            np.testing.assert_allclose(got, want, rtol=EXPR_RTOL)

        ph.run(name, lambda t=text: db.query_np(t), check)

    def oracle_check(sql, rtol=0.0):
        want = oracle.query_sql(table, parse_query_text(sql))

        def check(got):
            got = np.asarray(got, np.float32)
            assert got.shape == want.shape, (got.shape, want.shape)
            np.testing.assert_allclose(got, want, rtol=rtol)

        return check

    ph.run("group_dense", lambda: db.query_sql(SQL_A["group_dense"]),
           oracle_check(SQL_A["group_dense"], SUM_RTOL))

    uniq, counts, sums, mins = np_group(table["k"], table["price"])
    plan = db.explain(SQL_A["group_mid_sumcount"])
    assert "MIDRANGE" in plan and "one-hot" in plan, plan

    def check_sumcount(out):
        np.testing.assert_array_equal(_col(out, "k"), uniq)
        np.testing.assert_array_equal(_col(out, "c", np.int64), counts)
        np.testing.assert_allclose(_col(out, "s"), sums, rtol=SUM_RTOL)

    def check_min(out):
        np.testing.assert_array_equal(_col(out, "k"), uniq)
        np.testing.assert_array_equal(_col(out, "c", np.int64), counts)
        np.testing.assert_array_equal(_col(out, "mn", np.float32), mins)

    ph.run("group_mid_sumcount",
           lambda: db.query_sql_table(SQL_A["group_mid_sumcount"]),
           check_sumcount)
    ph.run("group_mid_min",
           lambda: db.query_sql_table(SQL_A["group_mid_min"]), check_min)
    for name in ("orderby_limit", "distinct"):
        ph.run(name, lambda s=SQL_A[name]: db.query_sql(s),
               oracle_check(SQL_A[name]))
    ph.run("window", lambda: db.query_sql(SQL_A["window"]),
           oracle_check(SQL_A["window"], SUM_RTOL))
    ph.summary(jax)
    return db


def _join_tables(rows: int, seed: int):
    rng = np.random.default_rng(seed + 1)
    n_keys = 1 << 16
    builds = {
        "d2": np.full(n_keys, 2),  # uniform fan-out 2
        "dv": rng.integers(1, 4, n_keys),  # variable fan-out 1..3
    }
    out = {}
    for name, counts in builds.items():
        k2 = np.repeat(np.arange(n_keys, dtype=np.float32), counts)
        w = rng.uniform(0.0, 1.0, len(k2)).astype(np.float32)
        out[name] = {"k2": k2, "w": w}
    return out


def phase_b(jax, rows: int, seed: int):
    """Expansion joins with the eager-aggregation rewrite off, so the
    join really materialises ~2x the probe rows."""
    from warpdb_tpu import WarpDB
    from warpdb_tpu.config import get_config
    from warpdb_tpu.storage import HostTable

    table = make_table(rows, seed)
    db = WarpDB(HostTable.from_dict(table))
    builds = _join_tables(rows, seed)
    for name, cols in builds.items():
        db.register_table(name, HostTable.from_dict(cols))
    ph = Phase("B", rows)
    cfg = get_config()
    saved = (cfg.eager_join_aggregation, cfg.join_cache_entries)
    cfg.eager_join_aggregation = False
    cfg.join_cache_entries = 0  # the steady rerun must redo the join
    try:
        k = table["k"].astype(np.int64)
        q = table["quantity"].astype(np.int64)
        for name, cols in builds.items():
            kk = cols["k2"].astype(np.int64)
            wsum = np.bincount(kk, weights=cols["w"].astype(np.float64),
                               minlength=1 << 16)
            cnt = np.bincount(kk, minlength=1 << 16)
            want_s = np.bincount(q, weights=table["price"] * wsum[k],
                                 minlength=32)
            want_c = np.bincount(q, weights=cnt[k], minlength=32)

            def check(out, want_s=want_s, want_c=want_c):
                np.testing.assert_array_equal(_col(out, "quantity"),
                                              np.arange(32))
                np.testing.assert_array_equal(_col(out, "c", np.int64),
                                              want_c.astype(np.int64))
                np.testing.assert_allclose(_col(out, "s"), want_s,
                                           rtol=SUM_RTOL)

            sql = JOIN_SQL.format(d=name)
            ph.run(f"join_{name}", lambda s=sql: db.query_sql_table(s), check)
            _log(f"  B.join_{name}: {int(cnt[k].sum())} joined rows")
    finally:
        cfg.eager_join_aggregation, cfg.join_cache_entries = saved
    ph.summary(jax)


def phase_c(jax, rows: int, seed: int, names):
    """TPC-H-derived suite through query_sql_table, each query against
    benchmarks/tpch.py's oracle at check_results' rtol=2e-3: grouped
    SUMs accumulate in f32 (ROADMAP 1g)."""
    import tpch

    t0 = time.perf_counter()
    tables = tpch.make_tables(rows, seed=seed)
    db = tpch.build_db(tables)
    _log(f"  C: tables generated and loaded in {time.perf_counter() - t0:.1f} s")
    ph = Phase("C", rows)
    for name in names:
        want = tpch.oracle(tables, name)
        sql = tpch.QUERIES[name]
        ph.run(name, lambda s=sql: db.query_sql_table(s),
               lambda got, n=name, w=want: tpch.check_results(n, got, w))
    ph.summary(jax)


def phase_d(jax, db):
    """Served path: POST SQL to an in-process QueryServer and compare
    the rows with the in-process answers."""
    from warpdb_tpu.serve import QueryServer, _jsonable

    srv = QueryServer(db, "127.0.0.1", 0).start()
    ph = Phase("D", db.num_rows)
    try:
        for i, sql in enumerate(SERVED):
            want = {k: _jsonable(v) for k, v in db.query_sql_table(sql).items()}

            def post(sql=sql):
                req = urllib.request.Request(
                    f"http://127.0.0.1:{srv.port}/query",
                    data=json.dumps({"sql": sql}).encode(),
                    headers={"Content-Type": "application/json"},
                )
                with urllib.request.urlopen(req, timeout=600) as resp:
                    assert resp.status == 200, resp.status
                    return json.loads(resp.read())["columns"]

            def check(got, want=want):
                # Keys, counts and selected values compare exactly; the
                # f32 SUM column ``s`` may differ in the last bits between
                # runs (scatter-add sums use atomics on the GPU).
                assert got.keys() == want.keys(), (got.keys(), want.keys())
                for name in want:
                    g = np.asarray(got[name], np.float64)
                    w = np.asarray(want[name], np.float64)
                    if name == "s":
                        np.testing.assert_allclose(g, w, rtol=SUM_RTOL)
                    else:
                        np.testing.assert_array_equal(g, w)

            ph.run(f"served_{i}", post, check)
    finally:
        srv.shutdown()
    ph.summary(jax)


class _Outcomes:
    """pytest plugin counting test outcomes."""

    def __init__(self):
        self.counts: dict = {}

    def pytest_runtest_logreport(self, report):
        if report.when == "call" or report.outcome != "passed":
            self.counts[report.outcome] = self.counts.get(report.outcome, 0) + 1


def phase_e(jax):
    """The tests marked ``gpu``, in this process (one process per card)."""
    import pytest

    os.environ["WARPDB_TEST_GPU"] = "1"
    plugin = _Outcomes()
    t0 = time.perf_counter()
    rc = pytest.main(
        ["-q", "-m", "gpu", "-p", "no:cacheprovider",
         os.path.join(ROOT, "tests")],
        plugins=[plugin],
    )
    _log(f"phase E: gpu tests {plugin.counts}, exit {int(rc)}, "
         f"{time.perf_counter() - t0:.1f} s")
    assert int(rc) == 0 and plugin.counts.get("passed", 0) > 0, plugin.counts
    assert not plugin.counts.get("skipped"), plugin.counts


# --- sharded paths (--devices N) ---------------------------------------------


def _collective_ns(trace_dir: str) -> dict:
    """Device time (ns) of collective kernels per device plane in the
    newest profiler trace under ``trace_dir``."""
    from jax.profiler import ProfileData

    paths = sorted(glob.glob(os.path.join(
        trace_dir, "plugins", "profile", "*", "*.xplane.pb")))
    if not paths:
        return {}
    pd = ProfileData.from_file(paths[-1])
    words = ("nccl", "all-to-all", "all-gather", "all-reduce",
             "alltoall", "allgather", "allreduce", "collective")
    out = {}
    for plane in pd.planes:
        if "/device:" not in plane.name:
            continue
        total = 0.0
        for line in plane.lines:
            for ev in line.events:
                if any(w in ev.name.lower() for w in words):
                    total += ev.duration_ns
        out[plane.name] = total
    return out


def phase_sharded(jax, n_dev: int, rows: int, seed: int, trace_dir: str):
    """Row-sharded scan, distributed GROUP BY (all_gather merge, combine
    shuffle, row shuffle), shuffle join and distributed window on an
    n-device mesh, each against one device and a NumPy reference."""
    import oracle

    from warpdb_tpu import WarpDB
    from warpdb_tpu.config import get_config
    from warpdb_tpu.frontend import parse_expression_text, parse_query_text
    from warpdb_tpu.parallel.mesh import data_mesh
    from warpdb_tpu.storage import HostTable

    mesh = data_mesh(n_dev)
    table = make_table(rows, seed)
    rng = np.random.default_rng(seed + 2)
    table["k13"] = rng.integers(0, 1 << 13, rows).astype(np.float32)
    builds = _join_tables(rows, seed)
    host = HostTable.from_dict(table)
    single = WarpDB(host)
    meshed = WarpDB(host, mesh=mesh)
    for name, cols in builds.items():
        single.register_table(name, HostTable.from_dict(cols))
        meshed.register_table(name, HostTable.from_dict(cols))
    ph = Phase(f"S{n_dev}", rows)

    expr = "price * quantity WHERE price > 15"
    want_scan = oracle.query_expression(
        table, parse_expression_text("price * quantity"),
        parse_expression_text("price > 15"),
    )
    one = single.query_np(expr)
    np.testing.assert_allclose(one, want_scan, rtol=EXPR_RTOL)

    def check_scan(got):
        got = np.asarray(got, np.float32)
        np.testing.assert_allclose(got, want_scan, rtol=EXPR_RTOL)
        np.testing.assert_allclose(got, one, rtol=EXPR_RTOL)

    ph.run("sharded_scan", lambda: meshed.query_sharded(expr), check_scan)

    queries = {
        # 32 keys: per-shard partials merged by all_gather.
        "group_allgather": (
            "SELECT quantity, SUM(price) AS s, COUNT(*) AS c, MIN(price) "
            "AS mn FROM t GROUP BY quantity ORDER BY quantity ASC",
            "quantity", ("sharded_group",),
        ),
        # 8192 keys: map-side combine, then the all-to-all exchange.
        "group_combine": (
            "SELECT k13, SUM(price) AS s, COUNT(*) AS c, MIN(price) AS mn "
            "FROM t GROUP BY k13 ORDER BY k13 ASC",
            "k13", ("combine_shuffle_group",),
        ),
        # 65536 keys: past the combine capacity (16384 distinct keys
        # per shard) the raw rows shuffle — at full size only.
        "group_shuffle": (
            "SELECT k, SUM(price) AS s, COUNT(*) AS c, MIN(price) AS mn "
            "FROM t GROUP BY k ORDER BY k ASC",
            "k", ("combine_shuffle_group", "shuffle_group")
            if min(rows // n_dev, 1 << 16) > 16384
            else ("combine_shuffle_group",),
        ),
    }
    for label, (sql, key, want_ops) in queries.items():
        uniq, counts, sums, mins = np_group(table[key], table["price"])
        one = single.query_sql_table(sql)

        def check(out, key=key, uniq=uniq, counts=counts, sums=sums,
                  mins=mins, one=one):
            for ref_keys in (uniq, _col(one, key)):
                np.testing.assert_array_equal(_col(out, key), ref_keys)
            np.testing.assert_array_equal(_col(out, "c", np.int64), counts)
            np.testing.assert_array_equal(_col(out, "mn", np.float32), mins)
            np.testing.assert_allclose(_col(out, "s"), sums, rtol=SUM_RTOL)
            np.testing.assert_allclose(_col(out, "s"), _col(one, "s"),
                                       rtol=SUM_RTOL)

        ph.run(label, lambda s=sql: meshed.query_sql_table(s), check)
        ops = _operators(lambda s=sql: meshed.query_sql_table(s))
        assert ops & {"sharded_group", "combine_shuffle_group",
                      "shuffle_group"} == set(want_ops), (label, ops)

    cfg = get_config()
    saved = cfg.eager_join_aggregation, cfg.join_cache_entries
    cfg.eager_join_aggregation, cfg.join_cache_entries = False, 0
    try:
        sql = JOIN_SQL.format(d="d2")
        k = table["k"].astype(np.int64)
        kk = builds["d2"]["k2"].astype(np.int64)
        wsum = np.bincount(kk, weights=builds["d2"]["w"].astype(np.float64),
                           minlength=1 << 16)
        q = table["quantity"].astype(np.int64)
        want_s = np.bincount(q, weights=table["price"] * wsum[k], minlength=32)
        one = single.query_sql_table(sql)

        def check_join(out):
            np.testing.assert_array_equal(_col(out, "c", np.int64),
                                          2 * np.bincount(q, minlength=32))
            np.testing.assert_allclose(_col(out, "s"), want_s, rtol=SUM_RTOL)
            np.testing.assert_allclose(_col(out, "s"), _col(one, "s"),
                                       rtol=SUM_RTOL)

        ph.run("shuffle_join", lambda: meshed.query_sql_table(sql),
               check_join)
        ops = _operators(lambda: meshed.query_sql_table(sql))
        assert "dist_join" in ops, ops
    finally:
        cfg.eager_join_aggregation, cfg.join_cache_entries = saved

    sql = SQL_A["window"]
    want_w = oracle.query_sql(table, parse_query_text(sql))
    one = np.asarray(single.query_sql(sql), np.float32)

    def check_window(got):
        got = np.asarray(got, np.float32)
        np.testing.assert_allclose(got, want_w, rtol=SUM_RTOL)
        np.testing.assert_allclose(got, one, rtol=SUM_RTOL)

    ph.run("window", lambda: meshed.query_sql(sql), check_window)
    assert "dist_window" in _operators(lambda: meshed.query_sql(sql))
    ph.summary(jax)

    # Collective time: one traced steady run of each distributed query,
    # beside the analytic bytes at the NVLink data-sheet rate.
    for label, (sql, _key, _op) in queries.items():
        _traced_collectives(jax, label, trace_dir,
                            lambda s=sql: meshed.query_sql_table(s))
    cfg.eager_join_aggregation, cfg.join_cache_entries = False, 0
    try:
        _traced_collectives(
            jax, "shuffle_join", trace_dir,
            lambda: meshed.query_sql_table(JOIN_SQL.format(d="d2")))
    finally:
        cfg.eager_join_aggregation, cfg.join_cache_entries = saved


def _recorded(fn) -> list:
    """QueryMetrics recorded while ``fn`` ran (an outer record catches
    entry points that keep none of their own)."""
    from warpdb_tpu.utils.metrics import history, timed_query

    before = len(history())
    with timed_query("chip_smoke", "sql", 0, 0):
        fn()
    return history()[before:]


def _operators(fn) -> set:
    """Names of the cached kernels one call of ``fn`` ran."""
    return {name for m in _recorded(fn) for name, _ in m.operators}


def _traced_collectives(jax, label, trace_dir, fn):
    d = os.path.join(trace_dir, label)
    with jax.profiler.trace(d):
        coll = [c for m in _recorded(fn) for c in m.collectives]
    per_dev = _collective_ns(d)
    nbytes = max((b for _op, b in coll), default=0)
    total = sum(b for _op, b in coll)
    model_ms = total / (NVLINK_GBPS * 1e9) * 1e3
    meas = (
        f"{max(per_dev.values()) / 1e6:.3f} ms (max over devices, "
        "profiler)" if per_dev else "not measured (no device plane)"
    )
    _log(
        f"  collectives {label}: device time {meas}; analytic {total} B/device "
        f"(largest {nbytes} B) = {model_ms:.3f} ms at {NVLINK_GBPS:g} GB/s "
        "NVLink data-sheet rate"
    )


# --- main -------------------------------------------------------------------


def add_paths() -> None:
    """Make the repo, its oracle (tests/) and benchmarks/ importable."""
    for sub in ("", "tests", "benchmarks"):
        path = os.path.join(ROOT, sub)
        if path not in sys.path:
            sys.path.insert(0, path)


def _nvidia_smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="1: phases A-E; N>1: only the sharded paths")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rehearse", action="store_true",
                    help="CPU rehearsal at tiny sizes (never a GPU result)")
    args = ap.parse_args(argv)

    import jax

    if args.rehearse:
        jax.config.update("jax_platforms", "cpu")
        if args.devices > 1:
            jax.config.update("jax_num_cpu_devices", args.devices)
    devices = jax.devices()
    platform = devices[0].platform
    if not args.rehearse and platform != "gpu":
        print(f"chip_smoke: no GPU found (JAX backend: {platform})",
              file=sys.stderr)
        return 1
    if len(devices) < args.devices:
        print(f"chip_smoke: need {args.devices} devices, have "
              f"{len(devices)}", file=sys.stderr)
        return 1

    add_paths()
    os.chdir(ROOT)  # custom.py (the discount UDF) is found from here

    from warpdb_tpu.config import configure_compilation_cache

    _log(f"compilation cache: {configure_compilation_cache()}")
    _log(f"device_kind: {devices[0].device_kind} ({platform}, "
         f"{len(devices)} visible)")
    _log("nvidia-smi: " + (
        _nvidia_smi() if not args.rehearse else "not run (CPU rehearsal)"))
    size = 1 if args.rehearse else 0
    t0 = time.perf_counter()

    if args.devices > 1:
        trace_dir = os.path.join(ROOT, ".jax_traces")
        phase_sharded(jax, args.devices, SIZES["S"][size], args.seed,
                      trace_dir)
    else:
        db = phase_a(jax, SIZES["A"][size], args.seed)
        phase_d(jax, db)
        del db
        gc.collect()
        phase_b(jax, SIZES["B"][size], args.seed)
        gc.collect()
        import tpch

        names = TPCH_REHEARSAL if args.rehearse else tuple(tpch.QUERIES)
        phase_c(jax, SIZES["C"][size], args.seed, names)
        gc.collect()
        if args.rehearse:
            _log("phase E: not run in a CPU rehearsal")
        else:
            phase_e(jax)

    _log(f"total wall {time.perf_counter() - t0:.1f} s")
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": platform,
            "kind": devices[0].device_kind,
            "count": len(devices),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
