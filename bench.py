"""Benchmark: rows/s/chip on the reference query set (BASELINE.md).

The reference publishes no numbers (BASELINE.md: "none published"), so
``vs_baseline`` is measured against an honest stand-in: the NumPy oracle
(vectorized single-core CPU) running the identical query set on the same
host.  Primary metric: geometric-mean rows/s/chip across the query set.

Run it on a GPU: ``python bench.py``.  The HBM peak comes from
``warpdb_tpu.utils.metrics.PEAK_HBM_BYTES_PER_S`` by the device's
``device_kind``; a device not in that table is an error.
``WARPDB_BENCH_CPU=1`` runs a CPU rehearsal at any size (the
``make check`` smoke): no roofline check, and the output names the CPU.

Methodology notes:

* every query's device pipeline is timed as N passes inside ONE jitted
  ``lax.scan`` whose body consumes every lane via a full reduction and
  perturbs the input per-iteration in a way that CHANGES THE RESULT
  (``price + i·1e-7`` flips condition outcomes near thresholds) — so
  XLA can neither hoist the body nor dead-code-eliminate lanes; every
  kernel also reports effective GB/s, and any above the device's HBM
  peak is flagged (a leak detector, VERDICT r3 #5);
* every timed call forces the scalar result to host; the per-pass time
  is the two-point difference t(N_HI) − t(N_LO) divided by
  N_HI − N_LO, cancelling the constant dispatch and sync latency;
* end-to-end wall-clock for the SQL queries (parse → validate →
  kernel → transfer → host finishing) is reported separately in the
  breakdown as ``e2e_*``.

Prints ONE JSON line:
  {"metric": "rows_per_second_per_chip", "value": N, "unit": "rows/s/chip",
   "vs_baseline": R, ...breakdown...}
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

EXPR_QUERIES = [
    # Reference query set (README.md:154-173): fused filter+projection.
    ("proj_revenue", "price * quantity"),
    ("filter_gt", "price WHERE price > 15"),
    ("filter_proj", "price * 0.9 WHERE price > 20"),
    ("proj_tax", "price * quantity * 1.08"),
    ("udf_discount", "discount(price, 0.9)"),
]
SQL_QUERIES = [
    ("group_sum", "SELECT SUM(price) FROM t GROUP BY quantity ORDER BY quantity ASC"),
    ("orderby_limit", "SELECT price FROM t ORDER BY price DESC LIMIT 5"),
]

import os

# Row count override for the `make check` smoke (scripts/check_gate.py):
# the full 33.5M-row run is a real-chip benchmark; the smoke only needs
# every section to EXECUTE and produce no *_error keys.
EXPR_ROWS = int(os.environ.get("WARPDB_BENCH_ROWS", 1 << 25))
GROUP_SLOTS = 32
TOPK = 16
ITERS_LO = 10
ITERS_HI = 410
REPEATS = 5


def _make_table(n: int) -> dict:
    rng = np.random.default_rng(12345)
    return {
        "price": rng.uniform(0.0, 100.0, n).astype(np.float32),
        "quantity": rng.integers(0, GROUP_SLOTS, n).astype(np.float32),
        # High-cardinality key for the breadth extras (sorted group path).
        "k": rng.integers(0, 1 << 16, n).astype(np.float32),
    }


def _times(fn) -> list:
    """Sorted wall times of REPEATS runs of fn(), which must itself
    block (forcing its result to host).  One warm/compile run first."""
    fn()
    times = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return sorted(times)


def _time(fn) -> float:
    """Median-of-REPEATS wall time of fn()."""
    return _times(fn)[REPEATS // 2]


def _time_spread(fn):
    """(min, median, max) wall time of fn() over REPEATS runs — the
    spread makes run-to-run noise visible next to every reported rate."""
    ts = _times(fn)
    return ts[0], ts[REPEATS // 2], ts[-1]


def _time_per_iter(make_loop, args):
    """(min, median, max, guard) per-pass time via two-point
    differencing: removes the constant dispatch and sync cost from the
    measurement.  The i-th order statistics of the two runs pair up,
    so the spread stays meaningful.

    * lo/hi runs INTERLEAVE (lo,hi,lo,hi,…) and difference temporally
      ADJACENT pairs, so drift between separated batches cannot shrink
      the difference;
    * the span (ITERS_HI−ITERS_LO = 400) keeps the differenced signal
      an order of magnitude above ms-scale drift;
    * ``guard`` is the CONSERVATIVE bound ``(max t_hi − min t_lo) /
      span`` used by the roofline check: jitter can only INFLATE it,
      while a genuine hoist keeps even this bound tiny, so detection
      power is unchanged."""
    lo = make_loop(ITERS_LO)
    hi = make_loop(ITERS_HI)
    # Warm both compiles, then interleave the timed runs.
    float(lo(*args))
    float(hi(*args))
    t_lo, t_hi = [], []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        float(lo(*args))
        t_lo.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        float(hi(*args))
        t_hi.append(time.perf_counter() - t0)
    dts = sorted(
        max(h - l, 1e-9) / (ITERS_HI - ITERS_LO)
        for h, l in zip(t_hi, t_lo)
    )
    guard = max(max(t_hi) - min(t_lo), 1e-9) / (ITERS_HI - ITERS_LO)
    return dts[0], dts[len(dts) // 2], dts[-1], guard


def main() -> None:
    import jax

    rehearsal = bool(os.environ.get("WARPDB_BENCH_CPU"))
    if rehearsal:
        jax.config.update("jax_platforms", "cpu")

    from warpdb_tpu.config import configure_compilation_cache
    from warpdb_tpu.utils.metrics import peak_hbm_bytes_per_s

    configure_compilation_cache()
    dev = jax.devices()[0]
    device = {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
    }
    hbm_peak_gbps = None
    if not rehearsal:
        peak = peak_hbm_bytes_per_s(dev.device_kind)
        if peak is None:
            raise SystemExit(
                f"bench.py: no HBM peak for device kind {dev.device_kind!r};"
                " add it to warpdb_tpu.utils.metrics.PEAK_HBM_BYTES_PER_S"
                " (or set WARPDB_BENCH_CPU=1 for a CPU rehearsal)"
            )
        hbm_peak_gbps = peak / 1e9
    import jax.numpy as jnp
    from jax import lax

    from warpdb_tpu import WarpDB
    from warpdb_tpu.api import _split_where
    from warpdb_tpu.engine.compiler import _as_bool, _as_f32, build_evaluator
    from warpdb_tpu.frontend import parse_expression_text, parse_query_text
    from warpdb_tpu.ops.aggregate import midrange_group_aggregate
    from warpdb_tpu.ops.sort import top_k_values
    from warpdb_tpu.storage import HostTable

    table_np = _make_table(EXPR_ROWS)
    db = WarpDB(HostTable.from_dict(table_np))
    cols = db.table.columns
    n_rows = jnp.int32(db.table.num_rows)

    # The materialized-join cache would make repeated identical join
    # queries skip the join entirely — honest COLD numbers need it off
    # (the warm number is reported separately, outside the geomean).
    from warpdb_tpu.config import get_config

    get_config().join_cache_entries = 0

    results = {}
    extras = {}

    # --- expression pipelines -------------------------------------------------
    def make_expr_loop_factory(text):
        e, w = _split_where(text)
        expr_fn = build_evaluator(parse_expression_text(e))
        cond_fn = build_evaluator(parse_expression_text(w)) if w else None

        def factory(iters):
            @jax.jit
            def loop(cols, num_rows):
                n_pad = next(iter(cols.values())).shape[0]
                base_valid = jnp.arange(n_pad, dtype=jnp.int32) < num_rows

                def body(acc, i):
                    c = dict(cols)
                    # Anti-hoist, two layers (VERDICT r3 #5, r4 #2):
                    # * i·1e-7 changes the CONDITION'S TRUTH SET (rows
                    #   near thresholds flip), so filter bodies depend
                    #   on i and cannot be hoisted;
                    # * acc·1e-30 makes the COLUMN ITSELF depend on the
                    #   loop carry, so even expressions AFFINE in price
                    #   (udf_discount = 0.9·price leaked past the
                    #   roofline — XLA split Σᵢ Σᵣ 0.9·(pᵣ+i·δ) into one hoisted
                    #   column pass plus a closed form in i) cannot have
                    #   their reduction split or any pass hoisted: the
                    #   input of iteration k needs the output of k-1.
                    #   acc ≤ ~2e11 so the term is ≤ 2e-19, below f32
                    #   ulp at price scale — results are bit-identical,
                    #   but the dependence is opaque to the compiler.
                    c["price"] = c["price"] + (
                        acc * jnp.float32(1e-30)
                        + i.astype(jnp.float32) * 1e-7
                    )
                    out = jnp.broadcast_to(_as_f32(expr_fn(c)), (n_pad,))
                    valid = base_valid
                    if cond_fn is not None:
                        valid = jnp.logical_and(valid, _as_bool(cond_fn(c)))
                    out = jnp.where(valid, out, 0.0)
                    return acc + jnp.sum(out), None

                acc, _ = lax.scan(body, jnp.float32(0.0), jnp.arange(iters))
                return acc

            return loop

        return factory

    from warpdb_tpu.frontend import column_refs

    def _bytes_per_pass(text):
        """HBM bytes one pass must read: every referenced column once."""
        e, w = _split_where(text)
        refs = set()
        for part in (e, w):
            if part:
                for r in column_refs(parse_expression_text(part)):
                    refs.add(r.unqualified)
        return sum(
            cols[r].dtype.itemsize * cols[r].shape[0]
            for r in refs
            if r in cols
        )

    spreads = {}
    gbps = {}
    gbps_lo = {}
    for name, text in EXPR_QUERIES:
        lo_dt, dt, hi_dt, guard_dt = _time_per_iter(
            make_expr_loop_factory(text), (cols, n_rows)
        )
        results[name] = EXPR_ROWS / dt
        spreads[name] = [round(EXPR_ROWS / hi_dt), round(EXPR_ROWS / lo_dt)]
        gbps[name] = _bytes_per_pass(text) / dt / 1e9
        gbps_lo[name] = _bytes_per_pass(text) / guard_dt / 1e9

    # --- grouped aggregation pipeline (dense path) -----------------------------
    def group_loop_factory(iters):
        @jax.jit
        def loop(cols, num_rows):
            n_pad = cols["price"].shape[0]
            valid = jnp.arange(n_pad, dtype=jnp.int32) < num_rows

            def body(acc, i):
                # Carry-dependent perturbation — see make_expr_loop_factory.
                vals = cols["price"] + (
                    acc * jnp.float32(1e-30) + i.astype(jnp.float32) * 1e-7
                )
                g = midrange_group_aggregate(
                    cols["quantity"], (vals,), valid, 0, GROUP_SLOTS,
                    need=("sum",),
                )
                return acc + jnp.sum(g.values[0].sums), None

            acc, _ = lax.scan(body, jnp.float32(0.0), jnp.arange(iters))
            return acc

        return loop

    lo_dt, dt, hi_dt, guard_dt = _time_per_iter(
    group_loop_factory, (cols, n_rows))
    results["group_sum"] = EXPR_ROWS / dt
    spreads["group_sum"] = [round(EXPR_ROWS / hi_dt), round(EXPR_ROWS / lo_dt)]
    gbps["group_sum"] = 8 * EXPR_ROWS / dt / 1e9  # price + quantity
    gbps_lo["group_sum"] = 8 * EXPR_ROWS / guard_dt / 1e9

    # --- order-by + limit pipeline (top-k) ---------------------------------------
    def topk_loop_factory(iters):
        @jax.jit
        def loop(cols, num_rows):
            n_pad = cols["price"].shape[0]
            valid = jnp.arange(n_pad, dtype=jnp.int32) < num_rows

            def body(acc, i):
                # Carry-dependent perturbation — see make_expr_loop_factory.
                vals = cols["price"] + (
                    acc * jnp.float32(1e-30) + i.astype(jnp.float32) * 1e-7
                )
                top = top_k_values(vals, valid, TOPK, ascending=False)
                return acc + top[0], None

            acc, _ = lax.scan(body, jnp.float32(0.0), jnp.arange(iters))
            return acc

        return loop

    lo_dt, dt, hi_dt, guard_dt = _time_per_iter(
    topk_loop_factory, (cols, n_rows))
    results["orderby_limit"] = EXPR_ROWS / dt
    spreads["orderby_limit"] = [
        round(EXPR_ROWS / hi_dt), round(EXPR_ROWS / lo_dt)
    ]
    gbps["orderby_limit"] = 4 * EXPR_ROWS / dt / 1e9  # price
    gbps_lo["orderby_limit"] = 4 * EXPR_ROWS / guard_dt / 1e9

    # Roofline sanity: a kernel claiming more HBM bytes/s than the
    # device has is a measurement leak, not a result.  The check uses
    # the SLOWEST repeat (gbps_lo): if even that implies super-roofline
    # bandwidth the body is leaking, while a median excursion within
    # the spread is jitter.  Violations are COLLECTED, excluded from
    # the headline geomean, and emitted in a `roofline_violations` key
    # — never raised, so one leaky microbench cannot erase the whole
    # record (VERDICT r4 Weak #1).  `make check-chip` fails on the key.
    roofline_violations = {}
    if hbm_peak_gbps is not None:
        for name, g in gbps_lo.items():
            if g > hbm_peak_gbps:
                roofline_violations[name] = round(g, 1)

    # --- end-to-end SQL wall-clock (incl. transfer + host finishing) ------------
    e2e_spreads = {}
    for name, sql in SQL_QUERIES:
        lo_t, dt, hi_t = _time_spread(lambda s=sql: db.query_sql(s))
        extras[f"e2e_{name}_rows_per_s"] = round(EXPR_ROWS / dt)
        e2e_spreads[f"e2e_{name}"] = [
            round(EXPR_ROWS / hi_t), round(EXPR_ROWS / lo_t)
        ]

    # --- breadth extras (outside the geomean; e2e wall incl. transfer) ---------
    rng = np.random.default_rng(7)
    rates = HostTable.from_dict(
        {
            "quantity": np.arange(GROUP_SLOTS, dtype=np.float32),
            "rate": rng.uniform(0.0, 1.0, GROUP_SLOTS).astype(np.float32),
        }
    )
    db.register_table("rates", rates)
    # Duplicate build keys force the general expansion join (the
    # dimension query below takes the probe-preserving lookup path, so
    # without this the sort-merge machinery would be regress-invisible).
    dup = HostTable.from_dict(
        {
            "quantity": np.tile(
                np.arange(GROUP_SLOTS, dtype=np.float32), 2
            ),
            "bonus": rng.uniform(0.0, 1.0, 2 * GROUP_SLOTS).astype(
                np.float32
            ),
        }
    )
    db.register_table("dup", dup)
    breadth = {
        "e2e_join": (
            "SELECT price FROM t JOIN rates ON quantity = rates.quantity "
            "WHERE rates.rate > 0.5 ORDER BY price DESC LIMIT 5"
        ),
        "e2e_join_expand": (
            "SELECT SUM(price * dup.bonus) FROM t "
            "JOIN dup ON quantity = dup.quantity "
            "GROUP BY quantity ORDER BY quantity ASC"
        ),
        # Probe-side predicate pushdown: the WHERE compacts the probe to
        # ~1% before the join materialises.
        "e2e_join_filtered": (
            "SELECT SUM(price * rate) FROM t "
            "JOIN rates ON quantity = rates.quantity "
            "WHERE price > 99 GROUP BY quantity ORDER BY quantity ASC "
            "LIMIT 5"
        ),
        "e2e_window": (
            "SELECT SUM(price) OVER (PARTITION BY quantity) FROM t "
            "WHERE price > 99.5"
        ),
        # Window EXPRESSION (deviation-from-mean): the fused device path
        # evaluates both windows + the arithmetic in ONE program and
        # ships a single compacted column (VERDICT r4 #5).
        "e2e_window_expr": (
            "SELECT (price - AVG(price) OVER (PARTITION BY quantity)) "
            "* 2 + MIN(price) OVER (PARTITION BY quantity) FROM t "
            "WHERE price > 99.5"
        ),
        "e2e_distinct": "SELECT DISTINCT quantity FROM t",
        # Order-preserving filtered projection: two-phase compaction,
        # O(matches) transfer (~0.5% selectivity here).
        "e2e_filter_project": "SELECT price FROM t WHERE price > 99.5",
        "e2e_group_highcard": "SELECT SUM(price) FROM t GROUP BY k LIMIT 5",
    }
    for name, sql in breadth.items():
        try:
            if name == "e2e_join_expand":
                # Measure the RAW expansion machinery (the optimizer's
                # eager-aggregation rewrite would legitimately skip it).
                get_config().eager_join_aggregation = False
            lo_t, dt, hi_t = _time_spread(lambda s=sql: db.query_sql(s))
            extras[f"{name}_rows_per_s"] = round(EXPR_ROWS / dt)
            e2e_spreads[name] = [
                round(EXPR_ROWS / hi_t), round(EXPR_ROWS / lo_t)
            ]
        except Exception as e:  # never fail the whole bench on an extra
            extras[f"{name}_error"] = str(e)[:120]
        finally:
            get_config().eager_join_aggregation = True

    # The same 1:N join-aggregate through the eager-aggregation rewrite
    # (pre-aggregated build side + 1:1 lookup join) — the plan the
    # optimizer actually picks.  Outside the geomean (the raw expansion
    # number above keeps that machinery regress-visible).
    try:
        lo_t, dt, hi_t = _time_spread(
            lambda: db.query_sql(breadth["e2e_join_expand"])
        )
        extras["join_pushdown_rows_per_s"] = round(EXPR_ROWS / dt)
        e2e_spreads["join_pushdown"] = [
            round(EXPR_ROWS / hi_t), round(EXPR_ROWS / lo_t)
        ]
    except Exception as e:
        extras["join_pushdown_error"] = str(e)[:120]

    # Warm repeat with the materialized-join cache on (default config):
    # repeated star-schema queries skip the join.  Outside the geomean.
    try:
        get_config().join_cache_entries = 4
        lo_t, dt, hi_t = _time_spread(
            lambda: db.query_sql(breadth["e2e_join"])
        )
        extras["join_cached_rows_per_s"] = round(EXPR_ROWS / dt)
        e2e_spreads["join_cached"] = [
            round(EXPR_ROWS / hi_t), round(EXPR_ROWS / lo_t)
        ]
        get_config().join_cache_entries = 0
    except Exception as e:
        extras["join_cached_error"] = str(e)[:120]

    # TPC-H-derived suite (benchmarks/tpch.py): the star-schema queries
    # at 16M lineitem rows, e2e wall per query — the "production
    # workload" number beside the micro query set.  Correctness is
    # pinned by tests/test_tpch.py's oracle gate.
    #
    # Default engine config (the join memo back on — the micro sections
    # above disable it to expose raw join machinery), and the 33.5M-row
    # micro tables + their memoized join intermediates released first,
    # so dead device memory does not sit under the star schema.
    get_config().join_cache_entries = 4
    del db, cols
    import gc

    gc.collect()
    try:
        sys.path.insert(0, "benchmarks")
        import signal

        import tpch

        TPCH_ROWS = min(EXPR_ROWS, 1 << 24)
        tables = tpch.make_tables(TPCH_ROWS)
        tdb = tpch.build_db(tables)
        trates = {}
        twalls = {}
        terrors = {}

        class _QueryTimeout(Exception):
            pass

        def _alarm(_sig, _frm):
            raise _QueryTimeout()

        have_alarm = hasattr(signal, "SIGALRM")
        if have_alarm:
            old_alarm = signal.signal(signal.SIGALRM, _alarm)
        # Per-query isolation (VERDICT r4 #2): one failing or
        # pathologically-compiling query must cost only its own row,
        # never the section.  First call = compile wall (unless the
        # persistent cache hits), reported per query.
        for tname, tsql in tpch.QUERIES.items():
            try:
                if have_alarm:
                    signal.alarm(900)
                t0 = time.perf_counter()
                tdb.query_sql_table(tsql)
                twalls[tname] = round(time.perf_counter() - t0, 3)
                dt = _time(lambda s=tsql: tdb.query_sql_table(s))
                trates[tname] = TPCH_ROWS / dt
            except _QueryTimeout:
                terrors[tname] = "timeout (900s)"
            except Exception as e:
                terrors[tname] = str(e)[:120]
            finally:
                if have_alarm:
                    signal.alarm(0)
        if have_alarm:
            signal.signal(signal.SIGALRM, old_alarm)
        extras["tpch_per_query_rows_per_s"] = {
            k: round(v) for k, v in trates.items()
        }
        extras["tpch_first_call_wall_s"] = twalls
        if terrors:
            extras["tpch_error"] = terrors
        if trates:
            tg = np.asarray(list(trates.values()), dtype=np.float64)
            extras["tpch_geomean_rows_per_s"] = round(
                float(np.exp(np.log(tg).mean()))
            )
    except Exception as e:  # never fail the whole bench on the suite
        extras["tpch_error"] = str(e)[:120]

    # End-to-end geomean across the FULL query set (parse → device →
    # transfer → host finishing) — printed beside the
    # kernel geomean so the sort-bound paths (join/window/distinct/
    # high-cardinality GROUP BY) regress visibly instead of hiding
    # outside the headline.
    e2e_rates = [
        v for k, v in extras.items()
        if k.startswith("e2e_") and k.endswith("_rows_per_s")
    ]
    if e2e_rates:
        ge = np.asarray(e2e_rates, dtype=np.float64)
        extras["e2e_value"] = round(float(np.exp(np.log(ge).mean())))
        extras["e2e_unit"] = "rows/s/chip e2e geomean"

    # --- NumPy oracle baseline ---------------------------------------------------
    sys.path.insert(0, "tests")
    import oracle  # noqa: PLC0415

    base_rows = 1 << 22
    base = {k: v[:base_rows] for k, v in table_np.items()}
    baseline = {}
    def best_of(fn, k=3):
        times = []
        for _ in range(k):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return min(times)

    for name, text in EXPR_QUERIES:
        e, w = _split_where(text)
        ea = parse_expression_text(e)
        ca = parse_expression_text(w) if w else None
        baseline[name] = base_rows / best_of(
            lambda: oracle.query_expression(base, ea, ca)
        )
    for name, sql in SQL_QUERIES:
        q = parse_query_text(sql)
        baseline[name] = base_rows / best_of(lambda: oracle.query_sql(base, q))

    def geomean(xs):
        xs = np.asarray(list(xs), dtype=np.float64)
        return float(np.exp(np.log(xs).mean()))

    # Roofline violators are excluded from the headline geomean — their
    # raw numbers stay visible in per_query_rows_per_s, flagged by the
    # roofline_violations key.
    clean = {k: v for k, v in results.items() if k not in roofline_violations}
    value = geomean(clean.values())
    vs = geomean(clean[k] / baseline[k] for k in clean)

    out = {
        "metric": "rows_per_second_per_chip",
        "value": round(value),
        "unit": "rows/s/chip",
        "vs_baseline": round(vs, 3),
        "baseline": "numpy oracle, same host (reference publishes no numbers)",
        "rows": EXPR_ROWS,
        "per_query_rows_per_s": {k: round(v) for k, v in results.items()},
        "per_query_gbps": {k: round(v, 1) for k, v in gbps.items()},
        "device": device,
        "hbm_peak_gbps": hbm_peak_gbps,
        "roofline_violations": roofline_violations,
        "per_query_spread_rows_per_s": spreads,
        "e2e_spread_rows_per_s": e2e_spreads,
        "per_query_speedup": {
            k: round(results[k] / baseline[k], 2) for k in results
        },
        **extras,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
