"""CLI: ``python -m warpdb_tpu "<expr|SQL>" [data_file]``.

Mirrors the reference CLI contract (main.cu:120-128): one query argument
(expression with optional WHERE, or a full SELECT statement), an optional
data file defaulting to ``data/test.csv``, and ``Result[i] = v`` output
lines (main.cu:337-343 / optimizer.cpp:56-58) for side-by-side diffing.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="warpdb_tpu",
        description="Vectorized SQL query engine on JAX/XLA",
    )
    parser.add_argument(
        "query", nargs="?", default=None,
        help='e.g. "price * quantity WHERE price > 10" or a SELECT '
             'statement; omit with --repl',
    )
    parser.add_argument("data_file", nargs="?", default="data/test.csv")
    parser.add_argument("--limit-print", type=int, default=20,
                        help="max result rows to print")
    parser.add_argument("--sharded", action="store_true",
                        help="execute across all local devices")
    parser.add_argument("--profile", metavar="DIR", default=None,
                        help="write a jax profiler trace to DIR")
    parser.add_argument("--demo", action="store_true",
                        help="run the full demo pipeline before the query "
                             "(mirrors the reference CLI, main.cu:120-385)")
    parser.add_argument("--explain", action="store_true",
                        help="print the physical plan instead of executing")
    parser.add_argument("--analyze", action="store_true",
                        help="with --explain: also execute and append the "
                             "measured profile (EXPLAIN ANALYZE)")
    parser.add_argument("--repl", action="store_true",
                        help="interactive SQL shell over the data file")
    parser.add_argument("--serve", metavar="PORT", type=int, default=None,
                        help="serve the data file over HTTP/JSON "
                             "(POST /query, GET /healthz, /schema)")
    args = parser.parse_args(argv)

    from .config import configure_compilation_cache

    configure_compilation_cache()

    from . import WarpDB

    if args.repl:
        return _repl(args.data_file)
    if args.serve is not None:
        from .serve import serve

        serve(WarpDB(args.data_file), port=args.serve)
        return 0
    if args.query is None:
        parser.error("a query is required unless --repl or --serve is given")

    if args.explain:
        db = WarpDB(args.data_file)
        print(db.explain(args.query, analyze=args.analyze))
        return 0

    if args.demo:
        _run_demo(args.data_file)

    t0 = time.perf_counter()
    db = WarpDB(args.data_file)
    t_load = time.perf_counter() - t0
    print(f"Loaded {db.num_rows} rows from {args.data_file} "
          f"({', '.join(db.column_names)}) in {t_load*1e3:.1f} ms")

    profile_ctx = None
    if args.profile:
        import jax

        profile_ctx = jax.profiler.trace(args.profile)
        profile_ctx.__enter__()

    t1 = time.perf_counter()
    is_sql = args.query.strip().upper().startswith(("SELECT", "WITH"))
    if is_sql:
        result = db.query_sql(args.query)
    elif args.sharded:
        result = db.query_sharded(args.query)
    else:
        result = db.query(args.query)
    t_query = time.perf_counter() - t1

    if profile_ctx is not None:
        profile_ctx.__exit__(None, None, None)

    for i, v in enumerate(result[: args.limit_print]):
        print(f"Result[{i}] = {v}")
    if len(result) > args.limit_print:
        print(f"... ({len(result)} rows total)")
    rows = db.num_rows if not is_sql else len(result)
    print(f"Query executed in {t_query*1e3:.2f} ms "
          f"({db.num_rows / max(t_query, 1e-9):,.0f} rows/s incl. compile)")
    return 0


def _repl(data_file: str) -> int:
    """Interactive SQL shell (extension; the reference CLI was single
    shot).  Statements run through the table API and print aligned
    columns; ``.tables`` lists registered relations, ``.schema`` the
    columns, ``.explain <sql>`` the physical plan, ``.load name path``
    registers another table for JOINs, ``.quit`` exits."""
    try:
        import readline  # noqa: F401  (line editing + history)
    except ImportError:
        pass

    from . import WarpDB

    t0 = time.perf_counter()
    db = WarpDB(data_file)
    print(
        f"warpdb_tpu — {db.num_rows} rows from {data_file} "
        f"({', '.join(db.column_names)}) in "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms.  "
        f'Try: SELECT * FROM {db.table_name} LIMIT 5;  (.help for commands)'
    )
    extra_tables: list[str] = []
    while True:
        try:
            line = input("warpdb> ").strip()
        except (EOFError, KeyboardInterrupt):
            print()
            return 0
        if not line:
            continue
        if line.startswith("."):
            cmd, *rest = line.split()
            if cmd in (".quit", ".exit"):
                return 0
            if cmd == ".help":
                print(".tables  .schema  .explain <sql>  "
                      ".load <name> <path>  .quit")
            elif cmd == ".tables":
                print("  ".join([db.table_name, *extra_tables]))
            elif cmd == ".schema":
                for name in db.column_names:
                    dt = db.table.dtypes.get(name)
                    print(f"  {name}  {getattr(dt, 'name', dt)}")
            elif cmd == ".explain":
                try:
                    print(db.explain(line[len(".explain"):].strip()))
                except Exception as e:  # keep the shell alive
                    print(f"error: {e}")
            elif cmd == ".load" and len(rest) == 2:
                try:
                    db.register_table(rest[0], rest[1])
                    extra_tables.append(rest[0])
                    print(f"registered {rest[0]}")
                except Exception as e:
                    print(f"error: {e}")
            else:
                print(f"unknown command: {line} (.help)")
            continue
        sql = line.rstrip(";")
        t0 = time.perf_counter()
        try:
            out = db.query_sql_table(sql)
        except Exception as e:
            print(f"error: {e}")
            continue
        dt = time.perf_counter() - t0
        names = list(out.keys())
        cols = [list(c) for c in out.values()]
        n = len(cols[0]) if cols else 0
        show = min(n, 40)
        cells = [
            [
                (f"{x:.6g}" if not isinstance(x, str) else x)
                for x in c[:show]
            ]
            for c in cols
        ]
        widths = [
            max(len(nm), *(len(x) for x in col)) if col else len(nm)
            for nm, col in zip(names, cells)
        ]
        print("  ".join(nm.ljust(w) for nm, w in zip(names, widths)))
        print("  ".join("-" * w for w in widths))
        for i in range(show):
            print(
                "  ".join(c[i].ljust(w) for c, w in zip(cells, widths))
            )
        tail = f" … ({n} rows)" if n > show else f"({n} rows)"
        print(f"{tail}  {dt * 1e3:.1f} ms")


def _run_demo(data_file: str) -> None:
    """Demo pipeline mirroring the reference CLI's fixed suite
    (main.cu:197-355): print rows, filter count, revenue projections
    (single and dual-output), sharded run, streamed run."""
    from . import WarpDB

    db = WarpDB(data_file)
    cols = db.column_names
    print(f"=== demo: {db.num_rows} rows, columns {cols} ===")

    # print_first_few (main.cu:56-62)
    table = db.table.host
    for i in range(min(db.num_rows, 5)):
        fields = ", ".join(
            f"{c.name}={c.data[i]}" for c in table.columns
        )
        print(f"Row {i}: {fields}")

    if "price" in cols:
        # filter_price_gt with threshold 25.0 (main.cu:200-213) — the
        # reference double-launched without resetting the counter and
        # printed a doubled count; ours is deterministic.
        res = db.query_np("price WHERE price > 25")
        count = int((res != 0).sum())
        print(f"Filtered rows (price > 25.0): {count}")

    if "price" in cols and "quantity" in cols:
        # project_revenue / project_revenue_and_adjusted (main.cu:92-118)
        revenue = db.query("price * quantity")
        adjusted = db.query("price * quantity * 0.9")
        for i in range(min(len(revenue), 5)):
            print(f"Revenue[{i}] = {revenue[i]}  Adjusted[{i}] = {adjusted[i]}")

        # multi-device + streamed multi-device demo (main.cu:352-355)
        sharded = db.query_sharded("price * quantity")
        print(f"Sharded result rows: {len(sharded)}")
        if str(data_file).endswith(".csv"):
            streamed = WarpDB.query_streaming_csv(
                data_file, "price * quantity", rows_per_chunk=1024
            )
            print(f"Streamed result rows: {len(streamed)}")
    print("=== demo done ===")


if __name__ == "__main__":
    sys.exit(main())
