"""TPC-H-derived analytics benchmark for warpdb_tpu.

Six queries adapted from the TPC-H suite (Q1, Q3, Q5, Q6, Q12, Q18) to
the engine's type system (f32 measures, dictionary-encoded strings; ISO
date strings order chronologically through the shared sorted vocabulary,
so date range predicates are plain string comparisons).  This is NOT a
compliant TPC-H run — it is a star-schema stress suite exercising the
paths a production deployment hits: multi-way joins, string predicates,
LIKE, CASE aggregation, expression-over-aggregates, HAVING, and top-k.

The reference (seanwevans/WarpDB) parses JOIN but never executes it
(warpdb.hpp:22-23) and publishes no benchmark numbers (SURVEY.md §6);
this suite is the "exceeds" evidence for BASELINE.md's join configs.

Usage:
    python benchmarks/tpch.py [--rows 4194304] [--check] [--json]

--check runs every query at small scale against a pandas-free NumPy
oracle first (tests/test_tpch.py runs the same oracle in CI).

Timing: e2e wall-clock per query (parse -> device -> transfer -> host
finishing), median of 3 after one warm/compile run —
the same discipline as bench.py's e2e numbers.  Metric: lineitem rows/s
per query + geomean.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

# Date vocabularies: ~2.5k distinct ISO days spanning 1992-01-01..1998-12-01
# (the TPC-H order-date span).  Strings sort chronologically.
_D0 = np.datetime64("1992-01-01")
_DAYS = 2527


def _iso_dates(rng: np.random.Generator, n: int) -> np.ndarray:
    offs = rng.integers(0, _DAYS, n)
    return (_D0 + offs.astype("timedelta64[D]")).astype(str)


def make_tables(rows: int, seed: int = 42) -> dict:
    """Generate the six tables.  ``rows`` = lineitem cardinality; the
    dimension cardinalities keep TPC-H's rough ratios (orders = rows/4,
    customers = orders/10, parts = rows/16, 100 suppliers, 25 nations)."""
    rng = np.random.default_rng(seed)
    n_orders = max(rows // 4, 64)
    n_cust = max(n_orders // 10, 16)
    n_part = max(rows // 16, 32)
    n_supp = 100
    n_nation = 25

    region = {
        "r_regionkey": np.arange(5, dtype=np.float32),
        "r_name": np.array(
            ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
        ),
    }
    nation = {
        "n_nationkey": np.arange(n_nation, dtype=np.float32),
        "n_name": np.array(
            [f"NATION_{i:02d}" for i in range(n_nation)]
        ),
        # dbgen maps each nation to one of the 5 regions.
        "n_regionkey": (
            np.arange(n_nation, dtype=np.float32) % 5
        ),
    }
    # s_comment: ~1% carry dbgen's "Customer …Complaints" marker (q16's
    # NOT IN exclusion set must be small but non-empty).
    s_comment = np.array(
        ["carefully final accounts"] * n_supp, dtype=object
    )
    s_comment[rng.integers(0, n_supp, max(n_supp // 100, 2))] = (
        "slyly Customer ironic Complaints"
    )
    supplier = {
        "s_suppkey": np.arange(n_supp, dtype=np.float32),
        "s_name": np.array(
            [f"Supplier#{i:09d}" for i in range(n_supp)]
        ),
        "s_nationkey": rng.integers(0, n_nation, n_supp).astype(np.float32),
        "s_comment": s_comment.astype(str),
    }
    customer = {
        "c_custkey": np.arange(n_cust, dtype=np.float32),
        "c_mktsegment": np.array(
            ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"]
        )[rng.integers(0, 5, n_cust)],
        "c_nationkey": rng.integers(0, n_nation, n_cust).astype(np.float32),
        # dbgen phones: "CC-…" where CC = 10 + nationkey-ish (10..34).
        "c_phone": np.array([
            f"{10 + int(c)}-{i % 900 + 100}-{(i * 7) % 9000 + 1000}"
            for i, c in enumerate(
                rng.integers(0, n_nation, n_cust)
            )
        ]),
        "c_acctbal": rng.uniform(-999.99, 9999.99, n_cust).astype(
            np.float32
        ),
    }
    # o_comment: ~2% carry the "special … requests" marker q13 excludes.
    o_comment = np.array(["quick final deposits"] * n_orders, dtype=object)
    special = rng.random(n_orders) < 0.02
    o_comment[special] = "pending special packages requests"
    orders = {
        "o_orderkey": np.arange(n_orders, dtype=np.float32),
        # dbgen leaves 1/3 of customers order-less (q13's zero bucket,
        # q22's NOT EXISTS positives): orders draw from the low 2/3.
        "o_custkey": rng.integers(
            0, max(2 * n_cust // 3, 1), n_orders
        ).astype(np.float32),
        "o_orderdate": _iso_dates(rng, n_orders),
        "o_orderpriority": np.array(
            ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
        )[rng.integers(0, 5, n_orders)],
        "o_shippriority": np.zeros(n_orders, dtype=np.float32),
        "o_totalprice": rng.uniform(1e3, 5e5, n_orders).astype(np.float32),
        "o_orderstatus": np.array(["F", "O", "P"])[
            rng.integers(0, 3, n_orders)
        ],
        "o_comment": o_comment.astype(str),
    }
    # p_type mirrors dbgen's "<prefix> <finish> <metal>" grammar; 1/6 of
    # types are PROMO% (the q14 numerator's LIKE predicate).
    type_vocab = np.array(
        [
            f"{pre} {fin} {met}"
            for pre in ("ECONOMY", "LARGE", "MEDIUM", "PROMO",
                        "SMALL", "STANDARD")
            for fin in ("ANODIZED", "BRUSHED", "BURNISHED", "PLATED",
                        "POLISHED")
            for met in ("BRASS", "COPPER", "NICKEL", "STEEL", "TIN")
        ]
    )
    # p_name: dbgen's space-joined color words; ~1/COLORS of parts start
    # with "forest" (q20) and ~2/COLORS contain "green" (q9).
    colors = np.array(
        ["almond", "azure", "blue", "chiffon", "forest", "green",
         "honeydew", "ivory", "khaki", "lime", "metallic", "navy",
         "olive", "pale", "rose", "sandy", "spring", "thistle"]
    )
    p_name = np.char.add(
        np.char.add(colors[rng.integers(0, len(colors), n_part)], " "),
        colors[rng.integers(0, len(colors), n_part)],
    )
    part = {
        "p_partkey": np.arange(n_part, dtype=np.float32),
        "p_name": p_name,
        "p_type": type_vocab[rng.integers(0, len(type_vocab), n_part)],
        # dbgen's Brand#MN grammar: 25 brands (q19's OR-of-AND arms).
        "p_brand": np.array(
            [f"Brand#{m}{n}" for m in range(1, 6) for n in range(1, 6)]
        )[rng.integers(0, 25, n_part)],
        "p_size": rng.integers(1, 51, n_part).astype(np.float32),
        "p_container": np.array(
            [f"{sz} {kind}"
             for sz in ("SM", "MED", "LG", "JUMBO", "WRAP")
             for kind in ("BAG", "BOX", "CAN", "CASE", "DRUM",
                          "JAR", "PACK", "PKG")]
        )[rng.integers(0, 40, n_part)],
    }
    # partsupp: every part stocked by 4 DISTINCT suppliers at distinct
    # costs (q2's correlated MIN-cost subquery needs real per-part
    # minima; q9/q20 join lineitem back to its part's supplier set).
    n_ps = n_part * 4
    ps_partkey = np.repeat(np.arange(n_part, dtype=np.float32), 4)
    ps_suppkey = (
        (ps_partkey + np.tile(np.arange(4, dtype=np.float32), n_part)
         * (n_supp // 4)) % n_supp
    )
    partsupp = {
        "ps_partkey": ps_partkey,
        "ps_suppkey": ps_suppkey,
        "ps_availqty": rng.integers(1, 10_000, n_ps).astype(np.float32),
        "ps_supplycost": rng.uniform(1.0, 1000.0, n_ps).astype(np.float32),
    }
    qty = rng.integers(1, 51, rows).astype(np.float32)
    price = (qty * rng.uniform(900, 1100, rows)).astype(np.float32)
    # commit/receipt dates: receipt = commit + offset drawn from [-20, 30)
    # days, so ~60% of lineitems are received strictly after their commit
    # date (q4's "late" EXISTS predicate selects a real, biased subset —
    # roughly dbgen's late fraction).
    commit_offs = rng.integers(0, _DAYS, rows)
    receipt_offs = np.clip(
        commit_offs + rng.integers(-20, 30, rows), 0, _DAYS - 1
    )
    commit = (_D0 + commit_offs.astype("timedelta64[D]")).astype(str)
    receipt = (_D0 + receipt_offs.astype("timedelta64[D]")).astype(str)
    # Each lineitem draws its supplier from its part's 4-supplier
    # partsupp set (dbgen does the same), so the (l_partkey, l_suppkey)
    # pair always matches exactly one partsupp row — q9's two-key join.
    l_partkey = rng.integers(0, n_part, rows).astype(np.float32)
    l_suppkey = (
        (l_partkey + rng.integers(0, 4, rows) * (n_supp // 4)) % n_supp
    ).astype(np.float32)
    lineitem = {
        "l_orderkey": rng.integers(0, n_orders, rows).astype(np.float32),
        "l_partkey": l_partkey,
        "l_suppkey": l_suppkey,
        "l_quantity": qty,
        "l_extendedprice": price,
        # One of 11 discrete discounts/taxes, like dbgen.
        "l_discount": (rng.integers(0, 11, rows) / 100.0).astype(np.float32),
        "l_tax": (rng.integers(0, 9, rows) / 100.0).astype(np.float32),
        "l_returnflag": np.array(["A", "N", "R"])[rng.integers(0, 3, rows)],
        "l_linestatus": np.array(["F", "O"])[rng.integers(0, 2, rows)],
        "l_shipdate": _iso_dates(rng, rows),
        "l_commitdate": commit,
        "l_receiptdate": receipt,
        "l_shipmode": np.array(
            ["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK"]
        )[rng.integers(0, 7, rows)],
    }
    return {
        "lineitem": lineitem,
        "orders": orders,
        "customer": customer,
        "supplier": supplier,
        "nation": nation,
        "region": region,
        "part": part,
        "partsupp": partsupp,
    }


QUERIES = {
    # Q1 pricing summary report: wide multi-aggregate GROUP BY over a
    # date-range filter (dense path: 6 string-pair groups).
    "q1": (
        "SELECT l_returnflag, l_linestatus, "
        "SUM(l_quantity) AS sum_qty, "
        "SUM(l_extendedprice) AS sum_base, "
        "SUM(l_extendedprice * (1 - l_discount)) AS sum_disc, "
        "SUM(l_extendedprice * (1 - l_discount) * (1 + l_tax)) AS sum_chg, "
        "AVG(l_quantity) AS avg_qty, AVG(l_discount) AS avg_disc, "
        "COUNT(*) AS n "
        "FROM lineitem WHERE l_shipdate <= '1998-09-02' "
        "GROUP BY l_returnflag, l_linestatus "
        "ORDER BY l_returnflag ASC, l_linestatus ASC"
    ),
    # Q3 shipping priority: 2 joins, selective predicates on BOTH sides,
    # high-cardinality GROUP BY over the joined table, top-10 by revenue.
    "q3": (
        "SELECT l_orderkey, "
        "SUM(l_extendedprice * (1 - l_discount)) AS revenue "
        "FROM lineitem "
        "JOIN orders ON l_orderkey = orders.o_orderkey "
        "JOIN customer ON orders.o_custkey = customer.c_custkey "
        "WHERE customer.c_mktsegment = 'BUILDING' "
        "AND orders.o_orderdate < '1995-03-15' "
        "AND l_shipdate > '1995-03-15' "
        "GROUP BY l_orderkey ORDER BY revenue DESC LIMIT 10"
    ),
    # Q4 order priority checking: correlated EXISTS (decorrelates into a
    # grouped LEFT semi-join) under a date-range filter on the outer.
    "q4": (
        "SELECT o_orderpriority, COUNT(*) AS n "
        "FROM orders "
        "WHERE o_orderdate >= '1993-07-01' AND o_orderdate < '1993-10-01' "
        "AND EXISTS (SELECT * FROM lineitem "
        "WHERE l_orderkey = o_orderkey "
        "AND l_commitdate < l_receiptdate) "
        "GROUP BY o_orderpriority ORDER BY o_orderpriority ASC"
    ),
    # Q5-style local supplier volume: fact -> supplier -> nation chain,
    # GROUP BY nation name (string), revenue-ordered.
    "q5": (
        "SELECT nation.n_name, "
        "SUM(l_extendedprice * (1 - l_discount)) AS revenue "
        "FROM lineitem "
        "JOIN supplier ON l_suppkey = supplier.s_suppkey "
        "JOIN nation ON supplier.s_nationkey = nation.n_nationkey "
        "GROUP BY nation.n_name ORDER BY revenue DESC"
    ),
    # Q6 forecast revenue: pure scan with a 3-predicate filter and one
    # global aggregate (the HBM-roofline query).
    "q6": (
        "SELECT SUM(l_extendedprice * l_discount) AS revenue "
        "FROM lineitem WHERE l_shipdate >= '1994-01-01' "
        "AND l_shipdate < '1995-01-01' "
        "AND l_discount BETWEEN 0.05 AND 0.07 AND l_quantity < 24"
    ),
    # Q10 returned item reporting: three-way join with selective filters
    # on fact AND both dimensions, high-cardinality GROUP BY, top-20.
    "q10": (
        "SELECT customer.c_custkey, "
        "SUM(l_extendedprice * (1 - l_discount)) AS revenue "
        "FROM lineitem "
        "JOIN orders ON l_orderkey = orders.o_orderkey "
        "JOIN customer ON orders.o_custkey = customer.c_custkey "
        "WHERE l_returnflag = 'R' "
        "AND orders.o_orderdate >= '1993-10-01' "
        "AND orders.o_orderdate < '1994-01-01' "
        "GROUP BY customer.c_custkey ORDER BY revenue DESC LIMIT 20"
    ),
    # Q12 shipping modes: join + CASE-based conditional aggregation.
    "q12": (
        "SELECT l_shipmode, "
        "SUM(CASE WHEN orders.o_orderpriority = '1-URGENT' "
        "OR orders.o_orderpriority = '2-HIGH' THEN 1 ELSE 0 END) AS high, "
        "SUM(CASE WHEN orders.o_orderpriority <> '1-URGENT' "
        "AND orders.o_orderpriority <> '2-HIGH' THEN 1 ELSE 0 END) AS low "
        "FROM lineitem JOIN orders ON l_orderkey = orders.o_orderkey "
        "WHERE l_shipmode IN ('MAIL', 'SHIP') "
        "AND l_shipdate >= '1994-01-01' AND l_shipdate < '1995-01-01' "
        "GROUP BY l_shipmode ORDER BY l_shipmode ASC"
    ),
    # Q14 promotion effect: part-dimension join, LIKE-gated CASE
    # numerator, expression OVER two global aggregates (ratio).
    "q14": (
        "SELECT 100 * SUM(CASE WHEN part.p_type LIKE 'PROMO%' "
        "THEN l_extendedprice * (1 - l_discount) ELSE 0 END) "
        "/ SUM(l_extendedprice * (1 - l_discount)) AS promo_revenue "
        "FROM lineitem JOIN part ON l_partkey = part.p_partkey "
        "WHERE l_shipdate >= '1995-09-01' AND l_shipdate < '1995-10-01'"
    ),
    # Q18-style large-volume customers: high-cardinality GROUP BY with
    # HAVING over SUM, top-k.
    "q18": (
        "SELECT l_orderkey, SUM(l_quantity) AS total_qty "
        "FROM lineitem GROUP BY l_orderkey "
        "HAVING SUM(l_quantity) > 150 "
        "ORDER BY total_qty DESC LIMIT 100"
    ),
    # Q2 minimum-cost supplier: correlated scalar MIN subquery (the
    # decorrelator turns it into a grouped-MIN join) over partsupp.
    "q2": (
        "SELECT ps_suppkey, ps_supplycost FROM partsupp "
        "JOIN part ON ps_partkey = part.p_partkey "
        "WHERE ps_supplycost = "
        "(SELECT MIN(ps_supplycost) FROM partsupp ps2 "
        "WHERE ps2.ps_partkey = part.p_partkey) "
        "ORDER BY ps_supplycost ASC LIMIT 100"
    ),
    # Q15 top supplier: CTE (revenue view) over an aggregate, joined
    # back and filtered by an uncorrelated scalar MAX over the view.
    "q15": (
        "WITH revenue AS ("
        "SELECT l_suppkey, "
        "SUM(l_extendedprice * (1 - l_discount)) AS total_revenue "
        "FROM lineitem "
        "WHERE l_shipdate >= '1996-01-01' AND l_shipdate < '1996-04-01' "
        "GROUP BY l_suppkey) "
        "SELECT l_suppkey, total_revenue FROM revenue "
        "WHERE total_revenue = (SELECT MAX(total_revenue) FROM revenue)"
    ),
    # Q7 volume shipping: 5-way join chain with the SAME dimension
    # (nation) joined twice under different aliases, an OR of alias
    # pairs, and a 3-key GROUP BY including a YEAR() extraction.
    "q7": (
        "SELECT n1.n_name AS supp_nation, n2.n_name AS cust_nation, "
        "YEAR(l_shipdate) AS l_year, "
        "SUM(l_extendedprice * (1 - l_discount)) AS revenue "
        "FROM lineitem "
        "JOIN supplier ON l_suppkey = supplier.s_suppkey "
        "JOIN orders ON l_orderkey = orders.o_orderkey "
        "JOIN customer ON orders.o_custkey = customer.c_custkey "
        "JOIN nation n1 ON supplier.s_nationkey = n1.n_nationkey "
        "JOIN nation n2 ON customer.c_nationkey = n2.n_nationkey "
        "WHERE ((n1.n_name = 'NATION_07' AND n2.n_name = 'NATION_08') "
        "OR (n1.n_name = 'NATION_08' AND n2.n_name = 'NATION_07')) "
        "AND l_shipdate >= '1995-01-01' AND l_shipdate <= '1996-12-31' "
        "GROUP BY supp_nation, cust_nation, l_year "
        "ORDER BY supp_nation ASC, cust_nation ASC, l_year ASC"
    ),
    # Q8 national market share: 7-way join through region, a CASE
    # numerator over a ratio of grouped SUMs, YEAR() grouping.
    "q8": (
        "SELECT YEAR(orders.o_orderdate) AS o_year, "
        "SUM(CASE WHEN n2.n_name = 'NATION_05' "
        "THEN l_extendedprice * (1 - l_discount) ELSE 0 END) "
        "/ SUM(l_extendedprice * (1 - l_discount)) AS mkt_share "
        "FROM lineitem "
        "JOIN part ON l_partkey = part.p_partkey "
        "JOIN supplier ON l_suppkey = supplier.s_suppkey "
        "JOIN orders ON l_orderkey = orders.o_orderkey "
        "JOIN customer ON orders.o_custkey = customer.c_custkey "
        "JOIN nation n1 ON customer.c_nationkey = n1.n_nationkey "
        "JOIN region ON n1.n_regionkey = region.r_regionkey "
        "JOIN nation n2 ON supplier.s_nationkey = n2.n_nationkey "
        "WHERE region.r_name = 'AMERICA' "
        "AND part.p_type = 'ECONOMY ANODIZED STEEL' "
        "AND orders.o_orderdate >= '1995-01-01' "
        "AND orders.o_orderdate <= '1996-12-31' "
        "GROUP BY o_year ORDER BY o_year ASC"
    ),
    # Q9 product type profit: two-key join (l_partkey, l_suppkey) into
    # partsupp, %substring% LIKE, profit expression mixing four tables,
    # GROUP BY (nation, year).
    "q9": (
        "SELECT nation.n_name AS nation, "
        "YEAR(orders.o_orderdate) AS o_year, "
        "SUM(l_extendedprice * (1 - l_discount) "
        "- partsupp.ps_supplycost * l_quantity) AS sum_profit "
        "FROM lineitem "
        "JOIN supplier ON l_suppkey = supplier.s_suppkey "
        "JOIN part ON l_partkey = part.p_partkey "
        "JOIN partsupp ON l_partkey = partsupp.ps_partkey "
        "AND l_suppkey = partsupp.ps_suppkey "
        "JOIN orders ON l_orderkey = orders.o_orderkey "
        "JOIN nation ON supplier.s_nationkey = nation.n_nationkey "
        "WHERE part.p_name LIKE '%green%' "
        "GROUP BY nation, o_year ORDER BY nation ASC, o_year DESC"
    ),
    # Q11 important stock: grouped value SUM gated by HAVING against an
    # uncorrelated scalar subquery that itself runs the same join chain.
    "q11": (
        "SELECT ps_partkey, "
        "SUM(ps_supplycost * ps_availqty) AS value "
        "FROM partsupp "
        "JOIN supplier ON ps_suppkey = supplier.s_suppkey "
        "JOIN nation ON supplier.s_nationkey = nation.n_nationkey "
        "WHERE nation.n_name = 'NATION_07' "
        "GROUP BY ps_partkey "
        "HAVING SUM(ps_supplycost * ps_availqty) > "
        "(SELECT 0.002 * SUM(ps_supplycost * ps_availqty) FROM partsupp "
        "JOIN supplier ON ps_suppkey = supplier.s_suppkey "
        "JOIN nation ON supplier.s_nationkey = nation.n_nationkey "
        "WHERE nation.n_name = 'NATION_07') "
        "ORDER BY value DESC LIMIT 100"
    ),
    # Q13 customer order distribution: LEFT JOIN against a NOT-LIKE
    # filtered CTE, then a two-level aggregate (COUNT per customer,
    # histogram of counts) through a derived table.
    "q13": (
        "WITH filtered AS (SELECT o_orderkey, o_custkey FROM orders "
        "WHERE o_comment NOT LIKE '%special%requests%') "
        "SELECT c_count, COUNT(*) AS custdist FROM "
        "(SELECT customer.c_custkey AS ck, "
        "COUNT(filtered.o_orderkey) AS c_count "
        "FROM customer LEFT JOIN filtered "
        "ON c_custkey = filtered.o_custkey "
        "GROUP BY ck) c_orders "
        "GROUP BY c_count ORDER BY custdist DESC, c_count DESC"
    ),
    # Q19 discounted revenue: disjunction of multi-way conjunctions
    # mixing part-side string equality with fact-side ranges + IN.
    "q19": (
        "SELECT SUM(l_extendedprice * (1 - l_discount)) AS revenue "
        "FROM lineitem JOIN part ON l_partkey = part.p_partkey "
        "WHERE (part.p_brand = 'Brand#12' AND l_quantity >= 1 "
        "AND l_quantity <= 11 AND l_shipmode IN ('AIR', 'REG AIR')) "
        "OR (part.p_brand = 'Brand#23' AND l_quantity >= 10 "
        "AND l_quantity <= 20 AND l_shipmode IN ('AIR', 'REG AIR')) "
        "OR (part.p_brand = 'Brand#34' AND l_quantity >= 20 "
        "AND l_quantity <= 30 AND l_shipmode IN ('AIR', 'REG AIR'))"
    ),
    # Q16 parts/supplier relationship: grouped COUNT(DISTINCT), a NOT IN
    # uncorrelated subquery exclusion set, NOT LIKE, numeric IN list,
    # and a 4-key ORDER BY led by the aggregate.
    "q16": (
        "SELECT part.p_brand, part.p_type, part.p_size, "
        "COUNT(DISTINCT ps_suppkey) AS supplier_cnt "
        "FROM partsupp JOIN part ON ps_partkey = part.p_partkey "
        "WHERE part.p_brand <> 'Brand#45' "
        "AND part.p_type NOT LIKE 'MEDIUM POLISHED%' "
        "AND part.p_size IN (1, 4, 7, 10, 14, 23, 45, 49) "
        "AND ps_suppkey NOT IN (SELECT s_suppkey FROM supplier "
        "WHERE s_comment LIKE '%Customer%Complaints%') "
        "GROUP BY part.p_brand, part.p_type, part.p_size "
        "ORDER BY supplier_cnt DESC, part.p_brand ASC, part.p_type ASC, "
        "part.p_size ASC LIMIT 50"
    ),
    # Q17 small-quantity-order revenue: correlated scalar AVG subquery
    # against the fact table itself, correlation key reaching through
    # the outer JOIN's part relation.  (Container widened to LIKE 'MED%'
    # so the 20k-row check scale keeps a non-vacuous match set.)
    "q17": (
        "SELECT SUM(l_extendedprice) / 7.0 AS avg_yearly "
        "FROM lineitem JOIN part ON l_partkey = part.p_partkey "
        "WHERE part.p_brand = 'Brand#23' AND part.p_container LIKE 'MED%' "
        "AND l_quantity < (SELECT 0.2 * AVG(l_quantity) FROM lineitem "
        "WHERE l_partkey = part.p_partkey)"
    ),
    # Q20 potential part promotion: IN subquery whose inner query nests
    # another IN subquery AND a two-key correlated scalar SUM over the
    # fact table (the deepest decorrelation in the suite).
    "q20": (
        "SELECT s_name FROM supplier "
        "JOIN nation ON s_nationkey = nation.n_nationkey "
        "WHERE s_suppkey IN (SELECT ps_suppkey FROM partsupp "
        "WHERE ps_partkey IN (SELECT p_partkey FROM part "
        "WHERE p_name LIKE 'forest%') "
        "AND ps_availqty > (SELECT 0.5 * SUM(l_quantity) FROM lineitem "
        "WHERE l_partkey = ps_partkey AND l_suppkey = ps_suppkey "
        "AND l_shipdate >= '1994-01-01' AND l_shipdate < '1995-01-01')) "
        "AND nation.n_name = 'NATION_03' "
        "ORDER BY s_name ASC"
    ),
    # Q21 suppliers who kept orders waiting: self-joined fact under an
    # alias, EXISTS and NOT EXISTS each carrying the one-<>-conjunct
    # correlation ("another supplier on the same order").
    "q21": (
        "SELECT supplier.s_name, COUNT(*) AS numwait "
        "FROM lineitem l1 "
        "JOIN supplier ON l1.l_suppkey = supplier.s_suppkey "
        "JOIN orders ON l1.l_orderkey = orders.o_orderkey "
        "JOIN nation ON supplier.s_nationkey = nation.n_nationkey "
        "WHERE orders.o_orderstatus = 'F' "
        "AND l1.l_receiptdate > l1.l_commitdate "
        "AND EXISTS (SELECT * FROM lineitem l2 "
        "WHERE l2.l_orderkey = l1.l_orderkey "
        "AND l2.l_suppkey <> l1.l_suppkey) "
        "AND NOT EXISTS (SELECT * FROM lineitem l3 "
        "WHERE l3.l_orderkey = l1.l_orderkey "
        "AND l3.l_suppkey <> l1.l_suppkey "
        "AND l3.l_receiptdate > l3.l_commitdate) "
        "AND nation.n_name = 'NATION_20' "
        "GROUP BY supplier.s_name "
        "ORDER BY numwait DESC, supplier.s_name ASC LIMIT 100"
    ),
    # Q22 global sales opportunity: SUBSTR-derived GROUP BY key through
    # a derived table (fresh string vocabulary), string IN list, an
    # uncorrelated scalar AVG gate, and an anti-join NOT EXISTS.
    "q22": (
        "SELECT cntrycode, COUNT(*) AS numcust, SUM(acctbal) AS totacctbal "
        "FROM (SELECT SUBSTR(c_phone, 1, 2) AS cntrycode, "
        "c_acctbal AS acctbal FROM customer "
        "WHERE SUBSTR(c_phone, 1, 2) IN ('13', '31', '23', '29', '30') "
        "AND c_acctbal > (SELECT AVG(c_acctbal) FROM customer "
        "WHERE c_acctbal > 0.0 "
        "AND SUBSTR(c_phone, 1, 2) IN ('13', '31', '23', '29', '30')) "
        "AND NOT EXISTS (SELECT * FROM orders "
        "WHERE o_custkey = c_custkey)) custsale "
        "GROUP BY cntrycode ORDER BY cntrycode ASC"
    ),
}


# ---------------------------------------------------------------------------
# NumPy oracle (small-scale correctness gate; also run by tests/test_tpch.py)
# ---------------------------------------------------------------------------


def _group_sum(keys: np.ndarray, vals: np.ndarray):
    uk, inv = np.unique(keys, return_inverse=True)
    s = np.zeros(len(uk), np.float64)
    np.add.at(s, inv.reshape(-1), vals.astype(np.float64))
    return uk, s


def oracle(tables: dict, name: str) -> dict:
    li = tables["lineitem"]
    od = tables["orders"]
    cu = tables["customer"]
    if name == "q1":
        m = li["l_shipdate"] <= "1998-09-02"
        flag = np.char.add(
            np.char.add(li["l_returnflag"][m].astype(str), "|"),
            li["l_linestatus"][m].astype(str),
        )
        price = li["l_extendedprice"][m].astype(np.float64)
        disc = li["l_discount"][m].astype(np.float64)
        qty = li["l_quantity"][m].astype(np.float64)
        uk = np.unique(flag)
        out = {"key": uk.tolist()}
        out["sum_qty"] = [qty[flag == k].sum() for k in uk]
        out["sum_disc"] = [
            (price[flag == k] * (1 - disc[flag == k])).sum() for k in uk
        ]
        out["n"] = [(flag == k).sum() for k in uk]
        return out
    if name == "q3":
        seg_ok = cu["c_mktsegment"] == "BUILDING"
        cust_ok = set(cu["c_custkey"][seg_ok].tolist())
        ord_ok = (od["o_orderdate"] < "1995-03-15") & np.isin(
            od["o_custkey"], list(cust_ok)
        )
        ok_orders = set(od["o_orderkey"][ord_ok].tolist())
        m = (li["l_shipdate"] > "1995-03-15") & np.isin(
            li["l_orderkey"], list(ok_orders)
        )
        uk, s = _group_sum(
            li["l_orderkey"][m],
            li["l_extendedprice"][m] * (1 - li["l_discount"][m]),
        )
        order = np.argsort(-s, kind="stable")[:10]
        return {"key": uk[order].tolist(), "revenue": s[order].tolist()}
    if name == "q5":
        su, na = tables["supplier"], tables["nation"]
        snat = su["s_nationkey"][li["l_suppkey"].astype(int)]
        nname = na["n_name"][snat.astype(int)]
        uk, s = _group_sum(
            nname, li["l_extendedprice"] * (1 - li["l_discount"])
        )
        order = np.argsort(-s, kind="stable")
        return {"key": uk[order].tolist(), "revenue": s[order].tolist()}
    if name == "q6":
        m = (
            (li["l_shipdate"] >= "1994-01-01")
            & (li["l_shipdate"] < "1995-01-01")
            & (li["l_discount"] >= 0.05)
            & (li["l_discount"] <= 0.07)
            & (li["l_quantity"] < 24)
        )
        return {
            "revenue": [
                float(
                    (
                        li["l_extendedprice"][m].astype(np.float64)
                        * li["l_discount"][m]
                    ).sum()
                )
            ]
        }
    if name == "q12":
        prio = od["o_orderpriority"][li["l_orderkey"].astype(int)]
        m = (
            np.isin(li["l_shipmode"], ["MAIL", "SHIP"])
            & (li["l_shipdate"] >= "1994-01-01")
            & (li["l_shipdate"] < "1995-01-01")
        )
        hi = np.isin(prio, ["1-URGENT", "2-HIGH"]).astype(np.float64)
        uk = np.unique(li["l_shipmode"][m])
        return {
            "key": uk.tolist(),
            "high": [hi[m][li["l_shipmode"][m] == k].sum() for k in uk],
            "low": [
                (1 - hi[m])[li["l_shipmode"][m] == k].sum() for k in uk
            ],
        }
    if name == "q18":
        uk, s = _group_sum(li["l_orderkey"], li["l_quantity"])
        keep = s > 150
        uk, s = uk[keep], s[keep]
        order = np.argsort(-s, kind="stable")[:100]
        return {"key": uk[order].tolist(), "total_qty": s[order].tolist()}
    if name == "q4":
        late = li["l_commitdate"] < li["l_receiptdate"]
        late_orders = np.unique(li["l_orderkey"][late])
        m = (
            (od["o_orderdate"] >= "1993-07-01")
            & (od["o_orderdate"] < "1993-10-01")
            & np.isin(od["o_orderkey"], late_orders)
        )
        uk, counts = np.unique(od["o_orderpriority"][m], return_counts=True)
        return {"key": uk.tolist(), "n": counts.tolist()}
    if name == "q10":
        ord_ok = (od["o_orderdate"] >= "1993-10-01") & (
            od["o_orderdate"] < "1994-01-01"
        )
        okey_to_cust = dict(
            zip(od["o_orderkey"][ord_ok].tolist(),
                od["o_custkey"][ord_ok].tolist())
        )
        m = (li["l_returnflag"] == "R") & np.isin(
            li["l_orderkey"], list(okey_to_cust)
        )
        cust = np.asarray(
            [okey_to_cust[k] for k in li["l_orderkey"][m].tolist()]
        )
        uk, s = _group_sum(
            cust, li["l_extendedprice"][m] * (1 - li["l_discount"][m])
        )
        order = np.argsort(-s, kind="stable")[:20]
        return {"key": uk[order].tolist(), "revenue": s[order].tolist()}
    if name == "q2":
        ps = tables["partsupp"]
        pk = ps["ps_partkey"].astype(np.int64)
        n_part = int(pk.max()) + 1
        mincost = np.full(n_part, np.inf, np.float32)
        np.minimum.at(mincost, pk, ps["ps_supplycost"])
        m = ps["ps_supplycost"] == mincost[pk]
        costs = np.sort(ps["ps_supplycost"][m])[:100]
        return {"cost": costs.astype(np.float64).tolist()}
    if name == "q15":
        m = (li["l_shipdate"] >= "1996-01-01") & (
            li["l_shipdate"] < "1996-04-01"
        )
        uk, s = _group_sum(
            li["l_suppkey"][m],
            li["l_extendedprice"][m] * (1 - li["l_discount"][m]),
        )
        # f32 engine totals: find the max under the engine's precision.
        s32 = s.astype(np.float32)
        best = s32.max()
        return {
            "key": uk[s32 == best].tolist(),
            "total_revenue": [float(best)],
        }
    if name == "q19":
        pt = tables["part"]
        brand = pt["p_brand"][li["l_partkey"].astype(int)]
        qty = li["l_quantity"]
        mode_ok = np.isin(li["l_shipmode"], ["AIR", "REG AIR"])
        m = (
            ((brand == "Brand#12") & (qty >= 1) & (qty <= 11) & mode_ok)
            | ((brand == "Brand#23") & (qty >= 10) & (qty <= 20) & mode_ok)
            | ((brand == "Brand#34") & (qty >= 20) & (qty <= 30) & mode_ok)
        )
        rev = (
            li["l_extendedprice"][m].astype(np.float64)
            * (1 - li["l_discount"][m].astype(np.float64))
        ).sum()
        return {"revenue": [float(rev)]}
    if name == "q14":
        pt = tables["part"]["p_type"][li["l_partkey"].astype(int)]
        m = (li["l_shipdate"] >= "1995-09-01") & (
            li["l_shipdate"] < "1995-10-01"
        )
        rev = (
            li["l_extendedprice"][m].astype(np.float64)
            * (1 - li["l_discount"][m].astype(np.float64))
        )
        promo = np.char.startswith(pt[m].astype(str), "PROMO")
        return {
            "promo_revenue": [float(100.0 * rev[promo].sum() / rev.sum())]
        }
    if name == "q7":
        su, na = tables["supplier"], tables["nation"]
        sn = na["n_name"][
            su["s_nationkey"][li["l_suppkey"].astype(int)].astype(int)
        ]
        ocust = od["o_custkey"][li["l_orderkey"].astype(int)]
        cn = na["n_name"][
            cu["c_nationkey"][ocust.astype(int)].astype(int)
        ]
        m = (
            (li["l_shipdate"] >= "1995-01-01")
            & (li["l_shipdate"] <= "1996-12-31")
            & (
                ((sn == "NATION_07") & (cn == "NATION_08"))
                | ((sn == "NATION_08") & (cn == "NATION_07"))
            )
        )
        year = np.array([s[:4] for s in li["l_shipdate"][m]])
        key = np.char.add(
            np.char.add(np.char.add(sn[m], "|"), np.char.add(cn[m], "|")),
            year,
        )
        uk, s = _group_sum(
            key, li["l_extendedprice"][m] * (1 - li["l_discount"][m])
        )
        return {"key": uk.tolist(), "revenue": s.tolist()}
    if name == "q8":
        su, na, pt = tables["supplier"], tables["nation"], tables["part"]
        re_ = tables["region"]
        odate = od["o_orderdate"][li["l_orderkey"].astype(int)]
        ocust = od["o_custkey"][li["l_orderkey"].astype(int)]
        cnat = cu["c_nationkey"][ocust.astype(int)].astype(int)
        creg = na["n_regionkey"][cnat].astype(int)
        snat = su["s_nationkey"][li["l_suppkey"].astype(int)].astype(int)
        ptype = pt["p_type"][li["l_partkey"].astype(int)]
        m = (
            (re_["r_name"][creg] == "AMERICA")
            & (ptype == "ECONOMY ANODIZED STEEL")
            & (odate >= "1995-01-01")
            & (odate <= "1996-12-31")
        )
        year = np.array([s[:4] for s in odate[m]])
        vol = (
            li["l_extendedprice"][m].astype(np.float64)
            * (1 - li["l_discount"][m].astype(np.float64))
        )
        brazil = (na["n_name"][snat[m]] == "NATION_05").astype(np.float64)
        uk = np.unique(year)
        return {
            "key": [float(y) for y in uk],
            "mkt_share": [
                float(
                    (vol[year == y] * brazil[year == y]).sum()
                    / vol[year == y].sum()
                )
                for y in uk
            ],
        }
    if name == "q9":
        su, na, pt = tables["supplier"], tables["nation"], tables["part"]
        ps = tables["partsupp"]
        # (part, supp) -> supplycost lookup (pairs are unique).
        n_supp = len(su["s_suppkey"])
        pair = (
            ps["ps_partkey"].astype(np.int64) * n_supp
            + ps["ps_suppkey"].astype(np.int64)
        )
        cost_by_pair = dict(zip(pair.tolist(), ps["ps_supplycost"]))
        lpair = (
            li["l_partkey"].astype(np.int64) * n_supp
            + li["l_suppkey"].astype(np.int64)
        )
        cost = np.array(
            [cost_by_pair[p] for p in lpair.tolist()], np.float64
        )
        m = np.char.find(
            pt["p_name"][li["l_partkey"].astype(int)].astype(str), "green"
        ) >= 0
        nname = na["n_name"][
            su["s_nationkey"][li["l_suppkey"].astype(int)].astype(int)
        ]
        odate = od["o_orderdate"][li["l_orderkey"].astype(int)]
        year = np.array([s[:4] for s in odate])
        key = np.char.add(np.char.add(nname[m], "|"), year[m])
        profit = (
            li["l_extendedprice"][m].astype(np.float64)
            * (1 - li["l_discount"][m].astype(np.float64))
            - cost[m] * li["l_quantity"][m].astype(np.float64)
        )
        uk, s = _group_sum(key, profit)
        return {"key": uk.tolist(), "sum_profit": s.tolist()}
    if name == "q11":
        su, na, ps = tables["supplier"], tables["nation"], tables["partsupp"]
        snat = su["s_nationkey"][ps["ps_suppkey"].astype(int)].astype(int)
        m = na["n_name"][snat] == "NATION_07"
        val = (
            ps["ps_supplycost"].astype(np.float64)
            * ps["ps_availqty"].astype(np.float64)
        )
        uk, s = _group_sum(ps["ps_partkey"][m], val[m])
        thresh = 0.002 * val[m].sum()
        keep = s > thresh
        uk, s = uk[keep], s[keep]
        order = np.argsort(-s, kind="stable")[:100]
        return {"key": uk[order].tolist(), "value": s[order].tolist()}
    if name == "q13":
        keep = ~np.array([
            _like_special(c) for c in od["o_comment"].astype(str)
        ])
        cnt = np.zeros(len(cu["c_custkey"]), np.int64)
        np.add.at(cnt, od["o_custkey"][keep].astype(int), 1)
        uk, dist = np.unique(cnt, return_counts=True)
        order = np.lexsort((-uk, -dist))
        return {
            "c_count": uk[order].astype(np.float64).tolist(),
            "custdist": dist[order].astype(np.float64).tolist(),
        }
    if name == "q16":
        su, pt = tables["supplier"], tables["partsupp"]
        part = tables["part"]
        bad = set(
            tables["supplier"]["s_suppkey"][
                np.array([
                    "Customer" in c
                    and "Complaints" in c.split("Customer", 1)[1]
                    for c in su["s_comment"].astype(str)
                ])
            ].astype(int).tolist()
        )
        pk = pt["ps_partkey"].astype(int)
        pb, ptp, psz = (
            part["p_brand"][pk], part["p_type"][pk], part["p_size"][pk]
        )
        m = (
            (pb != "Brand#45")
            & ~np.char.startswith(ptp.astype(str), "MEDIUM POLISHED")
            & np.isin(psz, [1, 4, 7, 10, 14, 23, 45, 49])
            & ~np.isin(pt["ps_suppkey"].astype(int), list(bad))
        )
        key = np.array([
            f"{b}|{t}|{int(s):02d}"
            for b, t, s in zip(pb[m], ptp[m], psz[m])
        ])
        pair = np.array([
            f"{k}|{int(x)}" for k, x in zip(key, pt["ps_suppkey"][m])
        ])
        upair = np.unique(pair)
        ukey = np.array(["|".join(p.split("|")[:-1]) for p in upair])
        uk, cnt = np.unique(ukey, return_counts=True)
        order = np.lexsort((uk, -cnt))[:50]
        return {
            "key": uk[order].tolist(),
            "supplier_cnt": cnt[order].astype(float).tolist(),
        }
    if name == "q17":
        pt = tables["part"]
        pk = li["l_partkey"].astype(int)
        sums = np.zeros(len(pt["p_partkey"]))
        cnts = np.zeros(len(pt["p_partkey"]))
        np.add.at(sums, pk, li["l_quantity"].astype(np.float64))
        np.add.at(cnts, pk, 1)
        avg = np.divide(
            sums, cnts, out=np.full_like(sums, np.nan), where=cnts > 0
        )
        m = (
            (pt["p_brand"][pk] == "Brand#23")
            & np.char.startswith(
                pt["p_container"][pk].astype(str), "MED"
            )
            & (li["l_quantity"] < 0.2 * avg[pk])
        )
        return {
            "avg_yearly": [float(li["l_extendedprice"][m].sum() / 7.0)]
        }
    if name == "q20":
        su, na, pt = tables["supplier"], tables["nation"], tables["part"]
        ps = tables["partsupp"]
        dm = (
            (li["l_shipdate"] >= "1994-01-01")
            & (li["l_shipdate"] < "1995-01-01")
        )
        pairsum: dict = {}
        for p, s, q in zip(
            li["l_partkey"][dm].astype(int),
            li["l_suppkey"][dm].astype(int), li["l_quantity"][dm],
        ):
            pairsum[(p, s)] = pairsum.get((p, s), 0.0) + float(q)
        fset = set(
            np.where(
                np.char.startswith(pt["p_name"].astype(str), "forest")
            )[0].tolist()
        )
        okset = {
            s
            for p, s, aq in zip(
                ps["ps_partkey"].astype(int),
                ps["ps_suppkey"].astype(int), ps["ps_availqty"],
            )
            if p in fset
            and (p, s) in pairsum
            and aq > 0.5 * pairsum[(p, s)]
        }
        m = np.array([int(k) in okset for k in su["s_suppkey"]]) & (
            na["n_name"][su["s_nationkey"].astype(int)] == "NATION_03"
        )
        return {"s_name": np.sort(su["s_name"][m]).tolist()}
    if name == "q21":
        su, na = tables["supplier"], tables["nation"]
        ok_ = li["l_orderkey"].astype(np.int64)
        sk = li["l_suppkey"].astype(np.int64)
        late = li["l_receiptdate"] > li["l_commitdate"]
        n_supp = len(su["s_suppkey"])
        pair = ok_ * n_supp + sk
        # Distinct (order, supplier) pairs -> per-order supplier counts;
        # same over late rows.  EXISTS(other supplier) == nsup >= 2;
        # NOT EXISTS(other LATE supplier) == nlate == 1 (l1 itself is
        # late, so its supplier is always in the late set).
        nsup = np.zeros(len(od["o_orderkey"]), np.int64)
        np.add.at(nsup, (np.unique(pair) // n_supp).astype(int), 1)
        nlate = np.zeros(len(od["o_orderkey"]), np.int64)
        np.add.at(nlate, (np.unique(pair[late]) // n_supp).astype(int), 1)
        m = (
            late
            & (od["o_orderstatus"][ok_] == "F")
            & (nsup[ok_] >= 2)
            & (nlate[ok_] == 1)
            & (
                na["n_name"][su["s_nationkey"][sk].astype(int)]
                == "NATION_20"
            )
        )
        uk, cnt = np.unique(su["s_name"][sk[m]], return_counts=True)
        order = np.lexsort((uk, -cnt))[:100]
        return {
            "s_name": uk[order].tolist(),
            "numwait": cnt[order].astype(float).tolist(),
        }
    if name == "q22":
        codes = np.array([p[:2] for p in cu["c_phone"].astype(str)])
        inlist = np.isin(codes, ["13", "31", "23", "29", "30"])
        avg = (
            cu["c_acctbal"][(cu["c_acctbal"] > 0) & inlist]
            .astype(np.float64).mean()
        )
        has_ord = np.zeros(len(cu["c_custkey"]), bool)
        has_ord[od["o_custkey"].astype(int)] = True
        m = inlist & (cu["c_acctbal"] > avg) & ~has_ord
        uk, cnt = np.unique(codes[m], return_counts=True)
        sums = np.array([
            cu["c_acctbal"][m][codes[m] == k].astype(np.float64).sum()
            for k in uk
        ])
        return {
            "cntrycode": uk.tolist(),
            "numcust": cnt.astype(float).tolist(),
            "totacctbal": sums.tolist(),
        }
    raise KeyError(name)


def _like_special(c: str) -> bool:
    """NumPy-side '%special%requests%' matcher for the q13 oracle."""
    i = c.find("special")
    return i >= 0 and c.find("requests", i + 7) >= 0


def check_results(name: str, got: dict, want: dict, rtol=2e-3) -> None:
    """Compare engine output columns to the oracle (sorted row multisets
    for value ties; revenue-ordered queries compare the VALUE column
    sorted, since equal revenues may permute keys)."""
    cols = list(got.values())
    if name == "q1":
        key = [f"{a}|{b}" for a, b in zip(cols[0], cols[1])]
        assert key == want["key"], (key, want["key"])
        np.testing.assert_allclose(got["sum_qty"], want["sum_qty"], rtol=rtol)
        np.testing.assert_allclose(got["sum_disc"], want["sum_disc"],
                                   rtol=rtol)
        np.testing.assert_allclose(got["n"], want["n"])
    elif name in ("q3", "q5", "q10", "q18"):
        vcol = "total_qty" if name == "q18" else "revenue"
        np.testing.assert_allclose(
            np.sort(np.asarray(got[vcol], np.float64))[::-1],
            np.sort(np.asarray(want[vcol], np.float64))[::-1],
            rtol=rtol,
        )
    elif name == "q4":
        assert cols[0] == want["key"], (cols[0], want["key"])
        np.testing.assert_allclose(got["n"], want["n"])
    elif name in ("q6", "q14", "q19"):
        vcol = "promo_revenue" if name == "q14" else "revenue"
        np.testing.assert_allclose(got[vcol], want[vcol], rtol=rtol)
    elif name == "q2":
        np.testing.assert_allclose(
            np.sort(np.asarray(got["ps_supplycost"], np.float64)),
            np.sort(np.asarray(want["cost"], np.float64)),
            rtol=rtol,
        )
    elif name == "q15":
        assert sorted(got["l_suppkey"]) == sorted(want["key"]), (
            got["l_suppkey"], want["key"],
        )
        np.testing.assert_allclose(
            got["total_revenue"][:1], want["total_revenue"], rtol=rtol
        )
    elif name == "q12":
        assert cols[0] == want["key"]
        np.testing.assert_allclose(got["high"], want["high"], rtol=rtol)
        np.testing.assert_allclose(got["low"], want["low"], rtol=rtol)
    elif name == "q7":
        key = [
            f"{a}|{b}|{int(y)}"
            for a, b, y in zip(cols[0], cols[1], cols[2])
        ]
        assert key == want["key"], (key, want["key"])
        np.testing.assert_allclose(got["revenue"], want["revenue"],
                                   rtol=rtol)
    elif name == "q8":
        np.testing.assert_allclose(cols[0], want["key"])
        np.testing.assert_allclose(got["mkt_share"], want["mkt_share"],
                                   rtol=rtol, atol=1e-6)
    elif name == "q9":
        key = [f"{a}|{int(y)}" for a, y in zip(cols[0], cols[1])]
        order = np.argsort(key, kind="stable")
        worder = np.argsort(want["key"], kind="stable")
        assert [key[i] for i in order] == [
            want["key"][i] for i in worder
        ]
        np.testing.assert_allclose(
            np.asarray(got["sum_profit"], np.float64)[order],
            np.asarray(want["sum_profit"], np.float64)[worder],
            rtol=rtol,
        )
    elif name == "q11":
        np.testing.assert_allclose(
            np.sort(np.asarray(got["value"], np.float64))[::-1],
            np.sort(np.asarray(want["value"], np.float64))[::-1],
            rtol=rtol,
        )
    elif name == "q13":
        assert got["c_count"] == want["c_count"], (
            got["c_count"], want["c_count"],
        )
        np.testing.assert_allclose(got["custdist"], want["custdist"])
    elif name == "q16":
        key = [
            f"{b}|{t}|{int(s):02d}"
            for b, t, s in zip(cols[0], cols[1], cols[2])
        ]
        assert key == want["key"], (key[:5], want["key"][:5])
        np.testing.assert_array_equal(
            got["supplier_cnt"], want["supplier_cnt"]
        )
    elif name == "q17":
        np.testing.assert_allclose(
            got["avg_yearly"], want["avg_yearly"], rtol=rtol
        )
        assert want["avg_yearly"][0] > 0, "q17 check is vacuous"
    elif name == "q20":
        assert cols[0] == want["s_name"], (cols[0], want["s_name"])
        assert want["s_name"], "q20 check is vacuous"
    elif name == "q21":
        assert cols[0] == want["s_name"], (
            cols[0][:5], want["s_name"][:5],
        )
        np.testing.assert_array_equal(got["numwait"], want["numwait"])
        assert want["s_name"], "q21 check is vacuous"
    elif name == "q22":
        assert cols[0] == want["cntrycode"], (
            cols[0], want["cntrycode"],
        )
        np.testing.assert_array_equal(got["numcust"], want["numcust"])
        np.testing.assert_allclose(
            got["totacctbal"], want["totacctbal"], rtol=rtol
        )
        assert want["cntrycode"], "q22 check is vacuous"
    else:
        # A query without a check branch must never "pass" vacuously.
        raise KeyError(f"check_results has no branch for {name!r}")


def build_db(tables: dict, mesh=None):
    from warpdb_tpu import WarpDB
    from warpdb_tpu.storage import HostTable

    db = WarpDB(HostTable.from_dict(tables["lineitem"]), mesh=mesh)
    # Every relation the suite names is explicitly registered — including
    # the fact table under "lineitem" (subquery FROMs resolve through the
    # catalog; the unknown-name demo fallback is disabled once a catalog
    # exists, see engine/executor.py::_validate_relations).
    db.register_table("lineitem", db.table)
    for name in (
        "orders", "customer", "supplier", "nation", "region", "part",
        "partsupp",
    ):
        db.register_table(name, HostTable.from_dict(tables[name]))
    return db


def run_check(rows: int = 20_000) -> None:
    tables = make_tables(rows, seed=7)
    db = build_db(tables)
    for name in QUERIES:
        got = db.query_sql_table(QUERIES[name])
        check_results(name, got, oracle(tables, name))
        print(f"  {name}: oracle match ({len(list(got.values())[0])} rows)")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1 << 22)
    ap.add_argument("--check", action="store_true",
                    help="small-scale oracle validation before timing")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--only", type=str, default="",
                    help="comma-separated query names (default: all)")
    args = ap.parse_args()

    from warpdb_tpu.config import configure_compilation_cache

    configure_compilation_cache()

    if args.check:
        print("oracle validation @ 20k rows:", flush=True)
        run_check()

    tables = make_tables(args.rows)
    db = build_db(tables)
    rows = args.rows
    out = {"suite": "tpch-derived", "lineitem_rows": rows}
    rates = {}
    first_walls = {}
    names = [n.strip() for n in args.only.split(",") if n.strip()] or list(
        QUERIES
    )
    for name in names:
        sql = QUERIES[name]
        # First call = compile (unless the persistent XLA cache
        # already has the executables) + memo fill + run.  Reported
        # separately so compile cost and run cost can be told apart.
        t0 = time.perf_counter()
        db.query_sql_table(sql)
        first_walls[name] = time.perf_counter() - t0
        times = []
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            db.query_sql_table(sql)
            times.append(time.perf_counter() - t0)
        dt = sorted(times)[len(times) // 2]
        rates[name] = rows / dt
        print(
            f"  {name}: first {first_walls[name]*1e3:9.1f} ms  steady "
            f"{dt*1e3:8.1f} ms  {rates[name]/1e6:9.1f} M rows/s",
            flush=True,
        )
    ge = np.asarray(list(rates.values()), np.float64)
    out["per_query_rows_per_s"] = {k: round(v) for k, v in rates.items()}
    out["first_call_wall_s"] = {
        k: round(v, 3) for k, v in first_walls.items()
    }
    out["geomean_rows_per_s"] = round(float(np.exp(np.log(ge).mean())))
    if args.json:
        print(json.dumps(out))
    else:
        print(f"geomean: {out['geomean_rows_per_s']/1e6:.1f} M rows/s")


if __name__ == "__main__":
    sys.exit(main())
