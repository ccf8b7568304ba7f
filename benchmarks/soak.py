"""Stability soak: a repeated mixed-query workload on one chip.

Asserts the two properties a long-running serving deployment needs:

* **determinism** — every iteration's results hash bit-identically.
  That holds on the CPU.  On the GPU scatter-add lowers to atomics, so
  SUMs through slot tables and the sorted tier can differ in the last
  bits between runs, and this check fails there (see PERF.md);
* **bounded drift** — the last iterations are no slower than the first
  (no leaks from the plan/join/count memos; all are instance-keyed
  LRUs or bounded dicts).

Usage: ``python benchmarks/soak.py [--rows 22] [--iters 30] [--cpu N]``.
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

import numpy as np

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=22,
                    help="log2 of the table rows")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--cpu", type=int, default=0,
                    help="run on N virtual CPU devices instead of the GPU")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", args.cpu)

    from warpdb_tpu import WarpDB
    from warpdb_tpu.storage import HostTable

    rng = np.random.default_rng(7)
    n = 1 << args.rows
    db = WarpDB(
        HostTable.from_dict(
            {
                "price": rng.uniform(0, 100, n).astype(np.float32),
                "quantity": rng.integers(0, 32, n).astype(np.float32),
                "k": rng.integers(0, 1 << 14, n).astype(np.float32),
            }
        )
    )
    db.register_table(
        "rates",
        HostTable.from_dict(
            {
                "quantity": np.arange(32, dtype=np.float32),
                "rate": rng.uniform(0, 1, 32).astype(np.float32),
            }
        ),
    )
    workload = [
        "SELECT SUM(price) FROM t GROUP BY quantity ORDER BY quantity ASC",
        "SELECT price FROM t ORDER BY price DESC LIMIT 5",
        "SELECT price FROM t WHERE price > 99.5",
        "SELECT DISTINCT quantity FROM t",
        "SELECT SUM(price) FROM t GROUP BY k LIMIT 5",
        "SELECT SUM(price) OVER (PARTITION BY quantity) FROM t "
        "WHERE price > 99",
        "SELECT price * rates.rate FROM t "
        "JOIN rates ON quantity = rates.quantity ORDER BY price DESC "
        "LIMIT 3",
        "SELECT PERCENTILE(price, 0.95) FROM t GROUP BY quantity "
        "ORDER BY quantity ASC",
    ]

    def run_once() -> tuple[str, float]:
        h = hashlib.sha256()
        t0 = time.perf_counter()
        for sql in workload:
            out = db.query_sql(sql)
            h.update(np.asarray(out, np.float32).tobytes())
        return h.hexdigest(), time.perf_counter() - t0

    first_hash, _ = run_once()  # compile + warm
    walls = []
    for i in range(args.iters):
        hx, dt = run_once()
        assert hx == first_hash, f"nondeterminism at iteration {i}"
        walls.append(dt)

    head = float(np.median(walls[: max(3, len(walls) // 5)]))
    tail = float(np.median(walls[-max(3, len(walls) // 5):]))
    out = {
        "iters": args.iters,
        "rows": n,
        "queries": len(workload),
        "wall_median_s": round(float(np.median(walls)), 4),
        "wall_head_s": round(head, 4),
        "wall_tail_s": round(tail, 4),
        "drift": round(tail / head, 3),
        "deterministic": True,
    }
    assert tail <= head * 1.5, f"wall-clock drift {out['drift']}x"
    print(json.dumps(out))


if __name__ == "__main__":
    main()
