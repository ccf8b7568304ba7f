"""Scaling-efficiency harness: rows/s/chip from 1 device to N.

BASELINE.md target: ≥80% scaling efficiency 1 chip → N hosts on the
reference query set.  This harness runs the two distributed pipelines —
the embarrassingly-parallel fused scan and the all-to-all shuffle
GROUP BY — over growing mesh sizes and reports per-device throughput
and efficiency relative to the single-device run.

Rehearse on virtual CPU devices (`python benchmarks/scaling.py --cpu 8`);
on a multi-GPU host run it unmodified (all local cards), and across
hosts per host after ``parallel.multihost.initialize``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", type=int, default=0,
                    help="force N virtual CPU devices (dev machines)")
    ap.add_argument("--rows", type=int, default=1 << 22)
    ap.add_argument("--keys", type=int, default=8192)
    ap.add_argument(
        "--xcheck", action="store_true",
        help="also run the 2-process loopback wire-byte cross-check of "
        "the analytic collective model (scripts/collective_xcheck.py)",
    )
    args = ap.parse_args()

    xcheck = None
    if args.xcheck:
        import json as _json
        import subprocess
        import sys as _sys

        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        proc = subprocess.run(
            [_sys.executable,
             os.path.join(root, "scripts", "collective_xcheck.py"),
             "--rows", str(min(args.rows, 1 << 20)), "--reps", "10"],
            capture_output=True, text=True, timeout=900,
        )
        for line in proc.stdout.splitlines():
            try:
                xcheck = _json.loads(line)
            except ValueError:
                continue

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", args.cpu)
    import jax
    import jax.numpy as jnp

    from warpdb_tpu.frontend import parse_expression_text
    from warpdb_tpu.parallel.mesh import data_mesh
    from warpdb_tpu.parallel.sharded import run_expression_sharded, shard_table
    from warpdb_tpu.parallel.shuffle import (
        combine_shuffle_grouped,
        shuffle_grouped,
    )
    from warpdb_tpu.storage import HostTable

    n = args.rows
    rng = np.random.default_rng(0)
    host = HostTable.from_dict(
        {
            "price": rng.uniform(0, 100, n).astype(np.float32),
            "k": rng.integers(0, args.keys, n).astype(np.float32),
        }
    )
    expr = parse_expression_text("price * k")
    cond = parse_expression_text("price > 50")
    key = parse_expression_text("k")
    vals = [parse_expression_text("price")]

    total = len(jax.devices())
    sizes = [s for s in (1, 2, 4, 8, 16, 32) if s <= total]
    report = {
        "rows": n, "keys": args.keys,
        "scan": {}, "shuffle_group": {}, "combine_group": {},
    }
    base_scan = base_group = base_combine = None

    from warpdb_tpu.utils.metrics import timed_query, last as last_metric

    # H100 NVLink: 900 GB/s to the other cards of the host, 450 GB/s
    # each way (NVIDIA data sheet, not a measurement) — the all_to_all
    # model bandwidth for the analytic collective bytes (DESIGN.md §6).
    NVLINK_GBPS = 450.0

    def measured_collectives(fn):
        """Run fn under the metrics trace; returns (wall_s, [(op, bytes)])."""
        with timed_query("scaling", "sharded", n, 0):
            fn()
        m = last_metric()
        return list(m.collectives) if m is not None else []

    for s in sizes:
        mesh = data_mesh(s)
        table = shard_table(host, mesh)

        def timed(fn, reps=3):
            fn()
            ts = []
            for _ in range(reps):
                t0 = time.perf_counter()
                fn()
                ts.append(time.perf_counter() - t0)
            return statistics.median(ts)

        t_scan = timed(lambda: run_expression_sharded(table, expr, cond, mesh=mesh))
        t_group = timed(
            lambda: shuffle_grouped(key, vals, None, table, mesh=mesh)
        )
        t_combine = timed(
            lambda: combine_shuffle_grouped(key, vals, None, table, mesh=mesh)
        )
        cs_group = measured_collectives(
            lambda: shuffle_grouped(key, vals, None, table, mesh=mesh)
        )
        cs_combine = measured_collectives(
            lambda: combine_shuffle_grouped(key, vals, None, table, mesh=mesh)
        )

        def collective_model(cs):
            """Per-phase collective bytes + the interconnect time they
            imply at the data-sheet NVLink rate (virtual-CPU walls
            measure host memcpy, not the interconnect)."""
            total = sum(b for _op, b in cs)
            return {
                "per_collective_bytes": [[op, b] for op, b in cs],
                "bytes_per_device": total,
                "nvlink_model_ms": round(total / (NVLINK_GBPS * 1e9) * 1e3, 4),
            }

        scan_rps = n / t_scan
        group_rps = n / t_group
        combine_rps = n / t_combine
        if s == 1:
            base_scan, base_group, base_combine = scan_rps, group_rps, combine_rps
        report["scan"][s] = {
            "rows_per_s": round(scan_rps),
            "per_device": round(scan_rps / s),
            "efficiency": round(scan_rps / (base_scan * s), 3),
            "wall_ms": round(t_scan * 1e3, 3),
            "collectives": {"bytes_per_device": 0, "nvlink_model_ms": 0.0},
        }
        report["shuffle_group"][s] = {
            "rows_per_s": round(group_rps),
            "per_device": round(group_rps / s),
            "efficiency": round(group_rps / (base_group * s), 3),
            "wall_ms": round(t_group * 1e3, 3),
            "collectives": collective_model(cs_group),
        }
        report["combine_group"][s] = {
            "rows_per_s": round(combine_rps),
            "per_device": round(combine_rps / s),
            "efficiency": round(combine_rps / (base_combine * s), 3),
            "wall_ms": round(t_combine * 1e3, 3),
            "collectives": collective_model(cs_combine),
        }

    if xcheck is not None:
        # Measured-vs-modeled wire bytes (VERDICT r4 #8): the pure
        # all_to_all ratio validates note_collective's analytic counts
        # (≈1.5× = gloo framing/algorithm, absent on NVLink); the
        # full-pipeline ratio additionally carries the loopback-emulated
        # replicated result fetch, which on GPUs stays on device.
        report["collective_xcheck"] = xcheck
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
