"""Empirical cross-check of the analytic collective cost model
(VERDICT r4 #8).

``utils.metrics.note_collective`` records, per distributed kernel
launch, the ANALYTIC per-device byte volume of each collective (static
shapes make it exact at the model's level of abstraction).  DESIGN.md §6
extrapolates interconnect walls from those numbers — this script puts real wire
bytes next to them: it runs the 2-process loopback ``jax.distributed``
path (2 procs × 2 virtual CPU devices) and measures the loopback
interface's RX byte counter across K repetitions of the distributed
shuffle GROUP BY, idle-baseline-subtracted.

What to expect (and why deviations are fine to see):
* the MODEL counts each device's full exchange buffer (including the
  slice it keeps for itself); the WIRE only sees slices that cross the
  process boundary — on 2×2 devices that is 1/2 of the slices;
* gloo (the CPU backend's cross-process transport) adds framing and may
  use multi-hop algorithms for all_gather/psum;
* gRPC heartbeats ride the same interface (subtracted via the idle
  baseline).

Usage:  python scripts/collective_xcheck.py [--rows 1048576 --reps 10]
Prints one JSON line: modeled bytes (total and cross-process), measured
wire bytes per rep, and their ratio.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _lo_rx_bytes() -> int:
    try:
        with open("/sys/class/net/lo/statistics/rx_bytes") as f:
            return int(f.read().strip())
    except OSError:
        with open("/proc/net/dev") as f:
            for line in f:
                if line.strip().startswith("lo:"):
                    return int(line.split()[1])
    raise RuntimeError("no loopback byte counter available")


def worker(proc_id: int, nprocs: int, port: str, rows: int, reps: int) -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 2)
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=nprocs,
        process_id=proc_id,
    )
    import numpy as np

    from warpdb_tpu.frontend import parse_expression_text
    from warpdb_tpu.parallel import multihost
    from warpdb_tpu.parallel.shuffle import shuffle_grouped
    from warpdb_tpu.storage import HostTable
    from warpdb_tpu.utils.metrics import last, timed_query

    mesh = multihost.global_mesh()
    rng = np.random.default_rng(0)
    price = rng.uniform(0, 100, rows).astype(np.float32)
    k = (rng.integers(0, 1 << 14, rows)).astype(np.float32)
    start, end = multihost.host_shard_range(rows)
    local = HostTable.from_dict(
        {"price": price[start:end], "k": k[start:end]}
    )
    table = multihost.make_global_table(local, rows, mesh)
    keys = [parse_expression_text("k")]
    vals = [parse_expression_text("price")]

    def run():
        out = shuffle_grouped(keys, vals, None, table, mesh=mesh)
        jax.block_until_ready(out.counts)

    # Warm: compile + memo fill, and capture the modeled collectives.
    with timed_query("xcheck", "sharded", rows, 0):
        run()
    m = last()
    modeled = list(m.collectives) if m is not None else []

    # Pure-collective calibration: ONE bare all_to_all of exactly known
    # per-device volume, so transport overhead (gloo algorithm + gRPC
    # framing) separates from the pipeline's other wire costs (the
    # replicated result fetch, which on GPUs stays on device).
    import jax.numpy as jnp
    from jax import lax, shard_map
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    n_dev = int(mesh.devices.size)
    m_elems = 1 << 18  # per-device elements → 1 MiB per-device send
    axis = mesh.axis_names[0]
    x = jax.device_put(
        jnp.zeros((n_dev * m_elems,), jnp.float32),
        NamedSharding(mesh, P(axis)),
    )

    @jax.jit
    def pure_a2a(x):
        def body(xl):
            y = lax.all_to_all(
                xl.reshape(n_dev, m_elems // n_dev), axis, 0, 0,
                tiled=False,
            )
            return jnp.sum(y, keepdims=True).reshape(1)

        return shard_map(
            body, mesh=mesh, in_specs=P(axis), out_specs=P(axis),
            check_vma=False,
        )(x)

    jax.block_until_ready(pure_a2a(x))  # compile
    multihost_sync = None  # set below after import

    # Idle baseline: gRPC heartbeat traffic over the same wall we will
    # measure (estimated from one timed run).
    t0 = time.perf_counter()
    run()
    per_rep_wall = time.perf_counter() - t0

    sync = getattr(jax.experimental, "multihost_utils", None)
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices("xcheck_idle_start")
    idle0 = _lo_rx_bytes()
    time.sleep(max(per_rep_wall * reps, 0.5))
    idle1 = _lo_rx_bytes()
    idle_per_s = (idle1 - idle0) / max(per_rep_wall * reps, 0.5)

    multihost_utils.sync_global_devices("xcheck_pure_start")
    p0 = _lo_rx_bytes()
    tp0 = time.perf_counter()
    for _ in range(reps):
        jax.block_until_ready(pure_a2a(x))
    pure_wall = time.perf_counter() - tp0
    multihost_utils.sync_global_devices("xcheck_pure_end")
    p1 = _lo_rx_bytes()

    multihost_utils.sync_global_devices("xcheck_run_start")
    b0 = _lo_rx_bytes()
    t0 = time.perf_counter()
    for _ in range(reps):
        run()
    wall = time.perf_counter() - t0
    multihost_utils.sync_global_devices("xcheck_run_end")
    b1 = _lo_rx_bytes()

    if proc_id == 0:
        local_dev = 2
        remote_frac = (n_dev - local_dev) / n_dev
        modeled_dev = sum(b for _op, b in modeled)
        pure_model_cross = int(
            m_elems * 4 * n_dev * remote_frac
        )  # each device sends its m_elems·4B row-block; half cross lo
        pure_measured = int(
            max((p1 - p0) - idle_per_s * pure_wall, 0) / reps
        )
        out = {
            "pure_a2a_model_cross_bytes": pure_model_cross,
            "pure_a2a_measured_bytes_per_rep": pure_measured,
            "pure_a2a_wire_vs_model": round(
                pure_measured / max(pure_model_cross, 1), 3
            ),
            "rows": rows,
            "reps": reps,
            "devices": int(n_dev),
            "modeled_per_device_bytes": modeled_dev,
            "modeled_collectives": [[op, b] for op, b in modeled],
            # All devices send; only the remote slice fraction hits lo.
            "modeled_cross_process_bytes": int(
                modeled_dev * n_dev * remote_frac
            ),
            "measured_wire_bytes_per_rep": int(
                max((b1 - b0) - idle_per_s * wall, 0) / reps
            ),
            "idle_bytes_per_s": int(idle_per_s),
        }
        out["wire_vs_model"] = round(
            out["measured_wire_bytes_per_rep"]
            / max(out["modeled_cross_process_bytes"], 1),
            3,
        )
        print("XCHECK " + json.dumps(out), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--worker", type=int, default=-1)
    ap.add_argument("--port", type=str, default="")
    args = ap.parse_args()
    if args.worker >= 0:
        return worker(args.worker, 2, args.port, args.rows, args.reps)

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             "--worker", str(i), "--port", str(port),
             "--rows", str(args.rows), "--reps", str(args.reps)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env, cwd=ROOT,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=600)
        outs.append(out)
    rc = 0
    for i, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            print(f"proc {i} failed:\n{out[-3000:]}")
            rc = 1
    for out in outs:
        for line in out.splitlines():
            if line.startswith("XCHECK "):
                print(line[len("XCHECK "):])
    return rc


if __name__ == "__main__":
    sys.exit(main())
