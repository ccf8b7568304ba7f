"""Times the plain XLA versions of the operators that once had
device-specific kernels, the slot-table engines of the dense GROUP BY
tier and the dimension-table join and IN-set sites, at the shapes
``chip_smoke.py`` runs them, and reports each as a share of the
device's data-sheet HBM peak
(``warpdb_tpu.utils.metrics.PEAK_HBM_BYTES_PER_S``).

    python benchmarks/kernel_probe.py            # on a GPU
    python benchmarks/kernel_probe.py --rehearse # tiny CPU rehearsal

Each probe prints its compiled ``memory_analysis()``, the median wall
time of ``--iters`` blocking calls after one warm-up, the bytes the
operation must move (formula beside it) and that over the time as a
share of the peak.  A large elementwise copy is measured first as the
achievable-bandwidth reference.  The expansion probe also times the
whole join through ``query_sql_table``.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _time(fn, args, iters):
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def probe(name, fn, args, nbytes, formula, peak, iters):
    import jax

    jf = jax.jit(fn)
    try:
        mem = jf.lower(*args).compile().memory_analysis()
        temp = getattr(mem, "temp_size_in_bytes", None)
        dt = _time(jf, args, iters)
    except jax.errors.JaxRuntimeError as e:
        print(f"{name}: FAILED {str(e).splitlines()[0][:200]}", flush=True)
        return None
    share = f"{nbytes / dt / peak * 100:.2f}%" if peak else "n/a"
    print(
        f"{name}: {dt * 1e3:.3f} ms median of {iters}, {nbytes} B "
        f"({formula}) = {nbytes / dt / 1e9:.1f} GB/s, {share} of peak; "
        f"temp {temp} B",
        flush=True,
    )
    return dt


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rehearse", action="store_true")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)

    import jax

    if args.rehearse:
        jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, ROOT)
    import jax.numpy as jnp
    from jax import lax

    from warpdb_tpu.config import configure_compilation_cache, get_config
    from warpdb_tpu.engine.compiler import build_evaluator
    from warpdb_tpu.frontend.ast import InValueSet, Variable
    from warpdb_tpu.ops.aggregate import (
        _mxu_counts_sums,
        _scatter_tables,
        _sweep_tables,
        dense_window_aggregate,
        group_aggregate,
        midrange_group_aggregate,
    )
    from warpdb_tpu.ops.join import (
        join_gather_indices,
        join_match_counts,
        join_match_counts_dense,
        stacked_take,
    )
    from warpdb_tpu.ops.sort import top_k_values
    from warpdb_tpu.utils.metrics import peak_hbm_bytes_per_s

    configure_compilation_cache()
    dev = jax.devices()[0]
    peak = peak_hbm_bytes_per_s(dev.device_kind)
    if peak is None and not args.rehearse:
        raise SystemExit(f"no HBM peak for device kind {dev.device_kind!r}")
    print(f"device_kind: {dev.device_kind}; peak {peak} B/s", flush=True)
    it = args.iters
    n25 = 1 << (25 if not args.rehearse else 14)
    n24 = n25 // 2
    rng = np.random.default_rng(0)

    x = jnp.asarray(rng.uniform(0, 100, 4 * n25).astype(np.float32))
    probe("copy_x2", lambda x: x * 2.0, (x,), 8 * x.size,
          "read+write 4 B/elem", peak, it)
    del x

    price = jnp.asarray(rng.uniform(0, 100, n25).astype(np.float32))
    valid = jnp.ones((n25,), jnp.bool_)
    k = 16
    block = 1 << max(13, min(18, (n25 // 128).bit_length() - 1))
    probe("topk_stage1", lambda u: lax.top_k(u.reshape(-1, block), k)[0],
          (price,), 4 * n25, "read 4 B/row", peak, it)
    probe("topk_values", lambda u, m: top_k_values(u, m, k, False),
          (price, valid), 5 * n25, "read 4 B/row + 1 B mask", peak, it)

    slots = 1 << 16
    keys = jnp.asarray(rng.integers(0, slots, n25).astype(np.float32))
    gid = keys.astype(jnp.int32)
    probe("midrange_mxu",
          lambda g, v, m: _mxu_counts_sums(g, (v,), m, slots, ("sum",)),
          (gid, price, valid), 9 * n25, "read 4 B key + 4 B value + 1 B mask",
          peak, it)
    probe("midrange_scatter",
          lambda kk, v, m: midrange_group_aggregate(
              kk, (v,), m, 0, slots, need=("sum",), use_mxu=False),
          (keys, price, valid), 9 * n25, "read 4 B key + 4 B value + 1 B mask",
          peak, it)
    probe("sort_group_2^16",
          lambda kk, v, m: group_aggregate(kk, (v,), m, slots),
          (keys, price, valid), 9 * n25, "read 4 B key + 4 B value + 1 B mask",
          peak, it)
    # Slot tables (dense GROUP BY / window tiers): the compare sweep
    # against the scatters around the SWEEP_MAX_SLOTS crossover.
    for g in (32, 128, 256, 4096):
        seg = jnp.asarray(rng.integers(0, g, n25).astype(np.int32))
        engines = [("scatter", _scatter_tables)]
        if g <= 256:  # the sweep is O(N·G): ~1 s at 4096 slots
            engines.insert(0, ("sweep", _sweep_tables))
        for name, tables in engines:
            probe(f"{name}_tables_{g}",
                  lambda s, v, t=tables, g=g: t(s, (v,), g, ("sum",)),
                  (seg, price), 8 * n25, "read 4 B slot + 4 B value", peak,
                  it)
    kw = jnp.asarray(rng.integers(0, 4096, n25).astype(np.float32))
    probe("dense_window_avg_4096",
          lambda kk, v, m: dense_window_aggregate(kk, v, m, "avg", 0, 4096),
          (kw, price, valid), 9 * n25,
          "read 4 B key + 4 B value + 1 B mask", peak, it)
    del kw, seg, keys, gid

    # Dimension-table sites at K = 256 build rows: the dense phase 1's
    # (N, K) compare, the build-column gather, the IN-set compare.
    kd = 256
    pk = jnp.asarray(rng.integers(0, 2 * kd, n25).astype(np.float32))
    bk = jnp.asarray(rng.permutation(2 * kd)[:kd].astype(np.float32))
    probe("join_dense_phase1_256",
          lambda p, m, b: join_match_counts_dense(
              p, m, b, jnp.ones(b.shape, jnp.bool_), kd),
          (pk, valid, bk), 13 * n25,
          "read 4 B key + 1 B mask, write 4 B lo + 4 B count", peak, it)
    slot = jnp.asarray(rng.integers(0, kd, n25).astype(np.int32))
    bcols = (jnp.asarray(rng.uniform(0, 1, kd).astype(np.float32)),
             jnp.asarray(rng.integers(0, 1 << 30, kd).astype(np.int32)))
    probe("build_gather_256", lambda s, m, c: stacked_take(c, s, m),
          (slot, valid, bcols), 13 * n25,
          "read 4 B slot + 1 B mask, write 2 x 4 B", peak, it)
    for kin in (256, 4096):
        vals = rng.uniform(0, 100, kin).astype(np.float32)
        in_fn = build_evaluator(InValueSet(Variable("x"), tuple(vals)))
        probe(f"in_values_{kin}", lambda x, f=in_fn: f({"x": x}), (pk,),
              5 * n25, "read 4 B, write 1 B", peak, it)
    del pk, slot

    # Expansion: probe 2^24 rows, key 0..2^16, builds of fan-out 2 and 4.
    pk = jnp.asarray(rng.integers(0, slots, n24).astype(np.float32))
    pmask = jnp.ones((n24,), jnp.bool_)
    pay = price[:n24]
    for fan in (2, 4):
        bk = jnp.asarray(np.repeat(np.arange(slots, dtype=np.float32), fan))
        p1 = jax.jit(join_match_counts)(
            (pk,), pmask, (bk,), jnp.ones(bk.shape, jnp.bool_))
        cap = 1 << int(np.ceil(np.log2(int(p1.total))))
        nb = 8 * n24 + 8 * cap
        formula = "read 4 B payload + 4 B lo per probe row, write 4 B " \
                  "payload + 4 B slot per output row"

        def general(p1, pay, cap=cap):
            pidx, slot, ok = join_gather_indices(p1, cap, return_slot=True)
            t = jnp.take(pay, pidx.reshape(-1, 1024)).reshape(-1)
            return jnp.where(ok, t, 0.0), slot

        probe(f"expand_general_fanout{fan}", general, (p1, pay), nb, formula,
              peak, it)

    # The same joins end to end (eager aggregation and the join memo off).
    from warpdb_tpu import WarpDB
    from warpdb_tpu.storage import HostTable

    host = {"k": np.asarray(pk), "price": np.asarray(pay)}
    db = WarpDB(HostTable.from_dict(host))
    for fan in (2, 4):
        w = rng.uniform(0, 1, slots * fan).astype(np.float32)
        db.register_table(f"d{fan}", HostTable.from_dict({
            "k2": np.repeat(np.arange(slots, dtype=np.float32), fan),
            "w": w}))
    cfg = get_config()
    cfg.eager_join_aggregation, cfg.join_cache_entries = False, 0
    for fan in (2, 4):
        sql = (f"SELECT COUNT(*) AS c, SUM(price * d{fan}.w) AS s FROM t "
               f"JOIN d{fan} ON k = d{fan}.k2")
        db.query_sql_table(sql)
        ts = []
        for _ in range(max(it // 4, 3)):
            t0 = time.perf_counter()
            db.query_sql_table(sql)
            ts.append(time.perf_counter() - t0)
        print(f"join_sql_fanout{fan}: {statistics.median(ts) * 1e3:.3f} ms "
              "median e2e", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
