"""Tests of the operator paths that once had device-specific Pallas
kernels: the blocked top-k pull, the one-hot matmul GROUP BY tier and
the expansion join — and of the slot-table engines of the dense tiers.
Each is plain JAX now; these pin its results against NumPy."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp


def test_topk_values_pallas_route_matches_xla():
    # The two-stage blocked pull (per-block candidates, then one small
    # top_k) must give exactly numpy's top k.
    from warpdb_tpu.ops.sort import top_k_values

    rng = np.random.default_rng(8)
    n = 1 << 21
    v = rng.uniform(0, 1000, n).astype(np.float32)
    mask = v > 5.0
    got = np.asarray(
        jax.jit(lambda v, m: top_k_values(v, m, 32, False))(
            jnp.asarray(v), jnp.asarray(mask)
        )
    )
    want = np.sort(v[mask])[::-1][:32]
    np.testing.assert_array_equal(got[:32], want)


# --- one-hot matmul GROUP BY tier ---------------------------------------------


@pytest.mark.parametrize("num_slots,n", [(6000, 4096), (40_000, 8192)])
def test_mxu_counts_sums_matches_numpy(num_slots, n):
    from warpdb_tpu.ops.aggregate import _mxu_counts_sums

    rng = np.random.default_rng(33)
    gid = rng.integers(0, num_slots, n).astype(np.int32)
    vals = rng.uniform(0, 100, n).astype(np.float32)
    valid = np.ones(n, bool)
    valid[::17] = False  # masked rows must contribute nothing
    counts, sums = jax.jit(
        lambda g, v, m: _mxu_counts_sums(g, (v,), m, num_slots, ("sum",))
    )(jnp.asarray(gid), jnp.asarray(vals), jnp.asarray(valid))
    want_counts = np.bincount(gid[valid], minlength=num_slots)
    want_sums = np.zeros(num_slots, np.float64)
    np.add.at(want_sums, gid[valid], vals[valid].astype(np.float64))
    np.testing.assert_array_equal(np.asarray(counts), want_counts)
    # f32 products at Precision.HIGHEST, summed in f32 across chunks.
    np.testing.assert_allclose(
        np.asarray(sums[0]), want_sums, rtol=3e-6, atol=1e-3
    )


@pytest.mark.parametrize("need", [("sum",), ("sum", "min", "max")])
def test_dense_group_scratch_stays_small(need):
    """The dense tier never builds an (N, G) row-to-slot matrix (XLA:GPU
    materialises one — 128 GiB at 2^25 rows × 4096 slots): the compiled
    program's scratch stays far below N·G bytes, and the aggregates
    still match NumPy."""
    from warpdb_tpu.ops.aggregate import midrange_group_aggregate

    n, g = 1 << 14, 4096
    rng = np.random.default_rng(2)
    keys = rng.integers(0, g, n).astype(np.float32)
    vals = rng.uniform(-1, 1, n).astype(np.float32)
    mask = rng.uniform(size=n) < 0.9
    fn = jax.jit(
        lambda k, v, m: midrange_group_aggregate(k, (v,), m, 0, g, need=need)
    )
    args = (jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(mask))
    temp = fn.lower(*args).compile().memory_analysis().temp_size_in_bytes
    assert temp < n * g // 64, temp
    got = fn(*args)
    k = keys[mask].astype(np.int64)
    np.testing.assert_array_equal(
        np.asarray(got.counts), np.bincount(k, minlength=g)
    )
    np.testing.assert_allclose(
        np.asarray(got.values[0].sums),
        np.bincount(k, weights=vals[mask], minlength=g), atol=1e-5,
    )
    if "min" in need:
        want = np.full(g, np.inf, np.float32)
        np.minimum.at(want, k, vals[mask])
        np.testing.assert_array_equal(np.asarray(got.values[0].mins), want)


def _np_tables(seg, vals, g):
    keep = seg < g
    s, v = seg[keep], vals[keep]
    mins = np.full(g, np.inf, np.float32)
    maxs = np.full(g, -np.inf, np.float32)
    np.minimum.at(mins, s, v)
    np.maximum.at(maxs, s, v)
    return (np.bincount(s, minlength=g),
            np.bincount(s, weights=v.astype(np.float64), minlength=g),
            mins, maxs)


@pytest.mark.parametrize("num_slots", [5, 128])
def test_sweep_tables_match_numpy(num_slots, monkeypatch):
    """The chunked compare sweep (small dense tiers) gives NumPy's
    counts, sums, mins and maxs over several scan steps and a padded
    last chunk; rows at slot >= num_slots drop."""
    from warpdb_tpu.ops import aggregate

    monkeypatch.setattr(aggregate, "_SWEEP_STEP_ELEMS", 1 << 12)
    rng = np.random.default_rng(6)
    n = 20_000 + 37
    seg = rng.integers(0, num_slots + 2, n).astype(np.int32)
    vals = rng.uniform(-50, 50, n).astype(np.float32)
    counts, (va,) = jax.jit(
        lambda s, v: aggregate._sweep_tables(
            s, (v,), num_slots, ("sum", "min", "max"))
    )(jnp.asarray(seg), jnp.asarray(vals))
    want_c, want_s, want_mn, want_mx = _np_tables(seg, vals, num_slots)
    np.testing.assert_array_equal(np.asarray(counts), want_c)
    # f32 sums of ±50 values: absolute error where a sum cancels.
    np.testing.assert_allclose(np.asarray(va.sums), want_s, rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_array_equal(np.asarray(va.mins), want_mn)
    np.testing.assert_array_equal(np.asarray(va.maxs), want_mx)


def test_sweep_tables_scratch_bounded(monkeypatch):
    """Each scan step compares at most _SWEEP_STEP_ELEMS row×slot pairs,
    so scratch stays far below the whole (N, G) comparison."""
    from warpdb_tpu.ops import aggregate

    monkeypatch.setattr(aggregate, "_SWEEP_STEP_ELEMS", 1 << 12)
    n, g = 1 << 15, 128
    fn = jax.jit(lambda s, v: aggregate._sweep_tables(
        s, (v,), g, ("sum", "min", "max")))
    args = (jnp.zeros((n,), jnp.int32), jnp.zeros((n,), jnp.float32))
    temp = fn.lower(*args).compile().memory_analysis().temp_size_in_bytes
    assert temp < n * g // 8, temp


@pytest.mark.parametrize("agg", ["sum", "avg", "count", "min", "max"])
@pytest.mark.parametrize("num_slots", [16, 1000])
def test_dense_window_aggregate_matches_numpy(agg, num_slots):
    """AGG(v) OVER (PARTITION BY k) from the slot tables (sweep at 16
    slots, scatters at 1000) broadcast back to every row; masked and
    out-of-range rows read 0."""
    from warpdb_tpu.ops.aggregate import dense_window_aggregate

    rng = np.random.default_rng(12)
    n = 6000
    key = rng.integers(3, 3 + num_slots + 2, n).astype(np.float32)
    vals = rng.uniform(-10, 10, n).astype(np.float32)
    mask = rng.uniform(size=n) < 0.8
    got = np.asarray(jax.jit(
        lambda k, v, m: dense_window_aggregate(k, v, m, agg, 3, num_slots)
    )(jnp.asarray(key), jnp.asarray(vals), jnp.asarray(mask)))
    seg = np.where(mask, key.astype(np.int64) - 3, num_slots)
    seg = np.where(seg < num_slots, seg, num_slots)
    c, s, mn, mx = _np_tables(seg, vals, num_slots)
    table = {"sum": s, "avg": s / np.maximum(c, 1), "count": c,
             "min": mn, "max": mx}[agg]
    ok = seg < num_slots
    want = np.where(ok, table[np.minimum(seg, num_slots - 1)], 0.0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("num_slots", [4, 4096])
def test_slot_sums_privatised_accuracy(num_slots):
    """Per-slot sums of 2^20 rows stay within 1e-6 of f64 (one shared
    table adding ~2^18 values per slot in sequence drifts to ~3e-6 on
    the CPU and ~6e-4 with the GPU's atomics); out-of-range slots drop."""
    from warpdb_tpu.ops.aggregate import slot_sums

    rng = np.random.default_rng(4)
    n = 1 << 20
    seg = rng.integers(0, num_slots + 1, n).astype(np.int32)
    vals = rng.uniform(0, 100, n).astype(np.float32)
    keep = seg < num_slots
    want = np.bincount(seg[keep], weights=vals[keep].astype(np.float64),
                       minlength=num_slots)
    got = jax.jit(lambda s, v: slot_sums(s, v, num_slots))(
        jnp.asarray(seg), jnp.asarray(vals)
    )
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-6)


def test_midrange_inf_values_route_to_scatter_engine():
    """±inf values cannot ride the one-hot matmul scaling (0·inf = NaN
    would poison other slots) — the executor's finiteness gate must
    route them to the scatter engine, which folds them exactly."""
    import numpy as np

    from warpdb_tpu import WarpDB
    from warpdb_tpu.storage import HostTable

    rng = np.random.default_rng(5)
    n = 20_000
    k = rng.integers(0, 30_000, n).astype(np.float32)
    v = rng.uniform(0, 10, n).astype(np.float32)
    v[7] = np.inf
    db = WarpDB(HostTable.from_dict({"k": k, "v": v}))
    out = np.asarray(db.query_sql("SELECT SUM(v) FROM t GROUP BY k"))
    uniq = np.sort(np.unique(k))
    inf_slot = int(np.searchsorted(uniq, k[7]))
    assert out[inf_slot] == np.inf
    finite = np.delete(out, inf_slot)
    assert np.isfinite(finite).all()


# --- expansion join ------------------------------------------------------------


def _expansion_db(counts, seed=3):
    """Probe table with f32 specials (NaN, -inf, -0.0) and full-range
    int32 payloads; build table whose key j repeats counts[j] times."""
    from warpdb_tpu import WarpDB
    from warpdb_tpu.storage import HostTable

    rng = np.random.default_rng(seed)
    n_keys = len(counts)
    n = 5000
    k = rng.integers(0, n_keys, n).astype(np.int32)
    vf = rng.normal(0, 1e10, n).astype(np.float32)
    vf[5], vf[7], vf[9] = np.nan, -np.inf, -0.0
    vi = rng.integers(-2**31, 2**31 - 1, n, dtype=np.int64).astype(np.int32)
    bk = np.repeat(np.arange(n_keys, dtype=np.int32), counts)
    w = rng.integers(-2**31, 2**31 - 1, len(bk), dtype=np.int64).astype(
        np.int32
    )
    db = WarpDB(HostTable.from_dict({"k": k, "vf": vf, "vi": vi}))
    db.register_table("d", HostTable.from_dict({"k2": bk, "w": w}))
    return db, (k, vf, vi), (bk, w)


def _expected_expansion(probe, build):
    """Probe order, then each probe row's build duplicates in order."""
    k, vf, vi = probe
    bk, w = build
    owner, dup = [], []
    for i, key in enumerate(k):
        for j in np.flatnonzero(bk == key):
            owner.append(i)
            dup.append(j)
    owner, dup = np.asarray(owner), np.asarray(dup)
    return vf[owner], vi[owner], w[dup]


@pytest.mark.parametrize("fanout", ["variable", "sparse"])
def test_expansion_join_bit_exact_specials(fanout):
    """The general expansion (scatter/cummax ownership fill + stacked
    gathers) reproduces every payload bit: NaN, -inf, -0.0 and
    full-range int32 values, in probe order."""
    from warpdb_tpu.config import get_config

    rng = np.random.default_rng(9)
    if fanout == "variable":
        counts = rng.integers(1, 4, 3000)  # fan-out 1..3
    else:
        counts = rng.integers(0, 3, 3000)  # some probe keys unmatched
    db, probe, build = _expansion_db(counts)
    get_config().eager_join_aggregation = False
    try:
        out = db.query_sql_table("SELECT vf, vi, d.w FROM t JOIN d ON k = d.k2")
    finally:
        get_config().eager_join_aggregation = True
    want_f, want_i, want_w = _expected_expansion(probe, build)
    got_f = np.asarray(out["vf"], np.float32)
    np.testing.assert_array_equal(
        got_f.view(np.uint32), want_f.view(np.uint32)
    )
    np.testing.assert_array_equal(np.asarray(out["vi"], np.int64), want_i)
    np.testing.assert_array_equal(np.asarray(out["d.w"], np.int64), want_w)


@pytest.mark.parametrize("k", [2, 4, 8])
def test_uniform_fanout_join_matches_numpy(k):
    """Every probe key matches exactly k build rows: the expansion must
    equal NumPy's, bit for bit, and COUNT(*) must see k rows per probe
    row."""
    from warpdb_tpu.config import get_config

    db, probe, build = _expansion_db(np.full(3000, k), seed=k)
    get_config().eager_join_aggregation = False
    try:
        out = db.query_sql_table("SELECT vf, vi, d.w FROM t JOIN d ON k = d.k2")
        g = db.query_sql_table(
            "SELECT k, COUNT(*) AS c FROM t JOIN d ON k = d.k2 "
            "GROUP BY k ORDER BY k ASC LIMIT 3"
        )
    finally:
        get_config().eager_join_aggregation = True
    want_f, want_i, want_w = _expected_expansion(probe, build)
    assert len(out["vf"]) == k * len(probe[0])
    np.testing.assert_array_equal(
        np.asarray(out["vf"], np.float32).view(np.uint32),
        want_f.view(np.uint32),
    )
    np.testing.assert_array_equal(np.asarray(out["vi"], np.int64), want_i)
    np.testing.assert_array_equal(np.asarray(out["d.w"], np.int64), want_w)
    keys, cnt = np.unique(probe[0], return_counts=True)
    np.testing.assert_array_equal(np.asarray(g["k"]), keys[:3])
    np.testing.assert_array_equal(np.asarray(g["c"]), cnt[:3] * k)


def test_expansion_join_matches_oracle_with_duplicate_build_keys():
    """The expansion join (duplicate build keys force the sort-merge
    expansion; the eager rewrite is disabled) must match a NumPy
    oracle."""
    import numpy as np

    from warpdb_tpu import WarpDB
    from warpdb_tpu.config import get_config
    from warpdb_tpu.storage import HostTable

    rng = np.random.default_rng(11)
    n = 8192
    k = rng.integers(0, 2048, n).astype(np.float32)
    v = rng.uniform(0, 100, n).astype(np.float32)
    w = rng.uniform(0, 1, 4096).astype(np.float32)
    wk = np.tile(np.arange(2048, dtype=np.float32), 2)
    db = WarpDB(HostTable.from_dict({"k": k, "v": v}))
    db.register_table("d", HostTable.from_dict({"k2": wk, "w": w}))
    get_config().eager_join_aggregation = False
    try:
        out = db.query_sql_table(
            "SELECT k, SUM(v * d.w) AS s FROM t JOIN d ON k = d.k2 "
            "GROUP BY k ORDER BY k ASC LIMIT 5"
        )
    finally:
        get_config().eager_join_aggregation = True
    # Oracle: per-key sum of v times BOTH matching dim weights.
    wsum = np.zeros(2048, np.float64)
    np.add.at(wsum, wk.astype(int), w.astype(np.float64))
    vsum = np.zeros(2048, np.float64)
    np.add.at(vsum, k.astype(int), v.astype(np.float64))
    want = vsum * wsum  # SUM over pairs factorises for this expression
    keys = np.sort(np.unique(k.astype(int)))[:5]
    np.testing.assert_allclose(out["k"], keys.astype(np.float32))
    np.testing.assert_allclose(
        out["s"], want[keys], rtol=2e-3,
    )
