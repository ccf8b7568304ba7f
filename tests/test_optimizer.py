"""Optimizer tests: constant folding, interval analysis, filter pruning —
the reference's intended-but-stubbed behaviors (optimizer.cpp:13-47)
made real and verified."""

import pathlib

import numpy as np
import pytest

from warpdb_tpu import WarpDB
from warpdb_tpu.engine.optimizer import (
    analyze_condition,
    expr_range,
    fold_constants,
)
from warpdb_tpu.frontend import parse_expression_text
from warpdb_tpu.storage.table import ColumnStats


STATS = {
    "price": ColumnStats(min=10.5, max=30.0),
    "quantity": ColumnStats(min=2.0, max=5.0),
}


def test_fold_constants():
    ast = fold_constants(parse_expression_text("price * (2 + 3)"))
    assert ast.canonical() == "(price[idx] * 5.0f)"
    ast2 = fold_constants(parse_expression_text("2 * 3 + 1"))
    assert ast2.canonical() == "7.0f"


def test_fold_preserves_division_by_zero():
    ast = fold_constants(parse_expression_text("1 / 0"))
    assert ast.canonical() == "(1.0f / 0.0f)"  # left for runtime inf


def test_expr_range():
    rng = expr_range(parse_expression_text("price + quantity"), STATS)
    assert rng == (12.5, 35.0)
    rng = expr_range(parse_expression_text("price * 2"), STATS)
    assert rng == (21.0, 60.0)
    assert expr_range(parse_expression_text("discount(price, 0.9)"), STATS) is None


@pytest.mark.parametrize(
    "cond,verdict",
    [
        ("price > 5", True),          # min 10.5 > 5
        ("price > 100", False),       # max 30 < 100
        ("price > 15", None),
        ("price >= 10.5", True),
        ("price < 30", None),
        ("price < 50", True),
        ("quantity <= 1", False),
        ("price > 5 AND quantity < 10", True),
        ("price > 5 AND quantity < 1", False),
        ("price > 100 OR quantity >= 2", True),
        ("price > 100 OR quantity > 100", False),
        ("price > 100 OR quantity > 3", None),
        ("price != 200", True),
    ],
)
def test_analyze_condition(cond, verdict):
    assert analyze_condition(parse_expression_text(cond), STATS) is verdict


def test_always_false_filter_skips_scan():
    db = WarpDB("data/test.csv")
    # price max is 30 → provably empty; no kernel launch needed.
    from warpdb_tpu.engine.compiler import cache_stats

    before = cache_stats()["misses"]
    res = db.query("price * quantity WHERE price > 1000")
    after = cache_stats()["misses"]
    assert res == [0.0, 0.0, 0.0, 0.0]
    assert after == before  # no new kernel compiled

    sql = db.query_sql("SELECT price FROM test WHERE price > 1000")
    assert sql == []


def test_always_true_filter_dropped():
    db = WarpDB("data/test.csv")
    res = db.query("price WHERE price >= 0")
    assert res == pytest.approx([10.5, 20.0, 15.25, 30.0])
    # Equivalent unconditional query shares the same cached kernel.
    from warpdb_tpu.engine.compiler import cache_stats

    before = cache_stats()
    res2 = db.query("price")
    after = cache_stats()
    assert res2 == res
    assert after["misses"] == before["misses"]


def test_unknown_verdict_still_filters():
    db = WarpDB("data/test.csv")
    res = db.query("price WHERE price > 15")
    assert res == pytest.approx([0.0, 20.0, 15.25, 30.0])


# --- EXPLAIN (plan introspection; observability beyond the reference) ---------


def test_explain_sql_dense_group(data_dir):
    from warpdb_tpu import WarpDB

    db = WarpDB(str(data_dir / "test.csv"))
    plan = db.explain(
        "SELECT SUM(price), COUNT(*) FROM test WHERE price > 5 "
        "GROUP BY quantity ORDER BY SUM(price) DESC LIMIT 3"
    )
    assert "always true -> dropped" in plan
    assert "DENSE integer-key aggregation" in plan
    assert "COUNT(*)" in plan and "SUM(price[idx])" in plan
    assert "host lexsort over groups" in plan


def test_explain_topk_and_expression(data_dir):
    from warpdb_tpu import WarpDB

    db = WarpDB(str(data_dir / "test.csv"))
    plan = db.explain("SELECT price FROM test ORDER BY price DESC LIMIT 5")
    assert "two-stage top-k" in plan
    plan2 = db.explain("price WHERE price > 1000")
    assert "always false -> scan skipped" in plan2
    plan3 = db.explain("price * quantity WHERE price > 15")
    assert "fused into kernel" in plan3


def test_explain_does_not_execute(data_dir):
    from warpdb_tpu import WarpDB
    from warpdb_tpu.engine.compiler import cache_stats

    db = WarpDB(str(data_dir / "test.csv"))
    before = cache_stats()["misses"]
    db.explain("SELECT SUM(price) FROM test GROUP BY quantity")
    assert cache_stats()["misses"] == before  # no kernel was built


@pytest.mark.parametrize("env_set", [True, False])
def test_persistent_compilation_cache_config(tmp_path, monkeypatch, env_set):
    # JAX's persistent executable cache (the durable analogue of the
    # kernel cache; the reference recompiled everything per call):
    # JAX_COMPILATION_CACHE_DIR wins untouched when set, otherwise the
    # checkout's .jax_cache.
    import jax

    from warpdb_tpu.config import configure_compilation_cache

    before = jax.config.jax_compilation_cache_dir
    min_secs = jax.config.jax_persistent_cache_min_compile_time_secs
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = configure_compilation_cache()
        if env_set:
            assert path == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir == before
        else:
            repo = pathlib.Path(__file__).resolve().parent.parent
            assert path == str(repo / ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
        jax.config.update(
            "jax_persistent_cache_min_compile_time_secs", min_secs
        )


def test_env_overrides_int_field(monkeypatch):
    import warpdb_tpu.config as cfg

    monkeypatch.setenv("WARPDB_DENSE_GROUP_MAX_SLOTS", "123")
    monkeypatch.setenv("WARPDB_UDF_MODULE", "my_udfs.py")
    cfg.set_config(None)
    try:
        c = cfg.get_config()
        assert c.dense_group_max_slots == 123
        assert c.udf_module == "my_udfs.py"
    finally:
        monkeypatch.delenv("WARPDB_DENSE_GROUP_MAX_SLOTS")
        monkeypatch.delenv("WARPDB_UDF_MODULE")
        cfg.set_config(None)
        cfg.get_config()


def test_config_pad_and_chunk_defaults_honored(monkeypatch):
    import warpdb_tpu.config as cfg
    from warpdb_tpu.storage import DeviceTable, HostTable

    monkeypatch.setenv("WARPDB_PAD_MULTIPLE", "2048")
    cfg.set_config(None)
    try:
        dt = DeviceTable.from_host(
            HostTable.from_dict({"v": np.arange(10, dtype=np.float32)})
        )
        assert dt.padded_rows % 2048 == 0
    finally:
        monkeypatch.delenv("WARPDB_PAD_MULTIPLE")
        cfg.set_config(None)
        cfg.get_config()


def test_explain_analyze():
    import numpy as np

    from warpdb_tpu import WarpDB
    from warpdb_tpu.storage import HostTable

    rng = np.random.default_rng(3)
    db = WarpDB(
        HostTable.from_dict(
            {
                "price": rng.uniform(0, 100, 2000).astype(np.float32),
                "quantity": rng.integers(0, 8, 2000).astype(np.float32),
            }
        )
    )
    out = db.explain(
        "SELECT SUM(price) FROM t GROUP BY quantity ORDER BY quantity ASC",
        analyze=True,
    )
    assert "Execution (measured):" in out
    assert "wall:" in out and "operators:" in out
    # Expression form too.
    out2 = db.explain("price * quantity WHERE price > 50", analyze=True)
    assert "Execution (measured):" in out2
