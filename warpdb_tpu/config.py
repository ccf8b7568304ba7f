"""Engine configuration.

The reference's config surface was three ad-hoc mechanisms (SURVEY.md §5:
CLI positionals, CMake defines, the ``custom.cu`` CWD convention).  Here
a single dataclass, overridable per-instance and from environment
variables (``WARPDB_``-prefixed).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

__all__ = ["EngineConfig", "get_config", "set_config", "configure_compilation_cache"]


@dataclasses.dataclass
class EngineConfig:
    # Padding multiple for device columns (lane alignment).
    pad_multiple: int = 1024
    # Rows per chunk for streaming execution when the caller passes no
    # explicit value (reference default 1e6, warpdb.hpp:35).
    rows_per_chunk: int = 1_000_000
    # The GROUP BY tier crossovers below are untuned on the current
    # device (ROADMAP Design 4): their values were set on earlier
    # hardware and wait for the benchmark to re-derive them.
    # Dense GROUP BY fast path: up to this many key-range slots the
    # whole slot table ships to the host in one dispatch; wider ranges
    # take the mid-range tier, which compacts occupied slots on device.
    dense_group_max_slots: int = 4096
    # Mid-range sort-free GROUP BY (scatter/one-hot matmul into a dense
    # slot table): scatter cost is per-UPDATE (row), not per-slot, so
    # the slot count only pays the occupancy-compaction sort — up to
    # ``base_slots`` the slot table runs regardless of input size.
    # Beyond that the compaction sort starts to matter, so the slot
    # table runs only when the input has at least as many rows as
    # slots.  ``max_slots`` is the hard cap either way.
    midrange_group_base_slots: int = 1 << 20
    midrange_group_max_slots: int = 1 << 23
    # SUM/COUNT-only mid-range queries ride the one-hot matmul up to
    # this many slots (FLOPs grow linearly with the slot count).
    mxu_group_max_slots: int = 1 << 16
    # Single-key joins whose build side has at most this many rows use
    # the sort-free dense phase 1 (virtual (N, K) compare sweep instead of
    # two full-width probe∪build sorts).
    join_dense_build_max: int = 256
    # Comm/compute overlap in the distributed row shuffle: split the
    # all-to-all into two half-bucket exchanges and aggregate the first
    # half while the second is in flight (DESIGN.md §6).
    shuffle_overlap: bool = False
    # Materialized-join LRU per probe table (device tables are
    # immutable, so a (build table, condition, columns) join result
    # never goes stale).  0 disables.
    join_cache_entries: int = 4
    # Eager aggregation: rewrite GROUP BY-over-join queries whose
    # aggregates factor across the join into a pre-aggregated build side
    # + 1:1 lookup join (classic aggregate pushdown).
    eager_join_aggregation: bool = True
    # Predicate pushdown below joins: compact the probe table to the
    # WHERE-matching rows before materialising INNER/LEFT/CROSS joins
    # when every WHERE column is a probe column (selectivity < 50%).
    join_filter_pushdown: bool = True
    # Device-side grouped finish: HAVING + ORDER BY <aggregate> + LIMIT
    # prune/order/slice the group table on device (O(limit) transfer
    # instead of O(groups)).
    grouped_device_finish: bool = True
    # Distributed GROUP BY: key-count threshold between the all_gather
    # partial merge and the all-to-all shuffle.
    distributed_small_keys: int = 4096
    # Float64 load policy ("strict" | "downcast").  The device compute
    # path is f32 (JAX x64 disabled); a FLOAT64 column whose values all
    # round-trip through f32 uploads losslessly either way.  For values
    # that do NOT round-trip, "strict" refuses loudly at load (the
    # int64 "widen or refuse" rule applied to floats — VERDICT r4 #4;
    # the reference carries Float64 as native double, jit.cpp:31-45)
    # while "downcast" accepts the documented ≤2^-24 relative rounding.
    f64_policy: str = "strict"
    # UDF module discovered in the working directory (custom.cu analogue).
    udf_module: str = "custom.py"

    @classmethod
    def from_env(cls) -> "EngineConfig":
        cfg = cls()
        for field in dataclasses.fields(cls):
            env = os.environ.get(f"WARPDB_{field.name.upper()}")
            if env is None:
                continue
            # With `from __future__ import annotations`, field.type is
            # the annotation STRING — dispatch by name, not identity.
            tname = (
                field.type if isinstance(field.type, str)
                else getattr(field.type, "__name__", "str")
            )
            if tname == "int":
                setattr(cfg, field.name, int(env))
            elif tname == "float":
                setattr(cfg, field.name, float(env))
            elif tname == "bool":
                setattr(cfg, field.name, env.lower() in ("1", "true", "yes"))
            else:
                setattr(cfg, field.name, env)
        return cfg


_config: Optional[EngineConfig] = None


def get_config() -> EngineConfig:
    global _config
    if _config is None:
        _config = EngineConfig.from_env()
    return _config


def set_config(cfg: EngineConfig) -> None:
    global _config
    _config = cfg


CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def configure_compilation_cache() -> str:
    """Persist XLA executables across processes — the durable analogue of
    the reference's missing kernel cache (its biggest perf flaw was
    NVRTC recompile per call, jit.cpp:98-157; ours caches in-process by
    plan and, with this, on disk across restarts).

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    this leaves the directory alone; otherwise the cache lives in the
    checkout's ``.jax_cache``.  The path is fixed (part of the cache
    key), never built from a temporary name, process id or time.
    Every entry point calls this; importing the library does not.
    Returns the directory in use."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = CHECKOUT_CACHE_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path
