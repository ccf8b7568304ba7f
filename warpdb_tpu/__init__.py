"""warpdb_tpu — a vectorized SQL query-execution engine on JAX/XLA.

A from-scratch JAX/XLA/Pallas re-design of the capability set of
seanwevans/WarpDB (a CUDA NVRTC-JIT query engine):

* SQL-ish frontend (tokenizer / expression parser / SQL parser / AST);
* expression compiler that traces ASTs into fused XLA kernels, with a
  plan-keyed jit cache (replacing per-call NVRTC recompilation);
* vectorized relational operators — fused filter+projection,
  order-preserving compaction, hash/sort aggregation (GROUP BY / HAVING /
  DISTINCT), sort + top-k (ORDER BY / LIMIT / OFFSET), hash equi-join;
* sharded execution over a ``jax.sharding.Mesh`` with XLA collectives,
  plus chunked out-of-core streaming;
* columnar storage with CSV/JSON/Parquet/Arrow ingest and Arrow C Data
  Interface result export (optionally in POSIX shared memory).

Public API mirrors the reference facade (warpdb.hpp:11-48)::

    from warpdb_tpu import WarpDB, DataType
    db = WarpDB("data/test.csv")
    db.query("price * quantity WHERE price > 10")   # length-N list[float]
    db.query_sql("SELECT SUM(price) FROM test GROUP BY quantity")
    db.query_sharded("price * quantity")            # multi-device
    WarpDB.query_streaming_csv("big.csv", "price * quantity")
    db.query_arrow("price + 1")                     # Arrow capsules
"""

from .errors import (
    ExecutionError,
    ParseError,
    TokenizeError,
    UnsupportedError,
    ValidationError,
    WarpDBError,
)
from .storage.table import DataType

__version__ = "0.1.0"


def __getattr__(name):
    # Lazy imports keep `import warpdb_tpu.frontend` usable without JAX
    # device initialisation.
    if name == "WarpDB":
        from .api import WarpDB

        return WarpDB
    if name == "register_udf":
        from .engine.udf import register_udf

        return register_udf
    raise AttributeError(f"module 'warpdb_tpu' has no attribute {name!r}")


__all__ = [
    "WarpDB",
    "DataType",
    "register_udf",
    "WarpDBError",
    "TokenizeError",
    "ParseError",
    "ValidationError",
    "ExecutionError",
    "UnsupportedError",
    "__version__",
]
