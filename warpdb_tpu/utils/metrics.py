"""Observability: per-query metrics, logging, and profiler hooks.

The reference's only observability was ``std::cout`` progress prints
(SURVEY.md §5).  Here every query records wall-clock, rows scanned,
bytes scanned and throughput into a bounded in-process history, the
``warpdb_tpu`` logger reports compile/cache events, and
``profile_trace`` wraps ``jax.profiler.trace`` for XLA-level traces
viewable in TensorBoard/Perfetto.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Optional

logger = logging.getLogger("warpdb_tpu")

__all__ = ["QueryMetrics", "record", "history", "last", "timed_query",
           "note_operator", "note_collective", "profile_trace", "logger"]


@dataclass(frozen=True)
class QueryMetrics:
    query: str
    kind: str              # "expression" | "sql" | "sharded" | "streaming"
    wall_s: float
    rows: int
    bytes_scanned: int
    output_rows: int
    # Cached-kernel invocations during this query, in execution order
    # (operator names = first element of each plan-cache key), with
    # compile-vs-cache-hit flags: [(name, was_cache_hit), ...].
    operators: tuple = ()
    # Cross-device collectives this query issued, with ANALYTIC
    # per-device byte counts derived from the kernels' static shapes:
    # [(op, bytes_per_device), ...].  The interconnect cost model
    # (docs/DESIGN.md §6) extrapolates from these.
    collectives: tuple = ()

    @property
    def rows_per_s(self) -> float:
        return self.rows / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def gb_per_s(self) -> float:
        return self.bytes_scanned / self.wall_s / 1e9 if self.wall_s > 0 else 0.0


_lock = threading.Lock()
_history: deque = deque(maxlen=256)


def record(m: QueryMetrics) -> None:
    with _lock:
        _history.append(m)
    logger.debug(
        "query %r: %.3f ms, %.1fM rows/s, %.2f GB/s",
        m.query[:80], m.wall_s * 1e3, m.rows_per_s / 1e6, m.gb_per_s,
    )


def history() -> list:
    with _lock:
        return list(_history)


def last() -> Optional[QueryMetrics]:
    with _lock:
        return _history[-1] if _history else None


# Per-thread operator trace filled by engine.compiler.get_or_compile.
_trace_local = threading.local()


def note_operator(name: str, cache_hit: bool) -> None:
    """Called by the kernel cache on every lookup; recorded per query."""
    ops = getattr(_trace_local, "ops", None)
    if ops is not None:
        ops.append((name, cache_hit))


_transfer_bytes = [0]


def note_transfer(nbytes: int) -> None:
    """Device→host result-transfer byte accounting (process-global,
    monotonic).  Each host↔device sync ships these bytes; the
    window-expression fusion is asserted against this counter: one
    shipped column per select item, not one per window/referenced
    column."""
    _transfer_bytes[0] += int(nbytes)


def transfer_bytes() -> int:
    return _transfer_bytes[0]


def note_collective(op: str, bytes_per_device: int) -> None:
    """Called by the distributed kernels at launch with the analytic
    per-device byte count of each collective (all_to_all / all_gather /
    psum) — static shapes make the count exact without a device sync."""
    cs = getattr(_trace_local, "collectives", None)
    if cs is not None:
        cs.append((op, int(bytes_per_device)))


@contextlib.contextmanager
def timed_query(query: str, kind: str, rows: int, bytes_scanned: int):
    """Context manager recording one query execution (including which
    physical operators ran — the per-operator accounting SURVEY §5 asks
    for, without forcing a device sync per operator)."""
    t0 = time.perf_counter()
    out_rows = [0]
    prev_ops = getattr(_trace_local, "ops", None)
    prev_cs = getattr(_trace_local, "collectives", None)
    _trace_local.ops = []
    _trace_local.collectives = []
    try:
        yield out_rows
    finally:
        ops = tuple(_trace_local.ops)
        cs = tuple(_trace_local.collectives)
        _trace_local.ops = prev_ops
        _trace_local.collectives = prev_cs
        record(
            QueryMetrics(
                query=query,
                kind=kind,
                wall_s=time.perf_counter() - t0,
                rows=rows,
                bytes_scanned=bytes_scanned,
                output_rows=out_rows[0],
                operators=ops,
                collectives=cs,
            )
        )


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """XLA-level profiler trace (view in TensorBoard / Perfetto)."""
    import jax

    with jax.profiler.trace(log_dir):
        yield


# ---------------------------------------------------------------------------
# Roofline accounting (SURVEY.md §5: per-operator bytes/s vs chip peak)
# ---------------------------------------------------------------------------

# Data-sheet peak HBM bandwidth, bytes/s, keyed by the exact
# ``jax.Device.device_kind`` string.  Source: NVIDIA H100 Tensor Core GPU
# data sheet (H100 SXM 3.35 TB/s, H100 PCIe 2.0 TB/s).  A device that is
# not listed has no peak: callers get None, never an assumed default.
PEAK_HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,  # H100 SXM
    "NVIDIA H100 PCIe": 2.0e12,
}


def peak_hbm_bytes_per_s(device_kind: Optional[str] = None) -> Optional[float]:
    """Peak HBM bandwidth of ``device_kind`` (default: the first attached
    device), or None for a device not in :data:`PEAK_HBM_BYTES_PER_S`."""
    if device_kind is None:
        import jax

        device_kind = jax.devices()[0].device_kind
    return PEAK_HBM_BYTES_PER_S.get(device_kind)


def roofline_fraction(m: QueryMetrics) -> Optional[float]:
    """Fraction of the device's peak HBM bandwidth this query achieved,
    or None when the device has no known peak."""
    peak = peak_hbm_bytes_per_s()
    return None if peak is None else m.gb_per_s * 1e9 / peak


def report(last_n: int = 20) -> str:
    """Human-readable recent-query report with roofline fractions."""
    lines = ["query                                    kind        ms    Mrows/s   GB/s  %peak"]
    for m in history()[-last_n:]:
        frac = roofline_fraction(m)
        peak = "  n/a" if frac is None else f"{frac*100:5.1f}"
        lines.append(
            f"{m.query[:40]:<40} {m.kind:<10} {m.wall_s*1e3:6.1f} "
            f"{m.rows_per_s/1e6:9.1f} {m.gb_per_s:6.2f} {peak}"
        )
    return "\n".join(lines)
