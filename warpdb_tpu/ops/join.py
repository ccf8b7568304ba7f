"""Inner equi-join.

The reference *parses* multi-join syntax (expression.cpp:375-401) but
never executes a join ("loads the same table for demonstration",
warpdb.hpp:22-23).  This operator makes JOIN real, with static shapes.

Design — sort-merge join with a two-phase static-shape protocol
(SURVEY.md §7 "hard parts": dynamic result shapes on XLA):

* phase 1 (``join_match_counts``): sort the build side once; each probe
  key's duplicate range [lo, hi) comes from two merged probe∪build
  sorts with tie-break flags (binary search per needle is NOT used —
  XLA lowers searchsorted to a log(n) loop of serial-ish gathers);
* the host picks an output capacity bucket (next power of two ≥ total —
  so at most log₂ distinct compilations);
* phase 2 (``join_gather_indices``): each output slot r finds its probe
  row by binary-searching the match-offset prefix sum, then its j-th
  duplicate inside the build range.  Emits (probe_idx, build_idx) pairs
  in probe-row order — deterministic, no atomics.

Row-major gather of the payload columns happens in the caller so columns
are only materialised once per output table.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from .sort import float_sort_key, sort_key_any

__all__ = [
    "join_match_counts", "join_match_counts_dense", "join_gather_indices",
    "stacked_take", "JoinPhase1",
]

_U32_MAX = jnp.uint32(0xFFFFFFFF)


class JoinPhase1(NamedTuple):
    build_order: jax.Array   # i32[n_build] — original index of sorted build rows
    build_sorted: jax.Array  # u32[n_build] — sorted build sort-keys
    lo: jax.Array            # i32[n_probe] — first matching build slot per probe row
    counts: jax.Array        # i32[n_probe] — matches per probe row
    total: jax.Array         # i32 scalar — total matched pairs


def _composite_ids(probe_keys, probe_mask, build_keys, build_mask):
    """Map composite key tuples to dense pair ids (u32) via one shared
    multi-key sort over probe ∪ build — equal tuples get equal ids, so
    the single-key machinery below applies unchanged (the standard trick
    for multi-column equi-joins without 64-bit key packing)."""
    n_p = probe_keys[0].shape[0]
    n_b = build_keys[0].shape[0]
    allk = tuple(
        jnp.concatenate(
            [
                jnp.where(probe_mask, sort_key_any(p), _U32_MAX),
                jnp.where(build_mask, sort_key_any(b), _U32_MAX),
            ]
        )
        for p, b in zip(probe_keys, build_keys)
    )
    idx = jnp.arange(n_p + n_b, dtype=jnp.int32)
    sorted_ops = lax.sort(allk + (idx,), num_keys=len(allk), is_stable=True)
    keys_s = sorted_ops[: len(allk)]
    idx_s = sorted_ops[len(allk)]
    first = jnp.ones(n_p + n_b, jnp.bool_).at[1:].set(False)
    for k in keys_s:
        first = jnp.logical_or(
            first,
            jnp.concatenate([jnp.zeros((1,), jnp.bool_), k[1:] != k[:-1]]),
        )
    pid = (jnp.cumsum(first.astype(jnp.int32)) - 1).astype(jnp.uint32)
    ids = jnp.zeros(n_p + n_b, jnp.uint32).at[idx_s].set(pid)
    return ids[:n_p], ids[n_p:]


def join_match_counts(
    probe_keys,
    probe_mask: jax.Array,
    build_keys,
    build_mask: jax.Array,
) -> JoinPhase1:
    """Phase 1: sort build side, count matches per probe row.

    ``probe_keys``/``build_keys`` may be single f32 arrays or equal-length
    tuples for composite ``ON a = b AND c = d`` conditions."""
    if isinstance(probe_keys, (tuple, list)):
        probe_keys = tuple(probe_keys)
        build_keys = tuple(build_keys)
        if len(probe_keys) == 1:
            pkey_u, bkey_u = (
                sort_key_any(probe_keys[0]),
                sort_key_any(build_keys[0]),
            )
        else:
            pkey_u, bkey_u = _composite_ids(
                probe_keys, probe_mask, build_keys, build_mask
            )
    else:
        pkey_u = sort_key_any(probe_keys)
        bkey_u = sort_key_any(build_keys)

    bkey = jnp.where(build_mask, bkey_u, _U32_MAX)
    n_build = bkey.shape[0]
    order = jnp.arange(n_build, dtype=jnp.int32)
    bkey_s, order_s = lax.sort((bkey, order), num_keys=1, is_stable=True)

    # lo/hi bounds via ONE merged sort rather than searchsorted: XLA
    # lowers searchsorted to a log(n)-iteration loop of 1-per-needle
    # gathers; comparator sorts and scans are the constructs the whole
    # engine is built on.
    #
    # Merge probe ∪ build sorted by (key, probe-after-build tie flag):
    # at a probe position the inclusive build count is its 'right' bound
    # (all equal builds precede it), and the build count at its key
    # segment's first position is the 'left' bound (builds strictly
    # smaller).  A second sort by (is_build, original index) un-merges
    # the per-probe bounds back to probe order — scatter-free.
    n_probe = pkey_u.shape[0]
    keys_all = jnp.concatenate([bkey, pkey_u])
    idx_all = jnp.concatenate(
        [jnp.arange(n_build, dtype=jnp.int32),
         jnp.arange(n_probe, dtype=jnp.int32)]
    )
    is_probe = jnp.concatenate(
        [jnp.zeros(n_build, jnp.int32), jnp.ones(n_probe, jnp.int32)]
    )

    k_s, p_s, i_s = lax.sort(
        (keys_all, is_probe, idx_all), num_keys=2, is_stable=True
    )
    is_build_s = 1 - p_s
    builds_seen = jnp.cumsum(is_build_s)  # inclusive build count
    hi_pos = builds_seen
    seg_first = jnp.ones(k_s.shape, jnp.bool_).at[1:].set(k_s[1:] != k_s[:-1])
    lo_at_start = jnp.where(seg_first, builds_seen - is_build_s, 0)
    lo_pos = lax.cummax(lo_at_start)

    # Un-merge: probes first (ordered by original index), builds last,
    # with one 3-operand sort instead of two int scatter-max passes.
    _, hi_u, lo_u = lax.sort(
        (is_build_s * (n_probe + n_build) + i_s, hi_pos, lo_pos),
        num_keys=1,
        is_stable=True,
    )
    hi = hi_u[:n_probe].astype(jnp.int32)
    lo = lo_u[:n_probe].astype(jnp.int32)
    counts = jnp.where(probe_mask, hi - lo, 0)
    total = jnp.sum(counts)
    return JoinPhase1(order_s, bkey_s, lo, counts, total)


def join_match_counts_dense(
    probe_key,
    probe_mask: jax.Array,
    build_key,
    build_mask: jax.Array,
    k_cap: int,
) -> JoinPhase1:
    """Phase 1 for SMALL build sides (≤ ``k_cap`` valid rows): sort only
    the build side (tiny) and derive each probe row's [lo, hi) from a
    virtual (N, K) comparison against the first K sorted build keys —
    the dense GROUP BY trick applied to joins.

    The general :func:`join_match_counts` pays two full-width probe∪build
    sorts; for a dimension-table join (the star-schema common case) that
    is ~1000× more comparator work than these two K-lane sweeps.
    Comparisons happen in ``float_sort_key`` u32 space, so key-matching
    semantics (including the canonical-NaN-matches-NaN behavior) are
    bit-identical to the sort-merge path.  Caller guarantees
    ``build.num_rows ≤ k_cap`` and a single key column."""
    pkey_u = sort_key_any(probe_key)
    bkey_u = sort_key_any(build_key)
    bkey = jnp.where(build_mask, bkey_u, _U32_MAX)
    n_build = bkey.shape[0]
    order = jnp.arange(n_build, dtype=jnp.int32)
    bkey_s, order_s = lax.sort((bkey, order), num_keys=1, is_stable=True)

    # All valid build rows live in the first k_cap sorted slots (invalid
    # rows carry the U32_MAX sentinel, which float_sort_key never
    # produces for real values — every NaN normalises to the canonical
    # code below it).
    bk = bkey_s[:k_cap]
    lt = jnp.sum(
        (bk[None, :] < pkey_u[:, None]).astype(jnp.int32), axis=1
    )
    eq = jnp.sum(
        (bk[None, :] == pkey_u[:, None]).astype(jnp.int32), axis=1
    )
    counts = jnp.where(probe_mask, eq, 0)
    total = jnp.sum(counts)
    return JoinPhase1(order_s, bkey_s, lt, counts, total)


def stacked_take(cols, idx, valid):
    """Gather the same ``idx`` from C equally-sized columns in ONE take.

    C columns stacked as (C, n) share one index stream.  The index is
    reshaped to a 2-D block so the gather output keeps the row axis
    minor instead of a [len(idx), C] intermediate with a tiny minor dim.
    Falls back to separate 1-D gathers when the index length isn't a
    1024-multiple or the source is tiny.
    Invalid output slots are zeroed."""
    cols = tuple(cols)
    n_idx = idx.shape[0]
    if len(cols) > 1 and n_idx % 1024 == 0 and cols[0].shape[0] >= 4096:
        m = jnp.stack(
            [lax.bitcast_convert_type(c, jnp.uint32) for c in cols], axis=0
        )
        t = jnp.take(m, idx.reshape(-1, 1024), axis=1).reshape(len(cols), n_idx)
        t = jnp.where(valid[None, :], t, jnp.uint32(0))
        return tuple(
            lax.bitcast_convert_type(t[i], c.dtype)
            for i, c in enumerate(cols)
        )
    return tuple(
        jnp.where(valid, c[idx], jnp.zeros((), c.dtype)) for c in cols
    )


def join_gather_indices(
    phase1: JoinPhase1, capacity: int, return_slot: bool = False,
    matched_counts=None, dense_pack: int = 0,
):
    """Phase 2: expand matches into (probe_idx, build_idx) pairs.

    Returns ``(probe_idx[capacity], build_idx[capacity], valid[capacity])``
    ordered by probe row (then build duplicate order) — deterministic.
    With ``return_slot=True`` the second element is the *sorted-build
    slot* instead of the original build index: callers that pre-permute
    their build columns by ``phase1.build_order`` (an n_build-sized
    shuffle, cheap) skip one capacity-sized random gather.

    LEFT OUTER expansion: the caller rewrites ``phase1.counts`` to the
    EMISSION counts (``max(matches, 1)`` per valid probe row) and passes
    the original match counts as ``matched_counts``; a fourth output
    then flags which emitted rows actually matched a build row (the
    rest take the missing-value fill).

    ``dense_pack`` (= K+1 for a dense-phase-1 build of ≤K rows, when
    ``n_probe·(K+1) < 2^32``): per-output metadata (probe row, lo,
    matched count) comes from monotone u32 streams scattered at segment
    starts and forward-filled with ``lax.cummax`` — ZERO capacity-sized
    gathers.  ``row_id·(K+1) + lo`` is strictly increasing across rows
    (the row stride dominates the packed digit), so the running max is
    an exact forward fill and mod/div recover both fields.
    """
    counts = phase1.counts
    offsets = jnp.cumsum(counts) - counts  # exclusive prefix sum

    r = jnp.arange(capacity, dtype=jnp.int32)
    # Probe row owning output slot r: scatter each matching row's id at
    # its start offset, then a running max fills the gaps (offsets are
    # nondecreasing in row id).  Replaces searchsorted, whose lowering
    # loops log(n) gathers per slot; this is one scatter + one scan.
    n_probe = counts.shape[0]
    row_ids = jnp.arange(n_probe, dtype=jnp.int32)
    starts = jnp.where(counts > 0, offsets, capacity)  # non-matching → drop

    def _fill(vals, dtype):
        return lax.cummax(
            jnp.zeros((capacity,), dtype).at[starts].max(vals, mode="drop")
        )

    if dense_pack:
        k2 = jnp.uint32(dense_pack)
        packed = row_ids.astype(jnp.uint32) * k2 + jnp.clip(
            phase1.lo, 0, dense_pack - 1
        ).astype(jnp.uint32)
        seg2 = _fill(packed, jnp.uint32)
        probe_idx = (seg2 // k2).astype(jnp.int32)
        lo_r = (seg2 % k2).astype(jnp.int32)
        # Segment start offsets need no scatter of their own: an output
        # segment starts exactly where probe_idx changes, and its start
        # POSITION equals the emission offset.
        seg_first = jnp.concatenate(
            [
                jnp.ones((1,), jnp.bool_),
                probe_idx[1:] != probe_idx[:-1],
            ]
        )
        off_r = lax.cummax(jnp.where(seg_first, r, 0))
        mc_r = None
        if matched_counts is not None:
            packed_mc = row_ids.astype(jnp.uint32) * k2 + jnp.clip(
                matched_counts, 0, dense_pack - 1
            ).astype(jnp.uint32)
            mc_r = (_fill(packed_mc, jnp.uint32) % k2).astype(jnp.int32)
    else:
        probe_idx = _fill(row_ids, jnp.int32)
        rows = [offsets, phase1.lo]
        if matched_counts is not None:
            rows.append(matched_counts)
        if capacity % 1024 == 0:
            # One stacked 2-D take for all per-probe lookups (offsets,
            # lo, [matched counts]) sharing one index stream; the 2-D
            # index block keeps the row axis minor.
            m = jnp.stack(rows, axis=0)
            t = jnp.take(m, probe_idx.reshape(-1, 1024), axis=1)
            t = t.reshape(len(rows), capacity)
            taken = tuple(t[i] for i in range(len(rows)))
        else:
            taken = tuple(a[probe_idx] for a in rows)
        off_r, lo_r = taken[0], taken[1]
        mc_r = taken[2] if matched_counts is not None else None
    dup_j = r - off_r
    slot = lo_r + dup_j
    n_build = phase1.build_order.shape[0]
    slot = jnp.clip(slot, 0, n_build - 1)
    valid = r < phase1.total
    probe_idx = jnp.where(valid, probe_idx, 0)
    matched = None
    if matched_counts is not None:
        matched = jnp.logical_and(valid, dup_j < mc_r)
    if return_slot:
        out = (probe_idx, jnp.where(valid, slot, 0), valid)
        return out + (matched,) if matched is not None else out
    build_idx = phase1.build_order[slot]
    build_idx = jnp.where(valid, build_idx, 0)
    out = (probe_idx, build_idx, valid)
    return out + (matched,) if matched is not None else out
