"""Bit-packed z-column compaction: dense 3-D masks -> flat index lists.

XLA lowers ``nonzero`` as one scatter per INPUT element (a 512-cube mask is
134M elements), so sparse-set extraction from dense volumetric masks is
formulated hierarchically over bit-packed columns instead:

  1. pack per-z-column mask bits into ceil(Z/32) uint32 words — 32x smaller
     than a bool field, built in one fused streaming pass;
  2. compact ACTIVE columns (any bit set) with one nonzero over XY elements;
  3. extract the first K set bits per active column, LSB-first (lsb = w & -w,
     bit position recovered exactly from the f32 exponent of the power of
     two), touching only (max_cols, nwords) words per round;
  4. assign output slots by exact per-column exclusive-cumsum offsets — the
     LSB-first extraction makes each column's valid mask a PREFIX, so a
     single stamp-scatter + cummax builds the inverse slot->column map with
     no large nonzero.

Candidate order (ascending column id, ascending z) equals the dense
row-major scan order, so consumers get bit-identical results to a dense
``nonzero`` whenever no capacity overflows; overflow is observable as
``n_total - n_captured``.

Used by marching cubes (mesh/mc.py, occupied-cell compaction) and the
non-rigid canonical-volume integrator (volume/fusion.py, active-band
compaction). Replaces the reference's warp-ballot + atomicAdd compactions
(src/kfusion/cuda/marching_cubes.cu:79-141, tsdf_volume.cu FullScan6).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def pack_columns(bits: jnp.ndarray) -> jnp.ndarray:
    """(..., Z) bool -> (..., ceil(Z/32)) uint32, bit z of word w = element
    w*32+z. Padding bits (beyond Z) are zero."""
    Z = bits.shape[-1]
    nwords = (Z + 31) // 32
    pad = [(0, 0)] * (bits.ndim - 1) + [(0, nwords * 32 - Z)]
    b = jnp.pad(bits, pad).reshape(bits.shape[:-1] + (nwords, 32))
    pow2 = jnp.left_shift(jnp.uint32(1), jnp.arange(32, dtype=jnp.uint32))
    return jnp.sum(b.astype(jnp.uint32) * pow2, axis=-1, dtype=jnp.uint32)


def pair_and_z(w: jnp.ndarray) -> jnp.ndarray:
    """bit z := bit z AND bit z+1, with carry across words (for 2-point
    z-stencils: cell occupancy from corner-voxel bits)."""
    nxt = jnp.concatenate([w[..., 1:], jnp.zeros_like(w[..., :1])], axis=-1)
    down = jnp.right_shift(w, jnp.uint32(1)) | jnp.left_shift(
        nxt, jnp.uint32(31))
    return w & down


def dilate_z(w: jnp.ndarray, r: int, z_valid: int) -> jnp.ndarray:
    """Binary dilation by ±r along z on packed words; bits at z >= z_valid
    are kept clear (so padding never turns on)."""
    out = w
    up = down = w
    for _ in range(r):
        nxt = jnp.concatenate([down[..., 1:], jnp.zeros_like(down[..., :1])],
                              axis=-1)
        down = jnp.right_shift(down, jnp.uint32(1)) | jnp.left_shift(
            nxt, jnp.uint32(31))
        prv = jnp.concatenate([jnp.zeros_like(up[..., :1]), up[..., :-1]],
                              axis=-1)
        up = jnp.left_shift(up, jnp.uint32(1)) | jnp.right_shift(
            prv, jnp.uint32(31))
        out = out | up | down
    nwords = w.shape[-1]
    zbit = jnp.arange(nwords * 32, dtype=jnp.int32).reshape(nwords, 32)
    keep_bits = (zbit < z_valid)
    pow2 = jnp.left_shift(jnp.uint32(1), jnp.arange(32, dtype=jnp.uint32))
    keep = jnp.sum(keep_bits.astype(jnp.uint32) * pow2, axis=-1,
                   dtype=jnp.uint32)  # (nwords,)
    return out & keep


def dilate_xy(w3: jnp.ndarray, r: int) -> jnp.ndarray:
    """Binary dilation by ±r along the leading two axes of (X, Y, nw)
    packed columns (separable OR of shifted planes)."""
    def sweep(a, axis):
        out = a
        fwd = bwd = a
        for _ in range(r):
            z = jnp.zeros_like(jax.lax.slice_in_dim(a, 0, 1, axis=axis))
            fwd = jnp.concatenate(
                [jax.lax.slice_in_dim(fwd, 1, fwd.shape[axis], axis=axis), z],
                axis=axis)
            bwd = jnp.concatenate(
                [z, jax.lax.slice_in_dim(bwd, 0, bwd.shape[axis] - 1,
                                         axis=axis)], axis=axis)
            out = out | fwd | bwd
        return out

    return sweep(sweep(w3, 0), 1)


def rank_select(mask: jnp.ndarray, size: int, fill: int) -> jnp.ndarray:
    """First `size` true indices of a 1-D bool mask, ascending, `fill`
    padded — a drop-in for ``jnp.nonzero(mask, size=..., fill_value=...)[0]``
    that avoids XLA's one-scatter-per-INPUT-element lowering for large
    masks. Single-level rank select: pack the mask 32x, per-word
    popcount + exclusive cumsum assigns each active slot its word, and
    prefix-popcount picks the slot's bit — one small stamp-scatter +
    elementwise blocks, no per-round bit extraction (a 32-round unrolled
    variant ran out of compiler memory when nested inside the fusion
    frame)."""
    n = mask.shape[0]
    nwm = (n + 31) // 32
    padded = jnp.pad(mask, (0, nwm * 32 - n))
    aw = pack_columns(padded.reshape(nwm, 32)).reshape(nwm)
    cnt = jax.lax.population_count(aw).astype(jnp.int32)
    off = jnp.cumsum(cnt) - cnt
    stamp = jnp.where(cnt > 0, off, size)
    wids = jnp.arange(nwm, dtype=jnp.int32)
    wstart = jnp.zeros(size, jnp.int32).at[stamp].max(wids + 1, mode="drop")
    word_of = jax.lax.cummax(wstart) - 1
    n_act = off[-1] + cnt[-1]
    slot = jnp.arange(size, dtype=jnp.int32)
    ok_s = (slot < n_act) & (word_of >= 0)
    wsafe = jnp.maximum(word_of, 0)
    rank = slot - off[wsafe]
    w = aw[wsafe]
    bits = jnp.arange(32, dtype=jnp.uint32)
    prefix = jax.lax.population_count(
        w[:, None] & ((jnp.uint32(1) << bits) - jnp.uint32(1)))
    isset = jnp.right_shift(w[:, None], bits) & jnp.uint32(1)
    match = (prefix.astype(jnp.int32) == rank[:, None]) \
        & (isset == jnp.uint32(1))
    b = jnp.min(jnp.where(match, jnp.arange(32, dtype=jnp.int32)[None],
                          jnp.int32(32)), axis=1)
    idx = wsafe * 32 + b
    return jnp.where(ok_s & (b < 32) & (idx < n), idx, fill)


def extract_bits(
    occ_w: jnp.ndarray,  # (ncols, nwords) uint32 packed column masks
    *,
    max_out: int,  # total output capacity
    row_stride: int,  # flat index = column_id * row_stride + z
    fill: int,  # flat index emitted for empty output slots
    max_words: int = 0,  # active-WORD compaction capacity (0 = max_out)
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Compact set bits into flat indices in dense scan order — the
    budget-free successor of `extract_columns`.

    Two-level rank select: (1) active WORDS compact through the packed
    rank-select (stamp scatter sized to the 32x-packed activity mask);
    (2) every output SLOT finds its (word, rank) by exclusive-cumsum +
    stamp/cummax over the compacted words and selects its rank-th set bit
    by prefix popcount. No per-column bit budget exists, so z-parallel
    surfaces (walls/floors filling whole columns) cost nothing extra —
    `extract_columns`' per-column rounds made the umbrella's 512-cube
    extraction pay budget(256) x max_cols x nwords word-ops per frame;
    here the work scales only with the capacities.

    Returns (flat_idx (max_out,) int32 ascending with `fill` padding,
    n_total set bits, n_captured <= n_total). Capture is an ascending
    prefix of scan order; a shortfall means max_words or max_out
    overflowed.
    """
    ncols, nwords = occ_w.shape
    if max_words <= 0:
        max_words = max_out
    wflat = occ_w.reshape(ncols * nwords)
    n_total = jnp.sum(jax.lax.population_count(wflat).astype(jnp.int32))

    # level 1: indices of active words (ascending)
    widx = rank_select(wflat != jnp.uint32(0), size=max_words,
                       fill=ncols * nwords)
    wok = widx < ncols * nwords
    wsafe = jnp.where(wok, widx, 0)
    words = jnp.where(wok, wflat[wsafe], jnp.uint32(0))  # (max_words,)

    # level 2: per-slot (word, rank) by exclusive cumsum + stamp/cummax
    cnt = jax.lax.population_count(words).astype(jnp.int32)
    off = jnp.cumsum(cnt) - cnt
    n_captured = jnp.minimum(off[-1] + cnt[-1], max_out)
    stamp = jnp.where(cnt > 0, off, max_out)
    wids = jnp.arange(max_words, dtype=jnp.int32)
    wstart = jnp.zeros(max_out, jnp.int32).at[stamp].max(
        wids + 1, mode="drop")
    word_of = jax.lax.cummax(wstart) - 1
    slot = jnp.arange(max_out, dtype=jnp.int32)
    ok_s = (slot < n_captured) & (word_of >= 0)
    wsel = jnp.maximum(word_of, 0)
    rank = slot - off[wsel]
    w = words[wsel]
    bits = jnp.arange(32, dtype=jnp.uint32)
    prefix = jax.lax.population_count(
        w[:, None] & ((jnp.uint32(1) << bits) - jnp.uint32(1)))
    isset = jnp.right_shift(w[:, None], bits) & jnp.uint32(1)
    match = (prefix.astype(jnp.int32) == rank[:, None]) \
        & (isset == jnp.uint32(1))
    b = jnp.min(jnp.where(match, jnp.arange(32, dtype=jnp.int32)[None],
                          jnp.int32(32)), axis=1)
    flat_word = wsafe[wsel]  # flat word index = c * nwords + wz
    c = flat_word // nwords
    z = (flat_word - c * nwords) * 32 + b
    flat_idx = jnp.where(ok_s & (b < 32), c * row_stride + z, fill)
    return flat_idx, n_total, n_captured


def extract_columns(
    occ_w: jnp.ndarray,  # (ncols, nwords) uint32 packed column masks
    *,
    per_column: int,  # K: max set bits captured per column
    max_cols: int,  # active-column compaction capacity
    max_out: int,  # total output capacity
    row_stride: int,  # flat index = column_id * row_stride + z
    fill: int,  # flat index emitted for empty output slots
    packed_cols: bool = False,  # bit-packed active-column compaction
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Compact set bits into flat indices in dense scan order.

    Returns (flat_idx (max_out,) int32 with `fill` padding, n_total set
    bits, n_captured <= n_total). Capacity overflow (per_column, max_cols,
    or max_out) surfaces as n_captured < n_total.
    """
    ncols, nwords = occ_w.shape
    n_total = jnp.sum(jax.lax.population_count(occ_w).astype(jnp.int32))

    col_active = jnp.any(occ_w != jnp.uint32(0), axis=1)
    if packed_cols:
        # XLA lowers `nonzero` as one scatter per INPUT element — at the
        # edge extraction's X*Y*3 = 786k columns that single op dominated
        # the extraction.
        # RANK-SELECT formulation: pack the mask 32x, per-word popcount +
        # exclusive cumsum assigns every active column its output slot,
        # and each output slot selects the k-th set bit of its word by
        # prefix-popcount — one 24k stamp-scatter + elementwise blocks, NO
        # per-element scatter and no nested LSB rounds (which ran the
        # compiler out of memory, both inside marching cubes and
        # standalone in the edge extraction).
        # OPT-IN because callers must compile-check their fused program.
        nwm = (ncols + 31) // 32
        padded = jnp.pad(col_active, (0, nwm * 32 - ncols))
        aw = pack_columns(padded.reshape(nwm, 32)).reshape(nwm)
        cnt = jax.lax.population_count(aw).astype(jnp.int32)
        off = jnp.cumsum(cnt) - cnt
        stamp = jnp.where(cnt > 0, off, max_cols)
        wids = jnp.arange(nwm, dtype=jnp.int32)
        wstart = jnp.zeros(max_cols, jnp.int32).at[stamp].max(
            wids + 1, mode="drop")
        word_of = jax.lax.cummax(wstart) - 1
        n_act = off[-1] + cnt[-1]
        slot = jnp.arange(max_cols, dtype=jnp.int32)
        ok_s = (slot < n_act) & (word_of >= 0)
        wsafe = jnp.maximum(word_of, 0)
        rank = slot - off[wsafe]
        w = aw[wsafe]  # (max_cols,) — gather from the small word table
        bits = jnp.arange(32, dtype=jnp.uint32)
        prefix = jax.lax.population_count(
            w[:, None] & ((jnp.uint32(1) << bits) - jnp.uint32(1)))
        isset = jnp.right_shift(w[:, None], bits) & jnp.uint32(1)
        match = (prefix.astype(jnp.int32) == rank[:, None]) \
            & (isset == jnp.uint32(1))
        b = jnp.min(jnp.where(match, jnp.arange(32, dtype=jnp.int32)[None],
                              jnp.int32(32)), axis=1)
        col_idx = jnp.where(ok_s & (b < 32), wsafe * 32 + b, ncols)
    else:
        col_idx = jnp.nonzero(col_active, size=max_cols, fill_value=ncols)[0]
    col_ok = col_idx < ncols
    safe_col = jnp.minimum(col_idx, ncols - 1)
    words = jnp.where(col_ok[:, None], occ_w[safe_col], jnp.uint32(0))

    iota_w = jnp.arange(nwords, dtype=jnp.int32)

    def one_round(words):
        nz = words != jnp.uint32(0)
        widx = jnp.min(jnp.where(nz, iota_w[None, :], jnp.int32(nwords)),
                       axis=1)  # first nonzero word per column
        oh = iota_w[None, :] == widx[:, None]
        w = jnp.sum(jnp.where(oh, words, jnp.uint32(0)), axis=1,
                    dtype=jnp.uint32)
        lsb = w & (jnp.uint32(0) - w)
        # bit position from the f32 exponent (exact for powers of two;
        # lsb == 0 gives e = -127, masked below)
        e = (jax.lax.bitcast_convert_type(lsb.astype(jnp.float32),
                                          jnp.int32) >> 23) - 127
        z = widx * 32 + e
        c = jnp.where(lsb != jnp.uint32(0), z, jnp.int32(nwords * 32))
        return jnp.where(oh, words ^ lsb[:, None], words), c

    if per_column <= 32:
        # unrolled: XLA fuses the short round chain
        cands = []
        for _ in range(per_column):
            words, c = one_round(words)
            cands.append(c)
        cand = jnp.stack(cands, axis=1)  # (max_cols, K) ascending z
    else:
        # large per-column budgets (the fusion band's col_budget=128)
        # must NOT unroll: 128 unrolled rounds blow the HLO up into a
        # pathological (tens-of-minutes, sometimes failing) compile
        def body(r, state):
            words, cand = state
            words, c = one_round(words)
            cand = jax.lax.dynamic_update_slice(cand, c[:, None], (0, r))
            return words, cand

        cand0 = jnp.full((words.shape[0], per_column),
                         jnp.int32(nwords * 32), jnp.int32)
        _, cand = jax.lax.fori_loop(0, per_column, body, (words, cand0))
    valid = cand < nwords * 32
    cand_idx = jnp.where(
        valid, safe_col.astype(jnp.int32)[:, None] * row_stride + cand, fill)

    # slot assignment: LSB-first extraction makes `valid` a per-column
    # PREFIX mask, so per-column counts + an exclusive cumsum give each
    # candidate its output slot exactly; the inverse slot -> (column, rank)
    # map is one small stamp-scatter + a cummax.
    cnt = jnp.sum(valid.astype(jnp.int32), axis=1)
    coff = jnp.cumsum(cnt) - cnt
    n_captured = jnp.minimum(coff[-1] + cnt[-1], max_out)
    stamp_pos = jnp.where(cnt > 0, coff, max_out)
    col_ids = jnp.arange(cand.shape[0], dtype=jnp.int32)
    colstart = jnp.zeros(max_out, jnp.int32).at[stamp_pos].max(
        col_ids + 1, mode="drop")
    col_of = jax.lax.cummax(colstart) - 1
    slots = jnp.arange(max_out, dtype=jnp.int32)
    slot_ok = (slots < n_captured) & (col_of >= 0)
    safe_c = jnp.maximum(col_of, 0)
    rank = jnp.clip(slots - coff[safe_c], 0, cand.shape[1] - 1)
    flat_idx = jnp.where(slot_ok, cand_idx[safe_c, rank], fill)
    return flat_idx, n_total, n_captured
