"""Per-tile chunk packing for same-tile pair sweeps.

The range sweeps of binning/grid.py pair row blocks with column blocks
whenever their tile RANGES overlap; when per-tile occupancy is small next to
the block size, those pair blocks are mostly cross-tile slack.  This module
instead pads each side so every tile's rows start at a chunk boundary: a
row chunk then meets only the col chunks of its own tile, and pair density
becomes sum_t e_t*c_t / (ceil(e_t/Be)*Be * ceil(c_t/Bc)*Bc).

Both layouts and the sweeps are shape-static and jit-compatible; the
planner measures exact capacities from one eager geometry build.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def chunk_counts(starts: jnp.ndarray, block: int) -> jnp.ndarray:
    """(T,) chunks per tile for tile-sorted rows with range table ``starts``
    ((T+2,) searchsorted layout; sentinel rows beyond tile T-1 excluded)."""
    T = starts.shape[0] - 2
    n = starts[1:T + 1] - starts[:T]
    return -(-n // block)


def chunk_layout(starts: jnp.ndarray, block: int, cap_chunks: int):
    """Padded per-tile chunk layout for tile-sorted rows.

    Rows of tile t (the contiguous range [starts[t], starts[t+1])) are
    re-laid-out to begin at chunk boundary ``base[t] * block``; every chunk
    holds rows of exactly one tile (trailing slots are pads).

    Every per-slot array is built as a (cap_chunks, block) broadcast of
    chunk-level quantities, so only chunk-level arrays are gathered.

    Returns (src, valid, slot_tile, chunk_tile, base, m, overflow):
      src        (cap_chunks*block,) int32 source row per padded slot
                 (monotone nondecreasing; clipped for pads)
      valid      (cap_chunks*block,) bool, False for pad slots
      slot_tile  (cap_chunks*block,) int32 tile of each slot, T for pads
      chunk_tile (cap_chunks,) int32 tile of each chunk, T for unused chunks
      base       (T,) int32 first chunk index of each tile
      m          (T,) int32 chunks per tile
      overflow   () int32 chunks beyond cap_chunks (0 => exact layout)
    """
    T = starts.shape[0] - 2
    m = chunk_counts(starts, block)
    base = (jnp.cumsum(m) - m).astype(jnp.int32)
    total = base[-1] + m[-1]
    overflow = jnp.maximum(total - cap_chunks, 0).astype(jnp.int32)

    # chunk -> tile: scatter tile boundaries, prefix-sum.  base is
    # nondecreasing with duplicates (m_t == 0 tiles); add-with-drop
    # accumulates one increment per crossed boundary.
    c = jnp.arange(cap_chunks, dtype=jnp.int32)
    chunk_tile = jnp.cumsum(
        jnp.zeros((cap_chunks,), jnp.int32).at[base[1:]].add(1, mode="drop")
    )
    chunk_tile = jnp.clip(chunk_tile, 0, T - 1)
    chunk_tile = jnp.where(c < total, chunk_tile, T)

    t_of = jnp.clip(chunk_tile, 0, T - 1)          # chunk-level gathers
    chunk_src0 = starts[t_of] + (c - base[t_of]) * block
    off = jnp.arange(block, dtype=jnp.int32)[None, :]
    src2 = chunk_src0[:, None] + off               # (cap_chunks, block)
    lim = starts[t_of + 1]
    valid2 = (src2 < lim[:, None]) & (chunk_tile < T)[:, None]
    slot_tile2 = jnp.where(
        valid2, jnp.broadcast_to(chunk_tile[:, None], valid2.shape), T
    )
    src = jnp.clip(src2, 0, jnp.maximum(starts[T] - 1, 0)).reshape(-1)
    return (src, valid2.reshape(-1), slot_tile2.reshape(-1), chunk_tile,
            base, m.astype(jnp.int32), overflow)


def chunk_sweeps(chunk_tile_row, col_base, col_m):
    """(base, nblk) per row chunk for the pair kernels (kernels/tiled.py):
    a row chunk of tile t meets exactly the col chunks of tile t, which
    chunk_layout placed contiguously at [col_base[t], col_base[t] +
    col_m[t]).  Unused row chunks (tile T) sweep nothing."""
    T = col_m.shape[0]
    t = jnp.clip(chunk_tile_row, 0, T - 1)
    live = chunk_tile_row < T
    return (jnp.where(live, col_base[t], 0).astype(jnp.int32),
            jnp.where(live, col_m[t], 0).astype(jnp.int32))


def work_list(m_row, m_col, row_base, col_base, cap: int, colmax: int):
    """Same-tile chunk work list, ordered row-chunk-major.

    For each tile: m_row[t] x max(m_col[t], 1) items, grouped by row chunk,
    with the tile's col chunks enumerated inside.  Encoding: aux = row_chunk
    * 4 + first * 2 + compute (``first`` flags a row chunk's first item,
    ``compute`` real work), col = the item's col chunk.

    Returns (aux (cap,), col (cap,), overflow ()).
    """
    T = m_row.shape[0]
    mi = jnp.maximum(m_col, 1)               # items per row chunk
    it = m_row * mi
    istart = (jnp.cumsum(it) - it).astype(jnp.int32)
    total = istart[-1] + it[-1]
    overflow = jnp.maximum(total - cap, 0).astype(jnp.int32)

    w = jnp.arange(cap, dtype=jnp.int32)
    t = jnp.cumsum(
        jnp.zeros((cap,), jnp.int32).at[istart[1:]].add(1, mode="drop")
    )
    t = jnp.clip(t, 0, T - 1)
    o = w - istart[t]
    mi_t = mi[t]
    rl = o // mi_t
    cl = o - rl * mi_t
    live = w < total
    first = ((cl == 0) & live).astype(jnp.int32)
    compute = (live & (cl < m_col[t])).astype(jnp.int32)
    row_chunk = row_base[t] + rl
    col_chunk = jnp.clip(
        col_base[t] + jnp.minimum(cl, jnp.maximum(m_col[t] - 1, 0)),
        0, colmax - 1,
    )
    aux = row_chunk * 4 + first * 2 + compute
    return aux.astype(jnp.int32), col_chunk.astype(jnp.int32), overflow
