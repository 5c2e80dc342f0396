"""Chunk-packed tile-binned sampling (the high-density sibling of
ops/sampling.sample_binned).

Same semantics as the tiled path - a pair counts iff the Gaussian's
footprint covers the sample's tile (forward.cu:104-144 pairing) - but both
sides of the pair sweep are padded per tile (binning/chunked.py), so a
sample chunk meets only the entry chunks of its own tile.  The range sweeps
of sample_tiled_multi pay cross-tile slack whenever per-tile occupancy is
small next to the block size; chunk packing removes it, which makes fine
tiles pay off (the candidate-pair total scales like (2r + tile)^D).

The pair kernels are kernels/tiled.py's, fed per-chunk (base, nblk) sweeps
(binning/chunked.chunk_sweeps); only the operand layouts (chunk-padded
instead of contiguous) and the capacity planning differ.  Gradients flow to
(means, values, conics) only - the reference's autograd contract
(__init__.py:113-126) - via the same custom-vjp + by-gaussian segment-sum
structure.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ..config import SamplerConfig, tri_size

class ChunkPlan(NamedTuple):
    """Static capacities for the chunked sampling path (hashable: usable as
    a jit static argument).  Measured exactly by plan_chunked from one eager
    geometry build; in-graph overflow counters guard drift."""

    rect: int      # per-axis candidate-tile cap R for duplicate_entries
    entries: int   # compact sorted-entry capacity
    e_chunks: int  # entry chunks of block_e
    s_chunks: int  # sample chunks of block_n


class ChunkedSamples(NamedTuple):
    """Chunk-padded sample side - parameter-independent, built once per
    sample set (the analogue of binning.grid.SampleBinning)."""

    s_coords: jnp.ndarray  # (D, Nsp) chunk-padded sorted coords
    s_tile: jnp.ndarray    # (Nsp,) int32, kernels/tiled.SAMPLE_PAD_TILE pads
    pos: jnp.ndarray       # (N,) padded slot of each original sample
    cm: jnp.ndarray        # (T,) sample chunks per tile
    cbase: jnp.ndarray     # (T,) first sample chunk of each tile
    ctile: jnp.ndarray     # (s_chunks,) tile of each sample chunk, T unused
    overflow: jnp.ndarray  # () int32 chunk-capacity overflow


def plan_chunked(cfg: SamplerConfig, means, covariances, samples,
                 *, block_n: Optional[int] = None,
                 block_e: Optional[int] = None,
                 headroom: float = 1.0):
    """Host-side capacity plan: exact chunk/work capacities measured from
    one eager geometry build (the chunked-path analogue of
    utils.native.plan_capacities).

    ``headroom > 1`` scales every capacity for training drift (parameters
    move, collocation points resample).  Chunks beyond the used total are
    never written by any work item, so the UNSORTED output path is
    headroom-safe, and unused chunks sweep nothing, so their padded output
    columns are zero.  Overflow diagnostics still flag any drift past the
    scaled capacities."""
    import numpy as np

    from ..binning import chunked
    from ..binning import grid as binning
    from ..oracle.dense import radii as compute_radii
    from ..oracle.dense import radii_axis

    import dataclasses

    P, D = means.shape
    cfg = cfg.with_dims(D)
    bn = block_n or cfg.block_n
    be = block_e or cfg.block_p
    rad = (radii_axis if cfg.axis_radii else compute_radii)(
        covariances, D, cfg.radius_sigma, cfg.eig_floor)
    # Compact-support certificate for the wrap-free kernels (identical to
    # utils.native.plan_capacities): with every footprint satisfying
    # max_radius + tile < period/2, per-entry period-shifted means make the
    # raw offset the minimum-image displacement for every paired sample.
    if cfg.period is not None and not cfg.unwrapped_kernels:
        rmax = float(jax.device_get(jnp.max(rad)))
        if rmax + cfg.tile_size < cfg.period / 2.0:
            cfg = dataclasses.replace(cfg, unwrapped_kernels=True)
    lo, hi = binning.gaussian_rects(cfg, means, rad)
    R = max(int(jax.device_get(jnp.max(hi - lo))), 1)
    plan_conics = (binning.conics_from_cov(jnp.asarray(covariances), D)
                   if cfg.ellip_cull and D >= 2 else None)
    ent = binning.duplicate_entries(cfg, means, rad, R, P * R ** D,
                                    conics=plan_conics)
    T = binning.num_tiles(cfg, D)
    n_entries = int(jax.device_get(jnp.sum(ent[1] < T)))
    sb = binning.bin_samples(cfg, samples)
    em = np.asarray(jax.device_get(chunked.chunk_counts(ent[2], be)))
    sm = np.asarray(jax.device_get(chunked.chunk_counts(sb.s_start, bn)))
    return cfg, ChunkPlan(
        rect=R,
        entries=max(-(-int(n_entries * headroom) // 128) * 128, 128),
        e_chunks=max(int(em.sum() * headroom), 1),
        s_chunks=max(int(sm.sum() * headroom), 1),
    )


@functools.partial(jax.jit, static_argnums=(0, 2, 3),
                   static_argnames=("plan", "block_n"))
def chunk_samples(cfg: SamplerConfig, samples, plan: ChunkPlan,
                  block_n: int, sample_binning=None) -> ChunkedSamples:
    """Build the chunk-padded sample side (once per sample set)."""
    from ..binning import chunked
    from ..binning import grid as binning
    from ..kernels.tiled import SAMPLE_PAD_TILE

    N, D = samples.shape
    cfg = cfg.with_dims(D)
    sb = sample_binning if sample_binning is not None else binning.bin_samples(
        cfg, samples)
    csrc, cvalid, stile, ctile, cbase, cm, s_of = chunked.chunk_layout(
        sb.s_start, block_n, plan.s_chunks)
    Nsp = plan.s_chunks * block_n
    coords = sb.s_sorted.T[csrc].T                       # (D, Nsp)
    s_tile = jnp.where(cvalid, stile, jnp.int32(SAMPLE_PAD_TILE))
    cid = jnp.where(cvalid, sb.s_perm[csrc], N)
    pos = jnp.zeros((N + 1,), jnp.int32).at[cid].set(
        jnp.arange(Nsp, dtype=jnp.int32), mode="drop"
    )[:N]
    return ChunkedSamples(
        s_coords=coords, s_tile=s_tile, pos=pos, cm=cm, cbase=cbase,
        ctile=ctile, overflow=s_of,
    )


def sample_chunked_multi(
    orders: Tuple[str, ...],
    cfg: SamplerConfig,
    means, values, conics, radii,
    cs: ChunkedSamples,
    plan: ChunkPlan,
    *,
    block_n: int, block_e: int,
    unique_outputs: bool = False,
    padded_outputs: bool = False,
):
    """Fused multi-order evaluation over the chunk-packed binning.

    Returns (outputs tuple, diagnostics dict).  With ``padded_outputs``
    each order comes back in the kernels' raw component-major layout
    ((n_unique, C, Nsp) canonical components, chunk-padded tile-sorted
    columns, pad columns zero); otherwise outputs are un-sorted to sample
    order via one row gather.  All overflow diagnostics must be zero for
    exact results."""
    from ..binning import chunked
    from ..binning import grid as binning
    from ..kernels import tiled as ktiled
    from .sampling import _unpack_orders

    P, D = means.shape
    C = values.shape[1]
    tri = tri_size(D)
    cfg = cfg.with_dims(D)
    N = cs.pos.shape[0]
    # Binning structure is non-differentiable; sever tangents before the
    # custom_vjp closure below captures radii (see sample_tiled_multi).
    radii = jax.lax.stop_gradient(radii)

    (gid, tile, start, rect_of, ent_of) = binning.duplicate_entries(
        cfg, means, radii, plan.rect, min(P * plan.rect ** D, plan.entries),
        conics=(jax.lax.stop_gradient(conics)
                if cfg.ellip_cull and D >= 2 else None),
    )
    esrc, evalid, etile, echunk_tile, ebase, em, e_of = chunked.chunk_layout(
        start, block_e, plan.e_chunks)
    gid_pad = jnp.where(evalid, gid[esrc], jnp.int32(P))
    tile_pad = jnp.where(evalid, etile, jnp.int32(ktiled.ENTRY_PAD_TILE))
    sweep_f = chunked.chunk_sweeps(cs.ctile, ebase, em)
    sweep_b = chunked.chunk_sweeps(echunk_tile, cs.cbase, cs.cm)
    smp = (cs.s_coords, cs.s_tile)

    # Entries are pre-shifted to their periodic image (gather_entries), so
    # the kernels run wrap-free when the config certifies compact
    # footprints.
    kernel_period = None if cfg.unwrapped_kernels else cfg.period

    def f_fwd(m, v, c):
        ent = (gid_pad, tile_pad, ktiled.gather_entries(
            cfg, gid_pad, tile_pad, m, v, c, radii))
        out = ktiled.tiled_forward(
            orders, kernel_period, D, C, sweep_f, ent, smp,
            block_n=block_n, block_e=block_e)   # (K*C, Nsp); pads are zero
        return out, ent

    @jax.custom_vjp
    def f(m, v, c):
        return f_fwd(m, v, c)[0]

    def f_bwd(ent, g):
        dent = ktiled.tiled_backward(
            orders, kernel_period, D, C, sweep_b, ent, smp, g,
            block_n=block_n, block_e=block_e)
        d = jax.ops.segment_sum(dent.T, ent[0], num_segments=P + 1)[:P]
        return d[:, :D], d[:, D + tri:], d[:, D:D + tri]

    f.defvjp(f_fwd, f_bwd)
    packed_t = f(means, values, conics)    # (K*C, Nsp)
    outs = _unpack_orders(
        orders, packed_t if padded_outputs else packed_t.T[cs.pos], N, D, C,
        unique_outputs, padded_outputs)
    diag = {
        "perm": None,
        "bin_overflow": rect_of,
        "entry_overflow": ent_of + e_of,
        "sample_overflow": cs.overflow,
    }
    return outs, diag


def sample_chunked(cfg, means, values, conics, covariances, samples,
                   plan: ChunkPlan, cs: ChunkedSamples,
                   orders: Tuple[str, ...],
                   *, unique_outputs: bool = False,
                   padded_outputs: bool = False):
    """Binned-evaluation entry point matching sample_binned's contract:
    (outputs dict, diagnostics dict), radii derived from covariances."""
    from ..oracle.dense import radii as compute_radii
    from ..oracle.dense import radii_axis

    D = means.shape[1]
    cfg = cfg.with_dims(D)
    rad = (radii_axis if cfg.axis_radii else compute_radii)(
        covariances, D, cfg.radius_sigma, cfg.eig_floor)
    outs, diag = sample_chunked_multi(
        tuple(orders), cfg, means, values, conics, rad, cs, plan,
        block_n=cfg.block_n, block_e=cfg.block_p,
        unique_outputs=unique_outputs, padded_outputs=padded_outputs,
    )
    return dict(zip(orders, outs)), diag
