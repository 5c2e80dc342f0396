"""Pair kernels over the tile-binned acceleration structure.

The binned analogue of the reference's per-tile render kernels
(forward.cu:88-166, backward.cu:27-106): one program per block of
tile-sorted rows walks its own contiguous sweep of column blocks.  Both
sides of the pair sweep are sorted by tile, so the columns a row block can
meet form one contiguous range [base, base + nblk) of column blocks
(binning.grid.forward_geometry / backward_geometry, or the chunked path's
same-tile chunk sweeps, binning.chunked.chunk_sweeps).  Pair validity inside
a block is ``entry_tile == sample_tile`` - the exact pairing the reference's
binning produces (a Gaussian meets a sample iff its footprint covers the
sample's tile).

  * forward: one program per block of ``block_n`` samples.  It loops over
    its entry blocks, keeps the (block_n, block_e) pair tile and the K*C
    partial sums in registers, and writes its output columns once.
  * backward: one program per block of ``block_e`` entries.  It loops over
    its sample blocks and writes the per-entry gradient rows once; the
    caller segment-sums them by gaussian id (the reference's atomicAdd
    scatter, backward.cu:121-152, moved outside the kernel).

The work is fp32 elementwise chains and reductions: C is 1-4 channels, so
there is no matrix product worth the tensor cores, and every contraction is
an FMA chain (no TF32 anywhere).  The kernels go through Pallas' Triton
route; on the CPU they run in the Pallas interpreter (tests).

Layouts: per-entry parameters ride in one ``geom`` array (D+tri+C, Ep) -
mean rows, conic rows, value rows - and each row of a block is one
contiguous (block_e,) load; samples are (D, Np) coordinates plus a (Np,)
tile row.  Outputs are component-major (K*C, Np): row k*C + c holds channel c
of unique component k (components enumerate ``orders`` in sequence).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from ..config import tri_size
from ..ops import formulas

# Tile ids of padding slots: never equal to each other or to a real tile
# (real tiles are < T, sorted-entry sentinels are T).
ENTRY_PAD_TILE = 2**30
SAMPLE_PAD_TILE = 2**30 + 1


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def pad_axis(x, axis, size):
    if x.shape[axis] == size:
        return x
    pads = [(0, 0)] * x.ndim
    pads[axis] = (0, size - x.shape[axis])
    return jnp.pad(x, pads)


def interpret_mode() -> bool:
    """Kernels compile for the GPU and run in the Pallas interpreter on the
    CPU; no other backend has a route, so it is an error, not a fallback."""
    backend = jax.default_backend()
    if backend == "cpu":
        return True
    if backend == "gpu":
        return False
    raise RuntimeError(f"no Pallas kernel route for backend {backend!r}")


def total_unique(orders, D: int) -> int:
    """Unique (canonical) components across the fused orders - the kernels
    compute only i<=j<=k of the symmetric tensors; the public layer mirrors
    (see formulas.sym_indices)."""
    return sum(formulas.n_unique(o, D) for o in orders)


def n_params(D: int, C: int) -> int:
    """Rows of the packed per-entry parameter/gradient arrays."""
    return D + tri_size(D) + C


# ---------------------------------------------------------------------------
# Operand preparation
# ---------------------------------------------------------------------------


def gather_entries(cfg, gid, tile, means, values, conics, radii):
    """(D+tri+C, E) per-entry parameter rows for entry ids ``gid`` (P =
    sentinel -> zero row) on tiles ``tile``.

    For a periodic config each entry's mean is shifted to the periodic image
    its tile sees (mu' = mu - period * k), so X = mu' - x is the
    minimum-image displacement for every pair the binning forms - which
    lets the kernels skip the per-pair wrap when footprints are compact
    (cfg.unwrapped_kernels).  The image index k is recomputed from (tile,
    rect lo); the rect lo columns ride the same row gather as the
    parameters.  Sentinel rows get a garbage shift, which is harmless: their
    values are zero and their tile never matches a sample tile."""
    from ..binning import grid as binning

    P, D = means.shape
    C = values.shape[1]
    tri = tri_size(D)
    params = jnp.concatenate([means, conics, values], axis=1)
    if cfg.period is not None:
        # The rect is binning structure, not a differentiable quantity.
        lo, _ = binning.gaussian_rects(
            cfg.with_dims(D), jax.lax.stop_gradient(means),
            jax.lax.stop_gradient(radii))
        params = jnp.concatenate([params, lo.astype(params.dtype)], axis=1)
    params = jnp.concatenate(
        [params, jnp.zeros((1, params.shape[1]), params.dtype)], 0)
    ent = params[gid]
    if cfg.period is not None:
        k = binning.image_shift(cfg.with_dims(D), tile, ent[:, D + tri + C:])
        ent = ent[:, :D + tri + C].at[:, :D].add(
            -cfg.period * k.astype(ent.dtype))
    return ent.T


def prepare_entries(state, means, values, conics, align_e: int, cfg):
    """Entry operands of the tiled path, padded to a multiple of
    ``align_e``: (gid (Ep,), tile (Ep,), geom (D+tri+C, Ep))."""
    P = means.shape[0]
    E = state.num_entries
    Ep = round_up(E, align_e)
    live = jnp.arange(Ep) < E
    gid = jnp.where(live, pad_axis(state.ent_gid, 0, Ep), P)
    tile = jnp.where(live, pad_axis(state.ent_tile[0], 0, Ep),
                     ENTRY_PAD_TILE)
    geom = gather_entries(cfg, gid, tile, means, values, conics, state.radii)
    return gid, tile, geom


def prepare_samples(state, align_n: int):
    """Sample operands of the tiled path, padded to a multiple of
    ``align_n``: (coords (D, Np), tile (Np,))."""
    N = state.s_sorted.shape[1]
    Np = round_up(N, align_n)
    coords = pad_axis(state.s_sorted, 1, Np)
    tile = jnp.where(jnp.arange(Np) < N, pad_axis(state.s_tile[0], 0, Np),
                     SAMPLE_PAD_TILE)
    return coords, tile


# ---------------------------------------------------------------------------
# Per-block pair math (shared by the forward and backward kernels)
# ---------------------------------------------------------------------------


def _pair_block(period, x, s_tile, ent, e_tile):
    """Pair quantities of one (samples, entries) block: X (D arrays), the
    conic entries, the tile-masked G and a = C X, all (block_n, block_e).
    ``x`` holds D (block_n,) coordinate rows, ``ent`` the entry rows
    [means, conics, values] as (block_e,) arrays."""
    D = len(x)
    Xs = [formulas.wrap(ent[d][None, :] - x[d][:, None], period)
          for d in range(D)]
    con = [ent[D + t][None, :] for t in range(tri_size(D))]
    G, a = formulas.power_terms(Xs, con)
    G = jnp.where(s_tile[:, None] == e_tile[None, :], G, 0.0)
    return Xs, con, G, a


def forward_block(orders, period, C, x, s_tile, ent, e_tile):
    """K*C per-sample partial sums (block_n,) of one pair block."""
    D = len(x)
    Xs, con, G, a = _pair_block(period, x, s_tile, ent, e_tile)
    vals = [ent[D + tri_size(D) + c][None, :] for c in range(C)]
    out = []
    for order in orders:
        for w in formulas.components_unique(order, Xs, con, G, a):
            out.extend(jnp.sum(w * v, axis=1) for v in vals)
    return out


def backward_block(orders, period, C, x, s_tile, g, ent, e_tile):
    """D+tri+C per-entry gradient partial sums (block_e,) of one pair block.

    ``g`` holds the K*C cotangent rows (block_n,) of the block's samples in
    the forward's output layout.  The VJP is the collapsed multi-order form
    (formulas.vjp_params_fused); dL/dvalues is the cotangent-weighted sum of
    the forward weights (backward.cu:121)."""
    D = len(x)
    Xs, con, G, a = _pair_block(period, x, s_tile, ent, e_tile)
    vals = [ent[D + tri_size(D) + c][None, :] for c in range(C)]
    hs, dvals = [], [None] * C
    lap_polys = third_polys = None
    k0 = 0
    for order in orders:
        polys = formulas.component_polys(order, Xs, con, a)
        if order == "laplacian":
            lap_polys = polys
        elif order == "third":
            third_polys = polys
        for k, p in enumerate(polys):
            w = G if isinstance(p, float) else G * p
            gk = [g[(k0 + k) * C + c][:, None] for c in range(C)]
            # h[n,p] = sum_c g[n,c] * values[p,c]   (backward.cu:122)
            h = gk[0] * vals[0]
            for c in range(1, C):
                h = h + gk[c] * vals[c]
            hs.append(h)
            for c in range(C):
                dv = jnp.sum(w * gk[c], axis=0)
                dvals[c] = dv if dvals[c] is None else dvals[c] + dv
        k0 += len(polys)
    dmu, dcon = formulas.vjp_params_fused(
        orders, Xs, con, G, a, hs, lap_polys, third_polys)
    return ([jnp.sum(m, axis=0) for m in dmu]
            + [jnp.sum(t, axis=0) for t in dcon] + dvals)


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------


_ANY = pl.BlockSpec(memory_space=pl.ANY)


def default_warps(block_n: int, block_e: int) -> int:
    """Warps per program: 8 pair slots per thread (32 threads a warp).
    Larger pair tiles spill registers in the backward (measured on the
    H100: PERF.md)."""
    return max(1, block_n * block_e // 256)


def _forward_kernel(orders, period, D, C, block_n, block_e,
                    base_ref, nblk_ref, geom_ref, etile_ref, s_ref,
                    stile_ref, *out_refs):
    i = pl.program_id(0)
    cols = pl.ds(i * block_n, block_n)
    x = [s_ref[d, cols] for d in range(D)]
    s_tile = stile_ref[cols]
    base = base_ref[i]
    nrows = geom_ref.shape[0]

    def body(j, accs):
        ecols = pl.ds((base + j) * block_e, block_e)
        ent = [geom_ref[r, ecols] for r in range(nrows)]
        part = forward_block(orders, period, C, x, s_tile, ent,
                             etile_ref[ecols])
        return tuple(acc + p for acc, p in zip(accs, part))

    zero = jnp.zeros((block_n,), jnp.float32)
    accs = jax.lax.fori_loop(0, nblk_ref[i], body, (zero,) * len(out_refs))
    for o, acc in zip(out_refs, accs):
        o[...] = acc


def tiled_forward(orders: Tuple[str, ...], period, D: int, C: int,
                  sweep, ent, smp, *, block_n: int, block_e: int,
                  num_warps: int = None) -> jnp.ndarray:
    """Packed (K*C, Np) outputs in tile-sorted sample order.

    ``sweep`` = (base, nblk) per sample block (Np // block_n of them) over
    entry blocks of ``block_e``; ``ent`` = (gid, tile, geom) and ``smp`` =
    (coords, tile) from prepare_entries / prepare_samples (or the chunked
    path's chunk layouts)."""
    base, nblk = sweep
    _, e_tile, geom = ent
    coords, s_tile = smp
    Np = coords.shape[1]
    KC = total_unique(orders, D) * C
    outs = pl.pallas_call(
        functools.partial(_forward_kernel, orders, period, D, C,
                          block_n, block_e),
        grid=(Np // block_n,),
        in_specs=[_ANY] * 6,
        out_specs=[pl.BlockSpec((block_n,), lambda i: (i,))] * KC,
        out_shape=[jax.ShapeDtypeStruct((Np,), jnp.float32)] * KC,
        backend="triton",
        compiler_params=plt.CompilerParams(
            num_warps=num_warps or default_warps(block_n, block_e)),
        interpret=interpret_mode(),
        name="dgs_pair_forward",
    )(base, nblk, geom, e_tile, coords, s_tile)
    return jnp.stack(outs)


def _backward_kernel(orders, period, D, C, block_n, block_e,
                     base_ref, nblk_ref, geom_ref, etile_ref, s_ref,
                     stile_ref, g_ref, *out_refs):
    j = pl.program_id(0)
    ecols = pl.ds(j * block_e, block_e)
    ent = [geom_ref[r, ecols] for r in range(geom_ref.shape[0])]
    e_tile = etile_ref[ecols]
    base = base_ref[j]
    n_g = g_ref.shape[0]

    def body(i, accs):
        cols = pl.ds((base + i) * block_n, block_n)
        x = [s_ref[d, cols] for d in range(D)]
        g = [g_ref[r, cols] for r in range(n_g)]
        part = backward_block(orders, period, C, x, stile_ref[cols], g,
                              ent, e_tile)
        return tuple(acc + p for acc, p in zip(accs, part))

    zero = jnp.zeros((block_e,), jnp.float32)
    accs = jax.lax.fori_loop(0, nblk_ref[j], body, (zero,) * len(out_refs))
    for o, acc in zip(out_refs, accs):
        o[...] = acc


def tiled_backward(orders: Tuple[str, ...], period, D: int, C: int,
                   sweep, ent, smp, g, *, block_n: int, block_e: int,
                   num_warps: int = None) -> jnp.ndarray:
    """Per-entry gradient rows (D+tri+C, Ep): mean rows, conic rows, value
    rows.  ``sweep`` = (base, nblk) per entry block (Ep // block_e of them)
    over sample blocks of ``block_n``; ``g`` is the (K*C, Np) cotangent of
    tiled_forward's output.  The caller segment-sums the rows by gid."""
    base, nblk = sweep
    _, e_tile, geom = ent
    coords, s_tile = smp
    Ep = geom.shape[1]
    NP = n_params(D, C)
    outs = pl.pallas_call(
        functools.partial(_backward_kernel, orders, period, D, C,
                          block_n, block_e),
        grid=(Ep // block_e,),
        in_specs=[_ANY] * 7,
        out_specs=[pl.BlockSpec((block_e,), lambda j: (j,))] * NP,
        out_shape=[jax.ShapeDtypeStruct((Ep,), jnp.float32)] * NP,
        backend="triton",
        compiler_params=plt.CompilerParams(
            num_warps=num_warps or default_warps(block_n, block_e)),
        interpret=interpret_mode(),
        name="dgs_pair_backward",
    )(base, nblk, geom, e_tile, coords, s_tile, g)
    return jnp.stack(outs)
