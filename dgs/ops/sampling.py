"""Differentiable sampling ops with hand-derived custom VJPs.

This is the JAX equivalent of the reference's autograd layer + CUDA
backward kernels (__init__.py:128-162 + backward.cu): each op is a
``jax.custom_vjp`` whose backward produces (dL/dmeans, dL/dvalues,
dL/dconics) exactly as the reference's hand-written kernels do
(sample_points.cu:165-167), and zero for the sample positions (the reference
returns no sample gradient, __init__.py:113-126).

Two execution paths share this interface:
  * dense  - XLA evaluation of all pairs (``sample_dense_multi``).
  * tiled  - tile-binned pair kernels (kernels/tiled.py + binning/).

The fused multi-order op evaluates several derivative orders in one pairwise
pass - the reference launches 4 separate kernels over the same binning
(sampler_impl.cu:333-364 called once per op).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from ..config import n_components, out_shape, tri_size
from . import formulas

ALL_ORDERS = ("value", "derivative", "laplacian", "third")


def _pairwise_context(means, conics, samples, period):
    """Shared per-pair quantities: X (wrapped), conic entries, G, a."""
    N, D = samples.shape
    X = formulas.wrap(means[None, :, :] - samples[:, None, :], period)
    Xs = [X[..., d] for d in range(D)]
    con = [conics[None, :, t] for t in range(tri_size(D))]
    G, a = formulas.power_terms(Xs, con)
    return Xs, con, G, a


def _forward_impl(orders, period, means, values, conics, samples):
    N, D = samples.shape
    P, C = values.shape
    Xs, con, G, a = _pairwise_context(means, conics, samples, period)
    outs = []
    for order in orders:
        comps = formulas.components(order, Xs, con, G, a)
        W = jnp.stack(comps, axis=1)  # (N, k, P)
        out = jnp.einsum("nkp,pc->nkc", W, values,
                         precision=jax.lax.Precision.HIGHEST)
        outs.append(out.reshape(out_shape(order, N, D, C)))
    return tuple(outs)


def _backward_impl(orders, period, means, values, conics, samples, gs):
    """Closed-form VJP shared by all orders; mirrors backward.cu:108-416."""
    N, D = samples.shape
    P, C = values.shape
    Xs, con, G, a = _pairwise_context(means, conics, samples, period)

    d_means = jnp.zeros((P, D), means.dtype)
    d_values = jnp.zeros((P, C), values.dtype)
    d_conics = jnp.zeros((P, tri_size(D)), conics.dtype)

    for order, g in zip(orders, gs):
        k = n_components(order, D)
        g = g.reshape(N, k, C)
        comps = formulas.components(order, Xs, con, G, a)
        W = jnp.stack(comps, axis=1)  # (N, k, P)
        # dL/dvalues[p,c] = sum_{n,comp} W[n,comp,p] * g[n,comp,c]
        d_values = d_values + jnp.einsum("nkp,nkc->pc", W, g,
                                         precision=jax.lax.Precision.HIGHEST)
        # h_comp[n,p] = sum_c values[p,c] * g[n,comp,c]   (backward.cu:122)
        H = jnp.einsum("pc,nkc->nkp", values, g,
                       precision=jax.lax.Precision.HIGHEST)
        hs = [H[:, i, :] for i in range(k)]
        dmu, dcon = formulas.vjp_params(order, Xs, con, G, a, hs)
        d_means = d_means + jnp.stack([m.sum(axis=0) for m in dmu], axis=-1)
        d_conics = d_conics + jnp.stack([c.sum(axis=0) for c in dcon], axis=-1)

    return d_means, d_values, d_conics


@functools.partial(jax.custom_vjp, nondiff_argnums=(0, 1))
def sample_dense_multi(orders: Tuple[str, ...], period: Optional[float],
                       means, values, conics, samples):
    """Fused multi-order dense evaluation; returns one output per order."""
    return _forward_impl(orders, period, means, values, conics, samples)


def _sample_dense_multi_fwd(orders, period, means, values, conics, samples):
    outs = _forward_impl(orders, period, means, values, conics, samples)
    return outs, (means, values, conics, samples)


def _sample_dense_multi_bwd(orders, period, res, gs):
    means, values, conics, samples = res
    d_means, d_values, d_conics = _backward_impl(
        orders, period, means, values, conics, samples, gs
    )
    return d_means, d_values, d_conics, jnp.zeros_like(samples)


sample_dense_multi.defvjp(_sample_dense_multi_fwd, _sample_dense_multi_bwd)


def sample_dense(order: str, means, values, conics, samples,
                 *, period: Optional[float] = 2.0):
    """Single-order dense evaluation (value/derivative/laplacian/third)."""
    (out,) = sample_dense_multi((order,), period, means, values, conics, samples)
    return out


def sample_dense_all(means, values, conics, samples, *, period=2.0,
                     orders: Sequence[str] = ALL_ORDERS):
    outs = sample_dense_multi(tuple(orders), period, means, values, conics, samples)
    return dict(zip(orders, outs))


# ---------------------------------------------------------------------------
# Tile-binned path (binning/ + kernels/tiled.py)
# ---------------------------------------------------------------------------


def _pad_sweep(sweep, rows: int):
    """(base, nblk) padded to ``rows`` row blocks (pad rows sweep nothing)."""
    from ..kernels.tiled import pad_axis

    base, nblk = sweep
    return pad_axis(base, 0, rows), pad_axis(nblk, 0, rows)


def sample_tiled_multi(orders: Tuple[str, ...], cfg,
                       means, values, conics, samples, state,
                       fwd_geom, bwd_geom,
                       *, block_n: int, block_e: int,
                       bwd_block_n: int, bwd_block_e: int,
                       sorted_outputs: bool = False,
                       unique_outputs: bool = False,
                       padded_outputs: bool = False,
                       unwrapped: bool = False):
    """Fused multi-order evaluation over a prebuilt BinningState.

    ``state``/geometry come from binning.grid (build + forward_geometry +
    backward_geometry) at the given block sizes.  Gradients flow to (means,
    values, conics) only - the reference's autograd contract
    (__init__.py:113-126).

    With ``padded_outputs`` (requires sorted_outputs) each order comes back
    in the kernels' raw component-major layout: (n_unique, C, Np) canonical
    components with block-padded, tile-sorted sample columns (pad columns
    are zero).  Reduction-style losses consume it with no un-sort gather.
    """
    from ..kernels import tiled as ktiled

    N, D = samples.shape
    P, C = values.shape
    tri = tri_size(D)
    if padded_outputs and not sorted_outputs:
        raise ValueError("padded_outputs requires sorted_outputs")
    # The binning structure (incl. radii, consumed by prepare_entries for the
    # periodic image recompute) is non-differentiable; sever its tangents
    # BEFORE the custom_vjp below closes over it, or an outer linearization's
    # tracers leak into the closure.
    state = jax.tree.map(jax.lax.stop_gradient, state)
    # With per-entry period-shifted means (prepare_entries) the kernels can
    # drop the per-pair torus wrap when footprints are compact
    # (cfg.unwrapped_kernels; exactness certified by the capacity planner).
    kernel_period = None if unwrapped else cfg.period

    # Entry/sample padding aligned to both directions' block sizes so one
    # gather serves forward and backward.
    align_e = max(block_e, bwd_block_e)
    align_n = max(block_n, bwd_block_n)
    smp = ktiled.prepare_samples(state, align_n)
    Np = smp[0].shape[1]
    Ep = ktiled.round_up(state.num_entries, align_e)
    sweep_f = _pad_sweep(fwd_geom, Np // block_n)
    sweep_b = _pad_sweep(bwd_geom, Ep // bwd_block_e)

    if not sorted_outputs:
        inv = jnp.zeros((N,), jnp.int32).at[state.s_perm].set(
            jnp.arange(N, dtype=jnp.int32)
        )

    # The custom_vjp works in the kernels' component-major (K*C, Np)
    # layout; all slicing / un-sorting / transposing to the public shapes
    # happens OUTSIDE, so f_bwd receives the cotangent in that layout.
    def f_fwd(m, v, c):
        ent = ktiled.prepare_entries(state, m, v, c, align_e, cfg)
        out = ktiled.tiled_forward(
            orders, kernel_period, D, C, sweep_f, ent, smp,
            block_n=block_n, block_e=block_e)  # columns >= N are zero
        return out, ent

    @jax.custom_vjp
    def f(m, v, c):
        return f_fwd(m, v, c)[0]

    def f_bwd(ent, g):
        dent = ktiled.tiled_backward(
            orders, kernel_period, D, C, sweep_b, ent, smp, g,
            block_n=bwd_block_n, block_e=bwd_block_e)
        # Segment-sum of entry gradients by gaussian id (replaces
        # backward.cu's atomicAdd scatter inside the kernel).
        d = jax.ops.segment_sum(dent.T, ent[0], num_segments=P + 1)[:P]
        return d[:, :D], d[:, D + tri:], d[:, D:D + tri]

    f.defvjp(f_fwd, f_bwd)
    packed_t = f(means, values, conics)    # (K*C, Np)

    if not padded_outputs:
        out = packed_t[:, :N].T            # (N, K*C)
        if not sorted_outputs:
            out = out[inv]
    return _unpack_orders(orders, packed_t if padded_outputs else out, N, D,
                          C, unique_outputs, padded_outputs)


def _unpack_orders(orders, packed, N, D, C, unique_outputs, padded_outputs):
    """Per-order outputs from the kernels' unique-component layout.

    ``packed`` is the component-major (K*C, Np) array when ``padded_outputs``,
    else the (N, K*C) row-major one.  Mirroring the unique (canonical
    i<=j<=k) components into the full symmetric tensors happens OUTSIDE the
    custom_vjp, so its transpose folds the duplicated positions' cotangents
    into the unique slots automatically (valid: every per-component VJP
    term is symmetric in the component's indices -
    formulas.vjp_params_folded)."""
    outs, k0 = [], 0
    for order in orders:
        nu = formulas.n_unique(order, D)
        if padded_outputs:
            # Raw component-major (nu, C, Np) canonical components - the layout
            # for reduction-style losses (pad columns are zero).
            outs.append(packed[k0 * C:(k0 + nu) * C, :].reshape(nu, C, -1))
            k0 += nu
            continue
        block = packed[:, k0 * C:(k0 + nu) * C].reshape(N, nu, C)
        if unique_outputs:
            # Skip the mirror: (N, n_unique, C) canonical components
            # (formulas.sym_indices order; sym_multiplicity gives the fold
            # weights).
            outs.append(block)
        else:
            fmap = formulas.full_to_unique(order, D)
            if len(fmap) != nu:
                block = block[:, jnp.asarray(fmap, jnp.int32), :]
            outs.append(block.reshape(out_shape(order, N, D, C)))
        k0 += nu
    return tuple(outs)


def sample_binned(cfg, means, values, conics, covariances, samples,
                  orders: Tuple[str, ...] = ALL_ORDERS,
                  sorted_outputs: bool = False,
                  unique_outputs: bool = False,
                  padded_outputs: bool = False,
                  sample_binning=None,
                  gaussian_binning=None):
    """Fully jit-compatible binned evaluation: builds the acceleration
    structure in-trace and returns (outputs dict, diagnostics dict).

    diagnostics["bin_overflow"] counts Gaussians whose footprint exceeded
    max_tiles_per_gaussian and diagnostics["entry_overflow"] entries beyond
    the static entry capacity.  Both must be zero for exact results (check
    them - this replaces the reference's reliance on dynamically sized
    buffers).

    ``sample_binning`` (binning.grid.bin_samples product) skips the
    parameter-independent sample sort when the query points are reused
    across steps.
    """
    from ..binning import grid as binning

    state = binning.build(cfg, means, covariances, samples,
                          sample_binning=sample_binning,
                          gaussian_binning=gaussian_binning)
    bn, be = cfg.block_n, cfg.block_p
    bbn, bbe = cfg.bwd_blocks
    outs = sample_tiled_multi(
        tuple(orders), cfg, means, values, conics, samples, state,
        binning.forward_geometry(state, bn, be),
        binning.backward_geometry(state, bbe, bbn),
        block_n=bn, block_e=be, bwd_block_n=bbn, bwd_block_e=bbe,
        sorted_outputs=sorted_outputs, unique_outputs=unique_outputs,
        padded_outputs=padded_outputs, unwrapped=cfg.unwrapped_kernels,
    )
    diag = {
        # With sorted_outputs, output row r corresponds to samples[perm[r]].
        "perm": state.s_perm if sorted_outputs else None,
        "bin_overflow": state.overflow,
        "entry_overflow": state.entry_overflow,
    }
    return dict(zip(orders, outs)), diag


def sample(order: str, means, values, conics, samples, *,
           period: Optional[float] = 2.0):
    """Public single-order entry point: all-pairs evaluation in XLA with
    the hand-derived VJP (small problems; large ones go through the binned
    paths)."""
    (out,) = sample_dense_multi((order,), period, means, values, conics,
                                samples)
    return out


def sample_all(means, values, conics, samples, *, period=2.0,
               orders: Sequence[str] = ALL_ORDERS):
    """Fused multi-order evaluation - one pairwise pass for all orders."""
    outs = sample_dense_multi(tuple(orders), period, means, values, conics,
                              samples)
    return dict(zip(orders, outs))
