"""Pair sweeps of the neighbor-aggregation subsystem, in plain jnp/lax.

The JAX counterpart of the CUDA aggregation kernels
(/root/reference/aggregate_neighbors.cu): findCollisions (18-55) +
preprocess (57-127) become a tile-binned pair sweep that computes the
per-center total density (``totals``); aggregateNeighbors (129-208) becomes
the center-chunk-major sweep (``forward``); aggregateNeighborsBackward
(210-321) becomes one entry-chunk-major sweep (``backward``) for the
per-neighbor gradients (features, keys) with per-item slabs for the
per-center / global ones (queries, distance_transform, frequencies).
Per-entry gradient rows are segment-summed by gaussian id outside; the LxL
transform and its gradient are single XLA matmuls outside (exact: the
transform is linear and applied per center).

Every sweep walks the same-tile (center-chunk x entry-chunk) work items of
an ``AggBinning`` (binning/chunked.work_list): items are evaluated in
batches of ITEM_BATCH (``lax.map``), each as a (block_n centers, block_e
entries) pair tile, and reduced per chunk with a segment sum - so no
per-pair table is materialized beyond one batch.  Because items are
same-tile by construction and pad slots gather the zero sentinel row
(radius 0), no per-pair tile comparison is needed - the alive-radius mask
alone is exact.

Semantics replicated exactly (same as ops/aggregation.py, which is pinned to
a numpy replica of the CUDA kernels in tests/test_aggregation.py):
  * collision iff |wrap(mu_j - mu_i)| <= 0.2 (r_i + r_j), both alive
    (aggregate_neighbors.cu:28-46, with the true minimum-image distance -
    the documented deviation of ops/aggregation.py);
  * density = exp(power) from the NEIGHBOR's conic on the unnormalized
    offset, zero when power > 0 (lines 107-120);
  * total-density normalization 1/(sum + 1e-6) (line 125) - a per-center
    scalar, carried in the center geometry for the forward and folded into
    the cotangent for the backward (every contribution of center i is linear
    in inv_total_i);
  * offsets normalized by 1/(0.333 r_i + 1e-6) before the sinusoidal code
    (lines 74-75); code layout dt[d*stride + 2e + {0,1}], biases at
    dt[E-1] / dt[2E-1] (lines 178-193).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..config import tri_size
from ..ops import formulas

# Work items evaluated together in one lax.map step.
ITEM_BATCH = 512

# Center-geometry column layout: mean (D), then r_eff / inv_norm / inv_tot,
# then the K query columns (the scalar tail sits before the queries so the
# totals kernel - which runs before queries exist - shares the layout).
C_REFF, C_INVNORM, C_INVTOT = 0, 1, 2


def _pair(D, period, ent, ctr):
    """Shared per-pair quantities: wrapped offsets X = mu_entry - mu_center
    and the density G zeroed outside the collision mask.  All pair arrays
    are (Bc centers, Be entries).  Work items pair same-tile chunks only,
    and pad slots carry the zero sentinel row (radius 0), so the
    alive-radius + distance mask is exact."""
    tri = tri_size(D)
    e = lambda row: ent[row, :][None, :]           # (1, Be)
    c = lambda col: ctr[:, col][:, None]           # (Bc, 1)
    Xs = [formulas.wrap(e(d) - c(d), period) for d in range(D)]
    con = [e(D + t) for t in range(tri)]
    G, _ = formulas.power_terms(Xs, con)
    r_j = e(D + tri)
    r_i = c(D + C_REFF)
    dist2 = sum(x * x for x in Xs)
    rr = r_i + r_j
    mask = (r_j >= 1e-6) & (r_i >= 1e-6) & (dist2 <= rr * rr)
    return Xs, jnp.where(mask, G, 0.0), e, c


def _sincode(D, nfreq, Xn, dtf, E, want_terms: bool,
             ladder: bool = False):
    """Sinusoidal positional code (aggregate_neighbors.cu:178-193).

    Returns (emb, fac, terms); terms[(d, e)] = (s, c, i0) kept only when the
    backward needs them for the dt/frequency gradients.

    ``ladder`` is the caller's certification that the frequencies form the
    exact integer ladder frequencies[e] == (e+1) * frequencies[0] (the
    standard sinusoidal-embedding parameterization, and how
    models/dynamics.py initializes them).  Then only the BASE phase needs
    transcendentals: sin/cos of every higher rung follow from the
    angle-addition recurrence s_{e+1} = s_e c_1 + c_e s_1,
    c_{e+1} = c_e c_1 - s_e s_1 (4 FMAs), which removes all but D of the
    2*nfreq*D per-pair sin/cos.  The frequency GRADIENTS are per-rung
    partials either way (the chain to a shared base scalar composes outside
    by autodiff)."""
    stride = (E - 1) // D
    shape = Xn[0].shape
    emb = jnp.full(shape, dtf[0, E - 1])
    fac = jnp.full(shape, dtf[0, 2 * E - 1])
    terms = {}
    for d in range(D):
        s = cs = s1 = c1 = None
        for e in range(nfreq):
            if ladder and e > 0:
                s, cs = s * c1 + cs * s1, cs * c1 - s * s1
            else:
                phase = (dtf[0, 2 * E + e] * jnp.pi) * Xn[d]
                s, cs = jnp.sin(phase), jnp.cos(phase)
                if ladder:
                    s1, c1 = s, cs
            i0 = d * stride + 2 * e
            emb = emb + s * dtf[0, i0] + cs * dtf[0, i0 + 1]
            fac = fac + s * dtf[0, E + i0] + cs * dtf[0, E + i0 + 1]
            if want_terms:
                terms[(d, e)] = (s, cs, i0)
    return emb, fac, terms


def _queries_w(D, L, K, ent_fk, c):
    """w = <q_i, k_j> unrolled over the K (static, small) channels as
    broadcast FMAs (aggregate_neighbors.cu:173-176).  Queries start at
    center column D + 3."""
    w = None
    for k in range(K):
        t = ent_fk[L + k, :][None, :] * c(D + 3 + k)
        w = t if w is None else w + t
    return w


def _dotg(a, b):
    """(Bc, X) @ (X, Be) with fp32 accumulate."""
    return jax.lax.dot_general(
        a, b, (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )


def _dot_nt(a, b):
    """Contract the last dims of both operands: (Bc, Be) x (X, Be) ->
    (Bc, X)."""
    return jax.lax.dot_general(
        a, b, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )


def _dot_tn(a, b):
    """Contract the first dims of both operands: (Bc, X) x (Bc, Be) ->
    (X, Be)."""
    return jax.lax.dot_general(
        a, b, (((0,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )


def _racc(acc, x):
    return x if acc is None else acc + x


# ---------------------------------------------------------------------------
# Item sweeps
# ---------------------------------------------------------------------------


def _sweep(item_fn, wl, *, block_n: int, block_e: int, ent_geo, ent_fk,
           ctr_geo, row_is_center: bool, extra=()):
    """Evaluate ``item_fn`` on every work item of ``wl`` = (aux, col),
    ITEM_BATCH items at a time.  Items of a center-chunk-major list have
    row = center chunk and col = entry chunk; an entry-chunk-major list the
    reverse.  ``extra`` are (Cp, X) per-center operands blocked like the
    center geometry.  Returns item_fn's per-item outputs, zeroed on items
    that carry no work."""
    aux, col = wl
    row = aux >> 2
    compute = (aux & 1) != 0
    c_chunk, e_chunk = (row, col) if row_is_center else (col, row)
    EB = ent_geo.shape[1] // block_e
    CB = ctr_geo.shape[0] // block_n
    eg = ent_geo.reshape(ent_geo.shape[0], EB, block_e).transpose(1, 0, 2)
    ef = ent_fk.reshape(ent_fk.shape[0], EB, block_e).transpose(1, 0, 2)
    cg = ctr_geo.reshape(CB, block_n, ctr_geo.shape[1])
    ex = [x.reshape(CB, block_n, x.shape[1]) for x in extra]

    def one(item):
        ci, ei, live = item
        outs = item_fn(eg[ei], ef[ei], cg[ci], *[x[ci] for x in ex])
        return jax.tree.map(lambda o: jnp.where(live, o, 0.0), outs)

    return jax.lax.map(one, (c_chunk, e_chunk, compute),
                       batch_size=ITEM_BATCH)


def _per_chunk(item_rows, chunk, n_chunks):
    """Sum per-item (W, block, X) rows into (n_chunks * block, X)."""
    W, B, X = item_rows.shape
    return jax.ops.segment_sum(item_rows, chunk, num_segments=n_chunks
                               ).reshape(n_chunks * B, X)


# ---------------------------------------------------------------------------
# Totals (preprocess): per-center sum of neighbor densities
# ---------------------------------------------------------------------------


def totals(D: int, period, wl, ent_geo, ctr_geo,
           *, block_n: int, block_e: int) -> jnp.ndarray:
    """(Cp, 1) per-center total density (aggregate_neighbors.cu:120-125).
    ``ctr_geo``'s inv_tot column is not read (it is what this computes)."""
    def item(eg, ef, cg):
        _, G, _, _ = _pair(D, period, eg, cg)
        return jnp.sum(G, axis=1, keepdims=True)

    per_item = _sweep(item, wl, block_n=block_n, block_e=block_e,
                      ent_geo=ent_geo, ent_fk=ent_geo, ctr_geo=ctr_geo,
                      row_is_center=True)
    return _per_chunk(per_item, wl[0] >> 2, ctr_geo.shape[0] // block_n)


# ---------------------------------------------------------------------------
# Forward: raw pre-activation rows per center
# ---------------------------------------------------------------------------


def forward(D: int, L: int, K: int, nfreq: int, period,
            wl, ent_geo, ent_fk, ctr_geo, dtf,
            *, block_n: int, block_e: int,
            ladder: bool = False, with_totals: bool = False):
    """(Cp, L) raw pre-activation (before the LxL transform - one XLA
    matmul outside, exact because the transform is linear).

    ``with_totals`` additionally returns the (Cp, 1) per-center total
    density from the SAME pair sweep (the structure's inv_tot column must
    then be 1.0; the caller applies the normalization outside - every
    center's row is linear in its inv_total)."""
    E = (dtf.shape[1] - nfreq) // 2

    def item(eg, ef, cg):
        Xs, G, e, c = _pair(D, period, eg, cg)
        w = _queries_w(D, L, K, ef, c)
        inv_norm = c(D + C_INVNORM)
        inv_tot = c(D + C_INVTOT)
        Xn = [x * inv_norm for x in Xs]
        emb, fac, _ = _sincode(D, nfreq, Xn, dtf, E, False, ladder)
        coeff = G * w * inv_tot                      # (Bc, Be)
        # pre[c, l] = sum_e (coeff * fac)[c, e] * feat[l, e], plus the
        # embedding's broadcast column (the same scalar feeds every output
        # channel - aggregate_neighbors.cu:198-205).
        pre = (_dot_nt(coeff * fac, ef[:L, :])
               + jnp.sum(coeff * emb, axis=1, keepdims=True))
        if with_totals:
            return pre, jnp.sum(G, axis=1, keepdims=True)
        return pre

    per_item = _sweep(item, wl, block_n=block_n, block_e=block_e,
                      ent_geo=ent_geo, ent_fk=ent_fk, ctr_geo=ctr_geo,
                      row_is_center=True)
    CB = ctr_geo.shape[0] // block_n
    rows = wl[0] >> 2
    if with_totals:
        return (_per_chunk(per_item[0], rows, CB),
                _per_chunk(per_item[1], rows, CB))
    return _per_chunk(per_item, rows, CB)


# ---------------------------------------------------------------------------
# Backward: ONE fused entry-chunk-major sweep for all parameter gradients
# ---------------------------------------------------------------------------


def backward(D: int, L: int, K: int, nfreq: int, period,
             wl, ent_geo, ent_fk, ctr_geo, dtf, gpre, gsum,
             *, block_n: int, block_e: int, ladder: bool = False):
    """One fused backward sweep over the entry-chunk-major work list
    (aggregateNeighborsBackward, aggregate_neighbors.cu:210-321).

    Returns (dent, slab):
      dent (L + K, Ep)   per-entry gradient rows (dfeatures, dkeys); the
        caller segment-sums by gaussian id.
      slab (W * block_n, K + 2E + nfreq)   per-work-item center gradient
        columns (dqueries, then d(distance_transform) / d(frequencies)
        partial sums); the caller segment-sums by the item's center chunk
        (wl col) and reduces the code columns over centers.
    ``gpre``/(Cp, L) is the transform-chained cotangent, ALREADY scaled by
    inv_total per center; ``gsum`` is its (Cp, 1) channel sum."""
    E = (dtf.shape[1] - nfreq) // 2

    def item(eg, ef, cg, gp, gs):
        Xs, G, e, c = _pair(D, period, eg, cg)
        w = _queries_w(D, L, K, ef, c)
        inv_norm = c(D + C_INVNORM)
        Xn = [x * inv_norm for x in Xs]
        emb, fac, terms = _sincode(D, nfreq, Xn, dtf, E, True, ladder)
        # The cotangent arrives pre-scaled by inv_tot_i (see module
        # docstring), so coeff here is G * w only.
        cf = G * w * fac                             # (Bc, Be)
        # dL/dfeat_j[l] = sum_i gpre[i, l] * cf[i, j]
        dfeat = _dot_tn(gp, cf)                      # (L, Be)
        # gdotf[i, j] = sum_l gpre[i, l] * feat[l, j]
        gdotf = _dotg(gp, ef[:L, :])                 # (Bc, Be)
        dw = G * (fac * gdotf + emb * gs)
        # dL/dkey_j[k] = sum_i dw[i, j] * q_i[k]
        dkey_rows = [
            jnp.sum(c(D + 3 + k) * dw, axis=0, keepdims=True)
            for k in range(K)
        ]
        dent = jnp.concatenate([dfeat] + dkey_rows, axis=0)

        # Center-side columns: dq, then the per-pair cotangents of the
        # codes (aggregate_neighbors.cu:270-317), reduced per center.
        cols = [
            jnp.sum(ef[L + k, :][None, :] * dw, axis=1, keepdims=True)
            for k in range(K)
        ]
        cw = G * w
        cemb = cw * gs                               # (Bc, Be)
        cfac = cw * gdotf
        ddt = [None] * (2 * E)
        dfreq = [None] * nfreq
        for d in range(D):
            for ee in range(nfreq):
                s, cs, i0 = terms[(d, ee)]
                ddt[i0] = _racc(ddt[i0], cemb * s)
                ddt[i0 + 1] = _racc(ddt[i0 + 1], cemb * cs)
                ddt[E + i0] = _racc(ddt[E + i0], cfac * s)
                ddt[E + i0 + 1] = _racc(ddt[E + i0 + 1], cfac * cs)
                dphase = (cemb * (cs * dtf[0, i0] - s * dtf[0, i0 + 1])
                          + cfac * (cs * dtf[0, E + i0]
                                    - s * dtf[0, E + i0 + 1]))
                dfreq[ee] = _racc(dfreq[ee], dphase * (jnp.pi * Xn[d]))
        ddt[E - 1] = _racc(ddt[E - 1], cemb)
        ddt[2 * E - 1] = _racc(ddt[2 * E - 1], cfac)
        zero = jnp.zeros_like(cols[0])
        for t in ddt + dfreq:
            cols.append(zero if t is None else
                        jnp.sum(t, axis=1, keepdims=True))
        return dent, jnp.concatenate(cols, axis=1)

    dent_items, slab = _sweep(
        item, wl, block_n=block_n, block_e=block_e, ent_geo=ent_geo,
        ent_fk=ent_fk, ctr_geo=ctr_geo, row_is_center=False,
        extra=(gpre, gsum))
    EB = ent_geo.shape[1] // block_e
    dent = jax.ops.segment_sum(dent_items, wl[0] >> 2, num_segments=EB)
    dent = dent.transpose(1, 0, 2).reshape(L + K, EB * block_e)
    return dent, slab.reshape(-1, slab.shape[-1])
