"""Closed-form per-pair Gaussian evaluation weights and their VJPs.

This is the single source of truth for the math of all four sampling ops.  It
replicates the semantics of the CUDA reference's inlined device functions
(forward: /root/reference/cuda_sampler/forward.cu:168-275, backward:
/root/reference/cuda_sampler/backward.cu:108-416) generalized from D in {1,2}
to D in {1,2,3}:

  field           u(x)    = sum_i v_i * G_i(x),  G = exp(-1/2 X^T C X)
  value           w       = G
  derivative      w_d     = G * a_d                      (d/dx_d, sample coords)
  laplacian       w_ij    = G * (a_i a_j - C_ij)         (full Hessian d2/dx_i dx_j)
  third           w_ijk   = G * (C_ij a_k + C_ik a_j + C_jk a_i - a_i a_j a_k)

where X = wrap(mu - x) and a = C X.  Note the reference's "third derivative"
is the NEGATIVE of d3G/dx3 (equivalently the third derivative w.r.t. the mean
mu); see forward.cu:247 (D=1: 3*c*x1 - x1^3 = -(x1^3 - 3*c*x1)).  We replicate
that sign exactly.

The reference skips any pair whose quadratic form is positive (non-PSD conic;
forward.cu:171 ``if (power > 0.0) return``); we replicate with a mask.

All functions operate on *lists* of arrays with the spatial dimension D and
the packed-triangular dimension unrolled in Python, so a kernel holds every
per-pair quantity as its own (rows, cols) tile instead of a tile with a
trailing axis of size D.  Conics are packed upper-triangular
row-major, e.g. D=2: [c_xx, c_xy, c_yy] (forward.cu:177).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import jax.numpy as jnp

from ..config import tri_index, tri_size


def wrap(X, period: Optional[float]):
    """Minimum-image displacement on a torus of the given period.

    Branch-free equivalent of the reference's fmod-based wrap
    (forward.cu:149-157): maps X into [-period/2, period/2].  Written with
    floor (not round) so the same expression lowers inside the pair
    kernels.
    """
    if period is None:
        return X
    return X - period * jnp.floor(X * (1.0 / period) + 0.5)


def conic_apply(Xs: Sequence, con: Sequence, D: int) -> List:
    """a = C @ X for packed-triangular C; returns list of D arrays."""
    return [
        sum(con[tri_index(D, l, m)] * Xs[m] for m in range(D)) for l in range(D)
    ]


def power_terms(Xs: Sequence, con: Sequence):
    """Returns (G, a) for a batch of pairs.

    G = exp(-1/2 X^T C X), masked to zero where the quadratic form is positive
    (backward.cu:114 ``if (power > 0.0) return``).
    """
    D = len(Xs)
    a = conic_apply(Xs, con, D)
    power = sum(a[l] * Xs[l] for l in range(D)) * (-0.5)
    G = jnp.where(power > 0, 0.0, jnp.exp(jnp.minimum(power, 0.0)))
    return G, a


def components(order: str, Xs: Sequence, con: Sequence, G, a) -> List:
    """Per-pair evaluation weights, row-major over tensor indices.

    Matches forward.cu:168-275 component ordering (e.g. the Hessian is emitted
    row-major with symmetric off-diagonals duplicated, forward.cu:231-234).
    """
    D = len(Xs)
    C = lambda i, j: con[tri_index(D, i, j)]
    if order == "value":
        return [G]
    if order == "derivative":
        return [G * a[i] for i in range(D)]
    if order == "laplacian":
        return [G * (a[i] * a[j] - C(i, j)) for i in range(D) for j in range(D)]
    if order == "third":
        return [
            G
            * (
                C(i, j) * a[k]
                + C(i, k) * a[j]
                + C(j, k) * a[i]
                - a[i] * a[j] * a[k]
            )
            for i in range(D)
            for j in range(D)
            for k in range(D)
        ]
    raise ValueError(f"unknown order {order!r}")


def sym_indices(order: str, D: int) -> List[tuple]:
    """Canonical (sorted) index tuples of the order's unique components.

    The evaluation tensors are totally symmetric (the Hessian and third
    tensors of a scalar field commute derivatives; forward.cu:231-234 emits
    the duplicates explicitly), so kernels compute only i<=j<=k and the
    public layer mirrors."""
    if order == "value":
        return [()]
    if order == "derivative":
        return [(i,) for i in range(D)]
    if order == "laplacian":
        return [(i, j) for i in range(D) for j in range(i, D)]
    if order == "third":
        return [
            (i, j, k)
            for i in range(D)
            for j in range(i, D)
            for k in range(j, D)
        ]
    raise ValueError(f"unknown order {order!r}")


def n_unique(order: str, D: int) -> int:
    return len(sym_indices(order, D))


def full_to_unique(order: str, D: int) -> List[int]:
    """Unique-component index for each full row-major component position."""
    uniq = {t: n for n, t in enumerate(sym_indices(order, D))}
    if order == "value":
        return [0]
    if order == "derivative":
        return [uniq[(i,)] for i in range(D)]
    if order == "laplacian":
        return [
            uniq[tuple(sorted((i, j)))] for i in range(D) for j in range(D)
        ]
    if order == "third":
        return [
            uniq[tuple(sorted((i, j, k)))]
            for i in range(D)
            for j in range(D)
            for k in range(D)
        ]
    raise ValueError(f"unknown order {order!r}")


def sym_multiplicity(order: str, D: int) -> List[int]:
    """How many full-tensor positions each unique component mirrors to."""
    from collections import Counter

    cnt = Counter(full_to_unique(order, D))
    return [cnt[u] for u in range(n_unique(order, D))]


def unique_diag_indices(D: int) -> List[int]:
    """Unique-component indices of the Hessian diagonal (for traces)."""
    uniq = {t: n for n, t in enumerate(sym_indices("laplacian", D))}
    return [uniq[(d, d)] for d in range(D)]


def _component_weight(order, idx, C, a, G):
    """The per-pair weight of one component, by index tuple."""
    if order == "value":
        return G
    if order == "derivative":
        (i,) = idx
        return G * a[i]
    if order == "laplacian":
        i, j = idx
        return G * (a[i] * a[j] - C(i, j))
    i, j, k = idx
    return G * (
        C(i, j) * a[k] + C(i, k) * a[j] + C(j, k) * a[i]
        - a[i] * a[j] * a[k]
    )


def components_unique(order: str, Xs: Sequence, con: Sequence, G, a) -> List:
    """Per-pair weights of the unique (canonical-index) components only."""
    D = len(Xs)
    C = lambda i, j: con[tri_index(D, i, j)]
    return [_component_weight(order, t, C, a, G) for t in sym_indices(order, D)]


def component_polys(order: str, Xs: Sequence, con: Sequence, a) -> List:
    """The unique components' pre-exponential polynomials (T_u / G).

    components_unique == [G * p for p in component_polys]; kernels that need
    both the weights and the polynomials (the backward reuses the laplacian
    polynomials inside vjp_params_fused's S0) compute the polys once."""
    D = len(Xs)
    C = lambda i, j: con[tri_index(D, i, j)]
    if order == "value":
        return [1.0]
    if order == "derivative":
        return [a[i] for i in range(D)]
    if order == "laplacian":
        return [a[i] * a[j] - C(i, j) for i, j in sym_indices(order, D)]
    if order == "third":
        return [
            C(i, j) * a[k] + C(i, k) * a[j] + C(j, k) * a[i]
            - a[i] * a[j] * a[k]
            for i, j, k in sym_indices(order, D)
        ]
    raise ValueError(f"unknown order {order!r}")


def vjp_params_folded(order: str, Xs: Sequence, con: Sequence, G, a,
                      hs: Sequence):
    """vjp_params over unique components with FOLDED cotangents.

    ``hs[u]`` must already hold the sum of the full tensor's cotangents over
    every position that mirrors unique component u (the expansion's transpose
    does this fold automatically when the mirror happens outside the
    custom_vjp).  Valid because every per-component VJP term is symmetric in
    the component's indices."""
    D = len(Xs)
    tri = tri_size(D)
    C = lambda i, j: con[tri_index(D, i, j)]
    s = _power_dcon(Xs, D)
    da = _a_dcon(Xs, D)

    dmu = [0.0] * D
    dcon = [0.0] * tri

    for idx, h in zip(sym_indices(order, D), hs):
        hG = h * G
        if order == "value":
            for d in range(D):
                dmu[d] = dmu[d] - hG * a[d]
            for t in range(tri):
                dcon[t] = dcon[t] + hG * s[t]
        elif order == "derivative":
            (i,) = idx
            for d in range(D):
                dmu[d] = dmu[d] + hG * (C(i, d) - a[d] * a[i])
            for t in range(tri):
                dcon[t] = dcon[t] + hG * (s[t] * a[i] + da[i][t])
        elif order == "laplacian":
            i, j = idx
            p = a[i] * a[j] - C(i, j)
            for d in range(D):
                dmu[d] = dmu[d] + hG * (
                    C(i, d) * a[j] + C(j, d) * a[i] - a[d] * p
                )
            tij = tri_index(D, i, j)
            for t in range(tri):
                dp = da[i][t] * a[j] + da[j][t] * a[i]
                if t == tij:
                    dp = dp - 1.0
                dcon[t] = dcon[t] + hG * (s[t] * p + dp)
        else:  # third
            i, j, k = idx
            p = (
                C(i, j) * a[k] + C(i, k) * a[j] + C(j, k) * a[i]
                - a[i] * a[j] * a[k]
            )
            for d in range(D):
                dp_dmu = (
                    C(i, j) * C(k, d)
                    + C(i, k) * C(j, d)
                    + C(j, k) * C(i, d)
                    - C(i, d) * a[j] * a[k]
                    - a[i] * C(j, d) * a[k]
                    - a[i] * a[j] * C(k, d)
                )
                dmu[d] = dmu[d] + hG * (dp_dmu - a[d] * p)
            tij = tri_index(D, i, j)
            tik = tri_index(D, i, k)
            tjk = tri_index(D, j, k)
            for t in range(tri):
                dp = (
                    C(i, j) * da[k][t]
                    + C(i, k) * da[j][t]
                    + C(j, k) * da[i][t]
                    - da[i][t] * a[j] * a[k]
                    - a[i] * da[j][t] * a[k]
                    - a[i] * a[j] * da[k][t]
                )
                if t == tij:
                    dp = dp + a[k]
                if t == tik:
                    dp = dp + a[j]
                if t == tjk:
                    dp = dp + a[i]
                dcon[t] = dcon[t] + hG * (s[t] * p + dp)
    return dmu, dcon


def _power_dcon(Xs: Sequence, D: int) -> List:
    """d(power)/d(c_t) for each packed index t.

    t=(u,u): -1/2 X_u^2 ; t=(u,v), u<v: -X_u X_v (the off-diagonal appears
    twice in X^T C X; cf. backward.cu:150-152).
    """
    out = [None] * tri_size(D)
    for u in range(D):
        for v in range(u, D):
            t = tri_index(D, u, v)
            if u == v:
                out[t] = -0.5 * Xs[u] * Xs[u]
            else:
                out[t] = -(Xs[u] * Xs[v])
    return out


def _a_dcon(Xs: Sequence, D: int):
    """da_l/dc_t as a [l][t] table of arrays-or-0.0.

    t=(u,u): delta_{lu} X_u ; t=(u,v): delta_{lu} X_v + delta_{lv} X_u.
    """
    table = [[0.0] * tri_size(D) for _ in range(D)]
    for u in range(D):
        for v in range(u, D):
            t = tri_index(D, u, v)
            if u == v:
                table[u][t] = Xs[u]
            else:
                table[u][t] = Xs[v]
                table[v][t] = Xs[u]
    return table


def fused_pair_accumulators(orders: Sequence[str], con: Sequence, a,
                            hs: Sequence,
                            lap_polys: Optional[Sequence] = None,
                            third_polys: Optional[Sequence] = None):
    """The collapsed multi-order VJP's shared per-pair accumulators.

    Returns (S0, w, hl, Y) - see vjp_params_fused's derivation: S0 is the
    h-weighted component-polynomial sum, w[l] the h-weighted dq/da_l sums,
    hl the folded laplacian cotangents (by packed index, None where absent),
    Y the thirds' explicit conic-derivative terms.  Everything is a function
    of (con, a, hs) only - no X."""
    D = len(a)

    tri = tri_size(D)
    C = lambda i, j: con[tri_index(D, i, j)]

    h0 = None
    hd = [None] * D
    hl = [None] * tri
    h3 = {}  # unique tuple (i<=j<=k) -> folded cotangent
    k0 = 0
    for order in orders:
        nu = n_unique(order, D)
        block = hs[k0:k0 + nu]
        if order == "value":
            h0 = block[0]
        elif order == "derivative":
            for i in range(D):
                hd[i] = block[i]
        elif order == "laplacian":
            for t, (i, j) in enumerate(sym_indices(order, D)):
                hl[tri_index(D, i, j)] = block[t]
        elif order == "third":
            for t, idx in enumerate(sym_indices(order, D)):
                h3[idx] = block[t]
        else:
            raise ValueError(f"unknown order {order!r}")
        k0 += nu

    def acc(x, y):
        return y if x is None else x + y

    # Shared polynomials (component_polys layout).
    lp = {}
    if lap_polys is not None:
        lp = dict(zip(sym_indices("laplacian", D), lap_polys))

    def q_pair(i, j):
        key = (i, j) if i <= j else (j, i)
        if key not in lp:
            lp[key] = a[i] * a[j] - C(i, j)
        return lp[key]

    tp = {}
    if third_polys is not None:
        tp = dict(zip(sym_indices("third", D), third_polys))

    def p_third(idx):
        # The reference's third polynomial = -q_ijk (forward.cu:247).
        if idx not in tp:
            i, j, k = idx
            tp[idx] = (C(i, j) * a[k] + C(i, k) * a[j] + C(j, k) * a[i]
                       - a[i] * a[j] * a[k])
        return tp[idx]

    # S0 = sum_u h~_u q_u  (third: h~ q = (-h)(-p_ref) = h p_ref).
    S0 = h0
    for i in range(D):
        if hd[i] is not None:
            S0 = acc(S0, hd[i] * a[i])
    if any(h is not None for h in hl):
        for u in range(D):
            for v in range(u, D):
                S0 = acc(S0, hl[tri_index(D, u, v)] * q_pair(u, v))
    for idx, h in h3.items():
        S0 = acc(S0, h * p_third(idx))

    # W_l = sum_u h~_u dq_u/da_l: derivative gives hd_l, laplacian gives
    # (H a)_l with doubled diagonal, third gives -h3_ijk (delta_il q_jk +
    # delta_jl q_ik + delta_kl q_ij).
    w = [None] * D
    for l in range(D):
        wl = hd[l]
        for m in range(D):
            t = tri_index(D, l, m)
            if hl[t] is not None:
                scale = 2.0 if l == m else 1.0
                wl = acc(wl, (scale * hl[t]) * a[m])
        w[l] = wl
    for (i, j, k), h in h3.items():
        nh = -h
        w[i] = acc(w[i], nh * q_pair(j, k))
        w[j] = acc(w[j], nh * q_pair(i, k))
        w[k] = acc(w[k], nh * q_pair(i, j))

    # Y_t: the thirds' explicit conic derivatives (+a at matching pairs,
    # backward.cu:300-416's "dp += a" terms).
    Y = [None] * tri
    for (i, j, k), h in h3.items():
        Y[tri_index(D, i, j)] = acc(Y[tri_index(D, i, j)], h * a[k])
        Y[tri_index(D, i, k)] = acc(Y[tri_index(D, i, k)], h * a[j])
        Y[tri_index(D, j, k)] = acc(Y[tri_index(D, j, k)], h * a[i])

    return S0, w, hl, Y


def vjp_params_fused(orders: Sequence[str], Xs: Sequence, con: Sequence,
                     G, a, hs: Sequence,
                     lap_polys: Optional[Sequence] = None,
                     third_polys: Optional[Sequence] = None):
    """Collapsed multi-order VJP across any subset of the four orders.

    ``hs`` is the flat list of FOLDED unique-component cotangents across
    ``orders`` in sequence (same layout the tiled backward kernel holds).

    Derivation: every component is a spatial derivative of G
    (T_u = G q_u with q_0 = 1, q_i = a_i, q_ij = a_i a_j - C_ij,
    q_ijk = a_i a_j a_k - C_ij a_k - C_ik a_j - C_jk a_i; the reference's
    "third" component is -q_ijk, forward.cu:247), dT_u/dmu_d = -T_{u,d}, and
    q_{u,d} = a_d q_u - sum_l C_ld dq_u/da_l, so the weighted cotangent sum
    telescopes into shared accumulators:

        S0    = sum_u h~_u q_u          (h~ = h, except third: h~ = -h)
        W_l   = sum_u h~_u dq_u/da_l
        dmu_d = G ((C W)_d - a_d S0)
        z_l   = W_l - 1/2 X_l S0
        dcon_(u,v) = G (X_v z_u + X_u z_v - hl_uv + Y_uv)

    where Y collects the thirds' explicit conic derivatives
    (Y_t = sum_{(ijk)} h_ijk (delta_(ij),t a_k + delta_(ik),t a_j
    + delta_(jk),t a_i)).  This reproduces backward.cu:108-416 exactly (see
    vjp_params) with ~3x fewer per-pair elementwise ops - the per-pair loop
    is the whole backward hot loop (SURVEY.md 3.3).

    ``lap_polys``/``third_polys`` (component_polys products) may be passed to
    share the polynomial terms with the caller's forward-weight recompute.
    """
    D = len(Xs)
    tri = tri_size(D)
    C = lambda i, j: con[tri_index(D, i, j)]

    def acc(x, y):
        return y if x is None else x + y

    S0, w, hl, Y = fused_pair_accumulators(
        orders, con, a, hs, lap_polys, third_polys)

    half_S0 = 0.5 * S0

    dmu = []
    for d in range(D):
        md = None
        for l in range(D):
            if w[l] is not None:
                md = acc(md, C(d, l) * w[l])
        md = acc(md, -(a[d] * S0))
        dmu.append(G * md)

    z = [
        (-(Xs[l] * half_S0)) if w[l] is None else (w[l] - Xs[l] * half_S0)
        for l in range(D)
    ]
    dcon = [None] * tri
    for u in range(D):
        for v in range(u, D):
            t = tri_index(D, u, v)
            if u == v:
                term = Xs[u] * z[u]
            else:
                term = Xs[v] * z[u] + Xs[u] * z[v]
            if hl[t] is not None:
                term = term - hl[t]
            if Y[t] is not None:
                term = term + Y[t]
            dcon[t] = G * term
    return dmu, dcon


def vjp_params(order: str, Xs: Sequence, con: Sequence, G, a, hs: Sequence):
    """Per-pair VJP contributions to (d mu, d conic).

    ``hs`` is the list (one per component, same order as ``components``) of the
    per-pair cotangents already contracted over channels:
    h_comp = sum_c values[c] * dL/dout[comp, c]  (the ``dL_dG`` accumulators of
    backward.cu:118-123, 188-197, 252-268, 344-375).

    Returns (dmu, dcon): lists of D and tri_size(D) per-pair arrays.  The
    caller reduces over the sample axis and handles dL/dvalues separately
    (dL_dvalues = sum over pairs of component_weight * dL/dout, cf.
    backward.cu:121).

    Derivation: for each component w = G * p(a, C),
      dw/dmu_d = G * (-a_d * p + dp/dmu_d),   da_l/dmu_d = C_{ld}
      dw/dc_t  = G * (s_t * p + dp/dc_t),     s_t = d(power)/dc_t
    which reproduces the reference's hand-derived forms (e.g. backward.cu:174:
    dL_dx = (x1^2 - c) * dL_dG * G with the sign flip applied at the
    accumulate, backward.cu:176 ``atomicAdd(dL_dmeans, -dL_dx)``).
    """
    D = len(Xs)
    tri = tri_size(D)
    C = lambda i, j: con[tri_index(D, i, j)]
    s = _power_dcon(Xs, D)
    da = _a_dcon(Xs, D)

    dmu = [0.0] * D
    dcon = [0.0] * tri

    if order == "value":
        h = hs[0]
        hG = h * G
        for d in range(D):
            dmu[d] = dmu[d] - hG * a[d]
        for t in range(tri):
            dcon[t] = dcon[t] + hG * s[t]
        return dmu, dcon

    if order == "derivative":
        for i in range(D):
            hG = hs[i] * G
            for d in range(D):
                dmu[d] = dmu[d] + hG * (C(i, d) - a[d] * a[i])
            for t in range(tri):
                dcon[t] = dcon[t] + hG * (s[t] * a[i] + da[i][t])
        return dmu, dcon

    if order == "laplacian":
        for i in range(D):
            for j in range(D):
                h = hs[i * D + j]
                hG = h * G
                p = a[i] * a[j] - C(i, j)
                for d in range(D):
                    dmu[d] = dmu[d] + hG * (
                        C(i, d) * a[j] + C(j, d) * a[i] - a[d] * p
                    )
                tij = tri_index(D, i, j)
                for t in range(tri):
                    dp = da[i][t] * a[j] + da[j][t] * a[i]
                    if t == tij:
                        dp = dp - 1.0
                    dcon[t] = dcon[t] + hG * (s[t] * p + dp)
        return dmu, dcon

    if order == "third":
        for i in range(D):
            for j in range(D):
                for k in range(D):
                    h = hs[(i * D + j) * D + k]
                    hG = h * G
                    p = (
                        C(i, j) * a[k]
                        + C(i, k) * a[j]
                        + C(j, k) * a[i]
                        - a[i] * a[j] * a[k]
                    )
                    for d in range(D):
                        dp_dmu = (
                            C(i, j) * C(k, d)
                            + C(i, k) * C(j, d)
                            + C(j, k) * C(i, d)
                            - C(i, d) * a[j] * a[k]
                            - a[i] * C(j, d) * a[k]
                            - a[i] * a[j] * C(k, d)
                        )
                        dmu[d] = dmu[d] + hG * (dp_dmu - a[d] * p)
                    tij = tri_index(D, i, j)
                    tik = tri_index(D, i, k)
                    tjk = tri_index(D, j, k)
                    for t in range(tri):
                        dp = (
                            C(i, j) * da[k][t]
                            + C(i, k) * da[j][t]
                            + C(j, k) * da[i][t]
                            - da[i][t] * a[j] * a[k]
                            - a[i] * da[j][t] * a[k]
                            - a[i] * a[j] * da[k][t]
                        )
                        if t == tij:
                            dp = dp + a[k]
                        if t == tik:
                            dp = dp + a[j]
                        if t == tjk:
                            dp = dp + a[i]
                        dcon[t] = dcon[t] + hG * (s[t] * p + dp)
        return dmu, dcon

    raise ValueError(f"unknown order {order!r}")
