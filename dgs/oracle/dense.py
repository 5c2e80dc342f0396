"""Dense O(N*P) jnp oracle for Gaussian mixture evaluation.

The correctness anchor for every kernel: pure jnp (differentiable by JAX
autodiff, so its gradients independently validate the hand-derived VJPs in
``ops/formulas.py`` and the pair kernels).  Mirrors the evaluation semantics
of the CUDA reference's render kernels (forward.cu:88-275) without the tile
binning: every (sample, gaussian) pair contributes, unless ``pair_mask``
restricts pairs to emulate a binning structure.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from ..config import n_components, out_shape, tri_size
from ..ops import formulas


def evaluate(
    order: str,
    means: jnp.ndarray,  # (P, D)
    values: jnp.ndarray,  # (P, C)
    conics: jnp.ndarray,  # (P, tri_size(D))
    samples: jnp.ndarray,  # (N, D)
    *,
    period: Optional[float] = 2.0,
    pair_mask: Optional[jnp.ndarray] = None,  # (N, P) bool
) -> jnp.ndarray:
    """Evaluate one derivative order at all sample points.

    Output shapes match the reference allocations (sample_points.cu:215, 240,
    265, 290): value (N,C), derivative (N,D,C), laplacian (N,D,D,C),
    third (N,D,D,D,C).
    """
    N, D = samples.shape
    P, C = values.shape
    X = formulas.wrap(means[None, :, :] - samples[:, None, :], period)  # (N,P,D)
    Xs = [X[..., d] for d in range(D)]
    con = [conics[None, :, t] for t in range(tri_size(D))]
    G, a = formulas.power_terms(Xs, con)
    if pair_mask is not None:
        G = G * pair_mask.astype(G.dtype)
    comps = formulas.components(order, Xs, con, G, a)
    W = jnp.stack(comps, axis=1)  # (N, n_comp, P)
    out = jnp.einsum("nkp,pc->nkc", W, values,
                     precision=jax.lax.Precision.HIGHEST)
    return out.reshape(out_shape(order, N, D, C))


def evaluate_all(means, values, conics, samples, *, period=2.0, pair_mask=None):
    """All four orders with one pairwise pass (shared G / a)."""
    return {
        order: evaluate(
            order, means, values, conics, samples, period=period, pair_mask=pair_mask
        )
        for order in ("value", "derivative", "laplacian", "third")
    }


def radii(covariances: jnp.ndarray, D: int, radius_sigma: float = 3.0,
          eig_floor: float = 1e-6) -> jnp.ndarray:
    """Per-Gaussian footprint radius = radius_sigma * sqrt(lambda_max(cov)).

    Replicates forward.cu:52-61 for D in {1,2} (including the det==0 cull that
    leaves the radius at zero) and generalizes to D=3 with the trigonometric
    closed form for symmetric 3x3 eigenvalues.
    """
    cov = covariances
    if D == 1:
        return radius_sigma * jnp.sqrt(jnp.maximum(cov[:, 0], 0.0))
    if D == 2:
        det = cov[:, 0] * cov[:, 2] - cov[:, 1] ** 2
        mid = 0.5 * (cov[:, 0] + cov[:, 2])
        lam = mid + jnp.sqrt(jnp.maximum(eig_floor, mid * mid - det))
        r = radius_sigma * jnp.sqrt(jnp.maximum(lam, 0.0))
        # Reference culls det == 0 exactly (forward.cu:55-57); under XLA the
        # product fuses into an FMA whose rounding differs from eager mode, so
        # an exactly-singular matrix can yield det = +/-eps.  Use a relative
        # epsilon so the cull is robust to fusion.
        scale = jnp.abs(cov[:, 0] * cov[:, 2]) + cov[:, 1] ** 2 + 1e-30
        return jnp.where(jnp.abs(det) <= 1e-6 * scale, 0.0, r)
    if D == 3:
        # Packed [c00,c01,c02,c11,c12,c22].
        A00, A01, A02, A11, A12, A22 = (cov[:, t] for t in range(6))
        q = (A00 + A11 + A22) / 3.0
        B00, B11, B22 = A00 - q, A11 - q, A22 - q
        p2 = (
            B00 * B00 + B11 * B11 + B22 * B22
            + 2.0 * (A01 * A01 + A02 * A02 + A12 * A12)
        ) / 6.0
        p = jnp.sqrt(jnp.maximum(p2, 1e-30))
        # det(B)/2 with B = (A - q I)
        detB = (
            B00 * (B11 * B22 - A12 * A12)
            - A01 * (A01 * B22 - A12 * A02)
            + A02 * (A01 * A12 - B11 * A02)
        )
        r = jnp.clip(detB / (2.0 * p * p * p), -1.0, 1.0)
        phi = jnp.arccos(r) / 3.0
        lam = q + 2.0 * p * jnp.cos(phi)
        return radius_sigma * jnp.sqrt(jnp.maximum(lam, 0.0))
    raise ValueError(f"unsupported D={D}")


def radii_axis(covariances: jnp.ndarray, D: int, radius_sigma: float = 3.0,
               eig_floor: float = 1e-6) -> jnp.ndarray:
    """(P, D) per-axis footprint radii: the tight axis-aligned bounding box
    of the radius_sigma-sigma ellipsoid has half-width
    radius_sigma * sqrt(cov_dd) along axis d (always <= the scalar
    radius_sigma * sqrt(lambda_max) bound the reference uses,
    forward.cu:52-61 - a strictly tighter box around the SAME support, so
    anisotropic fields emit fewer duplicates and pair candidates).  Culling
    (det == 0 -> zero radius) matches ``radii``: culled rows are zero on
    every axis."""
    from ..config import tri_index

    diag = jnp.stack(
        [covariances[:, tri_index(D, d, d)] for d in range(D)], axis=1)
    r = radius_sigma * jnp.sqrt(jnp.maximum(diag, 0.0))
    culled = radii(covariances, D, radius_sigma, eig_floor) <= 0.0
    return jnp.where(culled[:, None], 0.0, r)
