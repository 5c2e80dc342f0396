"""Neighbor aggregation vs a direct numpy replica of the CUDA reference.

The numpy replica re-implements aggregate_neighbors.cu line-for-line in
Python (collision search, CSR preprocess, forward aggregation) and the jnp
implementation must match it; gradients are finite-diff checked.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dgs.config import SamplerConfig, tri_size
from dgs.oracle import dense as oracle
from dgs.ops import aggregation

from conftest import make_gaussians


def _wrap(x):
    return x - 2.0 * np.round(x / 2.0)


def reference_neighbors(means, conics, radii):
    """Numpy replica of findCollisions + preprocess
    (aggregate_neighbors.cu:18-127) with true min-image distances."""
    P, D = means.shape
    out = []
    for i in range(P):
        my_r = radii[i] * 0.2
        row = []
        if my_r >= 1e-6:
            for j in range(P):
                other_r = radii[j] * 0.2
                if other_r < 1e-6:
                    continue
                dx = _wrap(means[j] - means[i])
                if (dx**2).sum() > (my_r + other_r) ** 2:
                    continue
                row.append(j)
        inv_norm = 1.0 / (radii[i] * 0.333 + 1e-6)
        entries = []
        total = 0.0
        for j in row:
            X = _wrap(means[j] - means[i])
            Cm = np.zeros((D, D))
            k = 0
            for a in range(D):
                for b in range(a, D):
                    Cm[a, b] = Cm[b, a] = conics[j, k]
                    k += 1
            power = -0.5 * X @ Cm @ X
            if power > 0:
                entries.append((-1, X * inv_norm, 0.0))
                continue
            dens = np.exp(power)
            total += dens
            entries.append((j, X * inv_norm, dens))
        out.append((entries, 1.0 / (total + 1e-6)))
    return out


def reference_aggregate(nbrs, features, transform, queries, keys,
                        frequencies, dt):
    """Numpy replica of aggregateNeighbors (aggregate_neighbors.cu:129-208)."""
    P, L = features.shape
    D = nbrs[0][0][0][1].shape[0] if nbrs[0][0] else 1
    E = dt.shape[0] // 2
    nf = np.zeros((P, L))
    for i, (entries, inv_total) in enumerate(nbrs):
        for j, X, dens in entries:
            if j < 0:
                continue
            w = float(queries[i] @ keys[j])
            emb, fac = 0.0, 0.0
            for d in range(D):
                for e in range((E - 1) // D // 2):
                    s = np.sin(frequencies[e] * np.pi * X[d])
                    c = np.cos(frequencies[e] * np.pi * X[d])
                    emb += dt[d * ((E - 1) // D) + e * 2 + 0] * s
                    emb += dt[d * ((E - 1) // D) + e * 2 + 1] * c
                    fac += dt[E + d * ((E - 1) // D) + e * 2 + 0] * s
                    fac += dt[E + d * ((E - 1) // D) + e * 2 + 1] * c
            emb += dt[E - 1]
            fac += dt[2 * E - 1]
            dw = inv_total * dens * w
            for jj in range(L):
                embedded = dw * emb + dw * fac * features[j, jj]
                for k in range(L):
                    nf[i, k] += transform[jj, k] * embedded
    return nf


def _setup(rng, P, D, L=4, K=3, E=None):
    means, _, covs, conics = make_gaussians(
        rng, P, D, 1, sigma_range=(0.1, 0.35)
    )
    radii = np.asarray(oracle.radii(jnp.asarray(covs), D))
    if E is None:
        E = 2 * D * 2 + 1  # 2 frequencies per dim
    nfreq = (E - 1) // D // 2
    features = rng.normal(size=(P, L)).astype(np.float32)
    transform = rng.normal(size=(L, L)).astype(np.float32)
    queries = rng.normal(size=(P, K)).astype(np.float32)
    keys = rng.normal(size=(P, K)).astype(np.float32)
    frequencies = rng.uniform(0.5, 3.0, (nfreq,)).astype(np.float32)
    dt = rng.normal(size=(2 * E,)).astype(np.float32)
    return means, conics, radii, features, transform, queries, keys, frequencies, dt


@pytest.mark.parametrize("D", [1, 2, 3])
def test_preprocess_matches_reference(rng, D):
    means, conics, radii, *_ = _setup(rng, 23, D)
    cfg = SamplerConfig().with_dims(D)
    nbr = aggregation.preprocess(
        cfg, jnp.asarray(means), jnp.asarray(conics), jnp.asarray(radii), 32
    )
    assert int(nbr.overflow) == 0
    ref = reference_neighbors(means, conics, radii)
    for i, (entries, inv_total) in enumerate(ref):
        got_idx = [int(x) for x in np.asarray(nbr.indices[i]) if True]
        ref_idx = [j for j, _, _ in entries]
        # padded slots are -1
        assert got_idx[: len(ref_idx)] == ref_idx, i
        assert all(x == -1 for x in got_idx[len(ref_idx):]), i
        np.testing.assert_allclose(
            nbr.inv_total_densities[i], inv_total, rtol=1e-5
        )
        for slot, (j, X, dens) in enumerate(entries):
            np.testing.assert_allclose(
                nbr.dists[i, slot], X, rtol=1e-4, atol=1e-6
            )
            np.testing.assert_allclose(
                nbr.densities[i, slot], dens, rtol=1e-4, atol=1e-7
            )


@pytest.mark.parametrize("D", [1, 2])
def test_aggregate_matches_reference(rng, D):
    means, conics, radii, features, transform, queries, keys, freqs, dt = _setup(
        rng, 19, D
    )
    cfg = SamplerConfig().with_dims(D)
    nbr = aggregation.preprocess(
        cfg, jnp.asarray(means), jnp.asarray(conics), jnp.asarray(radii), 32
    )
    got = aggregation.aggregate(
        *map(jnp.asarray, (features, transform, queries, keys, freqs, dt)), nbr
    )
    ref_nbrs = reference_neighbors(means, conics, radii)
    ref = reference_aggregate(
        ref_nbrs, features, transform, queries, keys, freqs, dt
    )
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("D", [1, 2, 3])
def test_preprocess_grid_matches_dense(rng, D):
    """Cell-list neighbor search == brute-force scan: same neighbor sets,
    same densities/dists/normalizers, same aggregate output."""
    means, conics, radii, features, transform, queries, keys, freqs, dt = _setup(
        rng, 37, D
    )
    cfg = SamplerConfig(max_tiles_per_gaussian=8).with_dims(D)
    m, c, r = map(jnp.asarray, (means, conics, radii))
    dense_nbr = aggregation.preprocess(cfg, m, c, r, 48)
    grid_nbr = aggregation.preprocess_grid(cfg, m, c, r, 64, 8)
    assert int(dense_nbr.overflow) == 0
    assert int(grid_nbr.overflow) == 0

    for i in range(means.shape[0]):
        dsl = {int(j): s for s, j in enumerate(np.asarray(dense_nbr.indices[i]))
               if j >= 0}
        gsl = {int(j): s for s, j in enumerate(np.asarray(grid_nbr.indices[i]))
               if j >= 0}
        assert set(dsl) == set(gsl), i
        # ascending-j order preserved in both
        assert sorted(dsl) == list(dsl) and sorted(gsl) == list(gsl), i
        for j in dsl:
            np.testing.assert_allclose(
                grid_nbr.dists[i, gsl[j]], dense_nbr.dists[i, dsl[j]],
                rtol=1e-5, atol=1e-7, err_msg=f"dists {i},{j}")
            np.testing.assert_allclose(
                grid_nbr.densities[i, gsl[j]], dense_nbr.densities[i, dsl[j]],
                rtol=1e-5, atol=1e-7, err_msg=f"dens {i},{j}")
    np.testing.assert_allclose(
        grid_nbr.inv_total_densities, dense_nbr.inv_total_densities, rtol=1e-5
    )

    args = tuple(map(jnp.asarray,
                     (features, transform, queries, keys, freqs, dt)))
    np.testing.assert_allclose(
        aggregation.aggregate(*args, grid_nbr),
        aggregation.aggregate(*args, dense_nbr),
        rtol=1e-4, atol=1e-5,
    )


def test_aggregate_gradients_finite_diff(rng):
    D = 2
    means, conics, radii, features, transform, queries, keys, freqs, dt = _setup(
        rng, 11, D
    )
    cfg = SamplerConfig().with_dims(D)
    nbr = aggregation.preprocess(
        cfg, jnp.asarray(means), jnp.asarray(conics), jnp.asarray(radii), 16
    )
    args = tuple(map(jnp.asarray, (features, transform, queries, keys, freqs, dt)))
    names = ("features", "transform", "queries", "keys", "frequencies", "dt")

    def loss(*a):
        return jnp.sum(aggregation.aggregate(*a, nbr) ** 2)

    grads = jax.grad(loss, argnums=tuple(range(6)))(*args)
    rng2 = np.random.default_rng(7)
    eps = 1e-3
    for gi, name in enumerate(names):
        direction = jnp.asarray(
            rng2.normal(size=args[gi].shape).astype(np.float32)
        )
        hi = list(args)
        lo = list(args)
        hi[gi] = hi[gi] + eps * direction
        lo[gi] = lo[gi] - eps * direction
        fd = (float(loss(*hi)) - float(loss(*lo))) / (2 * eps)
        an = float(jnp.vdot(grads[gi], direction))
        scale = max(abs(an), abs(fd), 1e-4)
        assert abs(an - fd) / scale < 2e-2, f"{name}: {an} vs {fd}"
