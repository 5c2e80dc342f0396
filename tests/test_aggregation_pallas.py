"""Pallas aggregation kernels vs the XLA path (which is itself pinned to a
numpy replica of aggregate_neighbors.cu in test_aggregation.py).

The Pallas path enumerates every colliding pair in-kernel, so with an
untruncated neighbor capacity on the XLA side both paths compute the exact
same sums: outputs and all six parameter-group gradients must agree to fp32
tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dgs.config import SamplerConfig
from dgs.ops import aggregation
from dgs.oracle.dense import radii as compute_radii

from conftest import make_gaussians


def _setup(rng, P, D, L, K, nfreq, sigma_range=(0.05, 0.25)):
    means, _, covs, conics = make_gaussians(rng, P, D, L,
                                            sigma_range=sigma_range)
    covs = jnp.asarray(covs)
    E = 2 * D * nfreq + 1
    params = dict(
        features=rng.normal(0.0, 1.0, (P, L)).astype(np.float32),
        transform=rng.normal(0.0, 0.3, (L, L)).astype(np.float32),
        queries=rng.normal(0.0, 1.0, (P, K)).astype(np.float32),
        keys=rng.normal(0.0, 1.0, (P, K)).astype(np.float32),
        frequencies=(np.abs(rng.normal(0.0, 1.0, (nfreq,))) + 0.5
                     ).astype(np.float32),
        distance_transform=rng.normal(0.0, 0.5, (2 * E,)).astype(np.float32),
    )
    params = {k: jnp.asarray(v) for k, v in params.items()}
    return jnp.asarray(means), covs, jnp.asarray(conics), params


def _outputs_and_grads(fn, params):
    def loss(p):
        out = fn(p)
        return jnp.sum(out * jnp.cos(out)), out

    (l, out), grads = jax.value_and_grad(loss, has_aux=True)(params)
    return out, grads


@pytest.mark.parametrize("D", [1, 2, 3])
def test_pallas_matches_xla_aggregation(rng, D):
    P, L, K, nfreq = 150, 5, 3, 2
    means, covs, conics, params = _setup(rng, P, D, L, K, nfreq)
    cfg = SamplerConfig().with_dims(D)
    rad = compute_radii(covs, D, cfg.radius_sigma, 1e-12)

    # XLA reference path: brute-force table with untruncated capacity.
    nbr = aggregation.preprocess(cfg, means, conics, rad,
                                 neighbor_capacity=P)
    assert int(nbr.overflow) == 0

    def xla_fn(p):
        return aggregation.aggregate(
            p["features"], p["transform"], p["queries"], p["keys"],
            p["frequencies"], p["distance_transform"], nbr,
        )

    # Pallas path.
    cfg2, plan = aggregation.plan_pallas(
        cfg, means, rad, block_n=16, block_e=128)
    agg = aggregation.preprocess_pallas(
        cfg2, means, conics, rad, plan, 16, 128)
    assert int(agg.overflow) == 0

    def pallas_fn(p):
        return aggregation.aggregate_pallas(
            p["features"], p["transform"], p["queries"], p["keys"],
            p["frequencies"], p["distance_transform"], agg,
            period=None, block_n=16, block_e=128,
        )

    out_ref, g_ref = _outputs_and_grads(xla_fn, params)
    out_got, g_got = _outputs_and_grads(pallas_fn, params)

    np.testing.assert_allclose(
        out_got, out_ref, rtol=2e-4,
        atol=1e-5 * max(1.0, float(np.abs(out_ref).max())))
    for k in sorted(g_ref):
        r, g = np.asarray(g_ref[k]), np.asarray(g_got[k])
        np.testing.assert_allclose(
            g, r, rtol=2e-3, atol=1e-4 * max(1.0, float(np.abs(r).max())),
            err_msg=f"dL/d{k} (D={D})",
        )


def test_pallas_matches_xla_with_culled_and_open_domain(rng):
    """Zero-radius (culled) Gaussians contribute nothing on either side;
    open (non-periodic) domains agree too."""
    D, P, L, K, nfreq = 2, 120, 4, 2, 2
    means, covs, conics, params = _setup(rng, P, D, L, K, nfreq)
    cfg = SamplerConfig(period=None, lower=(-1.0, -1.0),
                        upper_bounds=(1.0, 1.0))
    rad = compute_radii(covs, D, cfg.radius_sigma, 1e-12)
    rad = rad.at[::7].set(0.0)  # cull some

    nbr = aggregation.preprocess(cfg, means, conics, rad,
                                 neighbor_capacity=P)
    out_ref = aggregation.aggregate(
        params["features"], params["transform"], params["queries"],
        params["keys"], params["frequencies"],
        params["distance_transform"], nbr)

    cfg2, plan = aggregation.plan_pallas(
        cfg, means, rad, block_n=16, block_e=128)
    agg = aggregation.preprocess_pallas(
        cfg2, means, conics, rad, plan, 16, 128)
    assert int(agg.overflow) == 0
    out_got = aggregation.aggregate_pallas(
        params["features"], params["transform"], params["queries"],
        params["keys"], params["frequencies"],
        params["distance_transform"], agg,
        period=None, block_n=16, block_e=128)
    np.testing.assert_allclose(
        out_got, out_ref, rtol=2e-4,
        atol=1e-5 * max(1.0, float(np.abs(np.asarray(out_ref)).max())))


@pytest.mark.parametrize("D", [1, 2, 3])
def test_ladder_frequencies_recurrence(rng, D):
    """ladder_frequencies=True (angle-addition sincos recurrence) matches
    the generic per-frequency path exactly when frequencies form the
    integer ladder base * (1..nfreq) - values and all six gradient groups,
    including the per-rung frequency partials (and their chain onto a
    shared learnable base)."""
    P, L, K, nfreq = 120, 5, 3, 4
    means, covs, conics, params = _setup(rng, P, D, L, K, nfreq)
    base = jnp.float32(0.83)
    params["frequencies"] = base * jnp.arange(1, nfreq + 1,
                                              dtype=jnp.float32)
    cfg = SamplerConfig().with_dims(D)
    rad = compute_radii(covs, D, cfg.radius_sigma, 1e-12)

    cfg2, plan = aggregation.plan_pallas(
        cfg, means, rad, block_n=16, block_e=128)
    agg = aggregation.preprocess_pallas(
        cfg2, means, conics, rad, plan, 16, 128)
    assert int(agg.overflow) == 0

    def fn(ladder):
        def run(p):
            return aggregation.aggregate_pallas(
                p["features"], p["transform"], p["queries"], p["keys"],
                p["frequencies"], p["distance_transform"], agg,
                period=None, block_n=16, block_e=128,
                ladder_frequencies=ladder,
            )
        return run

    out_ref, g_ref = _outputs_and_grads(fn(False), params)
    out_got, g_got = _outputs_and_grads(fn(True), params)
    np.testing.assert_allclose(
        out_got, out_ref, rtol=1e-5,
        atol=1e-5 * max(1.0, float(np.abs(out_ref).max())))
    for k in sorted(g_ref):
        r, g = np.asarray(g_ref[k]), np.asarray(g_got[k])
        np.testing.assert_allclose(
            g, r, rtol=1e-4, atol=1e-5 * max(1.0, float(np.abs(r).max())),
            err_msg=f"dL/d{k} (D={D})",
        )

    # Shared-base parameterization (models/dynamics.rollout_step): the
    # base gradient is the ladder-weighted sum of the per-rung partials.
    def base_loss(ladder):
        def run(b):
            p = dict(params)
            p["frequencies"] = b * jnp.arange(1, nfreq + 1,
                                              dtype=jnp.float32)
            out = fn(ladder)(p)
            return jnp.sum(out * jnp.cos(out))
        return run

    db_ref = jax.grad(base_loss(False))(base)
    db_got = jax.grad(base_loss(True))(base)
    np.testing.assert_allclose(db_got, db_ref, rtol=1e-4, atol=1e-6)


def test_fused_totals_matches_separate_totals_sweep(rng):
    """aggregate_pallas(fused_totals=True) over a structure built with
    compute_totals=False derives the per-center total densities from its
    OWN forward sweep (kernels/aggregate.forward with_totals) and must
    match the separate-totals-sweep path in values and all six gradients -
    the per-training-step configuration when the Gaussian means move (the
    reference recomputes total densities in every preprocess too,
    aggregate_neighbors.cu:120-125)."""
    D, L, K, nfreq = 2, 4, 3, 2
    means, covs, conics, params = _setup(rng, 50, D, L, K, nfreq)
    cfg = SamplerConfig()
    rad = compute_radii(covs, D, cfg.radius_sigma, cfg.eig_floor)
    cfg2, plan = aggregation.plan_pallas(cfg, means, rad)
    agg = aggregation.preprocess_pallas(cfg2, means, conics, rad, plan)
    aggF = aggregation.preprocess_pallas(cfg2, means, conics, rad, plan,
                                         compute_totals=False)

    def fn(structure, fused):
        def run(p):
            return aggregation.aggregate_pallas(
                p["features"], p["transform"], p["queries"], p["keys"],
                p["frequencies"], p["distance_transform"], structure,
                fused_totals=fused,
            )
        return run

    out_ref, g_ref = _outputs_and_grads(fn(agg, False), params)
    out_got, g_got = _outputs_and_grads(fn(aggF, True), params)
    np.testing.assert_allclose(
        out_got, out_ref, rtol=1e-4,
        atol=1e-5 * max(1.0, float(np.abs(out_ref).max())))
    for k in sorted(g_ref):
        r, g = np.asarray(g_ref[k]), np.asarray(g_got[k])
        np.testing.assert_allclose(
            g, r, rtol=2e-4, atol=2e-5 * max(1.0, float(np.abs(r).max())),
            err_msg=f"dL/d{k}")
