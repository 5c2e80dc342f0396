"""GaussianSampler facade: the reference-shaped stateful API end-to-end."""

import jax.numpy as jnp
import numpy as np
import pytest

from dgs.config import SamplerConfig
from dgs.sampler import GaussianSampler
from dgs.oracle import dense as oracle
from dgs.binning import grid as binning

from conftest import make_gaussians, make_samples


def test_facade_preprocess_and_sample(rng):
    means, values, covs, conics = make_gaussians(rng, 33, 2, 3)
    samples = make_samples(rng, 47, 2)
    m, v, cov, c, s = map(jnp.asarray, (means, values, covs, conics, samples))

    sampler = GaussianSampler(debug=True)
    sampler.preprocess(m, v, cov, c, s)
    mask = binning.pair_mask_dense(sampler.config, sampler.state, s, 33)

    checks = [
        ("value", sampler.sample_gaussians()),
        ("derivative", sampler.sample_gaussians_derivative()),
        ("laplacian", sampler.sample_gaussians_laplacian()),
        ("third", sampler.sample_gaussians_third_derivative()),
    ]
    for order, got in checks:
        ref = oracle.evaluate(order, m, v, c, s, pair_mask=mask)
        np.testing.assert_allclose(
            got, ref, rtol=2e-4,
            atol=1e-5 * max(1.0, float(np.abs(ref).max())), err_msg=order,
        )

    fused = sampler.sample_all()
    for order, got in checks:
        np.testing.assert_allclose(fused[order], got, rtol=1e-5, atol=1e-6)


def test_facade_aggregation_path(rng):
    means, values, covs, conics = make_gaussians(
        rng, 21, 2, 3, sigma_range=(0.1, 0.3)
    )
    samples = make_samples(rng, 13, 2)
    m, v, cov, c, s = map(jnp.asarray, (means, values, covs, conics, samples))

    sampler = GaussianSampler()
    sampler.preprocess(m, v, cov, c, s)
    sampler.preprocess_aggregate(neighbor_capacity=32)

    L, K, E = 4, 3, 9
    r = np.random.default_rng(3)
    nf = sampler.aggregate_neighbors(
        jnp.asarray(r.normal(size=(21, L)).astype(np.float32)),
        jnp.asarray(r.normal(size=(L, L)).astype(np.float32)),
        jnp.asarray(r.normal(size=(21, K)).astype(np.float32)),
        jnp.asarray(r.normal(size=(21, K)).astype(np.float32)),
        jnp.asarray(r.uniform(0.5, 2.0, (2,)).astype(np.float32)),
        jnp.asarray(r.normal(size=(2 * E,)).astype(np.float32)),
    )
    assert nf.shape == (21, L)
    assert np.isfinite(np.asarray(nf)).all()


def test_facade_chunked_method_matches_tiled(rng):
    """method="chunked" (the D=3 production path) is selectable from the
    facade and agrees with the tiled path for every order."""
    means, values, covs, conics = make_gaussians(rng, 60, 3, 2)
    samples = make_samples(rng, 200, 3)
    m, v, cov, c, s = map(jnp.asarray, (means, values, covs, conics, samples))

    cfg = SamplerConfig(tile_size=0.51)
    tiled = GaussianSampler(debug=True, method="tiled", config=cfg)
    tiled.preprocess(m, v, cov, c, s)
    chunked = GaussianSampler(debug=True, method="chunked", config=cfg)
    chunked.preprocess(m, v, cov, c, s)

    ref = tiled.sample_all()
    got = chunked.sample_all()
    for order in ref:
        np.testing.assert_allclose(
            got[order], ref[order], rtol=2e-4,
            atol=1e-5 * max(1.0, float(np.abs(ref[order]).max())),
            err_msg=order,
        )


def test_facade_pallas_aggregation_matches_grid(rng):
    """preprocess_aggregate(method="pallas") + aggregate_neighbors runs the
    fused Pallas pair-sweep path from the facade and matches the XLA table
    path (values AND gradients over all six parameter groups)."""
    import jax

    means, values, covs, conics = make_gaussians(
        rng, 40, 2, 3, sigma_range=(0.05, 0.2)
    )
    samples = make_samples(rng, 13, 2)
    m, v, cov, c, s = map(jnp.asarray, (means, values, covs, conics, samples))

    P, L, K, E = 40, 4, 4, 9
    r = np.random.default_rng(7)
    args = (
        jnp.asarray(r.normal(size=(P, L)).astype(np.float32)),
        jnp.asarray(r.normal(size=(L, L)).astype(np.float32)),
        jnp.asarray(r.normal(size=(P, K)).astype(np.float32)),
        jnp.asarray(r.normal(size=(P, K)).astype(np.float32)),
        jnp.asarray(np.arange(1.0, 3.0).astype(np.float32)),
        jnp.asarray(r.normal(size=(2 * E,)).astype(np.float32)),
    )

    grid = GaussianSampler(debug=True)
    grid.preprocess(m, v, cov, c, s)
    grid.preprocess_aggregate(neighbor_capacity=64)

    pal = GaussianSampler(debug=True)
    pal.preprocess(m, v, cov, c, s)
    pal.preprocess_aggregate(method="pallas")
    from dgs.ops.aggregation import AggBinning
    assert isinstance(pal.neighbors, AggBinning)

    ref = grid.aggregate_neighbors(*args)
    got = pal.aggregate_neighbors(*args)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)

    def loss(fn):
        return lambda *a: jnp.sum(fn(*a) ** 2)

    g_ref = jax.grad(loss(grid.aggregate_neighbors), argnums=tuple(range(6)))(*args)
    g_got = jax.grad(loss(pal.aggregate_neighbors), argnums=tuple(range(6)))(*args)
    for i, (a, b) in enumerate(zip(g_got, g_ref)):
        np.testing.assert_allclose(
            a, b, rtol=3e-4, atol=3e-4 * max(1.0, float(np.abs(b).max())),
            err_msg=f"grad group {i}",
        )


def test_module_level_pallas_aggregate_dispatch(rng):
    """The module-level aggregate_neighbors dispatches on the structure."""
    import dgs
    from dgs.ops import aggregation

    means, values, covs, conics = make_gaussians(
        rng, 24, 2, 3, sigma_range=(0.05, 0.2)
    )
    m, cov, c = map(jnp.asarray, (means, covs, conics))
    from dgs.oracle.dense import radii as compute_radii

    cfg = SamplerConfig()
    rad = compute_radii(cov, 2, cfg.radius_sigma, cfg.eig_floor)
    cfg2, plan = aggregation.plan_pallas(cfg, m, rad)
    agg = aggregation.preprocess_pallas(cfg2, m, c, rad, plan)

    P, L, K, E = 24, 3, 3, 5
    r = np.random.default_rng(5)
    out = dgs.aggregate_neighbors(
        jnp.asarray(r.normal(size=(P, L)).astype(np.float32)),
        jnp.asarray(r.normal(size=(L, L)).astype(np.float32)),
        jnp.asarray(r.normal(size=(P, K)).astype(np.float32)),
        jnp.asarray(r.normal(size=(P, K)).astype(np.float32)),
        jnp.asarray(np.arange(1.0, 2.0).astype(np.float32)),
        jnp.asarray(r.normal(size=(2 * E,)).astype(np.float32)),
        agg,
    )
    assert out.shape == (P, L)
    assert np.isfinite(np.asarray(out)).all()


def test_facade_dense_method_matches_tiled_masked(rng):
    means, values, covs, conics = make_gaussians(
        rng, 15, 2, 2, sigma_range=(0.8, 1.1)
    )
    samples = make_samples(rng, 25, 2)
    m, v, cov, c, s = map(jnp.asarray, (means, values, covs, conics, samples))

    tiled = GaussianSampler(method="tiled")
    tiled.preprocess(m, v, cov, c, s)
    dense = GaussianSampler(method="dense")
    dense.preprocess(m, v, cov, c, s)
    # wide gaussians cover every tile -> tiled == dense exactly
    np.testing.assert_allclose(
        tiled.sample_gaussians(), dense.sample_gaussians(), rtol=2e-4, atol=1e-5
    )


def test_module_level_functional_api():
    """The reference's module-level functional forms (__init__.py:21-36)
    exist in JAX idiom and are differentiable."""
    import dgs
    import jax
    import jax.numpy as jnp
    from dgs.models.field import init_field

    f = init_field(jax.random.PRNGKey(0), 40, 2, 3, sigma=0.1)
    x = jax.random.uniform(jax.random.PRNGKey(1), (100, 2),
                           minval=-1, maxval=1)
    con = f.conics()
    assert dgs.sample_gaussians(f.means, f.values, con, x).shape == (100, 3)
    assert dgs.sample_gaussians_derivative(
        f.means, f.values, con, x).shape == (100, 2, 3)
    assert dgs.sample_gaussians_laplacian(
        f.means, f.values, con, x).shape == (100, 2, 2, 3)
    assert dgs.sample_gaussians_third_derivative(
        f.means, f.values, con, x).shape == (100, 2, 2, 2, 3)
    g = jax.grad(lambda m: jnp.sum(
        dgs.sample_gaussians(m, f.values, con, x) ** 2))(f.means)
    assert g.shape == f.means.shape and bool(jnp.isfinite(g).all())


def test_profiling_trace_and_aggregation(tmp_path):
    """utils.profiling captures a trace and aggregates per-op device time
    (works on CPU too - empty device table is acceptable there, the parse
    path is what's under test)."""
    import jax
    import jax.numpy as jnp
    from dgs.utils import profiling

    @jax.jit
    def f(x):
        with profiling.named_scope("square"):
            return jnp.sum(x * x)

    d = str(tmp_path / "trace")
    with profiling.trace(d):
        jax.block_until_ready(f(jnp.arange(1024.0)))
    rows = profiling.device_op_times(d, top=5)
    assert isinstance(rows, list)


def test_debug_named_errors():
    """The debug-mode guardrails the reference lacks (it segfaults or
    silently corrupts): named shape errors, named overflow errors, and a
    FloatingPointError on non-finite inputs."""
    import jax
    import jax.numpy as jnp
    import pytest
    from dgs.config import SamplerConfig
    from dgs.sampler import GaussianSampler
    from dgs.models.field import init_field

    f = init_field(jax.random.PRNGKey(0), 64, 2, 2, sigma=0.2)
    cov, con = f.covariances(), f.conics()
    x = jax.random.uniform(jax.random.PRNGKey(1), (256, 2),
                           minval=-1, maxval=1)

    # Wrong conic trailing dim -> named shape error.
    s = GaussianSampler(debug=True)
    with pytest.raises(ValueError, match="conics"):
        s.preprocess(f.means, f.values, cov, con[:, :2], x)

    # Undersized duplicate cap -> named overflow error (not silent drops).
    s2 = GaussianSampler(
        debug=True, config=SamplerConfig(max_tiles_per_gaussian=1)
    )
    with pytest.raises(ValueError, match="max_tiles_per_gaussian"):
        s2.preprocess(f.means, f.values, cov, con, x)

    # NaN input under debug -> FloatingPointError from the finite check.
    bad = f.means.at[0, 0].set(jnp.nan)
    with pytest.raises(FloatingPointError):
        GaussianSampler(debug=True).preprocess(bad, f.values, cov, con, x)


def test_module_level_preprocess_aggregate_methods(rng):
    """The functional preprocess_aggregate mirrors the facade's method
    dispatch (ext.cpp:29 parity at the module surface): method="pallas"
    builds the production AggBinning structure and its aggregation matches
    the grid-table path."""
    import dgs
    from dgs.ops import aggregation
    from dgs.oracle.dense import radii as compute_radii

    means, values, covs, conics = make_gaussians(
        rng, 30, 2, 3, sigma_range=(0.05, 0.2)
    )
    m, cov, c = map(jnp.asarray, (means, covs, conics))
    cfg = SamplerConfig()
    rad = compute_radii(cov, 2, cfg.radius_sigma, cfg.eig_floor)

    agg_p = dgs.preprocess_aggregate(cfg, m, c, rad, method="pallas")
    assert isinstance(agg_p, aggregation.AggBinning)
    agg_g = dgs.preprocess_aggregate(cfg, m, c, rad, method="grid",
                                         neighbor_capacity=64)
    assert isinstance(agg_g, aggregation.Neighbors)

    P, L, K, E = 30, 3, 3, 5
    r = np.random.default_rng(11)
    args = (
        jnp.asarray(r.normal(size=(P, L)).astype(np.float32)),
        jnp.asarray(r.normal(size=(L, L)).astype(np.float32)),
        jnp.asarray(r.normal(size=(P, K)).astype(np.float32)),
        jnp.asarray(r.normal(size=(P, K)).astype(np.float32)),
        jnp.asarray(np.arange(1.0, 2.0).astype(np.float32)),
        jnp.asarray(r.normal(size=(2 * E,)).astype(np.float32)),
    )
    out_p = dgs.aggregate_neighbors(*args, agg_p)
    out_g = dgs.aggregate_neighbors(*args, agg_g)
    np.testing.assert_allclose(out_p, out_g, rtol=2e-4, atol=2e-5)

    with pytest.raises(ValueError, match="method"):
        dgs.preprocess_aggregate(cfg, m, c, rad, method="nope")
