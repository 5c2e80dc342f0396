"""Tile binning + the tiled pair kernels vs the masked oracle.

The binning decides exactly which (sample, gaussian) pairs interact (a pair
counts iff the Gaussian's 3-sigma rect covers the sample's tile - the
reference's pairing, sampler_impl.cu:54-129 + forward.cu:104-144).  The tiled
kernels must reproduce the oracle restricted to that same pair mask bit-for-
tolerance, including torus-wrapped tiles.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dgs.config import SamplerConfig
from dgs.binning import grid as binning
from dgs.oracle import dense as oracle
from dgs.ops import sampling

from conftest import make_gaussians, make_samples

ORDERS = ("value", "derivative", "laplacian", "third")


def _setup(rng, P, N, D, C=3, **kw):
    means, values, covs, conics = make_gaussians(rng, P, D, C, **kw)
    samples = make_samples(rng, N, D)
    return tuple(map(jnp.asarray, (means, values, covs, conics, samples)))


BLOCKS = dict(block_n=128, block_e=128, bwd_block_n=64, bwd_block_e=128)


def _build(cfg, m, cov, s):
    state = binning.build(cfg, m, cov, s)
    fwd_geom = binning.forward_geometry(
        state, BLOCKS["block_n"], BLOCKS["block_e"])
    bwd_geom = binning.backward_geometry(
        state, BLOCKS["bwd_block_e"], BLOCKS["bwd_block_n"])
    return state, fwd_geom, bwd_geom


@pytest.mark.parametrize("D", [1, 2, 3])
def test_pair_mask_matches_rect_math(rng, D):
    """Binning pair mask == direct numpy rect-covers-tile computation."""
    cfg = SamplerConfig(max_tiles_per_gaussian=8).with_dims(D)
    m, v, cov, c, s = _setup(rng, 29, 41, D)
    state = binning.build(cfg, m, cov, s)
    assert int(state.overflow) == 0
    mask = np.asarray(binning.pair_mask_dense(cfg, state, s, 29))

    grid = cfg.grid_shape()
    rad = np.asarray(oracle.radii(cov, D))
    s_np, m_np = np.asarray(s), np.asarray(m)
    tile_of = np.clip(
        np.floor((s_np - np.asarray(cfg.lower)) / cfg.tile_size).astype(int),
        0,
        np.asarray(grid) - 1,
    )
    for n in range(s_np.shape[0]):
        for p in range(m_np.shape[0]):
            lo = np.floor(
                (m_np[p] - np.asarray(cfg.lower) - rad[p]) / cfg.tile_size
            ).astype(int)
            hi = np.ceil(
                (m_np[p] - np.asarray(cfg.lower) + rad[p]) / cfg.tile_size
            ).astype(int)
            full = (hi - lo) >= np.asarray(grid)
            lo[full], hi[full] = 0, np.asarray(grid)[full]
            covered = all(
                any(
                    (t % grid[d]) == tile_of[n, d] for t in range(lo[d], hi[d])
                )
                for d in range(D)
            ) and rad[p] > 0
            assert mask[n, p] == covered, (n, p)


@pytest.mark.parametrize("D", [1, 2, 3])
def test_tiled_forward_matches_masked_oracle(rng, D):
    cfg = SamplerConfig(max_tiles_per_gaussian=8).with_dims(D)
    m, v, cov, c, s = _setup(rng, 43, 67, D)
    state, fg, bg = _build(cfg, m, cov, s)
    mask = binning.pair_mask_dense(cfg, state, s, 43)
    outs = sampling.sample_tiled_multi(
        ORDERS, cfg, m, v, c, s, state, fg, bg, **BLOCKS)
    for order, got in zip(ORDERS, outs):
        ref = oracle.evaluate(order, m, v, c, s, pair_mask=mask)
        np.testing.assert_allclose(
            got, ref, rtol=2e-4,
            atol=1e-5 * max(1.0, float(np.abs(ref).max())), err_msg=order,
        )


@pytest.mark.parametrize("D", [1, 2, 3])
def test_tiled_backward_matches_masked_oracle_autodiff(rng, D):
    cfg = SamplerConfig(max_tiles_per_gaussian=8).with_dims(D)
    m, v, cov, c, s = _setup(rng, 31, 37, D)
    state, fg, bg = _build(cfg, m, cov, s)
    mask = binning.pair_mask_dense(cfg, state, s, 31)

    def loss_tiled(m_, v_, c_):
        outs = sampling.sample_tiled_multi(
            ORDERS, cfg, m_, v_, c_, s, state, fg, bg, **BLOCKS)
        return sum(jnp.sum(o**2) for o in outs)

    def loss_oracle(m_, v_, c_):
        return sum(
            jnp.sum(oracle.evaluate(o, m_, v_, c_, s, pair_mask=mask) ** 2)
            for o in ORDERS
        )

    ref = jax.grad(loss_oracle, argnums=(0, 1, 2))(m, v, c)
    got = jax.grad(loss_tiled, argnums=(0, 1, 2))(m, v, c)
    for r, o, name in zip(ref, got, ("means", "values", "conics")):
        np.testing.assert_allclose(
            o, r, rtol=2e-3,
            atol=1e-5 * max(1.0, float(np.abs(r).max())),
            err_msg=f"dL_d{name}",
        )


def test_tiled_equals_dense_for_wide_gaussians(rng):
    """Gaussians whose rects cover the whole grid: tiled == unmasked dense."""
    cfg = SamplerConfig(max_tiles_per_gaussian=8)
    m, v, cov, c, s = _setup(rng, 9, 21, 2, sigma_range=(0.9, 1.2))
    state, fg, bg = _build(cfg, m, cov, s)
    outs = sampling.sample_tiled_multi(
        ("value",), cfg, m, v, c, s, state, fg, bg, **BLOCKS)
    ref = oracle.evaluate("value", m, v, c, s)
    np.testing.assert_allclose(outs[0], ref, rtol=2e-4, atol=1e-5)


def test_overflow_detection(rng):
    """Footprints beyond the static duplicate capacity are counted."""
    cfg = SamplerConfig(max_tiles_per_gaussian=1)
    m, v, cov, c, s = _setup(rng, 7, 5, 2, sigma_range=(0.5, 0.8))
    state = binning.build(cfg, m, cov, s)
    assert int(state.overflow) > 0


def test_culled_zero_radius_gaussian(rng):
    """det == 0 covariance -> zero radius -> no contribution
    (forward.cu:55-57, sampler_impl.cu:69)."""
    cfg = SamplerConfig()
    m, v, cov, c, s = _setup(rng, 5, 11, 2)
    cov = cov.at[2].set(jnp.array([0.01, 0.01, 0.01]))  # det == 0
    state, fg, bg = _build(cfg, m, cov, s)
    outs = sampling.sample_tiled_multi(
        ("value",), cfg, m, v, c, s, state, fg, bg, **BLOCKS)
    mask = binning.pair_mask_dense(cfg, state, s, 5)
    assert not bool(mask[:, 2].any())
    ref = oracle.evaluate("value", m, v, c, s, pair_mask=mask)
    np.testing.assert_allclose(outs[0], ref, rtol=2e-4, atol=1e-5)


def test_padded_sorted_unique_outputs_and_sample_binning(rng):
    """padded+sorted+unique outputs with a prebuilt sample binning must give
    the same loss and gradients as the plain path."""
    from dgs.models.field import init_field

    P, N, D, C = 400, 1500, 2, 3
    f = init_field(jax.random.PRNGKey(3), P, D, C, sigma=0.06)
    s = jnp.asarray(make_samples(rng, N, D))
    cfg = SamplerConfig(tile_size=0.25, max_tiles_per_gaussian=4,
                        eig_floor=1e-12, entry_capacity_factor=30.0)
    con, cov = f.conics(), f.covariances()
    sb = binning.bin_samples(cfg, s)

    def loss(padded, sbin):
        def inner(m, v, c):
            outs, diag = sampling.sample_binned(
                cfg, m, v, c, cov, s, ("value", "laplacian"),
                sorted_outputs=True, unique_outputs=True,
                padded_outputs=padded, sample_binning=sbin)
            return sum(jnp.sum(o * o) for o in outs.values()), diag
        return jax.value_and_grad(inner, argnums=(0, 1, 2), has_aux=True)(
            f.means, f.values, con)

    (l0, d0), g0 = loss(False, None)
    (l1, d1), g1 = loss(True, sb)
    for k in ("bin_overflow", "entry_overflow"):
        assert int(d1[k]) == 0, (k, int(d1[k]))
    np.testing.assert_allclose(l0, l1, rtol=1e-6)
    for a, b in zip(g0, g1):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_backward_is_deterministic(rng):
    """Two identical runs give BITWISE-equal gradients - the deterministic
    segment-sum replaces CUDA's nondeterministic atomicAdd order
    (backward.cu:121-152)."""
    from dgs.models.field import init_field

    P, N, D, C = 300, 1200, 2, 3
    f = init_field(jax.random.PRNGKey(9), P, D, C, sigma=0.06)
    s = jnp.asarray(make_samples(rng, N, D))
    cfg = SamplerConfig(tile_size=0.25, max_tiles_per_gaussian=4,
                        eig_floor=1e-12, entry_capacity_factor=30.0)
    con, cov = f.conics(), f.covariances()

    @jax.jit
    def grads(m, v, c):
        def loss(m_, v_, c_):
            outs, _ = sampling.sample_binned(
                cfg, m_, v_, c_, cov, s, ("value", "derivative", "laplacian"))
            return sum(jnp.sum(o * o) for o in outs.values())
        return jax.grad(loss, argnums=(0, 1, 2))(m, v, c)

    g1 = jax.device_get(grads(f.means, f.values, con))
    g2 = jax.device_get(grads(f.means, f.values, con))
    for a, b in zip(g1, g2):
        np.testing.assert_array_equal(a, b)


def test_open_domain_binned_matches_oracle(rng):
    """Non-periodic (open) domain: clamped rects, no wrap - outputs and
    gradients match the masked oracle (a capability extension; the
    reference is torus-only, config.h:19)."""
    from dgs.models.field import init_field

    P, N, D, C = 300, 1500, 2, 3
    f = init_field(jax.random.PRNGKey(0), P, D, C, sigma=0.06)
    s = jnp.asarray(make_samples(rng, N, D))
    cfg = SamplerConfig(period=None, lower=(-1.0, -1.0),
                        upper_bounds=(1.0, 1.0), tile_size=0.25,
                        max_tiles_per_gaussian=4, eig_floor=1e-12,
                        entry_capacity_factor=30.0)
    con, cov = f.conics(), f.covariances()
    orders = ("value", "derivative", "laplacian")

    def loss(m, v, c):
        outs, diag = sampling.sample_binned(cfg, m, v, c, cov, s, orders)
        return sum(jnp.sum(o * o) for o in outs.values()), diag

    (l, diag), g = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(f.means, f.values, con)
    for k in ("bin_overflow", "entry_overflow"):
        assert int(diag[k]) == 0, k
    state = binning.build(cfg, f.means, cov, s)
    mask = binning.pair_mask_dense(cfg, state, s, P)

    def loss_ref(m, v, c):
        return sum(
            jnp.sum(oracle.evaluate(o, m, v, c, s, pair_mask=mask,
                                    period=None) ** 2)
            for o in orders
        )

    np.testing.assert_allclose(l, loss_ref(f.means, f.values, con), rtol=1e-5)
    gr = jax.grad(loss_ref, argnums=(0, 1, 2))(f.means, f.values, con)
    for a, b in zip(g, gr):
        np.testing.assert_allclose(
            a, b, rtol=2e-4, atol=1e-5 * max(1.0, float(np.abs(b).max()))
        )


def test_anisotropic_open_box_binned_matches_oracle(rng):
    """End-to-end sampling on a (2 x 1 x 0.5) anisotropic open box: binned
    outputs and gradients match the masked oracle (per-axis extents
    through grid_shape + the binned path)."""
    from dgs.models.field import init_field

    P, N, D, C = 200, 900, 3, 2
    f = init_field(jax.random.PRNGKey(2), P, D, C, sigma=0.05)
    scale = jnp.asarray([[1.0, 0.5, 0.25]], jnp.float32)
    means = f.means * scale
    s = jnp.asarray(make_samples(rng, N, D)) * scale
    cfg = SamplerConfig(period=None, lower=(-1.0, -0.5, -0.25),
                        upper_bounds=(1.0, 0.5, 0.25), tile_size=0.11,
                        max_tiles_per_gaussian=6, eig_floor=1e-12,
                        entry_capacity_factor=216.0)
    con, cov = f.conics(), f.covariances()
    orders = ("value", "derivative", "laplacian")

    def loss(m, v, c):
        outs, diag = sampling.sample_binned(cfg, m, v, c, cov, s, orders)
        return sum(jnp.sum(o * o) for o in outs.values()), diag

    (l, diag), g = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(means, f.values, con)
    for k in ("bin_overflow", "entry_overflow"):
        assert int(diag[k]) == 0, k
    state = binning.build(cfg, means, cov, s)
    mask = binning.pair_mask_dense(cfg, state, s, P)

    def loss_ref(m, v, c):
        return sum(
            jnp.sum(oracle.evaluate(o, m, v, c, s, pair_mask=mask,
                                    period=None) ** 2)
            for o in orders
        )

    np.testing.assert_allclose(l, loss_ref(means, f.values, con), rtol=1e-5)
    gr = jax.grad(loss_ref, argnums=(0, 1, 2))(means, f.values, con)
    for a, b in zip(g, gr):
        np.testing.assert_allclose(
            a, b, rtol=2e-3, atol=1e-4 * max(1.0, float(np.abs(b).max()))
        )


def test_gaussian_binning_reuse(rng):
    """build(gaussian_binning=...) with fresh samples must equal a full
    rebuild field-for-field (the dynamics-training hoist: geometry fixed,
    query points resampled)."""
    cfg = SamplerConfig(max_tiles_per_gaussian=8).with_dims(2)
    m, v, cov, c, s1 = _setup(rng, 31, 57, 2)
    s2 = jnp.asarray(make_samples(np.random.default_rng(99), 64, 2))
    gstate = binning.build(cfg, m, cov, s1)
    full = binning.build(cfg, m, cov, s2)
    reused = binning.build(cfg, m, cov, s2, gaussian_binning=gstate)
    for name in full._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(full, name)),
            np.asarray(getattr(reused, name)), err_msg=name)


@pytest.mark.parametrize("D", [2, 3])
def test_ellip_cull_binning_matches_masked_oracle(rng, D):
    """cfg.ellip_cull drops candidate tiles whose box the 3-sigma ellipsoid
    does not intersect (binning/grid.ellip_keep).  Checks: (1) the culled
    entry set is a strict subset of the uncalled one; (2) no tile containing
    a point at <= (1 - eps) sigma-level is ever culled (no false culls);
    (3) the tiled pipeline still matches the oracle under the culled pair
    mask exactly."""
    import dataclasses

    cfg = SamplerConfig(max_tiles_per_gaussian=8, ellip_cull=True,
                        eig_floor=1e-12).with_dims(D)
    m, v, cov, c, s = _setup(rng, 43, 67, D)
    state_c = binning.build(cfg, m, cov, s)
    cfg0 = dataclasses.replace(cfg, ellip_cull=False)
    state0 = binning.build(cfg0, m, cov, s)
    T = binning.num_tiles(cfg, D)

    def entry_set(st):
        gid = np.asarray(st.ent_gid)
        tile = np.asarray(st.ent_tile[0])
        keep = tile < T
        return set(zip(gid[keep].tolist(), tile[keep].tolist()))

    culled_set, full_set = entry_set(state_c), entry_set(state0)
    assert culled_set < full_set, "ellip_cull must drop some corner tiles"

    # No-false-cull: every tile containing a point strictly inside the
    # sigma ellipsoid of gaussian p must have a (p, tile) entry.
    conics_b = np.asarray(binning.conics_from_cov(cov, D))
    m_np = np.asarray(m)
    rng2 = np.random.default_rng(7)
    for p in range(0, 43, 5):
        Q = np.zeros((D, D))
        for i in range(D):
            for j in range(D):
                from dgs.config import tri_index

                Q[i, j] = conics_b[p, tri_index(D, i, j)]
        # Random directions scaled to just inside the 3-sigma surface.
        u = rng2.normal(size=(256, D))
        lev = np.einsum("nd,de,ne->n", u, Q, u)
        pts = m_np[p] + u * (0.98 * cfg.radius_sigma /
                             np.sqrt(np.maximum(lev, 1e-30)))[:, None]
        pts_w = (pts - np.asarray(cfg.lower)) % cfg.period \
            + np.asarray(cfg.lower)
        tiles = np.floor(
            (pts_w - np.asarray(cfg.lower)) / cfg.tile_size).astype(int)
        g = np.asarray(cfg.grid_shape())
        tiles = np.minimum(tiles, g - 1)
        strides = np.cumprod(np.concatenate([[1], g[::-1][:-1]]))[::-1]
        flat = (tiles * strides).sum(axis=1)
        for t in np.unique(flat):
            assert (p, int(t)) in culled_set, (p, int(t))

    state2, fg, bg = _build(cfg, m, cov, s)
    mask = binning.pair_mask_dense(cfg, state2, s, 43)
    outs = sampling.sample_tiled_multi(
        ("value", "third"), cfg, m, v, c, s, state2, fg, bg, **BLOCKS)
    for order, got in zip(("value", "third"), outs):
        ref = oracle.evaluate(order, m, v, c, s, pair_mask=mask)
        np.testing.assert_allclose(
            got, ref, rtol=3e-4,
            atol=1e-5 * max(1.0, float(np.abs(ref).max())), err_msg=order)


@pytest.mark.parametrize("D", [2, 3])
def test_axis_radii_binning_matches_masked_oracle(rng, D):
    """cfg.axis_radii bins by the tight per-axis AABB of the 3-sigma
    ellipsoid (oracle.radii_axis) - a strict subset of the isotropic
    sqrt(lambda_max) rects covering the same support.  The kernels must
    match the oracle restricted to the axis-rect pair mask, and the per-axis
    rects must never reach outside the isotropic ones."""
    import dataclasses

    cfg = SamplerConfig(max_tiles_per_gaussian=8, axis_radii=True,
                        eig_floor=1e-12).with_dims(D)
    m, v, cov, c, s = _setup(rng, 43, 67, D)
    state = binning.build(cfg, m, cov, s)
    assert state.radii.shape == (43, D)
    r_iso = oracle.radii(cov, D, cfg.radius_sigma, cfg.eig_floor)
    assert bool(jnp.all(state.radii <= r_iso[:, None] + 1e-6))

    # Axis-rect covered tile SETS are contained in the isotropic ones
    # (compare wrapped sets - the raw index ranges differ representationally
    # when an isotropic rect collapses to a full cover).
    lo_a, hi_a = map(np.asarray, binning.gaussian_rects(cfg, m, state.radii))
    lo_i, hi_i = map(np.asarray, binning.gaussian_rects(cfg, m, r_iso))
    g = cfg.grid_shape()
    for p in range(lo_a.shape[0]):
        for d in range(D):
            ta = {t % g[d] for t in range(lo_a[p, d], hi_a[p, d])}
            ti = {t % g[d] for t in range(lo_i[p, d], hi_i[p, d])}
            assert ta <= ti, (p, d, ta, ti)

    state2, fg, bg = _build(cfg, m, cov, s)
    mask = binning.pair_mask_dense(cfg, state2, s, 43)
    outs = sampling.sample_tiled_multi(
        ("value", "laplacian"), cfg, m, v, c, s, state2, fg, bg, **BLOCKS)
    for order, got in zip(("value", "laplacian"), outs):
        ref = oracle.evaluate(order, m, v, c, s, pair_mask=mask)
        np.testing.assert_allclose(
            got, ref, rtol=3e-4,
            atol=1e-5 * max(1.0, float(np.abs(ref).max())), err_msg=order)
