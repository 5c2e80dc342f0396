"""Chunk-packed sampling path vs the tiled path: same cfg => the same
binning semantics (pair counts iff the rect covers the sample's tile), so
outputs and all three parameter gradients must agree to fp32 tolerance.
The tiled path itself is pinned to the masked oracle and the backward.cu
numpy replica."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dgs.config import SamplerConfig
from dgs.ops import sampling, sampling_chunked
from dgs.binning import grid as binning
from dgs.oracle.dense import radii as compute_radii

from conftest import make_gaussians


def _setup(rng, P, N, D, C, sigma_range=(0.03, 0.1)):
    means, values, covs, conics = make_gaussians(rng, P, D, C,
                                                 sigma_range=sigma_range)
    samples = rng.uniform(-1.0, 1.0, (N, D)).astype(np.float32)
    return (jnp.asarray(means), jnp.asarray(values), jnp.asarray(covs),
            jnp.asarray(conics), jnp.asarray(samples))


def _grads(fn, means, values, conics):
    # Quadratic loss: the cotangent 2*o/scale is well-conditioned in o.
    # (An oscillatory loss like o*sin(o) is chaotic at the third order's
    # ~1e6 magnitudes - fp32-identical paths would still disagree.)
    def loss(m, v, c):
        outs = fn(m, v, c)
        return sum(jnp.sum(o * o) / max(1.0, float(o.size)) for o in outs)

    return jax.grad(loss, argnums=(0, 1, 2))(means, values, conics)


@pytest.mark.parametrize("D,orders", [
    (1, ("value", "derivative", "laplacian", "third")),
    (2, ("value", "derivative", "laplacian", "third")),
    (3, ("value", "derivative", "laplacian")),
])
def test_chunked_matches_tiled(rng, D, orders):
    P, N, C = 200, 500, 3
    means, values, covs, conics, samples = _setup(rng, P, N, D, C)
    cfg = SamplerConfig(tile_size=0.11, max_tiles_per_gaussian=8,
                        entry_capacity_factor=120.0, block_n=128, block_p=128,
                        block_n_bwd=128, block_p_bwd=128,
                        eig_floor=1e-12).with_dims(D)

    outs_ref, diag_ref = sampling.sample_binned(
        cfg, means, values, conics, covs, samples, tuple(orders))
    for k, v in diag_ref.items():
        if k != "perm":
            assert int(v) == 0, (k, int(v))

    def tiled(m, v, c):
        outs, diag = sampling.sample_binned(
            cfg, m, v, c, covs, samples, tuple(orders))
        return tuple(outs.values())

    cfg2, plan = sampling_chunked.plan_chunked(cfg, means, covs, samples)
    cs = sampling_chunked.chunk_samples(cfg2, samples, plan, cfg2.block_n)
    rad = compute_radii(covs, D, cfg2.radius_sigma, cfg2.eig_floor)

    def chunked(m, v, c):
        outs, diag = sampling_chunked.sample_chunked_multi(
            tuple(orders), cfg2, m, v, c, rad, cs, plan,
            block_n=cfg2.block_n, block_e=cfg2.block_p)
        return outs

    outs_t = tiled(means, values, conics)
    outs_c, diag = sampling_chunked.sample_chunked_multi(
        tuple(orders), cfg2, means, values, conics, rad, cs, plan,
        block_n=cfg2.block_n, block_e=cfg2.block_p)
    for k in ("bin_overflow", "entry_overflow", "sample_overflow"):
        assert int(diag[k]) == 0, (k, int(diag[k]))

    for o, (a, b) in zip(orders, zip(outs_c, outs_t)):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-4,
            atol=1e-5 * max(1.0, float(np.abs(np.asarray(b)).max())),
            err_msg=f"{o} output (D={D})")

    g_t = _grads(tiled, means, values, conics)
    g_c = _grads(chunked, means, values, conics)
    for name, a, b in zip(("dmeans", "dvalues", "dconics"), g_c, g_t):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=2e-3,
            atol=1e-4 * max(1.0, float(np.abs(np.asarray(b)).max())),
            err_msg=f"{name} (D={D})")


def test_chunked_padded_outputs_sum_matches(rng):
    """padded_outputs raw layout: multiplicity-weighted sum-of-squares
    equals the full-tensor loss computed from unsorted outputs."""
    from dgs.ops import formulas

    D, P, N, C = 2, 150, 400, 2
    orders = ("value", "derivative", "laplacian")
    means, values, covs, conics, samples = _setup(rng, P, N, D, C)
    cfg = SamplerConfig(tile_size=0.11, block_n=128, block_p=128,
                        eig_floor=1e-12).with_dims(D)
    cfg, plan = sampling_chunked.plan_chunked(cfg, means, covs, samples)
    cs = sampling_chunked.chunk_samples(cfg, samples, plan, cfg.block_n)
    rad = compute_radii(covs, D, cfg.radius_sigma, cfg.eig_floor)

    full, _ = sampling_chunked.sample_chunked_multi(
        orders, cfg, means, values, conics, rad, cs, plan,
        block_n=cfg.block_n, block_e=cfg.block_p)
    padded, _ = sampling_chunked.sample_chunked_multi(
        orders, cfg, means, values, conics, rad, cs, plan,
        block_n=cfg.block_n, block_e=cfg.block_p, padded_outputs=True)

    want = sum(float(jnp.sum(o * o)) for o in full)
    got = sum(
        float(jnp.einsum(
            "ucn,u->", o * o,
            jnp.asarray(formulas.sym_multiplicity(order, D), jnp.float32)))
        for order, o in zip(orders, padded)
    )
    assert got == pytest.approx(want, rel=1e-4)
