"""All-pairs evaluation (sample_dense_multi) vs the jnp oracle (config 2 of
BASELINE.json).

The dense path is plain XLA with the hand-derived VJP (formulas.vjp_params);
values and all three parameter gradients must match the oracle's autodiff to
fp32 tolerance.  (The test names date from when this path was a Pallas
kernel; the checks are the same.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dgs.oracle import dense as oracle
from dgs.ops import sampling

from conftest import make_gaussians, make_samples

DIMS = [1, 2, 3]
ORDERS = ["value", "derivative", "laplacian", "third"]


def _setup(rng, P, N, D, C=3):
    means, values, covs, conics = make_gaussians(rng, P, D, C)
    samples = make_samples(rng, N, D)
    return tuple(map(jnp.asarray, (means, values, conics, samples)))


@pytest.mark.parametrize("D", DIMS)
@pytest.mark.parametrize("order", ORDERS)
def test_pallas_forward_matches_oracle(rng, D, order):
    m, v, c, s = _setup(rng, 37, 53, D)
    got = sampling.sample(order, m, v, c, s)
    ref = oracle.evaluate(order, m, v, c, s)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("D", [1, 2, 3])
def test_pallas_fused_forward_matches_oracle(rng, D):
    m, v, c, s = _setup(rng, 19, 31, D)
    outs = sampling.sample_all(m, v, c, s)
    for order in ORDERS:
        ref = oracle.evaluate(order, m, v, c, s)
        np.testing.assert_allclose(
            outs[order], ref, rtol=2e-4, atol=1e-5, err_msg=order
        )


@pytest.mark.parametrize("D", DIMS)
@pytest.mark.parametrize("order", ORDERS)
def test_pallas_backward_matches_oracle_autodiff(rng, D, order):
    m, v, c, s = _setup(rng, 23, 29, D)
    g = jnp.asarray(
        np.random.default_rng(2)
        .normal(size=oracle.evaluate(order, m, v, c, s).shape)
        .astype(np.float32)
    )

    def loss_oracle(m_, v_, c_):
        return jnp.vdot(oracle.evaluate(order, m_, v_, c_, s), g)

    def loss_pallas(m_, v_, c_):
        return jnp.vdot(sampling.sample(order, m_, v_, c_, s), g)

    ref = jax.grad(loss_oracle, argnums=(0, 1, 2))(m, v, c)
    got = jax.grad(loss_pallas, argnums=(0, 1, 2))(m, v, c)
    for r, o, name in zip(ref, got, ("means", "values", "conics")):
        np.testing.assert_allclose(
            o, r, rtol=5e-4, atol=5e-5, err_msg=f"{order} dL_d{name}"
        )


def test_pallas_fused_backward_matches_dense(rng):
    m, v, c, s = _setup(rng, 17, 21, 2)

    def loss(fn):
        def f(m_, v_, c_):
            outs = fn(m_, v_, c_, s)
            return sum(jnp.sum(o**2) for o in outs.values())

        return f

    ref = jax.grad(
        loss(lambda *a: oracle.evaluate_all(*a)), argnums=(0, 1, 2)
    )(m, v, c)
    got = jax.grad(
        loss(lambda *a: sampling.sample_all(*a)), argnums=(0, 1, 2)
    )(m, v, c)
    for r, o in zip(ref, got):
        # Hand-derived VJP vs autodiff: different reduction orders, so the
        # tolerance scales with gradient magnitude.
        np.testing.assert_allclose(
            o, r, rtol=2e-3, atol=1e-5 * max(1.0, float(np.abs(r).max()))
        )


def test_block_boundary_sizes(rng):
    """Degenerate and odd shapes (single pair, non-power-of-two sizes)."""
    for P, N in [(1, 1), (5, 3), (130, 129), (257, 300)]:
        m, v, c, s = _setup(rng, P, N, 2, C=2)
        got = sampling.sample("value", m, v, c, s)
        ref = oracle.evaluate("value", m, v, c, s)
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=1e-5)
