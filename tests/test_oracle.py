"""Oracle correctness: analytic formulas vs autodiff vs finite differences.

This is config 1 of BASELINE.json: dense jnp evaluation with analytic grads
cross-checked against JAX autodiff and finite differences for all four
derivative orders, D in {1, 2, 3}.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dgs.config import n_components, tri_size
from dgs.oracle import dense as oracle
from dgs.ops import sampling

from conftest import make_gaussians, make_samples

jax.config.update("jax_enable_x64", False)

DIMS = [1, 2, 3]
ORDERS = ["value", "derivative", "laplacian", "third"]


def _setup(rng, P, N, D, C=3):
    means, values, covs, conics = make_gaussians(rng, P, D, C)
    samples = make_samples(rng, N, D)
    return means, values, covs, conics, samples


@pytest.mark.parametrize("D", DIMS)
def test_value_matches_manual_sum(rng, D):
    """Oracle value == explicit numpy mixture sum with torus wrap."""
    means, values, covs, conics, samples = _setup(rng, 17, 23, D)
    out = oracle.evaluate("value", means, values, conics, samples)
    # numpy reference
    expected = np.zeros((23, values.shape[1]), np.float64)
    for n in range(23):
        for p in range(17):
            X = means[p] - samples[n]
            X = X - 2.0 * np.round(X / 2.0)
            Cm = np.zeros((D, D))
            k = 0
            for i in range(D):
                for j in range(i, D):
                    Cm[i, j] = Cm[j, i] = conics[p, k]
                    k += 1
            power = -0.5 * X @ Cm @ X
            expected[n] += values[p] * np.exp(power)
    np.testing.assert_allclose(out, expected, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("D", DIMS)
def test_orders_are_successive_derivatives(rng, D):
    """derivative = d(value)/dx, laplacian = d(derivative)/dx,
    third = -d(laplacian)/dx  (the reference sign flip, forward.cu:247)."""
    means, values, covs, conics, samples = _setup(rng, 5, 1, D, C=2)
    m, v, c = jnp.asarray(means), jnp.asarray(values), jnp.asarray(conics)

    def at(order, x):
        return oracle.evaluate(order, m, v, c, x[None, :])[0]

    x0 = jnp.asarray(samples[0])

    jac_val = jax.jacfwd(lambda x: at("value", x))(x0)  # (C, D)
    deriv = at("derivative", x0)  # (D, C)
    np.testing.assert_allclose(jac_val.T, deriv, rtol=1e-4, atol=1e-5)

    jac_der = jax.jacfwd(lambda x: at("derivative", x))(x0)  # (D, C, D)
    lap = at("laplacian", x0)  # (D, D, C)
    np.testing.assert_allclose(
        jnp.transpose(jac_der, (0, 2, 1)), lap, rtol=1e-4, atol=1e-5
    )

    jac_lap = jax.jacfwd(lambda x: at("laplacian", x))(x0)  # (D, D, C, D)
    third = at("third", x0)  # (D, D, D, C)
    np.testing.assert_allclose(
        -jnp.transpose(jac_lap, (0, 1, 3, 2)), third, rtol=1e-4, atol=1e-5
    )


@pytest.mark.parametrize("D", DIMS)
@pytest.mark.parametrize("order", ORDERS)
def test_custom_vjp_matches_autodiff(rng, D, order):
    """Hand-derived closed-form VJP == JAX autodiff of the pure-jnp oracle."""
    means, values, covs, conics, samples = _setup(rng, 13, 19, D)
    m, v, c, s = map(jnp.asarray, (means, values, conics, samples))
    g = jnp.asarray(
        np.random.default_rng(1).normal(
            size=oracle.evaluate(order, m, v, c, s).shape
        ).astype(np.float32)
    )

    def loss_oracle(m_, v_, c_):
        return jnp.vdot(oracle.evaluate(order, m_, v_, c_, s), g)

    def loss_op(m_, v_, c_):
        return jnp.vdot(sampling.sample_dense(order, m_, v_, c_, s), g)

    ref = jax.grad(loss_oracle, argnums=(0, 1, 2))(m, v, c)
    got = jax.grad(loss_op, argnums=(0, 1, 2))(m, v, c)
    for r, o, name in zip(ref, got, ("means", "values", "conics")):
        np.testing.assert_allclose(
            o, r, rtol=5e-4, atol=5e-5, err_msg=f"{order} dL_d{name}"
        )


@pytest.mark.parametrize("D", [1, 2])
def test_grads_match_finite_differences(rng, D):
    """Directional central differences on a small, well-scaled problem.

    Broad Gaussians (sigma ~0.5) keep conics O(1) so fp32 loss evaluations
    are stable enough for finite differencing of all four orders.
    """
    means, values, covs, conics = make_gaussians(
        rng, 3, D, 1, sigma_range=(0.4, 0.7)
    )
    samples = make_samples(rng, 4, D)
    m, v, c, s = map(
        lambda x: jnp.asarray(x, jnp.float32), (means, values, conics, samples)
    )

    def loss(m_, v_, c_):
        outs = sampling.sample_dense_all(m_, v_, c_, s)
        return sum(jnp.sum(o**2) for o in outs.values())

    grads = jax.grad(loss, argnums=(0, 1, 2))(m, v, c)

    eps = 1e-3
    dirs = [
        jnp.asarray(rng.normal(size=a.shape).astype(np.float32)) for a in (m, v, c)
    ]
    for gi, name in enumerate(("means", "values", "conics")):
        args_hi = [m, v, c]
        args_lo = [m, v, c]
        args_hi[gi] = args_hi[gi] + eps * dirs[gi]
        args_lo[gi] = args_lo[gi] - eps * dirs[gi]
        fd = (float(loss(*args_hi)) - float(loss(*args_lo))) / (2 * eps)
        analytic = float(jnp.vdot(grads[gi], dirs[gi]))
        scale = max(abs(analytic), abs(fd), 1e-3)
        assert abs(analytic - fd) / scale < 2e-2, (
            f"fd dL_d{name}: analytic={analytic} fd={fd}"
        )


@pytest.mark.parametrize("D", [1, 2])
def test_torus_wrap_periodicity(rng, D):
    """Shifting samples by a full period leaves every order invariant."""
    means, values, covs, conics, samples = _setup(rng, 7, 9, D)
    m, v, c, s = map(jnp.asarray, (means, values, conics, samples))
    for order in ORDERS:
        a = oracle.evaluate(order, m, v, c, s)
        b = oracle.evaluate(order, m, v, c, s + 2.0)
        # fp32 cancellation in (mu - (x + 2)) bounds the achievable parity.
        np.testing.assert_allclose(
            a, b, rtol=1e-3, atol=1e-3 * float(np.abs(a).max())
        )


def test_fused_multi_order_matches_single(rng):
    means, values, covs, conics, samples = _setup(rng, 11, 13, 2)
    m, v, c, s = map(jnp.asarray, (means, values, conics, samples))
    fused = sampling.sample_dense_all(m, v, c, s)
    for order in ORDERS:
        single = oracle.evaluate(order, m, v, c, s)
        np.testing.assert_allclose(fused[order], single, rtol=1e-5, atol=1e-6)
