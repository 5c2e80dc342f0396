"""vjp_params_fused must reproduce the per-order folded VJP exactly.

The folded VJP is itself validated against the dense oracle and JAX autodiff
(tests/test_oracle.py, tests/test_kernels_dense.py); this locks the collapsed
multi-order closed form (the backward pair kernel's hot path) to it across
every order subset and D in {1, 2, 3}.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest

from dgs.config import tri_size
from dgs.ops import formulas

ORDERS = ("value", "derivative", "laplacian", "third")


def _subsets():
    out = []
    for r in range(1, 5):
        out.extend(itertools.combinations(ORDERS, r))
    return out


@pytest.mark.parametrize("D", [1, 2, 3])
def test_fused_matches_folded(D):
    rng = np.random.RandomState(D)
    tri = tri_size(D)
    n = 64
    Xs = [jnp.asarray(rng.randn(n).astype(np.float32)) for _ in range(D)]
    A = rng.randn(D, D).astype(np.float32)
    M = A @ A.T + np.eye(D, dtype=np.float32)
    con = [
        jnp.full((n,), M[i, j], jnp.float32)
        + 0.01 * jnp.asarray(rng.randn(n).astype(np.float32))
        for i in range(D)
        for j in range(i, D)
    ]
    G, a = formulas.power_terms(Xs, con)
    lp = formulas.component_polys("laplacian", Xs, con, a)
    tp = formulas.component_polys("third", Xs, con, a)

    for orders in _subsets():
        K = sum(formulas.n_unique(o, D) for o in orders)
        hs = [jnp.asarray(rng.randn(n).astype(np.float32)) for _ in range(K)]
        for extra in [(None, None), (lp, tp)]:
            dmu_f, dcon_f = formulas.vjp_params_fused(
                orders, Xs, con, G, a, hs, *extra
            )
            dmu_r = [jnp.zeros(n)] * D
            dcon_r = [jnp.zeros(n)] * tri
            k0 = 0
            for o in orders:
                nu = formulas.n_unique(o, D)
                dm, dc = formulas.vjp_params_folded(
                    o, Xs, con, G, a, hs[k0:k0 + nu]
                )
                dmu_r = [x + y for x, y in zip(dmu_r, dm)]
                dcon_r = [x + y for x, y in zip(dcon_r, dc)]
                k0 += nu
            for d in range(D):
                np.testing.assert_allclose(
                    dmu_f[d], dmu_r[d], rtol=3e-5, atol=3e-5,
                    err_msg=f"dmu[{d}] orders={orders} D={D}",
                )
            for t in range(tri):
                np.testing.assert_allclose(
                    dcon_f[t], dcon_r[t], rtol=3e-5, atol=3e-5,
                    err_msg=f"dcon[{t}] orders={orders} D={D}",
                )


def test_component_polys_match_components():
    D = 2
    rng = np.random.RandomState(0)
    n = 32
    Xs = [jnp.asarray(rng.randn(n).astype(np.float32)) for _ in range(D)]
    con = [jnp.asarray((rng.rand(n) + 1.0).astype(np.float32)),
           jnp.asarray((0.1 * rng.randn(n)).astype(np.float32)),
           jnp.asarray((rng.rand(n) + 1.0).astype(np.float32))]
    G, a = formulas.power_terms(Xs, con)
    for order in ORDERS:
        comps = formulas.components_unique(order, Xs, con, G, a)
        polys = formulas.component_polys(order, Xs, con, a)
        for w, p in zip(comps, polys):
            np.testing.assert_allclose(w, G * p, rtol=1e-6, atol=1e-7)
