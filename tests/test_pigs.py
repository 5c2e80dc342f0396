"""PIGS-style training loop: loss decreases, grads reach every param group."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from dgs.config import SamplerConfig
from dgs.models import pigs
from dgs.models.field import init_field


def test_field_conic_covariance_consistency(rng):
    f = init_field(jax.random.PRNGKey(0), 50, 2, 3, sigma=0.1)
    cov = np.asarray(f.covariances())
    con = np.asarray(f.conics())
    for p in range(0, 50, 7):
        Cm = np.array([[cov[p, 0], cov[p, 1]], [cov[p, 1], cov[p, 2]]])
        Km = np.array([[con[p, 0], con[p, 1]], [con[p, 1], con[p, 2]]])
        np.testing.assert_allclose(Cm @ Km, np.eye(2), atol=1e-4)


@pytest.mark.parametrize("method", ["dense", "tiled"])
def test_training_reduces_loss(method):
    cfg = SamplerConfig()
    state, history = pigs.train(
        cfg, P=64, D=2, C=1, steps=60, n_collocation=256,
        learning_rate=1e-2, sigma=0.25, method=method, log_every=59,
    )
    assert history[0]["loss"] > history[-1]["loss"]
    assert history[-1]["loss"] < 0.7 * history[0]["loss"]
    if method == "tiled":
        assert history[-1]["bin_overflow"] == 0
        assert history[-1]["entry_overflow"] == 0


def test_grads_reach_scales_and_rotations():
    """dL/dconic chains through the field parameterization
    (the PIGS python-side chain, SURVEY.md section 0)."""
    cfg = SamplerConfig()
    u_star, f_rhs = pigs.manufactured_solution(2)
    field = init_field(jax.random.PRNGKey(1), 32, 2, 1, sigma=0.2)
    x = jax.random.uniform(jax.random.PRNGKey(2), (64, 2), minval=-1, maxval=1)

    def loss(f):
        l, _ = pigs.pigs_loss(cfg, f, x, x, u_star(x), f_rhs, method="dense")
        return l

    g = jax.grad(loss)(field)
    assert float(jnp.abs(g.means).max()) > 0
    assert float(jnp.abs(g.log_scales).max()) > 0
    assert float(jnp.abs(g.rotations).max()) > 0
    assert float(jnp.abs(g.values).max()) > 0


def test_checked_step_localizes_injected_nan():
    """Compiled-step NaN localization (the in-jit CHECK_CUDA equivalent,
    utils/debug.checked): a NaN injected into the parameters of a JITTED
    PIGS loss+grad step must raise a checkify error that names the failing
    primitive - without leaving the compiled path."""
    from dgs.utils import debug

    cfg = SamplerConfig()
    u_star, f_rhs = pigs.manufactured_solution(2)
    field = init_field(jax.random.PRNGKey(1), 32, 2, 1, sigma=0.2)
    x = jax.random.uniform(jax.random.PRNGKey(2), (64, 2), minval=-1,
                           maxval=1)

    def step(f):
        (l, _), g = jax.value_and_grad(
            lambda f_: pigs.pigs_loss(cfg, f_, x, x, u_star(x), f_rhs,
                                      method="dense"),
            has_aux=True)(f)
        return l, g

    checked_step = jax.jit(debug.checked(step))
    # Clean parameters: no error raised.
    err, (l, g) = checked_step(field)
    debug.throw(err)
    assert np.isfinite(float(l))
    # Inject a NaN into one mean; the checked step localizes it.
    bad = field._replace(means=field.means.at[3, 0].set(jnp.nan))
    err, _ = checked_step(bad)
    with pytest.raises(Exception, match="nan"):
        debug.throw(err)


def test_checkpoint_roundtrip(tmp_path):
    from dgs.utils import checkpoint

    field = init_field(jax.random.PRNGKey(3), 8, 2, 1)
    opt = optax.adam(1e-3)
    state = pigs.TrainState(field, opt.init(field), jnp.zeros((), jnp.int32))
    path = str(tmp_path / "ckpt")
    checkpoint.save(path, state)
    restored = checkpoint.restore(path, state)
    np.testing.assert_allclose(restored.field.means, state.field.means)
    assert int(restored.step) == 0
