"""Dynamics model: neighbor-aggregation rollouts learn an analytic flow.

Exercises the full PIGS-dynamics composition the reference was built for
(SURVEY.md 3.5): fit a field, build neighbor lists (grid path), roll the
aggregation layer forward in time, and backprop through the rollout to all
six parameter groups.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dgs.config import SamplerConfig
from dgs.models import dynamics


@pytest.mark.slow
def test_dynamics_training_reduces_loss():
    cfg = SamplerConfig(tile_size=0.51)
    params, hist = dynamics.train(
        cfg, P=128, D=2, steps=60, rollout=2, n_eval=512,
        neighbor_capacity=64, log_every=10,
    )
    losses = [h["loss"] for h in hist]
    assert all(np.isfinite(losses))
    assert hist[0]["nbr_overflow"] == 0
    # The residual updates must learn to beat the frozen-field baseline.
    assert losses[-1] < 0.7 * losses[0], losses


def test_rollout_step_differentiable_through_scan():
    cfg = SamplerConfig(tile_size=0.51)
    key = jax.random.PRNGKey(0)
    from dgs.models.field import init_field
    from dgs.oracle.dense import radii as compute_radii
    from dgs.ops import aggregation

    field = init_field(key, 64, 2, 1, sigma=0.15)
    rad = compute_radii(field.covariances(), 2, cfg.radius_sigma,
                        cfg.eig_floor)
    nbr = aggregation.preprocess_grid(
        cfg.with_dims(2), field.means, field.conics(), rad, 48
    )
    params = dynamics.init_dynamics_params(key, 64, 1, 2)

    def loss(params):
        def body(v, _):
            return dynamics.rollout_step(params, v, nbr), None
        v, _ = jax.lax.scan(body, field.values, None, length=3)
        return jnp.sum(v**2)

    grads = jax.grad(loss)(params)
    flat = jax.tree_util.tree_leaves(grads)
    assert all(bool(jnp.all(jnp.isfinite(g))) for g in flat)
    # At least transform/queries/keys must receive signal.
    assert float(jnp.abs(grads.transform).sum()) > 0
    assert float(jnp.abs(grads.queries).sum()) > 0


@pytest.mark.slow
def test_dynamics_pallas_aggregation_with_tiled_eval_learns():
    """The large-P production combination: Pallas chunked aggregation
    kernels for the dynamics layer + binned Pallas sampler for the rollout
    evaluation (dense pair arrays are tens of GB at 100k Gaussians)."""
    from dgs.config import SamplerConfig
    from dgs.models import dynamics

    params, hist = dynamics.train(
        SamplerConfig(eig_floor=1e-12), P=300, D=2, steps=30, rollout=2,
        sigma=0.12, n_eval=512, method="pallas", eval_method="tiled",
        log_every=10,
    )
    assert hist[-1]["nbr_overflow"] == 0
    assert hist[-1]["loss"] < hist[0]["loss"] * 0.7, [h["loss"] for h in hist]


@pytest.mark.slow
def test_dynamics_ladder_frequencies_and_scan_chunk_learns():
    """Production loop shape: shared-base frequency ladder (angle-addition
    sincos recurrence in the Pallas kernels), scan-chunked optimizer steps,
    batched rollout evaluation - loss still converges and the in-step
    eval overflow stays 0."""
    params, hist = dynamics.train(
        SamplerConfig(eig_floor=1e-12), P=300, D=2, steps=30, rollout=2,
        sigma=0.12, n_eval=512, method="pallas", eval_method="tiled",
        log_every=10, ladder_frequencies=True, scan_chunk=5,
    )
    assert params.frequencies.shape == (1,)
    assert hist[-1]["nbr_overflow"] == 0
    assert hist[-1]["eval_overflow"] == 0
    assert hist[-1]["loss"] < hist[0]["loss"] * 0.7, [h["loss"] for h in hist]
