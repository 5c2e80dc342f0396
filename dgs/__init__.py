"""Differentiable Gaussian sampling engine in JAX.

Public API (see docs/PARITY.md for the reference mapping):

  * ``GaussianSampler`` - the reference-shaped stateful facade
    (/root/reference/diff_gaussian_sampling/__init__.py:214-317).
  * Module-level functional forms mirroring the reference's
    (__init__.py:21-36) in JAX idiom: differentiable pure functions of
    (means, values, conics, samples) - gradient bookkeeping is jax.grad's
    job, so there is no ``debug`` positional arg (the reference's functional
    wrappers misname their first arg ``debug`` anyway; it receives ``means``).
  * ``SamplerConfig`` - runtime configuration (the reference's compile-time
    config.h:18-20, made dynamic).
"""

from .config import SamplerConfig, ORDERS, tri_size, tri_index  # noqa: F401
from .sampler import GaussianSampler  # noqa: F401
from .ops.sampling import (  # noqa: F401
    sample,
    sample_all,
    sample_binned,
    sample_dense_multi,
)
from .ops import aggregation  # noqa: F401
from .binning.grid import bin_samples, build as preprocess_gaussians  # noqa: F401


def sample_gaussians(means, values, conics, samples, **kw):
    """Field values (N, C) - reference sample_gaussians (ext.cpp:21)."""
    return sample("value", means, values, conics, samples, **kw)


def sample_gaussians_derivative(means, values, conics, samples, **kw):
    """First derivatives (N, D, C) - ext.cpp:23."""
    return sample("derivative", means, values, conics, samples, **kw)


def sample_gaussians_laplacian(means, values, conics, samples, **kw):
    """Full Hessian (N, D, D, C), 'laplacian' in reference naming -
    ext.cpp:25."""
    return sample("laplacian", means, values, conics, samples, **kw)


def sample_gaussians_third_derivative(means, values, conics, samples, **kw):
    """Third-derivative tensor (N, D, D, D, C) - ext.cpp:27."""
    return sample("third", means, values, conics, samples, **kw)


def preprocess_aggregate(cfg, means, conics, radii, method: str = "grid",
                         **kw):
    """Neighbor structure build (reference preprocess_aggregate, ext.cpp:29
    / aggregate_neighbors.cu:323-367), mirroring the facade's ``method``
    dispatch at the functional surface:

      * ``"pallas"`` - the production chunk-packed structure
        (``aggregation.AggBinning``) driving the fused pair sweeps;
        capacities planned from the collision radii.
      * ``"grid"`` - world-grid cell-list neighbor table (``Neighbors``).
      * ``"dense"`` - the reference-shaped O(P^2) scan (``Neighbors``).

    Either return value feeds ``aggregate_neighbors`` below."""
    if method == "pallas":
        cfg, plan = aggregation.plan_pallas(cfg, means, radii)
        return aggregation.preprocess_pallas(
            cfg, means, conics, radii, plan, **kw)
    if method == "grid":
        return aggregation.preprocess_grid(cfg, means, conics, radii, **kw)
    if method == "dense":
        return aggregation.preprocess(cfg, means, conics, radii, **kw)
    raise ValueError(f"unknown preprocess_aggregate method: {method!r}")


def aggregate_neighbors(features, transform, queries, keys, frequencies,
                        distance_transform, neighbors):
    """Attention aggregation over the Gaussian cloud (ext.cpp:30);
    differentiable in all six parameter groups.  Dispatches on the neighbor
    structure: an ``aggregation.AggBinning`` (from ``preprocess_pallas``)
    routes to the fused pair sweeps, a ``Neighbors`` table to the
    neighbor-table path."""
    if isinstance(neighbors, aggregation.AggBinning):
        return aggregation.aggregate_pallas(
            features, transform, queries, keys, frequencies,
            distance_transform, neighbors)
    return aggregation.aggregate(features, transform, queries, keys,
                                 frequencies, distance_transform, neighbors)
