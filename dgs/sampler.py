"""Stateful GaussianSampler facade - the reference-shaped public API.

Drop-in analogue of the reference's ``GaussianSampler`` (__init__.py:214-317):
``preprocess`` builds the binning acceleration structure once, the four
``sample_gaussians*`` methods evaluate over it, ``preprocess_aggregate`` /
``aggregate_neighbors`` drive the neighbor-attention subsystem.  Added beyond
the reference: ``sample_all`` (fused multi-order, one pairwise pass instead of
four kernel launches) and ``method`` selection (tiled / chunked / dense).

Jit-compatibility note: this facade is EAGER by design, mirroring the
reference's host-driven API - ``preprocess`` and ``preprocess_aggregate``
read overflow counters and capacity plans back to the host (device->host
syncs), so they cannot be traced inside a jitted step.
Training loops that want one compiled program per step should size a
``SamplerConfig`` once via the capacity planners
(``utils.native.plan_capacities`` -> ``config_from_plan``,
``ops.sampling_chunked.plan_chunked``, ``ops.aggregation.plan_pallas``) and
call the functional ops (``ops.sampling.sample_binned``,
``ops.sampling_chunked.sample_chunked``, ``ops.aggregation``) directly -
those are fully jit-compatible with in-graph overflow diagnostics.  The
``sample_gaussians*`` / ``sample_all`` / ``aggregate_neighbors`` methods
themselves are pure and trace fine once the preprocess state exists.
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp

from .config import SamplerConfig
from .binning import grid as binning
from .ops import sampling
from .ops import aggregation
from .utils.debug import snapshot_call


class GaussianSampler:
    def __init__(self, debug: bool = False,
                 config: SamplerConfig = SamplerConfig(),
                 method: str = "tiled"):
        if method not in ("tiled", "chunked", "dense"):
            raise ValueError(f"unknown sampling method {method!r}; "
                             "expected tiled, chunked or dense")
        self.debug = debug
        self.config = config
        self.method = method

    # -- sampling ----------------------------------------------------------

    def _validate(self, means, values, covariances, conics, samples):
        """Shape (and, in debug mode, finiteness) validation with named
        errors - the reference segfaults or corrupts on these."""
        from .config import tri_size

        P, D = means.shape
        tri = tri_size(D)
        checks = [
            ("values", values, (P, None)),
            ("covariances", covariances, (P, tri)),
            ("conics", conics, (P, tri)),
            ("samples", samples, (None, D)),
        ]
        for name, arr, want in checks:
            if arr.ndim != 2 or any(
                w is not None and s != w for s, w in zip(arr.shape, want)
            ):
                want_s = tuple("*" if w is None else w for w in want)
                raise ValueError(
                    f"{name} has shape {tuple(arr.shape)}, expected {want_s} "
                    f"for P={P} Gaussians in D={D} dims"
                )
        if self.debug:
            from .utils.debug import check_finite

            check_finite("preprocess inputs", {
                "means": means, "values": values,
                "covariances": covariances, "conics": conics,
                "samples": samples,
            })

    def preprocess(self, means, values, covariances, conics, samples):
        """Build and store the acceleration structure
        (reference preprocess, __init__.py:218-233)."""
        P, D = means.shape
        self._validate(means, values, covariances, conics, samples)
        cfg = self.config.with_dims(D)
        self.config = cfg
        self.means, self.values, self.conics = means, values, conics
        self.covariances, self.samples = covariances, samples

        if self.method == "tiled":
            state = snapshot_call(
                self.debug, "preprocess", binning.build_jit, cfg, means,
                covariances, samples,
            )
            self.state = state
            # Aggregation (preprocess_aggregate) consumes SCALAR collision
            # radii (aggregate_neighbors.cu:28); under cfg.axis_radii the
            # binning carries per-axis rects, so keep the scalar form here.
            from .oracle.dense import radii as compute_radii

            self.radii = (state.radii if state.radii.ndim == 1 else
                          compute_radii(covariances, D, cfg.radius_sigma,
                                        cfg.eig_floor))
            if self.debug:
                rect_of = int(jax.device_get(state.overflow))
                ent_of = int(jax.device_get(state.entry_overflow))
                if rect_of:
                    raise ValueError(
                        f"binning overflow: {rect_of} Gaussians exceed "
                        f"max_tiles_per_gaussian={cfg.max_tiles_per_gaussian}"
                        "; raise it in SamplerConfig (see "
                        "dgs.utils.native.plan_capacities)"
                    )
                if ent_of:
                    raise ValueError(
                        f"binning entry overflow: {ent_of} (gaussian, tile) "
                        "entries dropped; raise "
                        f"entry_capacity_factor={cfg.entry_capacity_factor} "
                        "in SamplerConfig"
                    )
            bn, be = cfg.block_n, cfg.block_p
            bbn, bbe = cfg.bwd_blocks
            self._fwd_geom = binning.forward_geometry(state, bn, be)
            self._bwd_geom = binning.backward_geometry(state, bbe, bbn)
            self._blocks = (bn, be, bbn, bbe)
        elif self.method == "chunked":
            # Chunk-packed path (ops/sampling_chunked.py) - the D=3
            # production path: both pair-sweep sides padded per tile so
            # every work item is a same-tile chunk pair.  Eager host-side
            # capacity plan, mirroring the tiled branch's exact sizing.
            from .oracle.dense import radii as compute_radii
            from .ops import sampling_chunked

            cfg, plan = sampling_chunked.plan_chunked(
                cfg, means, covariances, samples)
            self.config = cfg
            self.state = None
            self.radii = compute_radii(
                covariances, D, cfg.radius_sigma, cfg.eig_floor)
            self._chunk_plan = plan
            self._chunk_samples = snapshot_call(
                self.debug, "preprocess", sampling_chunked.chunk_samples,
                cfg, samples, plan, cfg.block_n,
            )
            if self.debug:
                s_of = int(jax.device_get(self._chunk_samples.overflow))
                if s_of:
                    raise ValueError(
                        f"chunked sample overflow: {s_of} samples beyond the "
                        "planned chunk capacity"
                    )
        else:
            from .oracle.dense import radii as compute_radii

            self.state = None
            self.radii = compute_radii(covariances, D, cfg.radius_sigma, cfg.eig_floor)

    def _run(self, orders) -> Dict[str, jnp.ndarray]:
        cfg = self.config
        if self.method == "tiled":
            bn, be, bbn, bbe = self._blocks
            outs = snapshot_call(
                self.debug, "sample", sampling.sample_tiled_multi,
                tuple(orders), cfg, self.means, self.values,
                self.conics, self.samples, self.state, self._fwd_geom,
                self._bwd_geom,
                block_n=bn, block_e=be, bwd_block_n=bbn, bwd_block_e=bbe,
                unwrapped=cfg.unwrapped_kernels,
            )
            return dict(zip(orders, outs))
        if self.method == "chunked":
            from .ops import sampling_chunked

            outs, diag = snapshot_call(
                self.debug, "sample", sampling_chunked.sample_chunked,
                cfg, self.means, self.values, self.conics, self.covariances,
                self.samples, self._chunk_plan, self._chunk_samples,
                tuple(orders),
            )
            if self.debug:
                bad = {k: int(jax.device_get(v))
                       for k, v in diag.items()
                       if k != "perm" and int(jax.device_get(v))}
                if bad:
                    raise ValueError(
                        f"chunked sampling overflow {bad}; re-run preprocess "
                        "(parameters drifted past the planned capacities)"
                    )
            return outs
        return sampling.sample_all(
            self.means, self.values, self.conics, self.samples,
            period=cfg.period, orders=orders,
        )

    def sample_gaussians(self):
        return self._run(("value",))["value"]

    def sample_gaussians_derivative(self):
        return self._run(("derivative",))["derivative"]

    def sample_gaussians_laplacian(self):
        return self._run(("laplacian",))["laplacian"]

    def sample_gaussians_third_derivative(self):
        return self._run(("third",))["third"]

    def sample_all(self, orders=sampling.ALL_ORDERS):
        """Fused evaluation of several orders in one pairwise pass."""
        return self._run(tuple(orders))

    # -- neighbor aggregation ---------------------------------------------

    def preprocess_aggregate(self, neighbor_capacity: Optional[int] = None,
                             method: str = "grid",
                             rect_capacity: Optional[int] = None):
        """Build neighbor lists (reference preprocess_aggregate,
        __init__.py:291-301).  method="pallas" (the production path) builds
        the chunk-packed structure driving the fused pair sweeps
        (kernels/aggregate.py) - no neighbor capacity to truncate;
        "grid" uses the world-grid cell-list search (O(P*candidates));
        "dense" the reference-shaped O(P^2) scan.  Unset capacities are
        planned from the collision radii (grid tile matched to them, exact
        per-tile table width)."""
        if method == "pallas":
            cfg, plan = aggregation.plan_pallas(
                self.config, self.means, self.radii)
            agg = snapshot_call(
                self.debug, "preprocess_agg", aggregation.preprocess_pallas,
                cfg, self.means, self.conics, self.radii, plan,
            )
        elif method == "grid":
            cfg = self.config
            if neighbor_capacity is None or rect_capacity is None:
                cfg, nc_auto, rect_auto = aggregation.suggest_grid_capacities(
                    cfg, self.means, self.radii
                )
                neighbor_capacity = neighbor_capacity or nc_auto
                rect_capacity = rect_capacity or rect_auto
            agg = snapshot_call(
                self.debug, "preprocess_agg", aggregation.preprocess_grid,
                cfg, self.means, self.conics, self.radii,
                neighbor_capacity, rect_capacity,
            )
        else:
            agg = snapshot_call(
                self.debug, "preprocess_agg", aggregation.preprocess,
                self.config, self.means, self.conics, self.radii,
                neighbor_capacity,
            )
        if self.debug:
            of = int(jax.device_get(agg.overflow))
            if of:
                raise ValueError(
                    f"neighbor table overflow: {of} candidates dropped; "
                    "raise neighbor_capacity / rect_capacity"
                )
        self.neighbors = agg
        return agg

    def aggregate_neighbors(self, features, transform, queries, keys,
                            frequencies, distance_transform):
        """Attention aggregation over the stored neighbor structure
        (reference aggregate_neighbors, __init__.py:303-317).  Dispatches on
        what preprocess_aggregate built: the chunk structure routes to the
        fused pair sweeps, the table forms to the neighbor-table path."""
        if isinstance(self.neighbors, aggregation.AggBinning):
            return snapshot_call(
                self.debug, "aggregate", aggregation.aggregate_pallas,
                features, transform, queries, keys, frequencies,
                distance_transform, self.neighbors,
            )
        return snapshot_call(
            self.debug, "aggregate", aggregation.aggregate,
            features, transform, queries, keys, frequencies,
            distance_transform, self.neighbors,
        )
