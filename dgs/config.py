"""Runtime configuration for the Gaussian sampling engine.

The CUDA reference hard-codes its configuration at compile time
(/root/reference/cuda_sampler/config.h:18-20: ``BLOCK_SIZE 0.51f``, ``#define
TORUS``, ``typedef float FLOAT``).  Here everything is a runtime dataclass that
is hashable so it can be passed as a static argument to ``jax.jit`` /
``jax.custom_vjp``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Packed upper-triangular size for a symmetric DxD matrix
# (reference stores covariances/conics this way: sample_points.cu:167).
def tri_size(D: int) -> int:
    return D * (D + 1) // 2


def tri_index(D: int, i: int, j: int) -> int:
    """Index into the packed upper-triangular representation.

    Row-major upper triangle: D=2 -> [(0,0), (0,1), (1,1)] matching the
    reference layout con[0]=c_xx, con[1]=c_xy, con[2]=c_yy
    (forward.cu:177: power = -0.5*(c0*x^2 + c2*y^2) - c1*x*y).
    """
    u, v = (i, j) if i <= j else (j, i)
    return u * D - u * (u - 1) // 2 + (v - u)


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Static configuration for the sampling engine.

    Attributes:
      period: Domain period per-axis for the periodic (torus) domain, or
        ``None`` for an open domain.  The reference uses a compile-time torus
        of period 2 on [-1, 1]^D (config.h:19, auxiliary.h:23-25).
      lower: Lower corner of the tile grid (world units). The reference derives
        this from sample bounds at runtime, which forces a host sync
        (sample_points.cu:70-74); we make it static for XLA.
      tile_size: World-space tile edge (reference BLOCK_SIZE 0.51, config.h:18).
      radius_sigma: Gaussian footprint cutoff in standard deviations
        (reference: 3 sigma, forward.cu:52-61).
      max_tiles_per_gaussian: Static cap on the per-Gaussian tile footprint per
        axis (replaces the reference's dynamic ``num_rendered``,
        sampler_impl.cu:256-257, with a static capacity).

    Evaluation dtype is fp32 throughout, matching the reference
    (config.h:20); overflow in any static capacity is counted and reported,
    never silently wrong.
    """

    period: Optional[float] = 2.0
    lower: Tuple[float, ...] = (-1.0, -1.0)
    # Upper corner for OPEN (non-periodic) domains; ignored when period is
    # set (the reference is torus-only, config.h:19 - open domains are an
    # extension).
    upper_bounds: Optional[Tuple[float, ...]] = None
    tile_size: float = 0.51
    radius_sigma: float = 3.0
    # Numerical floor inside the eigenvalue solve for the footprint radius.
    # The reference hard-codes 1e-6 (forward.cu:59), which inflates the radius
    # of very small Gaussians to ~3*sqrt(1e-3); lower it for small-sigma
    # workloads.
    eig_floor: float = 1e-6
    max_tiles_per_gaussian: int = 4
    # Static capacity of the compacted duplicate-entry list, as a multiple of
    # P.  Enumeration capacity is P * R^D; after the tile sort, sentinel
    # (unused) slots are compacted away down to ceil(factor * P) entries so
    # sparse footprints don't pay for the worst case.  Valid entries beyond
    # the capacity are counted in the overflow diagnostic.
    entry_capacity_factor: float = 4.0
    # Evaluate pairs from per-entry period-shifted means with NO per-pair
    # torus wrap.  Exact iff every footprint is compact:
    # max_radius + tile_size < period / 2 per axis (the planner certifies
    # this - utils.native.plan_capacities["safe_unwrapped"]).  The binning
    # always carries the image shifts; this flag only switches the kernels.
    unwrapped_kernels: bool = False
    # Per-axis footprint radii (oracle.dense.radii_axis): bin each Gaussian
    # by the TIGHT axis-aligned bounding box of its radius_sigma-sigma
    # ellipsoid instead of the reference's looser isotropic
    # sqrt(lambda_max) box (forward.cu:52-61).  Same support, fewer
    # duplicates/pairs on anisotropic fields (measured -23% pairs / -27%
    # entries at the D=3 operating point).  Off by default for exact
    # reference rect semantics.
    axis_radii: bool = False
    # Exact ellipsoid-vs-tile culling (binning/grid.ellip_keep): drop every
    # candidate tile whose box the radius_sigma-sigma ellipsoid does not
    # intersect.  Any (per-axis or isotropic) bounding BOX keeps corner
    # tiles the ellipsoid never touches (ellipse/box area pi/4 at D=2,
    # ellipsoid/box volume pi/6 at D=3); a short coordinate-descent solve of
    # min_{x in tile} (x-mu)^T conic (x-mu) culls them exactly.  Same
    # support as the box footprint (a strict subset of its tiles), so this
    # composes with axis_radii.  Off by default for reference rect-semantics
    # parity (like axis_radii); D=1 and full-cover footprints are unchanged.
    ellip_cull: bool = False

    # Pair-kernel block sizes (powers of two, kernels/tiled.py): block_n
    # samples x block_e (= block_p) entries per pair tile, for the forward
    # and, separately, the backward; the defaults are the fastest of a
    # block-size sweep on the H100 (PERF.md).  The chunked path uses
    # (block_n, block_p) as its chunk sizes in both directions.
    block_n: int = 32
    block_p: int = 16
    block_n_bwd: Optional[int] = 16
    block_p_bwd: Optional[int] = 16

    def __post_init__(self):
        # Periodic domains require the tile grid to cover the period
        # EXACTLY.  With grid*tile > period, the overhang band
        # [period, grid*tile) is phantom space: the unwrapped floor/ceil
        # index math of the rect enumeration and the modulo-grid wrap
        # disagree there, and entries whose footprint crosses the seam
        # silently miss the wrapped tile (dropped pairs in a
        # grid*tile - period wide band).  Snap the tile size to
        # period / grid with grid = ceil(period/tile - 1e-9): existing
        # grids keep their size (exact divisors like 0.25 don't bump up a
        # tile), the tile only shrinks to fit.
        if self.period is not None:
            import math

            grid = max(1, math.ceil(self.period / self.tile_size - 1e-9))
            object.__setattr__(self, "tile_size", self.period / grid)

    @property
    def bwd_blocks(self):
        """(block_n_bwd, block_p_bwd); unset sizes follow the forward's."""
        return self.block_n_bwd or self.block_n, self.block_p_bwd or self.block_p

    @property
    def D(self) -> int:
        return len(self.lower)

    def grid_shape(self) -> Tuple[int, ...]:
        """Static tile-grid shape.

        Mirrors the reference grid computation
        ``ceil((max - min + 1e-6) / BLOCK_SIZE)`` (sample_points.cu:70-74) but
        over the configured domain instead of data-dependent sample bounds.
        """
        if self.period is not None:
            # tile_size is snapped to period/grid (__post_init__), so the
            # division is integral up to float rounding - round, don't ceil.
            return tuple(
                round(self.period / self.tile_size) for _ in range(self.D)
            )
        extent = [u - l for l, u in zip(self.lower, self.upper)]
        return tuple(int(-(-(e + 1e-6) // self.tile_size)) for e in extent)

    @property
    def upper(self) -> Tuple[float, ...]:
        if self.period is not None:
            return tuple(l + self.period for l in self.lower)
        if self.upper_bounds is not None:
            return self.upper_bounds
        raise ValueError(
            "open-domain config (period=None) requires upper_bounds"
        )

    def with_dims(self, D: int) -> "SamplerConfig":
        if self.D == D:
            return self
        up = (tuple(self.upper_bounds[0] for _ in range(D))
              if self.upper_bounds is not None else None)
        return dataclasses.replace(
            self, lower=tuple(self.lower[0] for _ in range(D)),
            upper_bounds=up,
        )


# The four evaluation orders exposed by the reference
# (ext.cpp:20-27: sample_gaussians / _derivative / _laplacian / _third_derivative).
ORDERS = ("value", "derivative", "laplacian", "third")


def n_components(order: str, D: int) -> int:
    return {"value": 1, "derivative": D, "laplacian": D * D, "third": D * D * D}[order]


def out_shape(order: str, N: int, D: int, C: int) -> Tuple[int, ...]:
    """Output shapes matching the reference allocations.

    value (N,C) / derivative (N,D,C) / laplacian==Hessian (N,D,D,C) /
    third (N,D,D,D,C)  (sample_points.cu:215, 240, 265, 290).
    """
    return {
        "value": (N, C),
        "derivative": (N, D, C),
        "laplacian": (N, D, D, C),
        "third": (N, D, D, D, C),
    }[order]
