"""Native C++ capacity planner vs the jnp binning pipeline."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dgs.config import SamplerConfig
from dgs.binning import grid as binning
from dgs.oracle import dense as oracle
from dgs.ops import aggregation
from dgs.utils import native

from conftest import make_gaussians, make_samples


def test_planner_matches_jnp_binning(rng):
    means, values, covs, conics = make_gaussians(rng, 200, 2, 2)
    samples = make_samples(rng, 500, 2)
    cfg = SamplerConfig(max_tiles_per_gaussian=8)
    plan = native.plan_capacities(cfg, means, covs, samples)

    m, cov, s = map(jnp.asarray, (means, covs, samples))
    state = binning.build(cfg, m, cov, s)
    assert int(state.overflow) == 0
    T = binning.num_tiles(cfg, 2)
    ent_tile = np.asarray(state.ent_tile[0])
    valid = ent_tile < T
    assert plan["entries"] == int(valid.sum())

    rad = np.asarray(state.radii)
    assert plan["culled"] == int((rad <= 0).sum())

    lo, hi = binning.gaussian_rects(cfg, m, state.radii)
    assert plan["max_extent"] == int(np.asarray(hi - lo).max())

    bn, be = cfg.block_n, cfg.block_p
    bbn, bbe = cfg.bwd_blocks
    _, fn = binning.forward_geometry(state, bn, be)
    _, bnn = binning.backward_geometry(state, bbe, bbn)
    assert plan["work_blocks_fwd"] >= int(jnp.max(fn))
    assert plan["work_blocks_bwd"] >= int(jnp.max(bnn))
    # the planner is exact, not just an upper bound
    assert plan["work_blocks_fwd"] == int(jnp.max(fn))
    assert plan["work_blocks_bwd"] == int(jnp.max(bnn))


def test_planner_capacities_make_binning_exact(rng):
    """Configure SamplerConfig straight from the plan -> zero overflows."""
    means, values, covs, conics = make_gaussians(
        rng, 300, 2, 2, sigma_range=(0.05, 0.4)
    )
    samples = make_samples(rng, 700, 2)
    plan = native.plan_capacities(SamplerConfig(), means, covs, samples)
    cfg = SamplerConfig(
        max_tiles_per_gaussian=max(int(plan["max_extent"]), 1),
        entry_capacity_factor=max(plan["entries"] / 300 + 1, 1.0),
    )
    state = binning.build(
        cfg, jnp.asarray(means), jnp.asarray(covs), jnp.asarray(samples)
    )
    assert int(state.overflow) == 0


def test_max_collisions_matches_reference(rng):
    means, values, covs, conics = make_gaussians(
        rng, 60, 2, 1, sigma_range=(0.1, 0.3)
    )
    cfg = SamplerConfig()
    rad = np.asarray(oracle.radii(jnp.asarray(covs), 2))
    got = native.max_collisions(cfg, means, rad)
    want = aggregation.suggest_capacity(
        cfg, jnp.asarray(means), jnp.asarray(rad)
    )
    assert got == want


def test_planner_cpp_matches_numpy_both_domains(rng):
    """The C++ planner and the numpy fallback must agree exactly, for the
    periodic torus AND the open domain (regressions: the C planner received
    period=0 as the open-domain world extent; the fallback counted entries
    truncated to the unplanned capacity)."""
    import jax

    from dgs.models.field import init_field
    from dgs.utils import native

    f = init_field(jax.random.PRNGKey(0), 500, 2, 2, sigma=0.05)
    x = jnp.asarray(make_samples(rng, 2000, 2))
    for period, ub in ((None, (1.0, 1.0)), (2.0, None)):
        cfg = SamplerConfig(period=period, lower=(-1.0, -1.0),
                            upper_bounds=ub, tile_size=0.2, eig_floor=1e-12,
                            max_tiles_per_gaussian=8)
        plan_c = native.plan_capacities(cfg, f.means, f.covariances(), x)
        plan_np = native._plan_capacities_numpy(
            cfg.with_dims(2), jnp.asarray(f.means),
            jnp.asarray(f.covariances()), x,
            cfg.block_n, cfg.block_p, *cfg.bwd_blocks)
        for k in ("entries", "max_extent", "max_tile_entries",
                  "work_items_fwd", "work_items_bwd", "culled",
                  "occupied_tiles"):
            assert plan_c[k] == plan_np[k], (period, k, plan_c[k], plan_np[k])


@pytest.mark.parametrize("D", [2, 3])
def test_planner_ellip_cull_matches_numpy(rng, D):
    """cfg.ellip_cull through the C planner: the coordinate-descent
    ellipsoid-vs-tile cull (csrc ellip_keep_tile) must agree with the
    device binning (numpy fallback runs binning.build) up to f32/f64
    borderline tiles, and must cull a meaningful fraction of the box
    footprint's entries."""
    import jax

    from dgs.models.field import init_field
    from dgs.utils import native

    f = init_field(jax.random.PRNGKey(0), 300, D, 2, sigma=0.08)
    x = jnp.asarray(make_samples(rng, 1000, D))
    cfg = SamplerConfig(tile_size=0.1, eig_floor=1e-12,
                        max_tiles_per_gaussian=10, ellip_cull=True,
                        ).with_dims(D)
    plan_c = native.plan_capacities(cfg, f.means, f.covariances(), x)
    plan_np = native._plan_capacities_numpy(
        cfg, jnp.asarray(f.means), jnp.asarray(f.covariances()), x,
        cfg.block_n, cfg.block_p, *cfg.bwd_blocks)
    # Borderline CD minima near the sigma level may flip between the f64
    # planner and the f32 device build; allow a tiny disagreement (the
    # runtime capacities carry a ~2% pad for exactly this).
    assert abs(plan_c["entries"] - plan_np["entries"]) <= max(
        2, plan_np["entries"] // 200), (plan_c["entries"], plan_np["entries"])
    import dataclasses

    plan_box = native.plan_capacities(
        dataclasses.replace(cfg, ellip_cull=False), f.means,
        f.covariances(), x)
    assert plan_c["entries"] < plan_box["entries"]


def test_anisotropic_open_box_plan_matches_numpy(rng):
    """Per-axis extents through the C planner: a (2 x 1 x 0.5) open box must
    produce the same plan as the numpy fallback (which uses the per-axis
    grid of SamplerConfig.grid_shape)."""
    import numpy as np
    from conftest import make_gaussians

    P, N, D = 300, 800, 3
    means, _, covs, _ = make_gaussians(rng, P, D, 1, sigma_range=(0.03, 0.08))
    # Anisotropic box [-1,1] x [-0.5,0.5] x [-0.25,0.25]
    means = np.asarray(means) * np.array([[1.0, 0.5, 0.25]], np.float32)
    samples = (rng.uniform(-1.0, 1.0, (N, D)).astype(np.float32)
               * np.array([[1.0, 0.5, 0.25]], np.float32))
    cfg = SamplerConfig(
        period=None, lower=(-1.0, -0.5, -0.25),
        upper_bounds=(1.0, 0.5, 0.25), tile_size=0.11,
        max_tiles_per_gaussian=8, eig_floor=1e-12,
    )
    if native._load() is None:
        import pytest
        pytest.skip("native planner unavailable")
    plan_c = native.plan_capacities(cfg, jnp.asarray(means), covs,
                                    jnp.asarray(samples))
    bn, be = cfg.block_n, cfg.block_p
    bbn, bbe = cfg.bwd_blocks
    plan_np = native._plan_capacities_numpy(
        cfg, jnp.asarray(means), covs, jnp.asarray(samples), bn, be, bbn, bbe)
    for k in ("entries", "max_extent", "max_tile_entries",
              "max_tile_samples", "culled", "occupied_tiles"):
        assert plan_c[k] == plan_np[k], (k, plan_c[k], plan_np[k])
