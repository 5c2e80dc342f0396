"""Neighbor aggregation: attention-style message passing over the Gaussian
cloud (the PIGS dynamics network).

JAX rebuild of aggregate_neighbors.cu:

  findCollisions (O(P^2) brute force into a PxP bool matrix,
  aggregate_neighbors.cu:18-55)            -> blocked vectorized collision
                                              search compacted into a
                                              capacity-padded neighbor table
  preprocess CSR {indices,dists,densities} -> same quantities, padded (P, NC)
  aggregateNeighbors fwd (129-208)         -> dense masked einsum pipeline
  aggregateNeighborsBackward (210-321)     -> JAX autodiff of the jnp forward
                                              (mathematically the same 6
                                              hand-derived gradients, without
                                              the atomicAdd scatter)

Semantics replicated exactly:
  * bounding radii shrunk by 0.2 for collision tests
    (aggregate_neighbors.cu:28, 38), self-pairs included (line 36 is
    commented out in the reference);
  * neighbor offsets normalized by 1/(0.333 * radius + 1e-6) (lines 74-75);
  * densities use the *neighbor's* conic on the unnormalized offset, pairs
    with positive quadratic form dropped (lines 107-120);
  * inv_total_density = 1/(sum + 1e-6) (line 125);
  * sinusoidal embedding layout: distance_transform has 2E entries; per dim d
    and frequency e, dt[d*(E-1)/D + 2e + {0,1}] weight sin/cos for the
    "embedding", dt[E + ...] for the "factor", biases at dt[E-1], dt[2E-1]
    (lines 178-193).

One deliberate fix: the reference's torus collision distance
``dx = min(dx, abs(2 - fmod(abs(dx), 2)))`` (line 46) fails to wrap negative
offsets; we use the true minimum-image distance.  (Documented deviation - it
only widens the neighbor candidate set the reference intended.)
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ..config import SamplerConfig, tri_size
from . import formulas


class Neighbors(NamedTuple):
    """Capacity-padded neighbor table (the reference's CSR arrays
    indices/ranges/dists/densities/inv_total_densities,
    aggregate_neighbors.cu:347-350, with padding instead of ragged ranges).

    The grid variant also carries the tile-sorted entry list (ent_gid), the
    per-tile entry range starts (ent_start), and each center's tile
    (tile_of_center): slot j of center i is entry
    ``ent_start[tile_of_center[i]] + j``.  aggregate() then fetches the
    neighbors' features/keys the same way preprocess_grid fetches
    parameters: monotone per-tile window gathers into a (T, NC, *) table
    plus one wide-row gather by center tile, instead of random (P, NC) row
    gathers."""

    indices: jnp.ndarray             # (P, NC) int32, -1 = invalid slot
    dists: jnp.ndarray               # (P, NC, D) normalized wrapped offsets
    densities: jnp.ndarray           # (P, NC)
    inv_total_densities: jnp.ndarray # (P,)
    overflow: jnp.ndarray            # () int32: collisions beyond capacity
    ent_gid: Optional[jnp.ndarray] = None         # (E,) int32, P = sentinel
    ent_start: Optional[jnp.ndarray] = None       # (T+2,) int32
    tile_of_center: Optional[jnp.ndarray] = None  # (P,) int32


def _collision_counts(cfg, means, radii):
    P, D = means.shape
    r = radii * 0.2
    alive = r >= 1e-6

    def row_counts(i):
        dx = formulas.wrap(means[None, :, :] - means[i][None, None, :], cfg.period)
        dist2 = jnp.sum(dx[0] ** 2, axis=-1)
        rad = r[i] + r
        hit = alive[i] & alive & (dist2 <= rad * rad)
        return jnp.sum(hit)

    return jax.lax.map(row_counts, jnp.arange(P))


def suggest_capacity(cfg: SamplerConfig, means, radii) -> int:
    """Host-side max collision count (for choosing the static capacity)."""
    return int(jax.device_get(_collision_counts(cfg, means, radii).max()))


def suggest_grid_capacities(cfg: SamplerConfig, means, radii,
                            auto_tile: bool = True):
    """Host-side capacity plan for preprocess_grid.

    Returns (cfg, neighbor_capacity, rect_capacity): a config whose tile
    size is matched to the collision radii (the sampler's 3-sigma grid is
    usually far coarser than the 0.2-shrunk collision radii - reusing it
    inflates the per-tile candidate tables by the density ratio), the max
    per-TILE candidate count under the inflated collision radii
    (preprocess_grid's table width), and the per-axis duplicate extent.
    """
    import dataclasses

    import numpy as np

    from ..binning import grid as binning

    P, D = means.shape
    cfg = cfg.with_dims(D)
    r = np.asarray(jax.device_get(radii)) * 0.2
    alive = r >= 1e-6
    r_eff = np.where(alive, r, 0.0)
    rho = np.where(alive, r_eff + r_eff.max(initial=0.0), 0.0)
    rho_max = float(rho.max(initial=0.0))
    if auto_tile and rho_max > 0.0:
        extent = (cfg.period if cfg.period is not None
                  else cfg.upper[0] - cfg.lower[0])
        tile = max(2.0 * rho_max, extent / 512.0)
        if tile < cfg.tile_size:
            cfg = dataclasses.replace(cfg, tile_size=tile)
    rect = min(
        int(np.ceil(2.0 * rho_max / cfg.tile_size)) + 2,
        max(cfg.grid_shape()),
    )
    ent = binning.duplicate_entries(
        cfg, jnp.asarray(means), jnp.asarray(rho), rect,
        P * rect ** D,
    )
    ent_tile = np.asarray(jax.device_get(ent[1]))
    T = binning.num_tiles(cfg, D)
    counts = np.bincount(ent_tile[ent_tile < T], minlength=T)
    nc = int(counts.max(initial=1))
    return cfg, max(8, -(-nc // 8) * 8), rect


@functools.partial(jax.jit, static_argnums=(0, 4, 5))
def preprocess_grid(
    cfg: SamplerConfig,
    means: jnp.ndarray,   # (P, D)
    conics: jnp.ndarray,  # (P, tri)
    radii: jnp.ndarray,   # (P,)
    neighbor_capacity: Optional[int] = None,
    rect_capacity: Optional[int] = None,
) -> Neighbors:
    """Grid-accelerated neighbor table: O(P * candidates) instead of the
    reference's brute-force O(P^2) findCollisions (aggregate_neighbors.cu:17
    ``// TODO: Optimize using a tree structure`` - this is the
    answer: world-grid cell lists, the same acceleration structure the
    sampler uses).

    Exactness: gaussian j is duplicated into every tile within its inflated
    collision radius rho_j = 0.2 r_j + 0.2 max(r); any i with
    |mu_i - mu_j| <= 0.2 (r_i + r_j) <= rho_j therefore finds j in the
    candidate list of i's center tile, and the true distance test filters the
    superset.  Candidate lists are per-TILE (all centers of a tile share one
    contiguous entry range), gathered as wide packed rows so the gather count
    stays O(T + P), not O(P * NC).

    ``neighbor_capacity`` caps candidates per tile (overflow counted, never
    silent).  Neighbor slots come back in ascending gaussian id, matching the
    reference's ascending-j CSR order (aggregate_neighbors.cu:85).
    """
    from ..binning import grid as binning

    P, D = means.shape
    tri = tri_size(D)
    cfg = cfg.with_dims(D)
    NC = neighbor_capacity or min(P, 256)
    # The inflated collision radii can exceed the 3-sigma footprints the
    # config's R was sized for; rect_capacity overrides (overflow counted).
    R = rect_capacity or cfg.max_tiles_per_gaussian

    r = radii * 0.2
    alive = r >= 1e-6
    r_eff = jnp.where(alive, r, 0.0)
    rho = jnp.where(alive, r_eff + jnp.max(r_eff), 0.0)

    E_cap = binning.entry_capacity(cfg, P, R)
    (ent_gid, ent_tile, ent_start, rect_of,
     ent_of) = binning.duplicate_entries(cfg, means, rho, R, E_cap)
    T = binning.num_tiles(cfg, D)

    # Packed per-entry parameters (one row gather, wide rows).
    params = jnp.concatenate(
        [means, conics, r_eff[:, None]], axis=1
    )  # (P, D+tri+1)
    params = jnp.concatenate(
        [params, jnp.zeros((1, params.shape[1]), params.dtype)], 0
    )
    ent_params = params[ent_gid]  # (E, W); sentinel gid==P hits the zero row

    # Per-tile candidate table (T, NC): contiguous slices of the sorted
    # entry list, so every center of a tile shares one table row.
    counts = ent_start[1:T + 1] - ent_start[:T]
    cand_overflow = jnp.sum(jnp.maximum(counts - NC, 0)).astype(jnp.int32)
    idx = ent_start[:T, None] + jnp.arange(NC, dtype=jnp.int32)[None, :]
    tvalid = idx < ent_start[1:T + 1, None]
    idx_c = jnp.minimum(idx, ent_gid.shape[0] - 1)
    tbl = jnp.where(tvalid[..., None], ent_params[idx_c], 0.0)  # (T, NC, W)
    tbl_gid = jnp.where(tvalid, ent_gid[idx_c], P)              # (T, NC)

    # Per-center candidates: one wide-row gather by center tile.
    tile_i = binning.sample_tiles(cfg, means)  # (P,)
    ctr = tbl[tile_i]                          # (P, NC, W)
    cand = tbl_gid[tile_i]                     # (P, NC)
    validc = cand < P

    mu_j = ctr[..., :D]
    con_j = ctr[..., D:D + tri]
    r_j = ctr[..., D + tri]
    X = formulas.wrap(mu_j - means[:, None, :], cfg.period)  # (P, NC, D)
    dist2 = jnp.sum(X * X, axis=-1)
    rr = r_eff[:, None] + r_j
    hit = validc & alive[:, None] & (r_j >= 1e-6) & (dist2 <= rr * rr)

    Xs = [X[..., d] for d in range(D)]
    cons = [con_j[..., t] for t in range(tri)]
    G, _ = formulas.power_terms(Xs, cons)
    dens = jnp.where(hit, G, 0.0)
    pos_power = hit & (G == 0.0)  # power > 0 culled inside power_terms
    out_idx = jnp.where(hit & ~pos_power, cand, -1).astype(jnp.int32)
    total = jnp.sum(dens, axis=1)
    inv_norm = 1.0 / (radii * 0.333 + 1e-6)

    overflow = (rect_of + ent_of + cand_overflow).astype(jnp.int32)
    return Neighbors(
        out_idx, X * inv_norm[:, None, None], dens,
        1.0 / (total + 1e-6), overflow,
        ent_gid=ent_gid, ent_start=ent_start, tile_of_center=tile_i,
    )


@functools.partial(jax.jit, static_argnums=(0, 4))
def preprocess(
    cfg: SamplerConfig,
    means: jnp.ndarray,   # (P, D)
    conics: jnp.ndarray,  # (P, tri)
    radii: jnp.ndarray,   # (P,)
    neighbor_capacity: Optional[int] = None,
) -> Neighbors:
    """Build the neighbor table (reference preprocess_aggregate,
    aggregate_neighbors.cu:323-367).  Brute-force per-row scan (the
    reference's findCollisions semantics, vectorized); prefer
    ``preprocess_grid`` at scale - identical table up to slot ordering
    capacity."""
    P, D = means.shape
    NC = neighbor_capacity or min(P, 64)
    r = radii * 0.2
    alive = r >= 1e-6
    inv_norm = 1.0 / (radii * 0.333 + 1e-6)  # (P,)

    ids = jnp.arange(P, dtype=jnp.int32)

    def row(i):
        dx = formulas.wrap(means - means[i][None, :], cfg.period)  # (P, D)
        dist2 = jnp.sum(dx**2, axis=-1)
        rad = r[i] + r
        hit = alive[i] & alive & (dist2 <= rad * rad)
        # Compact ascending-index neighbor list into NC slots (the reference
        # iterates j ascending, aggregate_neighbors.cu:85).
        key = jnp.where(hit, ids, P)
        order = jnp.argsort(key)[:NC]
        idx = key[order]  # ascending valid ids then P-sentinels
        valid = idx < P
        idx_c = jnp.minimum(idx, P - 1)
        X = formulas.wrap(means[idx_c] - means[i][None, :], cfg.period)  # (NC,D)
        # Density from the *neighbor's* conic on the unnormalized offset
        # (aggregate_neighbors.cu:107-120).
        con_j = conics[idx_c]  # (NC, tri)
        Xs = [X[:, d] for d in range(D)]
        cons = [con_j[:, t] for t in range(tri_size(D))]
        G, _ = formulas.power_terms(Xs, cons)
        dens = jnp.where(valid, G, 0.0)
        pos_power = valid & (G == 0.0)  # power > 0 culled inside power_terms
        out_idx = jnp.where(valid & ~pos_power, idx, -1).astype(jnp.int32)
        total = jnp.sum(dens)
        return out_idx, X * inv_norm[i], dens, 1.0 / (total + 1e-6), jnp.sum(hit)

    idxs, dists, dens, inv_tot, counts = jax.lax.map(row, ids)
    overflow = jnp.sum(counts > NC).astype(jnp.int32)
    return Neighbors(idxs, dists, dens, inv_tot, overflow)


def aggregate(
    features: jnp.ndarray,            # (P, L)
    transform: jnp.ndarray,           # (L, L)
    queries: jnp.ndarray,             # (P, K)
    keys: jnp.ndarray,                # (P, K)
    frequencies: jnp.ndarray,         # (nfreq,) or longer
    distance_transform: jnp.ndarray,  # (2E,)
    nbr: Neighbors,
) -> jnp.ndarray:
    """Forward aggregation (aggregateNeighbors, aggregate_neighbors.cu:129-208).

    Differentiable in (features, transform, queries, keys, frequencies,
    distance_transform) - JAX autodiff produces the same six gradients as the
    hand-written backward kernel (aggregate_neighbors.cu:210-321).
    """
    P, L = features.shape
    D = nbr.dists.shape[-1]
    E = distance_transform.shape[0] // 2
    nfreq = (E - 1) // D // 2
    stride = (E - 1) // D

    NC = nbr.indices.shape[1]
    valid = (nbr.indices >= 0).astype(features.dtype)  # (P, NC)

    if nbr.ent_gid is not None:
        # Grid path (see Neighbors docstring): E-row gather of the entries'
        # features/keys, monotone window gathers into the per-tile table,
        # one wide-row gather by center tile.
        T = nbr.ent_start.shape[0] - 2
        E_n = nbr.ent_gid.shape[0]
        fk = jnp.concatenate([features, keys], axis=1)       # (P, L+K)
        fk = jnp.concatenate([fk, jnp.zeros((1, fk.shape[1]), fk.dtype)], 0)
        ent_fk = fk[jnp.minimum(nbr.ent_gid, features.shape[0])]  # (E, L+K)
        win = nbr.ent_start[:T, None] + jnp.arange(NC, dtype=jnp.int32)
        tvalid = win < nbr.ent_start[1:T + 1, None]
        tbl = jnp.where(
            tvalid[..., None], ent_fk[jnp.minimum(win, E_n - 1)], 0.0
        )                                                    # (T, NC, L+K)
        ctr = tbl[nbr.tile_of_center]                        # (P, NC, L+K)
        nbr_features = ctr[..., :L]
        nbr_keys = ctr[..., L:]
    else:
        idx = jnp.maximum(nbr.indices, 0)
        nbr_features = features[idx]
        nbr_keys = keys[idx]

    # Attention weight w_ij = <query_i, key_j>  (lines 173-176).
    w = jnp.einsum("pk,pnk->pn", queries, nbr_keys,
                   precision=jax.lax.Precision.HIGHEST)

    # Sinusoidal positional code of the normalized offset (lines 178-193).
    # Accumulated per (dim, frequency) term over (P, NC) arrays - a single
    # (P, NC, D, nfreq) phase tensor would materialize D*nfreq times the
    # table (and its autodiff residuals) through HBM.
    X = nbr.dists  # (P, NC, D)
    dt = distance_transform
    embedding = jnp.broadcast_to(dt[E - 1], X.shape[:2])
    factor = jnp.broadcast_to(dt[2 * E - 1], X.shape[:2])
    for d in range(D):
        for e in range(nfreq):
            phase = (frequencies[e] * jnp.pi) * X[..., d]  # (P, NC)
            s, c = jnp.sin(phase), jnp.cos(phase)
            i = d * stride + 2 * e
            embedding = embedding + s * dt[i] + c * dt[i + 1]
            factor = factor + s * dt[E + i] + c * dt[E + i + 1]

    # Density-normalized attention (lines 198-206).
    coeff = nbr.inv_total_densities[:, None] * nbr.densities * w * valid
    pre = jnp.einsum("pn,pnl->pl", coeff * factor, nbr_features,
                     precision=jax.lax.Precision.HIGHEST) + (
        (coeff * embedding).sum(axis=1, keepdims=True)
    )
    return jnp.einsum("pj,jk->pk", pre, transform,
                      precision=jax.lax.Precision.HIGHEST)



# ---------------------------------------------------------------------------
# Chunked pair-sweep path (kernels/aggregate.py): no per-pair table
# ---------------------------------------------------------------------------


class AggPlan(NamedTuple):
    """Static capacities for the chunked aggregation path (hashable:
    usable as a jit static argument).  Produced by plan_pallas from one
    eager geometry build; every capacity is exact, with in-graph overflow
    counters guarding drift."""

    rect: int      # per-axis candidate-tile cap R for duplicate_entries
    entries: int   # compact sorted-entry capacity (valid duplicates)
    e_chunks: int  # entry chunks of block_e (padded entries = e_chunks*block_e)
    c_chunks: int  # center chunks of block_n (padded centers = c_chunks*block_n)
    work_fwd: int  # center-chunk-major work items
    work_bwd: int  # entry-chunk-major work items


class AggBinning(NamedTuple):
    """Acceleration structure + static geometry for the chunked aggregation
    path (the analogue of the reference's preprocess_aggregate products,
    aggregate_neighbors.cu:347-364, in per-tile chunked form -
    binning/chunked.py).

    All per-pair quantities (offsets, densities, attention weights,
    sinusoidal codes) are recomputed by the pair sweeps; this carries
    only the chunk-padded entry list, the chunk-padded center order, the
    packed static geometry (including the per-center inverse total density
    from the totals sweep), and the same-tile chunk work lists of both
    sweep orientations.
    """

    ent_gid: jnp.ndarray     # (Ep,) int32, P = sentinel (pad slots)
    ent_geo: jnp.ndarray     # (D+tri+1, Ep) shifted means, conics, r_eff
    ctr_static: jnp.ndarray  # (Cp, D+3) means, r_eff, inv_norm, inv_tot
    cid: jnp.ndarray         # (Cp,) int32 original center id, P = sentinel
    pos: jnp.ndarray         # (P,) int32 padded slot of each center
    wl_fwd: Tuple[jnp.ndarray, jnp.ndarray]  # center-chunk-major (aux, col)
    wl_bwd: Tuple[jnp.ndarray, jnp.ndarray]  # entry-chunk-major (aux, col)
    overflow: jnp.ndarray    # () int32: rect + chunk + work-list overflow


def _collision_geometry(cfg: SamplerConfig, radii):
    """Shrunk per-Gaussian collision radii and the entry inflation rho
    (aggregate_neighbors.cu:38: collide iff dist <= 0.2 (r_i + r_j), so an
    entry must reach every center within r_eff_j + max_i r_eff_i)."""
    r = radii * 0.2
    alive = r >= 1e-6
    r_eff = jnp.where(alive, r, 0.0)
    rho = jnp.where(alive, r_eff + jnp.max(r_eff), 0.0)
    return r_eff, rho


def plan_pallas(cfg: SamplerConfig, means, radii, *, block_n: int = 32,
                block_e: int = 128, auto_tile: bool = True):
    """Host-side capacity plan for preprocess_pallas.

    Returns (cfg', AggPlan): a config whose tile size matches the
    0.2-shrunk collision radii (the sampler's 3-sigma grid is usually far
    coarser) and exact static chunk/work capacities measured from one eager
    geometry build.
    """
    import dataclasses

    import numpy as np

    from ..binning import chunked
    from ..binning import grid as binning

    P, D = means.shape
    cfg = cfg.with_dims(D)
    r = np.asarray(jax.device_get(radii)) * 0.2
    alive = r >= 1e-6
    r_eff = np.where(alive, r, 0.0)
    rho = np.where(alive, r_eff + r_eff.max(initial=0.0), 0.0)
    rho_max = float(rho.max(initial=0.0))
    if auto_tile and rho_max > 0.0:
        extent = (cfg.period if cfg.period is not None
                  else min(u - l for l, u in zip(cfg.lower, cfg.upper)))
        tile = max(2.0 * rho_max, extent / 512.0)
        if tile < cfg.tile_size:
            cfg = dataclasses.replace(cfg, tile_size=tile)
    R = min(
        int(np.ceil(2.0 * rho_max / cfg.tile_size)) + 2,
        max(cfg.grid_shape()),
    )
    ent = binning.duplicate_entries(
        cfg, jnp.asarray(means), jnp.asarray(rho), R, P * R ** D
    )
    T = binning.num_tiles(cfg, D)
    n_entries = int(jax.device_get(jnp.sum(ent[1] < T)))
    sb = binning.bin_samples(cfg, jnp.asarray(means))
    em = np.asarray(jax.device_get(chunked.chunk_counts(ent[2], block_e)))
    cm = np.asarray(jax.device_get(chunked.chunk_counts(sb.s_start, block_n)))
    work_fwd = int((cm * np.maximum(em, 1)).sum())
    work_bwd = int((em * np.maximum(cm, 1)).sum())
    return cfg, AggPlan(
        rect=R,
        entries=max(-(-n_entries // 128) * 128, 128),
        e_chunks=max(int(em.sum()), 1),
        c_chunks=max(int(cm.sum()), 1),
        work_fwd=max(work_fwd, 1),
        work_bwd=max(work_bwd, 1),
    )


def plan_pallas_sharded(cfg: SamplerConfig, means, radii, n_shards: int,
                        *, block_n: int = 32, block_e: int = 128,
                        auto_tile: bool = True):
    """Host-side plan for tile-range model-parallel aggregation shards.

    Partitions the tile grid into ``n_shards`` contiguous ranges balanced by
    entry-chunk count, and returns (cfg', plan, ranges) where ``plan`` holds
    the MAX per-shard capacities (so every shard's structure has identical
    static shapes and they stack for shard_map; see
    parallel/mesh.sharded_aggregate)."""
    import numpy as np

    from ..binning import chunked
    from ..binning import grid as binning

    P, D = means.shape
    cfg, gplan = plan_pallas(cfg, means, radii, block_n=block_n,
                             block_e=block_e, auto_tile=auto_tile)
    r_eff, rho = _collision_geometry(cfg, radii)
    ent = binning.duplicate_entries(
        cfg, jnp.asarray(means), rho, gplan.rect, P * gplan.rect ** D)
    sb = binning.bin_samples(cfg, jnp.asarray(means))
    em = np.asarray(jax.device_get(chunked.chunk_counts(ent[2], block_e)))
    cm = np.asarray(jax.device_get(chunked.chunk_counts(sb.s_start, block_n)))
    T = em.shape[0]
    # Balanced contiguous tile ranges by cumulative entry chunks.
    cum = np.cumsum(em)
    total = max(int(cum[-1]), 1)
    bounds = [0]
    for s in range(1, n_shards):
        bounds.append(int(np.searchsorted(cum, total * s / n_shards)))
    bounds.append(T)
    ranges = tuple((bounds[i], max(bounds[i + 1], bounds[i]))
                   for i in range(n_shards))

    start_np = np.asarray(jax.device_get(ent[2]))
    caps = dict(entries=128, e_chunks=1, c_chunks=1, work_fwd=1, work_bwd=1)
    for t0, t1 in ranges:
        em_s = em[t0:t1]
        cm_s = cm[t0:t1]
        n_ent = int(start_np[t1] - start_np[t0])
        caps["entries"] = max(caps["entries"], -(-n_ent // 128) * 128)
        caps["e_chunks"] = max(caps["e_chunks"], int(em_s.sum()))
        caps["c_chunks"] = max(caps["c_chunks"], int(cm_s.sum()))
        caps["work_fwd"] = max(
            caps["work_fwd"], int((cm_s * np.maximum(em_s, 1)).sum()))
        caps["work_bwd"] = max(
            caps["work_bwd"], int((em_s * np.maximum(cm_s, 1)).sum()))
    # The shard layouts clamp the GLOBAL range tables, so chunk layouts are
    # sized over all T tiles but only the shard's tiles are non-empty; the
    # entry capacity must still admit the global compact list (the slice
    # indices are global).
    caps["entries"] = gplan.entries
    return cfg, AggPlan(rect=gplan.rect, **caps), ranges


@functools.partial(jax.jit, static_argnums=(0, 4, 5, 6, 7, 8),
                   static_argnames=("plan", "block_n", "block_e",
                                    "tile_range", "compute_totals"))
def preprocess_pallas(
    cfg: SamplerConfig,
    means: jnp.ndarray,   # (P, D)
    conics: jnp.ndarray,  # (P, tri)
    radii: jnp.ndarray,   # (P,)
    plan: AggPlan,
    block_n: int = 32,
    block_e: int = 128,
    tile_range: Optional[Tuple[int, int]] = None,
    compute_totals: bool = True,
) -> AggBinning:
    """Build the chunked aggregation structure (jit-compatible, static caps
    from plan_pallas).  Replaces findCollisions + preprocess
    (aggregate_neighbors.cu:18-127): per-tile chunk-padded candidate sweeps
    instead of the O(P^2) matrix, and the per-center total density from one
    pair sweep instead of materialized CSR density arrays.

    ``tile_range=(t0, t1)`` restricts the structure to tiles [t0, t1) - the
    model-parallel shard form (parallel/mesh.py): entries and centers are
    tile-sorted, so a tile range is a contiguous slice of the global
    binning, realized by clamping the range tables (work lists and chunk
    layouts then cover only the shard's tiles).  Work items pair same-tile
    chunks, so every pair of a shard's centers is shard-local, and totals /
    aggregation over the shard are complete for its centers.
    """
    from ..binning import chunked
    from ..binning import grid as binning
    from ..kernels import aggregate as kagg

    P, D = means.shape
    tri = tri_size(D)
    cfg = cfg.with_dims(D)
    Ep = plan.e_chunks * block_e
    Cp = plan.c_chunks * block_n

    r_eff, rho = _collision_geometry(cfg, radii)

    (gid, tile, start, rect_of, ent_of) = binning.duplicate_entries(
        cfg, means, rho, plan.rect, min(P * plan.rect ** D, plan.entries)
    )
    sb = binning.bin_samples(cfg, means)
    s_start = sb.s_start
    if tile_range is not None:
        # Clamp the range tables to [t0, t1): out-of-range tiles collapse
        # to empty; in-range offsets stay GLOBAL, so the chunk layouts'
        # source indices keep pointing into the global sorted arrays.
        t0, t1 = tile_range
        start = jnp.clip(start, start[t0], start[t1])
        s_start = jnp.clip(s_start, s_start[t0], s_start[t1])

    # Chunk-padded entry side: gid rides one 1-D gather, geometry one row
    # gather; the periodic image index is recomputed from (tile, rect lo)
    # with the lo rows riding the same row gather (see
    # kernels/tiled.gather_entries).  Every other per-slot array is a
    # chunk-level broadcast, so only chunk-level arrays are gathered.
    esrc, evalid, etile, _, ebase, em, e_of = chunked.chunk_layout(
        start, block_e, plan.e_chunks)
    gid_pad = jnp.where(evalid, gid[esrc], jnp.int32(P))
    geo = jnp.concatenate([means, conics, r_eff[:, None]], axis=1)
    if cfg.period is not None:
        lo, _ = binning.gaussian_rects(
            cfg, jax.lax.stop_gradient(means), jax.lax.stop_gradient(rho))
        geo = jnp.concatenate([geo, lo.astype(geo.dtype)], axis=1)
    geo = jnp.concatenate([geo, jnp.zeros((1, geo.shape[1]), geo.dtype)], 0)
    ent = geo[gid_pad]                        # (Ep, D+tri+1[+D])
    if cfg.period is not None:
        npar = D + tri + 1
        tile_pad = jnp.where(evalid, etile, jnp.int32(2**30))
        k = binning.image_shift(cfg, tile_pad, ent[:, npar:])
        ent = ent[:, :npar].at[:, :D].add(-cfg.period * k.astype(ent.dtype))
    ent_geo = ent.T                           # (D+tri+1, Ep)

    # Chunk-padded center side (the sample half of the binning machinery):
    # one 1-D gather for the id, one packed row gather for the geometry.
    csrc, cvalid, _, _, cbase, cm, c_of = chunked.chunk_layout(
        s_start, block_n, plan.c_chunks)
    cid = jnp.where(cvalid, sb.s_perm[csrc], P)
    inv_norm = 1.0 / (radii * 0.333 + 1e-6)
    ctr_tab = jnp.concatenate(
        [means, r_eff[:, None], inv_norm[:, None]], axis=1)
    ctr_tab = jnp.concatenate(
        [ctr_tab, jnp.zeros((1, D + 2), ctr_tab.dtype)], 0)
    ctr_pre = jnp.concatenate(
        [ctr_tab[cid], jnp.ones((Cp, 1), jnp.float32)], axis=1
    )                                                    # (Cp, D+3)

    # Same-tile chunk work lists for both sweep orientations.
    aux_f, col_f, wf_of = chunked.work_list(
        cm, em, cbase, ebase, plan.work_fwd, plan.e_chunks)
    aux_b, col_b, wb_of = chunked.work_list(
        em, cm, ebase, cbase, plan.work_bwd, plan.c_chunks)

    # Per-center total density -> inv_total (aggregate_neighbors.cu:120-125).
    # period=None: entries are pre-shifted to the periodic image their tile
    # sees, so the raw offset IS the minimum-image displacement for every
    # same-tile pair (compact footprints; see aggregate_pallas docstring).
    # ``compute_totals=False`` leaves the column at 1.0 for the
    # fused-totals mode (aggregate_pallas(fused_totals=True) re-derives the
    # totals from its own forward sweep every call - the per-training-step
    # configuration, since the reference's preprocess also recomputes them
    # each step).
    if compute_totals:
        tot = kagg.totals(
            D, None, (aux_f, col_f), ent_geo, ctr_pre,
            block_n=block_n, block_e=block_e,
        )
        inv_tot = 1.0 / (tot + 1e-6)
    else:
        inv_tot = jnp.ones((Cp, 1), jnp.float32)
    ctr_static = jnp.concatenate([ctr_pre[:, :-1], inv_tot], axis=1)

    # Sentinel Cp (not 0) for centers absent from this structure - only
    # possible under a tile_range shard - so consumers can route them to an
    # explicit zero row instead of stealing slot 0's values.
    pos = jnp.full((P + 1,), Cp, jnp.int32).at[cid].set(
        jnp.arange(Cp, dtype=jnp.int32), mode="drop"
    )[:P]
    overflow = (rect_of + ent_of + e_of + c_of + wf_of + wb_of
                ).astype(jnp.int32)
    return AggBinning(
        ent_gid=gid_pad, ent_geo=ent_geo, ctr_static=ctr_static,
        cid=cid, pos=pos, wl_fwd=(aux_f, col_f), wl_bwd=(aux_b, col_b),
        overflow=overflow,
    )


def aggregate_pallas(
    features: jnp.ndarray,            # (P, L)
    transform: jnp.ndarray,           # (L, L)
    queries: jnp.ndarray,             # (P, K)
    keys: jnp.ndarray,                # (P, K)
    frequencies: jnp.ndarray,         # (nfreq,) or longer
    distance_transform: jnp.ndarray,  # (2E,)
    agg: AggBinning,
    *, period: Optional[float] = None,
    block_n: int = 32, block_e: int = 128,
    ladder_frequencies: bool = False,
    padded_outputs: bool = False,
    fused_totals: bool = False,
) -> jnp.ndarray:
    """Forward aggregation through the chunked pair sweeps
    (kernels/aggregate.py); differentiable in all
    six parameter groups (the reference's contract,
    aggregate_neighbors.cu:417-475), with hand-wired VJPs for five of them
    and the linear LxL transform chained outside by autodiff.

    Numerically equal to ``aggregate`` over an exact (untruncated) neighbor
    table - the sweeps enumerate every colliding pair, so there is no
    neighbor_capacity to overflow (agg.overflow reports binning/work-list
    overflow instead).

    ``period=None`` (the default) is exact for periodic domains too:
    preprocess_pallas shifts every entry's mean to the periodic image its
    tile sees, so the raw offset IS the minimum-image displacement for all
    same-tile pairs, and pairs beyond the collision radius are masked in
    both conventions.  Pass the real period only for degenerate footprints
    that cover the whole grid (plan.rect == max grid extent), where the
    full-cover rect collapse emits unshifted entries.

    ``ladder_frequencies`` certifies frequencies[e] == (e+1)*frequencies[0]
    exactly (the standard sinusoidal-embedding ladder): the sweeps then
    evaluate one sin/cos per dim and derive the higher rungs by the
    angle-addition recurrence (kernels/aggregate._sincode), removing most
    per-pair transcendentals.  Gradients stay per-rung partials, so a
    shared-base parameterization built OUTSIDE (freqs = base * arange(1,
    nfreq+1)) chains correctly by autodiff.  Passing it with non-ladder
    frequencies silently computes the wrong code - it is a certification,
    not a request."""
    from ..kernels import aggregate as kagg

    # The binning structure is non-differentiable; it enters the custom_vjp
    # as EXPLICIT arguments (zero / float0 cotangents) rather than closure
    # captures: a closure capturing tracers breaks when the VJP runs in a
    # different trace than the forward (grad OF a shard_map, scan).
    agg = jax.tree.map(jax.lax.stop_gradient, agg)

    P, L = features.shape
    K = queries.shape[1]
    D = agg.ctr_static.shape[1] - 3
    E = distance_transform.shape[0] // 2
    nfreq = (E - 1) // D // 2
    Cp = agg.ctr_static.shape[0]

    def _gather(features, queries, keys, frequencies, distance_transform,
                ent_gid, ctr_static, cid):
        fk = jnp.concatenate([features, keys], axis=1)
        fk = jnp.concatenate([fk, jnp.zeros((1, L + K), fk.dtype)], 0)
        ent_fk = fk[ent_gid].T                          # (L+K, Ep)
        q_tab = jnp.concatenate([queries, jnp.zeros((1, K), queries.dtype)])
        ctr_geo = jnp.concatenate([ctr_static, q_tab[cid]], axis=1)
        dtf = jnp.concatenate(
            [distance_transform, frequencies[:nfreq]])[None, :]
        return ent_fk, ctr_geo, dtf

    def _fwd_scaled(features, queries, keys, frequencies, distance_transform,
                    ent_gid, ent_geo, ctr_static, cid, wf_aux, wf_col):
        """Forward sweep + per-center inv_total.  In fused mode the totals
        ride the SAME pair sweep (kernels/aggregate.forward with_totals) and
        the normalization is applied outside - every center's row is linear
        in its inv_total; the structure's inv_tot column is 1.0."""
        ent_fk, ctr_geo, dtf = _gather(
            features, queries, keys, frequencies, distance_transform,
            ent_gid, ctr_static, cid)
        if fused_totals:
            pre_u, tot = kagg.forward(
                D, L, K, nfreq, period, (wf_aux, wf_col),
                ent_geo, ent_fk, ctr_geo, dtf, block_n=block_n,
                block_e=block_e, ladder=ladder_frequencies, with_totals=True,
            )
            inv_tot = 1.0 / (tot + 1e-6)
            return pre_u * inv_tot, inv_tot, ent_fk, ctr_geo, dtf
        pre = kagg.forward(
            D, L, K, nfreq, period, (wf_aux, wf_col), ent_geo,
            ent_fk, ctr_geo, dtf, block_n=block_n, block_e=block_e,
            ladder=ladder_frequencies,
        )
        return pre, ctr_static[:, D + 2:D + 3], ent_fk, ctr_geo, dtf

    @jax.custom_vjp
    def raw_pre(features, queries, keys, frequencies, distance_transform,
                ent_gid, ent_geo, ctr_static, cid, pos,
                wf_aux, wf_col, wb_aux, wb_col):
        return _fwd_scaled(features, queries, keys, frequencies,
                           distance_transform, ent_gid, ent_geo, ctr_static,
                           cid, wf_aux, wf_col)[0]

    def raw_pre_fwd(features, queries, keys, frequencies, distance_transform,
                    ent_gid, ent_geo, ctr_static, cid, pos,
                    wf_aux, wf_col, wb_aux, wb_col):
        pre, inv_tot, ent_fk, ctr_geo, dtf = _fwd_scaled(
            features, queries, keys, frequencies, distance_transform,
            ent_gid, ent_geo, ctr_static, cid, wf_aux, wf_col)
        # Residuals: the gathered operand layouts (re-gathering ~3x the
        # parameter rows costs more than the HBM they hold) + the structure
        # arrays the backward consumes.
        return pre, (ent_fk, ctr_geo, dtf, frequencies, inv_tot,
                     ent_gid, ent_geo, ctr_static, pos, wb_aux, wb_col)

    def raw_pre_bwd(res, g):
        (ent_fk, ctr_geo, dtf, frequencies, inv_tot,
         ent_gid, ent_geo, ctr_static, pos, wb_aux, wb_col) = res
        # Every center's contribution is linear in its inv_total: fold it
        # into the cotangent so the backward sweep never touches it.
        g = g * inv_tot                                 # (Cp, L)
        gsum = jnp.sum(g, axis=1, keepdims=True)
        dent, slab = kagg.backward(
            D, L, K, nfreq, period, (wb_aux, wb_col), ent_geo,
            ent_fk, ctr_geo, dtf, g, gsum,
            block_n=block_n, block_e=block_e, ladder=ladder_frequencies,
        )
        # By-gaussian reduction of the per-entry rows.
        d = jax.ops.segment_sum(dent.T, ent_gid, num_segments=P + 1)[:P]
        # Per-item center slabs -> per-center-chunk sums (a ~5k-row
        # scatter), then un-chunk with a free reshape.
        W = wb_aux.shape[0]
        S = K + 2 * E + nfreq
        ctr_out = jax.ops.segment_sum(
            slab.reshape(W, block_n * S), wb_col,
            num_segments=Cp // block_n,
        ).reshape(Cp, S)
        # Full-row gather, THEN slice: a (pos, :K) mixed index gathers
        # partial rows, which XLA serializes into a while loop.  The extra
        # zero row serves pos == Cp sentinels (centers outside a
        # tile_range shard must contribute ZERO dq, not slot garbage).
        ctr_out = jnp.concatenate(
            [ctr_out, jnp.zeros((1, S), ctr_out.dtype)], 0)
        dq = ctr_out[pos][:, :K]                        # unpad+unsort (P, K)
        ddt = jnp.sum(ctr_out[:, K:K + 2 * E], axis=0)
        dfreq = jnp.zeros_like(frequencies).at[:nfreq].set(
            jnp.sum(ctr_out[:, K + 2 * E:], axis=0)
        )
        import numpy as np

        def _zero_ct(x):
            if jnp.issubdtype(x.dtype, jnp.floating):
                return jnp.zeros_like(x)
            return np.zeros(x.shape, jax.dtypes.float0)

        return (d[:, :L], dq, d[:, L:], dfreq, ddt,
                _zero_ct(ent_gid), jnp.zeros_like(ent_geo),
                jnp.zeros_like(ctr_static), _zero_ct(jnp.zeros(Cp, jnp.int32)),
                _zero_ct(jnp.zeros(P, jnp.int32)),
                _zero_ct(wb_aux), _zero_ct(wb_col),
                _zero_ct(wb_aux), _zero_ct(wb_col))

    raw_pre.defvjp(raw_pre_fwd, raw_pre_bwd)

    pre = raw_pre(features, queries, keys, frequencies, distance_transform,
                  agg.ent_gid, agg.ent_geo, agg.ctr_static, agg.cid, agg.pos,
                  agg.wl_fwd[0], agg.wl_fwd[1], agg.wl_bwd[0], agg.wl_bwd[1])
    out_pad = jnp.einsum("cl,lk->ck", pre, transform,
                         precision=jax.lax.Precision.HIGHEST)  # (Cp, K=L)
    if padded_outputs:
        # Raw per-slot rows (slot c is center agg.cid[c]; pad slots carry
        # zero coefficients) - the model-parallel shard form scatters these
        # by cid and psums (parallel/mesh.sharded_aggregate).
        return out_pad
    # Zero row for pos == Cp sentinels (centers outside a tile_range shard).
    out_pad = jnp.concatenate(
        [out_pad, jnp.zeros((1, out_pad.shape[1]), out_pad.dtype)], 0)
    return out_pad[agg.pos]
