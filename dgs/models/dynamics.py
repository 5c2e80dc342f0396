"""Gaussian-cloud dynamics via neighbor aggregation (the PIGS dynamics net).

The reference's aggregation subsystem (aggregate_neighbors.cu, SURVEY.md C12-
C15) exists to serve as "the neural network over the Gaussian cloud that
predicts dynamics" in downstream PIGS.  This module reproduces that usage
in JAX: a field u(x, t) is carried by a fixed Gaussian cloud whose
per-Gaussian feature values evolve through the attention-style neighbor
aggregation layer, trained so rollouts match an analytic advection-diffusion
solution on the periodic torus:

    u_t + c . grad(u) = kappa * laplace(u)
    u*(x, t) = exp(-D kappa pi^2 t) * prod_d sin(pi (x_d - c_d t))

Per rollout step:  values <- values + aggregate(values, ...)  (residual
update through the same 6 learnable parameter groups as the reference:
transform, queries, keys, frequencies, distance_transform - gradients via
JAX autodiff match the reference's hand-written backward).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import optax

from ..config import SamplerConfig
from ..ops import aggregation, sampling
from ..oracle.dense import radii as compute_radii
from .field import GaussianField, init_field


class DynamicsParams(NamedTuple):
    """The six learnable parameter groups of the aggregation layer
    (reference __init__.py:303-317)."""

    transform: jnp.ndarray           # (L, L)
    queries: jnp.ndarray             # (P, K)
    keys: jnp.ndarray                # (P, K)
    frequencies: jnp.ndarray         # (nfreq,)
    distance_transform: jnp.ndarray  # (2E,)


def init_dynamics_params(key, P: int, L: int, D: int, *, n_heads: int = 4,
                         n_freq: int = 2,
                         ladder: bool = False) -> DynamicsParams:
    """``ladder``: parameterize the frequency ladder by its learnable BASE
    scalar (frequencies = base * (1..n_freq), built in rollout_step) so the
    chunked pair sweeps can use the angle-addition sincos recurrence;
    otherwise each rung is independently learnable as in the reference."""
    E = 2 * D * n_freq + 1
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    scale = 0.1
    return DynamicsParams(
        transform=jax.random.normal(k1, (L, L)) * scale / L**0.5,
        queries=jax.random.normal(k2, (P, n_heads)) * scale,
        keys=jax.random.normal(k3, (P, n_heads)) * scale,
        frequencies=(jnp.ones((1,), jnp.float32) if ladder
                     else jnp.arange(1, n_freq + 1, dtype=jnp.float32)),
        distance_transform=jax.random.normal(k5, (2 * E,)) * scale,
    )


def advection_diffusion_solution(D: int, kappa: float = 0.05,
                                 velocity: float = 0.3):
    """u*(x, t) on the period-2 torus."""
    c = jnp.full((D,), velocity, jnp.float32)

    def u_star(x, t):  # (N, D), scalar t -> (N, 1)
        decay = jnp.exp(-D * kappa * jnp.pi**2 * t)
        return (decay * jnp.prod(jnp.sin(jnp.pi * (x - c * t)), axis=-1))[
            :, None
        ]

    return u_star


def rollout_step(params: DynamicsParams, values, nbr, *,
                 ladder: bool = False):
    """values <- values + aggregate(values)  (residual dynamics update).
    Dispatches on the neighbor structure: the XLA table path
    (aggregation.Neighbors) or the chunked pair-sweep path
    (aggregation.AggBinning).

    ``ladder``: params.frequencies is a (1,) learnable BASE and the full
    ladder base * (1..nfreq) is built here - autodiff chains the per-rung
    gradients onto the base - so the pair sweeps can replace most
    per-pair sin/cos with the angle-addition recurrence
    (aggregate_pallas ladder_frequencies)."""
    freqs = params.frequencies
    if ladder:
        D = (nbr.ctr_static.shape[1] - 3
             if isinstance(nbr, aggregation.AggBinning)
             else nbr.dists.shape[-1])
        E = params.distance_transform.shape[0] // 2
        nfreq = (E - 1) // D // 2
        freqs = params.frequencies[0] * jnp.arange(
            1, nfreq + 1, dtype=jnp.float32)
    if isinstance(nbr, aggregation.AggBinning):
        agg = aggregation.aggregate_pallas(
            values, params.transform, params.queries, params.keys,
            freqs, params.distance_transform, nbr,
            ladder_frequencies=ladder,
        )
    else:
        agg = aggregation.aggregate(
            values, params.transform, params.queries, params.keys,
            freqs, params.distance_transform, nbr,
        )
    return values + agg


def make_value_eval(cfg: SamplerConfig, field: GaussianField,
                    eval_method: str = "dense", n_eval: int = 4096,
                    with_overflow: bool = False, padded: bool = False):
    """(values, x) -> u(x) evaluator for a fixed cloud geometry, for
    batches of ``n_eval`` points.

    "dense" materializes (N, P) pair arrays - fine for small P;
    "tiled" routes through the binned sampler with capacities
    planned from the geometry and an ``n_eval``-sized probe (the only
    viable path at 100k+ Gaussians, where dense pair arrays are tens of
    GB).  Sample points may differ per call (sample_binned re-bins
    in-trace); a fresh random batch is probed eagerly once and must show
    zero overflow.  ``with_overflow``: the evaluator returns
    (u, overflow_total) so training loops can log in-step capacity drift
    (always 0 on the dense path)."""
    conics = field.conics()
    if eval_method == "dense":
        def eval_u(values, x):
            u = sampling.sample_dense(
                "value", field.means, values, conics, x, period=cfg.period
            )
            return (u, jnp.zeros((), jnp.int32)) if with_overflow else u
        return eval_u

    import dataclasses

    from ..binning import grid as binning
    from ..utils import native

    covs = field.covariances()
    # Auto-tile the EVAL grid to the cloud's footprints (mirrors
    # plan_pallas's auto_tile): the facade default tile (the reference's
    # 0.51 world BLOCK_SIZE, config.h:18) is catastrophically coarse for
    # dense clouds - at 100k Gaussians it put ~6k entries x ~4k samples in
    # every tile and the 65k-point eval cost MORE pair work than the 1M-
    # sample headline bench.  tile ~ 2.7x the median footprint radius
    # keeps a few tiles per footprint; only ever shrink the configured
    # tile.
    rad_med = float(jnp.median(compute_radii(
        covs, field.D, cfg.radius_sigma, cfg.eig_floor)))
    extent = (cfg.period if cfg.period is not None
              else min(u - l for l, u in zip(cfg.lower, cfg.upper)))
    tile_auto = max(2.7 * rad_med, extent / 512.0)
    if 0.0 < tile_auto < cfg.tile_size:
        cfg = dataclasses.replace(cfg, tile_size=tile_auto)
    probe = jax.random.uniform(
        jax.random.PRNGKey(17), (n_eval, field.D), minval=-1.0, maxval=1.0)
    plan = native.plan_capacities(cfg, field.means, covs, probe)
    cfg_s = native.config_from_plan(cfg, plan, field.means.shape[0])

    # The cloud geometry is FIXED in dynamics training (only the values
    # evolve): build the Gaussian-side binning once here and reuse it in
    # every step - the jitted step then only sorts the fresh sample batch
    # (binning.build gaussian_binning reuse).
    gstate = jax.jit(binning.build, static_argnums=0)(
        cfg_s, field.means, covs, probe)

    def eval_u(values, x):
        # ``padded``: raw component-major kernel layout (1, C, Np) plus the
        # sort permutation - reduction losses consume it with no transpose
        # or un-sort, and the backward cotangent never leaves the packed
        # layout.
        outs, diag = sampling.sample_binned(
            cfg_s, field.means, values, conics, covs, x, ("value",),
            gaussian_binning=gstate, sorted_outputs=padded,
            padded_outputs=padded)
        u = outs["value"]
        ret = (u, diag["perm"]) if padded else (u,)
        if with_overflow:
            of = sum(v for k, v in diag.items() if k != "perm")
            ret = ret + (of.astype(jnp.int32),)
        return ret if len(ret) > 1 else ret[0]

    # One eager probe on a fresh batch: the capacities must hold for
    # resampled points, not just the planning probe.
    check = jax.random.uniform(
        jax.random.PRNGKey(18), (n_eval, field.D), minval=-1.0, maxval=1.0)
    _, diag = sampling.sample_binned(
        cfg_s, field.means, field.values, conics, covs, check, ("value",))
    bad = {k: int(v) for k, v in diag.items()
           if k != "perm" and int(v) != 0}
    if bad:
        raise ValueError(f"tiled value eval overflows on a fresh batch: "
                         f"{bad}; enlarge the binning capacities")
    return eval_u


def fit_values(cfg: SamplerConfig, field: GaussianField, target: Callable,
               *, steps: int = 200, lr: float = 5e-2, n_fit: int = 4096,
               key=None, eval_method: str = "dense") -> GaussianField:
    """Least-squares fit of the per-Gaussian values to a target field at
    t=0 (means/covariances stay fixed)."""
    key = key if key is not None else jax.random.PRNGKey(3)
    x = jax.random.uniform(key, (n_fit, field.D), minval=-1.0, maxval=1.0)
    y = target(x)
    eval_u = make_value_eval(cfg, field, eval_method, n_eval=n_fit)
    opt = optax.adam(lr)

    def loss_fn(values):
        u = eval_u(values, x)
        return jnp.mean((u - y) ** 2)

    @jax.jit
    def step(values, opt_state):
        l, g = jax.value_and_grad(loss_fn)(values)
        updates, opt_state = opt.update(g, opt_state, values)
        return optax.apply_updates(values, updates), opt_state, l

    values, opt_state = field.values, opt.init(field.values)
    for _ in range(steps):
        values, opt_state, l = step(values, opt_state)
    return field._replace(values=values)


def train(cfg: SamplerConfig, *, P: int = 512, D: int = 2, steps: int = 150,
          rollout: int = 3, dt: float = 0.05, sigma: float = 0.12,
          learning_rate: float = 3e-3, n_eval: int = 2048, seed: int = 0,
          neighbor_capacity: int = 64, kappa: float = 0.05,
          log_every: int = 50, logger=None, method: str = "grid",
          eval_method: str = "dense", ladder_frequencies: bool = False,
          scan_chunk: int = 0):
    """Train the dynamics net to roll the field forward in time.

    Returns (params, history).  Per training step, one fresh batch of
    sample points x and loss = mean over rollout depths r of
    mean((u_model(x, r*dt) - u*(x, r*dt))^2).

    Production loop shape (the sampling loop's, models/pigs.py):
      * The rollout's field evaluations are BATCHED into one sampler call:
        the per-depth value vectors ride as channels (P, rollout*C), so the
        binning and the pair sweep run once per step instead of once per
        depth - the field u is linear in the values, so stacking channels
        is exact.  (This also means one sampler instantiation in the
        compiled graph, not ``rollout`` of them.)
      * ``scan_chunk`` > 1 runs that many optimizer steps per device
        program via lax.scan (grad-inside-scan, like pigs.train - one
        dispatch per chunk); 0 picks min(log_every, 32).  Metrics sync once
        per chunk.

    ``method``: "grid" (neighbor-table path; ``neighbor_capacity=None``
    plans exact capacities) or "pallas" (the chunked pair sweeps of
    kernels/aggregate.py - no (P, NC, .) neighbor table).
    ``eval_method``: "dense" or "tiled" (required at large P - see
    make_value_eval).  ``ladder_frequencies``: shared-base frequency ladder
    + the pair sweeps' angle-addition sincos recurrence (see rollout_step).
    """
    import functools
    import time

    u_star = advection_diffusion_solution(D, kappa=kappa)
    key = jax.random.PRNGKey(seed)
    key, k_field, k_params = jax.random.split(key, 3)

    field = init_field(k_field, P, D, 1, sigma=sigma)
    field = fit_values(cfg, field, lambda x: u_star(x, 0.0),
                       eval_method=eval_method)
    rad = compute_radii(field.covariances(), D, cfg.radius_sigma,
                        cfg.eig_floor)
    conics = field.conics()
    if method == "pallas":
        cfg_a, aplan = aggregation.plan_pallas(
            cfg.with_dims(D), field.means, rad)
        nbr = jax.jit(functools.partial(
            aggregation.preprocess_pallas, cfg_a, plan=aplan
        ))(field.means, conics, rad)
    elif neighbor_capacity is None:
        # Exact table: capacities (and the grid tile) planned from the radii.
        cfg_g, nc, rc = aggregation.suggest_grid_capacities(
            cfg.with_dims(D), field.means, rad)
        nbr = aggregation.preprocess_grid(cfg_g, field.means, conics, rad,
                                          nc, rc)
    else:
        nbr = aggregation.preprocess_grid(
            cfg.with_dims(D), field.means, conics, rad, neighbor_capacity
        )
    params = init_dynamics_params(k_params, P, 1, D,
                                  ladder=ladder_frequencies)
    opt = optax.adam(learning_rate)
    padded = eval_method == "tiled"
    eval_u = make_value_eval(cfg, field, eval_method, n_eval=n_eval,
                             with_overflow=True, padded=padded)

    def loss_fn(params, key):
        # Aggregation rollout (Python-unrolled: a handful of steps), then
        # ONE batched field evaluation of every depth's values.
        values, stacked = field.values, []
        for r in range(rollout):
            values = rollout_step(params, values, nbr,
                                  ladder=ladder_frequencies)
            stacked.append(values)
        V = jnp.concatenate(stacked, axis=1)            # (P, rollout*C)
        x = jax.random.uniform(key, (n_eval, D), minval=-1.0, maxval=1.0)
        if padded:
            # Lane-major loss on the kernels' raw padded layout (pad
            # columns are zero and excluded): the cotangent stays packed,
            # skipping the 2-lane transpose + unsort pair (see eval_u).
            # Targets are evaluated directly on the SORTED points - the
            # (N, 1) -> (1, N) turn is a reshape, not a transpose.
            u_pad, perm, overflow = eval_u(V, x)        # (1, R, Np), (N,)
            xs = x[perm]
            tgt_t = jnp.concatenate(
                [u_star(xs, (r + 1.0) * dt).reshape(1, -1)
                 for r in range(rollout)], axis=0)      # (R, N)
            diff = u_pad[0][:, :n_eval] - tgt_t
            return jnp.mean(diff * diff), overflow
        tgt = jnp.concatenate(
            [u_star(x, (r + 1.0) * dt) for r in range(rollout)], axis=1)
        u, overflow = eval_u(V, x)                      # (n_eval, rollout)
        return jnp.mean((u - tgt) ** 2), overflow

    def body(carry, key):
        params, opt_state = carry
        (l, of), g = jax.value_and_grad(loss_fn, has_aux=True)(params, key)
        updates, opt_state = opt.update(g, opt_state, params)
        return (optax.apply_updates(params, updates), opt_state), (l, of)

    @functools.partial(jax.jit, static_argnums=(2,))
    def run(carry, key, n):
        return jax.lax.scan(body, carry, jax.random.split(key, n))

    carry = (params, opt.init(params))
    chunk = scan_chunk if scan_chunk > 0 else max(min(log_every, 32), 1)
    history, i = [], 0
    nbr_of = int(jax.device_get(nbr.overflow))
    while i < steps:
        n = min(chunk, steps - i)
        key, sub = jax.random.split(key)
        t0 = time.perf_counter()
        carry, (ls, ofs) = run(carry, sub, n)
        # One sync per chunk; the first chunk's time includes compilation -
        # take min over records for the warm step time.
        rec = {"step": i + n - 1, "loss": float(ls[-1]),
               "t_step_s": (time.perf_counter() - t0) / n,
               "eval_overflow": int(jax.device_get(ofs[-1])),
               "nbr_overflow": nbr_of}
        i += n
        history.append(rec)
        if logger is not None:
            logger.log(rec)
    return carry[0], history
