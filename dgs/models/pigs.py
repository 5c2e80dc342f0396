"""PIGS-style physics-informed training loop (config 4 of BASELINE.json).

Reproduces the downstream usage pattern of the reference (SURVEY.md section
3.5): per step, bin once, evaluate u / grad u / Hessian u (/ third) at
collocation points, form a PDE residual loss, and backprop to every Gaussian
parameter (means, values, and - through the conic chain in models/field.py -
scales and rotations).

The demo problem is a periodic Poisson equation with a manufactured solution:
    u*(x) = sum_k a_k * prod_d sin(pi k x_d + phi)     on the period-2 torus
    -laplace(u) = f := -laplace(u*)
loss = w_pde * mean((-tr H[u] - f)^2) + w_data * mean((u - u*)^2).
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import optax

from ..config import SamplerConfig
from ..ops import sampling
from .field import GaussianField, init_field


def manufactured_solution(D: int, n_modes: int = 3):
    """Periodic target field and its (negative) Laplacian on [-1,1]^D."""
    ks = jnp.arange(1, n_modes + 1, dtype=jnp.float32)
    amps = 1.0 / ks

    def u_star(x):  # (N, D) -> (N, 1)
        out = 0.0
        for i in range(n_modes):
            out = out + amps[i] * jnp.prod(
                jnp.sin(jnp.pi * ks[i] * x + 0.3 * i), axis=-1
            )
        return out[:, None]

    def f_rhs(x):  # -laplace(u*) at x
        out = 0.0
        for i in range(n_modes):
            lam = D * (jnp.pi * ks[i]) ** 2
            out = out + lam * amps[i] * jnp.prod(
                jnp.sin(jnp.pi * ks[i] * x + 0.3 * i), axis=-1
            )
        return out[:, None]

    return u_star, f_rhs


class TrainState(NamedTuple):
    field: GaussianField
    opt_state: optax.OptState
    step: jnp.ndarray


def field_outputs(cfg: SamplerConfig, field: GaussianField, samples,
                  orders=("value", "derivative", "laplacian"),
                  method: str = "tiled", sorted_outputs: bool = False,
                  unique_outputs: bool = False,
                  padded_outputs: bool = False, sample_binning=None):
    """Bin once, evaluate the requested orders (the reference's
    preprocess-once / evaluate-4x reuse, SURVEY.md 3.5).

    With ``sorted_outputs=True`` (tiled only) outputs stay in tile-sorted
    order and diag["perm"] maps rows back to samples - losses that reduce
    over samples should evaluate their targets at ``samples[perm]`` instead
    of paying un-sort gathers.  With ``unique_outputs=True`` (tiled only)
    each order comes back as its canonical (N, n_unique, C) components
    without the symmetric mirror (see formulas.sym_indices)."""
    conics = field.conics()
    if method == "tiled":
        covs = field.covariances()
        return sampling.sample_binned(
            cfg, field.means, field.values, conics, covs, samples,
            tuple(orders), sorted_outputs=sorted_outputs,
            unique_outputs=unique_outputs, padded_outputs=padded_outputs,
            sample_binning=sample_binning,
        )
    if method != "dense":
        raise ValueError(f"unknown method {method!r} (tiled or dense)")
    outs = sampling.sample_all(
        field.means, field.values, conics, samples,
        period=cfg.period, orders=tuple(orders),
    )
    zero = jnp.zeros((), jnp.int32)
    return outs, {"perm": None, "bin_overflow": zero,
                  "entry_overflow": zero}


def pigs_loss(cfg: SamplerConfig, field: GaussianField, collocation,
              data_x, data_u, f_rhs, *, w_pde: float = 1.0,
              w_data: float = 1.0, method: str = "tiled",
              outs_reduce=None):
    """PDE residual + data loss; returns (loss, metrics).

    ``outs_reduce`` (optional) maps the raw field-outputs dict right after
    evaluation - the hook Gaussian-sharded execution uses to all-reduce
    partial mixtures over the 'model' mesh axis BEFORE the nonlinear loss
    (parallel/mesh.py), so autodiff transposes the psum back to shard-local
    parameter gradients.
    """
    D = field.D
    use_tiled = method == "tiled"
    outs, diag = field_outputs(
        cfg, field, collocation, orders=("value", "laplacian"),
        method=method, sorted_outputs=use_tiled, unique_outputs=use_tiled,
    )
    if outs_reduce is not None:
        outs = outs_reduce(outs)
    col_pts = collocation[diag["perm"]] if use_tiled else collocation
    if use_tiled:
        from ..ops import formulas

        u = outs["value"][:, 0, :]          # (N, 1, C) -> (N, C)
        hessu = outs["laplacian"]           # (N, tri, C) unique components
        diag_idx = formulas.unique_diag_indices(D)
        lap = sum(hessu[:, i, :] for i in diag_idx)  # trace (N, C)
    else:
        u = outs["value"]                       # (N, C)
        hess = outs["laplacian"]                # (N, D, D, C)
        lap = jnp.trace(hess, axis1=1, axis2=2) # (N, C)
    pde_residual = -lap - f_rhs(col_pts)
    pde = jnp.mean(pde_residual**2)

    outs_d, diag_d = field_outputs(
        cfg, field, data_x, orders=("value",), method=method,
        sorted_outputs=use_tiled, unique_outputs=use_tiled,
    )
    if outs_reduce is not None:
        outs_d = outs_reduce(outs_d)
    u_d = outs_d["value"][:, 0, :] if use_tiled else outs_d["value"]
    tgt = data_u[diag_d["perm"]] if use_tiled else data_u
    data = jnp.mean((u_d - tgt) ** 2)

    loss = w_pde * pde + w_data * data
    diag = {k: v for k, v in diag.items() if k != "perm"}
    metrics = {"loss": loss, "pde": pde, "data": data, **diag}
    return loss, metrics


def make_train_body(cfg: SamplerConfig, optimizer,
                    f_rhs: Callable, u_star: Callable,
                    *, n_collocation: int = 4096, method: str = "tiled",
                    w_pde: float = 1.0, w_data: float = 1.0):
    """Un-jitted training step body (scan-compatible): sample collocation
    points, loss, adam update."""

    def step(state: TrainState, key) -> Tuple[TrainState, Dict]:
        D = state.field.D
        k1, k2 = jax.random.split(key)
        n_col = n_collocation
        collocation = jax.random.uniform(
            k1, (n_col, D), minval=-1.0, maxval=1.0
        )
        data_x = jax.random.uniform(
            k2, (n_col // 4, D), minval=-1.0, maxval=1.0
        )
        data_u = u_star(data_x)

        def loss_fn(field):
            return pigs_loss(
                cfg, field, collocation, data_x, data_u, f_rhs,
                w_pde=w_pde, w_data=w_data, method=method,
            )

        (loss, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.field
        )
        updates, opt_state = optimizer.update(
            grads, state.opt_state, state.field
        )
        field = optax.apply_updates(state.field, updates)
        field = field._replace(
            means=wrap_means(field.means, cfg.period)
        )
        return TrainState(field, opt_state, state.step + 1), metrics

    return step


def make_train_step(cfg: SamplerConfig, optimizer,
                    f_rhs: Callable, u_star: Callable, **kw):
    """Jitted single training step (see make_train_body)."""
    return jax.jit(make_train_body(cfg, optimizer, f_rhs, u_star, **kw))


def wrap_means(means, period):
    if period is None:
        return means
    return means - period * jnp.round(means / period)


def train(cfg: SamplerConfig, *, P: int = 1000, D: int = 2, C: int = 1,
          steps: int = 200, n_collocation: int = 4096,
          learning_rate: float = 3e-3, sigma: float = 0.1,
          method: str = "tiled", seed: int = 0,
          log_every: int = 50, logger=None, scan_chunk: int = 0,
          auto_capacities: bool = True):
    """Full training run; returns (state, history of metrics).

    ``scan_chunk`` > 1 runs that many steps per device program via lax.scan
    (one dispatch per chunk); metrics are logged once per chunk (the
    chunk's last step).  0 picks min(log_every, 32) automatically.

    ``auto_capacities`` (tiled method) sizes the binning capacities from the
    initial parameters via the host planner, with 2x headroom for training
    drift; watch the overflow metrics if scales grow a lot.
    """
    import dataclasses
    import functools

    u_star, f_rhs = manufactured_solution(D)
    key = jax.random.PRNGKey(seed)
    key, init_key = jax.random.split(key)
    field = init_field(init_key, P, D, C, sigma=sigma)
    optimizer = optax.adam(learning_rate)
    state = TrainState(field, optimizer.init(field), jnp.zeros((), jnp.int32))
    if method == "tiled" and auto_capacities:
        # Size the static capacities from the initial parameters, with
        # headroom for training drift (scales grow -> footprints grow;
        # the per-step overflow metrics report if it is ever outgrown).
        from ..utils import native

        key, probe_key = jax.random.split(key)
        probe = jax.random.uniform(
            probe_key, (n_collocation, D), minval=-1.0, maxval=1.0
        )
        plan = native.plan_capacities(cfg, field.means, field.covariances(),
                                      probe)
        cfg = native.config_from_plan(cfg, plan, P)
        cfg = dataclasses.replace(
            cfg,
            max_tiles_per_gaussian=cfg.max_tiles_per_gaussian + 1,
            entry_capacity_factor=cfg.entry_capacity_factor * 2.0 + 1.0,
            unwrapped_kernels=False,  # drift can violate the certificate
        )
    body = make_train_body(
        cfg, optimizer, f_rhs, u_star, n_collocation=n_collocation,
        method=method,
    )
    chunk = scan_chunk if scan_chunk > 0 else max(min(log_every, 32), 1)

    @functools.partial(jax.jit, static_argnums=(2,))
    def run(state, key, n):
        keys = jax.random.split(key, n)
        return jax.lax.scan(body, state, keys)

    import time

    history, i = [], 0
    while i < steps:
        n = min(chunk, steps - i)
        key, sub = jax.random.split(key)
        t0 = time.perf_counter()
        state, metrics_seq = run(state, sub, n)
        metrics = jax.tree.map(lambda x: x[-1], metrics_seq)
        m = {k: float(v) for k, v in metrics.items()}  # float() syncs
        # Warm per-step wall time for this chunk (the first chunk includes
        # compilation; callers wanting steady-state take min over chunks).
        m["t_step_s"] = (time.perf_counter() - t0) / n
        i += n
        m["step"] = i - 1
        history.append(m)
        if logger is not None:
            logger.log(m)
    return state, history
