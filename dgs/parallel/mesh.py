"""Multi-chip / multi-host sharding (SPMD over a device mesh).

The reference is single-GPU with no distribution layer (SURVEY.md section 2:
"Parallelism & distributed-communication inventory: NONE"); this build
treats it as first-class (BASELINE.json north star).  Design:

  * ``data`` mesh axis shards SAMPLE points - each sample's output is an
    independent sum over Gaussians, so the forward has zero cross-talk and
    parameter gradients are all-reduced (psum) over ``data`` by the autodiff
    transpose of the replication.
  * ``model`` mesh axis shards GAUSSIANS - the mixture sum is associative, so
    each shard evaluates a partial field and the partials are ``psum``-ed over
    ``model`` (the ring/SP analogue for Gaussian mixtures: all-reduce over
    partial mixtures, SURVEY.md section 5).

Everything compiles through shard_map, and XLA hands the collectives to
NCCL.  The cards of one host are joined all to all (NVLink), so the mesh
shape follows the algorithm, not the wiring.  Multi-host bootstrap is
jax.distributed.initialize + the same mesh spanning all processes.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import SamplerConfig
from ..ops import sampling


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """('data', 'model') mesh over the available devices."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if shape is None:
        shape = (n, 1)
    assert shape[0] * shape[1] == n, f"mesh {shape} != {n} devices"
    # Auto axis types: arrays created inside shard_map bodies must stay
    # unsharded-local (explicit-mode meshes stamp iota/arange avals with the
    # mesh and break integer indexing of per-shard arrays).
    return jax.make_mesh(
        shape, ("data", "model"),
        axis_types=(jax.sharding.AxisType.Auto,) * 2,
        devices=devices,
    )


def initialize_distributed(**kwargs) -> None:
    """Multi-host bootstrap (no-op if single-process); pass
    coordinator_address, num_processes and process_id explicitly."""
    if jax.process_count() == 1 and not kwargs:
        return
    jax.distributed.initialize(**kwargs)


def sharded_sample_all(cfg: SamplerConfig, mesh: Mesh,
                       means, values, conics, covariances, samples,
                       orders=sampling.ALL_ORDERS, method: str = "tiled"):
    """Fused multi-order evaluation sharded over (data=samples,
    model=gaussians).  Returns outputs in the original sample order,
    replicated over ``model``."""
    orders = tuple(orders)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        check_vma=False,
        in_specs=(
            P("model"), P("model"), P("model"), P("model"), P("data"),
        ),
        out_specs=P("data"),
    )
    def run(m, v, c, cov, s):
        if method == "tiled":
            outs, _ = sampling.sample_binned(cfg, m, v, c, cov, s, orders)
        else:
            outs = sampling.sample_all(
                m, v, c, s, period=cfg.period, orders=orders
            )
        # Partial mixtures from each gaussian shard -> all-reduce.
        return jax.tree.map(lambda o: jax.lax.psum(o, "model"), outs)

    return run(means, values, conics, covariances, samples)


def make_sharded_pigs_step(cfg: SamplerConfig, mesh: Mesh, optimizer,
                           f_rhs, u_star, *, n_collocation: int = 4096,
                           method: str = "tiled",
                           w_pde: float = 1.0, w_data: float = 1.0,
                           grad_chunks: int = 1):
    """Sharded PIGS training step.

    Gaussian parameters and optimizer state are replicated (data-parallel);
    collocation points are sharded over the full mesh.  The loss is the
    global mean (psum over shards), so jax.grad's transpose inserts the
    gradient all-reduce automatically.

    ``grad_chunks > 1`` splits each shard's collocation batch into that many
    microbatches, each contributing its OWN gradient all-reduce: chunk k's
    reduction is independent of chunk k+1's backward compute, so XLA's
    latency-hiding scheduler can overlap communication with the remaining
    backward work (SURVEY.md section 7: "chunk backward over sample shards,
    issue psum per chunk").  The summed result equals the unchunked
    gradient over the union of the chunks' collocation points.
    """
    from ..models import pigs

    n_shards = mesh.devices.size
    assert n_collocation % (n_shards * grad_chunks) == 0

    def step(state: pigs.TrainState, key):
        D = state.field.D

        @functools.partial(
            jax.shard_map,
            mesh=mesh,
            check_vma=False,
            in_specs=(P(), P(("data", "model"))),
            out_specs=(P(), P()),
        )
        def loss_and_grad(field, keys):
            k1, k2 = jax.random.split(keys[0])
            n_local = n_collocation // n_shards
            data_x = jax.random.uniform(
                k2, (max(n_local // 4, 1), D), minval=-1.0, maxval=1.0
            )
            data_u = u_star(data_x)

            def chunk_grad(k):
                collocation = jax.random.uniform(
                    k, (n_local // grad_chunks, D), minval=-1.0, maxval=1.0
                )

                def local_loss(f):
                    loss, metrics = pigs.pigs_loss(
                        cfg, f, collocation, data_x, data_u, f_rhs,
                        w_pde=w_pde, w_data=w_data, method=method,
                    )
                    return loss, metrics

                (loss, metrics), grads = jax.value_and_grad(
                    local_loss, has_aux=True
                )(field)
                # Per-chunk all-reduce: issued as soon as this chunk's
                # backward finishes, overlapping the next chunk's compute.
                grads = jax.tree.map(
                    lambda g: jax.lax.pmean(g, ("data", "model")), grads
                )
                return metrics, grads

            # grad_chunks == 1 must reproduce the unchunked RNG stream
            # exactly (the model-sharded step draws collocation from k1).
            ks = [k1] if grad_chunks == 1 else jax.random.split(
                k1, grad_chunks)
            # Python-unrolled (not lax.scan): each chunk's collective must
            # be a distinct HLO op for the scheduler to overlap them.
            metrics, grads = chunk_grad(ks[0])
            for i in range(1, grad_chunks):
                m_i, g_i = chunk_grad(ks[i])
                grads = jax.tree.map(jnp.add, grads, g_i)
                metrics = jax.tree.map(jnp.add, metrics, m_i)
            inv = 1.0 / grad_chunks
            grads = jax.tree.map(lambda g: g * inv, grads)
            metrics = jax.tree.map(
                lambda x: jnp.asarray(x, jnp.float32) * inv, metrics
            )
            metrics = jax.tree.map(
                lambda x: jax.lax.pmean(
                    jnp.asarray(x, jnp.float32), ("data", "model")
                ),
                metrics,
            )
            return metrics, grads

        keys = jax.random.split(key, n_shards)
        metrics, grads = loss_and_grad(state.field, keys)
        updates, opt_state = optimizer.update(grads, state.opt_state, state.field)
        field = optax_apply(state.field, updates)
        field = field._replace(means=pigs.wrap_means(field.means, cfg.period))
        return pigs.TrainState(field, opt_state, state.step + 1), metrics

    return jax.jit(step)


def make_model_sharded_pigs_step(cfg: SamplerConfig, mesh: Mesh, optimizer,
                                 f_rhs, u_star, *,
                                 n_collocation: int = 4096,
                                 method: str = "tiled",
                                 w_pde: float = 1.0, w_data: float = 1.0):
    """PIGS step with Gaussian parameters (and optimizer state) SHARDED over
    the 'model' axis - the memory-scaling configuration for very large P
    (BASELINE.json config 5: 1M Gaussians).

    Dataflow per step:
      * every model shard evaluates its partial mixture at its data shard's
        collocation points (the mixture sum is associative);
      * partial outputs all-reduce (psum) over 'model' BEFORE the nonlinear
        loss - the autodiff transpose of that psum is a broadcast, so each
        shard's parameter gradients stay LOCAL: no parameter all-gather and
        no parameter-gradient all-reduce over 'model' ever happens;
      * gradients pmean only over 'data' (the transpose of replicating the
        parameters across data shards);
      * the optimizer update runs shard-local on the sharded params/state -
        the reduce-scatter-style sharded optimizer, for free.

    Returns (step, shard_field): ``shard_field`` places a GaussianField (and
    pytrees of matching leaves, e.g. optimizer state) with axis 0 sharded
    over 'model'.
    """
    from ..models import pigs

    n_shards = mesh.devices.size
    assert n_collocation % n_shards == 0

    def shard_field(tree):
        # Axis 0 of every array leaf is the Gaussian axis; scalars (e.g. the
        # optimizer step count) replicate.
        return jax.tree.map(
            lambda x: jax.device_put(
                x,
                NamedSharding(mesh, P("model") if jnp.ndim(x) >= 1 else P()),
            ),
            tree,
        )

    def step(state: pigs.TrainState, key):
        D = state.field.D

        @functools.partial(
            jax.shard_map,
            mesh=mesh,
            check_vma=False,
            in_specs=(P("model"), P(("data", "model"))),
            out_specs=(P(), P("model")),
        )
        def loss_and_grad(field, keys):
            # All model shards of a data row share one key -> identical
            # collocation points (keys is sharded over both axes; fold in
            # nothing model-specific).
            k1, k2 = jax.random.split(keys[0])
            n_local = n_collocation // n_shards
            collocation = jax.random.uniform(
                k1, (n_local, D), minval=-1.0, maxval=1.0
            )
            data_x = jax.random.uniform(
                k2, (max(n_local // 4, 1), D), minval=-1.0, maxval=1.0
            )
            data_u = u_star(data_x)
            psum_outs = lambda outs: jax.tree.map(
                lambda o: jax.lax.psum(o, "model"), outs
            )

            def local_loss(f):
                return pigs.pigs_loss(
                    cfg, f, collocation, data_x, data_u, f_rhs,
                    w_pde=w_pde, w_data=w_data, method=method,
                    outs_reduce=psum_outs,
                )

            (loss, metrics), grads = jax.value_and_grad(
                local_loss, has_aux=True
            )(field)
            # Shard-local over 'model'; mean over 'data' only.  Every model
            # shard evaluates the same loss, and the transpose of the
            # output psum sums their cotangents, so the raw gradient is
            # n_model times dL/dparams.
            n_model = mesh.shape["model"]
            grads = jax.tree.map(
                lambda g: jax.lax.pmean(g, "data") / n_model, grads)
            metrics = jax.tree.map(
                lambda x: jax.lax.pmean(
                    jnp.asarray(x, jnp.float32), ("data", "model")
                ),
                metrics,
            )
            return metrics, grads

        # One key per (data, model) submesh row; model shards of a row get
        # the same key via the ('data','model') sharding of a data-major
        # reshape.
        keys = jax.random.split(key, mesh.shape["data"])
        keys = jnp.repeat(keys, mesh.shape["model"], axis=0)
        metrics, grads = loss_and_grad(state.field, keys)
        updates, opt_state = optimizer.update(
            grads, state.opt_state, state.field
        )
        field = optax_apply(state.field, updates)
        field = field._replace(means=pigs.wrap_means(field.means, cfg.period))
        return pigs.TrainState(field, opt_state, state.step + 1), metrics

    return jax.jit(step), shard_field


def build_sharded_aggregation(cfg: SamplerConfig, means, conics, radii,
                              n_shards: int, *, block_n: int = 32,
                              block_e: int = 128):
    """Model-parallel neighbor-aggregation structure: the tile grid is
    partitioned into ``n_shards`` contiguous ranges (balanced by entry
    chunks), one AggBinning per range with identical static shapes, stacked
    on a leading shard axis for shard_map.  Same-tile pairing makes every
    shard's pair sweep fully shard-local (no halo exchange); the only
    collectives in the sharded step are the output psum and the replicated
    parameters' gradient psums (the transpose of replication).

    Returns (cfg', plan, stacked AggBinning)."""
    from ..ops import aggregation

    cfg2, plan, ranges = aggregation.plan_pallas_sharded(
        cfg, means, radii, n_shards, block_n=block_n, block_e=block_e)
    shards = [
        aggregation.preprocess_pallas(
            cfg2, means, conics, radii, plan, block_n, block_e,
            tile_range=r,
        )
        for r in ranges
    ]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *shards)
    return cfg2, plan, stacked


def sharded_aggregate(mesh: Mesh, features, transform, queries, keys,
                      frequencies, distance_transform, aggs,
                      *, ladder_frequencies: bool = False,
                      block_n: int = 32, block_e: int = 128):
    """Attention aggregation over the Gaussian cloud, model-sharded by tile
    range (see build_sharded_aggregation; the leading axis of ``aggs``
    shards over 'model').  Parameters are replicated; each center belongs
    to exactly one shard, so the padded per-slot outputs scatter into (P, L)
    and one psum over 'model' assembles the full result.  Differentiable in
    all six groups: the replication transpose psums the parameter gradients
    automatically (dfeatures/dkeys from each shard's local entries, dqueries
    from its local centers, the small globals from all shards)."""
    from ..ops import aggregation

    n_gauss, L = features.shape

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        check_vma=False,
        in_specs=(P(), P(), P(), P(), P(), P(), P("model")),
        out_specs=P(),
    )
    def run(f, t, q, k, fr, dt, agg_s):
        agg = jax.tree.map(lambda x: x[0], agg_s)
        out_pad = aggregation.aggregate_pallas(
            f, t, q, k, fr, dt, agg, period=None,
            block_n=block_n, block_e=block_e,
            ladder_frequencies=ladder_frequencies, padded_outputs=True,
        )
        out = jnp.zeros((n_gauss + 1, L), out_pad.dtype).at[agg.cid].add(
            out_pad, mode="drop")[:n_gauss]
        return jax.lax.psum(out, "model")

    return run(features, transform, queries, keys, frequencies,
               distance_transform, aggs)


def make_sharded_dynamics_step(mesh: Mesh, optimizer, aggs, values0,
                               target_values, *, rollout: int = 2,
                               ladder_frequencies: bool = False,
                               block_n: int = 32, block_e: int = 128):
    """Jitted model-sharded dynamics training step: ``rollout`` residual
    aggregation updates of the field values through sharded_aggregate, L2
    loss against target values, Adam on all six parameter groups.  The
    aggregation subsystem's analogue of make_sharded_pigs_step (the
    sampling subsystem's sharded step)."""
    def step(params, opt_state):
        def loss_fn(params):
            from ..models.dynamics import DynamicsParams  # noqa: F401

            freqs = params.frequencies
            if ladder_frequencies:
                E = params.distance_transform.shape[0] // 2
                D = aggs.ctr_static.shape[2] - 3
                nfreq = (E - 1) // D // 2
                freqs = params.frequencies[0] * jnp.arange(
                    1, nfreq + 1, dtype=jnp.float32)
            v = values0
            for _ in range(rollout):
                v = v + sharded_aggregate(
                    mesh, v, params.transform, params.queries, params.keys,
                    freqs, params.distance_transform, aggs,
                    ladder_frequencies=ladder_frequencies,
                    block_n=block_n, block_e=block_e,
                )
            return jnp.mean((v - target_values) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax_apply(params, updates), opt_state, loss

    return jax.jit(step)


def optax_apply(params, updates):
    import optax

    return optax.apply_updates(params, updates)


def replicate(tree, mesh: Mesh):
    """Place a pytree replicated over the mesh."""
    sharding = NamedSharding(mesh, P())
    return jax.device_put(tree, sharding)


def shard_samples(samples, mesh: Mesh):
    """Place sample points sharded over both mesh axes."""
    sharding = NamedSharding(mesh, P(("data", "model")))
    return jax.device_put(samples, sharding)
