"""The pair kernels (kernels/tiled.py) against the masked dense oracle.

On the CPU the kernels run in the Pallas interpreter, so these tests check
their arithmetic, sweeps and padding; ``test_kernels_lower_to_triton``
also lowers them for the GPU (Triton IR), which catches shapes and
operations the Triton route refuses.  ``test_compiled_kernels_on_gpu``
needs a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dgs.binning import chunked
from dgs.binning import grid as binning
from dgs.config import SamplerConfig
from dgs.kernels import tiled
from dgs.oracle import dense as oracle
from dgs.ops import sampling, sampling_chunked

from conftest import make_gaussians, make_samples

BLOCKS = dict(block_n=32, block_e=32, bwd_block_n=32, bwd_block_e=64)
ORDER_SETS = [("value",), ("derivative", "laplacian"), ("third",)]


def _problem(rng, P, N, D, C=2, sigma_range=(0.05, 0.25)):
    m, v, cov, c = make_gaussians(rng, P, D, C, sigma_range=sigma_range)
    s = make_samples(rng, N, D)
    return tuple(map(jnp.asarray, (m, v, cov, c, s)))


def _tiled(cfg, orders, m, v, c, cov, s, blocks=BLOCKS):
    state = binning.build(cfg, m, cov, s)
    assert int(state.overflow) == 0 and int(state.entry_overflow) == 0
    fg = binning.forward_geometry(state, blocks["block_n"], blocks["block_e"])
    bg = binning.backward_geometry(state, blocks["bwd_block_e"],
                                   blocks["bwd_block_n"])

    def f(m_, v_, c_):
        return sampling.sample_tiled_multi(orders, cfg, m_, v_, c_, s, state,
                                           fg, bg, **blocks)

    return f, binning.pair_mask_dense(cfg, state, s, m.shape[0])


def _masked_oracle(orders, mask, s, period=2.0):
    def f(m_, v_, c_):
        return tuple(oracle.evaluate(o, m_, v_, c_, s, pair_mask=mask,
                                     period=period) for o in orders)
    return f


def _close(got, want, rtol, name):
    for a, b in zip(got, want):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=rtol,
            atol=1e-5 * max(1.0, float(np.abs(np.asarray(b)).max())),
            err_msg=name)


@pytest.mark.parametrize("orders", ORDER_SETS, ids=lambda o: "+".join(o))
@pytest.mark.parametrize("D", [1, 2, 3])
def test_forward_matches_masked_oracle(rng, D, orders):
    """Several blocks per side and multi-block sweeps (32-wide blocks)."""
    cfg = SamplerConfig(tile_size=0.25, max_tiles_per_gaussian=8,
                        entry_capacity_factor=8.0 ** D).with_dims(D)
    m, v, cov, c, s = _problem(rng, 45, 150, D)
    f, mask = _tiled(cfg, orders, m, v, c, cov, s)
    _close(f(m, v, c), _masked_oracle(orders, mask, s)(m, v, c), 2e-4,
           f"forward D={D}")


@pytest.mark.parametrize("orders", [("value", "derivative"),
                                    ("laplacian", "third")],
                         ids=lambda o: "+".join(o))
@pytest.mark.parametrize("D", [1, 2, 3])
def test_backward_matches_masked_oracle(rng, D, orders):
    """VJP of a random cotangent: dL/dmeans, dL/dvalues, dL/dconics."""
    cfg = SamplerConfig(tile_size=0.25, max_tiles_per_gaussian=8,
                        entry_capacity_factor=8.0 ** D).with_dims(D)
    m, v, cov, c, s = _problem(rng, 37, 120, D)
    f, mask = _tiled(cfg, orders, m, v, c, cov, s)
    outs, vjp = jax.vjp(f, m, v, c)
    gen = np.random.default_rng(5)
    cots = tuple(jnp.asarray(gen.normal(size=o.shape), jnp.float32)
                 for o in outs)
    _, vjp_ref = jax.vjp(_masked_oracle(orders, mask, s), m, v, c)
    _close(vjp(cots), vjp_ref(cots), 2e-3, f"backward D={D}")


@pytest.mark.parametrize("P,N", [(1, 1), (5, 33), (70, 65)])
def test_block_boundary_padding(rng, P, N):
    """Sample and entry counts that are not block multiples: pad columns of
    the padded output are zero, and values/gradients match the oracle."""
    cfg = SamplerConfig(tile_size=0.5, max_tiles_per_gaussian=8,
                        entry_capacity_factor=16.0)
    m, v, cov, c, s = _problem(rng, P, N, 2, C=1)
    state = binning.build(cfg, m, cov, s)
    fg = binning.forward_geometry(state, 32, 32)
    bg = binning.backward_geometry(state, 64, 32)
    (padded,) = sampling.sample_tiled_multi(
        ("value",), cfg, m, v, c, s, state, fg, bg, sorted_outputs=True,
        padded_outputs=True, **BLOCKS)
    assert padded.shape[-1] % 32 == 0
    np.testing.assert_array_equal(np.asarray(padded[..., N:]), 0.0)
    f, mask = _tiled(cfg, ("value",), m, v, c, cov, s)
    ref = _masked_oracle(("value",), mask, s)
    _close(f(m, v, c), ref(m, v, c), 2e-4, "values")
    loss = lambda fn: lambda *a: sum(jnp.sum(o ** 2) for o in fn(*a))
    _close(jax.grad(loss(f), argnums=(0, 1, 2))(m, v, c),
           jax.grad(loss(ref), argnums=(0, 1, 2))(m, v, c), 2e-3, "grads")


def test_empty_sweeps_write_zeros():
    """Row blocks with nblk = 0 run no loop iteration and still write their
    whole output block (zeros), in both directions."""
    D, C, bn, be = 2, 1, 32, 32
    Np, Ep = 4 * bn, 2 * be
    x = jnp.zeros((D, Np), jnp.float32)
    s_tile = jnp.zeros((Np,), jnp.int32)
    # Means 0, identity conic, value 1: every same-tile pair has G = 1.
    geom = jnp.zeros((tiled.n_params(D, C), Ep), jnp.float32)
    geom = geom.at[D].set(1.0).at[D + 2].set(1.0).at[-1].set(1.0)
    e_tile = jnp.zeros((Ep,), jnp.int32)
    ent = (jnp.zeros((Ep,), jnp.int32), e_tile, geom)
    base = jnp.zeros((4,), jnp.int32)
    nblk = jnp.asarray([2, 0, 1, 0], jnp.int32)
    out = tiled.tiled_forward(("value",), 2.0, D, C, (base, nblk), ent,
                              (x, s_tile), block_n=bn, block_e=be)
    out = np.asarray(out).reshape(C, 4, bn)
    # X = 0, G = 1: each live entry block adds block_e * value 1.
    np.testing.assert_array_equal(out[0, 0], 2 * be)
    np.testing.assert_array_equal(out[0, 2], be)
    np.testing.assert_array_equal(out[0, 1], 0.0)
    np.testing.assert_array_equal(out[0, 3], 0.0)
    g = jnp.ones((C, Np), jnp.float32)
    dent = tiled.tiled_backward(
        ("value",), 2.0, D, C,
        (jnp.zeros((2,), jnp.int32), jnp.asarray([0, 3], jnp.int32)),
        ent, (x, s_tile), g, block_n=bn, block_e=be)
    dent = np.asarray(dent)
    np.testing.assert_array_equal(dent[:, :be], 0.0)
    # dL/dvalues of a live entry: sum over 3 sample blocks of G * g = 3 bn.
    np.testing.assert_array_equal(dent[-1, be:], 3 * bn)


@pytest.mark.parametrize("D", [2, 3])
def test_chunked_kernels_match_masked_oracle(rng, D):
    """The chunked path feeds the same kernels per-chunk sweeps; values and
    gradients against the oracle under the pairs its entry list forms."""
    orders = ("value", "laplacian")
    cfg = SamplerConfig(tile_size=0.4, block_n=32, block_p=32,
                        eig_floor=1e-12).with_dims(D)
    m, v, cov, c, s = _problem(rng, 40, 150, D, sigma_range=(0.05, 0.15))
    cfg, plan = sampling_chunked.plan_chunked(cfg, m, cov, s)
    cs = sampling_chunked.chunk_samples(cfg, s, plan, cfg.block_n)
    rad = oracle.radii(cov, D, cfg.radius_sigma, cfg.eig_floor)

    def f(m_, v_, c_):
        outs, diag = sampling_chunked.sample_chunked_multi(
            orders, cfg, m_, v_, c_, rad, cs, plan, block_n=32, block_e=32)
        return outs

    import dataclasses

    state = binning.build(dataclasses.replace(
        cfg, max_tiles_per_gaussian=plan.rect,
        entry_capacity_factor=float(plan.rect ** D)), m, cov, s)
    mask = binning.pair_mask_dense(cfg, state, s, m.shape[0])
    ref = _masked_oracle(orders, mask, s)
    _close(f(m, v, c), ref(m, v, c), 2e-4, f"chunked forward D={D}")
    loss = lambda fn: lambda *a: sum(jnp.sum(o ** 2) for o in fn(*a))
    _close(jax.grad(loss(f), argnums=(0, 1, 2))(m, v, c),
           jax.grad(loss(ref), argnums=(0, 1, 2))(m, v, c), 2e-3,
           f"chunked grads D={D}")


def test_chunk_sweeps():
    """Each row chunk sweeps the col chunks of its own tile; unused chunks
    (tile T) sweep nothing."""
    col_base = jnp.asarray([0, 2, 2, 5], jnp.int32)
    col_m = jnp.asarray([2, 0, 3, 1], jnp.int32)
    chunk_tile = jnp.asarray([0, 0, 2, 3, 4, 4], jnp.int32)   # T = 4
    base, nblk = chunked.chunk_sweeps(chunk_tile, col_base, col_m)
    assert base.tolist() == [0, 0, 2, 5, 0, 0]
    assert nblk.tolist() == [2, 2, 3, 1, 0, 0]


@pytest.mark.parametrize("D,C,orders", [
    (1, 2, ("value", "derivative", "laplacian", "third")),
    (2, 4, ("value", "derivative", "laplacian")),
    (3, 1, ("value", "derivative", "laplacian", "third")),
])
def test_kernels_lower_to_triton(monkeypatch, D, C, orders):
    """Both kernels lower through Pallas' Triton route for the GPU (Triton
    IR; the GPU compiler proper runs only on the card)."""
    monkeypatch.setattr(tiled, "interpret_mode", lambda: False)
    tri = D * (D + 1) // 2
    bn, be, NB, EB = 64, 32, 4, 8
    ent = (jnp.zeros(EB * be, jnp.int32), jnp.zeros(EB * be, jnp.int32),
           jnp.zeros((D + tri + C, EB * be)))
    smp = (jnp.zeros((D, NB * bn)), jnp.zeros(NB * bn, jnp.int32))
    sweep = (jnp.zeros(NB, jnp.int32), jnp.zeros(NB, jnp.int32))
    fwd = jax.jit(lambda sw, e, s: tiled.tiled_forward(
        orders, 2.0, D, C, sw, e, s, block_n=bn, block_e=be))
    txt = fwd.trace(sweep, ent, smp).lower(
        lowering_platforms=("cuda",)).as_text()
    assert "triton" in txt
    KC = tiled.total_unique(orders, D) * C
    bsweep = (jnp.zeros(EB, jnp.int32), jnp.zeros(EB, jnp.int32))
    bwd = jax.jit(lambda sw, e, s, g: tiled.tiled_backward(
        orders, None, D, C, sw, e, s, g, block_n=bn, block_e=be))
    txt = bwd.trace(bsweep, ent, smp, jnp.zeros((KC, NB * bn))).lower(
        lowering_platforms=("cuda",)).as_text()
    assert "triton" in txt


def test_interpret_mode_by_backend(monkeypatch):
    """Interpreter on the CPU, compiled on the GPU, an error elsewhere -
    never a silent fallback to the interpreter on an accelerator."""
    assert tiled.interpret_mode()
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert not tiled.interpret_mode()
    monkeypatch.setattr(jax, "default_backend", lambda: "metal")
    with pytest.raises(RuntimeError):
        tiled.interpret_mode()


@pytest.mark.gpu
def test_compiled_kernels_on_gpu(gpu_device, rng):
    """The compiled kernels (no interpreter) against the masked oracle, all
    four orders at D=2 and D=3, values and gradients."""
    assert not tiled.interpret_mode()
    orders = ("value", "derivative", "laplacian", "third")
    loss = lambda fn: lambda *a: sum(jnp.sum(o ** 2) for o in fn(*a))
    for D in (2, 3):
        cfg = SamplerConfig(tile_size=0.25, max_tiles_per_gaussian=8,
                            entry_capacity_factor=8.0 ** D).with_dims(D)
        m, v, cov, c, s = _problem(rng, 300, 2000, D, C=3)
        f, mask = _tiled(cfg, orders, m, v, c, cov, s,
                         dict(block_n=32, block_e=16, bwd_block_n=16,
                              bwd_block_e=16))
        ref = _masked_oracle(orders, mask, s)
        _close(jax.jit(f)(m, v, c), jax.jit(ref)(m, v, c), 2e-4,
               f"gpu forward D={D}")
        grad = lambda fn: jax.jit(jax.grad(loss(fn), argnums=(0, 1, 2)))
        _close(grad(f)(m, v, c), grad(ref)(m, v, c), 2e-3,
               f"gpu grads D={D}")
