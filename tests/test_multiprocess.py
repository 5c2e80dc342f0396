"""Multi-HOST mechanics: 2 real processes x 4 virtual CPU devices each,
bootstrapped with jax.distributed.initialize, running the sharded
evaluation over ONE global (data, model) mesh spanning both processes.
Loss and gradient norms must match the single-process reference
(SURVEY.md section 4: multi-process CPU rehearsal of the DCN rendezvous +
ICI mesh; parallel/mesh.initialize_distributed is the production entry).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

_WORKER = r"""
import json, sys
import jax

jax.config.update("jax_platforms", "cpu")
coordinator, pid = sys.argv[1], int(sys.argv[2])
jax.distributed.initialize(coordinator_address=coordinator,
                           num_processes=2, process_id=pid)

import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from dgs.config import SamplerConfig
from dgs.parallel import mesh as pmesh

assert jax.process_count() == 2
assert len(jax.devices()) == 8, len(jax.devices())

P_G, N, D, C = 64, 256, 2, 3
rng = np.random.default_rng(0)
sys.path.insert(0, "tests")
from conftest import make_gaussians
means, values, covs, conics = make_gaussians(rng, P_G, D, C)
samples = rng.uniform(-1.0, 1.0, (N, D)).astype(np.float32)

cfg = SamplerConfig().with_dims(D)
mesh = pmesh.make_mesh((4, 2))


def put(x, spec):
    return jax.make_array_from_callback(
        x.shape, NamedSharding(mesh, spec), lambda idx: x[idx])


m = put(means, P("model"))
v = put(values, P("model"))
c = put(conics, P("model"))
cov = put(covs, P("model"))
s = put(samples, P("data"))


@jax.jit
def loss_and_gnorm(m, v, c, cov, s):
    def loss(m, v, c):
        outs = pmesh.sharded_sample_all(
            cfg, mesh, m, v, c, cov, s,
            orders=("value", "derivative"), method="dense")
        return sum(jnp.sum(o * o) for o in outs.values())

    l, g = jax.value_and_grad(loss, argnums=(0, 1, 2))(m, v, c)
    gn = sum(jnp.sum(x * x) for x in g)
    return l, gn


l, gn = loss_and_gnorm(m, v, c, cov, s)
print("RESULT " + json.dumps({"pid": pid, "loss": float(l),
                              "gnorm": float(gn)}))
"""


@pytest.mark.slow
def test_two_process_mesh_matches_single_process(rng, tmp_path):
    port = _free_port()
    coordinator = f"localhost:{port}"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = os.getcwd()

    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), coordinator, str(i)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, cwd=os.getcwd(),
        )
        for i in range(2)
    ]
    results = {}
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
        for line in out.splitlines():
            if line.startswith("RESULT "):
                r = json.loads(line[len("RESULT "):])
                results[r["pid"]] = r
    assert set(results) == {0, 1}

    # Single-process reference (dense path, no mesh).
    import jax
    import jax.numpy as jnp

    from conftest import make_gaussians
    from dgs.config import SamplerConfig
    from dgs.ops import sampling

    P_G, N, D, C = 64, 256, 2, 3
    means, values, covs, conics = make_gaussians(rng, P_G, D, C)
    samples = rng.uniform(-1.0, 1.0, (N, D)).astype(np.float32)
    cfg = SamplerConfig().with_dims(D)

    def loss(m, v, c):
        outs = sampling.sample_dense_all(
            m, v, c, jnp.asarray(samples), period=cfg.period,
            orders=("value", "derivative"))
        return sum(jnp.sum(o * o) for o in outs.values())

    l_ref, g = jax.value_and_grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(means), jnp.asarray(values), jnp.asarray(conics))
    gn_ref = float(sum(jnp.sum(x * x) for x in g))

    for pid, r in results.items():
        assert r["loss"] == pytest.approx(float(l_ref), rel=1e-5), pid
        assert r["gnorm"] == pytest.approx(gn_ref, rel=1e-4), pid


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port
