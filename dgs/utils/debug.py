"""Debug and crash-forensics utilities.

JAX equivalent of the reference's debug machinery: the ``debug`` flag
threaded through every op (__init__.py:215-216) enabling synchronous error
checks (CHECK_CUDA, auxiliary.h:33-40) and the pre-call CPU snapshot dumped on
exception (cpu_deep_copy_tuple + torch.save, __init__.py:17-19, 38-50).

Coverage boundary (deliberate design): snapshots cover the EAGER entry
points (facade method calls outside jit) - the reference's only execution
mode.  Inside a trace (jit/grad/scan training steps) there is no host value
to copy, so ``snapshot_call`` degrades to a plain call; compiled-step
forensics are instead served by the in-step overflow diagnostics (carried
through scan and checked every step by both training loops) and by
``jax.config.update("jax_debug_nans", True)`` for NaN localization.  See
docs/PARITY.md "debug/crash forensics".
"""

from __future__ import annotations

from typing import Any

import jax
import numpy as np


def snapshot_call(debug: bool, name: str, fn, *args: Any, **kwargs: Any):
    """Run ``fn`` and on failure dump host copies of the inputs.

    Mirrors call_debug (__init__.py:38-50): inputs are copied to host *before*
    the call so device-side corruption cannot reach the dump; the snapshot is
    written to ``snapshot_<name>.npz``.
    """
    if not debug:
        return fn(*args, **kwargs)
    # Under a trace (jit/grad of a facade method) there is no host value to
    # snapshot - degrade gracefully to a plain call rather than fail the
    # trace; the eager entry points keep full crash forensics.
    if any(isinstance(a, jax.core.Tracer) for a in args):
        return fn(*args, **kwargs)
    host_args = [
        np.asarray(jax.device_get(a)) if hasattr(a, "shape") else a for a in args
    ]
    try:
        out = fn(*args, **kwargs)
        jax.block_until_ready(out)  # surface async device errors here
        return out
    except Exception:
        path = f"snapshot_{name}.npz"
        np.savez(path, **{f"arg{i}": a for i, a in enumerate(host_args)})
        print(
            f"\n{name} failed; inputs saved to {path} "
            f"(attach it when reporting the crash)."
        )
        raise


def checked(fn, *, errors=None):
    """Compiled-step error checking: the in-jit equivalent of the
    reference's CHECK_CUDA (auxiliary.h:33-40).

    Wraps ``fn`` with ``jax.experimental.checkify`` float checks (NaN/Inf
    at every primitive), so a jitted/scanned training step can localize
    which operation produced the first non-finite value WITHOUT rerunning
    eagerly.  Returns a function producing (err, out); call
    ``err.throw()`` (or ``debug.throw(err)``) after the step - the raised
    message carries the failing primitive and source line.

    Cost: functionalized checks add per-primitive overhead - this is the
    debug=True path, not the production step.  Composes with jit/grad/scan
    (unlike ``jax_debug_nans``, which re-runs op-by-op outside jit and
    cannot see inside a compiled scan body).
    """
    from jax.experimental import checkify

    return checkify.checkify(
        fn, errors=errors if errors is not None else checkify.float_checks)


def throw(err) -> None:
    """Raise the checkify error (if any) - one sync point per step, like
    the reference's per-launch cudaDeviceSynchronize under debug."""
    err.throw()


def check_finite(name: str, tree) -> None:
    """Eager NaN/Inf probe over a pytree (the reference's ad-hoc NaN check,
    __init__.py:185-188, done properly)."""
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        arr = np.asarray(jax.device_get(leaf))
        if np.issubdtype(arr.dtype, np.floating) and not np.isfinite(arr).all():
            raise FloatingPointError(
                f"non-finite values in {name}{jax.tree_util.keystr(path)}"
            )
