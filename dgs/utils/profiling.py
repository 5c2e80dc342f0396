"""Tracing / profiling utilities (SURVEY.md section 5: absent in the
reference - only ``-g`` debug symbols, setup.py:30).

Wraps jax.profiler with the repo's conventions: perfetto-compatible traces,
named scopes around the pipeline stages, and a trace post-processor that
aggregates per-kernel device time on the GPU's device planes.
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
from collections import defaultdict
from typing import Dict, Iterator, List

import jax

named_scope = jax.named_scope  # re-export: annotate pipeline stages


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a device trace (view in Perfetto / TensorBoard, or aggregate
    with ``device_op_times``)."""
    with jax.profiler.trace(log_dir):
        yield


def _latest_trace_json(log_dir: str) -> str:
    paths = sorted(glob.glob(
        os.path.join(log_dir, "plugins", "profile", "*", "*.trace.json.gz")
    ))
    if not paths:
        raise FileNotFoundError(f"no trace under {log_dir}")
    return paths[-1]


def device_op_times(log_dir: str, top: int = 25,
                    steps: int = 1) -> List[Dict]:
    """Aggregate per-op device time from the newest trace in ``log_dir``.

    Returns records {name, ms_per_step, calls, source} sorted by time -
    the per-kernel cost table (ms normalized by ``steps`` traced).  Events
    are read from the GPU device planes ("/device:GPU:*"), every stream
    included; a trace with no GPU plane gives an empty table.
    """
    with gzip.open(_latest_trace_json(log_dir)) as f:
        data = json.load(f)
    pids = {}
    for e in data["traceEvents"]:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            pids[e["pid"]] = e["args"].get("name", "")
    dur: Dict[str, float] = defaultdict(float)
    cnt: Dict[str, int] = defaultdict(int)
    src: Dict[str, str] = {}
    for e in data["traceEvents"]:
        if (e.get("ph") == "X"
                and "/device:GPU" in pids.get(e.get("pid"), "")):
            dur[e["name"]] += e.get("dur", 0)
            cnt[e["name"]] += 1
            if e["name"] not in src:
                src[e["name"]] = e.get("args", {}).get("source", "")
    out = [
        {
            "name": k,
            "ms_per_step": round(v / (1000.0 * steps), 4),
            "calls": cnt[k],
            "source": src.get(k, ""),
        }
        for k, v in sorted(dur.items(), key=lambda kv: -kv[1])[:top]
    ]
    return out
