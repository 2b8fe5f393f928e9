#!/usr/bin/env python
"""Capture a jax.profiler trace of the CP loop and print the top device ops.

Parses the perfetto trace written by ``jax.profiler.trace`` directly (no
tensorboard needed) and aggregates device-op durations — the ground truth
for where iteration time goes.
"""

import glob
import gzip
import json
import os
import re
import sys
import tempfile
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from raocp_tpu.utils.compilation import enable_compile_cache

    enable_compile_cache()

    from raocp_tpu.models import random_network_problem
    from raocp_tpu.solver import Solver, _run_cp

    problem, x0 = random_network_problem(
        num_states=50, num_inputs=20, num_modes=3, num_stages=8,
        stopping_time=8)
    solver = Solver(problem, dtype=jnp.float32, offline="device")
    sp = solver.stacked
    x0j = jnp.asarray(x0, sp.dtype)
    alpha = jnp.asarray(0.01, sp.dtype)
    tol0 = jnp.asarray(0.0, sp.dtype)
    z0 = sp.zero_primal(xp=np)
    eta0 = sp.zero_dual(xp=np)

    iters = 50
    check_every = int(os.environ.get("CHECK_EVERY", "25"))
    unroll = int(os.environ.get("UNROLL", "25"))
    out = _run_cp(sp, z0, eta0, x0j, alpha, alpha, tol0, iters,
                  check_every=check_every, unroll=unroll)
    jax.block_until_ready(out)

    trace_dir = tempfile.mkdtemp(prefix="raocp_trace_")
    with jax.profiler.trace(trace_dir):
        out = _run_cp(sp, z0, eta0, x0j, alpha, alpha, tol0, iters,
                      check_every=check_every, unroll=unroll)
        jax.block_until_ready(out)

    files = sorted(glob.glob(
        os.path.join(trace_dir, "**", "*.trace.json.gz"), recursive=True))
    if not files:
        print("no trace file found under", trace_dir)
        return
    with gzip.open(files[-1], "rt") as fh:
        trace = json.load(fh)

    # device-op events: the GPU planes (/device:GPU:N) and nothing else
    pids = {}
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") == "M" and ev.get("name") == "process_name":
            pids[ev["pid"]] = ev["args"].get("name", "")
    dev_pids = {p for p, name in pids.items()
                if re.match(r"/device:GPU:\d+", name)}
    if not dev_pids:
        raise RuntimeError("no /device:GPU:N plane in the trace; processes: "
                           f"{sorted(pids.values())}")

    agg = defaultdict(lambda: [0.0, 0])
    total = 0.0
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") == "X" and ev.get("pid") in dev_pids:
            name = ev.get("name", "?")
            dur = float(ev.get("dur", 0.0))
            agg[name][0] += dur
            agg[name][1] += 1
            total += dur
    rows = sorted(agg.items(), key=lambda kv: -kv[1][0])[:40]
    print(f"device total {total/1e3:.2f} ms over {iters} iters "
          f"({total/iters:.1f} us/iter), {len(agg)} distinct ops")
    for name, (dur, cnt) in rows:
        print(f"{dur/iters:9.2f} us/iter  x{cnt/iters:6.1f}  {name[:90]}")


if __name__ == "__main__":
    main()
