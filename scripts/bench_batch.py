#!/usr/bin/env python
"""Batched multi-scenario solve benchmark (``Solver.solve_batch``).

Solves the BASELINE config-3-sized SOC-network problem for a batch of B
initial states in ONE vmapped device program, and compares against B
sequential ``solve`` calls. The interesting number is the batching
efficiency: the per-stage matmuls of a ~3k-node problem are too small to
fill the device, so lanes are nearly free until it saturates.

Usage:  python scripts/bench_batch.py [--batch 8] [--small]

Prints one JSON line per batch size with sequential/batched wall-clock
and the speedup.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--small", action="store_true",
                    help="CI-sized problem on CPU")
    ap.add_argument("--max-iters", type=int, default=4000)
    args = ap.parse_args()

    import jax

    from raocp_tpu.utils.compilation import enable_compile_cache

    enable_compile_cache()
    if args.small:
        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp
    import numpy as np

    from raocp_tpu.models import soc_network_problem
    from raocp_tpu.solver import Solver

    if args.small:
        problem, x0 = soc_network_problem(
            num_states=4, num_inputs=2, num_modes=2, num_stages=4,
            stopping_time=2)
    else:
        problem, x0 = soc_network_problem()   # BASELINE config 3 (~3k nodes)

    solver = Solver(problem, dtype=jnp.float32, offline="device")
    rng = np.random.default_rng(0)
    x0 = np.asarray(x0, dtype=np.float64)
    scales = 0.5 + rng.random(args.batch)
    x0s = np.stack([s * x0 for s in scales])

    kw = dict(max_iters=args.max_iters, tol=1e-3,
              check_every=25, unroll=25)

    # warm both programs (compilation excluded from timing)
    solver.solve(x0s[0], **kw)
    solver.solve_batch(x0s, **kw)

    t0 = time.perf_counter()
    seq = [solver.solve(x, **kw) for x in x0s]
    seq_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    bat = solver.solve_batch(x0s, **kw)
    bat_s = time.perf_counter() - t0

    assert all(r.converged for r in seq) and all(r.converged for r in bat)
    # In float32 on the device, batched and unbatched matmuls may sum in
    # another order, which can shift a lane across a check_every boundary —
    # allow counts to differ by one check period instead of asserting
    # equality.
    for rs, rb in zip(seq, bat):
        diff = abs(rs.num_iters - rb.num_iters)
        if diff > 25:
            raise AssertionError(
                f"batched iteration count drifted beyond one check period: "
                f"{rs.num_iters} vs {rb.num_iters}")
        if diff:
            print(f"note: lane count {rb.num_iters} vs sequential "
                  f"{rs.num_iters} (within one check period)", flush=True)
    print(json.dumps({
        "metric": f"solve_batch_speedup_b{args.batch}",
        "nodes": int(problem.tree.num_nodes),
        "batch": args.batch,
        "sequential_s": round(seq_s, 3),
        "batched_s": round(bat_s, 3),
        "value": round(seq_s / bat_s, 3),
        "unit": "x",
        "iters": [r.num_iters for r in bat],
    }))


if __name__ == "__main__":
    main()
