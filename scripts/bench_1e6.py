#!/usr/bin/env python
"""Push the problem size toward 10^6 nodes (VERDICT r2 item 2: measured
max problem size after the dense offline stacks became lazy).

Default config: 50-state / 20-input network, 3-mode chain fully branched
for ``--stages`` stages — 12 stages = 797,161 nodes ((3^13-1)/2). The
solve loop reads only the stage-constant Riccati tables + mode blocks, so
HBM holds the iterates (x/e3 are the big ones: [N, n] each), not dense
[N, n, n] stacks. Prints one JSON line like bench.py.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--stages", type=int, default=12)
    ap.add_argument("--states", type=int, default=50)
    ap.add_argument("--inputs", type=int, default=20)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--unroll", type=int, default=5)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from raocp_tpu.utils.compilation import enable_compile_cache

    enable_compile_cache()

    from raocp_tpu.models import random_network_problem
    from raocp_tpu.solver import Solver, _power_iteration, _run_cp

    t0 = time.perf_counter()
    problem, x0 = random_network_problem(
        num_states=args.states, num_inputs=args.inputs, num_modes=3,
        num_stages=args.stages, stopping_time=args.stages)
    tree_s = time.perf_counter() - t0
    solver = Solver(problem, dtype=jnp.float32, offline="device")
    sp = solver.stacked
    jax.block_until_ready(sp.Pi)
    build_s = time.perf_counter() - t0

    # loose power iteration: the step size only needs a few digits
    lam, _ = _power_iteration(sp, rel_tol=1e-6)
    alpha = jnp.asarray(0.999 / float(lam), sp.dtype)
    x0j = jnp.asarray(x0, sp.dtype)
    tol0 = jnp.asarray(0.0, sp.dtype)
    z0 = sp.zero_primal(xp=np)
    z0.x[0] = np.asarray(x0, dtype=z0.x.dtype)
    eta0 = sp.zero_dual(xp=np)
    z0 = jax.tree_util.tree_map(jnp.asarray, z0)    # device-resident
    eta0 = jax.tree_util.tree_map(jnp.asarray, eta0)

    out = _run_cp(sp, z0, eta0, x0j, alpha, alpha, tol0, args.iters,
                  check_every=25, unroll=args.unroll)
    jax.block_until_ready(out)
    tic = time.perf_counter()
    out = _run_cp(sp, z0, eta0, x0j, alpha, alpha, tol0, args.iters,
                  check_every=25, unroll=args.unroll)
    jax.block_until_ready(out)
    toc = time.perf_counter()

    iters = int(out[2])
    print(json.dumps({
        "metric": f"cp_iterations_per_s_{sp.num_nodes}node_"
                  f"{args.states}state_tree",
        "value": round(iters / (toc - tic), 3),
        "unit": "iter/s",
        "num_nodes": sp.num_nodes,
        "tree_seconds": round(tree_s, 1),
        "build_seconds": round(build_s, 1),
        "iters": iters,
        "unroll": args.unroll,
    }))


if __name__ == "__main__":
    main()
