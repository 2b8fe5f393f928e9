#!/usr/bin/env python
"""Headline benchmark: CP iterations/s on a ~10^4-node scenario-tree RAOCP.

Problem: BASELINE.json config 4 scale — 50-state / 20-input network, 3-mode
Markov chain, 9841 nodes (3^0..3^8), AVaR(0.95), box constraints. Runs on
JAX's default device, float32.

Prints ONE JSON line:
  {"metric": ..., "value": iters/s, "unit": "iter/s", "vs_baseline": ratio,
   "device": {"platform", "device_kind", "count", "power_limit"}}

vs_baseline compares against the reference's pure-NumPy implementation on
the same problem, measured once by scripts/measure_reference.py and recorded
in BASELINE_MEASURED.json (iterations/s, CPU).
"""

import json
import os
import time


BENCH_ITERS = 20000  # solve-scale: the production solve of this config
                     # runs ~10k iterations, so the per-call constant
                     # (host->device iterate transfer + dispatch) amortises


def _power_limit() -> str:
    """The first GPU's power limit from nvidia-smi ("" where there is no
    nvidia-smi): a card set below its maximum runs slower under load."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def main() -> None:
    import jax
    import jax.numpy as jnp

    from raocp_tpu.utils.compilation import enable_compile_cache

    enable_compile_cache()

    from raocp_tpu.models import random_network_problem
    from raocp_tpu.solver import Solver, _power_iteration, _run_cp

    problem, x0 = random_network_problem(
        num_states=50, num_inputs=20, num_modes=3, num_stages=8,
        stopping_time=8)
    # offline="device": only per-mode dynamics + index plans cross the
    # host->device link; the Riccati stacks are computed on-chip
    solver = Solver(problem, dtype=jnp.float32, offline="device")
    sp = solver.stacked

    lam, _ = _power_iteration(sp)
    alpha = jnp.asarray(0.999 / float(lam), sp.dtype)
    x0j = jnp.asarray(x0, sp.dtype)
    tol0 = jnp.asarray(0.0, sp.dtype)   # tol 0 => exactly BENCH_ITERS+1 steps
    import numpy as np
    z0 = sp.zero_primal(xp=np)
    z0.x[0] = np.asarray(x0, dtype=z0.x.dtype)
    eta0 = sp.zero_dual(xp=np)

    # production configuration: convergence residuals evaluated every 25
    # iterations (SCS-style periodic checks) — between checks an iteration
    # is two operator applies; the reference evaluates its stopping test
    # (five applies) every iteration. unroll == check_every places the
    # check statically in the unrolled trip body: no per-iteration cond,
    # no history writes between checks (measured +13% over unroll=1).
    CHECK_EVERY = 25
    UNROLL = 25

    # compile + warm-up
    out = _run_cp(sp, z0, eta0, x0j, alpha, alpha, tol0, BENCH_ITERS,
                  check_every=CHECK_EVERY, unroll=UNROLL)
    jax.block_until_ready(out)

    # best-of-5: the host shares its cores, single timings vary
    best = float("inf")
    for _ in range(5):
        tic = time.perf_counter()
        out = _run_cp(sp, z0, eta0, x0j, alpha, alpha, tol0, BENCH_ITERS,
                      check_every=CHECK_EVERY, unroll=UNROLL)
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - tic)

    iters = int(out[2])
    ips = iters / best

    vs_baseline = None
    base_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "BASELINE_MEASURED.json")
    if os.path.exists(base_path):
        with open(base_path) as fh:
            base = json.load(fh)
        ref_ips = base.get("reference_iters_per_s")
        if ref_ips:
            vs_baseline = ips / ref_ips

    dev = jax.devices()[0]
    print(json.dumps({
        "metric": "cp_iterations_per_s_9841node_50state_tree",
        "value": round(ips, 3),
        "unit": "iter/s",
        "vs_baseline": round(vs_baseline, 2) if vs_baseline else None,
        "device": {"platform": dev.platform, "device_kind": dev.device_kind,
                   "count": len(jax.devices()),
                   "power_limit": _power_limit()},
    }))


if __name__ == "__main__":
    main()
