#!/usr/bin/env python
"""Roofline / speed-of-light accounting for the CP iteration.

For each component of the production step (L, L', prox_f, g* projections,
residuals) and for the whole production loop trip (unroll=check_every=25),
this script reports:

* FLOPs and HBM bytes accessed — from XLA's own ``cost_analysis()`` of the
  compiled executable (not hand counts),
* measured device time — serialised ``fori_loop`` timing harness (a data
  dependency between trips stops XLA from overlapping them),
* the roofline bound max(bytes / HBM_BW, flops / peak) for the device,
  and the achieved fraction of that bound.

The CP iteration is expected to be bandwidth-bound: its batched GEMVs do
about 2 flops per float32 element read, far below the H100's float32 ridge
of 67e12 / 3.35e12 = 20 flops/byte, so "speed of light" here means HBM
speed: 100% of roofline = every byte of problem data + iterate moved once
at full bandwidth. Peaks are the published ones; the card's power limit
(``nvidia-smi --query-gpu=power.limit``) belongs beside every share. Writes
one JSON line per row plus a summary table.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

# Published peaks per JAX device_kind: (float32 FLOP/s, HBM bytes/s).
# NVIDIA H100 data sheet, SXM part at its 700 W limit: 67 TFLOP/s float32
# outside the tensor cores (the solver runs full-float32 products, never
# TF32) and 3.35 TB/s of HBM3.
_CHIP_SPECS = {
    "NVIDIA H100 80GB HBM3": (67e12, 3.35e12),
}


def chip_peaks(device_kind: str):
    """(peak float32 FLOP/s, peak HBM bytes/s) of a device kind; a kind
    missing from the table is an error, not a default."""
    try:
        return _CHIP_SPECS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device_kind {device_kind!r}; add them "
            "to _CHIP_SPECS with their source") from None

UNROLL = 25


def _cost(fn, *args):
    """(flops, bytes_accessed) from XLA's cost model of the compiled fn."""
    ca = jax.jit(fn).lower(*args).compile().cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0]
    return float(ca.get("flops", 0.0)), float(ca.get("bytes accessed", 0.0))


def _time(fn, *args, iters=100):
    """Serialised device time per call, in seconds (see bench_components)."""
    @jax.jit
    def loop(*args):
        def body(_, a):
            out = fn(*a)
            dep = sum(jnp.sum(l.ravel()[:1])
                      for l in jax.tree_util.tree_leaves(out))
            return jax.tree_util.tree_map(lambda x: x + 1e-30 * dep, a)
        return jax.lax.fori_loop(0, iters, body, args)

    out = loop(*args)
    jax.block_until_ready(out)
    best = float("inf")
    for _ in range(3):
        tic = time.perf_counter()
        out = loop(*args)
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - tic)
    return best / iters


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--stages", type=int, default=8,
                    help="8 = headline 9841 nodes; 10 = 88573 nodes")
    ap.add_argument("--unroll", type=int, default=UNROLL)
    args = ap.parse_args()
    unroll = args.unroll

    from raocp_tpu.utils.compilation import enable_compile_cache

    enable_compile_cache()

    from raocp_tpu.models import random_network_problem
    from raocp_tpu.ops.operator import ell, ell_t
    from raocp_tpu.ops.prox import g_conj_projections, prox_f
    from raocp_tpu.solver import (Solver, _cp_residuals, _cp_step,
                                  cp_iteration)

    dev = jax.devices()[0]
    peak_flops, hbm_bw = chip_peaks(dev.device_kind)

    problem, x0 = random_network_problem(
        num_states=50, num_inputs=20, num_modes=3, num_stages=args.stages,
        stopping_time=args.stages)
    solver = Solver(problem, dtype=jnp.float32, offline="device")
    sp = solver.stacked
    x0j = jnp.asarray(x0, sp.dtype)
    alpha = jnp.asarray(0.01, sp.dtype)

    key = jax.random.PRNGKey(0)
    z = sp.zero_primal()
    z = z._replace(x=jax.random.normal(key, z.x.shape, sp.dtype),
                   u=jax.random.normal(key, z.u.shape, sp.dtype))
    eta = ell(sp, z)
    Lz, Lt = ell(sp, z), ell_t(sp, eta)

    prec = jax.default_matmul_precision("float32")

    def trip(z, eta, Lz, Lt):
        """One production while_loop trip: `unroll` steps + the final-slot
        residual evaluation (mirrors _run_cp with unroll=check_every)."""
        for i in range(unroll):
            prev = (z, eta, Lz, Lt)
            z, eta, Lz, Lt = _cp_step(sp, z, eta, Lz, Lt, alpha, alpha, x0j)
        err, derr = _cp_residuals(sp, prev[0], z, prev[1], eta, prev[2],
                                  Lz, prev[3], Lt, alpha, alpha)
        return z, eta, Lz, Lt, err, derr

    rows = []

    def row(name, fn, *args, per=1, iters=100):
        with prec:
            flops, nbytes = _cost(fn, *args)
            secs = _time(fn, *args, iters=iters)
        flops, nbytes, secs = flops / per, nbytes / per, secs / per
        bound = max(nbytes / hbm_bw, flops / peak_flops)
        r = {
            "component": name,
            "flops": flops,
            "bytes": nbytes,
            "intensity_flops_per_byte": round(flops / nbytes, 3),
            "measured_us": round(secs * 1e6, 1),
            "roofline_us": round(bound * 1e6, 1),
            "pct_of_roofline": round(100 * bound / secs, 1),
            "bound_by": "hbm" if nbytes / hbm_bw >= flops / peak_flops
            else "flops",
        }
        rows.append(r)
        print(json.dumps(r), flush=True)

    row("L apply", lambda z: (ell(sp, z),), z)
    row("L' apply", lambda e: (ell_t(sp, e),), eta)
    row("prox_f", lambda zz: (prox_f(sp, zz, alpha, x0j),), z)
    row("g* projections", lambda e: (g_conj_projections(sp, e),), eta)
    row("cp_step (2 applies + prox)",
        lambda *a: _cp_step(sp, *a, alpha, alpha, x0j), z, eta, Lz, Lt)
    row("cp_iteration (step + residuals)",
        lambda *a: cp_iteration(sp, *a, alpha, alpha, x0j), z, eta, Lz, Lt)
    row("production trip / iteration", trip, z, eta, Lz, Lt, per=unroll,
        iters=max(2, 100 // unroll))

    print(f"\ndevice: {dev.device_kind}  "
          f"peak {peak_flops/1e12:.0f} TF/s float32, "
          f"HBM {hbm_bw/1e9:.0f} GB/s")
    hdr = (f"{'component':34s} {'GFLOP':>8s} {'MB':>8s} {'meas us':>8s} "
           f"{'SOL us':>7s} {'%SOL':>6s}")
    print(hdr)
    for r in rows:
        print(f"{r['component']:34s} {r['flops']/1e9:8.3f} "
              f"{r['bytes']/1e6:8.1f} {r['measured_us']:8.1f} "
              f"{r['roofline_us']:7.1f} {r['pct_of_roofline']:6.1f}")


if __name__ == "__main__":
    main()
