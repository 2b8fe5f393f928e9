#!/usr/bin/env python
"""Scaling harness: CP iterations/s at 1, 2, 4, ... devices, for BOTH
multi-device strategies (flat GSPMD node split vs replicated-spine subtree
partition), plus the compiled collective count of each loop.

BASELINE.json's scaling target is ">=70% efficiency at 2 hosts". On real
multi-chip hardware run this directly (optionally after
``raocp_tpu.parallel.initialize_distributed()`` on a pod). Without one it
falls back to virtual CPU devices (``--virtual N``), which validates the
SPMD programs end-to-end and measures the COLLECTIVE BUDGET trend — the
measurable proxy on a single host: virtual devices share the same cores,
so virtual iters/s cannot show speedup, but the collective counts and the
per-step overhead trend vs mesh size are real program properties.

Prints one JSON line per (partition, devices).
"""

import argparse
import json
import os
import sys
import time
from functools import partial

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _collective_count(hlo: str) -> dict:
    names = ("all-reduce", "all-gather", "all-to-all", "collective-permute",
             "reduce-scatter")
    counts = {n: hlo.count(f" {n}(") for n in names}
    counts["total"] = sum(counts.values())
    return counts


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--virtual", type=int, default=0,
                    help="force N virtual CPU devices")
    ap.add_argument("--iters", type=int, default=500)
    ap.add_argument("--num-stages", type=int, default=8)
    ap.add_argument("--num-states", type=int, default=50)
    ap.add_argument("--partitions", default="subtree,flat")
    ap.add_argument("--flat-max", type=int, default=None,
                    help="run the flat partition only up to this many "
                    "devices (its resharding traffic makes large-device "
                    "runs at 1e4+ nodes prohibitively slow; the 1-device "
                    "flat row is the partition-free baseline)")
    args = ap.parse_args()

    if args.virtual:
        flags = os.environ.get("XLA_FLAGS", "")
        os.environ["XLA_FLAGS"] = (
            flags +
            f" --xla_force_host_platform_device_count={args.virtual}"
        ).strip()

    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P

    if args.virtual:
        jax.config.update("jax_platforms", "cpu")
    from raocp_tpu.utils.compilation import enable_compile_cache

    enable_compile_cache()

    from raocp_tpu.core.stacked import build_stacked
    from raocp_tpu.core.variables import Dual, Primal
    from raocp_tpu.models import random_network_problem
    from raocp_tpu.parallel import make_mesh, shard_problem, shard_variables
    from raocp_tpu.parallel.subtree import build_subtree_problem
    from raocp_tpu.solver import _run_cp

    n_dev = len(jax.devices())
    sizes = [1]
    while sizes[-1] * 2 <= n_dev:
        sizes.append(sizes[-1] * 2)
    partitions = args.partitions.split(",")

    problem, x0 = random_network_problem(
        num_states=args.num_states, num_inputs=args.num_states // 2,
        num_modes=3, num_stages=args.num_stages,
        stopping_time=args.num_stages)
    # production loop configuration
    loop = dict(max_iters=args.iters, check_every=25, unroll=25)
    base_ips = {}

    def report(part, nd, run, lower_args, sp_dtype):
        out = run(*lower_args)
        jax.block_until_ready(out)
        tic = time.perf_counter()
        out = run(*lower_args)
        jax.block_until_ready(out)
        dt_s = time.perf_counter() - tic
        ips = int(out[2]) / dt_s
        hlo = run.lower(*lower_args).compile().as_text()
        # speedup/efficiency are vs the first row (the 1-device run, which
        # is partition-free) for BOTH partitions
        base = base_ips.setdefault("base", ips)
        print(json.dumps({
            "partition": part,
            "devices": nd,
            "num_nodes": problem.tree.num_nodes,
            "iters_per_s": round(ips, 2),
            "speedup": round(ips / base, 3),
            "efficiency": round(ips / base / nd, 3),
            "collectives_per_trip": _collective_count(hlo),
        }), flush=True)

    for nd in sizes:
        mesh = make_mesh(num_devices=nd)
        if "flat" in partitions and (args.flat_max is None
                                     or nd <= args.flat_max):
            sp = build_stacked(problem, dtype=jnp.float32, pad_multiple=nd,
                               offline="device")
            sp = shard_problem(sp, mesh)
            z0 = shard_variables(sp.zero_primal(), mesh)
            z0 = z0._replace(x=z0.x.at[0].set(jnp.asarray(x0, sp.dtype)))
            eta0 = shard_variables(sp.zero_dual(), mesh)
            run = jax.jit(partial(_run_cp, **loop))
            lower_args = (sp, tuple(z0), tuple(eta0),
                          jnp.asarray(x0, sp.dtype),
                          jnp.asarray(0.01, sp.dtype),
                          jnp.asarray(0.01, sp.dtype),
                          jnp.asarray(0.0, sp.dtype))
            report("flat", nd, run, lower_args, sp.dtype)
        if "subtree" in partitions and nd > 1:
            stp = build_subtree_problem(problem, mesh, dtype=jnp.float32,
                                        offline="device")
            z0 = stp.zero_primal_global_layout()
            z0.x[::stp.l_np] = np.asarray(x0, z0.x.dtype)
            eta0 = stp.zero_dual_global_layout()
            body = partial(_run_cp, log_every=None, adaptive=False,
                           relax=1.0, **loop)
            run = jax.jit(jax.shard_map(
                body, mesh=mesh,
                in_specs=(stp.in_spec, stp._primal_spec(), stp._dual_spec(),
                          P(), P(), P(), P()),
                out_specs=(Primal(*stp._primal_spec()),
                           Dual(*stp._dual_spec()), P(), P(), P()),
                check_vma=False))
            dt = stp.sp.dtype
            lower_args = (stp.sp, tuple(z0), tuple(eta0),
                          jnp.asarray(np.asarray(x0), dt),
                          jnp.asarray(0.01, dt), jnp.asarray(0.01, dt),
                          jnp.asarray(0.0, dt))
            report("subtree", nd, run, lower_args, dt)


if __name__ == "__main__":
    main()
