#!/usr/bin/env python
"""1->N HOST scaling proxy: P single-core PROCESSES joined by
jax.distributed, each owning one virtual CPU device pinned to its own
physical core (cross-process collectives ride Gloo — the localhost
analogue of DCN on a pod).

The in-process virtual-device sweep (bench_scaling.py) shares one XLA:CPU
runtime between all "devices", so its numbers conflate sharding quality
with the host runtime's thread scheduling (intra-op Eigen threads fight
the inter-device threads for the same cores). This harness emulates the
multi-host execution model faithfully instead:

* one process per "host", pinned to ONE core (sched_setaffinity),
* single-threaded XLA per process (--xla_cpu_multi_thread_eigen=false),
* the replicated-spine subtree partition over the GLOBAL mesh, exactly as
  a real multi-host run would use it,
* baseline = the partition-free single-device program in one process on
  one core (what a real 1-host run would execute).

Efficiency = ips(P processes on P cores) / (P x ips(1 process on 1 core)).
Prints one JSON line per P.
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker(args) -> None:
    if args.pin:
        os.sched_setaffinity(0, {args.pid % os.cpu_count()})
    flags = "--xla_force_host_platform_device_count=1"
    if not args.eigen_threads:
        flags += " --xla_cpu_multi_thread_eigen=false"
    os.environ["XLA_FLAGS"] = flags

    import jax

    jax.config.update("jax_platforms", "cpu")
    from raocp_tpu.utils.compilation import enable_compile_cache

    enable_compile_cache()

    import jax.numpy as jnp
    import numpy as np

    from raocp_tpu.models import random_network_problem

    problem, x0 = random_network_problem(
        num_states=args.num_states, num_inputs=args.num_states // 2,
        num_modes=3, num_stages=args.num_stages,
        stopping_time=args.num_stages)
    loop = dict(max_iters=args.iters, check_every=25, unroll=25)

    if args.nprocs == 1:
        from raocp_tpu.core.stacked import build_stacked
        from raocp_tpu.solver import _run_cp

        sp = build_stacked(problem, dtype=jnp.float32, offline="device")
        z0 = sp.zero_primal(xp=np)
        z0.x[0] = np.asarray(x0, z0.x.dtype)
        eta0 = sp.zero_dual(xp=np)

        def run():
            out = _run_cp(sp, tuple(z0), tuple(eta0),
                          jnp.asarray(x0, sp.dtype),
                          jnp.asarray(0.01, sp.dtype),
                          jnp.asarray(0.01, sp.dtype),
                          jnp.asarray(0.0, sp.dtype), **loop)
            jax.block_until_ready(out)
            return int(out[2])
    else:
        from raocp_tpu.parallel import initialize_distributed, make_mesh
        from raocp_tpu.parallel.subtree import build_subtree_problem

        n = initialize_distributed(
            coordinator_address=f"127.0.0.1:{args.port}",
            num_processes=args.nprocs, process_id=args.pid)
        assert n == args.nprocs, (n, args.nprocs)
        mesh = make_mesh()
        stp = build_subtree_problem(problem, mesh, dtype=jnp.float32,
                                    offline="device")
        z0 = stp.zero_primal_global_layout()
        z0.x[::stp.l_np] = np.asarray(x0, z0.x.dtype)
        eta0 = stp.zero_dual_global_layout()
        dt = stp.sp.dtype

        def run():
            out = stp.run_cp(z0, eta0, jnp.asarray(np.asarray(x0), dt),
                             jnp.asarray(0.01, dt), jnp.asarray(0.01, dt),
                             jnp.asarray(0.0, dt), args.iters,
                             check_every=25, unroll=25)
            jax.block_until_ready(out)
            return int(np.asarray(out[2]))

    run()                                    # compile + warm caches
    tic = time.perf_counter()
    it = run()
    dt_s = time.perf_counter() - tic
    print(json.dumps({"pid": args.pid,
                      "iters_per_s": round(it / dt_s, 2)}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=500)
    ap.add_argument("--num-stages", type=int, default=8)
    ap.add_argument("--num-states", type=int, default=50)
    ap.add_argument("--procs", default=None,
                    help="comma list of process counts (default: 1,2,..,"
                    "up to the core count)")
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--pid", type=int, default=0)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--nprocs", type=int, default=1)
    ap.add_argument("--no-pin", dest="pin", action="store_false",
                    help="skip per-process core pinning (lets collective "
                    "progress threads escape the compute core)")
    ap.add_argument("--eigen-threads", action="store_true",
                    help="keep XLA:CPU intra-op Eigen threading on")
    args = ap.parse_args()

    if args.worker:
        worker(args)
        return

    ncores = os.cpu_count()
    if args.procs:
        sizes = [int(v) for v in args.procs.split(",")]
    else:
        sizes = [1]
        while sizes[-1] * 2 <= ncores:
            sizes.append(sizes[-1] * 2)

    base = None          # (mean_ips, P) of the first row — speedup and
    base_procs = None    # efficiency are normalised to ITS process count
    for P in sizes:
        port = _free_port()
        cmd = [sys.executable, os.path.abspath(__file__), "--worker",
               "--iters", str(args.iters),
               "--num-stages", str(args.num_stages),
               "--num-states", str(args.num_states),
               "--port", str(port), "--nprocs", str(P)]
        if not args.pin:
            cmd.append("--no-pin")
        if args.eigen_threads:
            cmd.append("--eigen-threads")
        env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
        procs = [subprocess.Popen(cmd + ["--pid", str(pid)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True,
                                  env=env)
                 for pid in range(P)]
        ips = []
        for p in procs:
            out, err = p.communicate(timeout=3600)
            if p.returncode != 0:
                for q in procs:
                    q.kill()
                raise RuntimeError(f"worker failed:\n{err[-4000:]}")
            ips.append(json.loads(out.strip().splitlines()[-1])
                       ["iters_per_s"])
        mean_ips = sum(ips) / len(ips)
        if base is None:
            base, base_procs = mean_ips, P
        print(json.dumps({
            "mode": "multiprocess-gloo",
            "partition": "subtree" if P > 1 else "none",
            "processes": P,
            "pinned": args.pin, "eigen_threads": args.eigen_threads,
            "num_stages": args.num_stages, "num_states": args.num_states,
            "iters_per_s": round(mean_ips, 2),
            "baseline_processes": base_procs,
            "speedup": round(mean_ips / base, 3),
            # per-process efficiency vs the baseline row's process count —
            # correct even when --procs omits P=1
            "efficiency": round(mean_ips / base * base_procs / P, 3),
        }), flush=True)


if __name__ == "__main__":
    main()
