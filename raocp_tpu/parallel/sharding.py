"""Multi-device scaling: shard the node axis over a jax.sharding.Mesh.

The reference is single-process/single-threaded (SURVEY §2: no parallelism
of any kind); this module is the capability it lacks. Strategy:

* Every stacked array whose leading dimension is a node count (all-node,
  nonleaf, or leaf) is sharded along that axis over a 1-D ``nodes`` mesh
  axis; scalars and small replicated tables stay replicated.
* The solver's batched kernels are written as *global* array programs, so
  under jit GSPMD partitions them automatically: elementwise/batched-matmul
  node ops stay local, ancestor/child gathers at shard frontiers and the
  residual max-norms lower to collectives (all-gather / all-reduce).
* Trees are stage-major, so an equal split of the node axis puts whole
  subtrees on one device once the stage width exceeds the device count —
  frontier traffic is the (small) root-side spine, as planned in SURVEY §7.8.

Use :func:`shard_problem` on a :class:`StackedProblem` (and optionally
:func:`shard_variables` on primal/dual pytrees); then call the normal
solver entry points — jit picks the shardings up from the inputs.
"""

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from raocp_tpu.core.stacked import StackedProblem
from raocp_tpu.core.variables import Dual, Primal

__all__ = ["make_mesh", "node_sharding", "shard_problem", "shard_variables"]

AXIS = "nodes"

# stacked-problem fields whose leading axis is a node count (the dense
# offline stacks A/B/P/Rinv/K/Abar/sumAPB are optional — None unless some
# stage needs the fallback sweep paths or keep_dense was requested)
_NODE_SHARDED_FIELDS = (
    "anc", "child_idx", "child_mask", "child_rank", "nz_mask",
    "A", "B",
    "b_pad", "y_mask", "risk_free_rows", "risk_zero_rows",
    "nl_lo", "nl_hi", "nl_active", "nl_ball_c", "nl_ball_r",
    "l_lo", "l_hi", "l_active", "l_ball_c", "l_ball_r",
    "P", "Rinv", "K", "Abar", "sumAPB", "Pi", "riccati_cls",
)
# small shared matrices (optional fields may be None)
_OPTIONAL_REPLICATED_FIELDS = ("nl_G", "l_G")
# optional node-leading arrays (None unless some node's risk uses them)
_OPTIONAL_NODE_SHARDED_FIELDS = ("risk_soc_rows", "risk_soc_tail")
# mode-grouped matrix stacks: the small mode table is replicated, the
# per-node mode index (or dense stack) is sharded
_MODAL_FIELDS = ("sqrtQ", "sqrtR", "sqrtP", "Am", "Bm", "ABm", "QRm")
_REPLICATED_FIELDS = ("ab_fwd", "ab_bwd", "qr_fwd", "qr_bwd",
                      "k_s", "rinv_s", "sumapb_s",
                      "k_ms", "rinv_ms", "sumapb_ms")


def make_mesh(devices: Optional[Sequence] = None,
              num_devices: Optional[int] = None) -> Mesh:
    """A 1-D mesh over the ``nodes`` axis (defaults to all devices)."""
    if devices is None:
        devices = jax.devices()
        if num_devices is not None:
            devices = devices[:num_devices]
    return Mesh(np.asarray(devices), (AXIS,))


def node_sharding(mesh: Mesh, ndim: int) -> NamedSharding:
    """Shard dim 0 over the mesh; replicate the rest."""
    return NamedSharding(mesh, P(AXIS, *([None] * (ndim - 1))))


def _replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_problem(sp: StackedProblem, mesh: Mesh) -> StackedProblem:
    """Place a stacked problem on a mesh with the node axis sharded."""
    import dataclasses

    updates = {}
    for name in _NODE_SHARDED_FIELDS:
        arr = getattr(sp, name)
        if arr is None:                 # optional dense offline stacks
            continue
        updates[name] = jax.device_put(arr, node_sharding(mesh, arr.ndim))
    for name in _MODAL_FIELDS:
        mm = getattr(sp, name)
        if mm is None:                  # optional fused stacks (QRm)
            continue
        updates[name] = dataclasses.replace(
            mm,
            dense_m=None if mm.dense_m is None else jax.device_put(
                mm.dense_m, node_sharding(mesh, mm.dense_m.ndim)),
            modes=None if mm.modes is None else jax.device_put(
                mm.modes, _replicated(mesh)),
            idx=None if mm.idx is None else jax.device_put(
                mm.idx, node_sharding(mesh, 1)),
        )
    for name in _REPLICATED_FIELDS:
        updates[name] = jax.device_put(getattr(sp, name), _replicated(mesh))
    for name in _OPTIONAL_REPLICATED_FIELDS:
        arr = getattr(sp, name)
        if arr is not None:
            updates[name] = jax.device_put(arr, _replicated(mesh))
    for name in _OPTIONAL_NODE_SHARDED_FIELDS:
        arr = getattr(sp, name)
        if arr is not None:
            updates[name] = jax.device_put(arr, node_sharding(mesh, arr.ndim))
    return dataclasses.replace(sp, **updates)


def shard_variables(tree, mesh: Mesh):
    """Place a Primal/Dual (or any node-leading pytree) on a mesh."""
    return jax.tree_util.tree_map(
        lambda arr: jax.device_put(arr, node_sharding(mesh, arr.ndim)), tree)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> int:
    """Initialise multi-host JAX (the communication backend the reference
    lacks — SURVEY §5: no NCCL/MPI).

    Thin wrapper over ``jax.distributed.initialize``: pass the coordinator
    address, process count and process id (nothing discovers them on a GPU
    cluster). After this, :func:`make_mesh` over ``jax.devices()`` spans
    every host's devices and the jitted solver programs run SPMD with
    GSPMD-inserted collectives. Returns the global device count.
    No-op if the distributed runtime is already initialised.
    """
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes, process_id=process_id)
    except RuntimeError as e:           # already initialised
        if "already" not in str(e):
            raise
    return len(jax.devices())
