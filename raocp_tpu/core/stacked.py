"""Stacked, padded, device-ready form of a RAOCP.

This module turns the per-node object lists of :class:`raocp_tpu.core.spec.RAOCP`
into the arrays the batched device kernels consume, and runs the offline phase:

* the backward Riccati-like factorisation used by the dynamics projection
  (parity: reference ``cache.py:207-233``), computed stage-batched in numpy;
* the kernel-projection operators: the reference solves a null-space least
  squares per node per iteration (``cache.py:290-317``); here the orthogonal
  projector ``Pi = I - M'(MM')^{-1}M`` onto ker(M) is precomputed once —
  mathematically identical, and online it is a single batched matmul. Since
  the kernel constraint matrix ``M = [[E', -I, -I], [F', 0, 0]]``
  (``cache.py:239-241``) depends only on the risk's (E, F) — for AVaR only on
  (alpha, num_children) — projectors are computed once per distinct matrix
  and broadcast to nodes.

Padded layouts (d = max branching; Y = max rows of any node's risk matrix E,
e.g. 2d+1 for AVaR, 3d+2 for TotalVariation; D = Y + 2d):

* y / e1 / b / E rows for a node whose risk has R rows sit in slots [0, R)
  in natural (E-row) order; slots beyond R are zero. The dual-cone
  projection is driven by per-node row-kind masks (``risk_free_rows`` /
  ``risk_zero_rows``) built from the risk's cone, so any Cartesian product
  of NnOC / Zero / Real components batches branch-free.
* kernel vector v = [y (Y slots) | tau_children (d slots) | s_children
  (d slots)].
"""

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from raocp_tpu.core.modal import ModalMatrix, from_dense_stack
from raocp_tpu.core.spec import RAOCP
from raocp_tpu.core.variables import Primal, Dual

__all__ = ["StackedProblem", "build_stacked"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class StackedProblem:
    """All device arrays + static metadata of one RAOCP instance."""

    # -- static metadata (hashable; part of the jit cache key) --------------
    n: int = dataclasses.field(metadata=dict(static=True))
    m: int = dataclasses.field(metadata=dict(static=True))
    num_nodes: int = dataclasses.field(metadata=dict(static=True))
    num_nonleaf: int = dataclasses.field(metadata=dict(static=True))
    num_leaf: int = dataclasses.field(metadata=dict(static=True))
    d_max: int = dataclasses.field(metadata=dict(static=True))
    num_stages: int = dataclasses.field(metadata=dict(static=True))
    stage_start: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    # per nonleaf stage: the uniform child count, or None when branching is
    # ragged within that stage. Uniform stages (dense transition matrices)
    # take gather-free reshape/repeat paths in the operators and sweeps.
    stage_child: Tuple[Optional[int], ...] = dataclasses.field(
        metadata=dict(static=True))
    # padded row counts of the three node spaces (>= the real counts; ghost
    # rows are engineered to stay zero through every op, so arrays can be
    # sharded evenly over a device mesh)
    np_pad: int = dataclasses.field(metadata=dict(static=True))
    nl_pad: int = dataclasses.field(metadata=dict(static=True))
    lf_pad: int = dataclasses.field(metadata=dict(static=True))
    # width of the padded y / e1 / b row space: the max row count of any
    # node's risk matrix E (2d+1 for AVaR, 3d+2 for TotalVariation, ...)
    y_dim: int = dataclasses.field(metadata=dict(static=True))

    # -- index plans ---------------------------------------------------------
    anc: jax.Array          # [num_nodes] parent (anc[0] = 0)
    child_idx: jax.Array    # [num_nonleaf, d_max] child node ids, 0-padded
    child_mask: jax.Array   # [num_nonleaf, d_max] 1.0 where valid
    child_rank: jax.Array   # [num_nodes] rank among siblings (root 0)
    nz_mask: jax.Array      # [num_nodes] 0.0 at root, 1.0 elsewhere
    # per-node risk-cone row kinds ([num_nonleaf, Y] bool): rows whose DUAL
    # projection is the identity (Zero-cone rows) / the zero map (Real-cone
    # rows); all other real rows are NnOC (max(0, .)); padded slots are
    # neither (max(0, 0) = 0 keeps them zero)
    risk_free_rows: jax.Array
    risk_zero_rows: jax.Array
    # SOC block row masks ([num_nonleaf, Y] bool, or None when no node's
    # risk cone has an SOC block): member rows / the radial row of each
    # node's (single) SecondOrderCone component — the dual projection
    # treats those rows as one joint cone per node
    risk_soc_rows: Optional[jax.Array]
    risk_soc_tail: Optional[jax.Array]

    # -- problem data ----------------------------------------------------------
    A: Optional[jax.Array]  # [num_nodes, n, n]; row 0 zero (dense; optional —
    B: Optional[jax.Array]  # [num_nodes, n, m]  the kernels use Am/Bm/ABm)
    Am: ModalMatrix         # mode-grouped A (mode 0 = zero; root/pad rows)
    Bm: ModalMatrix         # mode-grouped B
    ABm: ModalMatrix        # mode-grouped [A | B] ([M, n, n+m]) — one fused
                            # matvec/rmatvec where A and B act on the same
                            # node (DP sweeps): halves the op count
    sqrtQ: ModalMatrix      # [num_nodes, n, n]; row 0 zero (mode-grouped)
    sqrtR: ModalMatrix      # [num_nodes, m, m]; row 0 zero (mode-grouped)
    # mode-grouped blockdiag(sqrtQ, sqrtR) ([M, n+m, n+m]) for the fused
    # [x; u] paths of L/L'; None when the joint mode count is too large
    QRm: Optional[ModalMatrix]
    sqrtP: ModalMatrix      # [num_leaf, n, n] (mode-grouped)
    b_pad: jax.Array        # [num_nonleaf, Y] risk vector b (padded layout)
    y_mask: jax.Array       # [num_nonleaf, Y] 1.0 on real y coordinates
    nl_lo: jax.Array        # [num_nonleaf, n+m] box lower bound (-inf where free)
    nl_hi: jax.Array        # [num_nonleaf, n+m]
    nl_active: jax.Array    # [num_nonleaf] 1.0 where the constraint is active
    nl_ball_c: jax.Array    # [num_nonleaf, n+m] Ball centers (0 where not Ball)
    nl_ball_r: jax.Array    # [num_nonleaf] Ball radii (+inf where not Ball)
    l_lo: jax.Array         # [num_leaf, n]
    l_hi: jax.Array         # [num_leaf, n]
    l_active: jax.Array     # [num_leaf]
    l_ball_c: jax.Array     # [num_leaf, n]
    l_ball_r: jax.Array     # [num_leaf]
    # shared Polyhedral row matrices: when set, the constraint dual segment
    # (e7 / e14) carries the image rows G [x; u] (G x on leaves) and the
    # row-bound tables above have G.shape[0] columns; None = the
    # identity-structured Rectangle/Ball rows
    nl_G: Optional[jax.Array]   # [nl_rows, n+m] or None
    l_G: Optional[jax.Array]    # [l_rows, n] or None

    # -- stage-stacked mode blocks -------------------------------------------
    # In a fully-branching Markov stage every parent's children carry the
    # SAME mode sequence (child of sibling-rank r has mode pattern[r]), so
    # the per-stage "modal matvec + mode select + child reduction" collapses
    # into ONE dense matmul with a stacked mode-block matrix:
    #   children-from-parents (matvec):  [W, F] @ [F, c*out]  -> [W*c, out]
    #   sum-over-children (rmatvec):     [W, c*in] @ [c*in, out]
    # One entry per nonleaf stage; None where the stage has no uniform mode
    # pattern (ragged branching or post-stopping chains) — those stages use
    # the gather/select paths.
    ab_fwd: Tuple[Optional[jax.Array], ...]   # [F, c, n]   x_children
    ab_bwd: Tuple[Optional[jax.Array], ...]   # [c, n, F]   sum A'q | B'q
    qr_fwd: Tuple[Optional[jax.Array], ...]   # [F, c, F]   e3/e4 rows
    qr_bwd: Tuple[Optional[jax.Array], ...]   # [c, F, F]   sum Q'e3 | R'e4
    # Stage-constant Riccati tables: when every stage from k to the leaves
    # has a uniform mode pattern, the backward recursion produces the SAME
    # (K, Rinv, sumAPB) for every node of stage k — the [W, a, b] batched
    # GEMVs of the DP sweeps then become [W, b] @ [b, a] dense matmuls
    # against one tiny per-stage matrix (and stop reading the dense stacks
    # from HBM every iteration). None where not stage-constant.
    k_s: Tuple[Optional[jax.Array], ...]       # [m, n] per nonleaf stage
    rinv_s: Tuple[Optional[jax.Array], ...]    # [m, m]
    sumapb_s: Tuple[Optional[jax.Array], ...]  # [n, m]

    # -- offline factorisations --------------------------------------------------
    # The dense per-node stacks are OPTIONAL: the solve loop reads them only
    # on stages without stage-constant tables (k_s/rinv_s/sumapb_s), and
    # A/B/P/Abar never (the sweeps use the mode-grouped/stage forms). On a
    # fully stage-constant tree they are ~5 x [N, n, n]-class arrays of dead
    # HBM (~3.5 GB at 1e5 nodes / 50 states f32), so build_stacked
    # materialises each stack only when the solve needs it (or
    # ``keep_dense=True`` forces them, e.g. for offline-parity tests).
    P: Optional[jax.Array]       # [num_nodes, n, n] Riccati-like matrices
    Rinv: Optional[jax.Array]    # [num_nonleaf, m, m] (I + sum B'PB)^{-1}
    K: Optional[jax.Array]       # [num_nonleaf, m, n] feedback gains
    Abar: Optional[jax.Array]    # [num_nodes, n, n] A + B K_parent; row 0 zero
    sumAPB: Optional[jax.Array]  # [num_nonleaf, n, m] sum_children Abar'P B
    Pi: jax.Array                # [num_nonleaf, D, D] kernel projectors (padded)

    # -- subtree-partition (SPMD) metadata -----------------------------------
    # Set only by parallel.subtree.build_subtree_problem, for StackedProblems
    # whose arrays are the PER-DEVICE local blocks of a replicated-spine
    # subtree partition (SURVEY §7(c)): stages [0, frontier) are replicated
    # on every device, stages >= frontier are split evenly (each device owns
    # complete subtrees; uneven stages carry interior ghost rows that stay
    # identically zero). The ops then run shard-local except at the ONE
    # frontier crossing, where the child reductions complete with a psum
    # over ``spmd_axis`` (ops.operator._frontier_psum).
    frontier: Optional[int] = dataclasses.field(
        default=None, metadata=dict(static=True))
    spmd_axis: Optional[str] = dataclasses.field(
        default=None, metadata=dict(static=True))
    spmd_ndev: Optional[int] = dataclasses.field(
        default=None, metadata=dict(static=True))
    # 1.0 on real rows / 0.0 on interior ghost rows of the all-node space
    # (None = no interior ghosts: real rows are a prefix, masks derive from
    # the static counts)
    node_mask: Optional[jax.Array] = None
    # 1.0 on real leaf rows (None = arange(lf_pad) < num_leaf)
    lf_half_mask: Optional[jax.Array] = None

    # -- mode-constant Riccati tables (post-stopping chain stages) -----------
    # Each chain node's single-child subtree is a chain of one Markov mode,
    # so (K, Rinv, sumAPB) take only num_modes distinct values per stage,
    # indexed by the node's chain class (``riccati_cls``, the mode of its
    # child). Tables are [M, ...] replicated arrays; the sweeps apply them
    # all-modes-then-select (ModalMatrix style). This removes the dense
    # [N, n, n]-class offline stacks for stopped Markov trees — the
    # reference's standard shape — where the stage-constant path alone
    # cannot (the dense device factorisation at 1e5 nodes x 100 states
    # needs [N, n, n]-class stacks of ~10 GB). None on stages covered
    # by k_s or the dense fallback; empty tuple on pre-feature instances.
    k_ms: Tuple[Optional[jax.Array], ...] = ()       # [M, m, n]
    rinv_ms: Tuple[Optional[jax.Array], ...] = ()    # [M, m, m]
    sumapb_ms: Tuple[Optional[jax.Array], ...] = ()  # [M, n, m]
    riccati_cls: Optional[jax.Array] = None          # [np_pad] int32

    # -- convenience -----------------------------------------------------------

    @property
    def Y(self) -> int:
        return self.y_dim

    @property
    def D(self) -> int:
        return self.y_dim + 2 * self.d_max

    @property
    def dtype(self):
        return self.b_pad.dtype

    @property
    def nl_rows(self) -> int:
        """Columns of the nonleaf constraint dual segment e7."""
        return self.nl_lo.shape[1]

    @property
    def l_rows(self) -> int:
        """Columns of the leaf constraint dual segment e14."""
        return self.l_lo.shape[1]

    def zero_primal(self, xp=jnp) -> Primal:
        """Zero primal pytree. ``xp=numpy`` builds host arrays — use it
        outside jit so cold-start setup costs no eager device
        dispatches."""
        dt = self.dtype
        return Primal(
            x=xp.zeros((self.np_pad, self.n), dt),
            u=xp.zeros((self.nl_pad, self.m), dt),
            y=xp.zeros((self.nl_pad, self.Y), dt),
            tau=xp.zeros((self.np_pad,), dt),
            s=xp.zeros((self.np_pad,), dt),
        )

    def zero_dual(self, xp=jnp) -> Dual:
        """Zero dual pytree (``xp`` as in :meth:`zero_primal`)."""
        dt = self.dtype
        return Dual(
            e1=xp.zeros((self.nl_pad, self.Y), dt),
            e2=xp.zeros((self.nl_pad,), dt),
            e3=xp.zeros((self.np_pad, self.n), dt),
            e4=xp.zeros((self.np_pad, self.m), dt),
            e5=xp.zeros((self.np_pad,), dt),
            e6=xp.zeros((self.np_pad,), dt),
            e7=xp.zeros((self.nl_pad, self.nl_rows), dt),
            e11=xp.zeros((self.lf_pad, self.n), dt),
            e12=xp.zeros((self.lf_pad,), dt),
            e13=xp.zeros((self.lf_pad,), dt),
            e14=xp.zeros((self.lf_pad, self.l_rows), dt),
        )


def _constraint_tables(cons, width: int):
    """Constraint-row data for one node class (nonleaf or leaf).

    Returns ``(G, lo, hi, active, ball_c, ball_r)`` where ``G`` is the
    shared Polyhedral row matrix (or None for identity-structured
    Rectangle/Ball rows) and the per-node tables have ``G.shape[0]``
    (or ``width``) columns.
    """
    from raocp_tpu.core.constraints.sets import Ball, Polyhedral

    polys = [c for c in cons if isinstance(c, Polyhedral)]
    G = None
    rows = width
    if polys:
        first = polys[0]
        for p in polys:
            if p is not first and not np.array_equal(p.matrix, first.matrix):
                raise ValueError(
                    "all Polyhedral constraints of one node class must "
                    "share a single row matrix (the dual segment has one "
                    "width); use per-node bounds for node-varying sets")
        if any(c.is_active and not isinstance(c, Polyhedral) for c in cons):
            raise ValueError(
                "Polyhedral constraints cannot be mixed with active "
                "Rectangle/Ball constraints within one node class")
        G = np.asarray(first.matrix, dtype=np.float64)
        rows = first.num_rows
    count = len(cons)
    lo = np.full((count, rows), -np.inf)
    hi = np.full((count, rows), np.inf)
    active = np.zeros(count)
    ball_c = np.zeros((count, rows))
    ball_r = np.full(count, np.inf)
    for i, con in enumerate(cons):
        if con.is_active:
            active[i] = 1.0
            if isinstance(con, Ball):
                ball_c[i] = con.center_for_size(rows)
                ball_r[i] = con.radius
            else:
                lo[i] = con.min
                hi[i] = con.max
    return G, lo, hi, active, ball_c, ball_r


def _offline_riccati(spec: RAOCP, n: int, m: int):
    """Backward stage-batched Riccati-like factorisation.

    Parity: reference ``cache.py:207-233``. For each nonleaf node i (children
    ch(i)): R~_i = I + sum_j B_j'P_jB_j, K_i = -R~_i^{-1} sum_j B_j'P_jA_j,
    Abar_j = A_j + B_jK_i, P_i = I + K_i'K_i + sum_j Abar_j'P_jAbar_j.
    Additionally precomputes sumAPB_i = sum_j Abar_j'P_jB_j, used by the
    online projection.
    """
    tree = spec.tree
    N = tree.num_nodes
    NL = tree.num_nonleaf_nodes
    ns = tree.num_stages
    ss = tree.stage_start

    A = np.zeros((N, n, n))
    B = np.zeros((N, n, m))
    for j in range(1, N):
        A[j] = spec.state_dynamics_at_node(j)
        B[j] = spec.control_dynamics_at_node(j)

    P = np.zeros((N, n, n))
    P[NL:] = np.eye(n)
    K = np.zeros((NL, m, n))
    Rinv = np.zeros((NL, m, m))
    Abar = np.zeros((N, n, n))
    sumAPB = np.zeros((NL, n, m))

    # reduceat segment boundaries: children of stage-k nodes are contiguous
    cf = tree.child_first
    for k in range(ns - 2, -1, -1):
        a, b = ss[k], ss[k + 1]          # nonleaf nodes of stage k
        a2, b2 = ss[k + 1], ss[k + 2]    # their children (all of stage k+1)
        Ac, Bc, Pc = A[a2:b2], B[a2:b2], P[a2:b2]
        seg = cf[a:b] - a2               # start of each parent's child block
        PB = Pc @ Bc                                       # [W2, n, m]
        BtPB = np.einsum("jba,jbc->jac", Bc, PB)           # [W2, m, m]
        BtPA = np.einsum("jba,jbc->jac", Bc, Pc @ Ac)      # [W2, m, n]
        sum_r = np.add.reduceat(BtPB, seg, axis=0)
        sum_k = np.add.reduceat(BtPA, seg, axis=0)
        r_tilde = np.eye(m) + sum_r
        Rinv[a:b] = np.linalg.inv(r_tilde)
        K[a:b] = np.linalg.solve(r_tilde, -sum_k)
        # expand K to children: parent of child j in [a2,b2) is anc[j]
        Kc = K[tree.ancestors[a2:b2]]
        Abar[a2:b2] = Ac + Bc @ Kc
        APB = np.einsum("jba,jbc->jac", Abar[a2:b2], PB)   # [W2, n, m]
        AtPA = np.einsum("jba,jbc,jcd->jad", Abar[a2:b2], Pc, Abar[a2:b2])
        sumAPB[a:b] = np.add.reduceat(APB, seg, axis=0)
        P[a:b] = (np.eye(n) + np.einsum("iba,ibc->iac", K[a:b], K[a:b])
                  + np.add.reduceat(AtPA, seg, axis=0))

    return A, B, P, Rinv, K, Abar, sumAPB


def _dedup_dynamics(spec: RAOCP, n: int, m: int):
    """Distinct (A, B) pairs + per-node mode index (mode 0 = zero pair for
    the root / padding rows). Host-side, O(num_nodes) hashing."""
    tree = spec.tree
    N = tree.num_nodes
    modes_a = [np.zeros((n, n))]
    modes_b = [np.zeros((n, m))]
    seen = {}
    idx = np.zeros(N, dtype=np.int32)
    for j in range(1, N):
        a = spec.state_dynamics_at_node(j)
        b = spec.control_dynamics_at_node(j)
        key = id(a)            # Markovian specs share mode objects
        if key not in seen:
            bkey = (a.tobytes(), b.tobytes())
            if bkey in seen:
                seen[key] = seen[bkey]
            else:
                seen[key] = seen[bkey] = len(modes_a)
                modes_a.append(np.asarray(a, dtype=np.float64))
                modes_b.append(np.asarray(b, dtype=np.float64))
        idx[j] = seen[key]
    return np.stack(modes_a), np.stack(modes_b), idx


def _riccati_device(A, B, child_idx, child_mask, anc, stage_start,
                    num_nonleaf: int, nl_pad: int):
    """The same backward factorisation as :func:`_offline_riccati`, as one
    jitted device program over the dense padded stacks.

    Eliminates the dominant host->device transfer at scale (the [N, n, n]
    P/Abar/K/... stacks — hundreds of MB at 10^4 nodes, GBs at 10^5): only
    the per-mode dynamics and int32 index plans cross the wire; everything
    else is computed where it is consumed. Trace-time stage loop, static
    shapes, concatenate assembly (SPMD-safe, see ops/prox._set_rows).
    """
    ns = len(stage_start) - 1
    ss = stage_start
    np_pad, n = A.shape[0], A.shape[1]
    m = B.shape[2]
    dt = A.dtype
    NL = num_nonleaf

    def set_rows(buf, a, b, val):
        return jnp.concatenate([buf[:a], val, buf[b:]], axis=0)

    eye_n = jnp.eye(n, dtype=dt)
    eye_m = jnp.eye(m, dtype=dt)
    N = ss[ns]
    # leaves: P = I; nonleaf + padding rows overwritten / zero
    P = jnp.concatenate([
        jnp.zeros((NL, n, n), dt),
        jnp.broadcast_to(eye_n, (N - NL, n, n)),
        jnp.zeros((np_pad - N, n, n), dt)])
    K = jnp.zeros((nl_pad, m, n), dt)
    Rinv = jnp.zeros((nl_pad, m, m), dt)
    Abar = jnp.zeros((np_pad, n, n), dt)
    sumAPB = jnp.zeros((nl_pad, n, m), dt)

    for k in range(ns - 2, -1, -1):
        a, b = ss[k], ss[k + 1]
        a2, b2 = ss[k + 1], ss[k + 2]
        Ac, Bc, Pc = A[a2:b2], B[a2:b2], P[a2:b2]
        rel = jnp.clip(child_idx[a:b] - a2, 0, b2 - a2 - 1)
        mask = child_mask[a:b][..., None, None]
        PB = Pc @ Bc                                        # [W2, n, m]
        BtPB = jnp.einsum("jba,jbc->jac", Bc, PB)
        BtPA = jnp.einsum("jba,jbc->jac", Bc, Pc @ Ac)
        r_tilde = eye_m + jnp.sum(BtPB[rel] * mask, axis=1)
        sum_k = jnp.sum(BtPA[rel] * mask, axis=1)
        Rinv_k = jnp.linalg.inv(r_tilde)
        K_k = jnp.linalg.solve(r_tilde, -sum_k)
        Kc = K_k[anc[a2:b2] - a]
        Abar_c = Ac + Bc @ Kc
        APB = jnp.einsum("jba,jbc->jac", Abar_c, PB)
        AtPA = jnp.einsum("jba,jbc,jcd->jad", Abar_c, Pc, Abar_c)
        P_k = (eye_n + jnp.einsum("iba,ibc->iac", K_k, K_k)
               + jnp.sum(AtPA[rel] * mask, axis=1))
        P = set_rows(P, a, b, P_k)
        K = set_rows(K, a, b, K_k)
        Rinv = set_rows(Rinv, a, b, Rinv_k)
        sumAPB = set_rows(sumAPB, a, b, jnp.sum(APB[rel] * mask, axis=1))
        Abar = set_rows(Abar, a2, b2, Abar_c)

    return P, Rinv, K, Abar, sumAPB


def _riccati_precision(fn):
    # full-float32 matmuls: a GPU's default TF32 products are far too
    # loose for the Riccati factorisation (see solver.py)
    import functools

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        import os
        prec = os.environ.get("RAOCP_TPU_MATMUL_PRECISION", "float32")
        with jax.default_matmul_precision(prec):
            return fn(*args, **kwargs)
    return wrapper


_riccati_device_jit = jax.jit(
    _riccati_precision(_riccati_device),
    static_argnames=("stage_start", "num_nonleaf", "nl_pad"))


def _offline_kernel_projectors(spec: RAOCP, d_max: int,
                               y_dim: int) -> np.ndarray:
    """Orthogonal projectors onto ker([[E', -I, -I], [F', 0, 0]]) in the
    padded [y | tau | s] layout (parity: reference ``cache.py:235-242``,
    with lstsq-per-iteration replaced by a precomputed projector)."""
    tree = spec.tree
    NL = tree.num_nonleaf_nodes
    Y = y_dim
    D = Y + 2 * d_max
    Pi = np.zeros((NL, D, D))
    cache = {}
    for i in range(NL):
        risk = spec.risk_at_node(i)
        E, F = risk.matrix_e, risk.matrix_f
        c = tree.child_count[i]
        key = (E.shape, E.tobytes(), F.shape, F.tobytes(), int(c))
        if key not in cache:
            eye = np.eye(c)
            zeros = np.zeros((F.shape[1], c))
            M = np.vstack((np.hstack((E.T, -eye, -eye)),
                           np.hstack((F.T, zeros, zeros))))
            # Pi_small = I - M'(MM')^+ M  (pinv guards rank deficiency;
            # equals the reference's null-space projector)
            MMt_inv = np.linalg.pinv(M @ M.T)
            Pi_small = np.eye(M.shape[1]) - M.T @ MMt_inv @ M
            # embed unpadded coords [y(R), tau(c), s(c)] into the padded
            # layout: y rows -> slots [0, R), tau_j -> Y+j, s_j -> Y+d+j
            R = E.shape[0]
            emb = np.concatenate((
                np.arange(R),
                Y + np.arange(c),
                Y + d_max + np.arange(c)))
            Pi_pad = np.zeros((D, D))
            Pi_pad[np.ix_(emb, emb)] = Pi_small
            cache[key] = Pi_pad
        Pi[i] = cache[key]
    return Pi


def _cone_row_kinds(cone, rows: int):
    """Row-kind codes of a risk cone: 0 = NnOC (dual: max(0, .)),
    1 = Zero (dual: identity), 2 = Real (dual: zero map), 3 = SOC member
    rows, 4 = the SOC radial (last) row. Any Cartesian product of NnOC /
    Zero / Real components plus AT MOST ONE SecondOrderCone block batches
    branch-free via per-row masks (the SOC block projects jointly, driven
    by the kind-3/kind-4 masks — see ops.cones.risk_dual_project)."""
    import raocp_tpu.core.constraints.cones as cones

    comps = cone.cones if isinstance(cone, cones.Cartesian) else [cone]
    kinds = []
    soc_seen = False
    for comp in comps:
        dim = comp.dimension
        if dim is None:
            raise ValueError("risk cone components must carry explicit "
                             "dimensions")
        if isinstance(comp, cones.NonnegativeOrthant):
            kinds.extend([0] * dim)
        elif isinstance(comp, cones.Zero):
            kinds.extend([1] * dim)
        elif isinstance(comp, cones.Real):
            kinds.extend([2] * dim)
        elif isinstance(comp, cones.SecondOrderCone):
            if soc_seen:
                raise NotImplementedError(
                    "a risk cone may contain at most one SecondOrderCone "
                    "block (one joint projection per node)")
            if dim < 2:
                raise ValueError("a SecondOrderCone block needs at least "
                                 "2 rows (members + radial)")
            soc_seen = True
            kinds.extend([3] * (dim - 1) + [4])
        else:
            raise NotImplementedError(
                "risk cones must be Cartesian products of "
                "NonnegativeOrthant / Zero / Real / SecondOrderCone "
                f"components; got {type(comp).__name__}")
    if len(kinds) != rows:
        raise ValueError(f"risk cone dimension {len(kinds)} does not match "
                         f"the {rows} rows of (E, b)")
    return kinds


def _fuse_block_diag(mq: ModalMatrix, mr: ModalMatrix,
                     dtype) -> Optional[ModalMatrix]:
    """Mode-grouped blockdiag(Q_j, R_j) from two mode-grouped stacks over
    the same node space. Joint modes come from unique (q, r) index pairs;
    returns None when either stack is dense or the joint mode count exceeds
    the modal limit (callers then use the unfused pair)."""
    from raocp_tpu.core.modal import MODAL_MAX_MODES

    if mq.modes is None or mr.modes is None:
        return None
    qi = np.asarray(mq.idx, dtype=np.int64)
    ri = np.asarray(mr.idx, dtype=np.int64)
    pairs = qi * mr.modes.shape[0] + ri
    uniq, inv = np.unique(pairs, return_inverse=True)
    if len(uniq) > MODAL_MAX_MODES:
        return None
    qm = np.asarray(mq.modes, dtype=np.float64)
    rm = np.asarray(mr.modes, dtype=np.float64)
    nq, nr = qm.shape[1], rm.shape[1]
    modes = np.zeros((len(uniq), nq + nr, nq + nr))
    for t, p in enumerate(uniq):
        a, b = divmod(int(p), rm.shape[0])
        modes[t, :nq, :nq] = qm[a]
        modes[t, nq:, nq:] = rm[b]
    return ModalMatrix(dense_m=None, modes=jnp.asarray(modes, dtype),
                       idx=jnp.asarray(inv.astype(np.int32)))


def _offline_riccati_stage(modes_a, modes_b, patterns):
    """Backward Riccati recursion for FULLY stage-constant trees: one tiny
    (n x n)-class computation per stage instead of one per node.

    Exactly the reference recursion (``cache.py:207-233``) specialised to
    the case where every parent of a stage sees children with the same mode
    sequence — all nodes of a stage then share (P, K, Rinv, sumAPB), and
    Abar is shared per (stage, sibling rank). Host numpy float64; at 1e5
    nodes this replaces a device program over [N, n, n] stacks with
    microseconds of work and a few-KB transfer.

    Returns per-stage lists (P_s[ns], K_s, Rinv_s, sumAPB_s, Abar_s) where
    Abar_s[k] is [c, n, n] for stage k's children.
    """
    n = modes_a.shape[1]
    m = modes_b.shape[2]
    ns_nl = len(patterns)
    P_s = [None] * (ns_nl + 1)
    P_s[ns_nl] = np.eye(n)
    K_s, Rinv_s, APB_s, Abar_s = ([None] * ns_nl for _ in range(4))
    for k in range(ns_nl - 1, -1, -1):
        pat = patterns[k]
        Pc = P_s[k + 1]
        A = modes_a[list(pat)]          # [c, n, n]
        B = modes_b[list(pat)]          # [c, n, m]
        PB = Pc @ B                     # [c, n, m]
        r_tilde = np.eye(m) + np.einsum("rba,rbc->ac", B, PB)
        sum_k = np.einsum("rba,rbc->ac", B, Pc @ A)
        Rinv_s[k] = np.linalg.inv(r_tilde)
        K = np.linalg.solve(r_tilde, -sum_k)
        Abar = A + B @ K
        K_s[k] = K
        Abar_s[k] = Abar
        APB_s[k] = np.einsum("rba,rbc->ac", Abar, PB)
        P_s[k] = (np.eye(n) + K.T @ K
                  + np.einsum("rba,bc,rcd->ad", Abar, Pc, Abar))
    return P_s, K_s, Rinv_s, APB_s, Abar_s


def _riccati_plan(w_idx: np.ndarray, stage_start, stage_child, ab_pat):
    """Backward classification of nonleaf stages for table-based Riccati:

    * ``("const", pattern)`` — uniform child-mode pattern AND a
      table-compatible child stage: every node of the stage shares one
      (P, K, Rinv, sumAPB).
    * ``("modal", cls)`` — chain stage (uniform single child) whose
      per-node subtree is classed by the child's mode (a stopped Markov
      chain: the chain copies the mode forever), so the tables take at
      most num_modes distinct values, indexed by ``cls``.
    * ``None`` — dense fallback; table validity is a suffix property, so
      every stage above a None is None too.
    """
    ns_nl = len(stage_child)
    plan = [None] * ns_nl
    below_kind, below_cls = "I", None
    for k in range(ns_nl - 1, -1, -1):
        a2, b2 = stage_start[k + 1], stage_start[k + 2]
        child_modes = w_idx[a2:b2]
        # a modal child stage is consumable iff each child's class equals
        # its own mode (true exactly when the chain repeats the mode)
        ok_below = below_kind != "modal" or bool(
            np.array_equal(below_cls, child_modes))
        if ab_pat[k] is not None and ok_below:
            plan[k] = ("const", ab_pat[k])
            below_kind, below_cls = "const", None
        elif stage_child[k] == 1 and ok_below:
            cls = child_modes.astype(np.int32)
            plan[k] = ("modal", cls)
            below_kind, below_cls = "modal", cls
        else:
            break
    return plan


def _offline_riccati_tables(modes_a, modes_b, plan):
    """Backward Riccati recursion over the table plan: one tiny matrix per
    ("const") stage, one [num_modes, ...] table per ("modal") chain stage.
    Host numpy float64; replaces the [N, n, n]-class dense stacks for any
    stopped Markov tree. Returns per-stage lists
    (K_s, Rinv_s, APB_s, K_ms, Rinv_ms, APB_ms), None where not that kind.
    """
    n, m = modes_a.shape[1], modes_b.shape[2]
    M = modes_a.shape[0]
    ns_nl = len(plan)
    eye_n, eye_m = np.eye(n), np.eye(m)
    K_s, Rinv_s, APB_s, K_ms, Rinv_ms, APB_ms = (
        [None] * ns_nl for _ in range(6))
    P_rep = ("I", eye_n)
    for k in range(ns_nl - 1, -1, -1):
        if plan[k] is None:
            break
        kind, data = plan[k]
        if kind == "const":
            pat = list(data)
            A = modes_a[pat]
            B = modes_b[pat]
            if P_rep[0] == "modal":
                Pc = P_rep[1][pat]                       # [c, n, n]
            else:
                Pc = np.broadcast_to(P_rep[1], (len(pat), n, n))
            PB = Pc @ B
            r_tilde = eye_m + np.einsum("rba,rbc->ac", B, PB)
            sum_k = np.einsum("rba,rbc->ac", B, Pc @ A)
            Rinv_s[k] = np.linalg.inv(r_tilde)
            K = np.linalg.solve(r_tilde, -sum_k)
            Abar = A + B @ K
            K_s[k] = K
            APB_s[k] = np.einsum("rba,rbc->ac", Abar, PB)
            P_rep = ("const",
                     eye_n + K.T @ K
                     + np.einsum("rba,rbc,rcd->ad", Abar, Pc, Abar))
        else:                                            # modal chain stage
            cls = data
            Pm = np.zeros((M, n, n))
            Km = np.zeros((M, m, n))
            Rm = np.zeros((M, m, m))
            APBm = np.zeros((M, n, m))
            for w in np.unique(cls):
                A, B = modes_a[w], modes_b[w]
                Pc = P_rep[1][w] if P_rep[0] == "modal" else P_rep[1]
                PB = Pc @ B
                r_tilde = eye_m + B.T @ PB
                Rm[w] = np.linalg.inv(r_tilde)
                K = np.linalg.solve(r_tilde, -(B.T @ Pc @ A))
                Abar = A + B @ K
                Km[w] = K
                APBm[w] = Abar.T @ PB
                Pm[w] = eye_n + K.T @ K + Abar.T @ Pc @ Abar
            K_ms[k], Rinv_ms[k], APB_ms[k] = Km, Rm, APBm
            P_rep = ("modal", Pm)
    return K_s, Rinv_s, APB_s, K_ms, Rinv_ms, APB_ms


def _stage_mode_patterns(idx: np.ndarray, stage_start, stage_child):
    """Per nonleaf stage: the child mode sequence (tuple of mode ids, length
    c) when it is identical for every parent in the stage, else None."""
    pats = []
    for k in range(len(stage_child)):
        c = stage_child[k]
        a2, b2 = stage_start[k + 1], stage_start[k + 2]
        if c is None:
            pats.append(None)
            continue
        blk = idx[a2:b2].reshape(-1, c)
        pats.append(tuple(int(v) for v in blk[0])
                    if (blk == blk[0]).all() else None)
    return tuple(pats)


def _stacked_stage_weights(mm: Optional[ModalMatrix], patterns, dtype):
    """(fwd, bwd) tuples of per-stage stacked mode blocks for a mode-grouped
    matrix, kept 3-D so the consuming ``dot_general`` needs only free
    major-dim reshapes on the node data (a 2-D [W, c*F] layout would force
    a relayout copy per stage):

    fwd[k] [in, c, out]: children-from-parents, out3[w, r, o] (then a free
    [W, c, out] -> [W*c, out] merge); bwd[k] [c, in, out]: rmatvec summed
    over children via a single contraction over (c, in)."""
    if mm is None or mm.modes is None:
        none = tuple(None for _ in patterns)
        return none, none
    modes = np.asarray(mm.modes, dtype=np.float64)
    fwd, bwd = [], []
    cache = {}
    for pat in patterns:
        if pat is None:
            fwd.append(None)
            bwd.append(None)
        else:
            # one shared array object per distinct pattern: consecutive
            # stages with identical blocks are then groupable by identity
            # into a single whole-range contraction (ops/operator.py
            # stage_groups) — on fully uniform trees the per-stage loops
            # collapse to ONE op over all nodes
            if pat not in cache:
                cache[pat] = (
                    jnp.asarray(
                        np.stack([modes[p].T for p in pat], axis=1), dtype),
                    jnp.asarray(
                        np.stack([modes[p] for p in pat], axis=0), dtype))
            f, b = cache[pat]
            fwd.append(f)
            bwd.append(b)
    return tuple(fwd), tuple(bwd)


def _pad0(arr: np.ndarray, rows: int, fill: float = 0.0) -> np.ndarray:
    """Pad axis 0 of a numpy array to ``rows`` with ``fill``."""
    extra = rows - arr.shape[0]
    if extra == 0:
        return arr
    pad = np.full((extra,) + arr.shape[1:], fill, dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def build_stacked(spec: RAOCP, dtype=None,
                  pad_multiple: int = 1, offline: str = "host",
                  keep_dense: bool = False) -> StackedProblem:
    """Materialise a :class:`StackedProblem` from a problem specification.

    ``pad_multiple``: pad each node space (all-node / nonleaf / leaf) to a
    multiple of this, so the arrays shard evenly over that many devices.
    Ghost rows are zero (bounds: +-inf) and provably stay zero through every
    operator/prox (see tests/test_sharding.py).

    ``offline``: where the Riccati-like factorisation runs. ``"host"``
    computes it in numpy (exact reference parity in float64); ``"device"``
    transfers only the per-mode dynamics + index plans and runs the
    factorisation as one jitted program on the accelerator
    (:func:`_riccati_device`) — the right choice at scale or behind a slow
    host<->device link.

    ``keep_dense``: force the dense per-node stacks (A/B/P/Rinv/K/Abar/
    sumAPB) onto the device. By default only the stacks the solve loop
    actually reads are materialised: on a fully stage-constant tree that is
    NONE of them (the sweeps use the per-stage tables and mode-grouped
    forms), which frees ~5 [N, n, n]-class arrays of HBM at scale; on trees
    with ragged stages the K/Rinv/sumAPB stacks are kept for the fallback
    sweep paths.
    """
    if dtype is None:
        dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    if offline not in ("host", "device"):
        raise ValueError(f"offline must be 'host' or 'device', got {offline}")
    tree = spec.tree
    N = tree.num_nodes
    NL = tree.num_nonleaf_nodes
    LF = N - NL
    n = spec.state_size
    m = spec.control_size
    d = tree.max_branching
    # padded y width: the max row count of any node's risk matrix E
    # (= 2c+1 per AVaR node, 3c+2 per TotalVariation node, ...)
    Y = max(spec.risk_at_node(i).matrix_e.shape[0] for i in range(NL))

    def up(v: int) -> int:
        return -(-v // pad_multiple) * pad_multiple

    NP_, NLP, LFP = up(N), up(NL), up(LF)

    Pi = _offline_kernel_projectors(spec, d, Y)

    def modal_stack(fetch, start: int, stop: int, offset: int, rows: int,
                    shape, dt):
        """Mode-grouped stack from per-node matrices without materialising
        the dense [rows, *shape] array: id()-keyed dedup (shared immutable
        instances hit the cache; distinct objects fall back to content
        hashing). Node ``j`` lands in row ``j - offset``; mode 0 is the zero
        matrix (unassigned/padded rows)."""
        from raocp_tpu.core.modal import MODAL_MAX_MODES

        modes = [np.zeros(shape)]
        seen: dict = {}
        idx = np.zeros(rows, dtype=np.int32)
        dense = False
        for j in range(start, stop):
            mat = fetch(j)
            key = id(mat)
            mode = seen.get(key)
            if mode is None:
                bkey = mat.tobytes()
                mode = seen.get(bkey)
                if mode is None:
                    mode = len(modes)
                    modes.append(np.asarray(mat, dtype=np.float64))
                seen[key] = seen[bkey] = mode
            idx[j - offset] = mode
            if len(modes) > MODAL_MAX_MODES:
                dense = True
                break
        if dense:                                   # too many modes
            stack = np.zeros((rows,) + shape)
            for j in range(start, stop):
                stack[j - offset] = fetch(j)
            return from_dense_stack(stack, dt)
        return ModalMatrix(dense_m=None,
                           modes=jnp.asarray(np.stack(modes), dt),
                           idx=jnp.asarray(idx))

    sqrtQ_m = modal_stack(
        lambda j: spec.nonleaf_cost_at_node(j).sqrt_state_weights,
        1, N, 0, NP_, (n, n), dtype)
    sqrtR_m = modal_stack(
        lambda j: spec.nonleaf_cost_at_node(j).sqrt_control_weights,
        1, N, 0, NP_, (m, m), dtype)
    sqrtP_m = modal_stack(
        lambda i: spec.leaf_cost_at_node(i).sqrt_state_weights,
        NL, N, NL, LFP, (n, n), dtype)

    # risk b vectors + row-kind masks in the padded layout (rows of node i's
    # (E, b) occupy slots [0, R_i) in natural order; kind-driven dual-cone
    # projection — see _cone_row_kinds)
    b_pad = np.zeros((NL, Y))
    y_mask = np.zeros((NL, Y))
    risk_free = np.zeros((NL, Y), dtype=bool)   # Zero-cone rows
    risk_zero = np.zeros((NL, Y), dtype=bool)   # Real-cone rows
    risk_soc = np.zeros((NL, Y), dtype=bool)    # SOC member rows
    risk_soc_t = np.zeros((NL, Y), dtype=bool)  # SOC radial rows
    for i in range(NL):
        risk = spec.risk_at_node(i)
        b = risk.vector_b.reshape(-1)
        R = b.size
        b_pad[i, :R] = b
        y_mask[i, :R] = 1.0
        kinds = np.asarray(_cone_row_kinds(risk.cone, R))
        risk_free[i, :R] = kinds == 1
        risk_zero[i, :R] = kinds == 2
        risk_soc[i, :R] = kinds == 3
        risk_soc_t[i, :R] = kinds == 4
    has_soc = bool(risk_soc_t.any())

    # constraint sets: boxes (Rectangle), Euclidean balls (Ball) and general
    # polyhedra (Polyhedral, lb <= G v <= ub): the dual segment carries the
    # image rows G v (identity rows for Rectangle/Ball) and the dual prox
    # clips them, so only the row matrix and per-node row bounds are stored
    nl_G, nl_lo, nl_hi, nl_active, nl_ball_c, nl_ball_r = _constraint_tables(
        [spec.nonleaf_constraint_at_node(i) for i in range(NL)], n + m)
    l_G, l_lo, l_hi, l_active, l_ball_c, l_ball_r = _constraint_tables(
        [spec.leaf_constraint_at_node(i) for i in range(NL, N)], n)

    anc = tree.ancestors.copy()
    anc[0] = 0
    nz_mask = np.ones(N)
    nz_mask[0] = 0.0

    def dev(x, dt=dtype):
        return jnp.asarray(x, dtype=dt)

    stage_start = tuple(int(v) for v in tree.stage_start)
    # uniform child count per nonleaf stage (None where ragged) — the
    # tree's own derivation, shared with the pre-build partition
    # eligibility check (parallel.subtree._stage_structure)
    stage_child = tree.stage_child
    anc_dev = dev(_pad0(anc, NP_), jnp.int32)
    child_idx_dev = dev(_pad0(tree.children_padded, NLP), jnp.int32)
    child_mask_dev = dev(_pad0(tree.children_mask.astype(np.float64), NLP))

    modes_a, modes_b, w_idx = _dedup_dynamics(spec, n, m)
    idx_dev = dev(_pad0(w_idx, NP_), jnp.int32)      # pad rows -> zero mode
    Am = ModalMatrix(dense_m=None, modes=dev(modes_a), idx=idx_dev)
    Bm = ModalMatrix(dense_m=None, modes=dev(modes_b), idx=idx_dev)
    ABm = ModalMatrix(dense_m=None,
                      modes=dev(np.concatenate([modes_a, modes_b], axis=2)),
                      idx=idx_dev)
    QRm = _fuse_block_diag(sqrtQ_m, sqrtR_m, dtype)

    ab_pat = _stage_mode_patterns(w_idx, stage_start, stage_child)
    ab_fwd, ab_bwd = _stacked_stage_weights(ABm, ab_pat, dtype)
    # stage-constant Riccati detection: constant at stage k iff every stage
    # from k to the leaves has a uniform mode pattern (induction from P=I
    # at the leaves — only the dynamics enter the recursion)
    ns_nl = len(stage_child)
    stage_const = [False] * ns_nl
    const_below = True
    for k in range(ns_nl - 1, -1, -1):
        const_below = const_below and (ab_pat[k] is not None)
        stage_const[k] = const_below
    if QRm is not None:
        qr_pat = _stage_mode_patterns(np.asarray(QRm.idx)[:N], stage_start,
                                      stage_child)
        qr_fwd, qr_bwd = _stacked_stage_weights(QRm, qr_pat, dtype)
    else:
        qr_fwd = qr_bwd = tuple(None for _ in stage_child)

    # Which dense stacks does the solve actually read? K/Rinv/sumAPB only
    # on stages with neither stage-constant nor mode-constant tables;
    # A/B/P/Abar never (the sweeps use the mode-grouped / per-stage
    # forms). fully_const implies every stage has scalar tables
    # (stage_const is a suffix property); fully_tabled additionally covers
    # post-stopping chain stages via [num_modes, ...] mode tables
    # (_riccati_plan) — the standard stopped-Markov-tree shape then needs
    # NO dense stacks at any scale.
    fully_const = bool(ns_nl) and stage_const[0]
    plan = _riccati_plan(w_idx, stage_start, stage_child, ab_pat)
    fully_tabled = bool(ns_nl) and plan[0] is not None
    need_kr = keep_dense or not fully_tabled

    A_dev = B_dev = P_dev = Rinv_dev = K_dev = None
    Abar_dev = sumAPB_dev = None
    k_s = rinv_s = sumapb_s = None
    k_ms = rinv_ms = sumapb_ms = None
    riccati_cls = None

    if fully_tabled and not keep_dense:
        # No dense stacks at all: the Riccati recursion runs on the host
        # over ONE tiny matrix per stage (per mode on chain stages;
        # microseconds, float64) and only the tables — a few KB — reach
        # the device. This is both the fastest setup path and the memory
        # floor (at 1e5 nodes / 50 states the dense stacks it avoids are
        # ~3.5 GB of dead device memory; at 100 states the general device
        # factorisation peaks ~10 GB).
        K_sl, Rinv_sl, APB_sl, K_msl, Rinv_msl, APB_msl = \
            _offline_riccati_tables(modes_a, modes_b, plan)
        opt = lambda tabs: tuple(                     # noqa: E731
            None if t is None else dev(t) for t in tabs)
        k_s, rinv_s, sumapb_s = opt(K_sl), opt(Rinv_sl), opt(APB_sl)
        k_ms, rinv_ms, sumapb_ms = opt(K_msl), opt(Rinv_msl), opt(APB_msl)
        if any(t is not None for t in k_ms):
            cls = np.zeros(NP_, dtype=np.int32)
            for k in range(ns_nl):
                if plan[k] is not None and plan[k][0] == "modal":
                    cls[stage_start[k]:stage_start[k + 1]] = plan[k][1]
            riccati_cls = dev(cls, jnp.int32)
    elif offline == "device":
        @jax.jit
        def _expand(ma, mb, idx):
            return ma[idx], mb[idx]

        if fully_const:
            # keep_dense on a fully stage-constant tree: expand the stage
            # tables on device by broadcast instead of running the general
            # device program (_riccati_device) over [N, n, n] stacks.
            A_dev, B_dev = _expand(Am.modes, Bm.modes, idx_dev)
            P_sl, K_sl, Rinv_sl, APB_sl, Abar_sl = _offline_riccati_stage(
                modes_a, modes_b, ab_pat)
            widths = tuple(stage_start[k + 1] - stage_start[k]
                           for k in range(tree.num_stages))

            @jax.jit
            def _expand_tables(P_st, K_st, Rinv_st, APB_st, Abar_st):
                def bcast(tabs, rows, pad_rows):
                    parts = [jnp.broadcast_to(t, (w,) + t.shape)
                             for t, w in zip(tabs, rows)]
                    if pad_rows:
                        parts.append(jnp.zeros((pad_rows,) + tabs[0].shape,
                                               dtype))
                    return jnp.concatenate(parts, axis=0)

                eye = jnp.eye(n, dtype=dtype)
                P_full = bcast(list(P_st) + [eye], widths, NP_ - N)
                K_full = bcast(list(K_st), widths[:-1], NLP - NL)
                Rinv_full = bcast(list(Rinv_st), widths[:-1], NLP - NL)
                APB_full = bcast(list(APB_st), widths[:-1], NLP - NL)
                ab_parts = [jnp.zeros((1, n, n), dtype)]      # root row
                for k, ab in enumerate(Abar_st):
                    c = ab.shape[0]
                    blk = jnp.broadcast_to(ab, (widths[k],) + ab.shape)
                    ab_parts.append(blk.reshape(widths[k] * c, n, n))
                if NP_ - N:
                    ab_parts.append(jnp.zeros((NP_ - N, n, n), dtype))
                Abar_full = jnp.concatenate(ab_parts, axis=0)
                return P_full, K_full, Rinv_full, APB_full, Abar_full

            to_dt = lambda t: jnp.asarray(t, dtype)   # noqa: E731
            P_dev, K_dev, Rinv_dev, sumAPB_dev, Abar_dev = _expand_tables(
                tuple(to_dt(t) for t in P_sl[:-1]),
                tuple(to_dt(t) for t in K_sl),
                tuple(to_dt(t) for t in Rinv_sl),
                tuple(to_dt(t) for t in APB_sl),
                tuple(to_dt(t) for t in Abar_sl))
        else:
            A_dev, B_dev = _expand(Am.modes, Bm.modes, idx_dev)
            P_dev, Rinv_dev, K_dev, Abar_dev, sumAPB_dev = \
                _riccati_device_jit(
                    A_dev, B_dev, child_idx_dev, child_mask_dev, anc_dev,
                    stage_start, num_nonleaf=NL, nl_pad=NLP)
            if not keep_dense:   # transient inputs/outputs of the program
                A_dev = B_dev = P_dev = Abar_dev = None
    else:
        A, B, P, Rinv, K, Abar, sumAPB = _offline_riccati(spec, n, m)
        if keep_dense:
            A_dev, B_dev = dev(_pad0(A, NP_)), dev(_pad0(B, NP_))
            P_dev = dev(_pad0(P, NP_))
            Abar_dev = dev(_pad0(Abar, NP_))
        Rinv_dev, K_dev = dev(_pad0(Rinv, NLP)), dev(_pad0(K, NLP))
        sumAPB_dev = dev(_pad0(sumAPB, NLP))

    if k_s is None:
        # representative rows for stage-constant stages (first node of stage)
        k_s = tuple(K_dev[stage_start[k]] if stage_const[k] else None
                    for k in range(ns_nl))
        rinv_s = tuple(Rinv_dev[stage_start[k]] if stage_const[k] else None
                       for k in range(ns_nl))
        sumapb_s = tuple(sumAPB_dev[stage_start[k]] if stage_const[k]
                         else None for k in range(ns_nl))
    if k_ms is None:
        k_ms = rinv_ms = sumapb_ms = tuple(None for _ in range(ns_nl))
    if not need_kr:
        Rinv_dev = K_dev = sumAPB_dev = None

    return StackedProblem(
        n=n, m=m, num_nodes=N, num_nonleaf=NL, num_leaf=LF,
        d_max=d, num_stages=tree.num_stages,
        stage_start=stage_start,
        stage_child=stage_child,
        np_pad=NP_, nl_pad=NLP, lf_pad=LFP, y_dim=Y,
        anc=anc_dev,
        child_idx=child_idx_dev,
        child_mask=child_mask_dev,
        child_rank=dev(_pad0(tree.child_rank, NP_), jnp.int32),
        nz_mask=dev(_pad0(nz_mask, NP_)),
        risk_free_rows=jnp.asarray(_pad0(risk_free, NLP)),
        risk_zero_rows=jnp.asarray(_pad0(risk_zero, NLP)),
        risk_soc_rows=(jnp.asarray(_pad0(risk_soc, NLP)) if has_soc
                       else None),
        risk_soc_tail=(jnp.asarray(_pad0(risk_soc_t, NLP)) if has_soc
                       else None),
        A=A_dev, B=B_dev, Am=Am, Bm=Bm, ABm=ABm,
        sqrtQ=sqrtQ_m, sqrtR=sqrtR_m, QRm=QRm, sqrtP=sqrtP_m,
        ab_fwd=ab_fwd, ab_bwd=ab_bwd, qr_fwd=qr_fwd, qr_bwd=qr_bwd,
        k_s=k_s, rinv_s=rinv_s, sumapb_s=sumapb_s,
        k_ms=k_ms, rinv_ms=rinv_ms, sumapb_ms=sumapb_ms,
        riccati_cls=riccati_cls,
        b_pad=dev(_pad0(b_pad, NLP)), y_mask=dev(_pad0(y_mask, NLP)),
        nl_lo=dev(_pad0(nl_lo, NLP, -np.inf)),
        nl_hi=dev(_pad0(nl_hi, NLP, np.inf)),
        nl_active=dev(_pad0(nl_active, NLP)),
        nl_ball_c=dev(_pad0(nl_ball_c, NLP)),
        nl_ball_r=dev(_pad0(nl_ball_r, NLP, np.inf)),
        l_lo=dev(_pad0(l_lo, LFP, -np.inf)),
        l_hi=dev(_pad0(l_hi, LFP, np.inf)),
        l_active=dev(_pad0(l_active, LFP)),
        l_ball_c=dev(_pad0(l_ball_c, LFP)),
        l_ball_r=dev(_pad0(l_ball_r, LFP, np.inf)),
        nl_G=None if nl_G is None else dev(nl_G),
        l_G=None if l_G is None else dev(l_G),
        P=P_dev, Rinv=Rinv_dev, K=K_dev, Abar=Abar_dev,
        sumAPB=sumAPB_dev, Pi=dev(_pad0(Pi, NLP)),
    )
