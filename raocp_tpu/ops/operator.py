"""The Chambolle-Pock linear operator L and its adjoint L' — the hot kernels.

The reference implements these as Python loops over nodes
(``raocp/core/operators.py:19`` ``ell`` and ``:55`` ``ell_transpose``). Here
each is ONE fused batched computation over the stacked pytrees: parent-index
gathers, batched einsum matmuls, and padded child-table reductions —
no per-node control flow, fully jittable and shardable over the node axis.

Mathematical definition (per nonleaf node i, child j, leaf l):
  eta1_i = y_i                       eta2_i = s_i - b_i'y_i
  eta3_j = sqrt(Q_j) x_i             eta4_j = sqrt(R_j) u_i
  eta5_j = eta6_j = tau_j / 2        eta7_i = [x_i; u_i]   (box rows)
  eta11_l = sqrt(P) x_l              eta12_l = eta13_l = s_l / 2
  eta14_l = x_l
and ell_t is the exact adjoint (verified segment-by-segment in
``tests/test_operator.py``, mirroring the reference's 13 pairing tests).
"""

import jax
import jax.numpy as jnp

from raocp_tpu.core.stacked import StackedProblem
from raocp_tpu.core.variables import Primal, Dual

__all__ = ["ell", "ell_t", "sum_over_children", "parent_expand", "repad",
           "stage_groups", "flat_linops"]


def stage_groups(sp: StackedProblem, same):
    """Yield (k0, k1) maximal runs of consecutive nonleaf stages with
    ``same(k0, k) for k in (k0, k1)``.

    Stage-major node ordering makes a run's parents [ss[k0], ss[k1]) and
    children [ss[k0+1], ss[k1+1]) contiguous, so any per-stage batched op
    whose parameters coincide across the run (same child count, same
    stage-stacked mode block) applies to the whole run as ONE op — on a
    fully uniform tree every stage loop here collapses to a single
    whole-tree contraction (one op instead of num_stages; the per-op
    launch overhead inside the solver loop was ~30% of iteration time on
    the 9841-node benchmark before grouping)."""
    ns = sp.num_stages - 1
    k = 0
    while k < ns:
        k1 = k + 1
        while k1 < ns and same(k, k1):
            k1 += 1
        yield k, k1
        k = k1


def _same_weight(table):
    """Group predicate: stages share one (non-None) stage-stacked mode
    block object (build_stacked interns them per distinct pattern)."""
    return lambda k0, k: table[k0] is not None and table[k] is table[k0]


def _same_child(sp: StackedProblem):
    """Group predicate: stages have the same uniform child count."""
    return lambda k0, k: (sp.stage_child[k0] is not None
                          and sp.stage_child[k] == sp.stage_child[k0])


def _frontier_psum(sp: StackedProblem, k0: int, part):
    """Complete a child reduction across the subtree-partition frontier.

    Under the replicated-spine subtree partition (parallel.subtree) the
    children of stage ``frontier - 1`` are sharded over the devices, so a
    locally computed per-parent child reduction is PARTIAL (each device
    contributes the children it owns; mask rows elsewhere are zero) — one
    psum over the mesh axis completes it identically on every device. All
    other stages reduce shard-locally: spine stages because parents and
    children are both replicated, subtree stages because each device owns
    complete subtrees. No-op outside shard_map (``spmd_axis`` unset)."""
    if sp.spmd_axis is not None and sp.frontier is not None \
            and k0 == sp.frontier - 1:
        return jax.lax.psum(part, sp.spmd_axis)
    return part


def repad(arr, rows: int):
    """Pad axis 0 with zeros up to ``rows`` (no-op when already there).

    Used at the boundaries between the three node spaces (all-node, nonleaf,
    leaf), each of which is padded independently for even mesh sharding."""
    extra = rows - arr.shape[0]
    if extra == 0:
        return arr
    return jnp.concatenate(
        [arr, jnp.zeros((extra,) + arr.shape[1:], arr.dtype)], axis=0)


def sum_over_children(sp: StackedProblem, w):
    """[num_nodes, ...] child-indexed values -> [num_nonleaf, ...] sums over
    each node's children.

    Stage-wise: a stage with uniform branching ``c`` (dense transition
    matrices — stage-major ordering makes each parent's children contiguous)
    reduces with a gather-free reshape ``[W, c, ...] -> sum(axis=1)``;
    ragged stages fall back to the padded child table (gather + masked
    sum)."""
    ss = sp.stage_start
    parts = []
    for k0, k1 in stage_groups(sp, _same_child(sp)):
        a, b = ss[k0], ss[k1]
        a2, b2 = ss[k0 + 1], ss[k1 + 1]
        wk = w[a2:b2]
        c = sp.stage_child[k0]
        if c is not None:
            parts.append(wk.reshape((b - a, c) + wk.shape[1:]).sum(axis=1))
        else:                      # single ragged stage (k1 == k0 + 1)
            rel = jnp.clip(sp.child_idx[a:b] - a2, 0, b2 - a2 - 1)
            mask = sp.child_mask[a:b]
            mask = mask.reshape(mask.shape + (1,) * (wk.ndim - 1))
            parts.append(_frontier_psum(
                sp, k0, jnp.sum(wk[rel] * mask, axis=1)))
    tail = sp.nl_pad - sp.num_nonleaf
    if tail:
        parts.append(jnp.zeros((tail,) + w.shape[1:], w.dtype))
    return jnp.concatenate(parts, axis=0)


def parent_expand(sp: StackedProblem, v, rows: int):
    """[nonleaf-or-node rows, ...] -> [rows, ...] with out[j] = v[anc(j)]
    for real non-root nodes j, zero at row 0 and padding.

    Uniform stages use ``repeat`` (a broadcast — no random access); ragged
    stages gather the stage slice."""
    ss = sp.stage_start
    parts = [jnp.zeros((1,) + v.shape[1:], v.dtype)]
    for k0, k1 in stage_groups(sp, _same_child(sp)):
        a, b = ss[k0], ss[k1]
        a2, b2 = ss[k0 + 1], ss[k1 + 1]
        c = sp.stage_child[k0]
        if c is not None:
            parts.append(jnp.repeat(v[a:b], c, axis=0))
        else:                      # single ragged stage
            parts.append(v[sp.anc[a2:b2]])
    tail = rows - ss[sp.num_stages]
    if tail:
        parts.append(jnp.zeros((tail,) + v.shape[1:], v.dtype))
    return jnp.concatenate(parts, axis=0)


def ell(sp: StackedProblem, z: Primal) -> Dual:
    """Apply L: primal -> dual (parity: reference ``operators.py:19-53``)."""
    NL, N, n = sp.num_nonleaf, sp.num_nodes, sp.n
    # one fused [x; u] per nonleaf node feeds the parent-expand, the
    # blockdiag(sqrtQ, sqrtR) matvec, AND the constraint rows e7
    xu = jnp.concatenate([repad(z.x[:NL], sp.nl_pad), z.u], axis=1)
    e1 = z.y
    e2 = repad(z.s[:NL], sp.nl_pad) - jnp.sum(sp.b_pad * z.y, axis=1)
    if sp.QRm is not None and any(w is not None for w in sp.qr_fwd):
        # stage-stacked mode blocks: parent-expand + modal matvec + mode
        # select collapse to one dense matmul per GROUP of consecutive
        # stages sharing the block (one matmul for the whole tree when the
        # branching/mode pattern is uniform — see stage_groups)
        ss = sp.stage_start
        F = sp.n + sp.m
        parts = [jnp.zeros((1, F), sp.dtype)]              # root row
        for k0, k1 in stage_groups(sp, _same_weight(sp.qr_fwd)):
            a, b = ss[k0], ss[k1]
            a2, b2 = ss[k0 + 1], ss[k1 + 1]
            if sp.qr_fwd[k0] is not None:
                e3d = jax.lax.dot_general(xu[a:b], sp.qr_fwd[k0],
                                          (((1,), (0,)), ((), ())))
                parts.append(e3d.reshape(b2 - a2, F))
            else:                  # single non-uniform stage (k1 == k0 + 1)
                c = sp.stage_child[k0]
                xu_par = (jnp.repeat(xu[a:b], c, axis=0) if c is not None
                          else xu[a:b][sp.anc[a2:b2] - a])
                parts.append(sp.QRm.slice_rows(a2, b2).matvec(xu_par))
        tail = sp.np_pad - N
        if tail:
            parts.append(jnp.zeros((tail, F), sp.dtype))
        e34 = jnp.concatenate(parts, axis=0)
        e3, e4 = e34[:, :n], e34[:, n:]
    elif sp.QRm is not None:
        xu_parent = parent_expand(sp, xu, sp.np_pad)   # [N, n+m] (row 0 = 0)
        e34 = sp.QRm.matvec(xu_parent)
        e3, e4 = e34[:, :n], e34[:, n:]
    else:
        e3 = sp.sqrtQ.matvec(parent_expand(sp, z.x, sp.np_pad))
        e4 = sp.sqrtR.matvec(parent_expand(sp, z.u, sp.np_pad))
    half_tau = 0.5 * z.tau * sp.nz_mask
    # constraint rows: the image G [x; u] under a shared Polyhedral matrix,
    # or the identity rows of Rectangle/Ball (reference operators.py:41-44
    # with Gamma matrices that are stacked identities there)
    e7 = ((xu @ sp.nl_G.T) if sp.nl_G is not None else xu) \
        * sp.nl_active[:, None]

    x_leaf = repad(z.x[NL:N], sp.lf_pad)
    e11 = sp.sqrtP.matvec(x_leaf)
    half_s = 0.5 * repad(z.s[NL:N], sp.lf_pad)
    e14 = ((x_leaf @ sp.l_G.T) if sp.l_G is not None else x_leaf) \
        * sp.l_active[:, None]

    return Dual(e1=e1, e2=e2, e3=e3, e4=e4, e5=half_tau, e6=half_tau,
                e7=e7, e11=e11, e12=half_s, e13=half_s, e14=e14)


def ell_t(sp: StackedProblem, eta: Dual) -> Primal:
    """Apply L' (exact adjoint of :func:`ell`; parity: reference
    ``operators.py:55-94``)."""
    NL, LF = sp.num_nonleaf, sp.num_leaf
    n = sp.n

    y = eta.e1 - sp.b_pad * eta.e2[:, None]

    # adjoint of the constraint rows: G' e7 under a shared Polyhedral
    # matrix, identity rows otherwise — a [nl_pad, n+m] contribution
    con7 = eta.e7 * sp.nl_active[:, None]
    if sp.nl_G is not None:
        con7 = con7 @ sp.nl_G

    # x/u contributions from the SOC heads, summed back over children —
    # fused: one blockdiag rmatvec + one child reduction over [N, n+m]
    if sp.QRm is not None and any(w is not None for w in sp.qr_bwd):
        # stage-stacked mode blocks: rmatvec + select + child-sum in one
        # dense matmul per GROUP of consecutive stages sharing the block
        ss = sp.stage_start
        F = sp.n + sp.m
        e34 = jnp.concatenate([eta.e3, eta.e4], axis=1)
        parts = []
        for k0, k1 in stage_groups(sp, _same_weight(sp.qr_bwd)):
            a, b = ss[k0], ss[k1]
            a2, b2 = ss[k0 + 1], ss[k1 + 1]
            blk = e34[a2:b2]
            if sp.qr_bwd[k0] is not None:
                c = sp.stage_child[k0]
                parts.append(jax.lax.dot_general(
                    blk.reshape(b - a, c, F), sp.qr_bwd[k0],
                    (((1, 2), (0, 1)), ((), ()))))
            else:                  # single non-uniform stage (k1 == k0 + 1)
                w = sp.QRm.slice_rows(a2, b2).rmatvec(blk)
                c = sp.stage_child[k0]
                if c is not None:
                    parts.append(_frontier_psum(
                        sp, k0, w.reshape(b - a, c, F).sum(axis=1)))
                else:
                    rel = jnp.clip(sp.child_idx[a:b] - a2, 0, b2 - a2 - 1)
                    mask = sp.child_mask[a:b][..., None]
                    parts.append(_frontier_psum(
                        sp, k0, jnp.sum(w[rel] * mask, axis=1)))
        tail = sp.nl_pad - NL
        if tail:
            parts.append(jnp.zeros((tail, F), sp.dtype))
        s34 = jnp.concatenate(parts, axis=0)
        xu = con7 + s34
        x_nl, u = xu[:, :n], xu[:, n:]
    elif sp.QRm is not None:
        w34 = sp.QRm.rmatvec(jnp.concatenate([eta.e3, eta.e4], axis=1))
        s34 = sum_over_children(sp, w34)
        xu = con7 + s34
        x_nl, u = xu[:, :n], xu[:, n:]
    else:
        w3 = sp.sqrtQ.rmatvec(eta.e3)                # sqrtQ' e3 per child
        w4 = sp.sqrtR.rmatvec(eta.e4)
        x_nl = con7[:, :n] + sum_over_children(sp, w3)
        u = con7[:, n:] + sum_over_children(sp, w4)

    con14 = eta.e14 * sp.l_active[:, None]
    if sp.l_G is not None:
        con14 = con14 @ sp.l_G
    x_leaf = sp.sqrtP.rmatvec(eta.e11) + con14
    x = repad(jnp.concatenate([x_nl[:NL], x_leaf[:LF]], axis=0), sp.np_pad)

    tau = 0.5 * (eta.e5 + eta.e6) * sp.nz_mask
    s = repad(jnp.concatenate(
        [eta.e2[:NL], 0.5 * (eta.e12 + eta.e13)[:LF]], axis=0), sp.np_pad)

    return Primal(x=x, u=u, y=y, tau=tau, s=s)


def flat_linops(sp: StackedProblem):
    """(matvec, rmatvec, primal_dim, dual_dim) on flat numpy vectors.

    The scipy-interop surface (parity: reference ``operators.py:96-109``
    ``linop_ell``/``linop_ell_transpose``): wraps the jitted L / L' pair so
    they plug directly into ``scipy.sparse.linalg.LinearOperator`` — e.g.
    for cross-checking the step-size rule against Arnoldi ``eigs``::

        mv, rmv, np_, nd = flat_linops(sp)
        L = LinearOperator((nd, np_), matvec=mv, rmatvec=rmv)
    """
    import numpy as np

    from raocp_tpu.core.variables import make_packers

    pack_p, unpack_p, pack_d, unpack_d = make_packers(sp)
    ell_jit = jax.jit(lambda pz: pack_d(ell(sp, unpack_p(pz))))
    ell_t_jit = jax.jit(lambda pe: pack_p(ell_t(sp, unpack_d(pe))))
    primal_dim = int(pack_p(sp.zero_primal(xp=np)).shape[0])
    dual_dim = int(pack_d(sp.zero_dual(xp=np)).shape[0])

    def matvec(vec):
        flat = jnp.asarray(np.asarray(vec).reshape(-1), sp.dtype)
        return np.asarray(ell_jit(flat))

    def rmatvec(vec):
        flat = jnp.asarray(np.asarray(vec).reshape(-1), sp.dtype)
        return np.asarray(ell_t_jit(flat))

    return matvec, rmatvec, primal_dim, dual_dim
