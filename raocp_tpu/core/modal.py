"""Mode-grouped storage for per-node matrix stacks.

On Markovian problems, the per-node matrix stacks (sqrt(Q_j), sqrt(R_j),
sqrt(P_l), ...) contain only a handful of distinct matrices — one per Markov
mode. A dense [num_nodes, a, b] stack makes every batched matvec an
HBM-bandwidth-bound batched GEMV (reads num_nodes*a*b matrix entries per
apply). Mode-grouped storage computes ALL modes with one dense
[num_nodes, b] @ [b, M*a] matmul (a dense GEMM that reads only the vectors)
and then selects each node's mode — a large win whenever M << a.

This is an accelerator-side optimisation with no counterpart in the reference
(which stores per-node Python objects — raocp_spec.py:19-24) and changes no
numerics: ``matvec``/``rmatvec`` produce bit-identical results to the dense
path for M == 1 and numerically identical contractions otherwise.
"""

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["ModalMatrix", "from_dense_stack"]

# use mode-grouping when the number of distinct matrices is at most this
MODAL_MAX_MODES = 16


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ModalMatrix:
    """Either a dense per-node stack or (modes, index) grouped storage."""

    dense_m: Optional[jax.Array]   # [N, a, b] or None
    modes: Optional[jax.Array]     # [M, a, b] or None
    idx: Optional[jax.Array]       # [N] int32 mode index, or None

    @property
    def num_rows(self) -> int:
        if self.dense_m is not None:
            return self.dense_m.shape[0]
        return self.idx.shape[0]

    def matvec(self, x):
        """Per-row M[i] @ x[i]; x: [N, b] -> [N, a]."""
        if self.dense_m is not None:
            return jnp.einsum("jab,jb->ja", self.dense_m, x)
        if self.modes.shape[0] == 1:
            return x @ self.modes[0].T
        all_modes = jnp.einsum("jb,mab->jma", x, self.modes)   # [N, M, a]
        return jnp.take_along_axis(
            all_modes, self.idx[:, None, None], axis=1)[:, 0]

    def rmatvec(self, v):
        """Per-row M[i]' @ v[i]; v: [N, a] -> [N, b]."""
        if self.dense_m is not None:
            return jnp.einsum("jab,ja->jb", self.dense_m, v)
        if self.modes.shape[0] == 1:
            return v @ self.modes[0]
        all_modes = jnp.einsum("ja,mab->jmb", v, self.modes)   # [N, M, b]
        return jnp.take_along_axis(
            all_modes, self.idx[:, None, None], axis=1)[:, 0]

    def slice_rows(self, a: int, b: int) -> "ModalMatrix":
        """View of rows [a, b) (static bounds) — modes stay shared, so the
        per-stage sweeps read only the tiny mode table plus an int32 slice."""
        if self.dense_m is not None:
            return ModalMatrix(dense_m=self.dense_m[a:b], modes=None,
                               idx=None)
        return ModalMatrix(dense_m=None, modes=self.modes,
                           idx=self.idx[a:b])

    def dense(self):
        """Materialise the [N, a, b] stack (for tests/inspection)."""
        if self.dense_m is not None:
            return self.dense_m
        return self.modes[self.idx]


def from_dense_stack(stack: np.ndarray, dtype) -> ModalMatrix:
    """Build mode-grouped storage when few distinct matrices exist."""
    n_rows = stack.shape[0]
    seen = {}
    idx = np.zeros(n_rows, dtype=np.int32)
    modes = []
    for i in range(n_rows):
        key = stack[i].tobytes()
        if key not in seen:
            seen[key] = len(modes)
            modes.append(stack[i])
        idx[i] = seen[key]
        if len(modes) > MODAL_MAX_MODES:
            return ModalMatrix(dense_m=jnp.asarray(stack, dtype),
                               modes=None, idx=None)
    return ModalMatrix(dense_m=None,
                       modes=jnp.asarray(np.stack(modes), dtype),
                       idx=jnp.asarray(idx))
