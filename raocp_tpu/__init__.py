"""raocp_tpu — a JAX framework for multistage Risk-Averse Optimal Control
Problems (RAOCPs) on scenario trees, run on an NVIDIA GPU.

Built from scratch for JAX/XLA: all per-node computations are batched
over stacked arrays (vmap/einsum style), the Chambolle-Pock iteration runs as
a single jitted step inside ``lax.while_loop``, and multi-device scaling uses
``jax.sharding`` over the node axis.

Capability parity target: smokinmirror/raocp-toolbox (see reference
``raocp/__init__.py:1`` for the public surface re-exported here).
"""

from raocp_tpu.core.tree import ScenarioTree, MarkovChainScenarioTreeFactory
from raocp_tpu.core.elements import (Node, Nonleaf, Leaf, NodeKind,
                                     Dynamics, Quadratic, AVaR,
                                     TotalVariation, MeanUpperSemideviation,
                                     Wasserstein, L2Ball,
                                     ConicRisk, ConicForm)
from raocp_tpu.core.constraints import (
    Ball,
    Constraint,
    No,
    Polyhedral,
    Rectangle,
    Real,
    Zero,
    NonnegativeOrthant,
    SecondOrderCone,
    Cartesian,
)
from raocp_tpu.core.spec import RAOCP
from raocp_tpu.solver import Solver, SolverResult
from raocp_tpu.mpc import ClosedLoopResult, RiskAverseMPC

__version__ = "0.1.0"

__all__ = [
    "ScenarioTree",
    "MarkovChainScenarioTreeFactory",
    "Node",
    "NodeKind",
    "Nonleaf",
    "Leaf",
    "Dynamics",
    "Quadratic",
    "AVaR",
    "TotalVariation",
    "MeanUpperSemideviation",
    "Wasserstein",
    "L2Ball",
    "ConicRisk",
    "ConicForm",
    "Constraint",
    "Ball",
    "No",
    "Polyhedral",
    "Rectangle",
    "Real",
    "Zero",
    "NonnegativeOrthant",
    "SecondOrderCone",
    "Cartesian",
    "RAOCP",
    "Solver",
    "SolverResult",
    "RiskAverseMPC",
    "ClosedLoopResult",
]
