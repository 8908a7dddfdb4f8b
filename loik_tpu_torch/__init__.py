"""loik_tpu_torch — the PyTorch/CUDA port of loik_tpu for NVIDIA Hopper.

Constrained differential inverse kinematics by first-order ADMM over
linear-time kinematic-tree sweeps, batched with the problem index as the
trailing tensor axis.  The eager PyTorch solver (`solver.solve`) runs on any
device; on a CUDA device the whole ADMM loop runs as one hand-written kernel
(`kernels/csrc/fused_admm.cu`), built with nvcc on first use.

On the card the entry points run as captured CUDA graphs (`utils.graphs`,
the counterpart of `jax.jit`), and `jit` captures a user's function of
tensors, such as a training step through `solve_unrolled`, the same way.

`loik_tpu` (JAX) is the reference this package is held against; this
package never imports it or jax.
"""

from . import parallel, spatial, utils
from .api import DiffIkSolver
from .model import KinematicTree, builders, load_urdf, make_tree, robots
from .params import MuUpdateStrat, SolverParams
from .problem import IkProblem, make_problem
from .solver import solve
from .solver.clik import ClikResult, solve_clik
from .solver.diff import solve_unrolled
from .solver.refine import solve_delta_duals, solve_delta_refined, solve_two_stage
from .solver.state import SolveResult, SolverState
from .solver.stream import StreamResult, solve_stream
from .utils import jit

__version__ = "0.1.0"
