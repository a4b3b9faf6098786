"""pycatkin_tpu_torch: the PyTorch / CUDA port of pycatkin_tpu.

The JAX package's microkinetics framework -- DFT-landscape
thermochemistry, TST kinetics, mean-field microkinetic models, the
lane-batched steady-state sweep, the transient, degree of rate control,
the energy span model and uncertainty quantification -- ported to
PyTorch for NVIDIA Hopper cards: float64 throughout, an explicit leading
lane dimension in place of ``vmap``, and the batched-LU Pallas kernels
of ``pycatkin_tpu/ops/pallas_linalg.py`` rewritten as hand-written CUDA
kernels (``csrc/linalg.cu``, bound in :mod:`.ops.cuda_linalg`).

Entry points: the :class:`~.api.system.System` facade and its presets
(:mod:`.api.presets`), :func:`~.frontend.loader.read_from_input_file`,
and the one-call sweep
:func:`~.parallel.batch.sweep_steady_state` (``abi=True`` lowers the
mechanism into its shape bucket first, :mod:`.frontend.abi`). Public
entry points run on the CUDA card unless ``device="cpu"`` is passed,
and raise when no card is present.
"""

from . import constants
from .engine import (FreeEnergies, ReactionEnergies, activity_from_tof, drc,
                     drc_fd, free_energies, get_dydt, get_jacobian,
                     make_rhs, make_steady_x, rate_constants,
                     reaction_energies, reaction_rates_at, steady_state,
                     tof, transient)
from .analysis.uncertainty import Uncertainty
from .frontend.loader import read_from_input_file
from .frontend.reactions import (Reaction, ReactionDerivedReaction,
                                 UserDefinedReaction)
from .frontend.spec import Conditions, ModelSpec, build_spec
from .frontend.states import ScalingState, State
from .solvers.newton import SolverOptions, SteadyStateResults
from .solvers.ode import ODEOptions, log_time_grid

__version__ = "0.1.0"
