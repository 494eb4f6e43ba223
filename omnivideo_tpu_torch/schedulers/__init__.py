from .continuous_ode import ContinuousODEScheduler
from .ddim import EnhancedDDIMScheduler
from .flow_match import FlowMatchScheduler
from .fm_dpm import DPMState, FlowDPMSolver, get_sampling_sigmas
from .unipc import FlowUniPC, UniPCState

__all__ = ["ContinuousODEScheduler", "DPMState", "EnhancedDDIMScheduler", "FlowDPMSolver",
           "FlowMatchScheduler", "FlowUniPC", "UniPCState", "get_sampling_sigmas"]
