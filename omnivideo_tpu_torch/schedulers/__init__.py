from .flow_match import FlowMatchScheduler
from .fm_dpm import DPMState, FlowDPMSolver, get_sampling_sigmas
from .unipc import FlowUniPC, UniPCState

__all__ = ["DPMState", "FlowDPMSolver", "FlowMatchScheduler", "FlowUniPC", "UniPCState",
           "get_sampling_sigmas"]
