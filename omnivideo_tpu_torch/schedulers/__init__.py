from .flow_match import FlowMatchScheduler
from .unipc import FlowUniPC, UniPCState

__all__ = ["FlowMatchScheduler", "FlowUniPC", "UniPCState"]
