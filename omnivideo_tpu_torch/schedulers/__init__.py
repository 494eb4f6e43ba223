from .unipc import FlowUniPC, UniPCState

__all__ = ["FlowUniPC", "UniPCState"]
