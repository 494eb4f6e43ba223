from .observability import MetricsLogger, PreemptionGuard, TimeoutGuard

__all__ = ["MetricsLogger", "PreemptionGuard", "TimeoutGuard"]
