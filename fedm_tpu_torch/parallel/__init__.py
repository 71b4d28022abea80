from .dd import DistributedSystem, distribute
from .sweep import BatchedSweep, SweepState

__all__ = ["BatchedSweep", "DistributedSystem", "SweepState", "distribute"]
