from .dd import DistributedSystem, distribute

__all__ = ["DistributedSystem", "distribute"]
