from .system import CoupledSystem, StepOperators, StepParams

__all__ = ["CoupledSystem", "StepOperators", "StepParams"]
