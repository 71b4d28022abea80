from .controllers import adaptive_timestep
from .driver import AdaptiveDriver, TimeState, step_error_norm

__all__ = ["adaptive_timestep", "AdaptiveDriver", "TimeState",
           "step_error_norm"]
