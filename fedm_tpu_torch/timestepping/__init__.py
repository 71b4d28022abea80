from .controllers import (adaptive_timestep, adaptive_timestep_H211b,
                          adaptive_timestep_PI34)
from .driver import (AdaptiveDriver, TimeState, restart_bdf_history,
                     step_error_norm)

__all__ = ["adaptive_timestep", "adaptive_timestep_PI34",
           "adaptive_timestep_H211b", "AdaptiveDriver", "TimeState",
           "restart_bdf_history", "step_error_norm"]
