from .generic import PlasmaConfig, PlasmaModel
from .glow import GlowConfig, GlowDischargeModel
from .streamer import StreamerConfig, StreamerModel
from .tof import TimeOfFlight1D, TimeOfFlight2D, TofConfig

__all__ = ["PlasmaConfig", "PlasmaModel", "GlowConfig",
           "GlowDischargeModel", "StreamerConfig", "StreamerModel",
           "TimeOfFlight1D", "TimeOfFlight2D", "TofConfig"]
