from .generic import PlasmaConfig, PlasmaModel
from .glow import GlowConfig, GlowDischargeModel
from .streamer import StreamerConfig, StreamerModel

__all__ = ["PlasmaConfig", "PlasmaModel", "GlowConfig",
           "GlowDischargeModel", "StreamerConfig", "StreamerModel"]
