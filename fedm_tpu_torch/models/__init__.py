from .streamer import StreamerConfig, StreamerModel

__all__ = ["StreamerConfig", "StreamerModel"]
