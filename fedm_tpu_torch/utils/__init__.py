from .process import comma_separated, print_process_0
from .timers import PhaseTimer, trace_annotation

__all__ = ["print_process_0", "comma_separated", "PhaseTimer",
           "trace_annotation"]
