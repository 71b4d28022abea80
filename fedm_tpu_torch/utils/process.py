"""Multi-process utilities: only process zero prints or writes (the
reference's MPI rank-0 gate). Process zero is `torch.distributed` rank 0,
or the process itself when no process group is initialised."""

from __future__ import annotations

from typing import List

import torch.distributed as dist


def is_process_zero() -> bool:
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


def print_process_0(*args, **kwargs) -> None:
    if is_process_zero():
        print(*args, **kwargs)


def comma_separated(strings: List[str]) -> str:
    return ", ".join(f"'{s}'" for s in strings)
