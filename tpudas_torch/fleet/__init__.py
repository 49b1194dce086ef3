"""The stream round engine and the multi-array fleet: configuration,
runners (low-pass and rolling), driver loop, :class:`FleetEngine` and
its batched executor."""

from tpudas_torch.fleet.config import StreamConfig, StreamSpec
from tpudas_torch.fleet.engine import (
    LowpassStreamRunner,
    PollJitter,
    RollingStreamRunner,
    StepResult,
    StreamRunner,
    build_runner,
    drive,
)
from tpudas_torch.fleet.fleet import FleetEngine, run_fleet

__all__ = [
    "FleetEngine",
    "LowpassStreamRunner",
    "PollJitter",
    "RollingStreamRunner",
    "StepResult",
    "StreamConfig",
    "StreamRunner",
    "StreamSpec",
    "build_runner",
    "drive",
    "run_fleet",
]
