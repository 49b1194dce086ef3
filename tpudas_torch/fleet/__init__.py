"""The stream round engine and the multi-array fleet: configuration,
runner, driver loop, :class:`FleetEngine` and its batched executor.
The rolling runner is not ported yet."""

from tpudas_torch.fleet.config import StreamConfig, StreamSpec
from tpudas_torch.fleet.engine import (
    LowpassStreamRunner,
    PollJitter,
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
    "StepResult",
    "StreamConfig",
    "StreamRunner",
    "StreamSpec",
    "build_runner",
    "drive",
    "run_fleet",
]
