"""Utilities: structured logging, profiling counters."""

from tpudas_torch.utils.logging import log_event, set_log_handler
from tpudas_torch.utils.profiling import Counters, Timer

__all__ = ["log_event", "set_log_handler", "Timer", "Counters"]
