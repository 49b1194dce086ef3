"""Stream configuration: the dataclass the realtime driver and the round
engine share.

The port's copy of the JAX package's ``fleet/config.py`` (same fields,
same validation, so a configuration reads the same in both packages).
:class:`StreamConfig` holds every processing/config parameter of the
realtime drivers, with ``kind`` selecting the driver semantics
(``"lowpass"`` — the carried-state low-pass decimator, optionally
joint with a rolling product — or ``"rolling"``, the stateless per-file
rolling mean).  Run-control arguments (``max_rounds``,
``sleep_fn``, ``on_round``, ``counters``) are not configuration: they
belong to whoever drives the rounds, so they stay function arguments.

:class:`StreamSpec` binds one stream's identity to its config: a
``stream_id`` (a directory name and URL segment), the ``source`` spool
to poll, and optionally an explicit ``output_folder``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

__all__ = ["StreamConfig", "StreamSpec"]

_KINDS = ("lowpass", "rolling")

_STREAM_ID_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,63}$")


@dataclass
class StreamConfig:
    """Per-stream processing configuration (see the driver docstring
    in :mod:`tpudas_torch.proc.streaming` for each knob's semantics).
    ``None`` keeps a knob's driver default, so
    ``StreamConfig(kind="lowpass", start_time=...,
    output_sample_interval=1.0, edge_buffer=8.0, process_patch_size=40)``
    behaves exactly like the bare driver call."""

    kind: str = "lowpass"
    # -- common ---------------------------------------------------------
    distance: object = None
    poll_interval: object = None  # lowpass: 125.0; rolling: file_duration
    file_duration: object = None  # lowpass: 0.0; rolling: 30.0
    engine: object = None
    mesh: object = None
    fault_policy: object = None
    quarantine: bool = True
    pyramid: object = None  # None -> TPUDAS_PYRAMID (on at 1)
    detect: object = None
    detect_operators: object = None
    poll_jitter: object = None  # fraction; None -> TPUDAS_POLL_JITTER/0
    flight: object = None  # None -> TPUDAS_FLIGHT (on unless 0)
    live: object = None  # live push hub; None -> TPUDAS_LIVE (on at 1)
    # -- lowpass only ---------------------------------------------------
    start_time: object = None
    output_sample_interval: object = None
    edge_buffer: object = None
    process_patch_size: object = None
    on_gap: object = None
    filter_order: object = None
    data_gap_tolerance: object = None
    window_dp: object = None
    rolling_output_folder: object = None
    rolling_window: object = None
    rolling_step: object = None
    stateful: object = None
    carry_save_every: object = None
    health: object = None  # None -> TPUDAS_HEALTH (on at 1)
    # -- rolling only ---------------------------------------------------
    window: object = None
    step: object = None
    scale: float = 1.0

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(
                f"StreamConfig.kind must be one of {_KINDS}, got "
                f"{self.kind!r}"
            )
        if self.kind == "lowpass":
            missing = [
                k
                for k in (
                    "start_time",
                    "output_sample_interval",
                    "edge_buffer",
                    "process_patch_size",
                )
                if getattr(self, k) is None
            ]
            if missing:
                raise ValueError(
                    "lowpass StreamConfig requires "
                    + ", ".join(missing)
                )
            if self.rolling_output_folder is None and (
                self.rolling_window is not None
                or self.rolling_step is not None
            ):
                raise ValueError(
                    "rolling_window/rolling_step require "
                    "rolling_output_folder (the joint-pipeline switch) "
                    "— without it no rolling product would be written"
                )
        else:
            if self.window is None or self.step is None:
                raise ValueError(
                    "rolling StreamConfig requires window and step"
                )


@dataclass
class StreamSpec:
    """One fleet member: identity + source + config.

    ``stream_id`` doubles as the directory name under the fleet root
    and the ``/s/<stream_id>/`` URL segment, so it is restricted to
    ``[A-Za-z0-9._-]`` (must not start with a dot: dot-dirs beside the
    streams are bookkeeping).
    """

    stream_id: str
    source: str
    # required: there is no constructible default StreamConfig (every
    # kind has mandatory fields), so omitting it must fail on the
    # missing argument, not inside StreamConfig.__post_init__
    config: StreamConfig
    output_folder: object = None  # default: <fleet_root>/<stream_id>

    def __post_init__(self):
        if not _STREAM_ID_RE.match(str(self.stream_id)):
            raise ValueError(
                f"stream_id {self.stream_id!r} must match "
                f"{_STREAM_ID_RE.pattern} (it names a directory and a "
                "URL segment)"
            )
        if not isinstance(self.config, StreamConfig):
            raise TypeError(
                "StreamSpec.config must be a StreamConfig, got "
                f"{type(self.config).__name__}"
            )

    def resolve_output_folder(self, root) -> str:
        import os

        if self.output_folder is not None:
            return str(self.output_folder)
        return os.path.join(str(root), str(self.stream_id))
