"""The edge health snapshot's schema (``health.json``).

The part of :mod:`tpudas.obs.health` the integrity audit needs to check
a ``health.json`` that the JAX driver may have written into an output
folder: its file name and :func:`validate_health`.  The writers
(``write_health``, ``write_prom``) and ``read_health`` come with the
health files themselves; until then the port writes no snapshot.
"""

from __future__ import annotations

__all__ = [
    "HEALTH_FILENAME",
    "HEALTH_REQUIRED_KEYS",
    "HEALTH_SCHEMA_VERSION",
    "validate_health",
]

HEALTH_FILENAME = "health.json"
# the JAX package's schema 3: the degradation fields (schema 2) and the
# integrity fields integrity_fallbacks and resource_degraded
HEALTH_SCHEMA_VERSION = 3

# keys every snapshot carries
HEALTH_REQUIRED_KEYS = (
    "schema",
    "written_at",
    "rounds",
    "polls",
    "mode",
    "realtime_factor",
    "round_realtime_factor",
    "head_lag_seconds",
    "redundant_ratio",
    "carry_resume_count",
    "last_round_wall_seconds",
    "consecutive_failures",
    "quarantined_files",
    "degraded",
    "last_error",
    "integrity_fallbacks",
    "resource_degraded",
)


def validate_health(payload: dict) -> dict:
    """Raise ``ValueError`` unless ``payload`` carries every required
    key and a known schema version; returns the payload."""
    missing = [k for k in HEALTH_REQUIRED_KEYS if k not in payload]
    if missing:
        raise ValueError(f"health payload missing keys: {missing}")
    if payload["schema"] != HEALTH_SCHEMA_VERSION:
        raise ValueError(
            f"unknown health schema {payload['schema']!r} "
            f"(expected {HEALTH_SCHEMA_VERSION})"
        )
    return payload
