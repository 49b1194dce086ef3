"""Bad-file quarantine: the ``.quarantine.json`` ledger.

The port's own copy of :mod:`tpudas.resilience.quarantine`, with the
same file name and format (one crc32-stamped JSON object, ``.prev``
double buffer), so a ledger written by either package loads in the
other.

A source file that repeatedly fails to scan or read is almost always
one of two things at an unattended site: a file the interrogator is
STILL WRITING (transient — it will complete), or a file that was
truncated/corrupted for good (permanent).  Distinguishing them from
inside one polling round is impossible, so the ledger does it across
rounds: every failure is a strike; at ``threshold`` strikes the file is
quarantined — excluded from the spool index so the round loop stops
paying for it — and re-probed on a slow schedule (``retry_interval``,
doubling per re-quarantine up to 8x) in case the interrogator finished
writing it late.  Release depends on where the failure surfaced
(``source``): a SCAN-sourced entry is released the moment its scan
passes again; a READ-sourced entry (scan fine, payload bad) is marked
``probe_pending`` and released only when the probing round COMPLETES —
a failed probe read re-quarantines with the entry's backoff history
(``rounds``) intact, so the doubling escalation survives the probe.

The ledger lives beside the stream carry in the OUTPUT folder (one
JSON object, crc32-stamped and written tmp-then-rename), so the
crash-only contract holds: kill the driver anywhere and
the next run reloads the same quarantine state.  A corrupt ledger
degrades to empty (logged + counted) — quarantine is an optimization,
never a reason to die.
"""

from __future__ import annotations

import os
import time

from tpudas_torch.obs.registry import get_registry
from tpudas_torch.utils.logging import log_event

__all__ = ["QUARANTINE_FILENAME", "QuarantineLedger"]

QUARANTINE_FILENAME = ".quarantine.json"
_VERSION = 1
_MAX_BACKOFF_ROUNDS = 3  # retry interval doubles per round, capped at 8x


class QuarantineLedger:
    """Per-file failure strikes and quarantine state, persisted as
    ``.quarantine.json`` in ``folder``.  Entries are keyed by the
    source file's basename (the spool excludes by basename)."""

    def __init__(self, folder: str):
        self.folder = str(folder)
        self._entries: dict[str, dict] = {}
        self._load()

    # -- persistence ---------------------------------------------------
    @property
    def path(self) -> str:
        return os.path.join(self.folder, QUARANTINE_FILENAME)

    def _load(self) -> None:
        """Verified-read ladder: checksummed primary, then the
        ``.prev`` double buffer, then empty (counted) — quarantine is
        an optimization, never a reason to die."""
        from tpudas_torch.integrity.checksum import (
            count_fallback,
            count_unstamped,
            read_json_verified,
        )

        primary = self.path
        if not os.path.isfile(primary) and not os.path.isfile(
            primary + ".prev"
        ):
            return
        for cand in (primary, primary + ".prev"):
            try:
                raw, status = read_json_verified(cand, "quarantine")
                if status == "mismatch":
                    raise ValueError("ledger checksum mismatch")
                if status == "unstamped":
                    count_unstamped("quarantine")
                if raw.get("version") != _VERSION:
                    log_event(
                        "quarantine_version_skew", got=raw.get("version")
                    )
                    return
                files = raw.get("files", {})
                if not isinstance(files, dict):
                    raise ValueError("files is not a mapping")
                self._entries = {
                    str(k): dict(v) for k, v in files.items()
                }
                return
            except FileNotFoundError:
                continue
            except (OSError, ValueError, TypeError, AttributeError) as exc:
                # a torn/corrupt rung falls through the ladder
                log_event(
                    "quarantine_ledger_unreadable", path=cand,
                    error=str(exc)[:200],
                )
                get_registry().counter(
                    "tpudas_quarantine_ledger_unreadable_total",
                    "corrupt quarantine ledgers degraded to .prev or "
                    "empty",
                ).inc()
                count_fallback("quarantine", str(exc)[:120], cand)
                continue
        self._entries = {}

    def _save(self) -> None:
        from tpudas_torch.integrity.checksum import (
            rotate_prev,
            write_json_checksummed,
        )

        payload = {"version": _VERSION, "files": self._entries}
        try:
            rotate_prev(self.path)
            write_json_checksummed(self.path, payload)
        except OSError as exc:
            # read-only output dir: ledger stays in-memory for this run
            log_event("quarantine_ledger_write_failed", error=str(exc)[:200])

    # -- queries -------------------------------------------------------
    @property
    def quarantined_count(self) -> int:
        return sum(1 for e in self._entries.values() if e.get("quarantined"))

    def quarantined_names(self) -> list[str]:
        return sorted(
            n for n, e in self._entries.items() if e.get("quarantined")
        )

    def entry(self, name_or_path: str) -> dict | None:
        return self._entries.get(os.path.basename(name_or_path))

    def excluded(self, now: float | None = None) -> frozenset:
        """Basenames to exclude from the spool index right now:
        quarantined files whose slow-retry probe window has not opened
        yet."""
        now = time.time() if now is None else float(now)
        return frozenset(
            n
            for n, e in self._entries.items()
            if e.get("quarantined") and now < float(e.get("retry_at", 0.0))
        )

    def probe_open_names(self, now: float | None = None) -> list[str]:
        """Quarantined basenames whose retry window is open (the spool
        will include them this round as a probe)."""
        now = time.time() if now is None else float(now)
        return sorted(
            n
            for n, e in self._entries.items()
            if e.get("quarantined") and now >= float(e.get("retry_at", 0.0))
        )

    def probe_pending_names(self) -> list[str]:
        """Quarantined basenames whose probe is riding the current
        round (see :meth:`mark_probe_pending`)."""
        return sorted(
            n
            for n, e in self._entries.items()
            if e.get("quarantined") and e.get("probe_pending")
        )

    # -- mutations -----------------------------------------------------
    def mark_probe_pending(self, name_or_path: str) -> None:
        """Flag a read-sourced quarantined entry as probing via the
        CURRENT round: its payload is about to be read again.  The
        caller releases it when the round completes (the read
        succeeded); a failure clears the flag and re-quarantines with
        escalation — the entry (and its backoff ``rounds``) survives
        the probe either way."""
        e = self._entries.get(os.path.basename(str(name_or_path)))
        if e is not None and not e.get("probe_pending"):
            e["probe_pending"] = True
            self._save()

    def record_failure(
        self,
        path: str,
        error: str,
        now: float | None = None,
        threshold: int = 3,
        retry_interval: float = 900.0,
        source: str = "read",
    ) -> str | None:
        """One strike against ``path``.  ``source`` records where the
        failure surfaced (``"scan"`` — the index scan; ``"read"`` — a
        payload read), which decides how a later probe can release the
        entry.  Returns ``"added"`` when this strike newly quarantined
        the file, ``"requarantined"`` after a failed probe, else None.
        """
        now = time.time() if now is None else float(now)
        name = os.path.basename(str(path))
        e = self._entries.setdefault(
            name,
            {
                "fails": 0,
                "first_failed_at": now,
                "quarantined": False,
                "rounds": 0,
            },
        )
        e["fails"] = int(e.get("fails", 0)) + 1
        e["last_failed_at"] = now
        e["last_error"] = str(error)[:300]
        e["source"] = str(source)
        e["probe_pending"] = False
        outcome = None
        was_probe = bool(e.get("quarantined")) and now >= float(
            e.get("retry_at", 0.0)
        )
        if was_probe or (
            not e.get("quarantined") and e["fails"] >= int(threshold)
        ):
            # quarantine (or re-quarantine after a failed probe) with a
            # doubling, capped retry interval
            e["quarantined"] = True
            e["rounds"] = rounds = int(e.get("rounds", 0)) + 1
            wait = float(retry_interval) * (
                2 ** min(rounds - 1, _MAX_BACKOFF_ROUNDS)
            )
            e["retry_at"] = now + wait
            outcome = "requarantined" if was_probe else "added"
            log_event(
                "quarantine_added",
                file=name,
                fails=e["fails"],
                rounds=rounds,
                retry_in_s=round(wait, 1),
                error=e["last_error"],
            )
        self._save()
        return outcome

    def record_success(self, name_or_path: str) -> bool:
        """A read/scan of the file succeeded: release it entirely
        (strikes included — a once-flaky file earns a clean slate).
        Returns True when an entry was removed."""
        name = os.path.basename(str(name_or_path))
        e = self._entries.pop(name, None)
        if e is None:
            return False
        if e.get("quarantined"):
            log_event("quarantine_released", file=name, fails=e.get("fails"))
            get_registry().counter(
                "tpudas_stream_quarantine_released_total",
                "quarantined files released after a successful probe",
            ).inc()
        self._save()
        return True
