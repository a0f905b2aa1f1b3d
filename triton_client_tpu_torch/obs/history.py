"""Metric history ring: per-model x tenant rate, busy share and MFU over
time (the port's copy of ``obs/history.py``).

A fixed-interval ring of entries, each the delta of the
``DeviceTimeLedger``'s cumulative account over the interval::

  {"t": unix_seconds, "interval_s": ...,
   "utilization": window busy ratio,
   "models": {"model|tenant": {"launches_per_s": ...,
                               "device_s_per_s": ...,
                               "mfu": ...}}}

served at ``GET /history`` (``?n=K``: the K most recent) and persisted to
JSON when the server stops, so a restart reads the same shape back.
``attach_quality`` adds a ``quality`` row per tick where a quality plane
exists (none is ported).

The ring is bounded (``capacity`` intervals, default 360 x 10 s = 1 h) and
``tick()`` is dict arithmetic on two ledger snapshots: no device work, safe
on the timer thread.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from collections import deque

log = logging.getLogger(__name__)


class MetricHistory:
    """Fixed-interval ring of serving-rate snapshots.

    ``ledger``: an ``obs.device_time.DeviceTimeLedger``. ``interval_s``:
    entry spacing; ``capacity``: ring depth. The thread starts only on
    :meth:`start`; :meth:`tick` takes an entry directly (``now``: the
    ``perf_counter`` reading the interval is measured to, for an injected
    clock)."""

    def __init__(self, ledger=None, interval_s: float = 10.0, capacity: int = 360) -> None:
        self._ledger = ledger
        self._quality = None
        self.interval_s = max(0.5, float(interval_s))
        self.capacity = max(2, int(capacity))
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.capacity)
        self._last: dict | None = None
        self._last_t = time.perf_counter()
        self._ticks = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def attach_quality(self, quality) -> None:
        """A quality plane whose ``history_row()`` lands on every tick."""
        self._quality = quality

    # -- recording -------------------------------------------------------------

    def tick(self, now: float | None = None) -> dict | None:
        """One entry: the ledger's account diffed against the previous tick,
        as rates. Returns the appended entry (None without a ledger)."""
        if self._ledger is None:
            return None
        try:
            snap = self._ledger.snapshot()
        except Exception:
            log.exception("history tick: ledger snapshot failed")
            return None
        t = time.perf_counter() if now is None else float(now)
        with self._lock:
            prev, prev_t = self._last, self._last_t
            self._last, self._last_t = snap, t
            dt = max(t - prev_t, 1e-9) if prev is not None else None
            entry = self._entry(snap, prev, dt)
            if self._quality is not None:
                try:
                    entry["quality"] = self._quality.history_row()
                except Exception:
                    log.debug("history tick: quality row failed", exc_info=True)
            self._ring.append(entry)
            self._ticks += 1
        return entry

    @staticmethod
    def _entry(snap: dict, prev: dict | None, dt: float | None) -> dict:
        """One entry from consecutive ledger snapshots. The first tick has
        no baseline: its rates are 0, the busy share and MFU still export
        (they are window gauges)."""
        window = snap.get("window") or {}
        mfu = window.get("mfu") or {}
        device_s = snap.get("device_seconds") or {}
        launches = snap.get("launches") or {}
        prev_device = (prev or {}).get("device_seconds") or {}
        prev_launches = (prev or {}).get("launches") or {}
        models: dict[str, dict] = {}
        for key, total in device_s.items():
            model = key.split("|", 1)[0]
            d_dev = total - prev_device.get(key, 0.0) if dt else 0.0
            d_launch = launches.get(model, 0) - prev_launches.get(model, 0) if dt else 0
            models[key] = {
                "launches_per_s": (d_launch / dt) if dt else 0.0,
                "device_s_per_s": (d_dev / dt) if dt else 0.0,
                "mfu": float(mfu.get(model, 0.0)),
            }
        return {
            "t": time.time(),
            "interval_s": dt or 0.0,
            "utilization": float(window.get("utilization", 0.0)),
            "models": models,
        }

    # -- reading ---------------------------------------------------------------

    def snapshots(self, n: int = 0) -> list[dict]:
        """The most recent ``n`` entries (0: all), oldest first."""
        with self._lock:
            entries = list(self._ring)
        if n and n > 0:
            entries = entries[-n:]
        return entries

    def stats(self) -> dict:
        with self._lock:
            return {
                "interval_s": self.interval_s,
                "capacity": self.capacity,
                "buffered": len(self._ring),
                "ticks": self._ticks,
            }

    # -- persistence -----------------------------------------------------------

    def persist(self, path: str) -> int:
        """Write the ring to ``path`` as JSON; returns the entry count."""
        doc = {"interval_s": self.interval_s, "persisted_at": time.time(),
               "snapshots": self.snapshots()}
        with open(path, "w") as fh:
            json.dump(doc, fh)
        return len(doc["snapshots"])

    @staticmethod
    def load(path: str) -> dict:
        """Read a persisted history document."""
        with open(path) as fh:
            return json.load(fh)

    def restore(self, doc: dict) -> int:
        """Seed the ring from a persisted document (its newest entries when
        it holds more than the capacity)."""
        entries = list(doc.get("snapshots") or [])
        with self._lock:
            for e in entries[-self.capacity:]:
                self._ring.append(e)
        return min(len(entries), self.capacity)

    # -- background loop -------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, name="metric-history", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.tick()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
