"""The overload errors and the circuit breaker of the serving stack (the
port's copy of the error classes and ``CircuitBreaker`` of
``runtime/admission.py``).

One exception per deliberate degradation decision, so a caller can tell
a shed request from a bug. :class:`CircuitBreaker` is the closed -> open
-> half-open machine the staged channel wraps around launch and
readback: consecutive failures open the circuit (fail fast, launch cache
dropped), a timed probe half-opens it, one success closes it. The
admission controller of the JAX module is not ported yet.
"""

from __future__ import annotations

import threading
import time


class OverloadError(RuntimeError):
    """Base for every deliberate degradation decision (vs a bug)."""


class AdmissionRejectedError(OverloadError):
    """Shed at the door: the queue ahead already exceeds the request's
    budget (``RESOURCE_EXHAUSTED`` on the wire)."""


class QueueFullError(AdmissionRejectedError):
    """The batcher's bounded queue is full: a fail-fast rejection instead
    of blocking the submitting thread."""


class DeadlineExpiredError(OverloadError):
    """The request's deadline passed while it was queued; it was shed
    before touching the device (``DEADLINE_EXCEEDED`` on the wire)."""


class CircuitOpenError(OverloadError):
    """The model's circuit breaker is open (recent consecutive failures);
    fail fast until the timed probe (``UNAVAILABLE`` on the wire)."""


# breaker states, as the JAX package's breaker_state gauge reads them
CLOSED, HALF_OPEN, OPEN = 0, 1, 2


class _BreakerCell:
    __slots__ = ("state", "consecutive", "opens", "open_until", "probing")

    def __init__(self) -> None:
        self.state = CLOSED
        self.consecutive = 0
        self.opens = 0
        self.open_until = 0.0
        self.probing = False


class CircuitBreaker:
    """Per-key (model) closed -> open -> half-open circuit breaker.

    ``threshold`` consecutive failures open the circuit for ``reset_s``
    seconds; the first :meth:`allow` after the window half-opens it and
    admits exactly ONE probe (other callers keep failing fast); the
    probe's success closes the circuit, its failure re-opens the window."""

    def __init__(self, threshold: int = 3, reset_s: float = 30.0) -> None:
        self._threshold = max(1, int(threshold))
        self._reset_s = max(0.0, float(reset_s))
        self._lock = threading.Lock()
        self._cells: dict[str, _BreakerCell] = {}

    def _cell(self, key: str) -> _BreakerCell:
        cell = self._cells.get(key)
        if cell is None:
            cell = self._cells[key] = _BreakerCell()
        return cell

    def allow(self, key: str, now: float | None = None) -> bool:
        """May a request for ``key`` proceed right now? False: fail fast
        with :class:`CircuitOpenError` without touching the device."""
        if now is None:
            now = time.perf_counter()
        with self._lock:
            # the cell exists even while healthy, so states() reports an
            # explicit CLOSED for every model this breaker guards
            cell = self._cell(key)
            if cell.state == CLOSED:
                return True
            if cell.state == OPEN:
                if now < cell.open_until:
                    return False
                cell.state = HALF_OPEN
                cell.probing = True
                return True  # this caller IS the probe
            # HALF_OPEN: one probe in flight at a time
            if cell.probing:
                return False
            cell.probing = True
            return True

    def record_success(self, key: str) -> None:
        with self._lock:
            cell = self._cells.get(key)
            if cell is None:
                return
            cell.state = CLOSED
            cell.consecutive = 0
            cell.probing = False

    def record_failure(self, key: str, now: float | None = None) -> bool:
        """Count one failure; True when this failure OPENED the circuit
        (the caller then drops its launch cache)."""
        if now is None:
            now = time.perf_counter()
        with self._lock:
            cell = self._cell(key)
            cell.consecutive += 1
            was_open = cell.state == OPEN
            if cell.state == HALF_OPEN or cell.consecutive >= self._threshold:
                cell.state = OPEN
                cell.open_until = now + self._reset_s
                cell.probing = False
                if not was_open:
                    cell.opens += 1
                    return True
        return False

    def state(self, key: str) -> int:
        with self._lock:
            cell = self._cells.get(key)
            return CLOSED if cell is None else cell.state

    def states(self) -> dict:
        """{key: {"state": 0|1|2, "opens": n, "consecutive": n}}."""
        with self._lock:
            return {
                k: {"state": c.state, "opens": c.opens, "consecutive": c.consecutive}
                for k, c in self._cells.items()
            }
