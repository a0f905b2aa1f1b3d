"""Admission control, the overload errors and the circuit breaker of the
serving stack (the port's copy of ``runtime/admission.py``).

One exception per deliberate degradation decision, so a caller can tell
a shed request from a bug; each maps to the gRPC status code the client
retry ladder keys on (``runtime/server._grpc_code``).
:class:`AdmissionController` is the per-model queue-depth gate the
server consults before parsing a request: a request that finds its
model's queue at the limit is rejected at the door.
:class:`CircuitBreaker` is the closed -> open -> half-open machine the
staged channel wraps around launch and readback: consecutive failures
open the circuit (fail fast, launch cache dropped), a timed probe
half-opens it, one success closes it.
"""

from __future__ import annotations

import threading
import time


class OverloadError(RuntimeError):
    """Base for every deliberate degradation decision (vs a bug)."""


class AdmissionRejectedError(OverloadError):
    """Shed at the door: the model's queue is at its limit
    (``RESOURCE_EXHAUSTED`` on the wire)."""


class QueueFullError(AdmissionRejectedError):
    """The batcher's bounded queue is full: a fail-fast rejection instead
    of blocking the submitting thread."""


class DeadlineExpiredError(OverloadError):
    """The request's deadline passed while it was queued; it was shed
    before touching the device (``DEADLINE_EXCEEDED`` on the wire)."""


class CircuitOpenError(OverloadError):
    """The model's circuit breaker is open (recent consecutive failures);
    fail fast until the timed probe (``UNAVAILABLE`` on the wire)."""


class ServerDrainingError(OverloadError):
    """The server is draining (SIGTERM / ``drain()``): in-flight work
    completes, new work is refused (``UNAVAILABLE`` on the wire)."""


class ReplicaDownError(OverloadError):
    """Injected replica death (the ``replica_down`` fault point): the
    server answers as if its process were gone, ``UNAVAILABLE`` with no
    drain marker. Only fault plans raise this."""


class AdmissionController:
    """Per-model bounded queue-depth admission.

    ``max_queue``: cap on a model's admitted-but-unfinished requests (the
    knee for priority >= 0; lower priorities hit ``max_queue *
    low_priority_fraction``). The JAX module's estimated-wait check (a
    service-time EWMA against the request's deadline budget) waits for the
    SLO plane, the only producer of deadlines, and its per-tenant caps for
    the tenant table (ROADMAP.md Queue 1 item 8)."""

    def __init__(self, max_queue: int = 64, low_priority_fraction: float = 0.5) -> None:
        self._max_queue = max(1, int(max_queue))
        self._low_frac = min(1.0, max(0.05, float(low_priority_fraction)))
        self._lock = threading.Lock()
        self._inflight: dict[str, int] = {}
        self._rejects: dict[tuple[str, int], int] = {}
        self._admitted = 0

    def admit(self, model: str, priority: int = 0) -> None:
        """Admit or raise :class:`AdmissionRejectedError`. An admitted
        request counts against the model's queue until :meth:`finished`,
        which the caller must reach on every exit path."""
        with self._lock:
            depth = self._inflight.get(model, 0)
            limit = self._max_queue
            if priority < 0:
                # the background class sheds first
                limit = max(1, int(limit * self._low_frac))
            if depth >= limit:
                key = (model, int(priority))
                self._rejects[key] = self._rejects.get(key, 0) + 1
                raise AdmissionRejectedError(
                    f"model '{model}' overloaded: queue depth {depth} >= limit {limit} "
                    f"(priority {priority})"
                )
            self._inflight[model] = depth + 1
            self._admitted += 1

    def finished(self, model: str) -> None:
        """One admitted request left (any outcome)."""
        with self._lock:
            depth = self._inflight.get(model, 0)
            if depth > 0:
                self._inflight[model] = depth - 1

    def stats(self) -> dict:
        with self._lock:
            return {
                "max_queue": self._max_queue,
                "admitted": self._admitted,
                "inflight": dict(self._inflight),
                "rejects": {f"{m}|{p}": n for (m, p), n in self._rejects.items()},
            }


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
