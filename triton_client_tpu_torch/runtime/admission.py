"""Admission control, the overload errors and the circuit breaker of the
serving stack (the port's copy of ``runtime/admission.py``).

One exception per deliberate degradation decision, so a caller can tell
a shed request from a bug; each maps to the gRPC status code the client
retry ladder keys on (``runtime/server._grpc_code``).
:class:`AdmissionController` is the per-model gate the server consults
before parsing a request: a request that finds its model's queue at the
limit, or whose estimated queue wait already eats its deadline budget, is
rejected at the door (rejecting in microseconds beats timing out after
taking a device slot).
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
    """Shed at the door: the model's queue is at its limit, or the
    estimated wait exceeds the deadline budget (``RESOURCE_EXHAUSTED`` on
    the wire)."""


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
    """Per-model bounded queue-depth and estimated-wait admission.

    ``max_queue``: cap on a model's admitted-but-unfinished requests (the
    knee for priority >= 0; lower priorities hit ``max_queue *
    low_priority_fraction``). ``concurrency``: how many requests the
    serving stack works on at once for a model (batcher width x pipeline
    depth, roughly); it divides the estimated wait, so a healthy batched
    server is not over-shed. The service-time estimate is an EWMA over
    completed requests, seeded by the first; until then only the depth knee
    applies."""

    def __init__(
        self,
        max_queue: int = 64,
        concurrency: int = 4,
        low_priority_fraction: float = 0.5,
        ewma_alpha: float = 0.2,
        tenants=None,
    ) -> None:
        """``tenants``: an optional ``runtime/lifecycle.TenantTable``. With
        one, a tenant's ``max_inflight`` caps admitted-but-unfinished
        requests across its models, on top of the per-model knees: a tenant
        flooding its models sheds at its own cap instead of taking the whole
        server's queue."""
        self._max_queue = max(1, int(max_queue))
        self._concurrency = max(1, int(concurrency))
        self._low_frac = min(1.0, max(0.05, float(low_priority_fraction)))
        self._alpha = min(1.0, max(0.01, float(ewma_alpha)))
        self._tenants = tenants
        self._lock = threading.Lock()
        self._inflight: dict[str, int] = {}
        self._tenant_inflight: dict[str, int] = {}
        self._tenant_rejects: dict[str, int] = {}
        self._ewma_s: dict[str, float] = {}
        self._rejects: dict[tuple[str, int], int] = {}
        self._admitted = 0

    def _tenant_of(self, model: str) -> str | None:
        return None if self._tenants is None else self._tenants.tenant_of(model)

    def admit(
        self,
        model: str,
        deadline_s: float | None = None,
        priority: int = 0,
        now: float | None = None,
    ) -> None:
        """Admit or raise :class:`AdmissionRejectedError`: the model's queue
        is at its limit, or the estimated wait (queue depth x service-time
        EWMA / concurrency) exceeds what is left of ``deadline_s``, the
        request's absolute ``perf_counter`` deadline. An admitted request
        counts against the model's queue (and its tenant's cap) until
        :meth:`finished`, which the caller must reach on every exit path."""
        tenant = self._tenant_of(model)
        with self._lock:
            depth = self._inflight.get(model, 0)
            limit = self._max_queue
            if priority < 0:
                # the background class sheds first
                limit = max(1, int(limit * self._low_frac))
            reason = None
            if depth >= limit:
                reason = f"queue depth {depth} >= limit {limit} (priority {priority})"
            if reason is None and tenant is not None:
                cap = self._tenants.max_inflight(tenant)
                t_depth = self._tenant_inflight.get(tenant, 0)
                if cap > 0 and t_depth >= cap:
                    reason = f"tenant '{tenant}' in-flight {t_depth} >= cap {cap}"
            if reason is None and deadline_s is not None:
                ewma = self._ewma_s.get(model)
                if ewma is not None:
                    if now is None:
                        now = time.perf_counter()
                    est_wait = depth * ewma / self._concurrency
                    budget = deadline_s - now
                    if est_wait > budget:
                        reason = (
                            f"estimated queue wait {est_wait * 1e3:.1f}ms "
                            f"exceeds deadline budget {budget * 1e3:.1f}ms"
                        )
            if reason is not None:
                key = (model, int(priority))
                self._rejects[key] = self._rejects.get(key, 0) + 1
                if tenant is not None:
                    self._tenant_rejects[tenant] = self._tenant_rejects.get(tenant, 0) + 1
                raise AdmissionRejectedError(f"model '{model}' overloaded: {reason}")
            self._inflight[model] = depth + 1
            if tenant is not None:
                self._tenant_inflight[tenant] = self._tenant_inflight.get(tenant, 0) + 1
            self._admitted += 1

    def finished(self, model: str, service_s: float | None = None) -> None:
        """One admitted request left (any outcome). ``service_s`` (wall
        seconds, successful requests only) feeds the EWMA the
        estimated-wait check divides by."""
        tenant = self._tenant_of(model)
        with self._lock:
            depth = self._inflight.get(model, 0)
            if depth > 0:
                self._inflight[model] = depth - 1
            if tenant is not None:
                t_depth = self._tenant_inflight.get(tenant, 0)
                if t_depth > 0:
                    self._tenant_inflight[tenant] = t_depth - 1
            if service_s is not None and service_s >= 0:
                prev = self._ewma_s.get(model)
                self._ewma_s[model] = (
                    service_s if prev is None else prev + self._alpha * (service_s - prev)
                )

    def estimated_wait_s(self, model: str) -> float:
        with self._lock:
            ewma = self._ewma_s.get(model)
            if ewma is None:
                return 0.0
            return self._inflight.get(model, 0) * ewma / self._concurrency

    def stats(self) -> dict:
        with self._lock:
            return {
                "max_queue": self._max_queue,
                "concurrency": self._concurrency,
                "admitted": self._admitted,
                "inflight": dict(self._inflight),
                "ewma_ms": {m: round(v * 1e3, 3) for m, v in self._ewma_s.items()},
                "rejects": {f"{m}|{p}": n for (m, p), n in self._rejects.items()},
                "tenant_inflight": dict(self._tenant_inflight),
                "tenant_rejects": dict(self._tenant_rejects),
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
