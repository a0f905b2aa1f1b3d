"""The overload errors of the serving stack (the port's copy of the
error classes of ``runtime/admission.py``).

One exception per deliberate degradation decision, so a caller can tell
a shed request from a bug. The admission controller and the circuit
breaker of the JAX module are not ported yet.
"""

from __future__ import annotations


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
