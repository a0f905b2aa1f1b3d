"""Deterministic fault injection (the port's copy of ``runtime/faults.py``).

A seeded :class:`FaultPlan` is installed process-wide
(:func:`install_fault_plan`), and the serving paths probe named injection
points. Rules fire by COUNT windows (probes ``after`` .. ``after + count``
at that point and model); probabilistic rules draw from a
``random.Random(seed)`` owned by the plan, so the same plan over the same
request sequence replays the same fault timeline. Sleep-class rules
(``latency_s`` > 0) sleep at the probe, the others raise
:class:`InjectedFault`.

The port probes these points:

  ==============  ============================================ =======
  point           probed from                                  effect
  ==============  ============================================ =======
  launch          StagedChannel.launch, before the launcher     raise
  slow_launch     StagedChannel.launch, before the launcher     sleep
  readback        InferFuture resolve, before the host copy     raise
  batcher_stall   the batchers' group execution                 sleep
  codec_decode    kserve codec.parse_infer_request              raise
  replica_down    _Servicer ServerReady/ModelReady/_issue       flag
  shm_detach      _Servicer, before a request's parse           flag
  ==============  ============================================ =======

``replica_down`` and ``shm_detach`` are flag-class (:func:`probe_flag`):
the caller owns the failure's shape. The servicer keys ``replica_down``
by its ``replica_of`` label and then answers as a dead process would
(not ready, ``UNAVAILABLE`` with no drain marker). ``shm_detach`` keys
by model; the port's server has no shared-memory registry to drop, so
the probe only counts. The JAX package's quality_corrupt and
temporal_overskip points belong to layers not ported yet.

With no plan installed a probe is one ``is None`` check.
"""

from __future__ import annotations

import json
import random
import threading
import time
from dataclasses import dataclass, field


class InjectedFault(RuntimeError):
    """The error raised at a faulted injection point. A distinct type
    so tests can assert the failure they see is the one they planned,
    not an incidental bug."""


@dataclass
class FaultRule:
    """One injection rule: fire at ``point`` (optionally only for
    ``model``) on probe numbers ``after`` <= n < ``after + count``,
    each firing gated by ``prob``. ``latency_s`` sleeps instead of
    raising for the sleep-class points (slow_launch/batcher_stall)."""

    point: str
    model: str | None = None
    after: int = 0
    count: int = 1
    prob: float = 1.0
    latency_s: float = 0.0
    message: str = "injected fault"
    # runtime state: probes observed / fires executed (not config)
    seen: int = field(default=0, compare=False)
    fired: int = field(default=0, compare=False)


class FaultPlan:
    """A seeded set of :class:`FaultRule`\\ s with thread-safe probes."""

    def __init__(self, rules=(), seed: int = 0) -> None:
        self.rules = [
            r if isinstance(r, FaultRule) else FaultRule(**dict(r))
            for r in rules
        ]
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
        self._lock = threading.Lock()
        self.fired: list[tuple[str, str | None]] = []

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        """Build from the CLI/file form::

            {"seed": 7, "rules": [{"point": "launch", "model": "m",
                                   "after": 2, "count": 3}]}
        """
        doc = json.loads(text)
        return cls(rules=doc.get("rules", ()), seed=doc.get("seed", 0))

    def check(self, point: str, model: str | None = None) -> float:
        """Consult the plan at ``point`` for ``model``. Returns a sleep
        duration (0.0 = no sleep) or raises :class:`InjectedFault`.
        Counting and RNG draws happen under the plan lock so concurrent
        probes see one deterministic global order per (point, model)."""
        sleep_s = 0.0
        raise_msg = None
        with self._lock:
            for rule in self.rules:
                if rule.point != point:
                    continue
                if rule.model is not None and rule.model != model:
                    continue
                n = rule.seen
                rule.seen += 1
                if not (rule.after <= n < rule.after + rule.count):
                    continue
                if rule.prob < 1.0 and self._rng.random() >= rule.prob:
                    continue
                rule.fired += 1
                self.fired.append((point, model))
                if rule.latency_s > 0:
                    sleep_s = max(sleep_s, rule.latency_s)
                else:
                    raise_msg = rule.message
        if raise_msg is not None:
            raise InjectedFault(f"{point}: {raise_msg}")
        return sleep_s

    def stats(self) -> dict:
        with self._lock:
            return {
                "seed": self.seed,
                "fired": len(self.fired),
                "rules": [
                    {
                        "point": r.point,
                        "model": r.model,
                        "seen": r.seen,
                        "fired": r.fired,
                    }
                    for r in self.rules
                ],
            }


# -- process-wide installation hook ------------------------------------------

_ACTIVE: FaultPlan | None = None


def install_fault_plan(plan: FaultPlan | None) -> FaultPlan | None:
    """Install ``plan`` process-wide (None uninstalls); returns the
    previous plan so test fixtures can restore it."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, plan
    return prev


def active_plan() -> FaultPlan | None:
    return _ACTIVE


def probe(point: str, model: str | None = None) -> None:
    """The hot-path hook: no-op (one global read) without a plan;
    otherwise consult it — sleeping faults sleep HERE, raising faults
    raise :class:`InjectedFault` out of the calling injection point."""
    plan = _ACTIVE
    if plan is None:
        return
    sleep_s = plan.check(point, model)
    if sleep_s > 0:
        time.sleep(sleep_s)


def probe_flag(point: str, model: str | None = None) -> bool:
    """Flag-class probe: True when a rule fired; never raises or sleeps.
    Same counting and seeding as :func:`probe`, so flag rules replay
    identically too."""
    plan = _ACTIVE
    if plan is None:
        return False
    try:
        plan.check(point, model)
    except InjectedFault:
        return True
    return False
