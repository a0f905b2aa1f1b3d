"""SLO attainment accounting and tail-exemplar sampling (the port's copy of
``obs/slo.py``).

The server stamps each request's deadline at admission
(``_Servicer._issue``), the batcher and the staged channel carry it, and
this module scores the outcome once a request, on every exit path, in the
``finally``-rooted accounting that also feeds the error counter.

- **Attainment counters**: met/missed per (model, priority), read through
  ``RuntimeCollector.snapshot()["slo"]`` and exported as
  ``tpu_serving_slo_requests_total``. A request with neither a deadline nor
  a configured budget is not scored (an SLO-less server must not report
  100% attainment).
- **Tail sampler**: a bounded ring of whole ``RequestTrace`` exemplars,
  kept only for requests that missed their SLO or landed at or above the
  live p99 of their model's e2e histogram, served at
  ``/traces?slo_violations=1``.
- **Per-model budgets**: ``slo_ms`` is the default; ``per_model``
  overrides single models.
"""

from __future__ import annotations

import collections
import threading
import time

# below this many e2e observations the p99 is not trusted, and the tail
# sampler keeps only hard SLO misses
_MIN_P99_SAMPLES = 100


class SLOTracker:
    """Scores one finished request per :meth:`observe_request` call."""

    def __init__(
        self,
        slo_ms: float = 0.0,
        per_model: dict[str, float] | None = None,
        tail_capacity: int = 64,
        histograms=None,
    ) -> None:
        """``slo_ms``: default latency budget (0: none; requests are then
        scored only when they carry a deadline). ``per_model``: model name
        -> budget ms. ``histograms``: the serving ``HistogramFamily``, whose
        live (model, e2e) p99 also qualifies traces for the tail ring."""
        self._slo_s = max(0.0, float(slo_ms)) / 1e3
        self._per_model_s = {str(m): max(0.0, float(v)) / 1e3 for m, v in (per_model or {}).items()}
        self._hist = histograms
        self._lock = threading.Lock()
        # (model, priority) -> [met, missed]
        self._counts: dict[tuple[str, int], list[int]] = {}
        self._tail: collections.deque = collections.deque(maxlen=max(1, int(tail_capacity)))
        self._tail_retained = 0
        self._deadline_missed = 0

    # -- configuration ---------------------------------------------------------

    @property
    def enabled(self) -> bool:
        return self._slo_s > 0 or bool(self._per_model_s)

    def slo_s(self, model: str) -> float:
        """The latency budget of ``model`` in seconds (0: none)."""
        return self._per_model_s.get(str(model), self._slo_s)

    def set_budget(self, slo_ms: float, model: str | None = None) -> None:
        """Re-arm the default (or one model's) budget on a live tracker.
        Scored requests keep their verdicts; later admissions see the new
        budget."""
        v = max(0.0, float(slo_ms)) / 1e3
        if model is None:
            self._slo_s = v
        else:
            self._per_model_s[str(model)] = v

    def deadline_for(self, model: str, t0: float) -> float | None:
        """Absolute ``perf_counter`` deadline of a request admitted at
        ``t0`` (what ``_Servicer._issue`` stamps on the InferRequest); None
        when the model has no budget."""
        budget = self.slo_s(model)
        return t0 + budget if budget > 0 else None

    # -- scoring ---------------------------------------------------------------

    def observe_request(
        self,
        model: str,
        wall_s: float,
        deadline_s: float | None = None,
        priority: int = 0,
        status: str = "ok",
        trace=None,
        now: float | None = None,
    ) -> None:
        """Score one finished request. ``deadline_s``, the absolute deadline
        stamped at admission, decides when present; otherwise ``wall_s`` is
        held to the model's budget. A failed request (``status != "ok"``)
        counts as missed."""
        budget = self.slo_s(model)
        if deadline_s is None and budget <= 0:
            # no SLO for this request: it still feeds the tail sampler's p99
            # criterion, never the attainment counters
            self._maybe_retain(model, wall_s, missed=False, trace=trace)
            return
        if now is None:
            now = time.perf_counter()
        if deadline_s is not None:
            missed = now > deadline_s
        else:
            missed = wall_s > budget
        if status != "ok":
            missed = True
        key = (str(model), int(priority))
        with self._lock:
            cell = self._counts.get(key)
            if cell is None:
                cell = self._counts[key] = [0, 0]
            cell[1 if missed else 0] += 1
            if missed:
                self._deadline_missed += 1
        self._maybe_retain(model, wall_s, missed=missed, trace=trace)

    def _maybe_retain(self, model, wall_s, missed, trace) -> None:
        if trace is None:
            return
        keep = missed
        if not keep and self._hist is not None:
            try:
                if (
                    self._hist.count(model, "e2e") >= _MIN_P99_SAMPLES
                    and wall_s >= self._hist.quantile(model, "e2e", 0.99)
                ):
                    keep = True
            except Exception:
                keep = False  # observability never fails the request
        if keep:
            with self._lock:
                self._tail.append(trace)
                self._tail_retained += 1

    # -- reading ---------------------------------------------------------------

    def violations(self, n: int = 0) -> list:
        """The most recent ``n`` retained exemplar traces (0: all), oldest
        first: the ``/traces?slo_violations=1`` payload."""
        with self._lock:
            traces = list(self._tail)
        return traces[-n:] if n else traces

    def stats(self) -> dict:
        """Numeric-leaved dict for ``RuntimeCollector.snapshot()``:
        attainment keyed ``"model|priority"``, so ``delta()`` windows it."""
        with self._lock:
            by_key = {
                f"{m}|{p}": {"met": c[0], "missed": c[1]}
                for (m, p), c in sorted(self._counts.items())
            }
            met = sum(c[0] for c in self._counts.values())
            missed = sum(c[1] for c in self._counts.values())
            return {
                "slo_ms": self._slo_s * 1e3,
                "met": met,
                "missed": missed,
                "requests": by_key,
                "tail_buffered": len(self._tail),
                "tail_retained": self._tail_retained,
            }

    def attainment(self) -> float:
        """Share of scored requests that met their SLO (1.0 when none has
        been scored)."""
        with self._lock:
            met = sum(c[0] for c in self._counts.values())
            total = met + sum(c[1] for c in self._counts.values())
        return met / total if total else 1.0
