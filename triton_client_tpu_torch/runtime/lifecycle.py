"""Multi-tenant model lifecycle: device-memory paging, warm/cold states,
quotas (the port's copy of ``runtime/lifecycle.py``).

A server that registers more models than fit on its card at once keeps
them COLD until asked for, pages them in on demand and pages them out
under pressure. :class:`ModelLifecycleManager` owns that policy. Each
registered model moves through

    COLD ──acquire──▶ WARMING ──warm hook──▶ WARM
      ▲                                        │
      └────────── evict hook ◀── EVICTING ◀────┘  (budget pressure)

* **promotion**: the first acquirer of a COLD model claims the WARMING
  transition, makes room under the budget, runs the channel's warm hook
  (``StagedChannel._warm_model``: builds the launcher and captures the
  graphs of the route the model serves through), then broadcasts WARM.
  Concurrent acquirers wait with a deadline-aware bound instead of
  erroring, so a cold model's first request pays the promotion and the
  requests queued behind it ride along.
* **eviction**: LRU crossed with a pinned/priority tier. Candidates are
  WARM, unpinned, idle (``inflight == 0``) models, lowest ``priority``
  first, least recently used inside a tier. A model with in-flight work
  is never evicted (acquire/release brackets stage -> resolve). On the
  card the evict hook (``StagedChannel._evict_model``) drops the model's
  cached launchers and releases every CUDA graph it captured, with the
  graphs' private memory pools.
* **budget accounting**: a model's cost starts at
  ``spec.extra["param_bytes"]`` (``runtime/precision.py`` records it), or a
  configurable default; the channel rebases it with :meth:`note_cost` to
  ``param_bytes`` plus the live bytes of the model's graph pools once it
  has captured. The room a promotion makes is counted as resident from
  the moment it is made, so two promotions that run at once cannot both
  fit into the same free bytes. A cost that grows makes room again under
  the same rules: before WARM (the page-in captured), or while WARM (a
  ``device_fn`` model captures at its first launch, and any model at a new
  input key).
* **tenancy**: a :class:`TenantTable` (``tenants.yaml``) maps models to
  tenants with device-memory quotas, request-rate shares and in-flight
  caps. Quotas are enforced here (a tenant over its quota evicts its own
  models first and cannot displace another tenant's), shares feed the
  continuous scheduler's deficit-round-robin ordering
  (``runtime/continuous.py``), and in-flight caps layer onto the admission
  controller (``runtime/admission.py``).

Stdlib and ``obs/histogram`` only; the fast path (acquire of a WARM
model) is one lock, two dict reads and a counter bump.
"""

from __future__ import annotations

import dataclasses
import threading
import time

from triton_client_tpu_torch.obs.histogram import LatencyHistogram
from triton_client_tpu_torch.runtime.admission import (
    AdmissionRejectedError,
    DeadlineExpiredError,
)

# lifecycle states, exported as the tpu_serving_lifecycle_models gauge
COLD, WARMING, WARM, EVICTING = 0, 1, 2, 3
STATE_NAMES = {COLD: "cold", WARMING: "warming", WARM: "warm", EVICTING: "evicting"}

#: Cost assumed for a model that declares no ``param_bytes``: 64 MiB.
#: Deliberately conservative: an unmeasured model should not look free.
DEFAULT_COST_BYTES = 64 << 20

#: Default tenant every unmapped model bills to.
DEFAULT_TENANT = "default"


class HBMBudgetExceededError(AdmissionRejectedError):
    """A promotion could not fit under the device-memory budget (every
    resident model is pinned or has in-flight work). RESOURCE_EXHAUSTED on
    the wire, like any other shed."""


@dataclasses.dataclass(frozen=True)
class TenantPolicy:
    """One tenant's serving policy (a ``tenants.yaml`` entry)."""

    name: str
    #: deficit-round-robin weight in the continuous scheduler's ready
    #: ordering; relative, so (4, 1) and (8, 2) mean the same split
    share: float = 1.0
    #: ceiling on this tenant's resident model bytes (0 = unlimited; the
    #: global budget still applies)
    hbm_quota_bytes: int = 0
    #: admitted-but-unfinished request cap across the tenant's models
    #: (0 = no per-tenant cap; per-model caps still apply)
    max_inflight: int = 0
    #: model names billed to this tenant
    models: tuple = ()
    #: models never evicted while this policy is active
    pinned: frozenset = frozenset()


class TenantTable:
    """model name -> :class:`TenantPolicy`, plus the lookups the scheduler
    and the admission controller key on. Unmapped models bill to
    ``default`` (share ``default_share``, no quota)."""

    def __init__(self, policies: list[TenantPolicy], default_share: float = 1.0) -> None:
        self._policies: dict[str, TenantPolicy] = {}
        self._by_model: dict[str, str] = {}
        for pol in policies:
            self._policies[pol.name] = pol
            for model in pol.models:
                self._by_model[str(model)] = pol.name
        if DEFAULT_TENANT not in self._policies:
            self._policies[DEFAULT_TENANT] = TenantPolicy(
                name=DEFAULT_TENANT, share=float(default_share))

    def tenant_of(self, model_name: str) -> str:
        return self._by_model.get(model_name, DEFAULT_TENANT)

    def policy(self, tenant: str) -> TenantPolicy:
        return self._policies.get(tenant, self._policies[DEFAULT_TENANT])

    def share(self, tenant: str) -> float:
        return max(1e-6, float(self.policy(tenant).share))

    def max_inflight(self, tenant: str) -> int:
        return int(self.policy(tenant).max_inflight)

    def pinned(self, model_name: str) -> bool:
        return model_name in self.policy(self.tenant_of(model_name)).pinned

    def tenants(self) -> list[str]:
        return sorted(self._policies)

    def describe(self) -> dict:
        return {
            name: {
                "share": pol.share,
                "hbm_quota_bytes": pol.hbm_quota_bytes,
                "max_inflight": pol.max_inflight,
                "models": list(pol.models),
                "pinned": sorted(pol.pinned),
            }
            for name, pol in self._policies.items()
        }


def parse_tenants(doc: dict) -> TenantTable:
    """Build a :class:`TenantTable` from a parsed ``tenants.yaml``::

        tenants:
          crop-inspection:
            share: 4            # DRR weight in the ready ordering
            hbm_quota_mb: 256   # resident-bytes ceiling (0 = none)
            max_inflight: 32    # admitted-but-unfinished cap (0 = none)
            models: [yolov5_crop, yolov5_weed]
            pinned: [yolov5_crop]
          batch-analytics:
            share: 1
            models: [centerpoint]

    Unknown top-level or per-tenant keys raise ``ValueError`` (the
    config.yaml discipline of ``runtime/disk_repository.py``)."""
    allowed_top = {"tenants", "default_share"}
    unknown = set(doc) - allowed_top
    if unknown:
        raise ValueError(f"tenants config: unknown top-level keys {sorted(unknown)} "
                         f"(allowed: {sorted(allowed_top)})")
    allowed = {"share", "hbm_quota_mb", "hbm_quota_bytes", "max_inflight", "models", "pinned"}
    policies = []
    for name, body in (doc.get("tenants") or {}).items():
        body = dict(body or {})
        unknown = set(body) - allowed
        if unknown:
            raise ValueError(f"tenant '{name}': unknown keys {sorted(unknown)} "
                             f"(allowed: {sorted(allowed)})")
        quota = int(body.get("hbm_quota_bytes", 0) or 0)
        if not quota and body.get("hbm_quota_mb"):
            quota = int(float(body["hbm_quota_mb"]) * (1 << 20))
        policies.append(TenantPolicy(
            name=str(name),
            share=float(body.get("share", 1.0)),
            hbm_quota_bytes=quota,
            max_inflight=int(body.get("max_inflight", 0) or 0),
            models=tuple(str(m) for m in body.get("models") or ()),
            pinned=frozenset(str(m) for m in body.get("pinned") or ()),
        ))
    return TenantTable(policies, default_share=float(doc.get("default_share", 1.0)))


def load_tenants(path: str) -> TenantTable:
    """Parse a ``tenants.yaml`` file (read with the port's ``yaml_subset``)
    into a :class:`TenantTable`."""
    from triton_client_tpu_torch import yaml_subset

    doc = yaml_subset.load(path) or {}
    if not isinstance(doc, dict):
        raise ValueError(f"tenants config {path}: expected a mapping")
    return parse_tenants(doc)


class _Entry:
    """Lifecycle state of one (name, version)."""

    __slots__ = ("state", "cost", "tenant", "pinned", "priority", "last_used", "inflight",
                 "promotions", "evictions", "charged")

    def __init__(self, cost: int, tenant: str, pinned: bool) -> None:
        self.state = COLD
        self.cost = int(cost)
        self.tenant = tenant
        self.pinned = bool(pinned)
        self.priority = 0
        self.last_used = 0
        self.inflight = 0
        self.promotions = 0
        self.evictions = 0
        # bytes counted in the resident totals: the room a promotion made,
        # until the page-out
        self.charged = 0


class ModelLifecycleManager:
    """Budgeted COLD/WARMING/WARM/EVICTING state machine over the
    repository's registered models (module docstring).

    ``budget_bytes=0`` disables budget pressure (models still move COLD ->
    WARM, so promotion latency and residency are observable, but nothing is
    evicted). ``StagedChannel.attach_lifecycle`` wires the hooks:
    ``warmer(name, version)`` pages in, ``evictor(name, version)`` pages
    out."""

    def __init__(
        self,
        repository,
        budget_bytes: int = 0,
        tenants: TenantTable | None = None,
        default_cost_bytes: int = DEFAULT_COST_BYTES,
        warming_timeout_s: float = 60.0,
    ) -> None:
        self._repository = repository
        self._budget = max(0, int(budget_bytes))
        self._tenants = tenants
        self._default_cost = max(1, int(default_cost_bytes))
        self._warming_timeout_s = max(0.1, float(warming_timeout_s))
        self._cv = threading.Condition()
        self._entries: dict[tuple[str, str], _Entry] = {}
        self._resident = 0
        self._tenant_resident: dict[str, int] = {}
        self._clock = 0  # LRU sequence, bumped on every touch
        self._warmer = None
        self._evictor = None
        self._promotion_hist = LatencyHistogram()
        self._counts = {"promotions": 0, "evictions": 0, "promotion_failures": 0}

    # -- wiring ---------------------------------------------------------------

    def set_hooks(self, warmer=None, evictor=None) -> None:
        """The channel's page-in and page-out callables."""
        if warmer is not None:
            self._warmer = warmer
        if evictor is not None:
            self._evictor = evictor

    @property
    def tenants(self) -> TenantTable | None:
        return self._tenants

    @property
    def budget_bytes(self) -> int:
        return self._budget

    # -- per-model knobs ------------------------------------------------------

    def pin(self, name: str, version: str = "", pinned: bool = True) -> None:
        """Pin (never evict) or unpin a model, on top of any tenant
        ``pinned`` list."""
        key, model = self._resolve(name, version)
        with self._cv:
            self._ensure_entry_locked(key, model).pinned = bool(pinned)

    def set_priority(self, name: str, priority: int, version: str = "") -> None:
        """Eviction tier: lower-priority models evict first; ties break
        least recently used."""
        key, model = self._resolve(name, version)
        with self._cv:
            self._ensure_entry_locked(key, model).priority = int(priority)

    def note_cost(self, name: str, version: str, nbytes: int) -> None:
        """Rebase a model's cost to measured bytes (the CUDA channel reports
        ``param_bytes`` plus its live graph-pool bytes after a capture).
        Resident accounting rebases if the model holds room (WARMING past
        its room, WARM). A cost that grew makes room again, as a promotion
        does: a WARMING model that then cannot fit raises
        :class:`HBMBudgetExceededError` (its promotion fails and pages out
        what it captured); a WARM one is serving and stays, and
        ``resident_bytes`` reads above ``budget_bytes`` until a page-out."""
        if nbytes <= 0:
            return
        with self._cv:
            ent = self._entries.get((name, version))
            if ent is None:
                return
            grew = 0 < ent.charged < int(nbytes)
            if ent.charged:
                self._charge_locked(ent, int(nbytes) - ent.charged)
            ent.cost = int(nbytes)
            warming = ent.state == WARMING
        if grew:
            self._make_room((name, version), strict=warming)

    # -- the serving-path contract -------------------------------------------

    def acquire(self, name: str, version: str = "", deadline_s: float | None = None
                ) -> tuple[str, str]:
        """Block until (name, version) is WARM, then take an in-flight
        reference protecting it from eviction. Returns the resolved
        ``(name, version)`` key for the paired :meth:`release`.

        A COLD model promotes on demand: the first acquirer claims the
        WARMING transition and pays the page-in; later acquirers wait. The
        wait is deadline-aware: a request whose ``deadline_s`` (absolute,
        ``time.perf_counter`` base) passes while warming raises
        :class:`DeadlineExpiredError`; with no deadline the wait is bounded
        by ``warming_timeout_s``. A promotion that cannot fit raises
        :class:`HBMBudgetExceededError`."""
        key, model = self._resolve(name, version)
        bound = time.perf_counter() + self._warming_timeout_s
        with self._cv:
            ent = self._ensure_entry_locked(key, model)
            while True:
                self._clock += 1
                ent.last_used = self._clock
                if ent.state == WARM:
                    ent.inflight += 1
                    return key
                if ent.state == COLD:
                    ent.state = WARMING
                    break
                # WARMING by a peer, or EVICTING: wait for the transition to
                # settle, bounded by the deadline or the timeout
                now = time.perf_counter()
                limit = bound if deadline_s is None else min(bound, deadline_s)
                if now >= limit:
                    if deadline_s is not None and now >= deadline_s:
                        raise DeadlineExpiredError(
                            f"model '{key[0]}': deadline expired while waiting for promotion")
                    raise HBMBudgetExceededError(
                        f"model '{key[0]}': promotion did not complete within "
                        f"{self._warming_timeout_s:.1f}s")
                self._cv.wait(timeout=min(0.05, limit - now))
        # this thread owns the COLD -> WARMING claim: page in outside the
        # lock (evictions and the channel's captures take time)
        t0 = time.perf_counter()
        warming = False
        try:
            self._make_room(key)  # holds the room from here on
            if self._warmer is not None:
                warming = True
                # a cost the page-in measures makes room again (note_cost)
                self._warmer(key[0], key[1])
        except BaseException:
            try:
                if warming and self._evictor is not None:
                    # what the page-in captured goes with the failed promotion
                    self._evictor(key[0], key[1])
            finally:
                with self._cv:
                    self._charge_locked(ent, -ent.charged)
                    ent.state = COLD
                    self._counts["promotion_failures"] += 1
                    self._cv.notify_all()
            raise
        with self._cv:
            ent.state = WARM
            ent.promotions += 1
            ent.inflight += 1
            self._counts["promotions"] += 1
            self._cv.notify_all()
        self._promotion_hist.observe(time.perf_counter() - t0)
        return key

    def release(self, name: str, version: str) -> None:
        """Drop one in-flight reference taken by :meth:`acquire` (the
        channel calls this when the request resolves or fails)."""
        with self._cv:
            ent = self._entries.get((name, version))
            if ent is not None and ent.inflight > 0:
                ent.inflight -= 1
                if ent.inflight == 0:
                    self._cv.notify_all()

    def prefetch(self, name: str, version: str = "") -> None:
        """Promote ahead of demand: warm a model without keeping an
        in-flight reference, so its first request pays only the queue."""
        key = self.acquire(name, version)
        self.release(*key)

    def evict(self, name: str, version: str = "") -> bool:
        """Page a model out explicitly (the operator's runbook path).
        False when the model is not resident, pinned or busy."""
        key, model = self._resolve(name, version)
        with self._cv:
            ent = self._entries.get(key)
            if (ent is None or ent.state != WARM or ent.inflight > 0
                    or self._pinned_locked(key, ent)):
                return False
            ent.state = EVICTING
        self._evict_one(key, self._entries[key])
        return True

    # -- internals ------------------------------------------------------------

    def _resolve(self, name: str, version: str):
        model = self._repository.get(name, version)
        return (model.spec.name, model.spec.version), model

    def _ensure_entry_locked(self, key, model) -> _Entry:
        ent = self._entries.get(key)
        if ent is None:
            extra = getattr(model.spec, "extra", None) or {}
            cost = int(extra.get("param_bytes", 0) or 0) or self._default_cost
            tenant = (self._tenants.tenant_of(key[0]) if self._tenants is not None
                      else DEFAULT_TENANT)
            pinned = bool(extra.get("pinned", False))
            ent = self._entries[key] = _Entry(cost, tenant, pinned)
        return ent

    def _pinned_locked(self, key, ent) -> bool:
        if ent.pinned:
            return True
        return self._tenants is not None and self._tenants.pinned(key[0])

    def _quota(self, tenant: str) -> int:
        if self._tenants is None:
            return 0
        return int(self._tenants.policy(tenant).hbm_quota_bytes)

    def fits(self, name: str, version: str = "") -> bool:
        """Whether (name, version) is resident, or would promote at its
        present cost with no eviction (``serve --warmup`` prefetches while
        this holds)."""
        key, model = self._resolve(name, version)
        with self._cv:
            ent = self._ensure_entry_locked(key, model)
            return ent.state == WARM or not any(self._over_locked(ent))

    def _over_locked(self, ent) -> tuple[bool, bool]:
        """(over its tenant's quota, over the budget) once ``ent`` holds
        room for its cost."""
        need = ent.cost - ent.charged
        quota = self._quota(ent.tenant)
        return (quota > 0 and self._tenant_resident.get(ent.tenant, 0) + need > quota,
                self._budget > 0 and self._resident + need > self._budget)

    def _charge_locked(self, ent, nbytes: int) -> None:
        """Count ``nbytes`` more (or fewer) of ``ent`` as resident."""
        if not nbytes:
            return
        ent.charged += nbytes
        self._resident += nbytes
        self._tenant_resident[ent.tenant] = self._tenant_resident.get(ent.tenant, 0) + nbytes

    def _make_room(self, key, strict: bool = True) -> None:
        """Evict until ``key`` fits its tenant quota and the global budget,
        then count its cost as resident in the same hold of the lock.
        Victims: WARM, unpinned, idle; lowest priority tier first, least
        recently used inside a tier. A tenant over its own quota may only
        displace its own models: quota pressure must not let one tenant
        flush another's working set. With no victim left, raises
        :class:`HBMBudgetExceededError`, or returns when not ``strict``."""
        ent = self._entries[key]
        quota = self._quota(ent.tenant)
        while True:
            with self._cv:
                if ent.state not in (WARMING, WARM):
                    return  # paged out meanwhile: it holds no room to grow
                over_quota, over_budget = self._over_locked(ent)
                if not over_quota and not over_budget:
                    self._charge_locked(ent, ent.cost - ent.charged)
                    return
                victim_key = self._pick_victim_locked(tenant=ent.tenant if over_quota else None)
                if victim_key is None:
                    if not strict:
                        return
                    scope = (f"tenant '{ent.tenant}' quota {quota}" if over_quota
                             else f"budget {self._budget}")
                    self._counts["promotion_failures"] += 1
                    raise HBMBudgetExceededError(
                        f"model '{key[0]}' (cost {ent.cost}B) cannot fit under {scope}: every "
                        f"resident model is pinned or has in-flight work")
                victim = self._entries[victim_key]
                victim.state = EVICTING
            self._evict_one(victim_key, victim)

    def _pick_victim_locked(self, tenant: str | None = None):
        best_key, best_rank = None, None
        for key, ent in self._entries.items():
            if ent.state != WARM or ent.inflight > 0:
                continue
            if self._pinned_locked(key, ent):
                continue
            if tenant is not None and ent.tenant != tenant:
                continue
            rank = (ent.priority, ent.last_used)
            if best_rank is None or rank < best_rank:
                best_key, best_rank = key, rank
        return best_key

    def _evict_one(self, key, ent) -> None:
        """Run the channel's page-out hook for an entry already marked
        EVICTING, then settle it COLD (a failing hook still settles: a
        broken invalidation must not wedge the state machine)."""
        try:
            if self._evictor is not None:
                self._evictor(key[0], key[1])
        finally:
            with self._cv:
                ent.state = COLD
                self._charge_locked(ent, -ent.charged)
                ent.evictions += 1
                self._counts["evictions"] += 1
                self._cv.notify_all()

    # -- reading --------------------------------------------------------------

    def state(self, name: str, version: str = "") -> int:
        key, _ = self._resolve(name, version)
        with self._cv:
            ent = self._entries.get(key)
            return COLD if ent is None else ent.state

    def stats(self) -> dict:
        """One structured read for the collector: budget and residency,
        per-state counts, per-tenant resident bytes, the promotion latency
        histogram and a per-model table."""
        with self._cv:
            states = {name: 0 for name in STATE_NAMES.values()}
            models = {}
            for (name, version), ent in self._entries.items():
                states[STATE_NAMES[ent.state]] += 1
                models[f"{name}:{version}"] = {
                    "state": STATE_NAMES[ent.state],
                    "cost_bytes": ent.cost,
                    "tenant": ent.tenant,
                    "pinned": self._pinned_locked((name, version), ent),
                    "priority": ent.priority,
                    "inflight": ent.inflight,
                    "promotions": ent.promotions,
                    "evictions": ent.evictions,
                }
            out = {
                "budget_bytes": self._budget,
                "resident_bytes": self._resident,
                "tenant_resident_bytes": dict(self._tenant_resident),
                "states": states,
                "models": models,
            }
            out.update(self._counts)
        out["promotion_latency"] = self._promotion_hist.snapshot()
        if self._tenants is not None:
            out["tenants"] = self._tenants.describe()
        return out
