"""The port's model lifecycle and tenant plane (``runtime/lifecycle.py``)
against the JAX package's, on the CPU.

Bars:

- ``parse_tenants`` / ``load_tenants`` on the JAX docstring's and
  docs/OPERATIONS.md's ``tenants.yaml``: equal ``describe()`` and lookups;
  unknown keys fail on both with the same message;
- the state machine: the same sequence of acquire / release / evict /
  prefetch / pin / set_priority / note_cost on both managers, over one fake
  repository with recording hooks, gives equal outcomes, equal ``stats()``
  (but for the promotion latency) and the same hook calls in the same
  order;
- tenant admission caps and the repository's access accounting equal
  JAX's;
- the page-out on a CPU ``CUDAChannel`` with a stand-in graph backend: an
  eviction leaves the model no live graph, no launch-cache entry and no
  pool bytes, on the ``device_fn`` route, the ragged route and the
  ``infer_fn`` route of a disk entry's pipeline; the next request captures
  again and answers bitwise as an always-resident channel does; breaker
  invalidation rebuilds; a fused ensemble's graph outlives its member's
  eviction;
- the server: the JAX live-server flow (five models, three tenants, a
  budget that fits two) through both packages' stacks, equal lifecycle
  stats, bitwise parity with an always-resident server, the pinned model,
  and the ``/snapshot`` and ``/metrics`` lines; ``serve --hbm-budget
  --tenants`` on a disk repository.
"""

from __future__ import annotations

import json
import pathlib
import threading
import time
import urllib.request
import weakref

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from triton_client_tpu.runtime import admission as jadm
from triton_client_tpu.runtime import lifecycle as jlc
from triton_client_tpu.runtime import repository as jrepo

from triton_client_tpu_torch.channel.base import InferRequest
from triton_client_tpu_torch.channel.cuda_channel import CUDAChannel
from triton_client_tpu_torch.config import ModelSpec, TensorSpec
from triton_client_tpu_torch.runtime import admission as tadm
from triton_client_tpu_torch.runtime import lifecycle as tlc
from triton_client_tpu_torch.runtime import repository as trepo
from triton_client_tpu_torch.runtime.graphs import CapturedFunction
from torch_threads import one_torch_thread  # noqa: F401

# -- tenants.yaml --------------------------------------------------------------

DOCSTRING_YAML = """tenants:
  crop-inspection:
    share: 4            # DRR weight in the ready ordering
    hbm_quota_mb: 256   # resident-bytes ceiling (0 = none)
    max_inflight: 32    # admitted-but-unfinished cap (0 = none)
    models: [yolov5_crop, yolov5_weed]
    pinned: [yolov5_crop]
  batch-analytics:
    share: 1
    models: [centerpoint]
"""

OPERATIONS_YAML = """tenants:
  crop-inspection:        # interactive: big share, pinned hot model
    share: 8
    hbm_quota_mb: 4096
    max_inflight: 64
    models: [yolov5_crop, lane_seg]
    pinned: [yolov5_crop]
  analytics:              # batch: small share, sheds first
    share: 1
    max_inflight: 16
    models: [centerpoint]
default_share: 2
"""

LOOKUP_MODELS = ("yolov5_crop", "yolov5_weed", "lane_seg", "centerpoint", "unmapped")


def _table_view(table) -> dict:
    return {
        "describe": table.describe(),
        "tenants": table.tenants(),
        "models": {m: (table.tenant_of(m), table.share(table.tenant_of(m)),
                       table.max_inflight(table.tenant_of(m)), table.pinned(m))
                   for m in LOOKUP_MODELS},
    }


ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_operations_example_is_the_documented_one():
    text = (ROOT / "docs" / "OPERATIONS.md").read_text()
    assert OPERATIONS_YAML.rsplit("default_share", 1)[0].replace("tenants:\n", "", 1) in text
    assert DOCSTRING_YAML.replace("tenants:\n", "", 1).splitlines()[0] in jlc.parse_tenants.__doc__


@pytest.mark.parametrize("text", [DOCSTRING_YAML, OPERATIONS_YAML], ids=["docstring", "operations"])
def test_load_tenants_equals_jax(tmp_path, text):
    path = tmp_path / "tenants.yaml"
    path.write_text(text)
    port, jax_ = tlc.load_tenants(str(path)), jlc.load_tenants(str(path))
    assert _table_view(port) == _table_view(jax_)
    assert port.policy("crop-inspection").hbm_quota_bytes > 0


@pytest.mark.parametrize("doc", [
    {"tenantz": {}},
    {"tenants": {"t": {"hbm_quota": 5}}},
    {"tenants": {"t": {"share": 2, "models": ["a"], "pin": ["a"]}}, "default_share": 1},
], ids=["top_level", "tenant_key", "tenant_key_beside_known"])
def test_unknown_keys_fail_on_both(doc):
    errors = []
    for mod in (jlc, tlc):
        with pytest.raises(ValueError) as e:
            mod.parse_tenants(doc)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_load_tenants_needs_a_mapping(tmp_path):
    path = tmp_path / "tenants.yaml"
    path.write_text("- a\n- b\n")
    for mod in (jlc, tlc):
        with pytest.raises(ValueError, match="expected a mapping"):
            mod.load_tenants(str(path))


# -- the state machine ---------------------------------------------------------


class _Spec:
    def __init__(self, name, version, extra):
        self.name, self.version, self.extra = name, version, extra


class _Model:
    def __init__(self, name, version="1", param_bytes=100):
        self.spec = _Spec(name, version, {"param_bytes": param_bytes})


class FakeRepository:
    """What a manager reads of a repository: ``get(name, version)``."""

    def __init__(self, names, param_bytes=100):
        self.models = {n: _Model(n, param_bytes=param_bytes) for n in names}

    def get(self, name, version=""):
        if name not in self.models:
            raise KeyError(f"model '{name}' is not registered")
        return self.models[name]


def _tables(mod):
    return {
        "none": None,
        "quota": mod.TenantTable([mod.TenantPolicy(name="small", hbm_quota_bytes=150,
                                                   models=("s1", "s2")),
                                  mod.TenantPolicy(name="big", models=("b1",))]),
        "pinned": mod.TenantTable([mod.TenantPolicy(name="gold", models=("a", "b"),
                                                    pinned=frozenset({"a"}))]),
    }


# name -> (models, budget, tenant table, ops). An op is (verb, *args):
# acquire/release/evict/prefetch/pin/set_priority/note_cost as the managers
# take them; release pops the newest reference taken on the model.
CASES = {
    "lru": (("a", "b", "c"), 250, "none", [
        ("acquire", "a"), ("release", "a"), ("acquire", "b"), ("release", "b"),
        ("acquire", "c"), ("release", "c"), ("acquire", "a"), ("release", "a")]),
    "priority_tier": (("lo", "hi", "new"), 250, "none", [
        ("acquire", "lo"), ("release", "lo"), ("acquire", "hi"), ("release", "hi"),
        ("set_priority", "lo", -1), ("acquire", "lo"), ("release", "lo"),
        ("acquire", "new"), ("release", "new")]),
    "pinned": (("a", "b"), 150, "none", [
        ("pin", "a"), ("acquire", "a"), ("release", "a"), ("acquire", "b"),
        ("pin", "a", False), ("acquire", "b"), ("release", "b")]),
    "tenant_pinned": (("a", "b", "c"), 150, "pinned", [
        ("acquire", "a"), ("release", "a"), ("acquire", "b"), ("acquire", "c"),
        ("evict", "a"), ("evict", "c")]),
    "inflight": (("a", "b"), 150, "none", [
        ("acquire", "a"), ("acquire", "b"), ("release", "a"), ("acquire", "b"),
        ("release", "b")]),
    "rebase": (("a", "b"), 10_000, "none", [
        ("acquire", "a"), ("release", "a"), ("note_cost", "a", "1", 900),
        ("note_cost", "b", "1", 50), ("acquire", "b"), ("note_cost", "b", "1", 0),
        ("release", "b")]),
    "rebase_over_budget": (("a", "b", "c"), 1000, "none", [
        ("acquire", "a"), ("release", "a"), ("note_cost", "a", "1", 800),
        ("acquire", "b"), ("release", "b"), ("acquire", "c"), ("release", "c")]),
    "tenant_quota": (("s1", "s2", "b1"), 10_000, "quota", [
        ("acquire", "b1"), ("release", "b1"), ("acquire", "s1"), ("release", "s1"),
        ("acquire", "s2"), ("release", "s2")]),
    "prefetch_evict": (("a",), 0, "none", [
        ("prefetch", "a"), ("evict", "a"), ("evict", "a"), ("pin", "a"), ("prefetch", "a"),
        ("evict", "a"), ("acquire", "missing")]),
}


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # the outcome under comparison, error class included
        return (type(e).__name__, str(e))


def _run_case(mod, case):
    models, budget, table, ops = CASES[case]
    calls = []
    mgr = mod.ModelLifecycleManager(FakeRepository(models), budget_bytes=budget,
                                    tenants=_tables(mod)[table])
    mgr.set_hooks(warmer=lambda n, v: calls.append(("warm", n, v)),
                  evictor=lambda n, v: calls.append(("evict", n, v)))
    held: dict[str, list] = {}
    outcomes = []
    for verb, name, *rest in ops:
        if verb == "acquire":
            out = _outcome(lambda: mgr.acquire(name))
            if out[0] == "ok":
                held.setdefault(name, []).append(out[1])
        elif verb == "release":
            out = _outcome(lambda: mgr.release(*held[name].pop()))
        elif verb == "pin":
            out = _outcome(lambda: mgr.pin(name, pinned=rest[0] if rest else True))
        elif verb == "set_priority":
            out = _outcome(lambda: mgr.set_priority(name, rest[0]))
        elif verb == "note_cost":
            out = _outcome(lambda: mgr.note_cost(name, *rest))
        else:
            out = _outcome(lambda: getattr(mgr, verb)(name))
        outcomes.append((verb, name, out))
    stats = mgr.stats()
    latency = stats.pop("promotion_latency")
    states = {n: mgr.state(n) for n in models}
    return outcomes, stats, calls, latency["count"], states


@pytest.mark.parametrize("case", sorted(CASES))
def test_state_machine_equals_jax(case):
    port, jax_ = _run_case(tlc, case), _run_case(jlc, case)
    assert port == jax_
    assert port[3] == port[1]["promotions"]


def test_state_machine_cases_page():
    """The cases exercise what they are named for (on the port)."""
    _, s, calls, _, _ = _run_case(tlc, "lru")
    assert s["models"]["a:1"]["evictions"] == 1 and s["resident_bytes"] == 200
    assert ("evict", "a", "1") in calls
    _, s, _, _, _ = _run_case(tlc, "priority_tier")
    assert s["models"]["lo:1"]["state"] == "cold" and s["models"]["hi:1"]["state"] == "warm"
    out, s, _, _, _ = _run_case(tlc, "pinned")
    assert out[3][2][0] == "HBMBudgetExceededError" and s["models"]["a:1"]["state"] == "cold"
    out, _, _, _, _ = _run_case(tlc, "inflight")
    assert out[1][2][0] == "HBMBudgetExceededError" and out[3][2][0] == "ok"
    _, s, _, _, _ = _run_case(tlc, "rebase")
    assert s["models"]["a:1"]["cost_bytes"] == 900 and s["resident_bytes"] == 1000
    _, s, _, _, _ = _run_case(tlc, "tenant_quota")
    assert s["models"]["s1:1"]["state"] == "cold" and s["models"]["b1:1"]["state"] == "warm"
    assert s["tenant_resident_bytes"]["small"] == 100
    out, _, _, _, _ = _run_case(tlc, "prefetch_evict")
    assert [o[2][1] for o in out[1:3]] == [True, False] and out[5][2] == ("ok", False)


@pytest.mark.parametrize("mod", [jlc, tlc], ids=["jax", "port"])
def test_deadline_expires_while_warming(mod):
    """A request whose deadline passes while a peer promotes the model
    raises DeadlineExpiredError; the promotion then completes."""
    mgr = mod.ModelLifecycleManager(FakeRepository(("slow",)), budget_bytes=0)
    gate = threading.Event()
    mgr.set_hooks(warmer=lambda n, v: gate.wait(timeout=5.0), evictor=lambda n, v: None)
    first = threading.Thread(target=mgr.acquire, args=("slow",), daemon=True)
    first.start()
    bound = time.monotonic() + 5.0
    while mgr.state("slow") != mod.WARMING and time.monotonic() < bound:
        time.sleep(0.005)
    assert mgr.state("slow") == mod.WARMING
    t0 = time.perf_counter()
    with pytest.raises(mod.DeadlineExpiredError, match="while waiting for promotion"):
        mgr.acquire("slow", deadline_s=t0 + 0.1)
    assert time.perf_counter() - t0 < 2.0
    gate.set()
    first.join(timeout=5.0)
    assert not first.is_alive() and mgr.state("slow") == mod.WARM
    assert mgr.stats()["models"]["slow:1"]["inflight"] == 1


def test_concurrent_acquires_promote_once():
    """Eight threads acquire one cold model: one promotion, eight references;
    every join is bounded."""
    mgr = tlc.ModelLifecycleManager(FakeRepository(("m",)), budget_bytes=0)
    warms = []
    mgr.set_hooks(warmer=lambda n, v: (warms.append(n), time.sleep(0.05)))
    keys = []
    threads = [threading.Thread(target=lambda: keys.append(mgr.acquire("m")), daemon=True)
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10.0)
    assert not any(t.is_alive() for t in threads)
    assert warms == ["m"] and len(keys) == 8
    assert mgr.stats()["models"]["m:1"]["inflight"] == 8


def test_a_promotion_holds_its_room_while_it_warms():
    """Two cold models promote at once under a budget that fits one: the
    first's room counts as resident from the moment it is made, so the
    second cannot fit into the same bytes while the first warms; once the
    first is WARM and idle, the second evicts it. Resident bytes never pass
    the budget. Every wait is bounded."""
    mgr = tlc.ModelLifecycleManager(FakeRepository(("a", "b")), budget_bytes=150)
    gate, seen = threading.Event(), []

    def warmer(name, version):
        seen.append(mgr.stats()["resident_bytes"])
        if name == "a":
            gate.wait(timeout=5.0)

    mgr.set_hooks(warmer=warmer, evictor=lambda n, v: seen.append(mgr.stats()["resident_bytes"]))
    first = threading.Thread(target=mgr.prefetch, args=("a",), daemon=True)
    first.start()
    bound = time.monotonic() + 5.0
    while mgr.state("a") != tlc.WARMING and time.monotonic() < bound:
        time.sleep(0.005)
    assert mgr.state("a") == tlc.WARMING and mgr.stats()["resident_bytes"] == 100
    assert not mgr.fits("b")
    with pytest.raises(tlc.HBMBudgetExceededError):
        mgr.prefetch("b")
    gate.set()
    first.join(timeout=5.0)
    assert not first.is_alive() and mgr.state("a") == tlc.WARM
    mgr.prefetch("b")
    s = mgr.stats()
    assert (mgr.state("a"), mgr.state("b")) == (tlc.COLD, tlc.WARM)
    assert s["resident_bytes"] == 100 and max(seen) <= 150
    assert s["promotion_failures"] == 2  # counted by the room and by the promotion, as JAX


@pytest.mark.parametrize("grow_in", ["warming", "warm"])
def test_a_cost_that_grows_makes_room(grow_in):
    """A cost noted above the room a model holds makes room again: while
    WARMING (the page-in captured) and while WARM (a ``device_fn`` model's
    first launch captures). With nothing left to evict, a WARMING model's
    promotion fails and pages out; a WARM one stays over the budget."""
    mgr = tlc.ModelLifecycleManager(FakeRepository(("a", "b", "c")), budget_bytes=1000)
    calls = []

    def warmer(name, version):
        calls.append(("warm", name))
        if grow_in == "warming":
            mgr.note_cost(name, version, 600)

    def grow(name):
        key = mgr.acquire(name)
        if grow_in == "warm":
            mgr.note_cost(*key, 600)
        mgr.release(*key)

    mgr.set_hooks(warmer=warmer, evictor=lambda n, v: calls.append(("evict", n)))
    grow("a")
    grow("b")
    s = mgr.stats()
    assert calls == [("warm", "a"), ("warm", "b"), ("evict", "a")]
    assert s["resident_bytes"] == 600 <= s["budget_bytes"]
    mgr.pin("b")
    if grow_in == "warming":
        with pytest.raises(tlc.HBMBudgetExceededError):
            grow("c")  # fits at its 100 B estimate, not at the 600 B it measures
        assert calls[-2:] == [("warm", "c"), ("evict", "c")]
        s = mgr.stats()
        assert s["models"]["c:1"]["state"] == "cold" and s["resident_bytes"] == 600
    else:
        grow("c")
        s = mgr.stats()
        assert calls[-1] == ("warm", "c") and s["models"]["c:1"]["state"] == "warm"
        assert s["resident_bytes"] == 1200 > s["budget_bytes"]


# -- tenant admission ------------------------------------------------------------

ADMISSION_CASES = {
    "cap": ([("small", 2, ("a", "b"))],
            [("admit", "a"), ("admit", "b"), ("admit", "a"), ("finished", "a"), ("admit", "a"),
             ("admit", "other"), ("finished", "b"), ("finished", "b"), ("finished", "b")]),
    "unmapped_uncapped": ([("small", 1, ("a",))],
                          [("admit", "other")] * 10 + [("admit", "a"), ("admit", "a")]),
    "two_tenants": ([("gold", 3, ("g",)), ("bronze", 1, ("z1", "z2"))],
                    [("admit", "z1"), ("admit", "z2"), ("admit", "g"), ("admit", "g"),
                     ("finished", "z1"), ("admit", "z2"), ("admit", "g"), ("admit", "g")]),
}


def _admission(mod, lmod, case):
    policies, ops = ADMISSION_CASES[case]
    table = lmod.TenantTable([lmod.TenantPolicy(name=n, max_inflight=cap, models=models)
                              for n, cap, models in policies])
    gate = mod.AdmissionController(max_queue=64, tenants=table)
    outcomes = [_outcome(lambda: getattr(gate, verb)(model)) for verb, model in ops]
    return outcomes, gate.stats()


@pytest.mark.parametrize("case", sorted(ADMISSION_CASES))
def test_tenant_admission_equals_jax(case):
    port, jax_ = _admission(tadm, tlc, case), _admission(jadm, jlc, case)
    assert port == jax_
    if case == "cap":
        assert port[0][2][0] == "AdmissionRejectedError" and "tenant 'small'" in port[0][2][1]
        assert port[1]["tenant_rejects"] == {"small": 1}


def test_repository_access_stats_equal_jax():
    stats = []
    for mod in (jrepo, trepo):
        repo = mod.ModelRepository()
        for name in ("a", "b"):
            for version in ("1", "2"):
                if mod is jrepo:
                    from triton_client_tpu.config import ModelSpec as JSpec

                    repo.register(JSpec(name=name, version=version), lambda x: x)
                else:
                    repo.register(ModelSpec(name=name, version=version), lambda x: x)
        for name, version in (("a", ""), ("b", "1"), ("a", "2"), ("a", "")):
            repo.get(name, version)
        with pytest.raises(KeyError):
            repo.get("c")
        stats.append(repo.access_stats())
    assert stats[0] == stats[1] == {"a": {"count": 3, "last_seq": 4},
                                    "b": {"count": 1, "last_seq": 2}}


# -- the page-out on a CPU channel ---------------------------------------------


class _Graph:
    """A stand-in graph: a replay recomputes the body into the static
    outputs, as a graph rewrites its static buffers."""

    def __init__(self, fn, inputs, outputs):
        self.fn, self.inputs, self.outputs = fn, inputs, outputs

    def __call__(self):
        for static, new in zip(pytree.tree_leaves(self.outputs),
                               pytree.tree_leaves(self.fn(*self.inputs))):
            static.copy_(new)


class Backend:
    """Records every graph it captured (weakly), and the owners it was told
    to forget."""

    POOL_BYTES = 4096

    def __init__(self):
        self.graphs: list[tuple[str, weakref.ref]] = []
        self.forgotten: list[str] = []

    def warmup(self, fn, inputs, times):
        for _ in range(times):
            fn(*inputs)

    def capture(self, fn, inputs, owner):
        outputs = fn(*inputs)
        graph = _Graph(fn, inputs, outputs)
        self.graphs.append((owner.name, weakref.ref(graph)))
        return graph, outputs, self.POOL_BYTES

    def forget(self, owner):
        self.forgotten.append(owner.name)

    def live(self, prefix: str) -> list[str]:
        return [n for n, ref in self.graphs if ref() is not None and n.startswith(prefix)]


X = np.arange(8, dtype=np.float32).reshape(2, 4)


def _spec(name, param_bytes=100):
    return ModelSpec(name=name, version="1", max_batch_size=8,
                     inputs=(TensorSpec("x", (-1, 4), "FP32"),),
                     outputs=(TensorSpec("y", (-1, 4), "FP32"),),
                     extra={"param_bytes": param_bytes})


def _register(repo, name, k, backend=None, route="device_fn", fail=()):
    """y = k * x + 1, on the ``device_fn`` route, or on the ``infer_fn``
    route of a disk entry (a captured body with ``graph_stats``,
    ``release_graphs`` and a ``warmup`` that captures batch 2). The body
    raises while ``fail`` holds a true value."""

    def body(x):
        if fail and fail[0]:
            raise RuntimeError(f"{name}: injected failure")
        return {"y": x * k + 1.0}

    def ragged(inputs, segment_ids, num_segments):
        return {"y": inputs["x"] * k + 1.0}

    if route == "device_fn":
        repo.register(_spec(name), lambda inputs: body(torch.as_tensor(inputs["x"])),
                      device_fn=lambda inputs: body(inputs["x"]), ragged_fn=ragged)
        return None
    jit = CapturedFunction(body, name, backend=backend)

    def infer_fn(inputs):
        return jit(inputs["x"])

    infer_fn.graph_stats = jit.stats
    infer_fn.release_graphs = jit.release
    repo.register(_spec(name), infer_fn,
                  warmup=lambda: jit(torch.zeros((2, 4), dtype=torch.float32)))
    return jit


MODELS = (("a", 2.0), ("b", 3.0), ("c", 4.0))


def _paged_pair(route, budget=None):
    """A paged channel (budget: two of the three models, at their measured
    cost) and an always-resident one over the same models."""
    backend = Backend()
    repos = trepo.ModelRepository(), trepo.ModelRepository()
    jits = {}
    for name, k in MODELS:
        jits[name] = _register(repos[0], name, k, backend, route)
        _register(repos[1], name, k, Backend(), route)
    chan, ref = CUDAChannel(repos[0], "cpu"), CUDAChannel(repos[1], "cpu")
    chan.graph_backend = backend
    ref.graph_backend = Backend()
    # measured cost: param_bytes + one key's pool; two fit, three do not
    cost = 100 + Backend.POOL_BYTES
    mgr = tlc.ModelLifecycleManager(repos[0], budget_bytes=budget or 2 * cost + 50)
    chan.attach_lifecycle(mgr)
    return chan, ref, mgr, backend, jits


@pytest.mark.parametrize("route", ["device_fn", "infer_fn"])
def test_eviction_releases_graphs_and_repromotion_answers_bitwise(route):
    chan, ref, mgr, backend, jits = _paged_pair(route)
    rng = np.random.default_rng(11)
    schedule = [n for n, _ in MODELS] * 3
    rng.shuffle(schedule)
    schedule += ["a", "b", "c"]
    for name in schedule:
        x = rng.standard_normal((2, 4)).astype(np.float32)
        got = chan.do_inference(InferRequest(name, {"x": x})).outputs["y"]
        want = ref.do_inference(InferRequest(name, {"x": x})).outputs["y"]
        assert got.tobytes() == want.tobytes()
        s = mgr.stats()
        assert s["resident_bytes"] <= s["budget_bytes"]
        for model, row in s["models"].items():
            n = model.split(":")[0]
            if row["state"] == "cold":
                assert not backend.live(n), (n, backend.live(n))
                assert not [k for k in chan._launch_cache if k[0] == n]
                if jits[n] is not None:
                    assert jits[n].stats()["keys"] == jits[n].stats()["pool_bytes"] == 0
            else:
                assert len(backend.live(n)) == 1
    s = mgr.stats()
    assert s["promotions"] >= 5 and s["evictions"] >= 3
    assert {row["cost_bytes"] for row in s["models"].values()} == {100 + Backend.POOL_BYTES}
    assert len(backend.graphs) == s["promotions"]  # every promotion captured once, anew
    assert sorted(set(backend.forgotten)) == sorted(
        f"{n}:1" if route == "device_fn" else n for n, _ in MODELS)
    if route == "infer_fn":
        # the page-in ran the entry's warmup: the first request replayed
        assert jits["a"].stats()["captures"] == s["models"]["a:1"]["promotions"]


def test_a_first_launch_that_captures_makes_room():
    """On the ``device_fn`` route a model captures at its first launch,
    after it turned WARM: the launch notes its cost and makes room then.
    The budget fits two models at their measured cost and a third at its
    estimate, so every third promotion evicts from inside a launch."""
    chan, ref, mgr, backend, _ = _paged_pair("device_fn", budget=2 * (100 + Backend.POOL_BYTES)
                                             + 150)
    for i, name in enumerate(["a", "b", "c", "a", "b", "c"]):
        x = np.full((2, 4), i, np.float32)
        got = chan.do_inference(InferRequest(name, {"x": x})).outputs["y"]
        assert got.tobytes() == ref.do_inference(InferRequest(name, {"x": x})).outputs["y"].tobytes()
        s = mgr.stats()
        assert s["resident_bytes"] <= s["budget_bytes"], s
        assert sum(row["state"] == "warm" for row in s["models"].values()) == min(i + 1, 2)
    assert mgr.stats()["evictions"] == 4


def test_a_promotion_beside_a_serving_model_changes_no_answer():
    """One thread keeps a pinned WARM model busy while the main thread pages
    two others in and out (each promotion captures and evicts, each eviction
    releases graphs and empties the cache): every answer of both stays
    bitwise equal to an always-resident channel's, and resident bytes stay
    within the budget. Every join is bounded."""
    chan, ref, mgr, backend, _ = _paged_pair("infer_fn")
    mgr.pin("a")
    rng = np.random.default_rng(21)
    inputs = [rng.standard_normal((2, 4)).astype(np.float32) for _ in range(16)]
    want = {(n, i): ref.do_inference(InferRequest(n, {"x": x})).outputs["y"].tobytes()
            for n in ("a", "b", "c") for i, x in enumerate(inputs)}
    chan.do_inference(InferRequest("a", {"x": inputs[0]}))
    stop, served, errors = threading.Event(), [], []

    def serve_a():
        i = 0
        while not stop.is_set() and i < 10_000:
            x = inputs[i % len(inputs)]
            try:
                got = chan.do_inference(InferRequest("a", {"x": x})).outputs["y"].tobytes()
            except Exception as e:  # reported by the main thread
                errors.append(e)
                return
            served.append(got == want[("a", i % len(inputs))])
            i += 1

    worker = threading.Thread(target=serve_a, daemon=True)
    worker.start()
    try:
        for i, x in enumerate(inputs):
            name = "bc"[i % 2]
            got = chan.do_inference(InferRequest(name, {"x": x})).outputs["y"].tobytes()
            assert got == want[(name, i)]
            s = mgr.stats()
            assert s["resident_bytes"] <= s["budget_bytes"]
    finally:
        stop.set()
        worker.join(timeout=10.0)
    assert not worker.is_alive() and not errors
    assert served and all(served)
    s = mgr.stats()
    assert s["promotions"] >= len(inputs) and s["models"]["a:1"]["evictions"] == 0


def test_ragged_launchers_go_with_the_eviction():
    """A packed segment bucket's launcher (the ragged route) is dropped and
    its graphs released with the dense one's."""
    chan, _, mgr, backend, _ = _paged_pair("device_fn", budget=10_000)
    mgr.prefetch("a")
    model = chan._repository.get("a")
    launcher, _ = chan._ragged_launcher(model, 4)
    x = torch.ones((5, 4))
    ids = torch.tensor([0, 0, 1, 3, 4], dtype=torch.int32)
    launcher({"x": x, "__segment_ids__": ids})
    chan.do_inference(InferRequest("a", {"x": X}))
    assert sorted(k[2:] for k in chan._launch_cache if k[0] == "a") == [(), ("ragged", 4)]
    assert len(backend.live("a:1")) == 2
    assert mgr.evict("a")
    assert not backend.live("a") and not [k for k in chan._launch_cache if k[0] == "a"]
    assert chan.ragged_graph_stats() == {}


def test_breaker_invalidation_rebuilds_while_warm():
    """An opened breaker drops the model's launcher while the manager still
    says WARM (as JAX's); the probe after the reset rebuilds it, captures
    again and answers."""
    repo, fail = trepo.ModelRepository(), [False]
    _register(repo, "a", 2.0, fail=fail)
    chan = CUDAChannel(repo, "cpu", breaker_threshold=1, breaker_reset_s=0.0)
    chan.graph_backend = backend = Backend()
    mgr = tlc.ModelLifecycleManager(repo, budget_bytes=10_000)
    chan.attach_lifecycle(mgr)
    first = chan.do_inference(InferRequest("a", {"x": X})).outputs["y"]
    launcher = chan._launch_cache[("a", "1")][1]
    fail[0] = True  # the next replay fails
    with pytest.raises(Exception, match="injected failure"):
        chan.do_inference(InferRequest("a", {"x": X}))
    assert ("a", "1") not in chan._launch_cache
    assert mgr.state("a") == tlc.WARM and mgr.stats()["models"]["a:1"]["inflight"] == 0
    fail[0] = False
    again = chan.do_inference(InferRequest("a", {"x": X})).outputs["y"]
    assert chan._launch_cache[("a", "1")][1] is not launcher and len(backend.graphs) == 2
    assert again.tobytes() == first.tobytes() == (X * 2.0 + 1.0).tobytes()
    assert mgr.stats()["promotions"] == 1


def test_failures_release_the_reference_once():
    """A request that fails at launch, is shed at launch, or succeeds
    (sync or async) holds no in-flight reference afterwards: the model stays
    evictable."""
    repo, fail = trepo.ModelRepository(), [True]
    _register(repo, "a", 2.0, fail=fail)
    chan = CUDAChannel(repo, "cpu", shed_expired=True)
    mgr = tlc.ModelLifecycleManager(repo, budget_bytes=10_000)
    chan.attach_lifecycle(mgr)
    with pytest.raises(RuntimeError, match="injected failure"):
        chan.do_inference(InferRequest("a", {"x": X}))
    assert mgr.stats()["models"]["a:1"]["inflight"] == 0
    fail[0] = False
    expired = InferRequest("a", {"x": X}, deadline_s=time.perf_counter() - 1.0)
    with pytest.raises(tadm.DeadlineExpiredError):
        chan.do_inference(expired)
    assert mgr.stats()["models"]["a:1"]["inflight"] == 0
    chan.do_inference(InferRequest("a", {"x": X}))
    future = chan.do_inference_async(InferRequest("a", {"x": X}))
    assert mgr.stats()["models"]["a:1"]["inflight"] == 1  # held across the device window
    future.result()
    s = mgr.stats()
    assert s["models"]["a:1"]["inflight"] == 0 and s["promotions"] == 1
    assert chan.stats()["shed"] == {"a|0|launch": 1}
    assert mgr.evict("a")


def test_a_shed_promotion_counts_under_lifecycle():
    repo = trepo.ModelRepository()
    for name, k in (("a", 2.0), ("b", 3.0)):
        _register(repo, name, k)
    chan = CUDAChannel(repo, "cpu")
    mgr = tlc.ModelLifecycleManager(repo, budget_bytes=150)
    chan.attach_lifecycle(mgr)
    mgr.pin("a")
    chan.do_inference(InferRequest("a", {"x": X}))
    with pytest.raises(tlc.HBMBudgetExceededError):
        chan.do_inference(InferRequest("b", {"x": X}))
    assert chan.stats()["shed"] == {"b|0|lifecycle": 1}
    tr_req = InferRequest("a", {"x": X})
    from triton_client_tpu_torch.obs.trace import Tracer

    tr_req.trace = Tracer(capacity=4).start(model="a")
    chan.do_inference(tr_req)
    assert "lifecycle" in [span.name for span in tr_req.trace.spans]


def test_a_fused_ensembles_graph_outlives_its_members_eviction():
    """A fused ensemble holds its own copy of its members' bodies in its own
    graph: evicting a member leaves the ensemble's graph live and its
    answers unchanged; evicting the ensemble releases it."""
    from triton_client_tpu_torch.runtime.ensemble import EnsembleStep, build_ensemble

    repo = trepo.ModelRepository()
    for name, k in (("a", 2.0), ("b", 3.0)):
        _register(repo, name, k)
    steps = [EnsembleStep("a", input_map={"x": "raw"}, output_map={"y": "mid"}),
             EnsembleStep("b", input_map={"x": "mid"}, output_map={"y": "out"})]
    ens = build_ensemble(repo, "pipe", steps, outputs=["out"], device="cpu")
    repo.register(ens.spec, ens.infer_fn, warmup=ens.warmup, device_fn=ens.device_fn)
    backend = Backend()
    chan = CUDAChannel(repo, "cpu")
    chan.graph_backend = backend
    mgr = tlc.ModelLifecycleManager(repo, budget_bytes=0)
    chan.attach_lifecycle(mgr)
    want = (X * 2.0 + 1.0) * 3.0 + 1.0
    got = chan.do_inference(InferRequest("pipe", {"raw": X})).outputs["out"]
    chan.do_inference(InferRequest("a", {"x": X}))
    assert got.tobytes() == want.tobytes()
    assert mgr.evict("a") and not backend.live("a:") and backend.live("pipe:")
    again = chan.do_inference(InferRequest("pipe", {"raw": X})).outputs["out"]
    assert again.tobytes() == want.tobytes() and mgr.state("a") == tlc.COLD
    assert mgr.evict("pipe") and not backend.live("pipe:")


def test_capture_scope_keep_dies_with_the_graph():
    """What a capture scope yielded (kernel 6's tickets on the card) lives as
    long as its graph: a release drops it."""
    import contextlib

    class Keep:
        pass

    kept = []

    @contextlib.contextmanager
    def scope():
        k = Keep()
        kept.append(weakref.ref(k))
        yield k

    fn = CapturedFunction(lambda x: x + 1, "scoped", backend=Backend(), capture_scope=scope)
    fn(torch.ones(3))
    fn(torch.ones(4))
    assert [r() is not None for r in kept] == [True, True]
    fn.release()
    assert [r() is None for r in kept] == [True, True]
    s = fn.stats()
    assert (s["keys"], s["pool_bytes"], s["captures"]) == (0, 0, 2)
    assert fn(torch.ones(3)).tolist() == [2.0, 2.0, 2.0] and fn.stats()["captures"] == 3


# -- the server -------------------------------------------------------------------


def _live_models():
    return [("gold_a", 2.0), ("gold_b", 3.0), ("silver_a", 4.0), ("bronze_a", 5.0),
            ("bronze_b", 6.0)]


def _live_table(mod):
    return mod.TenantTable([
        mod.TenantPolicy(name="gold", share=8, max_inflight=64, models=("gold_a", "gold_b"),
                         pinned=("gold_a",)),
        mod.TenantPolicy(name="silver", share=2, max_inflight=32, models=("silver_a",)),
        mod.TenantPolicy(name="bronze", share=1, max_inflight=16,
                         models=("bronze_a", "bronze_b")),
    ])


def _port_stack(budget_bytes):
    from triton_client_tpu_torch.runtime.continuous import ContinuousBatchingChannel
    from triton_client_tpu_torch.runtime.server import InferenceServer

    repo = trepo.ModelRepository()
    for name, k in _live_models():
        repo.register(_spec(name), lambda i, k=k: {"y": torch.as_tensor(i["x"]) * k},
                      device_fn=lambda i, k=k: {"y": i["x"] * k})
    table = _live_table(tlc)
    base = CUDAChannel(repo, "cpu")
    lifecycle = None
    if budget_bytes:
        lifecycle = tlc.ModelLifecycleManager(repo, budget_bytes=budget_bytes, tenants=table)
        base.attach_lifecycle(lifecycle)
    chan = ContinuousBatchingChannel(base, max_batch=4)
    chan.attach_tenants(table)
    server = InferenceServer(repo, chan, address="127.0.0.1:0", metrics_port="auto",
                             lifecycle=lifecycle, tenants=table, admission_max_queue=64)
    server.start()
    return server, lifecycle


def _jax_stack(budget_bytes):
    from triton_client_tpu.channel.tpu_channel import TPUChannel
    from triton_client_tpu.config import ModelSpec as JSpec
    from triton_client_tpu.config import TensorSpec as JTensor
    from triton_client_tpu.runtime.continuous import ContinuousBatchingChannel
    from triton_client_tpu.runtime.server import InferenceServer

    repo = jrepo.ModelRepository()
    for name, k in _live_models():
        spec = JSpec(name=name, version="1", max_batch_size=8,
                     inputs=(JTensor("x", (-1, 4), "FP32"),),
                     outputs=(JTensor("y", (-1, 4), "FP32"),), extra={"param_bytes": 100})
        repo.register(spec, lambda i, k=k: {"y": np.asarray(i["x"], np.float32) * k},
                      device_fn=lambda i, k=k: {"y": i["x"] * k})
    table = _live_table(jlc)
    base = TPUChannel(repo)
    lifecycle = jlc.ModelLifecycleManager(repo, budget_bytes=budget_bytes, tenants=table)
    base.attach_lifecycle(lifecycle)
    chan = ContinuousBatchingChannel(base, max_batch=4)
    chan.attach_tenants(table)
    server = InferenceServer(repo, chan, address="127.0.0.1:0", lifecycle=lifecycle,
                             tenants=table, admission_max_queue=64)
    server.start()
    return server, lifecycle


def _scrape(url):
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.read()


def test_live_server_pages_as_jax():
    """The JAX live-server flow on both stacks (five models of 100 B, a
    budget of 250 B, three tenants, gold_a pinned): bitwise parity with an
    always-resident port server, the same lifecycle stats and admission
    tenant counts as JAX's server, and the lifecycle lines on /snapshot and
    /metrics."""
    from triton_client_tpu.channel.grpc_channel import GRPCChannel as JClient
    from triton_client_tpu.channel.base import InferRequest as JRequest
    from triton_client_tpu_torch.channel.grpc_channel import GRPCChannel

    server, lifecycle = _port_stack(250)
    baseline, _ = _port_stack(0)
    jserver, jlifecycle = _jax_stack(250)
    clients = []
    try:
        client = GRPCChannel(f"127.0.0.1:{server.port}", timeout_s=30.0)
        ref = GRPCChannel(f"127.0.0.1:{baseline.port}", timeout_s=30.0)
        jclient = JClient(f"127.0.0.1:{jserver.port}", timeout_s=30.0)
        clients = [client, ref, jclient]
        rng = np.random.default_rng(7)
        schedule = [name for name, _ in _live_models()] * 3
        rng.shuffle(schedule)
        for name in schedule:
            x = rng.standard_normal((2, 4)).astype(np.float32)
            got = client.do_inference(InferRequest(name, {"x": x})).outputs["y"]
            want = ref.do_inference(InferRequest(name, {"x": x})).outputs["y"]
            jgot = jclient.do_inference(JRequest(name, {"x": x})).outputs["y"]
            assert got.tobytes() == want.tobytes() == np.asarray(jgot).tobytes()
        s, js = lifecycle.stats(), jlifecycle.stats()
        for stats in (s, js):
            stats.pop("promotion_latency")
        assert s == js
        assert s["promotions"] >= 5 and s["evictions"] >= 3 and s["resident_bytes"] <= 250
        assert s["models"]["gold_a:1"]["evictions"] == 0
        assert s["models"]["gold_a:1"]["state"] == "warm"
        for key in ("tenant_inflight", "tenant_rejects"):
            assert server.admission.stats()[key] == jserver.admission.stats()[key]
        assert server.lifecycle is lifecycle and server.tenants.tenant_of("gold_b") == "gold"
        base = f"http://127.0.0.1:{server.metrics_port}"
        snap = json.loads(_scrape(base + "/snapshot"))
        assert snap["lifecycle"]["budget_bytes"] == 250
        assert "gold" in snap["lifecycle"]["tenant_resident_bytes"]
        assert snap["lifecycle"]["promotion_latency"]["count"] >= 5
        assert "bronze" in {k.split("|")[1] for k in snap["device_time"]["device_seconds"]}
        text = _scrape(base + "/metrics").decode()
        assert 'tpu_serving_tenant_hbm_bytes{tenant="gold"}' in text
        assert "tpu_serving_promotion_seconds_bucket" in text
        assert 'tpu_serving_lifecycle_models{state="warm"}' in text
        assert "tpu_serving_hbm_budget_bytes 250.0" in text
        # the runbook: page a model out and back in by hand
        assert server.lifecycle.evict("silver_a") in (True, False)
        server.lifecycle.prefetch("silver_a")
        assert server.lifecycle.state("silver_a") == tlc.WARM
    finally:
        for c in clients:
            c.close()
        for srv in (server, baseline, jserver):
            srv.stop()


def test_collector_exports_the_lifecycle_families_as_jax():
    """With a manager attached, the lifecycle families carry its stats, the
    same sample lines as JAX's collector on an equal manager (the promotion
    histogram's buckets left out: its samples are timings)."""
    import prometheus_client

    from triton_client_tpu.obs import collector as jcol
    from triton_client_tpu_torch.obs import collector as tcol

    lines = []
    for mod, col in ((jlc, jcol), (tlc, tcol)):
        mgr = mod.ModelLifecycleManager(FakeRepository(("a", "b", "c")), budget_bytes=250,
                                        tenants=_tables(mod)["pinned"])
        for name in ("a", "b", "c", "b"):
            mgr.prefetch(name)
        registry = prometheus_client.CollectorRegistry()
        c = col.RuntimeCollector(registry=registry, lifecycle=mgr)
        text = prometheus_client.generate_latest(registry).decode()
        c.close()
        lines.append([line for line in text.splitlines()
                      if line.startswith(("tpu_serving_hbm", "tpu_serving_tenant_hbm",
                                          "tpu_serving_lifecycle", "tpu_serving_model_promotions",
                                          "tpu_serving_model_evictions",
                                          "tpu_serving_promotion_seconds_count"))])
    assert lines[1] == lines[0]
    assert 'tpu_serving_lifecycle_models{state="warm"} 2.0' in lines[1]
    assert "tpu_serving_promotion_seconds_count 4.0" in lines[1]


# -- serve --hbm-budget --tenants --------------------------------------------------

TINY = """family: yolov5
model:
  variant: n
  input_hw: [64, 64]
pipeline:
  class_names_file: data/crop.names
  conf_thresh: 0.05
max_batch_size: 4
"""


def test_serve_pages_disk_entries(tmp_path, monkeypatch, capsys):
    """``serve --hbm-budget --tenants`` over three 64x64 YOLOv5n entries
    whose captured bodies go through a stand-in backend: one fits the
    budget at a time besides the pinned one; every answer is bitwise the
    always-resident server's, an evicted entry's pipeline holds no graph,
    and ``--warmup`` prefetches while the next entry fits without an
    eviction."""
    import pathlib

    from triton_client_tpu_torch.channel.grpc_channel import GRPCChannel
    from triton_client_tpu_torch.cli import serve

    root_dir = pathlib.Path(__file__).resolve().parent.parent
    monkeypatch.chdir(root_dir)
    names = ("crop_a", "crop_b", "crop_c")
    for name in names:
        (tmp_path / name).mkdir()
        (tmp_path / name / "config.yaml").write_text(TINY)
    tenants = tmp_path / "tenants.yaml"
    tenants.write_text("tenants:\n  lines:\n    hbm_quota_mb: 64\n    models: [crop_a]\n"
                       "    pinned: [crop_a]\n  rest:\n    max_inflight: 4\n"
                       "    models: [crop_b, crop_c]\n")

    def build(*flags):
        args = serve.parser().parse_args(["-r", str(tmp_path), "-a", "127.0.0.1:0", "--device",
                                          "cpu", "--max-workers", "4", "--uds", "off", *flags])
        return serve.build_server(args)

    # every entry's pipeline captures through a stand-in backend: record
    # the pipelines as scan_disk builds them
    from triton_client_tpu_torch.pipelines import detect2d

    backends = []
    original = detect2d.Detect2DPipeline.__init__

    def init(self, *a, **kw):
        original(self, *a, **kw)
        self._jit._backend = Backend()
        backends.append(self)

    monkeypatch.setattr(detect2d.Detect2DPipeline, "__init__", init)
    resident = build()
    pipes_resident = list(backends)
    backends.clear()
    # measure one entry's cost from an unbudgeted lifecycle, then budget two
    probe = build("--tenants", str(tenants), "--warmup")
    cost = probe.lifecycle.stats()["models"]["crop_b:1"]["cost_bytes"]
    probe.stop()
    backends.clear()
    budget_mb = 2.5 * cost / (1 << 20)
    server = build("--hbm-budget", f"{budget_mb}", "--tenants", str(tenants), "--admission",
                   "8", "--batching")
    repo = server.lifecycle._repository  # the scanned entries
    jits = {n: repo.get(n).infer_fn.release_graphs.__self__ for n in names}
    out = capsys.readouterr().out
    assert f"model lifecycle: hbm_budget={budget_mb:g}MB tenants=3" in out
    server.start()
    resident.start()
    clients = []
    try:
        client = GRPCChannel(f"127.0.0.1:{server.port}", timeout_s=60.0)
        ref = GRPCChannel(f"127.0.0.1:{resident.port}", timeout_s=60.0)
        clients = [client, ref]
        rng = np.random.default_rng(3)
        schedule = ["crop_a", "crop_b", "crop_c", "crop_b", "crop_a", "crop_c", "crop_b"]
        for name in schedule:
            # FP32 frames at the input size: the key the entry's warmup (the
            # page-in) captures
            frame = rng.integers(0, 255, (1, 64, 64, 3)).astype(np.float32)
            got = client.do_inference(InferRequest(name, {"images": frame})).outputs
            want = ref.do_inference(InferRequest(name, {"images": frame})).outputs
            for key in want:
                assert got[key].tobytes() == want[key].tobytes()
            s = server.lifecycle.stats()
            assert s["resident_bytes"] <= s["budget_bytes"]
            for model, row in s["models"].items():
                jit = jits[model.split(":")[0]]
                if row["state"] == "cold":
                    assert jit.stats()["keys"] == jit.stats()["pool_bytes"] == 0
                    assert not jit._backend.live("")
                else:
                    assert jit.stats()["keys"] == 1 and len(jit._backend.live("")) == 1
        s = server.lifecycle.stats()
        assert s["evictions"] == 4 and s["models"]["crop_a:1"]["evictions"] == 0
        assert s["tenants"]["rest"]["max_inflight"] == 4
        assert server.admission.stats()["tenant_inflight"] == {"lines": 0, "rest": 0}
        assert server.channel._tenant_table is server.tenants
        assert len(pipes_resident) == 3
    finally:
        for c in clients:
            c.close()
        server.stop()
        resident.stop()
    # --warmup under the budget prefetches in list order and stops at the
    # first entry whose page-in evicted another: one wasted capture at most
    capsys.readouterr()
    warmed = build("--hbm-budget", f"{budget_mb}", "--tenants", str(tenants), "--warmup")
    s = warmed.lifecycle.stats()
    warmed.stop()
    assert "warmup: 2 of 3 models prefetched under the budget" in capsys.readouterr().out
    assert s["evictions"] <= 1 and s["resident_bytes"] <= s["budget_bytes"]
    assert [s["models"][f"{n}:1"]["state"] for n in names[:2]] == ["warm", "warm"]
