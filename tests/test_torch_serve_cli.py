"""The port's ``serve`` command: its parser against the JAX CLI's flags,
a CPU-device serve of a small disk repository answering over grpc (no
batcher, the window batcher and the continuous one), and every flag of a
layer the port does not serve raising at a non-default value, naming its
ROADMAP item (tests/test_serve_cli.py drives the JAX command)."""

import argparse
import contextlib
import io
import json
import logging
import pathlib
import re

import numpy as np
import pytest

from triton_client_tpu.cli import serve as jserve
from triton_client_tpu.runtime.precision import PrecisionPolicy as JPolicy

from triton_client_tpu_torch.channel.base import InferRequest
from triton_client_tpu_torch.channel.grpc_channel import GRPCChannel
from triton_client_tpu_torch.cli import serve
from triton_client_tpu_torch.runtime import faults
from torch_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
TINY = """family: yolov5
model:
  variant: n
  input_hw: [64, 64]
pipeline:
  class_names_file: data/crop.names
  conf_thresh: 0.05
max_batch_size: 4
"""


@pytest.fixture
def repo_root(tmp_path, monkeypatch):
    monkeypatch.chdir(ROOT)
    (tmp_path / "tiny").mkdir()
    (tmp_path / "tiny" / "config.yaml").write_text(TINY)
    return tmp_path


def _args(root, *extra):
    return serve.parser().parse_args(
        ["-r", str(root), "-a", "127.0.0.1:0", "--device", "cpu", "--max-workers", "4", *extra])


def test_parser_builds():
    with contextlib.redirect_stdout(io.StringIO()):
        with pytest.raises(SystemExit):
            serve.main(["--help"])


def test_every_jax_flag_is_taken():
    """Every flag of the JAX serve command is one of the port's, served or
    raising; the port adds --device and --batcher none."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit):
        jserve.main(["--help"])
    usage = out.getvalue().split("options:")[0]  # wrapped between flags, never inside one
    jax_flags = set(re.findall(r"\[(--[a-z][a-z0-9-]*)", usage)) | {"--model-repository"}
    assert len(jax_flags) > 40
    ours = {s for a in serve.parser()._actions for s in a.option_strings}
    assert jax_flags - {"--help"} <= ours, sorted(jax_flags - ours)


@pytest.mark.parametrize("extra", [[], ["--batching"], ["--batcher", "window"],
                                   ["--batcher", "continuous", "--pipeline-depth", "1"]])
def test_cpu_serve_answers_over_grpc(repo_root, extra, capsys):
    server = serve.build_server(_args(repo_root, *extra))
    server.start()
    try:
        chan = GRPCChannel(f"127.0.0.1:{server.port}", timeout_s=60)
        assert chan.server_live() and chan.repository_index() == [("tiny", "1", "READY")]
        spec = chan.get_metadata("tiny")
        assert spec.extra["model_input_hw"] == [64, 64] and spec.max_batch_size == 4
        frame = np.random.default_rng(0).integers(0, 255, (1, 48, 80, 3)).astype(np.uint8)
        resp = chan.do_inference(InferRequest("tiny", {"images": frame}))
        assert resp.outputs["detections"].shape == (1, 300, 6) and resp.outputs["valid"].any()
        chan.close()
    finally:
        server.stop()
    printed = capsys.readouterr().out
    assert "loaded tiny:1 (torch, device=cpu)" in printed
    assert ("micro-batching" in printed) == bool(extra)


def test_serve_rejects_a_missing_repository(tmp_path):
    with pytest.raises(FileNotFoundError):
        serve.build_server(_args(tmp_path / "nope"))


def test_fault_plan_and_warmup(repo_root, tmp_path, capsys):
    plan = tmp_path / "plan.json"
    plan.write_text('{"seed": 7, "rules": [{"point": "slow_launch", "count": 1}]}')
    prev = faults.active_plan()
    try:
        server = serve.build_server(_args(repo_root, "--fault-plan", str(plan), "--warmup"))
        server.stop()
        assert faults.active_plan().seed == 7
    finally:
        faults.install_fault_plan(prev)
    assert "FAULT PLAN ACTIVE (seed 7, 1 rule(s))" in capsys.readouterr().out


def test_batch_timeout_warns_once_on_continuous(repo_root, caplog):
    serve._timeout_warned = False
    with caplog.at_level(logging.WARNING, logger=serve.__name__):
        for _ in range(2):
            serve.build_server(_args(repo_root, "--batching", "--batch-timeout-us", "3000")).stop()
    assert len([r for r in caplog.records if "--batch-timeout-us" in r.getMessage()]) == 1


NON_DEFAULT = {
    "mesh": ["--mesh", "data=-1"],
    "canary": ["--canary", "x=0.1"], "quality_sample": ["--quality-sample", "0.5"],
    "quality_window": ["--quality-window", "8"],
    "quality_promote_after": ["--quality-promote-after", "1"],
    "quality_pin_fused_off": ["--quality-pin-fused-off"],
    "temporal_reuse": ["--temporal-reuse", "on"], "temporal_k_max": ["--temporal-k-max", "4"],
    "temporal_tile": ["--temporal-tile", "4"], "temporal_forced_k": ["--temporal-forced-k", "3"],
    "replica_of": ["--replica-of", "cell0/pool"],
}

# the flags served since they left UNPORTED (the telemetry and SLO planes,
# the lifecycle and tenants, the streaming sessions): flags -> what the built
# server shows for them
_METRICS = ["--metrics-port", "auto"]
SERVED = {
    "hbm_budget": (["--hbm-budget", "256"],
                   lambda s: s.lifecycle.budget_bytes == 256 << 20
                   and s.channel.lifecycle is s.lifecycle),
    "tenants": (["--tenants", "TENANTS", "--batching", "--admission", "4"],
                lambda s: s.tenants.tenant_of("tiny") == "crop" and s.lifecycle.tenants is s.tenants
                and s.channel._tenant_table is s.tenants
                and s.admission.stats()["tenant_inflight"] == {}),
    "metrics_port": (_METRICS, lambda s: s.metrics_enabled and s.metrics_port > 0),
    "op_sample_interval": (_METRICS + ["--op-sample-interval", "2"],
                           lambda s: s.sampler.interval_s == 2.0),
    "op_sample_window": (_METRICS + ["--op-sample-interval", "100", "--op-sample-window", "0.5"],
                         lambda s: s.sampler.window_s == 0.5),
    "history_interval": (_METRICS + ["--history-interval", "10"],
                         lambda s: s.history.interval_s == 10.0),
    "history_capacity": (_METRICS + ["--history-capacity", "10"],
                         lambda s: s.history.capacity == 10),
    "history_path": (_METRICS + ["--history-path", "HISTORY"], None),
    "slo_ms": (_METRICS + ["--slo-ms", "50"], lambda s: s.slo.slo_s("tiny") == 0.05),
    "slo_tail_capacity": (_METRICS + ["--slo-tail-capacity", "8"],
                          lambda s: s.slo._tail.maxlen == 8),
    "admission_concurrency": (["--admission", "2", "--admission-concurrency", "8"],
                              lambda s: s.admission.stats()["concurrency"] == 8),
    "shed_expired": (["--shed-expired"], lambda s: s.channel._shed_expired),
    "max_sessions": (["--max-sessions", "16"],
                     lambda s: s.channel.sessions.stats()["max_sessions"] == 16),
    "session_ttl_s": (["--session-ttl-s", "5"], lambda s: s.channel.sessions._ttl_s == 5.0),
    "session_id_namespace": (["--session-id-namespace", "3"],
                             lambda s: s.channel.sessions._namespace == 3),
}


def test_every_served_flag_has_a_case():
    ours = {a.dest for a in serve.parser()._actions}
    assert set(SERVED) <= ours and not set(SERVED) & set(serve.UNPORTED)


@pytest.mark.parametrize("dest", sorted(SERVED))
def test_telemetry_and_slo_flags_are_served(tmp_path, monkeypatch, dest):
    """Each flag that left UNPORTED builds a server that carries it (an empty
    repository: the flags act on the planes, not the models); the history
    path holds the persisted ring once the server stops."""
    monkeypatch.chdir(ROOT)
    flags, holds = SERVED[dest]
    history = tmp_path / "history.json"
    tenants = tmp_path / "tenants.yaml"
    tenants.write_text("tenants:\n  crop:\n    max_inflight: 2\n    models: [tiny]\n")
    flags = [{"HISTORY": str(history), "TENANTS": str(tenants)}.get(f, f) for f in flags]
    server = serve.build_server(_args(tmp_path, *flags))
    try:
        assert holds is None or holds(server)
    finally:
        server.stop()
    if dest == "history_path":
        assert json.loads(history.read_text())["snapshots"]


def test_sessions_default_on_under_any_batcher_and_zero_disables(tmp_path, monkeypatch, capsys):
    """``--max-sessions`` defaults to 64, as in the JAX CLI: the manager sits
    on the staged channel under a batcher too; 0 attaches none."""
    monkeypatch.chdir(ROOT)
    server = serve.build_server(_args(tmp_path, "--batching"))
    try:
        assert server.channel.inner.sessions.stats()["max_sessions"] == 64
    finally:
        server.stop()
    assert "streaming sessions: max_sessions=64 ttl=60s id_namespace=0" in capsys.readouterr().out
    server = serve.build_server(_args(tmp_path, "--max-sessions", "0"))
    try:
        assert server.channel.sessions is None
    finally:
        server.stop()


def test_every_unported_flag_has_a_case():
    assert set(NON_DEFAULT) == set(serve.UNPORTED)


@pytest.mark.parametrize("dest", sorted(NON_DEFAULT))
def test_unported_flags_raise_naming_their_item(repo_root, dest):
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md Queue 1 item [38] "):
        serve.build_server(_args(repo_root, *NON_DEFAULT[dest]))


def test_unported_flag_exits_with_its_message(repo_root, capsys):
    with pytest.raises(SystemExit, match="--mesh data=2 is not ported yet"):
        serve.main(["-r", str(repo_root), "--device", "cpu", "--mesh", "data=2"])


def test_f32_precision_is_served(repo_root):
    serve.check_unported(_args(repo_root, "--precision", "f32"))


@pytest.mark.parametrize("policy", ["int8w", "int8"])
def test_int8_precisions_serve_fp32_requests(repo_root, capsys, policy):
    """``--precision int8w|int8`` serves every entry with int8 weights: the
    spec records the policy and about a quarter of the float32 bytes, FP32
    frames stage float32 (a config.yaml entry carries no calibration
    scales, as in the JAX package) and the detections come back float32."""
    server = serve.build_server(_args(repo_root, "--precision", policy))
    f32 = serve.build_server(_args(repo_root))
    server.start()
    try:
        chan = GRPCChannel(f"127.0.0.1:{server.port}", timeout_s=60)
        spec = chan.get_metadata("tiny")
        assert spec.extra["precision"] == policy
        f32_bytes = f32._servicer._repo.metadata("tiny").extra["param_bytes"]
        assert f32_bytes * 0.25 < spec.extra["param_bytes"] < f32_bytes * 0.3
        model = server._servicer._repo.get("tiny")
        frame = np.random.default_rng(0).uniform(0, 255, (1, 64, 64, 3)).astype(np.float32)
        assert model.precision.name == policy
        assert model.precision.wire_cast("images", frame) is frame
        assert JPolicy.parse(policy).wire_cast("images", frame) is frame
        out = chan.do_inference(InferRequest("tiny", {"images": frame})).outputs
        assert out["detections"].dtype == np.float32 and out["detections"].shape == (1, 300, 6)
        assert np.isfinite(out["detections"]).all()
        chan.close()
    finally:
        server.stop()
        f32.stop()
    assert f"loaded tiny:1 (torch, device=cpu) precision={policy}" in capsys.readouterr().out


def test_precision_bf16_serves_fp32_requests(repo_root, capsys):
    """``--precision bf16`` serves every entry under the bf16 policy: FP32 frames
    stage as bfloat16, the detections come back float32."""
    server = serve.build_server(_args(repo_root, "--precision", "bf16"))
    server.start()
    try:
        chan = GRPCChannel(f"127.0.0.1:{server.port}", timeout_s=60)
        spec = chan.get_metadata("tiny")
        assert spec.extra["precision"] == "bf16"
        frame = np.random.default_rng(0).uniform(0, 255, (1, 64, 64, 3)).astype(np.float32)
        out = chan.do_inference(InferRequest("tiny", {"images": frame})).outputs
        assert out["detections"].dtype == np.float32 and out["detections"].shape == (1, 300, 6)
        assert np.isfinite(out["detections"]).all()
        chan.close()
    finally:
        server.stop()
    assert "loaded tiny:1 (torch, device=cpu) precision=bf16" in capsys.readouterr().out


def test_an_embedders_namespace_needs_only_the_served_flags(repo_root):
    """build_server reads every flag with a default, as the JAX one does for
    hand-built Namespaces (tests/test_serve_cli.py)."""
    args = argparse.Namespace(model_repository=str(repo_root), address="127.0.0.1:0",
                              max_workers=2, device="cpu", batching=False, max_batch=8,
                              pipeline_depth=2)
    serve.build_server(args).stop()
