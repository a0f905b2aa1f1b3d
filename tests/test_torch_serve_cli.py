"""The port's ``serve`` command: its parser against the JAX CLI's flags,
a CPU-device serve of a small disk repository answering over grpc (no
batcher, the window batcher and the continuous one), and every flag of a
layer the port does not serve raising at a non-default value, naming its
ROADMAP item (tests/test_serve_cli.py drives the JAX command)."""

import argparse
import contextlib
import io
import logging
import pathlib
import re

import numpy as np
import pytest

from triton_client_tpu.cli import serve as jserve

from triton_client_tpu_torch.channel.base import InferRequest
from triton_client_tpu_torch.channel.grpc_channel import GRPCChannel
from triton_client_tpu_torch.cli import serve
from triton_client_tpu_torch.runtime import faults

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
    "uds": ["--uds", "auto"], "mesh": ["--mesh", "data=-1"], "precision": ["--precision", "bf16"],
    "metrics_port": ["--metrics-port", "8002"], "op_sample_interval": ["--op-sample-interval", "2"],
    "op_sample_window": ["--op-sample-window", "0.5"],
    "history_interval": ["--history-interval", "10"],
    "history_capacity": ["--history-capacity", "10"], "history_path": ["--history-path", "h"],
    "canary": ["--canary", "x=0.1"], "quality_sample": ["--quality-sample", "0.5"],
    "quality_window": ["--quality-window", "8"],
    "quality_promote_after": ["--quality-promote-after", "1"],
    "quality_pin_fused_off": ["--quality-pin-fused-off"], "slo_ms": ["--slo-ms", "50"],
    "slo_tail_capacity": ["--slo-tail-capacity", "8"], "hbm_budget": ["--hbm-budget", "256"],
    "tenants": ["--tenants", "t.yaml"], "max_sessions": ["--max-sessions", "64"],
    "session_ttl_s": ["--session-ttl-s", "5"],
    "session_id_namespace": ["--session-id-namespace", "3"],
    "temporal_reuse": ["--temporal-reuse", "on"], "temporal_k_max": ["--temporal-k-max", "4"],
    "temporal_tile": ["--temporal-tile", "4"], "temporal_forced_k": ["--temporal-forced-k", "3"],
    "replica_of": ["--replica-of", "cell0/pool"],
    "admission_concurrency": ["--admission-concurrency", "8"],
    "shed_expired": ["--shed-expired"],
}


def test_every_unported_flag_has_a_case():
    assert set(NON_DEFAULT) == set(serve.UNPORTED)


@pytest.mark.parametrize("dest", sorted(NON_DEFAULT))
def test_unported_flags_raise_naming_their_item(repo_root, dest):
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md Queue 1 item [38] "):
        serve.build_server(_args(repo_root, *NON_DEFAULT[dest]))


def test_unported_flag_exits_with_its_message(repo_root, capsys):
    with pytest.raises(SystemExit, match="--uds auto is not ported yet"):
        serve.main(["-r", str(repo_root), "--device", "cpu", "--uds", "auto"])


def test_f32_precision_is_served(repo_root):
    serve.check_unported(_args(repo_root, "--precision", "f32"))


def test_an_embedders_namespace_needs_only_the_served_flags(repo_root):
    """build_server reads every flag with a default, as the JAX one does for
    hand-built Namespaces (tests/test_serve_cli.py)."""
    args = argparse.Namespace(model_repository=str(repo_root), address="127.0.0.1:0",
                              max_workers=2, device="cpu", batching=False, max_batch=8,
                              pipeline_depth=2)
    serve.build_server(args).stop()
