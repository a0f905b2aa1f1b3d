"""The port's ensembles (``runtime/ensemble.py``) and the disk repository's
ensemble and preprocess entries against the JAX package, on the CPU.

Every case of tests/test_ensemble.py and of the ensemble-precision cases of
tests/test_precision.py runs on both packages over the same DAG: members
that compute the same function (numpy and ``jax.numpy`` in the JAX
repository, torch in the port's), the same steps and the same config
docs. Outputs are equal, and every build-time error has the same type and
message. The port's fused path equals its host path bitwise. A tiny disk
repository (``camera_preprocess`` and ``yolov5_crop_base`` at 64x64, conf
0.05, one ``weights.msgpack`` read by both packages) holds the preprocess
-> detector ensembles against JAX's on seeded 48x80 camera frames, at
tests/test_torch_detect2d.py's resized-frame bars (rtol 1e-3, atol 1e-2 on
boxes; labels and counts equal). One documented difference: a disk entry
serves through its captured ``infer_fn`` and offers its device form to
``fuse: always`` only, so ``fuse: auto`` over disk entries is the host
path in the port where JAX fuses (ROADMAP.md, Disagreements).
"""

import dataclasses
import pathlib
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from triton_client_tpu.channel.base import InferRequest as JRequest
from triton_client_tpu.channel.tpu_channel import TPUChannel
from triton_client_tpu.config import ModelSpec as JSpec
from triton_client_tpu.config import TensorSpec as JTensor
from triton_client_tpu.runtime import disk_repository as jdr
from triton_client_tpu.runtime import ensemble as jens
from triton_client_tpu.runtime.repository import ModelRepository as JRepository

from triton_client_tpu_torch.channel.base import InferRequest
from triton_client_tpu_torch.channel.cuda_channel import CUDAChannel
from triton_client_tpu_torch.config import ModelSpec, TensorSpec
from triton_client_tpu_torch.runtime import disk_repository as tdr
from triton_client_tpu_torch.runtime import ensemble as tens
from triton_client_tpu_torch.runtime.repository import ModelRepository
from tests.test_torch_server import yolo_variables
from torch_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent

# name -> (inputs, outputs, numpy function, torch function); each runs on
# its package's tensors. The device forms compute the same function.
MEMBERS = {
    "scale": ([("x", (-1, 4), "FP32")], [("scaled", (-1, 4), "FP32")],
              lambda x: {"scaled": x * np.float32(2.0)}, lambda x: {"scaled": x * 2.0}),
    "shift": ([("x", (-1, 4), "FP32")], [("shifted", (-1, 4), "FP32")],
              lambda x: {"shifted": x + np.float32(1.0)}, lambda x: {"shifted": x + 1.0}),
    "counter": ([("x", (-1, 4), "FP32")], [("count", (-1,), "INT32")],
                lambda x: {"count": np.zeros(1, np.int32)},
                lambda x: {"count": torch.zeros(1, dtype=torch.int32)}),
    "wide": ([("x", (-1, 4), "FP32")], [("y", (-1, 8), "FP32")],
             lambda x: {"y": np.zeros((1, 8), np.float32)},
             lambda x: {"y": torch.zeros((1, 8))}),
    "ids": ([("x", (-1, 4), "FP32")], [("classes", (-1,), "INT64")],
            lambda x: {"classes": np.zeros(len(x), np.int64)},
            lambda x: {"classes": torch.zeros(x.shape[0], dtype=torch.int32)}),
}


def _register(jrepo, trepo, name, device=False):
    """Register MEMBERS[name] in both repositories; ``device`` also gives
    each a device form (the JAX one traced under jit)."""
    ins, outs, np_fn, t_fn = MEMBERS[name]
    jspec = JSpec(name=name, version="1", platform="jax",
                  inputs=tuple(JTensor(*t) for t in ins),
                  outputs=tuple(JTensor(*t) for t in outs))
    tspec = ModelSpec(name=name, version="1", inputs=tuple(TensorSpec(*t) for t in ins),
                      outputs=tuple(TensorSpec(*t) for t in outs))
    if name == "ids":  # the device form emits int32 classes, as a scored head's does
        jdev = lambda i: {"classes": jnp.zeros(i["x"].shape[0], jnp.int32)}  # noqa: E731
    else:
        jdev = lambda i: np_fn(i["x"])  # noqa: E731 (jnp arrays take the numpy scalars)
    jrepo.register(jspec, lambda i: np_fn(np.asarray(i["x"])),
                   device_fn=jdev if device else None)
    trepo.register(tspec, lambda i: t_fn(torch.as_tensor(i["x"])),
                   device_fn=(lambda i: t_fn(i["x"])) if device else None)


def _repos(device=False, names=("scale", "shift")):
    jrepo, trepo = JRepository(), ModelRepository()
    for name in names:
        _register(jrepo, trepo, name, device)
    return jrepo, trepo


def _steps(pkg, spec):
    return [pkg.EnsembleStep(*s[:3], **s[3] if len(s) > 3 else {}) for s in spec]


def _both(jrepo, trepo, name, steps, outputs, **kw):
    """The JAX and the port's build of one ensemble."""
    return (jens.build_ensemble(jrepo, name, _steps(jens, steps), outputs=outputs, **kw),
            tens.build_ensemble(trepo, name, _steps(tens, steps), outputs=outputs,
                                device="cpu", **kw))


def _same_outputs(jrm, trm, inputs):
    want = jrm.infer_fn({k: np.asarray(v) for k, v in inputs.items()})
    got = trm.infer_fn(dict(inputs))
    assert set(got) == set(want)
    for k in want:
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else np.asarray(got[k])
        w = np.asarray(want[k])
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w)
    return got


def _tensors(spec):
    """A spec's tensors as the disk tests compare them (the JAX 2D specs
    mark ``images`` donatable; the port's channel donates nothing there)."""
    return [(t.name, t.shape, t.dtype, t.layout) for t in spec.inputs + spec.outputs]


def _same_error(jcall, tcall):
    with pytest.raises(Exception) as jinfo:
        jcall()
    with pytest.raises(Exception) as tinfo:
        tcall()
    assert type(tinfo.value) is type(jinfo.value)
    assert str(tinfo.value) == str(jinfo.value)
    return str(tinfo.value)


CHAIN = [("scale", {"x": "raw"}, {"scaled": "mid"}), ("shift", {"x": "mid"}, {"shifted": "final"})]
X = np.arange(8, dtype=np.float32).reshape(2, 4)


# -- parse_steps -------------------------------------------------------------------


def test_parse_steps_matches_jax():
    doc = [{"model": "a", "input_map": {"x": "raw"}, "output_map": {"y": "mid"},
            "precision": "bf16"},
           {"model": "b", "version": 2, "input_map": {"x": "mid"}, "output_map": {"y": "out"}}]
    got, want = tens.parse_steps(doc), jens.parse_steps(doc)
    assert [dataclasses.asdict(s) for s in got] == [dataclasses.asdict(s) for s in want]
    assert got[0] == tens.EnsembleStep("a", {"x": "raw"}, {"y": "mid"}, precision="bf16")
    assert got[1].version == "2" and got[1].precision == ""


@pytest.mark.parametrize("doc,match", [
    ([{"model": "a", "input_map": {}, "output_map": {}, "gpu": 1}], "unknown keys"),
    ([{"model": "a", "input_map": {}}], "missing 'output_map'"),
    ([], "at least one step"),
    ([{"model": "a", "input_map": {}, "output_map": {}, "precision": "fp8"}], "precision"),
], ids=["unknown_keys", "missing_keys", "empty", "bad_precision"])
def test_parse_steps_rejects_as_jax(doc, match):
    msg = _same_error(lambda: jens.parse_steps(doc), lambda: tens.parse_steps(doc))
    assert match in msg


# -- build_ensemble ------------------------------------------------------------------

# each build error of tests/test_ensemble.py: (members, steps, outputs, fuse, match)
BUILD_ERRORS = {
    "unknown_member": ((), [("nope", {"x": "raw"}, {"y": "out"})], ["out"], "auto",
                       "not registered"),
    "unknown_step_input": ((), [("scale", {"wrong": "raw"}, {"scaled": "out"})], ["out"],
                           "auto", "no inputs"),
    "unbound_step_input": ((), [("scale", {}, {"scaled": "out"})], ["out"], "auto",
                           "not bound"),
    "unknown_step_output": ((), [("scale", {"x": "raw"}, {"wrong": "out"})], ["out"], "auto",
                            "no outputs"),
    "input_echo_output": ((), [("scale", {"x": "raw"}, {"scaled": "mid"})], ["mid", "raw"],
                          "auto", "never produced"),
    "undeclared_output": ((), [("scale", {"x": "raw"}, {"scaled": "mid"})], ["final"], "auto",
                          "never produced"),
    "dtype_mismatch": (("counter",), [("counter", {"x": "raw"}, {"count": "mid"}),
                                      ("shift", {"x": "mid"}, {"shifted": "out"})], ["out"],
                       "auto", "INT32 but step 'shift' consumes it as FP32"),
    "shape_mismatch": (("wide",), [("wide", {"x": "raw"}, {"y": "mid"}),
                                   ("shift", {"x": "mid"}, {"shifted": "out"})], ["out"],
                       "auto", "shape"),
    "no_outputs": ((), [("scale", {"x": "raw"}, {"scaled": "mid"})], [], "auto",
                   "at least one output"),
    "invalid_fuse": ((), [("scale", {"x": "raw"}, {"scaled": "out"})], ["out"], "maybe",
                     "auto/always/never"),
    "always_host_only_member": ((), [("scale", {"x": "raw"}, {"scaled": "out"})], ["out"],
                                "always", "no device_fn"),
}


@pytest.mark.parametrize("case", sorted(BUILD_ERRORS))
def test_build_errors_match_jax(case):
    extra, steps, outputs, fuse, match = BUILD_ERRORS[case]
    jrepo, trepo = _repos(device=case == "invalid_fuse")
    for name in extra:
        _register(jrepo, trepo, name)
    msg = _same_error(
        lambda: jens.build_ensemble(jrepo, "e", _steps(jens, steps), outputs=outputs, fuse=fuse),
        lambda: tens.build_ensemble(trepo, "e", _steps(tens, steps), outputs=outputs, fuse=fuse,
                                    device="cpu"))
    assert match in msg


def test_chain_executes_in_order():
    jrm, trm = _both(*_repos(), "chain", CHAIN, ["final"])
    got = _same_outputs(jrm, trm, {"raw": X})
    np.testing.assert_array_equal(got["final"], X * 2 + 1)
    assert set(got) == {"final"} and isinstance(got["final"], np.ndarray)


def test_derived_contract_matches_jax():
    jrm, trm = _both(*_repos(), "chain", CHAIN, ["final", "mid"])
    assert _tensors(trm.spec) == _tensors(jrm.spec)
    assert [t.name for t in trm.spec.outputs] == ["final", "mid"]
    assert trm.spec.platform == jrm.spec.platform == "ensemble"
    assert trm.spec.extra == jrm.spec.extra
    assert trm.spec.extra == {"steps": ["scale", "shift"], "fused": False, "data_path": "host",
                              "step_precision": ["f32", "f32"]}


def test_fanout_shares_input():
    steps = [("scale", {"x": "raw"}, {"scaled": "a"}), ("shift", {"x": "raw"}, {"shifted": "b"})]
    jrm, trm = _both(*_repos(), "fan", steps, ["a", "b"])
    got = _same_outputs(jrm, trm, {"raw": np.ones((1, 4), np.float32)})
    np.testing.assert_array_equal(got["a"], 2.0)
    np.testing.assert_array_equal(got["b"], 2.0)
    assert [t.name for t in trm.spec.inputs] == ["raw"]


@pytest.mark.parametrize("device", [False, True], ids=["host", "fused"])
def test_serves_through_the_channel_as_jax(device):
    """Through ``CUDAChannel`` (the CPU) against JAX's ``TPUChannel``: the
    host ensemble through its ``infer_fn``, the fused one through the
    channel's launcher over its ``device_fn``."""
    jrepo, trepo = _repos(device)
    jrm, trm = _both(jrepo, trepo, "chain", CHAIN, ["final"])
    assert (trm.device_fn is not None) is device is trm.spec.extra["fused"]
    jrepo.register(jrm.spec, jrm.infer_fn, device_fn=jrm.device_fn)
    trepo.register(trm.spec, trm.infer_fn, device_fn=trm.device_fn)
    x = np.ones((2, 4), np.float32)
    want = TPUChannel(jrepo).do_inference(JRequest(model_name="chain", inputs={"raw": x}))
    got = CUDAChannel(trepo, device="cpu").do_inference(InferRequest("chain", {"raw": x}))
    np.testing.assert_array_equal(got.outputs["final"], np.asarray(want.outputs["final"]))
    np.testing.assert_array_equal(got.outputs["final"], 3.0)


def test_ensemble_of_ensemble():
    jrepo, trepo = _repos()
    jin, tin = _both(jrepo, trepo, "inner", [("scale", {"x": "raw"}, {"scaled": "out"})], ["out"])
    jrepo.register(jin.spec, jin.infer_fn)
    trepo.register(tin.spec, tin.infer_fn)
    steps = [("inner", {"raw": "raw"}, {"out": "mid"}), ("shift", {"x": "mid"}, {"shifted": "final"})]
    jout, tout = _both(jrepo, trepo, "outer", steps, ["final"])
    got = _same_outputs(jout, tout, {"raw": np.ones((1, 4), np.float32)})
    np.testing.assert_array_equal(got["final"], 3.0)


# -- config docs ---------------------------------------------------------------------


def _doc(**kw):
    return {"family": "ensemble", "steps": [
        {"model": "scale", "input_map": {"x": "raw"}, "output_map": {"scaled": "out"}}],
        "outputs": ["out"], **kw}


@pytest.mark.parametrize("fuse", [True, False, "never"])
def test_build_from_doc_matches_jax(fuse):
    """``max_batch_size`` is read, and ``fuse: true/false`` is a bool."""
    jrepo, trepo = _repos(device=True)
    doc = _doc(max_batch_size=4, fuse=fuse)
    jrm = jens.build_ensemble_doc(jrepo, "chain", doc)
    trm = tens.build_ensemble_doc(trepo, "chain", doc, device="cpu")
    assert trm.spec.max_batch_size == jrm.spec.max_batch_size == 4
    assert trm.spec.extra == jrm.spec.extra
    assert trm.spec.extra["fused"] is (fuse is True)
    _same_outputs(jrm, trm, {"raw": X})


@pytest.mark.parametrize("doc,match", [
    ({"family": "ensemble", "steps": [], "outputs": [], "gpu": 1}, "unknown config keys"),
    ({"family": "ensemble"}, "needs 'steps'"),
], ids=["unknown_keys", "missing_sections"])
def test_doc_errors_match_jax(doc, match):
    jrepo, trepo = _repos()
    msg = _same_error(lambda: jens.build_ensemble_doc(jrepo, "e", doc),
                      lambda: tens.build_ensemble_doc(trepo, "e", doc, device="cpu"))
    assert match in msg


# -- the device paths ----------------------------------------------------------------


def test_fused_matches_host_path_and_jax():
    jrepo, trepo = _repos(device=True)
    jf, tf = _both(jrepo, trepo, "chain", CHAIN, ["final"], fuse="auto")
    jh, th = _both(jrepo, trepo, "chain", CHAIN, ["final"], fuse="never")
    assert tf.spec.extra == jf.spec.extra and tf.spec.extra["data_path"] == "fused"
    assert th.spec.extra == jh.spec.extra and th.spec.extra["data_path"] == "host"
    fused = _same_outputs(jf, tf, {"raw": X})
    host = _same_outputs(jh, th, {"raw": X})
    assert isinstance(fused["final"], torch.Tensor) and isinstance(host["final"], np.ndarray)
    np.testing.assert_array_equal(fused["final"].numpy(), host["final"])
    np.testing.assert_array_equal(host["final"], X * 2 + 1)


def test_auto_falls_back_to_host_members():
    jrm, trm = _both(*_repos(), "chain", [("scale", {"x": "raw"}, {"scaled": "out"})], ["out"])
    assert trm.spec.extra["fused"] is jrm.spec.extra["fused"] is False
    got = _same_outputs(jrm, trm, {"raw": np.ones((1, 4), np.float32)})
    np.testing.assert_array_equal(got["out"], 2.0)


def test_mixed_dag_is_device_resident_as_jax():
    """Some members with a device form and one without: the device steps
    hand tensors over, the host-only step crosses the host; equal to the
    host path and to JAX's."""
    jrepo, trepo = _repos(device=True)
    _register(jrepo, trepo, "ids")  # host-only
    steps = CHAIN + [("ids", {"x": "final"}, {"classes": "classes"})]
    jm, tm = _both(jrepo, trepo, "mix", steps, ["final", "classes"])
    assert tm.spec.extra == jm.spec.extra and tm.spec.extra["data_path"] == "device-resident"
    got = _same_outputs(jm, tm, {"raw": X})
    _, th = _both(jrepo, trepo, "mix", steps, ["final", "classes"], fuse="never")
    host = th.infer_fn({"raw": X})
    np.testing.assert_array_equal(np.asarray(got["final"]), host["final"])
    assert got["classes"].dtype == host["classes"].dtype == np.int64
    assert tm.infer_fn.graph_stats()["calls"] == 2  # one captured function a device step


def test_nested_fusion_composes_device_fns():
    jrepo, trepo = _repos(device=True)
    jc, tc = _both(jrepo, trepo, "chain", CHAIN, ["final"], fuse="always")
    assert tc.device_fn is not None
    jrepo.register(jc.spec, jc.infer_fn, warmup=jc.warmup, device_fn=jc.device_fn)
    trepo.register(tc.spec, tc.infer_fn, warmup=tc.warmup, device_fn=tc.device_fn)
    steps = [("chain", {"raw": "x0"}, {"final": "mid"}), ("scale", {"x": "mid"}, {"scaled": "out"})]
    jp, tp = _both(jrepo, trepo, "parent", steps, ["out"], fuse="always")
    assert tp.spec.extra["fused"] is jp.spec.extra["fused"] is True
    x = np.ones((2, 4), np.float32)
    got = _same_outputs(jp, tp, {"x0": x})
    np.testing.assert_array_equal(got["out"].numpy(), (x * 2 + 1) * 2)


def test_fused_output_cast_to_spec_dtype():
    """The device form emits int32 classes; the spec says INT64, and the
    fused boundary casts to it, in both packages."""
    jrepo, trepo = _repos(device=True, names=("ids",))
    jrm, trm = _both(jrepo, trepo, "e", [("ids", {"x": "raw"}, {"classes": "out"})], ["out"],
                     fuse="always")
    got = _same_outputs(jrm, trm, {"raw": np.zeros((3, 4), np.float32)})
    assert got["out"].dtype == torch.int64


def test_fused_warmup_runs_the_dag():
    """The fused warmup runs the DAG on a nominal batch (wildcard dims 64,
    batch 1), not the members' warmups (none registered here)."""
    trepo = _repos(device=True)[1]
    trm = tens.build_ensemble(trepo, "chain", _steps(tens, CHAIN), outputs=["final"],
                              fuse="always", device="cpu")
    trm.warmup()
    stats = trm.infer_fn.graph_stats()
    assert stats["calls"] == 1 and stats["keys"] == 1


def test_3d_pipeline_device_fn_matches_its_infer_fn():
    """3D members are fusable too: the detect3d pipeline's device form
    gives its wire adapter's rows on the same padded cloud, bit for bit."""
    from test_torch_pointpillars import tiny_configs

    from triton_client_tpu_torch.pipelines.detect3d import build_pointpillars_pipeline

    _, tcfg = tiny_configs()
    pipe, _, _ = build_pointpillars_pipeline(model_cfg=tcfg, device="cpu")
    rng = np.random.default_rng(0)
    pts = np.stack([rng.uniform(0, 12.8, 512), rng.uniform(-6.4, 6.4, 512),
                    rng.uniform(-2, 0.5, 512), rng.uniform(0, 1, 512)], axis=1).astype(np.float32)
    n = min(pipe.config.point_buckets)
    padded = np.zeros((n, 4), np.float32)
    padded[: min(n, 512)] = pts[:n]
    inputs = {"points": torch.from_numpy(padded), "num_points": torch.tensor(min(n, 512),
                                                                              dtype=torch.int32)}
    wire = pipe.infer_fn()(inputs)
    dev = pipe.device_fn()(inputs)
    for k in wire:
        assert torch.equal(wire[k], dev[k]), k


# -- step precision (tests/test_precision.py) -----------------------------------------


def test_build_records_effective_step_precision():
    steps = [("scale", {"x": "raw"}, {"scaled": "mid"}, {"precision": "bf16"}),
             ("shift", {"x": "mid"}, {"shifted": "final"})]
    jrm, trm = _both(*_repos(), "chain", steps, ["final"])
    assert trm.spec.extra["step_precision"] == jrm.spec.extra["step_precision"] == ["bf16", "f32"]
    got = _same_outputs(jrm, trm, {"raw": X})
    np.testing.assert_array_equal(got["final"], X * 2 + 1)


def test_stage_cast_follows_the_step_precision():
    """On the fused path a ``bf16`` stage takes its floating inputs in
    bfloat16 (cast on the device), the next stage in float32 again; the
    values are JAX's fused path's."""
    jrepo, trepo = _repos(device=True)
    seen = []
    trepo.register(trepo.get("scale").spec, trepo.get("scale").infer_fn,
                   device_fn=lambda i: (seen.append(i["x"].dtype), {"scaled": i["x"] * 2.0})[1])
    steps = [("scale", {"x": "raw"}, {"scaled": "mid"}, {"precision": "bf16"}),
             ("shift", {"x": "mid"}, {"shifted": "final"})]
    jrm, trm = _both(jrepo, trepo, "chain", steps, ["final"], fuse="always")
    x = (X + 0.3).astype(np.float32)
    got = _same_outputs(jrm, trm, {"raw": x})
    assert seen == [torch.bfloat16] and got["final"].dtype == torch.float32


# -- the disk repository -------------------------------------------------------------


def _write(root, name, doc):
    (root / name).mkdir(parents=True, exist_ok=True)
    (root / name / "config.yaml").write_text(yaml.safe_dump(doc, sort_keys=False))


PIPE_STEPS = [{"model": "camera_preprocess", "input_map": {"images": "camera_raw"},
               "output_map": {"preprocessed": "frame"}},
              {"model": "yolov5_crop_base", "input_map": {"images": "frame"},
               "output_map": {"detections": "boxes", "valid": "valid"}}]


@pytest.fixture(scope="module")
def tiny_disk(tmp_path_factory):
    """A disk repository of ``camera_preprocess`` and ``yolov5_crop_base`` at
    64x64 (conf 0.05; seeded weights in 1/weights.msgpack) and ensembles
    over them, scanned by both packages (JAX's template drawn from a seed,
    not initialised). Directory order puts ensembles first and the outer of
    a nested pair before its inner."""
    root = tmp_path_factory.mktemp("tiny_disk")
    for name in ("camera_preprocess", "yolov5_crop_base"):
        text = (ROOT / "examples" / name / "config.yaml").read_text()
        text = text.replace("[512, 512]", "[64, 64]").replace("conf_thresh: 0.3",
                                                              "conf_thresh: 0.05")
        (root / name).mkdir()
        (root / name / "config.yaml").write_text(text)
    variables = yolo_variables()
    (root / "yolov5_crop_base" / "1").mkdir()
    jdr.save_flax_weights(root / "yolov5_crop_base" / "1" / "weights.msgpack", variables)
    _write(root, "aaa_pipeline", {"family": "ensemble", "steps": PIPE_STEPS[1:],
                                  "outputs": ["boxes", "valid"]})
    for fuse in ("always", "never"):
        _write(root, f"ens_{fuse}", {"family": "ensemble", "fuse": fuse, "steps": PIPE_STEPS,
                                     "outputs": ["boxes", "valid"], "max_batch_size": 8})
    _write(root, "z_inner", {"family": "ensemble", "fuse": "always", "steps": PIPE_STEPS,
                             "outputs": ["boxes", "valid"]})
    _write(root, "a_outer", {"family": "ensemble", "steps": [
        {"model": "z_inner", "input_map": {"camera_raw": "camera"},
         "output_map": {"boxes": "boxes", "valid": "valid"}}], "outputs": ["boxes"]})
    mp = pytest.MonkeyPatch()
    mp.chdir(ROOT)  # data/crop.names
    mp.setattr(jdr._Entry, "template", lambda self: variables)
    try:
        trepo = tdr.scan_disk(root, device="cpu")
        jrepo = jdr.scan_disk(root)
    finally:
        mp.undo()
    frames = np.random.default_rng(7).integers(0, 256, (2, 48, 80, 3), dtype=np.uint8)
    return root, jrepo, trepo, frames


def _rows(out):
    return np.asarray(out["boxes"], np.float32), np.asarray(out["valid"])


def _assert_rows_close(got, want):
    """Equal valid masks and counts; each image's rows matched one to one
    by box (a near-tie in score may order two rows differently: the
    forwards differ at the 5e-4 head bar), each pair within rtol 1e-3 /
    atol 1e-2 with equal labels."""
    (gb, gv), (wb, wv) = got, want
    np.testing.assert_array_equal(gv, wv)
    assert gv.sum() > 0
    for g_img, w_img, valid in zip(gb, wb, gv):
        g_rows, w_rows = g_img[valid], w_img[valid]
        free = list(range(len(w_rows)))
        for row in g_rows:
            match = [j for j in free if w_rows[j, 5] == row[5] and np.allclose(
                row[:4], w_rows[j, :4], rtol=1e-3, atol=1e-2)]
            assert match, f"no JAX row within the bars of {row}"
            free.remove(match[0])


def test_scan_disk_registers_ensembles_after_their_members(tiny_disk):
    _, jrepo, trepo, _ = tiny_disk
    assert sorted(trepo.list_models()) == sorted(jrepo.list_models())
    for name in ("aaa_pipeline", "ens_always", "ens_never", "z_inner", "a_outer"):
        t, j = trepo.get(name).spec, jrepo.get(name).spec
        assert t.platform == j.platform == "ensemble"
        assert _tensors(t) == _tensors(j)
    extra = {n: trepo.get(n).spec.extra["data_path"] for n in
             ("aaa_pipeline", "ens_always", "ens_never", "z_inner", "a_outer")}
    # auto over disk entries is the host path here (module docstring); the
    # fused inner ensemble registers its device form, so the outer fuses
    assert extra == {"aaa_pipeline": "host", "ens_always": "fused", "ens_never": "host",
                     "z_inner": "fused", "a_outer": "fused"}
    assert jrepo.get("aaa_pipeline").spec.extra["data_path"] == "fused"
    # plain entries keep their route: no device_fn, the device form offered aside
    for name in ("camera_preprocess", "yolov5_crop_base"):
        rm = trepo.get(name)
        assert rm.device_fn is None and rm.member_device_fn is not None


@pytest.mark.parametrize("name", ["ens_always", "ens_never", "a_outer"])
def test_disk_ensembles_match_jax(tiny_disk, name):
    _, jrepo, trepo, frames = tiny_disk
    key = "camera" if name == "a_outer" else "camera_raw"
    want = jrepo.get(name).infer_fn({key: frames})
    got = trepo.get(name).infer_fn({key: frames})
    if name == "a_outer":
        got["valid"] = trepo.get("z_inner").infer_fn({"camera_raw": frames})["valid"]
        want["valid"] = jrepo.get("z_inner").infer_fn({"camera_raw": frames})["valid"]
    _assert_rows_close(_rows(got), _rows(want))


def test_disk_fused_equals_host_and_the_hand_chain_bitwise(tiny_disk):
    """The fused DAG, the host path and the chain run by hand through the
    channel (preprocess, then the detector) give the same rows, bit for bit;
    so does ``aaa_pipeline`` on the preprocessed frame."""
    _, _, trepo, frames = tiny_disk
    channel = CUDAChannel(trepo, device="cpu")

    def ask(model, inputs):
        return channel.do_inference(InferRequest(model, inputs)).outputs

    fused = ask("ens_always", {"camera_raw": frames})
    host = ask("ens_never", {"camera_raw": frames})
    pre = ask("camera_preprocess", {"images": frames})["preprocessed"]
    hand = ask("yolov5_crop_base", {"images": pre})
    single = ask("aaa_pipeline", {"frame": pre})
    for other in (host, {"boxes": hand["detections"], "valid": hand["valid"]}, single):
        np.testing.assert_array_equal(fused["valid"], other["valid"])
        np.testing.assert_array_equal(fused["boxes"].view(np.int32),
                                      other["boxes"].view(np.int32))
    assert fused["valid"].sum() > 0


def test_disk_cycle_and_bad_member_raise_as_jax(tmp_path):
    for a, b in [("ens_a", "ens_b"), ("ens_b", "ens_a")]:
        _write(tmp_path / "cycle", a, {"family": "ensemble", "outputs": ["out"], "steps": [
            {"model": b, "input_map": {"x": "raw"}, "output_map": {"y": "out"}}]})
    msg = _same_error(lambda: jdr.scan_disk(tmp_path / "cycle"),
                      lambda: tdr.scan_disk(tmp_path / "cycle", device="cpu"))
    assert msg == "ensemble dependency cycle among ['ens_a', 'ens_b']"
    _write(tmp_path / "bad", "broken", {"family": "ensemble", "outputs": ["out"], "steps": [
        {"model": "missing_member", "input_map": {"x": "raw"}, "output_map": {"y": "out"}}]})
    msg = _same_error(lambda: jdr.scan_disk(tmp_path / "bad"),
                      lambda: tdr.scan_disk(tmp_path / "bad", device="cpu"))
    assert "not registered" in msg


def test_preprocess_entry_ignores_the_repository_precision(tmp_path, monkeypatch):
    """A repository-wide policy passes the paramless preprocess entry by, as
    JAX pops it; the entry registers version 1 with no version dir."""
    monkeypatch.chdir(ROOT)
    (tmp_path / "camera_preprocess").mkdir()
    shutil.copy(ROOT / "examples" / "camera_preprocess" / "config.yaml",
                tmp_path / "camera_preprocess" / "config.yaml")
    repo = tdr.scan_disk(tmp_path, device="cpu", precision="bf16")
    rm = repo.get("camera_preprocess")
    assert repo.versions("camera_preprocess") == ["1"] and rm.precision is None
    jrm = jdr.scan_disk(tmp_path, precision="bf16").get("camera_preprocess")
    assert _tensors(rm.spec) == _tensors(jrm.spec)
    frame = np.random.default_rng(1).integers(0, 256, (1, 48, 80, 3), dtype=np.uint8)
    np.testing.assert_allclose(rm.infer_fn({"images": torch.from_numpy(frame)})[
        "preprocessed"].numpy(), jrm.infer_fn({"images": frame})["preprocessed"], atol=1e-3)

