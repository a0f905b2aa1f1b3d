"""The port's disk model repository and its YAML reader against the JAX
package's, on the CPU.

- ``yaml_subset`` equals ``yaml.safe_load`` on every YAML file under
  ``data/`` and ``examples/`` and on scalar edge cases, and raises (naming
  the file and line) on what is outside the subset.
- ``dataset_config`` builds the JAX package's configs from ``data/*.yaml``.
- ``scan_disk`` over the portable ``examples/`` entries
  (``yolov5_crop_base``, ``pointpillar_kitti``, ``pointpillar_wide``,
  ``second_iou``, ``centerpoint_nusc``) builds the JAX entries' specs and
  serves the same ``ModelConfig`` bytes; the JAX specs come from each
  entry's builder without an init (the template's ``param_bytes`` is then
  0, so that key is compared in tests/test_torch_server.py on carried
  weights, and here against the bytes of the JAX init's tree, traced with
  ``jax.eval_shape``, for the entries this file adds). Unported families and
  ``export_model`` raise naming their ROADMAP item; the ``s2d``/``ch_floor``
  /bf16 entries serve, and a version dir's ``weights.pt`` loads.
"""

import dataclasses
import math
import pathlib
import shutil

import numpy as np
import pytest
import torch
import yaml

from triton_client_tpu import dataset_config as jds
from triton_client_tpu.runtime import disk_repository as jdr
from triton_client_tpu.runtime.server import _Servicer as JServicer
from triton_client_tpu.runtime.repository import ModelRepository as JRepository

from triton_client_tpu_torch import dataset_config as tds
from triton_client_tpu_torch import yaml_subset
from triton_client_tpu_torch.channel.kserve import pb, service
from triton_client_tpu_torch.runtime import disk_repository as tdr
from triton_client_tpu_torch.models.yolov5 import YoloV5
from triton_client_tpu_torch.runtime.precision import stored_params, tree_bytes
from triton_client_tpu_torch.runtime.server import _Servicer
from tests.test_torch_server import yolo_variables

ROOT = pathlib.Path(__file__).resolve().parent.parent
YAML_FILES = sorted(
    str(p.relative_to(ROOT))
    for base in ("data", "examples")
    for p in (ROOT / base).rglob("*")
    if p.suffix in (".yaml", ".yml")
)
PORTABLE = ("yolov5_crop_base", "pointpillar_kitti", "pointpillar_wide", "second_iou",
            "centerpoint_nusc")


# -- yaml_subset -----------------------------------------------------------------


def test_every_yaml_file_is_found():
    assert len(YAML_FILES) >= 23


@pytest.mark.parametrize("rel", YAML_FILES)
def test_yaml_subset_equals_safe_load_on_every_file(rel):
    with open(ROOT / rel) as f:
        want = yaml.safe_load(f)
    assert yaml_subset.load(ROOT / rel) == want


SCALARS = [
    "a: 1", "a: -17", "a: +2", "a: 0", "a: -0", "a: 0x1f", "a: 017", "a: 08", "a: 0b101",
    "a: 1_000", "a: 1:30", "a: 1e3", "a: 1e-3", "a: 1.0e+3", "a: 1.5", "a: -39.68", "a: .5",
    "a: 0.", "a: -.inf", "a: .Inf", "a: yes", "a: No", "a: ON", "a: off", "a: y", "a: true",
    "a: False", "a: ~", "a: null", "a:", "a: 'x''y'", 'a: "x\\ty\\u00e9\\x41"', "a: 15s",
    "a: hello world", "a: http://host:8001/p", "a: localhost:9090", "'q': 1", "1: x",
    "true: y", "a: b # comment", "a: 'b # not a comment'", "a: [x,\n  y]",
    "a: [1, [2, 3], {b: c}]", "a: {b: , c: d}", "a: []", "a: {}", "k:\n- 1\n- 2\nz: 3",
    "- a\n- b: 1\n  c: 2\n-\n  - x\n  - y\n- - p\n  - q", "a:\n  b:\n    c: [1, 2]\n  d: e",
    "", "# only a comment\n",
]


@pytest.mark.parametrize("text", SCALARS)
def test_yaml_subset_resolves_scalars_as_safe_load(text):
    got, want = yaml_subset.loads(text), yaml.safe_load(text)
    assert got == want
    assert type(got) is type(want)
    if isinstance(want, dict):
        for k, v in want.items():
            assert type(got[k]) is type(v), k


def test_yaml_subset_nan_is_nan():
    assert math.isnan(yaml_subset.loads("a: .nan")["a"])


REFUSED = {
    "anchor": "a: &x 1\nb: *x",
    "alias": "a: *x",
    "block scalar": "a: |\n  text",
    "folded scalar": "a: >\n  text",
    "tab": "a:\n\tb: 1",
    "tag": "a: !!str 1",
    "document marker": "---\na: 1",
    "timestamp": "a: 2001-12-14",
    "complex key": "? a\n: b",
    "multi-line plain scalar": "a: b\n  c",
    "merge key": "a: {x: 1}\nb:\n  <<: 1",
}


@pytest.mark.parametrize("what", sorted(REFUSED))
def test_yaml_subset_refuses_with_file_and_line(what):
    text = REFUSED[what]
    with pytest.raises(yaml_subset.YAMLSubsetError, match=r"^cfg\.yaml:\d+: "):
        yaml_subset.loads(text, "cfg.yaml")


# -- dataset_config ------------------------------------------------------------


def _fields(obj):
    """A config dataclass as a dict over its own fields, nested ones too."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            v = _fields(v)
        elif isinstance(v, tuple) and v and dataclasses.is_dataclass(v[0]):
            v = [_fields(x) for x in v]
        out[f.name] = v
    return out


@pytest.mark.parametrize("name", ["kitti_pointpillars", "kitti_pointpillars_capacity",
                                  "kitti_second", "kitti_second_dense01", "nusc_centerpoint",
                                  "kitti_centerpoint"])
def test_detect3d_from_yaml_builds_the_jax_configs(name):
    path = str(ROOT / "data" / f"{name}.yaml")
    jmodel, jmcfg, jpcfg = jds.detect3d_from_yaml(path)
    tmodel, tmcfg, tpcfg = tds.detect3d_from_yaml(path)
    assert tmodel == jmodel
    for got, want in ((tmcfg, jmcfg), (tpcfg, jpcfg)):
        got, want = _fields(got), _fields(want)
        for k, v in got.items():
            assert want[k] == v, k


def test_client_params_equal_jax():
    path = str(ROOT / "data" / "client_parameter.yaml")
    assert tds.client_params(path) == jds.client_params(path)
    assert tds.client_params() == jds.client_params()


def test_unknown_keys_raise_in_both_packages():
    for mod in (jds, tds):
        with pytest.raises(KeyError, match="bogus"):
            mod.model_config_from_dict("pointpillars", {"bogus": 1})
        with pytest.raises(KeyError, match="bogus"):
            mod.voxel_from_dict({"bogus": 1})


# -- scan_disk -------------------------------------------------------------------


def _copy_entries(tmp, names):
    for name in names:
        (tmp / name).mkdir()
        shutil.copy(ROOT / "examples" / name / "config.yaml", tmp / name / "config.yaml")
    return tmp


@pytest.fixture(scope="module")
def scanned(tmp_path_factory, monkeypatch_module):
    """The port's scan of the portable entries (config.yaml only; the
    names and dataset files resolve from the checkout) beside the JAX
    entries' specs."""
    monkeypatch_module.chdir(ROOT)
    root = _copy_entries(tmp_path_factory.mktemp("repo"), PORTABLE)
    repo = tdr.scan_disk(root, device="cpu")
    jspecs = {}
    for name in PORTABLE:
        entry = jdr._Entry(root / name)
        _, spec, _ = entry._build(variables={}, config=entry.cfg)
        jspecs[name] = dataclasses.replace(
            spec, name=name, version="1",
            max_batch_size=int(entry.doc.get("max_batch_size", spec.max_batch_size)),
        )
    return repo, jspecs


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.mark.parametrize("name", PORTABLE)
def test_scan_disk_builds_the_jax_specs(scanned, name):
    repo, jspecs = scanned
    got, want = repo.metadata(name), jspecs[name]
    assert repo.versions(name) == ["1"]
    assert (got.name, got.version, got.max_batch_size) == (want.name, want.version,
                                                           want.max_batch_size)
    assert got.platform == "torch"
    assert [(t.name, t.shape, t.dtype, t.layout) for t in got.inputs + got.outputs] == \
        [(t.name, t.shape, t.dtype, t.layout) for t in want.inputs + want.outputs]
    assert set(got.extra) == set(want.extra)
    for key, value in got.extra.items():
        if key != "param_bytes":
            assert want.extra[key] == value, key
    assert got.extra["param_bytes"] > 0


@pytest.mark.parametrize("name", PORTABLE)
def test_scan_disk_serves_the_jax_model_config(scanned, name):
    """ModelConfig bytes from the port's servicer equal the JAX servicer's
    on the JAX spec, once its platform and param_bytes are the port's."""
    repo, jspecs = scanned
    got_spec = repo.metadata(name)
    want_spec = dataclasses.replace(
        jspecs[name], platform=got_spec.platform,
        extra={**jspecs[name].extra, "param_bytes": got_spec.extra["param_bytes"]},
    )
    jrepo = JRepository()
    jrepo.register(want_spec, lambda inputs: inputs)
    request = pb.ModelConfigRequest(name=name).SerializeToString()
    got = service.invoke(_Servicer(repo, channel=None), "ModelConfig", request)
    from triton_client_tpu.channel.kserve import pb as jpb

    want = JServicer(jrepo, channel=None).ModelConfig(
        jpb.ModelConfigRequest.FromString(request), None
    ).SerializeToString(deterministic=True)
    assert got == want


def _jax_tree_bytes(name):
    """The bytes of the JAX entry's init tree (params and batch stats),
    traced with ``jax.eval_shape``: nothing is initialised."""
    import jax

    from triton_client_tpu.models.centerpoint import init_centerpoint
    from triton_client_tpu.models.pointpillars import init_pointpillars

    entry = jdr._Entry(ROOT / "examples" / name)
    init = {"pointpillars": init_pointpillars, "centerpoint": init_centerpoint}[entry.family]
    _, model_cfg, _ = jds.detect3d_from_yaml(str(ROOT / entry.doc["dataset"]))
    tree = jax.eval_shape(lambda k: init(k, model_cfg)[1], jax.random.PRNGKey(0))
    return sum(int(np.prod(x.shape)) * x.dtype.itemsize for x in jax.tree_util.tree_leaves(tree))


@pytest.mark.parametrize("name,want", [("pointpillar_wide", 137950496),
                                       ("centerpoint_nusc", None)])
def test_new_3d_entries_store_the_jax_trees_bytes(scanned, monkeypatch, name, want):
    """``param_bytes`` of the entries this port serves since CenterPoint
    equals the JAX init tree's (float32 both); CenterPoint's spec serves
    the velocity columns and output as JAX's does."""
    monkeypatch.chdir(ROOT)
    repo, _ = scanned
    got = repo.metadata(name).extra["param_bytes"]
    assert got == _jax_tree_bytes(name)
    assert want is None or got == want
    if name == "centerpoint_nusc":
        spec = repo.metadata(name)
        assert spec.extra["with_velocity"] is True and spec.extra["iou_thresh"] == 0.2
        assert [(t.name, t.shape) for t in spec.outputs] == [
            ("detections", (128, 11)), ("valid", (128,)), ("velocities", (128, 2))]
        assert spec.inputs[0].shape == (-1, 5)
        assert spec.extra["point_buckets"] == [131072, 262144]


def test_scanned_entries_carry_a_warmup_and_serve(scanned):
    repo, _ = scanned
    model = repo.get("yolov5_crop_base")
    assert model.warmup is not None
    dets = model.infer_fn({"images": torch.zeros((1, 64, 64, 3))})
    assert tuple(dets["detections"].shape) == (1, 300, 6)


UNPORTED = {
    "yolov4_coco": "item 7", "retinanet_coco": "item 7", "fcos_crop": "item 7",
    "camera_preprocess": "item 7", "ensemble_crop_pipeline": "item 7",
    "ensemble_fused_pipeline": "item 7",
}
LAYOUT_ENTRIES = ("yolov5_crop", "yolov5_crop_mxu", "yolov5l_crop")


@pytest.mark.parametrize("name", sorted(UNPORTED))
def test_unported_entries_raise_naming_their_item(tmp_path, monkeypatch, name):
    monkeypatch.chdir(ROOT)
    root = _copy_entries(tmp_path, [name])
    with pytest.raises(NotImplementedError, match=UNPORTED[name]):
        tdr.scan_disk(root, device="cpu")


@pytest.mark.parametrize("name", LAYOUT_ENTRIES)
def test_layout_entries_serve(tmp_path, monkeypatch, name):
    """The s2d/ch_floor/bf16 entries scan as they stand, with the JAX entry's
    spec but for the bytes the port stores; a 64x64 copy answers a request on
    the CPU."""
    monkeypatch.chdir(ROOT)
    root = _copy_entries(tmp_path, [name])
    repo = tdr.scan_disk(root, device="cpu")
    model = repo.get(name)
    jentry = jdr._Entry(root / name)
    _, jspec, _ = jentry._build(variables={}, config=jentry.cfg)
    got = {k: v for k, v in model.spec.extra.items() if k != "param_bytes"}
    want = {k: v for k, v in jspec.extra.items() if k != "param_bytes"}
    assert got == want and got["precision"] == "f32"
    assert model.precision.name == "f32"
    # the body is stored in bfloat16 (dtype: bf16), the detect convs in
    # float32: just over half the float32 bytes
    variant = "l" if name == "yolov5l_crop" else "n"
    f32 = tree_bytes(stored_params(YoloV5(num_classes=2, variant=variant, s2d=True,
                                          ch_floor=32)))
    assert 0.5 * f32 < model.spec.extra["param_bytes"] < 0.51 * f32
    text = (root / name / "config.yaml").read_text().replace("[512, 512]", "[64, 64]")
    (root / name / "config.yaml").write_text(text)
    small = tdr.scan_disk(root, device="cpu").get(name)
    out = small.infer_fn({"images": torch.rand((1, 64, 64, 3)) * 255})
    assert tuple(out["detections"].shape) == (1, 300, 6)
    assert bool(torch.isfinite(out["detections"]).all())


@pytest.mark.parametrize("how", ["dtype", "precision", "override"])
def test_bf16_on_a_3d_entry_raises_naming_item_11(tmp_path, monkeypatch, how):
    monkeypatch.chdir(ROOT)
    root = _copy_entries(tmp_path, ["pointpillar_kitti"])
    config = root / "pointpillar_kitti" / "config.yaml"
    if how != "override":
        config.write_text(config.read_text() + f"model:\n  {how}: bf16\n")
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 11 "):
        tdr.scan_disk(root, device="cpu", precision="bf16" if how == "override" else None)


def test_weight_artifacts_load_and_export_raises_naming_item_12(tmp_path, monkeypatch):
    """A version dir's weights.pt (an upstream-named state_dict) serves
    through scan_disk and load_pipeline alike; export_model raises naming
    its item."""
    from tests.test_import_fidelity import TYoloV5N, _randomize

    monkeypatch.chdir(ROOT)
    root = _copy_entries(tmp_path, ["yolov5_crop_base"])
    entry = root / "yolov5_crop_base"
    (entry / "config.yaml").write_text(
        (entry / "config.yaml").read_text().replace("[512, 512]", "[64, 64]"))
    tmodel = TYoloV5N(2).eval()
    _randomize(tmodel, 3)
    (entry / "1").mkdir()
    torch.save({"model": tmodel.state_dict()}, entry / "1" / "weights.pt")
    frames = torch.rand((2, 64, 64, 3)) * 255
    served = tdr.scan_disk(root, device="cpu").get("yolov5_crop_base").infer_fn(
        {"images": frames})
    pipe, spec = tdr.load_pipeline(entry, device="cpu")
    direct = pipe.infer_fn()({"images": frames})
    assert spec.version == "1"
    for k in ("detections", "valid"):
        assert torch.equal(served[k], direct[k])
    with pytest.raises(NotImplementedError, match="item 12"):
        tdr.export_model(tmp_path, "x", {"family": "yolov5"})


def test_version_dir_without_an_artifact_raises_in_both(tmp_path, monkeypatch):
    monkeypatch.chdir(ROOT)
    root = _copy_entries(tmp_path, ["yolov5_crop_base"])
    (root / "yolov5_crop_base" / "2").mkdir()
    (root / "yolov5_crop_base" / "2" / "weights.typo").write_bytes(b"")
    for scan in (lambda: tdr.scan_disk(root, device="cpu"), lambda: jdr.scan_disk(root)):
        with pytest.raises(FileNotFoundError, match="no weight artifact"):
            scan()


@pytest.mark.parametrize("bad", [{"bogus": 1}, {"pipeline": {"bogus": 1}}])
def test_unknown_config_keys_raise_in_both(tmp_path, monkeypatch, bad):
    monkeypatch.chdir(ROOT)
    doc = {"family": "yolov5", "model": {"variant": "n", "input_hw": [64, 64]}, **bad}
    (tmp_path / "m").mkdir()
    (tmp_path / "m" / "config.yaml").write_text(yaml.safe_dump(doc))
    for build in (lambda: jdr._Entry(tmp_path / "m"), lambda: tdr._Entry(tmp_path / "m")):
        with pytest.raises(KeyError, match="bogus"):
            build()


def test_missing_names_file_raises(tmp_path):
    (tmp_path / "m").mkdir()
    (tmp_path / "m" / "config.yaml").write_text(
        "family: yolov5\npipeline:\n  class_names_file: nowhere.names\n")
    with pytest.raises(FileNotFoundError, match="nowhere.names"):
        tdr._Entry(tmp_path / "m", device="cpu")


TINY_2D = """family: yolov5
model:
  variant: n
  input_hw: [64, 64]
pipeline:
  class_names_file: data/crop.names
  conf_thresh: 0.05
  max_det: 50
max_batch_size: 4
"""


def test_registered_with_carried_variables_is_the_builders_pipeline(tmp_path, monkeypatch):
    """A 64x64 YOLOv5n entry registered with a flax variable tree: the JAX
    entry's spec (param_bytes included) and, bit for
    bit, the pipeline ``build_yolov5_pipeline`` makes from those variables
    and the entry's settings (which tests/test_torch_detect2d.py holds to
    the JAX pipeline; tests/test_torch_server.py holds a served entry to
    the JAX server)."""
    from triton_client_tpu_torch.pipelines.detect2d import Detect2DConfig, build_yolov5_pipeline

    monkeypatch.chdir(ROOT)
    (tmp_path / "tiny").mkdir()
    (tmp_path / "tiny" / "config.yaml").write_text(TINY_2D)
    jentry = jdr._Entry(tmp_path / "tiny")
    variables = yolo_variables()  # the 64x64 YOLOv5n tree, seeded (no init)
    _, jspec, _ = jentry._build(variables=variables, config=jentry.cfg)
    trm = tdr._Entry(tmp_path / "tiny", device="cpu").registered("3", variables=variables)
    assert (trm.spec.name, trm.spec.version, trm.spec.max_batch_size) == ("tiny", "3", 4)
    for key, value in trm.spec.extra.items():
        assert jspec.extra[key] == value, key
    names = ("weeds", "maize")
    cfg = Detect2DConfig(model_name="yolov5n", input_hw=(64, 64), num_classes=2,
                         conf_thresh=0.05, max_det=50, class_names=names)
    pipe, _, _ = build_yolov5_pipeline(num_classes=2, input_hw=(64, 64), variables=variables,
                                       config=cfg, device="cpu")
    frames = torch.from_numpy(
        np.random.default_rng(5).integers(0, 255, (2, 48, 80, 3)).astype(np.float32))
    got = trm.infer_fn({"images": frames})
    want = pipe.infer_fn()({"images": frames})
    assert torch.equal(got["valid"], want["valid"]) and got["valid"].sum() > 10
    assert torch.equal(got["detections"], want["detections"])


def test_scan_disk_runs_on_cuda_unless_asked(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    monkeypatch.chdir(ROOT)
    root = _copy_entries(tmp_path, ["yolov5_crop_base"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdr.scan_disk(root)
