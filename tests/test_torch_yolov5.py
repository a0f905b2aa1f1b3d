"""The port's YOLOv5 against the JAX package's, with the flax weights
carried across by ``models/convert.yolov5_state_dict_from_flax``.

Heads are held at the bar of tests/test_import_fidelity.py (atol 5e-4,
rtol 1e-4): the two frameworks sum convolutions in other orders, and
flax folds BatchNorm as (x - mean) * (rsqrt(var + eps) * scale) + bias.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from triton_client_tpu.models.yolov5 import init_yolov5

from triton_client_tpu_torch.models.convert import yolov5_state_dict_from_flax
from triton_client_tpu_torch.models.yolov5 import YoloV5, num_predictions
from torch_threads import one_torch_thread  # noqa: F401


def _to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


@pytest.fixture(scope="module", params=[2, 3])
def carried(request):
    nc = request.param
    jmodel, variables = init_yolov5(jax.random.PRNGKey(0), num_classes=nc, input_hw=(64, 64))
    variables = _to_numpy(variables)
    tmodel = YoloV5(num_classes=nc, variant="n")
    tmodel.load_state_dict(yolov5_state_dict_from_flax(variables, tmodel))
    return nc, jmodel, variables, tmodel.eval()


def test_heads_and_decode_match_jax(carried):
    nc, jmodel, variables, tmodel = carried
    x = np.random.default_rng(1).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    want = jmodel.apply(variables, x, train=False)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x))
    assert [tuple(h.shape) for h in got] == [h.shape for h in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-4, rtol=1e-4)
    # decode on the same heads: the grid decode alone (sigmoid/exp ulps)
    dec = tmodel.decode([torch.from_numpy(np.array(w)) for w in want]).numpy()
    np.testing.assert_allclose(dec, np.asarray(jmodel.decode(want)), rtol=1e-6, atol=1e-4)
    assert dec.shape == (2, num_predictions((64, 64)), 5 + nc)


def test_strict_conversion_rejects_missing_and_extra_leaves(carried):
    _, _, variables, tmodel = carried
    missing = copy.deepcopy(variables)
    del missing["params"]["detect1"]["bias"]
    with pytest.raises(KeyError, match="unfilled"):
        yolov5_state_dict_from_flax(missing, tmodel)
    extra = copy.deepcopy(variables)
    extra["params"]["stem"]["bn"]["offset"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="unexpected flax leaf"):
        yolov5_state_dict_from_flax(extra, tmodel)
    stray = copy.deepcopy(variables)
    stray["params"]["stem2"] = copy.deepcopy(stray["params"]["stem"])
    with pytest.raises(KeyError, match="no such tensor"):
        yolov5_state_dict_from_flax(stray, tmodel)
    wrong = copy.deepcopy(variables)
    wrong["batch_stats"]["stem"]["bn"]["mean"] = np.zeros(5, np.float32)
    with pytest.raises(ValueError, match="shape"):
        yolov5_state_dict_from_flax(wrong, tmodel)


def test_s2d_ch_floor_layout_shapes_match_jax():
    """The layout of examples/yolov5_crop (s2d stem, 32-channel floor, a
    bfloat16 body) builds, with the JAX model's tensor shapes and a float32
    detect head."""
    jmodel, variables = init_yolov5(jax.random.PRNGKey(0), num_classes=2, input_hw=(64, 64),
                                    s2d=True, ch_floor=32)
    tmodel = YoloV5(num_classes=2, s2d=True, ch_floor=32, dtype=torch.bfloat16)
    want = yolov5_state_dict_from_flax(_to_numpy(variables), YoloV5(num_classes=2, s2d=True,
                                                                      ch_floor=32))
    got = tmodel.state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    assert tuple(got["stem.conv.weight"].shape) == (32, 12, 3, 3)
    assert got["stem.conv.weight"].dtype == torch.bfloat16
    assert got["detect0.weight"].dtype == torch.float32
    with torch.no_grad():
        heads = tmodel(torch.zeros((1, 64, 64, 3)))
    assert [h.dtype for h in heads] == [torch.float32] * 3
