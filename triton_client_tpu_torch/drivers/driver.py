"""Channel adapters of the drivers (port of the 3D channel adapter of
``drivers/driver.py``).

``channel_infer3d`` turns a channel serving a 3D model into a callable
``points -> {pred_boxes, pred_scores, pred_labels}``: host prep
configured from the served metadata (feature width, z offset, point
buckets), then the padded (points, num_points) contract over the
channel. The inference driver loop, prefetching and sinks come later.
"""

from __future__ import annotations

from typing import Callable, Mapping

import numpy as np

from triton_client_tpu_torch.channel.base import InferRequest
from triton_client_tpu_torch.pipelines.detect3d import prepare_points, unpack_rows


def channel_infer3d(
    channel, model_name: str, model_version: str = "", z_offset: float | None = None
) -> Callable[[np.ndarray], Mapping[str, np.ndarray]]:
    """Adapter over ``channel`` for one served 3D model. ``z_offset=None``
    takes the served value; pass one to force a client-side correction."""
    spec = channel.get_metadata(model_name, model_version)
    buckets = sorted(spec.extra.get("point_buckets", [32768, 65536, 131072]))
    if z_offset is None:
        z_offset = float(spec.extra.get("z_offset", 0.0))
    pf = int(spec.inputs[0].shape[-1])  # the served point-feature width

    def infer(points: np.ndarray) -> Mapping[str, np.ndarray]:
        padded, m = prepare_points(points, pf, buckets, z_offset)
        resp = channel.do_inference(
            InferRequest(
                model_name=model_name,
                model_version=model_version,
                inputs={"points": padded, "num_points": np.asarray(m, np.int32)},
            )
        )
        return unpack_rows(
            np.asarray(resp.outputs["detections"]), np.asarray(resp.outputs["valid"])
        )

    return infer
