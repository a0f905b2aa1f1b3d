"""The inference event loop (port of ``drivers/driver.py``).

The loop is pull-driven with a bounded prefetch queue: a producer thread
reads and decodes upcoming frames while the card runs the current one.
The driver is model-agnostic: it pumps ``Frame``s through an
``infer(data) -> {name: array}`` callable (the adapters below wrap the
2D/3D pipelines and the channel), optionally scores each frame against
ground truth (``evaluator``, ``gt_lookup``) and reports throughput and
latency percentiles.
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
from typing import Any, Callable, Mapping

import numpy as np

from triton_client_tpu_torch.channel.base import InferRequest
from triton_client_tpu_torch.io.sinks import Sink
from triton_client_tpu_torch.io.sources import Frame
from triton_client_tpu_torch.pipelines.detect3d import prepare_points, unpack_rows

InferFn = Callable[[np.ndarray], Mapping[str, Any]]
# the --async variant: the callable dispatches and returns a future whose
# result() yields the Mapping (channel/base.py InferFuture)
AsyncInferFn = Callable[[np.ndarray], Any]

_SENTINEL = object()


@dataclasses.dataclass
class DriverStats:
    frames: int = 0
    wall_s: float = 0.0
    fps: float = 0.0
    p50_ms: float = 0.0
    p99_ms: float = 0.0
    mean_ms: float = 0.0
    # device dispatches: == frames one frame a dispatch, frames / batch size
    # batched (latency percentiles are per dispatch)
    ticks: int = 0
    # camera views skipped by cross-camera suppression (the multi-camera
    # driver of the JAX package, not ported: always 0 here)
    suppressed: int = 0

    def to_dict(self) -> dict[str, float]:
        return dataclasses.asdict(self)


def latency_stats(latencies_s: list, frames: int, wall_s: float, ticks: int) -> DriverStats:
    """Percentile and fps arithmetic of the drivers."""
    lat_ms = np.asarray(latencies_s) * 1e3
    n = len(latencies_s)
    return DriverStats(
        frames=frames,
        wall_s=wall_s,
        fps=frames / wall_s if wall_s > 0 else 0.0,
        p50_ms=float(np.percentile(lat_ms, 50)) if n else 0.0,
        p99_ms=float(np.percentile(lat_ms, 99)) if n else 0.0,
        mean_ms=float(lat_ms.mean()) if n else 0.0,
        ticks=ticks,
    )


class InferenceDriver:
    """Prefetching pull loop: source -> infer -> sink (+ eval)."""

    def __init__(
        self,
        infer: InferFn,
        source,
        sink: Sink | None = None,
        prefetch: int = 4,
        warmup: int = 1,
        evaluator=None,
        gt_lookup: Callable[[Frame], np.ndarray | None] | None = None,
        profiler=None,
        batch_size: int = 1,
        inflight: int = 1,
    ) -> None:
        """``evaluator``: an ``eval.detection_map`` evaluator scored through
        ``gt_lookup``, which maps a frame to its ground truth (2D: (n, 5)
        [x1, y1, x2, y2, cls]; 3D: (n, 8) boxes and class) or None.
        ``profiler``: optional object with ``record(stage, seconds)``;
        records source/infer/sink stage latencies. ``batch_size`` > 1
        stacks that many frames a dispatch (frames must share a shape) and
        demuxes the results back per frame. ``inflight`` > 1 selects the
        async pump: ``infer`` must then return a future (``.result() ->
        Mapping``) and up to ``inflight`` dispatches overlap, retired in
        issue order. The two are mutually exclusive."""
        self.infer = infer
        self.source = source
        self.sink = sink
        self.prefetch = prefetch
        self.warmup = warmup
        self.evaluator = evaluator
        self.gt_lookup = gt_lookup
        self.profiler = profiler
        self.batch_size = max(1, int(batch_size))
        self.inflight = max(1, int(inflight))
        if self.batch_size > 1 and self.inflight > 1:
            raise ValueError(
                "batch_size and inflight both pipeline the device; "
                "pick one (batched sync dispatch or async futures)"
            )

    def run(self, max_frames: int = 0) -> DriverStats:
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        error: list[BaseException] = []

        def produce() -> None:
            try:
                it = iter(self.source)
                i = 0
                while not max_frames or i < max_frames:
                    t0 = time.perf_counter()
                    frame = next(it, _SENTINEL)
                    if frame is _SENTINEL:
                        break
                    if self.profiler is not None:
                        self.profiler.record("source", time.perf_counter() - t0)
                    q.put(frame)
                    i += 1
            except BaseException as e:  # propagate into the consumer
                error.append(e)
            finally:
                q.put(_SENTINEL)

        producer = threading.Thread(target=produce, daemon=True)
        producer.start()

        latencies: list[float] = []
        n = 0
        first = q.get()
        if first is _SENTINEL:
            if error:
                raise error[0]
            return DriverStats()
        # warmup outside the timed window (the first call of a shape
        # captures its CUDA graph); batched mode warms the batched shape
        frame = first
        b = self.batch_size
        for _ in range(self.warmup):
            if self.inflight > 1:
                self.infer(frame.data).result()
            elif b > 1:
                self.infer(np.stack([np.asarray(frame.data)] * b))
            else:
                self.infer(frame.data)

        if self.inflight > 1:
            return self._run_async(q, first, error)

        ticks = 0
        t_start = time.perf_counter()
        try:
            while frame is not _SENTINEL:
                batch = [frame]
                while len(batch) < b:
                    nxt = q.get()
                    if nxt is _SENTINEL:
                        frame = _SENTINEL  # the outer loop ends after this batch
                        break
                    batch.append(nxt)

                t0 = time.perf_counter()
                if b > 1:
                    datas = [np.asarray(f.data) for f in batch]
                    if len({d.shape for d in datas}) > 1:
                        raise ValueError(
                            "batched dispatch needs uniform frame shapes; "
                            f"got {sorted({d.shape for d in datas})} — "
                            "resize upstream or use batch_size=1"
                        )
                    # pad a trailing partial batch to the warmed shape: a
                    # (b-1, ...) dispatch would capture a graph in the loop
                    datas += [datas[-1]] * (b - len(batch))
                    result = self.infer(np.stack(datas))
                else:
                    result = self.infer(batch[0].data)
                dt = time.perf_counter() - t0
                latencies.append(dt)
                ticks += 1
                if self.profiler is not None:
                    self.profiler.record("infer", dt)
                n += len(batch)

                if b > 1:
                    arrs = {k: np.asarray(v) for k, v in result.items()}
                for i, f in enumerate(batch):
                    if b > 1:
                        per = {
                            k: v[i] if np.ndim(v) > 0 and np.shape(v)[0] == b else v
                            for k, v in arrs.items()
                        }
                    else:
                        per = result
                    self._deliver(f, per)
                if frame is not _SENTINEL:
                    frame = q.get()
            wall = time.perf_counter() - t_start
        finally:
            # close even on infer errors: buffered sinks must flush what they hold
            if self.sink is not None:
                self.sink.close()
        if error:
            raise error[0]

        return latency_stats(latencies, frames=n, wall_s=wall, ticks=ticks)

    def _run_async(self, q: queue.Queue, first, error: list) -> DriverStats:
        """Async pump: keep up to ``inflight`` dispatches outstanding,
        retire in issue order. Per-frame latency is issue -> retire."""
        latencies: list[float] = []
        pending: collections.deque = collections.deque()
        n = 0
        frame = first
        t_start = time.perf_counter()

        def retire() -> None:
            nonlocal n
            f, t0, fut = pending.popleft()
            result = fut.result()
            dt = time.perf_counter() - t0
            latencies.append(dt)
            if self.profiler is not None:
                self.profiler.record("infer", dt)
            n += 1
            self._deliver(f, result)

        try:
            while True:
                # dispatch the frame in hand, retire once the window is full,
                # and only then block on the source for the next frame
                if frame is not _SENTINEL:
                    t0 = time.perf_counter()
                    pending.append((frame, t0, self.infer(frame.data)))
                if pending and (frame is _SENTINEL or len(pending) >= self.inflight):
                    retire()
                if frame is _SENTINEL:
                    if not pending:
                        break
                else:
                    frame = q.get()
            wall = time.perf_counter() - t_start
        finally:
            if self.sink is not None:
                self.sink.close()
        if error:
            raise error[0]
        return latency_stats(latencies, frames=n, wall_s=wall, ticks=n)

    def _deliver(self, frame, per: Mapping[str, Any]) -> None:
        """The per-frame tail of both loops: the sink write and the
        optional scoring."""
        if self.sink is not None:
            t1 = time.perf_counter()
            self.sink.write(frame, per)
            if self.profiler is not None:
                self.profiler.record("sink", time.perf_counter() - t1)
        if self.evaluator is not None and self.gt_lookup is not None:
            gts = self.gt_lookup(frame)
            if gts is not None:
                # the evaluator's adapter owns the output contract (2D
                # packed rows, 3D pred_boxes dict)
                self.evaluator.add_frame_from(per, gts)


def detect2d_infer(pipeline) -> InferFn:
    """Adapter over Detect2DPipeline.infer's (dets, valid) pair."""

    def fn(image: np.ndarray) -> Mapping[str, Any]:
        dets, valid = pipeline.infer(image)
        return {"detections": dets, "valid": valid}

    return fn


def detect3d_infer(pipeline) -> InferFn:
    """Adapter over Detect3DPipeline.infer's dict (the reference 3D client
    contract pred_boxes/scores/labels)."""

    def fn(points: np.ndarray) -> Mapping[str, Any]:
        return pipeline.infer(points)

    return fn


def detect3d_infer_async(pipeline) -> AsyncInferFn:
    """Async adapter for the in-process 3D pipeline: host prep and the
    graph's replay happen at call time, the readback waits in the returned
    future, so the driver pads scan N+1 while the card runs scan N."""

    def fn(points: np.ndarray):
        return pipeline.infer_dispatch(points)

    return fn


def channel_infer3d(
    channel,
    model_name: str,
    model_version: str = "",
    z_offset: float | None = None,
    asynchronous: bool = False,
) -> InferFn | AsyncInferFn:
    """Adapter over ``channel`` for one served 3D model: host prep
    configured from the served metadata (feature width, z offset, point
    buckets), then the padded (points, num_points) contract over the
    channel. ``z_offset=None`` takes the served value; pass one to force a
    client-side correction. ``asynchronous=True`` returns futures for the
    driver's inflight pump."""
    spec = channel.get_metadata(model_name, model_version)
    buckets = sorted(spec.extra.get("point_buckets", [32768, 65536, 131072]))
    if z_offset is None:
        z_offset = float(spec.extra.get("z_offset", 0.0))
    pf = int(spec.inputs[0].shape[-1])  # the served point-feature width

    def make_request(points: np.ndarray) -> InferRequest:
        padded, m = prepare_points(points, pf, buckets, z_offset)
        return InferRequest(
            model_name=model_name,
            model_version=model_version,
            inputs={"points": padded, "num_points": np.asarray(m, np.int32)},
        )

    def unpack(resp) -> Mapping[str, np.ndarray]:
        return unpack_rows(
            np.asarray(resp.outputs["detections"]), np.asarray(resp.outputs["valid"])
        )

    if asynchronous:
        return lambda points: channel.do_inference_async(make_request(points)).map(unpack)
    return lambda points: unpack(channel.do_inference(make_request(points)))


def channel_infer(
    channel,
    model_name: str,
    input_name: str = "images",
    model_version: str = "",
    asynchronous: bool = False,
) -> InferFn | AsyncInferFn:
    """Adapter that round-trips through a channel (``CUDAChannel``
    in-process). Single frames gain a batch dim on the way in and lose it
    on the way out. With ``asynchronous=True`` the callable returns
    futures for the driver's inflight pump."""

    def make_request(data: np.ndarray) -> InferRequest:
        if input_name == "images" and data.ndim == 3:
            # a reshape, not data[None]: the batch axis gets a real stride,
            # as in a staged or wire copy (PyTorch's CPU kernels may round
            # differently on a stride-0 axis), so in-process and remote
            # runs see the same tensor
            data = data.reshape((1, *data.shape))
        return InferRequest(
            model_name=model_name, model_version=model_version, inputs={input_name: data}
        )

    def unpack(resp) -> Mapping[str, Any]:
        out = dict(resp.outputs)
        if input_name == "images" and "detections" in out:
            # un-batch single-frame results for sink uniformity
            if out["detections"].ndim == 3 and out["detections"].shape[0] == 1:
                out = {k: v[0] for k, v in out.items()}
        return out

    if asynchronous:
        return lambda data: channel.do_inference_async(make_request(data)).map(unpack)
    return lambda data: unpack(channel.do_inference(make_request(data)))

