"""GRPCChannel: the KServe v2 client channel (the port's copy of
``channel/grpc_channel.py``).

A driver points at a remote server (this package's ``InferenceServer``,
the JAX package's, or a stock Triton) through the same ``BaseChannel``
seam ``CUDAChannel`` implements.

- The message cap starts at a 64 MiB floor and grows on demand:
  ``get_metadata`` sizes the served contract and re-dials with a larger
  cap when the model needs one.
- Requests are built per call from typed arrays (the zero-copy codec), so
  the channel is thread-safe and drivers can pipeline.
- Transient failures retry with capped exponential backoff and full
  jitter. ``ModelInfer`` re-issues only on ``UNAVAILABLE``: a
  ``DEADLINE_EXCEEDED`` or ``RESOURCE_EXHAUSTED`` request may have run on
  the server, and ``INTERNAL`` (a kernel fault) is surfaced as it is.
- ``grpc`` is imported when the channel dials, never at module import;
  :data:`DeadlineExceededRpcError` (a ``grpc.RpcError``) is built then.

The shared-memory transport of the JAX client waits for the port's
shared-memory registry (ROADMAP.md Queue 1 item 8): ``use_shared_memory=
True`` raises, and every endpoint rides the wire (``transport`` reads
``grpc`` or ``uds``).
"""

from __future__ import annotations

import collections
import json
import logging
import random
import time

import numpy as np

from triton_client_tpu_torch.channel.base import (
    BaseChannel,
    InferFuture,
    InferRequest,
    InferResponse,
)
from triton_client_tpu_torch.channel.kserve import codec, pb, service
from triton_client_tpu_torch.config import FRAMING_BYTES, ModelSpec, TensorSpec
from triton_client_tpu_torch.obs.trace import SUMMARY_PARAM_KEY, TraceContext

log = logging.getLogger(__name__)

# retry backoff ceiling: with jitter, a fleet's retries decorrelate
_BACKOFF_CAP_S = 5.0

_DEADLINE_ERROR: type | None = None


def _deadline_error_class() -> type:
    """``DeadlineExceededRpcError``, subclassing ``grpc.RpcError``: built
    on first use, where ``grpc`` is imported."""
    global _DEADLINE_ERROR
    if _DEADLINE_ERROR is None:
        import grpc

        class DeadlineExceededRpcError(grpc.RpcError):
            """Client-local deadline failure, raised without touching the
            wire when the request's remaining budget is gone (or the next
            backoff would spend it). Answers ``code()``/``details()`` like a
            server-sent DEADLINE_EXCEEDED."""

            def __init__(self, details: str) -> None:
                super().__init__(details)
                self._details = details

            def code(self):
                return grpc.StatusCode.DEADLINE_EXCEEDED

            def details(self) -> str:
                return self._details

        _DEADLINE_ERROR = DeadlineExceededRpcError
    return _DEADLINE_ERROR


def __getattr__(name: str):
    if name == "DeadlineExceededRpcError":
        return _deadline_error_class()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _wire_params(request: InferRequest) -> dict | None:
    """Request-level parameters of one outbound ModelInfer: the trace
    context (when the request's trace carries one), the priority and the
    sequence parameters. None on the plain path."""
    params = None
    tr = request.trace
    ctx = getattr(tr, "context", None) if tr is not None else None
    if ctx is not None:
        params = {TraceContext.PARAM_KEY: ctx.encode()}
    if request.priority:
        params = params or {}
        params["priority"] = int(request.priority)
    if request.sequence_id:
        params = params or {}
        params[codec.SEQUENCE_ID_PARAM] = str(request.sequence_id)
        if request.sequence_start:
            params[codec.SEQUENCE_START_PARAM] = True
        if request.sequence_end:
            params[codec.SEQUENCE_END_PARAM] = True
    return params


def _response_params(resp) -> dict | None:
    """Response-level parameters off the wire: the server's span summary."""
    raw = codec.get_string_param(resp, SUMMARY_PARAM_KEY)
    if raw is None:
        return None
    return {SUMMARY_PARAM_KEY: raw}


class GRPCChannel(BaseChannel):
    def __init__(
        self,
        endpoint: str,
        max_message_bytes: int = 64 << 20,
        timeout_s: float = 30.0,
        retries: int = 3,
        backoff_s: float = 0.1,
        use_shared_memory: bool | None = None,
    ) -> None:
        """``use_shared_memory``: None or False ride the wire; True raises
        (the shared-memory transport is not ported)."""
        if use_shared_memory:
            from triton_client_tpu_torch.runtime.server import not_ported

            raise not_ported("shared memory", "use_shared_memory=True")
        import grpc

        self._grpc = grpc
        codes = grpc.StatusCode
        self._retryable = (codes.UNAVAILABLE, codes.DEADLINE_EXCEEDED, codes.RESOURCE_EXHAUSTED)
        # ModelInfer may have run on the server when a deadline fires, so
        # only the connection-level code is safe to re-issue
        self._infer_retryable = (codes.UNAVAILABLE,)
        self._deadline_error = _deadline_error_class()
        self._endpoint = endpoint
        self._max_message_bytes = max_message_bytes
        self._timeout_s = timeout_s
        self._retries = retries
        self._backoff_s = backoff_s
        self._channel = None
        self._stub: service.GRPCInferenceServiceStub | None = None
        self._retired: list = []
        # sheds the server sent back (RESOURCE_EXHAUSTED on ModelInfer,
        # never retried) and transient failures the ladder re-issued
        self._infer_rejections = 0
        self._retries_total = 0
        self.register_channel()

    @property
    def transport(self) -> str:
        """``grpc`` (TCP wire) or ``uds`` (a ``unix:`` / ``unix-abstract:``
        target, the unix-socket wire)."""
        return "uds" if self._endpoint.startswith(("unix:", "unix-abstract:")) else "grpc"

    # -- BaseChannel protocol -------------------------------------------------

    def register_channel(self) -> None:
        self._channel = self._grpc.insecure_channel(
            self._endpoint,
            options=[
                ("grpc.max_send_message_length", self._max_message_bytes),
                ("grpc.max_receive_message_length", self._max_message_bytes),
            ],
        )
        self._stub = service.GRPCInferenceServiceStub(self._channel)

    def fetch_channel(self):
        return self._channel

    def get_metadata(self, model_name: str, model_version: str = "") -> ModelSpec:
        meta = self._call(
            self._stub.ModelMetadata,
            pb.ModelMetadataRequest(name=model_name, version=model_version),
        )
        config = self._call(
            self._stub.ModelConfig, pb.ModelConfigRequest(name=model_name, version=model_version)
        ).config
        spec = ModelSpec(
            name=meta.name,
            version=model_version or (meta.versions[-1] if meta.versions else "1"),
            platform=meta.platform,
            inputs=tuple(TensorSpec(t.name, tuple(t.shape), t.datatype) for t in meta.inputs),
            outputs=tuple(TensorSpec(t.name, tuple(t.shape), t.datatype) for t in meta.outputs),
            max_batch_size=config.max_batch_size,
            extra={k: json.loads(v) for k, v in config.parameters.items()},
        )
        needed = 2 * spec.wire_bytes() + FRAMING_BYTES
        if needed > self._max_message_bytes:
            # re-dial with the larger cap; the old channel is retired, not
            # closed (other threads may have RPCs in flight on it)
            self._max_message_bytes = needed
            if self._channel is not None:
                self._retired.append(self._channel)
            self.register_channel()
        return spec

    def _expired(self, request: InferRequest) -> bool:
        return request.deadline_s is not None and request.deadline_s - time.perf_counter() <= 0

    def _wire(self, request: InferRequest):
        return codec.build_infer_request(
            model_name=request.model_name,
            inputs=request.inputs,
            model_version=request.model_version,
            request_id=request.request_id,
            parameters=_wire_params(request),
        )

    @staticmethod
    def _response(resp, t0: float | None = None) -> InferResponse:
        return InferResponse(
            model_name=resp.model_name,
            model_version=resp.model_version,
            outputs=codec.parse_infer_response(resp),
            request_id=resp.id,
            latency_s=0.0 if t0 is None else time.perf_counter() - t0,
            parameters=_response_params(resp),
        )

    def do_inference(self, request: InferRequest) -> InferResponse:
        # an already-expired deadline fails before any transport work
        if self._expired(request):
            raise self._deadline_error("deadline expired before ModelInfer was issued")
        wire = self._wire(request)
        t0 = time.perf_counter()
        try:
            resp = self._call(
                self._stub.ModelInfer, wire, retryable=self._infer_retryable,
                deadline_s=request.deadline_s,
            )
        except self._grpc.RpcError as e:
            self._record_infer_error(e)
            raise
        return self._response(resp, t0)

    def do_inference_async(self, request: InferRequest) -> InferFuture:
        """Non-blocking ModelInfer through a gRPC call future: the RPC is on
        the wire when this returns, and ``result()`` parses the response.
        An UNAVAILABLE failure re-issues on the sync retry ladder at
        resolution (within the request's deadline); other errors surface
        at ``result()``."""
        if self._expired(request):
            return InferFuture.failed(
                self._deadline_error("deadline expired before async ModelInfer was issued")
            )
        try:
            wire = self._wire(request)
            t0 = time.perf_counter()
            call = self._issue_async(wire, request.deadline_s)
        except Exception as e:  # errors surface at result()
            return InferFuture.failed(e)

        def resolve() -> InferResponse:
            try:
                resp = call.result()
            except self._grpc.RpcError as e:
                resp = self._async_retry(e, wire, request)
            return self._response(resp, t0)

        return InferFuture(resolve)

    def _issue_async(self, wire, deadline_s: float | None):
        timeout = self._timeout_s
        if deadline_s is not None:
            remaining = deadline_s - time.perf_counter()
            if remaining <= 0:
                raise self._deadline_error("deadline expired before async ModelInfer was issued")
            timeout = min(timeout, remaining)
        return self._stub.ModelInfer.future(wire, timeout=timeout)

    def _async_retry(self, e, wire, request: InferRequest):
        self._record_infer_error(e)
        code = e.code() if hasattr(e, "code") else None
        if code not in self._infer_retryable:
            raise e
        log.warning("async ModelInfer failed (%s); re-issuing on the sync retry path", code)
        return self._call(
            self._stub.ModelInfer, wire, retryable=self._infer_retryable,
            deadline_s=request.deadline_s,
        )

    # -- health and the repository --------------------------------------------

    def server_live(self, timeout_s: float | None = None) -> bool:
        try:
            return self._call(self._stub.ServerLive, pb.ServerLiveRequest(),
                              timeout_s=timeout_s).live
        except self._grpc.RpcError:
            return False

    def server_ready(self, timeout_s: float | None = None) -> bool:
        """Readiness: a draining server stays live but turns not-ready."""
        try:
            return self._call(self._stub.ServerReady, pb.ServerReadyRequest(),
                              timeout_s=timeout_s).ready
        except self._grpc.RpcError:
            return False

    def model_ready(self, model_name: str, model_version: str = "",
                    timeout_s: float | None = None) -> bool:
        try:
            return self._call(
                self._stub.ModelReady,
                pb.ModelReadyRequest(name=model_name, version=model_version),
                retryable=(), timeout_s=timeout_s,
            ).ready
        except self._grpc.RpcError:
            return False

    def repository_index(self) -> list[tuple[str, str, str]]:
        """[(name, version, state)] from the server's RepositoryIndex."""
        resp = self._call(self._stub.RepositoryIndex, pb.RepositoryIndexRequest())
        return [(m.name, m.version, m.state) for m in resp.models]

    # -- streaming ---------------------------------------------------------------

    @staticmethod
    def _stream_groups(requests, group_size: int):
        """Consecutive compatible requests in frame groups of up to
        ``group_size`` (same model, version, priority, input names, shapes
        and dtypes; no trace, no sequence; every input with a leading
        axis). Anything else streams alone. Grouping buffers, so it suits
        open-loop producers; a closed-loop caller keeps ``group_size=1``."""

        def groupable(r: InferRequest) -> bool:
            if r.trace is not None or r.sequence_id:
                return False
            return all(np.asarray(v).ndim >= 1 for v in r.inputs.values())

        def compatible(a: InferRequest, b: InferRequest) -> bool:
            if (a.model_name != b.model_name or a.model_version != b.model_version
                    or a.priority != b.priority or set(a.inputs) != set(b.inputs)):
                return False
            return all(
                np.asarray(v).shape == np.asarray(b.inputs[k]).shape
                and np.asarray(v).dtype == np.asarray(b.inputs[k]).dtype
                for k, v in a.inputs.items()
            )

        group: list[InferRequest] = []
        for r in requests:
            if group_size > 1 and groupable(r):
                if group and not compatible(group[0], r):
                    yield group
                    group = []
                group.append(r)
                if len(group) >= group_size:
                    yield group
                    group = []
            else:
                if group:
                    yield group
                    group = []
                yield [r]
        if group:
            yield group

    @staticmethod
    def _stage_stream_group(members: list[InferRequest]):
        """One wire message for G compatible requests, their inputs packed
        back to back along the leading axis."""
        first = members[0]
        g = len(members)
        req = pb.ModelInferRequest(
            model_name=first.model_name, model_version=first.model_version, id=first.request_id
        )
        params = dict(_wire_params(first) or {})
        if g > 1:
            params[codec.STREAM_GROUP_PARAM] = g
            ids = [m.request_id for m in members]
            if any(ids):
                params[codec.STREAM_GROUP_IDS_PARAM] = json.dumps(ids)
        codec.set_request_params(req, params)
        for name in sorted(first.inputs):
            arrs = [np.asarray(m.inputs[name]) for m in members]
            a0 = arrs[0]
            shape = (g * a0.shape[0],) + tuple(a0.shape[1:]) if g > 1 else a0.shape
            req.inputs.add(name=name, datatype=codec.datatype_of(a0), shape=shape)
            req.raw_input_contents.append(b"".join(codec.serialize_tensor(a) for a in arrs))
        return req

    def infer_stream(self, requests, stream_timeout_s: float | None = 3600.0,
                     group_size: int = 1):
        """Bidirectional streaming inference: ``requests`` is an iterable of
        InferRequest; yields InferResponse in request order.
        ``group_size > 1`` packs up to that many compatible requests into
        one stream message, which the server fans back out; a whole-group
        failure is prefixed ``stream group failed:``.
        ``stream_timeout_s`` bounds the whole stream (None: unbounded)."""
        # appended on gRPC's request-consumer thread, consumed in order here:
        # an entry is always enqueued before its first response arrives
        entries: collections.deque = collections.deque()

        def wire_iter():
            for members in self._stream_groups(requests, group_size):
                wire = self._stage_stream_group(members)
                entries.append({"members": members, "remaining": len(members)})
                yield wire

        call = self._stub.ModelStreamInfer(wire_iter(), timeout=stream_timeout_s)
        try:
            for resp in call:
                entry = entries[0]
                if resp.error_message:
                    msg = resp.error_message
                    if len(entry["members"]) == 1 or msg.startswith("stream group failed: "):
                        entries.popleft()
                    raise RuntimeError(msg)
                entry["remaining"] -= 1
                if entry["remaining"] <= 0:
                    entries.popleft()
                yield self._response(resp.infer_response)
        finally:
            call.cancel()

    def close(self) -> None:
        if self._channel is not None:
            self._channel.close()
        for ch in self._retired:
            ch.close()
        self._retired.clear()

    # -- internals ------------------------------------------------------------

    def _record_infer_error(self, e) -> None:
        """Count server sheds (RESOURCE_EXHAUSTED on ModelInfer)."""
        try:
            if e.code() == self._grpc.StatusCode.RESOURCE_EXHAUSTED:
                self._infer_rejections += 1
        except (AttributeError, ValueError):
            pass

    def stats(self) -> dict:
        """``infer_rejections`` (sheds, never retried), ``retries`` (what
        the backoff ladder re-issued) and the ``transport`` label."""
        return {
            "infer_rejections": self._infer_rejections,
            "retries": self._retries_total,
            "transport": self.transport,
        }

    def _call(self, method, request, retryable=None, deadline_s: float | None = None,
              timeout_s: float | None = None):
        """Retry ladder with capped exponential backoff and full jitter.
        ``retryable``: the status codes safe to re-issue for this method
        (default: UNAVAILABLE, DEADLINE_EXCEEDED, RESOURCE_EXHAUSTED, for
        the idempotent queries). ``deadline_s``: the request's absolute
        perf_counter deadline; it caps each attempt's timeout and the
        backoff sleeps, failing fast with a client-local
        DeadlineExceededRpcError once the budget is spent. ``timeout_s``
        overrides the per-attempt timeout."""
        if retryable is None:
            retryable = self._retryable
        delay = self._backoff_s
        per_attempt = self._timeout_s if timeout_s is None else timeout_s
        for attempt in range(self._retries + 1):
            timeout = per_attempt
            if deadline_s is not None:
                remaining = deadline_s - time.perf_counter()
                if remaining <= 0:
                    raise self._deadline_error(
                        f"deadline expired before attempt {attempt + 1} of rpc "
                        f"{getattr(method, '_method', method)}"
                    )
                timeout = min(per_attempt, remaining)
            try:
                return method(request, timeout=timeout)
            except self._grpc.RpcError as e:
                code = e.code() if hasattr(e, "code") else None
                if attempt >= self._retries or code not in retryable:
                    raise
                sleep_s = delay * random.uniform(0.5, 1.0)
                if deadline_s is not None and time.perf_counter() + sleep_s >= deadline_s:
                    raise self._deadline_error(
                        f"remaining deadline {deadline_s - time.perf_counter():.3f}s < backoff "
                        f"{sleep_s:.3f}s after {code} (attempt {attempt + 1}/{self._retries})"
                    ) from e
                log.warning("rpc %s failed (%s); retry %d/%d in %.2fs",
                            getattr(method, "_method", method), code, attempt + 1,
                            self._retries, sleep_s)
                self._retries_total += 1
                time.sleep(sleep_s)
                delay = min(delay * 2, _BACKOFF_CAP_S)
