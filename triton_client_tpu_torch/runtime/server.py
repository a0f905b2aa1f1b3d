"""KServe v2 gRPC serving façade over the model repository (the port's
copy of ``runtime/server.py``).

A gRPC server speaking the KServe v2 protocol, so the reference's ROS
tooling, a ``tritonclient`` caller and both packages' ``GRPCChannel``
reach the models the port serves, dispatching through a ``BaseChannel``
(normally ``CUDAChannel``, optionally behind a batcher).

- **No grpc at import.** :class:`_Servicer` runs on the port's own
  ``channel/kserve/pb`` messages and aborts through the ``context`` it is
  handed with status names (``status`` maps them to ``grpc.StatusCode``
  once a server opens its socket), so the RPC handlers can be driven
  in-process on request bytes where ``grpc`` is not installed.
  :class:`InferenceServer` imports ``grpc`` when it is constructed.
- **Message caps** come from the registered specs (:func:`message_limit`).
- **Errors** map to the JAX server's status codes (:func:`_grpc_code`): an
  unknown model is ``NOT_FOUND``, a bad shape or dtype
  ``INVALID_ARGUMENT``, a shed ``RESOURCE_EXHAUSTED``, an expired
  deadline ``DEADLINE_EXCEEDED``, draining, a downed replica and an open
  breaker ``UNAVAILABLE``, anything else (a ``KernelError`` among them)
  ``INTERNAL``. An option that is not ported answers ``UNIMPLEMENTED``.
- **Tracing** is on by default (``trace_capacity=256``): every request
  gets a trace from the server's ``Tracer``, and every response carries
  its span summary in the ``trace_summary`` parameter.
- **Streams** keep up to ``stream_pipeline_depth`` requests in flight and
  answer in request order, each response the moment it resolves.

Not ported, each raising ``NotImplementedError`` that names its ROADMAP
item (the defaults keep them off, as in the JAX server): the telemetry
endpoint (``metrics_port``), the unix socket (``uds_address``), the op
sampler and metric history, the SLO plane (``slo_ms > 0``), lifecycle,
tenants, the quality and temporal planes, and ``content_encoding`` input
parameters. The shared-memory RPCs answer ``UNIMPLEMENTED``, and
``ServerMetadata`` does not list ``system_shared_memory``.
"""

from __future__ import annotations

import concurrent.futures
import json
import logging
import queue
import threading
import time

from triton_client_tpu_torch import __version__
from triton_client_tpu_torch.channel.base import BaseChannel, InferRequest
from triton_client_tpu_torch.channel.kserve import codec, pb, service
from triton_client_tpu_torch.config import FRAMING_BYTES
from triton_client_tpu_torch.obs.logs import log_tag
from triton_client_tpu_torch.obs.trace import (
    SUMMARY_PARAM_KEY,
    TraceContext,
    Tracer,
    encode_span_summary,
)
from triton_client_tpu_torch.runtime import faults
from triton_client_tpu_torch.runtime.admission import (
    AdmissionController,
    AdmissionRejectedError,
    CircuitOpenError,
    DeadlineExpiredError,
    OverloadError,
    ReplicaDownError,
    ServerDrainingError,
)
from triton_client_tpu_torch.runtime.repository import ModelRepository

log = logging.getLogger(__name__)

# Floor for the gRPC message cap; specs with dynamic (-1) dims fall back
# to it. 64 MiB covers batch 8 of 512x512 FP32 frames with headroom.
_MIN_MSG_BYTES = 64 << 20

# the ROADMAP.md Queue 1 item each unported option waits for
ROADMAP_ITEMS = {
    "shared memory": "8 (runtime/shared_memory.py, channel/transport.py)",
    "unix socket": "8 (channel/transport.py)",
    "content_encoding": "8 (runtime/wire_encoding.py)",
    "telemetry": "8 (obs/{collector,histogram,slo,history,sampler}.py)",
    "slo": "8 (obs/slo.py)",
    "lifecycle": "8 (runtime/lifecycle.py)",
    "tenants": "8 (runtime/lifecycle.py TenantTable)",
    "quality": "8 (eval/{shadow,quality_plane}.py)",
    "temporal": "8 (runtime/temporal.py)",
    "sessions": "8 (runtime/sessions.py)",
    "router": "8 (runtime/router.py)",
    "mesh": "8 (channel/sharded_channel.py)",
    "precision": "3 (runtime/precision.py)",
}


def not_ported(what: str, option: str | None = None) -> NotImplementedError:
    """The error of an option the port does not serve yet, naming its item."""
    return NotImplementedError(
        f"{option or what} is not ported yet (ROADMAP.md Queue 1 item {ROADMAP_ITEMS[what]})"
    )


def message_limit(repository: ModelRepository) -> int:
    """Per-repository message cap from the specs registered now (read once
    by InferenceServer: gRPC options are fixed at bind time)."""
    best = _MIN_MSG_BYTES
    for name in repository.names():
        for version in repository.versions(name):
            spec = repository.metadata(name, version)
            best = max(best, 2 * spec.wire_bytes() + FRAMING_BYTES)
    return best


def _grpc_code(exc: BaseException) -> str:
    """The gRPC status name a request error is answered with, as the JAX
    server maps it (RESOURCE_EXHAUSTED is non-retryable for ModelInfer
    clients; UNAVAILABLE is the code retry ladders go elsewhere on). The
    port adds UNIMPLEMENTED for an option it does not serve yet."""
    if isinstance(exc, AdmissionRejectedError):  # incl. QueueFullError
        return "RESOURCE_EXHAUSTED"
    if isinstance(exc, DeadlineExpiredError):
        return "DEADLINE_EXCEEDED"
    if isinstance(exc, (CircuitOpenError, ServerDrainingError, ReplicaDownError)):
        return "UNAVAILABLE"
    if isinstance(exc, KeyError):
        return "NOT_FOUND"
    if isinstance(exc, ValueError):
        return "INVALID_ARGUMENT"
    if isinstance(exc, NotImplementedError):
        return "UNIMPLEMENTED"
    return "INTERNAL"


class _Servicer(service.GRPCInferenceServiceServicer):
    def __init__(
        self,
        repository: ModelRepository,
        channel: BaseChannel,
        stream_pipeline_depth: int = 2,
        tracer: Tracer | None = None,
        admission: AdmissionController | None = None,
        draining: threading.Event | None = None,
        replica_of: str | None = None,
        status: dict | None = None,
    ) -> None:
        """``status``: status name -> code for ``context.abort`` (the grpc
        table, from ``service.grpc_status_table``); None aborts with the
        names, for an in-process context."""
        self._repo = repository
        self._channel = channel
        self._stream_depth = max(1, int(stream_pipeline_depth))
        self._tracer = tracer
        self._admission = admission
        self._draining = draining
        # replica-set label: keys the replica_down fault point and rides
        # ServerMetadata.extensions
        self._replica_of = replica_of
        self.status = status
        # in-flight requests; drain() polls it
        self._active = 0
        self._active_lock = threading.Lock()

    def _abort(self, context, name: str, message: str):
        context.abort(service.status_code(name, self.status), message)

    def active_requests(self) -> int:
        with self._active_lock:
            return self._active

    def _draining_now(self) -> bool:
        return self._draining is not None and self._draining.is_set()

    # -- health ---------------------------------------------------------------

    def ServerLive(self, request, context):
        return pb.ServerLiveResponse(live=True)

    def _replica_down_now(self) -> bool:
        return faults.probe_flag("replica_down", self._replica_of)

    def ServerReady(self, request, context):
        # a draining server turns not-ready first, so orchestrators pull it
        # from rotation before its in-flight work finishes
        return pb.ServerReadyResponse(
            ready=not self._draining_now() and not self._replica_down_now()
        )

    def ModelReady(self, request, context):
        if self._draining_now() or self._replica_down_now():
            return pb.ModelReadyResponse(ready=False)
        try:
            self._repo.get(request.name, request.version)
            ready = True
        except KeyError:
            ready = False
        return pb.ModelReadyResponse(ready=ready)

    # -- metadata -------------------------------------------------------------

    def ServerMetadata(self, request, context):
        extensions = ["model_repository", "binary_tensor_data"]
        if self._replica_of:
            extensions.append(f"replica_of:{self._replica_of}")
        return pb.ServerMetadataResponse(
            name="triton_client_tpu_torch", version=__version__, extensions=extensions
        )

    def _spec_or_abort(self, name, version, context):
        try:
            return self._repo.metadata(name, version)
        except KeyError as e:
            self._abort(context, "NOT_FOUND", str(e))

    def ModelMetadata(self, request, context):
        spec = self._spec_or_abort(request.name, request.version, context)
        resp = pb.ModelMetadataResponse(
            name=spec.name, versions=list(self._repo.versions(spec.name)), platform=spec.platform
        )
        for t in spec.inputs:
            resp.inputs.add(name=t.name, datatype=t.dtype, shape=t.shape)
        for t in spec.outputs:
            resp.outputs.add(name=t.name, datatype=t.dtype, shape=t.shape)
        return resp

    def ModelConfig(self, request, context):
        spec = self._spec_or_abort(request.name, request.version, context)
        config = pb.ModelConfig(
            name=spec.name, platform=spec.platform, max_batch_size=spec.max_batch_size
        )
        for t in spec.inputs:
            config.input.add(name=t.name, data_type=codec.config_datatype(t.dtype), dims=t.shape)
        for t in spec.outputs:
            config.output.add(name=t.name, data_type=codec.config_datatype(t.dtype), dims=t.shape)
        # ModelSpec.extra rides the config parameters map as JSON values, so
        # remote clients configure their host prep from served metadata
        for key, value in spec.extra.items():
            config.parameters[key] = json.dumps(value)
        return pb.ModelConfigResponse(config=config)

    def RepositoryIndex(self, request, context):
        resp = pb.RepositoryIndexResponse()
        for name in self._repo.names():
            for version in self._repo.versions(name):
                resp.models.add(name=name, version=version, state="READY")
        return resp

    # -- shared memory: not ported ----------------------------------------------

    def _no_shm(self, context):
        self._abort(context, "UNIMPLEMENTED", str(not_ported("shared memory", "the "
                                                             "system-shared-memory extension")))

    def SystemSharedMemoryStatus(self, request, context):
        self._no_shm(context)

    def SystemSharedMemoryRegister(self, request, context):
        self._no_shm(context)

    def SystemSharedMemoryUnregister(self, request, context):
        self._no_shm(context)

    # -- inference ------------------------------------------------------------

    def _issue(self, request, inputs_override=None, id_override=None):
        """Admit, parse and dispatch one request; returns a finisher that
        resolves it and encodes the response.

        ``inputs_override``/``id_override``: one member of a packed stream
        group (:meth:`_issue_group`), whose inputs are views into the
        group's parse. The dispatch is ``do_inference_async``, so the card
        starts while this thread returns; the finisher's ``result()`` is
        the only wait. ``_account`` closes every request out, failed ones
        included."""
        t0 = time.perf_counter()
        request_id = id_override if id_override is not None else request.id
        trace = None
        if self._tracer is not None:
            # adopt the caller's distributed context (malformed: local trace)
            context = TraceContext.decode(
                codec.get_string_param(request, TraceContext.PARAM_KEY) or ""
            )
            trace = self._tracer.start(
                model=request.model_name, request_id=request_id, context=context
            )
        priority = 0
        params = request.parameters
        if params and "priority" in params:
            priority = int(params["priority"].int64_param)
        sequence_id = codec.get_string_param(request, codec.SEQUENCE_ID_PARAM)
        sequence_start = sequence_end = False
        if sequence_id:
            sequence_start = codec.get_bool_param(request, codec.SEQUENCE_START_PARAM)
            sequence_end = codec.get_bool_param(request, codec.SEQUENCE_END_PARAM)
        with self._active_lock:
            self._active += 1
        admitted = False
        try:
            # the overload checks come before the parse: a shed request
            # costs microseconds, not a deserialize
            if self._draining_now():
                raise ServerDrainingError("server is draining; retry against another replica")
            if self._replica_down_now():
                raise ReplicaDownError("replica is down (injected)")
            if self._admission is not None:
                self._admission.admit(request.model_name, priority=priority)
                admitted = True
            if inputs_override is not None:
                inputs = inputs_override
            else:
                # the port's server has no shared-memory registry to drop;
                # the probe keeps the fault timeline's counts equal to JAX's
                faults.probe_flag("shm_detach", request.model_name)
                if trace is not None:
                    with trace.span("parse"):
                        inputs = codec.parse_infer_request(request)
                else:
                    inputs = codec.parse_infer_request(request)
                for t in request.inputs:
                    if "content_encoding" in t.parameters:
                        raise not_ported("content_encoding",
                                         f"input {t.name!r}: a content_encoding parameter")
            if trace is not None:
                # closed in finish() once the future resolves
                trace.begin("channel")
            ireq = InferRequest(
                model_name=request.model_name,
                model_version=request.model_version,
                inputs=inputs,
                request_id=request_id,
                trace=trace,
                priority=priority,
                sequence_id=sequence_id or "",
                sequence_start=sequence_start,
                sequence_end=sequence_end,
            )
            future = self._channel.do_inference_async(ireq)
        except BaseException as e:
            self._account(request.model_name, t0, trace, error=e, admitted=admitted)
            raise

        def finish():
            error = None
            try:
                try:
                    result = future.result()
                finally:
                    if trace is not None:
                        trace.end("channel")
                if trace is None:
                    return codec.build_infer_response(
                        model_name=result.model_name,
                        model_version=result.model_version,
                        outputs=result.outputs,
                        request_id=result.request_id,
                    )
                t_e0 = time.perf_counter()
                resp = codec.build_infer_response(
                    model_name=result.model_name,
                    model_version=result.model_version,
                    outputs=result.outputs,
                    request_id=result.request_id,
                )
                trace.add("encode", t_e0, time.perf_counter())
                # the summary goes in after the encode span, so the far
                # side's grafted timeline includes it
                codec.set_request_params(resp, {SUMMARY_PARAM_KEY: encode_span_summary(trace)})
                return resp
            except BaseException as e:
                error = e
                raise
            finally:
                self._account(request.model_name, t0, trace, error=error, admitted=admitted)

        return finish

    def _account(self, model_name, t0, trace, error=None, admitted=False) -> None:
        """Per-request bookkeeping on every exit path: the log line, the
        trace's finish, the admission slot and the in-flight count."""
        now = time.perf_counter()
        if error is not None:
            log.debug("request for model %s failed with %s: %s%s",
                      model_name, _grpc_code(error), error, log_tag(trace))
        elif log.isEnabledFor(logging.DEBUG):
            log.debug("request for model %s served in %.1f ms%s",
                      model_name, (now - t0) * 1e3, log_tag(trace))
        if self._tracer is not None:
            self._tracer.finish(trace, status="ok" if error is None else _grpc_code(error))
        if self._admission is not None and admitted:
            self._admission.finished(model_name)
        with self._active_lock:
            self._active -= 1

    @staticmethod
    def _uses_shm(request) -> bool:
        return any(
            "shared_memory_region" in t.parameters
            for t in list(request.inputs) + list(request.outputs)
        )

    @staticmethod
    def _stream_group_size(request) -> int:
        return max(1, codec.get_int_param(request, codec.STREAM_GROUP_PARAM, 1))

    def _issue_group(self, request):
        """Fan one multi-frame stream message (G frames along the leading
        axis) into G requests; one finisher each, in member order. A member
        whose issue fails becomes a finisher that raises its error, so the
        others still serve."""
        g = self._stream_group_size(request)
        if g == 1:
            return [self._issue(request)]
        faults.probe_flag("shm_detach", request.model_name)
        inputs = codec.parse_infer_request(request)
        members: list[dict] = [{} for _ in range(g)]
        for name, arr in inputs.items():
            if arr.ndim < 1 or arr.shape[0] % g:
                raise ValueError(
                    f"stream group of {g} needs every input's leading axis divisible by {g}; "
                    f"input {name!r} has shape {tuple(arr.shape)}"
                )
            b = arr.shape[0] // g
            for i in range(g):
                members[i][name] = arr[i * b:(i + 1) * b]
        raw_ids = codec.get_string_param(request, codec.STREAM_GROUP_IDS_PARAM)
        try:
            ids = json.loads(raw_ids) if raw_ids else []
        except ValueError:
            ids = []
        if len(ids) != g:
            ids = [f"{request.id}#{i}" if request.id else "" for i in range(g)]

        def deferred_error(err):
            def fin():
                raise err
            return fin

        finishers = []
        for i in range(g):
            try:
                fin = self._issue(request, inputs_override=members[i], id_override=ids[i])
            except Exception as e:  # already accounted by _issue
                fin = deferred_error(e)
            finishers.append(fin)
        return finishers

    @staticmethod
    def _group_error(request, e: BaseException) -> str:
        """error_message for a failure that consumed a whole stream entry:
        the prefix tells the client to retire all G member slots."""
        if _Servicer._stream_group_size(request) > 1:
            return f"stream group failed: {e}"
        return str(e)

    def ModelInfer(self, request, context):
        if self._uses_shm(request):
            self._no_shm(context)
        try:
            return self._issue(request)()
        except OverloadError as e:
            self._abort(context, _grpc_code(e), str(e))
        except KeyError as e:
            self._abort(context, "NOT_FOUND", str(e))
        except ValueError as e:
            self._abort(context, "INVALID_ARGUMENT", str(e))
        except NotImplementedError as e:
            self._abort(context, "UNIMPLEMENTED", str(e))
        except Exception as e:
            # launch and readback faults (a KernelError among them) are
            # INTERNAL, a stable code clients key retry-elsewhere on
            self._abort(context, "INTERNAL", str(e))

    _STREAM_ERRORS = (KeyError, ValueError, OverloadError, NotImplementedError)

    def ModelStreamInfer(self, request_iterator, context):
        """Up to ``stream_pipeline_depth`` requests of a stream in flight:
        request N+1 parses and launches on a reader thread while N runs.
        Responses come back in request order, each the moment it
        resolves, never withheld for a later request (a lock-step client
        sees serial semantics). Depth 1 runs without the reader thread."""
        if self._stream_depth <= 1:
            for request in request_iterator:
                if self._uses_shm(request):
                    self._no_shm(context)
                try:
                    finishers = self._issue_group(request)
                except self._STREAM_ERRORS as e:
                    yield pb.ModelStreamInferResponse(error_message=self._group_error(request, e))
                    continue
                for fin in finishers:
                    try:
                        yield pb.ModelStreamInferResponse(infer_response=fin())
                    except self._STREAM_ERRORS as e:
                        yield pb.ModelStreamInferResponse(error_message=str(e))
            return

        # bounded hand-off: the reader blocks once `depth` issued requests
        # await resolution (backpressure on a client that floods)
        q: queue.Queue = queue.Queue(maxsize=self._stream_depth)

        def issue_loop() -> None:
            try:
                for request in request_iterator:
                    if self._uses_shm(request):
                        q.put(("shm", None))  # the abort runs on the handler thread
                        return
                    try:
                        finishers = self._issue_group(request)
                    except self._STREAM_ERRORS as e:
                        q.put(("error", self._group_error(request, e)))
                        continue
                    for finish in finishers:
                        q.put(("finish", finish))
            except Exception as e:  # a reader crash surfaces on the RPC
                q.put(("crash", e))
            finally:
                q.put(("done", None))

        reader = threading.Thread(target=issue_loop, name="stream-issue", daemon=True)
        reader.start()
        try:
            while True:
                kind, payload = q.get()
                if kind == "done":
                    return
                if kind == "finish":
                    try:
                        yield pb.ModelStreamInferResponse(infer_response=payload())
                    except self._STREAM_ERRORS as e:
                        yield pb.ModelStreamInferResponse(error_message=str(e))
                elif kind == "error":
                    yield pb.ModelStreamInferResponse(error_message=payload)
                elif kind == "shm":
                    self._no_shm(context)
                else:  # crash
                    raise payload
        finally:
            reader.join(timeout=5.0)


class InferenceServer:
    """Owns the ``grpc.Server``: ``start()``, then ``wait()``, ``drain()`` or
    ``stop()``. Constructing it imports ``grpc``."""

    def __init__(
        self,
        repository: ModelRepository,
        channel: BaseChannel,
        address: str = "0.0.0.0:8001",
        uds_address: str | None = None,
        max_workers: int = 8,
        max_message_bytes: int | None = None,
        metrics_port: int | str = 0,
        stream_pipeline_depth: int = 2,
        trace_capacity: int = 256,
        slo_ms: float = 0.0,
        admission_max_queue: int = 0,
        lifecycle=None,
        tenants=None,
        replica_of: str | None = None,
        op_sample_interval_s: float = 0.0,
        history_interval_s: float = 0.0,
        history_path: str | None = None,
        quality=None,
        temporal=None,
    ) -> None:
        """``stream_pipeline_depth``: in-flight requests per
        ModelStreamInfer stream (1 is serial). ``trace_capacity``: the ring
        of recent request traces (0 turns request tracing off).
        ``admission_max_queue``: per-model admitted-but-unfinished cap (0:
        no admission control); beyond it requests are rejected with
        RESOURCE_EXHAUSTED before parse.
        ``replica_of``: replica-set label (keys the ``replica_down`` fault
        point; advertised in ServerMetadata.extensions). The other options
        are not ported and raise when set (module docstring)."""
        for what, value, option in (
            ("unix socket", uds_address, "uds_address"),
            ("telemetry", metrics_port, "metrics_port"),
            ("telemetry", op_sample_interval_s, "op_sample_interval_s"),
            ("telemetry", history_interval_s, "history_interval_s"),
            ("telemetry", history_path, "history_path"),
            ("slo", slo_ms, "slo_ms"),
            ("lifecycle", lifecycle, "lifecycle"),
            ("tenants", tenants, "tenants"),
            ("quality", quality, "quality"),
            ("temporal", temporal, "temporal"),
        ):
            if value:
                raise not_ported(what, option)
        import grpc

        self.replica_of = replica_of
        self.admission = (
            AdmissionController(max_queue=admission_max_queue) if admission_max_queue > 0 else None
        )
        self._draining = threading.Event()
        self.tracer = Tracer(capacity=trace_capacity) if trace_capacity > 0 else None
        limit = max_message_bytes or message_limit(repository)
        self._server = grpc.server(
            concurrent.futures.ThreadPoolExecutor(max_workers=max_workers),
            options=[
                ("grpc.max_send_message_length", limit),
                ("grpc.max_receive_message_length", limit),
            ],
        )
        self._servicer = _Servicer(
            repository,
            channel,
            stream_pipeline_depth=stream_pipeline_depth,
            tracer=self.tracer,
            admission=self.admission,
            draining=self._draining,
            replica_of=replica_of,
            status=service.grpc_status_table(),
        )
        service.add_GRPCInferenceServiceServicer_to_server(self._servicer, self._server)
        self._port = self._server.add_insecure_port(address)
        if self._port == 0:
            raise RuntimeError(f"could not bind {address}")
        self._address = address
        self.channel = channel

    @property
    def port(self) -> int:
        return self._port

    @property
    def servicer(self) -> _Servicer:
        return self._servicer

    def start(self) -> None:
        self._server.start()
        log.info("KServe v2 server listening on %s", self._address)

    def wait(self) -> None:
        self._server.wait_for_termination()

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    def drain(self, timeout_s: float = 10.0, poll_s: float = 0.02) -> bool:
        """Graceful shutdown (the SIGTERM path): turn not-ready and refuse
        new requests with UNAVAILABLE, let in-flight work finish up to
        ``timeout_s``, then stop the transport and close the channel stack.
        True when the server emptied in time."""
        self._draining.set()
        deadline = time.monotonic() + max(0.0, float(timeout_s))
        drained = False
        while time.monotonic() < deadline:
            if self._servicer.active_requests() <= 0:
                drained = True
                break
            time.sleep(poll_s)
        self.stop(grace=max(0.0, deadline - time.monotonic()) + 0.1)
        close = getattr(self.channel, "close", None)
        if close is not None:
            close()
        return drained

    def stop(self, grace: float = 1.0) -> None:
        self._server.stop(grace).wait()
