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
- **Telemetry** (``metrics_port``, ``"auto"`` for an ephemeral port): the
  ``obs/http.TelemetryServer`` serves ``/metrics`` (the per-server
  Prometheus registry: ``obs/collector.RuntimeCollector`` and the stage
  histograms), ``/traces``, ``/snapshot``, ``/profile`` and ``/history``;
  the ``Tracer`` feeds the per-(model, stage) latency histograms, a
  ``DeviceTimeLedger`` is attached to the staged channel (one ``inner``
  level below a batcher), and the metric history and the continuous op
  sampler run when asked. ``slo_ms`` stamps each request's deadline at
  admission and scores it met or missed on every exit path
  (``obs/slo.SLOTracker``); the admission controller then also sheds on
  the estimated wait.
- **Streams** keep up to ``stream_pipeline_depth`` requests in flight and
  answer in request order, each response the moment it resolves.
- **Shared memory** (Triton's system-shared-memory extension, the JAX
  server's registry): same-host clients register ``/dev/shm`` regions and
  send inputs, and ask for outputs, as region coordinates. Only a
  loopback or unix-socket peer may reach the registry
  (``PERMISSION_DENIED`` otherwise). ``uds_address`` adds a unix-socket
  listener beside TCP. ``content_encoding`` inputs (``jpeg``, ``q8``,
  ``q16``) decode as the JAX server decodes them
  (``runtime/wire_encoding.py``).
- **Lifecycle and tenants** (``lifecycle``: a
  ``runtime/lifecycle.ModelLifecycleManager`` already attached to the
  staged channel; ``tenants``: a ``TenantTable``): a request for a COLD
  model waits on its RPC thread, after admission, while the model pages
  in, so a batcher's dispatcher never waits on a promotion; the reference
  it takes is dropped in ``_account``. Tenants' ``max_inflight`` caps join
  the admission controller, the device-time ledger bills each tenant, and
  the collector and ``/snapshot`` read the manager. ``server.lifecycle``
  serves the runbook's ``evict`` and ``prefetch``.
- **Streaming sessions** (``runtime/sessions.SessionManager``, attached to
  the staged channel by ``serve --max-sessions``): the servicer decodes the
  ``sequence_id`` / ``sequence_start`` / ``sequence_end`` parameters onto
  the request, the channel advances the stream's tracker on the launch's
  outputs and the track tensors ride back in the response; a full pool
  answers ``RESOURCE_EXHAUSTED`` (``SessionLimitError``), and the
  collector's sessions families read the manager.

Not ported, each raising ``NotImplementedError`` that names its ROADMAP
item (the defaults keep them off, as in the JAX server): the quality and
temporal planes.
"""

from __future__ import annotations

import concurrent.futures
import functools
import json
import logging
import os
import queue
import threading
import time

from triton_client_tpu_torch import __version__
from triton_client_tpu_torch.channel import transport as transports
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
from triton_client_tpu_torch.runtime import faults, wire_encoding
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
from triton_client_tpu_torch.runtime.shared_memory import SystemSharedMemoryRegistry

log = logging.getLogger(__name__)

# Floor for the gRPC message cap; specs with dynamic (-1) dims fall back
# to it. 64 MiB covers batch 8 of 512x512 FP32 frames with headroom.
_MIN_MSG_BYTES = 64 << 20

# the ROADMAP.md Queue 1 item each unported option waits for
ROADMAP_ITEMS = {
    "quality": "8 (eval/{shadow,quality_plane}.py)",
    "temporal": "8 (runtime/temporal.py)",
    "mesh": "8 (channel/sharded_channel.py)",
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
        shm_registry: SystemSharedMemoryRegistry | None = None,
        profiler=None,
        collector=None,
        slo=None,
        lifecycle=None,
    ) -> None:
        """``status``: status name -> code for ``context.abort`` (the grpc
        table, from ``service.grpc_status_table``); None aborts with the
        names, for an in-process context. ``shm_registry``: the regions
        the shared-memory RPCs register (a new one when None).
        ``profiler``: a ``StageProfiler`` each request's wall lands in as
        ``infer_<model>``; ``collector``: the ``RuntimeCollector`` the
        request hooks feed; ``slo``: the ``SLOTracker`` that stamps
        deadlines and scores requests; ``lifecycle``: the
        ``ModelLifecycleManager`` a request waits on for its model."""
        self._repo = repository
        self._lifecycle = lifecycle
        self._profiler = profiler
        self._collector = collector
        self._slo = slo
        self._channel = channel
        self._shm = shm_registry if shm_registry is not None else SystemSharedMemoryRegistry()
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
        extensions = ["model_repository", "binary_tensor_data", "system_shared_memory"]
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

    # -- shared memory (Triton system-shared-memory extension) ----------------

    @staticmethod
    def _is_local_peer(context) -> bool:
        # ipv6:[::ffff:127.*] is the v4-mapped loopback a dual-stack bind
        # reports for a 127.0.0.1 dial
        return context.peer().startswith(
            ("ipv4:127.", "ipv6:[::1]", "ipv6:[::ffff:127.", "unix:"))

    def _require_local(self, context) -> None:
        """Registration maps a /dev/shm file into the server and requests
        read and write it, so a remote peer must never reach it (it could
        attach any flat-named segment on this host). Loopback and unix
        sockets only."""
        if not self._is_local_peer(context):
            self._abort(context, "PERMISSION_DENIED",
                        f"shared-memory extension is restricted to same-host clients "
                        f"(peer {context.peer()})")

    def SystemSharedMemoryRegister(self, request, context):
        self._require_local(context)
        try:
            self._shm.register(request.name, request.key, request.offset, request.byte_size)
        except (ValueError, OSError) as e:
            self._abort(context, "INVALID_ARGUMENT", str(e))
        return pb.SystemSharedMemoryRegisterResponse()

    def SystemSharedMemoryUnregister(self, request, context):
        self._require_local(context)
        if request.name:
            self._shm.unregister(request.name)
        else:
            self._shm.unregister_all()
        return pb.SystemSharedMemoryUnregisterResponse()

    def SystemSharedMemoryStatus(self, request, context):
        self._require_local(context)
        resp = pb.SystemSharedMemoryStatusResponse()
        try:
            regions = self._shm.status(request.name)
        except KeyError as e:
            self._abort(context, "NOT_FOUND", str(e))
        for name, reg in regions.items():
            resp.regions[name].name = name
            resp.regions[name].key = reg.key
            resp.regions[name].offset = reg.offset
            resp.regions[name].byte_size = reg.byte_size
        return resp

    def _detach_probe(self, model_name: str) -> None:
        """Fault point ``shm_detach``: drop every attached region right
        before a parse, so the parse fails as on a freshly restarted server
        ('not registered' -> INVALID_ARGUMENT) and clients exercise their
        re-registration."""
        if faults.probe_flag("shm_detach", model_name):
            self._shm.unregister_all()

    # -- inference ------------------------------------------------------------

    def _issue(self, request, inputs_override=None, id_override=None):
        """Admit, parse and dispatch one request; returns a finisher that
        resolves it and encodes the response.

        ``inputs_override``/``id_override``: one member of a packed stream
        group (:meth:`_issue_group`), whose inputs are views into the
        group's parse; content decoding and output placement are then
        skipped (a shared output region cannot serve G members). The
        dispatch is ``do_inference_async``, so the card starts while this
        thread returns; the finisher's ``result()`` is the only wait.
        ``_account`` closes every request out, failed ones included."""
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
        deadline_s = None
        if self._slo is not None:
            deadline_s = self._slo.deadline_for(request.model_name, t0)
        sequence_id = codec.get_string_param(request, codec.SEQUENCE_ID_PARAM)
        sequence_start = sequence_end = False
        if sequence_id:
            sequence_start = codec.get_bool_param(request, codec.SEQUENCE_START_PARAM)
            sequence_end = codec.get_bool_param(request, codec.SEQUENCE_END_PARAM)
        if self._collector is not None:
            self._collector.request_started()
        with self._active_lock:
            self._active += 1
        admitted = False
        lifecycle_key = None
        try:
            # the overload checks come before the parse: a shed request
            # costs microseconds, not a deserialize
            if self._draining_now():
                raise ServerDrainingError("server is draining; retry against another replica")
            if self._replica_down_now():
                raise ReplicaDownError("replica is down (injected)")
            if self._admission is not None:
                try:
                    self._admission.admit(request.model_name, deadline_s=deadline_s,
                                          priority=priority, now=t0)
                except AdmissionRejectedError:
                    if self._collector is not None:
                        self._collector.record_shed(request.model_name, priority, "admission")
                    raise
                admitted = True
            if self._lifecycle is not None:
                # the promotion wait, on this RPC thread: a batcher's
                # dispatcher never waits on a warming model. The channel
                # takes its own reference across the device window
                try:
                    lifecycle_key = self._lifecycle.acquire(
                        request.model_name, request.model_version, deadline_s=deadline_s)
                except OverloadError:
                    if self._collector is not None:
                        self._collector.record_shed(request.model_name, priority, "lifecycle")
                    raise
            if inputs_override is not None:
                inputs = inputs_override
            else:
                self._detach_probe(request.model_name)
                if trace is not None:
                    with trace.span("parse"):
                        inputs = codec.parse_infer_request(request, shm=self._shm)
                else:
                    inputs = codec.parse_infer_request(request, shm=self._shm)
                encodings = wire_encoding.encodings_of(request)
                if encodings:
                    # in a pipelined stream this runs on the reader thread
                    # while the previous request owns the card
                    if trace is not None:
                        with trace.span("decode"):
                            inputs = wire_encoding.decode_inputs(inputs, encodings)
                    else:
                        inputs = wire_encoding.decode_inputs(inputs, encodings)
            if trace is not None:
                # closed in finish() once the future resolves
                trace.begin("channel")
            ireq = InferRequest(
                model_name=request.model_name,
                model_version=request.model_version,
                inputs=inputs,
                request_id=request_id,
                trace=trace,
                deadline_s=deadline_s,
                priority=priority,
                sequence_id=sequence_id or "",
                sequence_start=sequence_start,
                sequence_end=sequence_end,
            )
            future = self._channel.do_inference_async(ireq)
            # overlapped with the card: the placement needs only the request
            shm_outputs = {} if inputs_override is not None else {
                t.name: params for t in request.outputs
                if (params := codec.shm_params(t)) is not None
            }
        except BaseException as e:
            self._account(request.model_name, t0, trace, error=e, deadline_s=deadline_s,
                          priority=priority, admitted=admitted, lifecycle_key=lifecycle_key)
            raise

        def finish():
            error = None
            try:
                try:
                    result = future.result()
                finally:
                    if trace is not None:
                        trace.end("channel")
                # the encode copies the outputs (into the wire message or the
                # client's region) now: nothing keeps a view of a readback
                # buffer past this request
                encode = functools.partial(
                    codec.build_infer_response,
                    model_name=result.model_name,
                    model_version=result.model_version,
                    outputs=result.outputs,
                    request_id=result.request_id,
                    shm_outputs=shm_outputs,
                    shm=self._shm,
                )
                if trace is None:
                    return encode()
                t_e0 = time.perf_counter()
                resp = encode()
                trace.add("encode", t_e0, time.perf_counter())
                # the summary goes in after the encode span, so the far
                # side's grafted timeline includes it
                codec.set_request_params(resp, {SUMMARY_PARAM_KEY: encode_span_summary(trace)})
                return resp
            except BaseException as e:
                error = e
                raise
            finally:
                self._account(request.model_name, t0, trace, error=error, deadline_s=deadline_s,
                              priority=priority, admitted=admitted, lifecycle_key=lifecycle_key)

        return finish

    def _account(
        self, model_name, t0, trace, error=None, deadline_s=None, priority=0, admitted=False,
        lifecycle_key=None,
    ) -> None:
        """Per-request bookkeeping on every exit path: the log line, the
        trace's finish (which feeds the latency histograms), the SLO score,
        the stage sample, the error and in-flight counters, the admission
        slot (a success also feeds its service-time EWMA) and the lifecycle
        reference."""
        now = time.perf_counter()
        if error is not None:
            log.debug("request for model %s failed with %s: %s%s",
                      model_name, _grpc_code(error), error, log_tag(trace))
        elif log.isEnabledFor(logging.DEBUG):
            log.debug("request for model %s served in %.1f ms%s",
                      model_name, (now - t0) * 1e3, log_tag(trace))
        status = "ok" if error is None else _grpc_code(error)
        if self._tracer is not None:
            # first: the histograms it feeds are what the SLO tracker's p99
            # criterion reads below
            self._tracer.finish(trace, status=status)
        if self._slo is not None:
            self._slo.observe_request(model_name, wall_s=now - t0, deadline_s=deadline_s,
                                      priority=priority, status=status, trace=trace, now=now)
        if self._profiler is not None:
            self._profiler.record(f"infer_{model_name}", time.perf_counter() - t0)
        if self._collector is not None:
            if error is not None:
                self._collector.record_error(model_name, status)
            self._collector.request_finished()
        if self._admission is not None and admitted:
            self._admission.finished(
                model_name, service_s=(now - t0) if error is None else None)
        if self._lifecycle is not None and lifecycle_key is not None:
            self._lifecycle.release(*lifecycle_key)
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

    def _record_transport(self, request, context) -> None:
        """The transport-mix counters: which transport carried this
        request's input tensors and how many payload bytes each path
        moved."""
        if self._collector is None:
            return
        wire_bytes = sum(len(b) for b in request.raw_input_contents)
        shm_bytes = 0
        for t in request.inputs:
            p = t.parameters
            if "shared_memory_region" in p and "shared_memory_byte_size" in p:
                shm_bytes += int(p["shared_memory_byte_size"].int64_param)
        peer = getattr(context, "peer", None)
        uds = peer is not None and peer().startswith("unix:")
        if shm_bytes:
            transport = "uds+shm" if uds else "shm"
        else:
            transport = "uds" if uds else "grpc"
        self._collector.record_transport(transport, wire_bytes, shm_bytes)

    def _record_stream(self, request, context) -> None:
        """A stream message's transport and, for a packed group, its size."""
        self._record_transport(request, context)
        if self._collector is not None and (g := self._stream_group_size(request)) > 1:
            self._collector.record_stream_group(g)

    def _issue_group(self, request):
        """Fan one multi-frame stream message (G frames along the leading
        axis) into G requests; one finisher each, in member order. A member
        whose issue fails becomes a finisher that raises its error, so the
        others still serve."""
        g = self._stream_group_size(request)
        if g == 1:
            return [self._issue(request)]
        self._detach_probe(request.model_name)
        inputs = codec.parse_infer_request(request, shm=self._shm)
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
            self._require_local(context)
        self._record_transport(request, context)
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
                    self._require_local(context)
                self._record_stream(request, context)
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
                    if self._uses_shm(request) and not self._is_local_peer(context):
                        q.put(("non_local", None))  # the abort runs on the handler thread
                        return
                    self._record_stream(request, context)
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
                elif kind == "non_local":
                    self._require_local(context)
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
        profiler=None,
        metrics_port: int | str = 0,
        stream_pipeline_depth: int = 2,
        trace_capacity: int = 256,
        slo_ms: float = 0.0,
        slo_per_model: dict | None = None,
        slo_tail_capacity: int = 64,
        admission_max_queue: int = 0,
        admission_concurrency: int = 4,
        lifecycle=None,
        tenants=None,
        replica_of: str | None = None,
        op_sample_interval_s: float = 0.0,
        op_sample_window_s: float = 0.2,
        history_interval_s: float = 10.0,
        history_capacity: int = 360,
        history_path: str | None = None,
        quality=None,
        temporal=None,
    ) -> None:
        """``stream_pipeline_depth``: in-flight requests per
        ModelStreamInfer stream (1 is serial). ``trace_capacity``: the ring
        of recent request traces (0 turns request tracing off).
        ``admission_max_queue``: per-model admitted-but-unfinished cap (0:
        no admission control); beyond it, or when the estimated queue wait
        already exceeds a request's deadline budget, requests are rejected
        with RESOURCE_EXHAUSTED before parse. ``admission_concurrency``: the
        per-model service concurrency the estimated wait divides by.
        ``metrics_port``: serve the telemetry endpoint (0: off; ``"auto"``:
        an ephemeral port, read back from ``.metrics_port``). ``profiler``:
        a ``StageProfiler`` to record into (made when ``metrics_port`` is
        set). ``slo_ms``: the default per-request latency budget (0: none;
        the histograms and the tail sampler's p99 criterion still run);
        ``slo_per_model`` overrides it a model; ``slo_tail_capacity``
        bounds the ``/traces?slo_violations=1`` ring. The SLO plane lives
        on the telemetry plane: without ``metrics_port`` it is off.
        ``op_sample_interval_s`` > 0 starts the continuous op sampler (a
        ``torch.profiler`` window of ``op_sample_window_s`` every interval,
        at most a 1% duty cycle, sharing ``/profile``'s capture guard).
        ``history_interval_s`` / ``history_capacity``: the metric-history
        ring served at ``/history`` (0: off); ``history_path``: persisted
        there on ``stop()`` and restored from it at start.
        ``lifecycle``: a ``runtime/lifecycle.ModelLifecycleManager``,
        already attached to the serving channel: a request for a COLD
        model waits, deadline-aware, on its RPC thread while the model
        pages in. ``tenants``: a ``TenantTable``: its ``max_inflight`` caps
        join the admission controller, and the device-time ledger bills its
        tenants (fair-share ordering is attached on the continuous batcher
        with ``attach_tenants``).
        ``replica_of``: replica-set label (keys the ``replica_down`` fault
        point; advertised in ServerMetadata.extensions). ``uds_address``:
        also listen on a unix socket (``unix:/path``, a bare path, or
        ``"auto"`` for a path of this process and port in the temporary
        directory), so same-host clients skip the TCP stack; read the bound
        target back from ``.uds_address``. The socket file is unlinked on
        ``stop()``. The other options are not ported and raise when set
        (module docstring)."""
        for what, value in (("quality", quality), ("temporal", temporal)):
            if value:
                raise not_ported(what)
        import grpc

        self.lifecycle = lifecycle
        self.tenants = tenants
        self.replica_of = replica_of
        self.admission = (
            AdmissionController(max_queue=admission_max_queue, concurrency=admission_concurrency,
                                tenants=tenants)
            if admission_max_queue > 0 else None
        )
        self._draining = threading.Event()
        self._history_path = history_path
        self._telemetry = None
        self.metrics_enabled = False
        self.histograms = self.slo = self.device_time = None
        self.history = self.sampler = self.collector = None
        if metrics_port:
            self._start_telemetry(
                repository, channel, metrics_port, profiler, trace_capacity, slo_ms,
                slo_per_model, slo_tail_capacity, op_sample_interval_s, op_sample_window_s,
                history_interval_s, history_capacity)
        else:
            self.profiler = profiler
            self.tracer = Tracer(capacity=trace_capacity) if trace_capacity > 0 else None
        limit = max_message_bytes or message_limit(repository)
        self._executor = concurrent.futures.ThreadPoolExecutor(max_workers=max_workers)
        self._server = grpc.server(
            self._executor,
            options=[
                ("grpc.max_send_message_length", limit),
                ("grpc.max_receive_message_length", limit),
            ],
        )
        self.shm_registry = SystemSharedMemoryRegistry()
        self._servicer = _Servicer(
            repository,
            channel,
            stream_pipeline_depth=stream_pipeline_depth,
            tracer=self.tracer,
            admission=self.admission,
            draining=self._draining,
            replica_of=replica_of,
            status=service.grpc_status_table(),
            shm_registry=self.shm_registry,
            profiler=self.profiler,
            collector=self.collector,
            slo=self.slo,
            lifecycle=lifecycle,
        )
        service.add_GRPCInferenceServiceServicer_to_server(self._servicer, self._server)
        self._port = self._server.add_insecure_port(address)
        if self._port == 0:
            raise RuntimeError(f"could not bind {address}")
        self._address = address
        self.uds_address: str | None = None
        self._uds_path: str | None = None
        if uds_address:
            path = uds_address
            if path == "auto":
                import tempfile

                path = os.path.join(tempfile.gettempdir(),
                                    f"tct_serve_{os.getpid()}_{self._port}.sock")
            elif transports.is_uds(path):
                path = transports.uds_path(path)
            try:
                # a stale socket from a crashed run blocks the bind
                os.unlink(path)
            except FileNotFoundError:
                pass
            if self._server.add_insecure_port(f"unix:{path}") == 0:
                raise RuntimeError(f"could not bind unix:{path}")
            self.uds_address = f"unix:{path}"
            self._uds_path = path
        self.channel = channel

    def _start_telemetry(
        self, repository, channel, metrics_port, profiler, trace_capacity, slo_ms,
        slo_per_model, slo_tail_capacity, op_sample_interval_s, op_sample_window_s,
        history_interval_s, history_capacity,
    ) -> None:
        """The telemetry and SLO planes (``__init__``'s docstring). A missing
        ``prometheus_client`` or a taken port degrades, never fails the
        server: ``/metrics`` answers 503, or the endpoint is off."""
        from triton_client_tpu_torch.obs.collector import RuntimeCollector
        from triton_client_tpu_torch.obs.device_time import DeviceTimeLedger
        from triton_client_tpu_torch.obs.histogram import HistogramFamily
        from triton_client_tpu_torch.obs.profiling import PrometheusStageExporter, StageProfiler
        from triton_client_tpu_torch.obs.slo import SLOTracker

        self.profiler = profiler if profiler is not None else StageProfiler()
        registry = None
        try:
            import prometheus_client

            # a registry a server: several servers in one process each
            # export their whole metric set
            registry = prometheus_client.CollectorRegistry()
            PrometheusStageExporter(0, registry=registry).attach(self.profiler)
        except ImportError:
            log.warning("prometheus_client not installed; /metrics on port %s disabled "
                        "(traces still export)", metrics_port)
        self.histograms = HistogramFamily()
        self.slo = SLOTracker(slo_ms=slo_ms, per_model=slo_per_model,
                              tail_capacity=slo_tail_capacity, histograms=self.histograms)
        self.tracer = (Tracer(capacity=trace_capacity, profiler=self.profiler,
                              histograms=self.histograms) if trace_capacity > 0 else None)
        # the ledger on the staged channel, one `inner` level below a batcher
        target = channel
        if not hasattr(target, "attach_device_time"):
            target = getattr(channel, "inner", None)
        if target is not None and hasattr(target, "attach_device_time"):
            tenant_table = self.tenants
            if tenant_table is None and self.lifecycle is not None:
                tenant_table = self.lifecycle.tenants
            self.device_time = DeviceTimeLedger(tenants=tenant_table, devices=1)
            target.attach_device_time(self.device_time)
        if self.device_time is not None and history_interval_s > 0:
            from triton_client_tpu_torch.obs.history import MetricHistory

            self.history = MetricHistory(ledger=self.device_time, interval_s=history_interval_s,
                                         capacity=history_capacity)
            if self._history_path and os.path.exists(self._history_path):
                try:
                    self.history.restore(MetricHistory.load(self._history_path))
                except (OSError, ValueError):
                    log.warning("could not restore metric history from %s",
                                self._history_path, exc_info=True)
            self.history.start()
        self.collector = RuntimeCollector(
            channel=channel, tracer=self.tracer, registry=registry, repository=repository,
            histograms=self.histograms, slo=self.slo, admission=self.admission,
            lifecycle=self.lifecycle, device_time=self.device_time,
        )
        if self.history is not None:
            self.collector.attach_history(self.history)
        from triton_client_tpu_torch.obs.profiling import prime_profiler

        try:
            prime_profiler()
        except Exception:  # /profile and the sampler then report their own failures
            log.warning("could not prime the profiler", exc_info=True)
        try:
            from triton_client_tpu_torch.obs.http import TelemetryServer

            self._telemetry = TelemetryServer(
                port=0 if metrics_port == "auto" else int(metrics_port), registry=registry,
                tracer=self.tracer, collector=self.collector, slo=self.slo, history=self.history,
            )
        except OSError as e:
            log.warning("could not bind metrics port %s (%s); telemetry endpoint disabled",
                        metrics_port, e)
            return
        self.metrics_enabled = registry is not None
        if op_sample_interval_s > 0:
            from triton_client_tpu_torch.obs.sampler import ContinuousSampler

            self.sampler = ContinuousSampler(
                sink=self.collector, interval_s=op_sample_interval_s,
                window_s=op_sample_window_s, lock=self._telemetry.profile_lock,
                hlo_modules=self.collector.hlo_modules,
            )
            self.collector.attach_sampler(self.sampler)
            self.sampler.start()

    @property
    def port(self) -> int:
        return self._port

    @property
    def metrics_port(self) -> int:
        """The bound telemetry port (0 when telemetry is off)."""
        return self._telemetry.port if self._telemetry is not None else 0

    @property
    def servicer(self) -> _Servicer:
        return self._servicer

    def start(self) -> None:
        self._server.start()
        listening = self._address
        if self.uds_address:
            listening = f"{listening} + {self.uds_address}"
        log.info("KServe v2 server listening on %s", listening)

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
        if self.collector is not None:
            self.collector.set_draining(True)
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
        """Stop the transport, then the telemetry planes: the sampler, the
        history (a last tick, persisted to ``history_path``), the endpoint
        and the collector's registration; then the handler threads.
        Idempotent."""
        self._server.stop(grace).wait()
        if self.sampler is not None:
            self.sampler.close()
            self.sampler = None
        if self.history is not None:
            self.history.close()
            self.history.tick()
            if self._history_path:
                try:
                    self.history.persist(self._history_path)
                except OSError:
                    log.warning("could not persist metric history to %s",
                                self._history_path, exc_info=True)
                self._history_path = None
        if self._telemetry is not None:
            self._telemetry.close()
            self._telemetry = None
        if self.collector is not None:
            self.collector.close()
        # the RPCs have ended: the handler threads go too
        self._executor.shutdown(wait=True)
        # detach, never unlink: the segments are the clients'
        self.shm_registry.unregister_all()
        if self._uds_path is not None:
            # the socket file is the server's
            try:
                os.unlink(self._uds_path)
            except FileNotFoundError:
                pass
            self._uds_path = None
