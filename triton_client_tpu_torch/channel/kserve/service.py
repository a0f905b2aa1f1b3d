"""Hand-written gRPC stubs for ``inference.GRPCInferenceService`` (the
port's copy of ``channel/kserve/service.py``).

Built on grpc's generic API with the port's ``pb`` (de)serializers, so
the method paths and bytes are what grpcio-tools would generate. This
module imports no ``grpc``: the servicer base class aborts through the
``context`` it is handed with a status *name*, resolved by
:func:`status_code`, and :func:`add_GRPCInferenceServiceServicer_to_server`
imports ``grpc`` when it registers the handlers on a server. A servicer
can therefore be driven in-process on request bytes where grpc is not
installed: :func:`invoke` runs an RPC through the same deserializer and
serializer (``METHODS``) with an :class:`InProcessContext`.
"""

from __future__ import annotations

from triton_client_tpu_torch.channel.kserve import pb

SERVICE = "inference.GRPCInferenceService"

# method name -> (request type, response type, is_streaming)
METHODS = {
    "ServerLive": (pb.ServerLiveRequest, pb.ServerLiveResponse, False),
    "ServerReady": (pb.ServerReadyRequest, pb.ServerReadyResponse, False),
    "ModelReady": (pb.ModelReadyRequest, pb.ModelReadyResponse, False),
    "ServerMetadata": (pb.ServerMetadataRequest, pb.ServerMetadataResponse, False),
    "ModelMetadata": (pb.ModelMetadataRequest, pb.ModelMetadataResponse, False),
    "ModelInfer": (pb.ModelInferRequest, pb.ModelInferResponse, False),
    "ModelStreamInfer": (pb.ModelInferRequest, pb.ModelStreamInferResponse, True),
    "ModelConfig": (pb.ModelConfigRequest, pb.ModelConfigResponse, False),
    "RepositoryIndex": (pb.RepositoryIndexRequest, pb.RepositoryIndexResponse, False),
    "SystemSharedMemoryStatus": (
        pb.SystemSharedMemoryStatusRequest,
        pb.SystemSharedMemoryStatusResponse,
        False,
    ),
    "SystemSharedMemoryRegister": (
        pb.SystemSharedMemoryRegisterRequest,
        pb.SystemSharedMemoryRegisterResponse,
        False,
    ),
    "SystemSharedMemoryUnregister": (
        pb.SystemSharedMemoryUnregisterRequest,
        pb.SystemSharedMemoryUnregisterResponse,
        False,
    ),
}


def grpc_status_table() -> dict:
    """Status name -> ``grpc.StatusCode``. Imports ``grpc``: call it where
    a socket is opened."""
    import grpc

    return {code.name: code for code in grpc.StatusCode}


def status_code(name: str, table: dict | None = None):
    """The code a servicer aborts with: ``table[name]`` when a grpc table
    is given, else the name itself (an in-process context reads names)."""
    return name if table is None else table[name]


class RpcAborted(Exception):
    """Raised by :meth:`InProcessContext.abort`, as grpc's own ``abort``
    raises to end the RPC."""

    def __init__(self, code, details: str) -> None:
        super().__init__(f"{code}: {details}")
        self.code = code
        self.details = details


class InProcessContext:
    """A stand-in for grpc's servicer context when a servicer is driven
    in-process (:func:`invoke`): ``abort`` records the code and details and
    raises :class:`RpcAborted`."""

    def __init__(self) -> None:
        self.aborted: tuple | None = None

    def peer(self) -> str:
        """Neither loopback nor a unix socket in grpc's form, so the
        shared-memory extension refuses an in-process caller."""
        return "in-process"

    def abort(self, code, details: str):
        self.aborted = (code, details)
        raise RpcAborted(code, details)


def invoke(servicer, method: str, payload, context=None):
    """Call ``servicer``'s RPC ``method`` in-process on request bytes,
    through the deserializer and serializer a grpc server would use;
    returns the response bytes. For ``ModelStreamInfer`` ``payload`` is an
    iterable of request bytes and the result a list of response bytes."""
    req_t, resp_t, streaming = METHODS[method]
    context = context if context is not None else InProcessContext()
    handler = getattr(servicer, method)
    if streaming:
        requests = (req_t.FromString(p) for p in payload)
        return [resp_t.SerializeToString(r) for r in handler(requests, context)]
    return resp_t.SerializeToString(handler(req_t.FromString(payload), context))


class GRPCInferenceServiceStub:
    """Client stub over a ``grpc.Channel``: the same surface as a generated
    ``*_pb2_grpc`` stub (one multicallable per method)."""

    def __init__(self, channel) -> None:
        for name, (req_t, resp_t, streaming) in METHODS.items():
            path = f"/{SERVICE}/{name}"
            make = channel.stream_stream if streaming else channel.unary_unary
            setattr(
                self,
                name,
                make(path, request_serializer=req_t.SerializeToString,
                     response_deserializer=resp_t.FromString),
            )


class GRPCInferenceServiceServicer:
    """Base servicer: every method answers ``UNIMPLEMENTED``. ``status`` is
    the name -> code table its aborts use (None: the names themselves)."""

    status: dict | None = None

    def _unimplemented(self, context):
        context.abort(status_code("UNIMPLEMENTED", self.status), "method not implemented")

    def ServerLive(self, request, context):
        self._unimplemented(context)

    def ServerReady(self, request, context):
        self._unimplemented(context)

    def ModelReady(self, request, context):
        self._unimplemented(context)

    def ServerMetadata(self, request, context):
        self._unimplemented(context)

    def ModelMetadata(self, request, context):
        self._unimplemented(context)

    def ModelInfer(self, request, context):
        self._unimplemented(context)

    def ModelStreamInfer(self, request_iterator, context):
        self._unimplemented(context)

    def ModelConfig(self, request, context):
        self._unimplemented(context)

    def RepositoryIndex(self, request, context):
        self._unimplemented(context)

    def SystemSharedMemoryStatus(self, request, context):
        self._unimplemented(context)

    def SystemSharedMemoryRegister(self, request, context):
        self._unimplemented(context)

    def SystemSharedMemoryUnregister(self, request, context):
        self._unimplemented(context)


def add_GRPCInferenceServiceServicer_to_server(servicer, server) -> None:
    """Register ``servicer``'s methods on a ``grpc.Server``."""
    import grpc

    handlers = {}
    for name, (req_t, resp_t, streaming) in METHODS.items():
        make = (
            grpc.stream_stream_rpc_method_handler
            if streaming
            else grpc.unary_unary_rpc_method_handler
        )
        handlers[name] = make(
            getattr(servicer, name),
            request_deserializer=req_t.FromString,
            response_serializer=resp_t.SerializeToString,
        )
    server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(SERVICE, handlers),))
