"""KServe v2 wire protocol: the messages (``pb``, written from
``kserve_v2.proto`` without protobuf), the gRPC stubs (``service``, which
import ``grpc`` only where a socket is opened) and the tensor codec."""
