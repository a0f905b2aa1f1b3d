"""Endpoint transport negotiation for the host serving path (the port's
copy of ``channel/transport.py``).

Same-host endpoints ride POSIX shared memory, with the gRPC message
carrying only region coordinates; the rest ride the wire.

This module is the one place that decides *which* transport an
endpoint gets, so ``GRPCChannel``, the server's ``--uds`` listener and the detect
CLIs' ``-u grpc:`` channels agree:

  endpoint                         class      shm eligible
  -------------------------------  ---------  ------------
  ``unix:/path`` / ``unix://...``  uds        yes
  ``localhost:8001``               local      yes
  ``127.0.0.1:8001`` (any 127.*)   local      yes
  ``[::1]:8001``                   local      yes
  anything else                    remote     no

Eligibility additionally requires a usable ``/dev/shm`` (absent in
some minimal containers); callers can always force the decision with
an explicit ``use_shared_memory=True/False``.
"""

from __future__ import annotations

import os

_SHM_DIR = "/dev/shm"

#: endpoint classes returned by :func:`classify`
UDS = "uds"
LOCAL = "local"
REMOTE = "remote"


def is_uds(endpoint: str) -> bool:
    """True for gRPC unix-socket targets (``unix:/path``,
    ``unix:///abs/path``, and the ``unix-abstract:`` namespace)."""
    return endpoint.startswith(("unix:", "unix-abstract:"))


def uds_path(endpoint: str) -> str:
    """Filesystem path of a ``unix:`` target (``unix:///a/b`` and
    ``unix:/a/b`` both mean ``/a/b``)."""
    if not is_uds(endpoint):
        raise ValueError(f"not a unix-socket endpoint: {endpoint!r}")
    rest = endpoint.split(":", 1)[1]
    if rest.startswith("//"):
        rest = rest[2:]
        # unix://authority/path — gRPC reserves the authority slot;
        # the common ``unix:///abs`` form has an empty authority
        if not rest.startswith("/"):
            rest = "/" + rest.split("/", 1)[1] if "/" in rest else rest
    return rest


def classify(endpoint: str) -> str:
    """``uds`` / ``local`` / ``remote`` for one gRPC target string."""
    if is_uds(endpoint):
        return UDS
    host = endpoint
    # dns:// and ipv4:/ipv6: scheme prefixes resolve to their target
    for scheme in ("dns:///", "ipv4:", "ipv6:"):
        if host.startswith(scheme):
            host = host[len(scheme):]
            break
    if host.startswith("["):  # [::1]:8001
        host = host[1:].split("]", 1)[0]
    else:
        host = host.rsplit(":", 1)[0]
    if host in ("localhost", "::1") or host.startswith("127."):
        return LOCAL
    return REMOTE


def shm_supported() -> bool:
    """Whether this host can back shm regions at all."""
    return os.path.isdir(_SHM_DIR) and os.access(_SHM_DIR, os.W_OK)


def shm_eligible(endpoint: str) -> bool:
    """Default-on decision for the shared-memory transport: both ends
    on this host (loopback TCP or a unix socket) and /dev/shm usable.
    This is the *auto* answer — an explicit ``use_shared_memory=``
    always wins."""
    return classify(endpoint) != REMOTE and shm_supported()


def negotiated(endpoint: str, use_shm: bool) -> str:
    """Human-readable transport label for one dialed endpoint, as the
    ``route`` CLI and bench rows print it: ``grpc`` (TCP wire),
    ``uds`` (unix socket wire), ``shm`` (loopback TCP + shm tensors),
    ``uds+shm`` (unix socket + shm tensors)."""
    kind = classify(endpoint)
    if kind == UDS:
        return "uds+shm" if use_shm else "uds"
    return "shm" if use_shm else "grpc"
