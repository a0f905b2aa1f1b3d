"""Channel protocol: register / metadata / infer (port of
``channel/base.py``, holding only the fields the in-process path reads).

Requests and responses are dicts of numpy arrays; ``do_inference``
takes the request explicitly, so channels are thread-safe and a driver
can prepare frame N+1 while frame N runs.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Mapping

import numpy as np


@dataclasses.dataclass
class InferRequest:
    model_name: str
    inputs: Mapping[str, np.ndarray]
    model_version: str = ""
    request_id: str = ""
    # request-scoped spans (obs.trace.RequestTrace / MultiTrace); None on
    # the untraced path, where call sites pay one attribute read
    trace: object | None = dataclasses.field(default=None, repr=False, compare=False)
    # absolute time.perf_counter() deadline; a merged group takes the
    # earliest of its members'. None = no deadline
    deadline_s: float | None = dataclasses.field(default=None, repr=False, compare=False)
    # scheduling class: the continuous batcher breaks deadline ties on
    # it. Higher = more important
    priority: int = dataclasses.field(default=0, repr=False, compare=False)
    # packed-ragged marker (parallel.ragged_kernels.RaggedLayout): set by
    # the continuous batcher when the inputs are several members' rows
    # packed together. None on every dense request
    ragged: object | None = dataclasses.field(default=None, repr=False, compare=False)
    # streaming-session identity: frames of one stream share a
    # sequence_id, start/end bracket the stream. Empty = stateless; the
    # batchers never merge a session frame
    sequence_id: str = dataclasses.field(default="", repr=False, compare=False)
    sequence_start: bool = dataclasses.field(default=False, repr=False, compare=False)
    sequence_end: bool = dataclasses.field(default=False, repr=False, compare=False)


@dataclasses.dataclass
class InferResponse:
    model_name: str
    outputs: dict[str, np.ndarray]
    model_version: str = ""
    request_id: str = ""
    # seconds from launch to the outputs on the host
    latency_s: float = 0.0


class InferFuture:
    """Handle for an in-flight inference. ``result()`` blocks until the
    response is ready and returns it, or raises the deferred error.
    Single-consumer: each future is retired once."""

    __slots__ = ("_resolve", "_done", "_value", "_error")

    def __init__(self, resolve) -> None:
        self._resolve = resolve
        self._done = False
        self._value = None
        self._error: BaseException | None = None

    @classmethod
    def completed(cls, value) -> "InferFuture":
        fut = cls(None)
        fut._done, fut._value = True, value
        return fut

    @classmethod
    def failed(cls, error: BaseException) -> "InferFuture":
        fut = cls(None)
        fut._done, fut._error = True, error
        return fut

    def result(self):
        if not self._done:
            try:
                self._value = self._resolve()
            except BaseException as e:
                self._error = e
            finally:
                self._done = True
                self._resolve = None  # free the closure (it pins device buffers)
        if self._error is not None:
            raise self._error
        return self._value


class BaseChannel(abc.ABC):
    """Transport abstraction between drivers and models."""

    @abc.abstractmethod
    def register_channel(self) -> None:
        """Establish the transport (claim the device / dial the endpoint)."""

    @abc.abstractmethod
    def fetch_channel(self):
        """Return the underlying transport handle."""

    @abc.abstractmethod
    def get_metadata(self, model_name: str, model_version: str = ""):
        """Return the ModelSpec for a served model."""

    @abc.abstractmethod
    def do_inference(self, request: InferRequest) -> InferResponse:
        """Run one inference round trip."""

    def do_inference_async(self, request: InferRequest) -> InferFuture:
        """Issue an inference without blocking for the response; the base
        version runs the blocking call and wraps the outcome."""
        try:
            return InferFuture.completed(self.do_inference(request))
        except Exception as e:  # KeyboardInterrupt/SystemExit stay immediate
            return InferFuture.failed(e)
