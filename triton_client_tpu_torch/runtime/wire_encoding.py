"""Compressed wire payloads for the remote serving path (the port's copy
of ``runtime/wire_encoding.py``).

Same-host clients ride shared memory (channel/transport.py); clients on
the far side of a real network cannot, so the wire may carry compressed
payloads instead of raw tensors: the client encodes (JPEG for camera
frames, linear quantization for pointclouds / feature maps), the
request's per-tensor ``content_encoding`` parameter names the scheme,
and the server decodes on a small host thread pool, overlapped with the
stream pipeline (request N+1 decodes on the reader thread while request
N owns the card).

Schemes (the ``content_encoding`` per-tensor parameter):

  * ``jpeg`` — payload is a 1-D uint8 tensor of JPEG bytes; decodes
    to the image's natural HxWxC uint8 array (PIL, import-guarded: a
    server without it rejects encoded tensors with a clear error
    instead of dying at import);
  * ``q8`` / ``q16`` — payload is the tensor linearly quantized to
    uint8/uint16 with ``q_scale`` / ``q_min`` parameters. The JAX
    server dequantizes on its device, where XLA fuses ``q * scale + lo``
    into one multiply-add; the port's channel stages host arrays, so
    :func:`dequantize` runs on the host and computes the product exactly
    in float64 before one rounding to the tensor's dtype, which gives
    the fused result's values. It works in blocks of ``_DEQUANT_BLOCK``
    elements, so the float64 temporary stays a few MB whatever the
    tensor's size, and the host holds the full-precision tensor once,
    in its own dtype (the device would hold it instead in the JAX
    server).
"""

from __future__ import annotations

import concurrent.futures
import io
import threading

import numpy as np

ENCODING_PARAM = "content_encoding"
Q_SCALE_PARAM = "q_scale"
Q_MIN_PARAM = "q_min"
Q_DTYPE_PARAM = "q_dtype"

try:  # optional: camera-frame JPEG path only
    from PIL import Image as _PILImage
except ImportError:  # pragma: no cover - depends on the host
    _PILImage = None

# float64 elements of one dequantization block (4 MiB of temporary)
_DEQUANT_BLOCK = 1 << 19

# decode pool: a few threads is enough — JPEG decode releases the GIL
# inside libjpeg, and the pool exists to OVERLAP decode with staging
_POOL_WORKERS = 4
_pool: concurrent.futures.ThreadPoolExecutor | None = None
_pool_lock = threading.Lock()


def decode_pool() -> concurrent.futures.ThreadPoolExecutor:
    global _pool
    if _pool is None:
        with _pool_lock:
            if _pool is None:
                _pool = concurrent.futures.ThreadPoolExecutor(
                    max_workers=_POOL_WORKERS, thread_name_prefix="wire-decode"
                )
    return _pool


# -- client-side encoders ------------------------------------------------------


def encode_jpeg(image: np.ndarray, quality: int = 90):
    """(payload, per-tensor params) for one HxW[xC] uint8 frame. The
    payload is a 1-D uint8 tensor of the compressed bytes; attach the
    params via ``InferRequest.input_params[name]``."""
    if _PILImage is None:
        raise RuntimeError("JPEG encoding needs PIL (not installed)")
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise ValueError(f"JPEG encodes uint8 frames, got {image.dtype}")
    buf = io.BytesIO()
    _PILImage.fromarray(image).save(buf, format="JPEG", quality=quality)
    payload = np.frombuffer(buf.getvalue(), dtype=np.uint8)
    return payload, {ENCODING_PARAM: "jpeg"}


def quantize(arr: np.ndarray, bits: int = 8):
    """(payload, per-tensor params) for one float tensor linearly
    quantized to ``bits`` (8 or 16). Shape is preserved; the server
    dequantizes from the ``q_scale``/``q_min`` params."""
    if bits not in (8, 16):
        raise ValueError(f"quantization supports 8 or 16 bits, got {bits}")
    a = np.asarray(arr)
    lo = float(a.min()) if a.size else 0.0
    hi = float(a.max()) if a.size else 0.0
    qmax = (1 << bits) - 1
    scale = (hi - lo) / qmax if hi > lo else 1.0
    q = np.round((a - lo) / scale).astype(np.uint8 if bits == 8 else np.uint16)
    return q, {
        ENCODING_PARAM: f"q{bits}",
        Q_SCALE_PARAM: repr(scale),
        Q_MIN_PARAM: repr(lo),
        Q_DTYPE_PARAM: np.dtype(a.dtype).name,
    }


# -- server-side decoders ------------------------------------------------------


def decode_jpeg(payload) -> np.ndarray:
    if _PILImage is None:
        raise ValueError(
            "request carries a JPEG-encoded tensor but this server has "
            "no PIL to decode it"
        )
    # bytes() copies the (small, compressed) payload out of its wire
    # view — PIL needs a real buffer; the decoded frame is the big one
    return np.asarray(_PILImage.open(io.BytesIO(bytes(payload))))


def dequantize(payload, scale: float, lo: float, dtype) -> np.ndarray:
    """``payload * scale + lo`` with ``scale`` and ``lo`` first rounded to
    ``dtype``, as the JAX server passes them; the product of a 16-bit
    integer and a float32 is exact in float64, so the float64 sum rounds
    to ``dtype`` as the fused multiply-add does. Block by block, into
    the output."""
    dtype = np.dtype(dtype)
    s = np.float64(np.asarray(scale, dtype))
    m = np.float64(np.asarray(lo, dtype))
    q = np.asarray(payload)
    out = np.empty(q.shape, dtype)
    flat_q, flat_out = q.reshape(-1), out.reshape(-1)
    tmp = np.empty(min(flat_q.size, _DEQUANT_BLOCK), np.float64)
    for i in range(0, flat_q.size, _DEQUANT_BLOCK):
        part = tmp[: min(_DEQUANT_BLOCK, flat_q.size - i)]
        np.multiply(flat_q[i:i + part.size], s, out=part)
        part += m
        flat_out[i:i + part.size] = part  # one rounding to ``dtype``
    return out


def encodings_of(request) -> dict[str, dict]:
    """{input name: decode directive} for one wire ModelInferRequest;
    empty on the (common) unencoded path — one parameters-map probe
    per input tensor."""
    out = {}
    for t in request.inputs:
        p = t.parameters
        if ENCODING_PARAM not in p:
            continue
        enc = p[ENCODING_PARAM].string_param
        if not enc:
            continue
        info = {"encoding": enc}
        if enc in ("q8", "q16"):
            try:
                info["scale"] = float(p[Q_SCALE_PARAM].string_param)
                info["min"] = float(p[Q_MIN_PARAM].string_param)
            except (KeyError, ValueError) as e:
                raise ValueError(
                    f"input {t.name!r} is {enc}-encoded but its "
                    f"q_scale/q_min parameters are missing or malformed"
                ) from e
            info["dtype"] = (
                p[Q_DTYPE_PARAM].string_param if Q_DTYPE_PARAM in p else "float32"
            ) or "float32"
        out[t.name] = info
    return out


def decode_one(payload: np.ndarray, info: dict) -> np.ndarray:
    enc = info["encoding"]
    if enc == "jpeg":
        return decode_jpeg(payload)
    if enc in ("q8", "q16"):
        return dequantize(payload, info["scale"], info["min"], np.dtype(info["dtype"]))
    raise ValueError(f"unknown content_encoding {enc!r}")


def decode_inputs(
    inputs: dict[str, np.ndarray], encodings: dict[str, dict]
) -> dict[str, np.ndarray]:
    """Replace encoded inputs with their decoded arrays. Several encoded
    tensors decode concurrently on the module pool (libjpeg releases the
    GIL); a single one decodes inline."""
    todo = {k: v for k, v in encodings.items() if k in inputs}
    if not todo:
        return inputs
    out = dict(inputs)
    if len(todo) == 1:
        name, info = next(iter(todo.items()))
        out[name] = decode_one(inputs[name], info)
        return out
    futures = {
        name: decode_pool().submit(decode_one, inputs[name], info)
        for name, info in todo.items()
    }
    for name, fut in futures.items():
        out[name] = fut.result()
    return out
