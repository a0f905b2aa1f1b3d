"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file compiles with ``nvcc`` into a shared library of
its own with a plain C interface, loaded through ``ctypes``. Builds
happen at first use, into ``_build/<hash>/`` beside the sources (listed
in ``.gitignore``), keyed by a hash of every source and the flags, so a
changed source never loads a stale library. ``build_all`` starts one
``nvcc`` per source at once and waits for all of them.

Nothing here runs when the module is imported: the CPU tests import
every module, and the CPU has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = CSRC.parent / "_build"
SOURCES = (
    "decode_nms_2d.cu", "greedy_nms.cu", "residual_decode_3d.cu", "suppress_pack_3d.cu",
    "segment_mean.cu", "segment_sum.cu",
)

# sm_90a: Hopper. --fmad=false: no mul+add contraction, so products and
# sums round as the plain PyTorch versions round them. No fast-math
# flag, so division is IEEE.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


class KernelError(RuntimeError):
    """A hand-written kernel failed to build, load or launch. The
    batchers never fall back to a plain path on it: the requests of the
    group fail with it."""


def nvcc() -> str:
    found = shutil.which("nvcc")
    return found or "/usr/local/cuda/bin/nvcc"


def build_command(source: str, output: pathlib.Path) -> list[str]:
    return [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(output), str(CSRC / source)]


def _build_dir() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def library_path(source: str) -> pathlib.Path:
    return _build_dir() / f"lib{pathlib.Path(source).stem}.so"


def build_all(sources: tuple[str, ...] = SOURCES) -> float:
    """Compile every library not built yet, one ``nvcc`` per source, all
    started together. Returns the wall seconds; raises
    :class:`KernelError` on a failure."""
    t0 = time.perf_counter()
    pending = []
    for src in sources:
        out = library_path(src)
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            build_command(src, tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT
        )
        pending.append((src, out, tmp, proc))
    errors = []
    for src, out, tmp, proc in pending:
        log_text, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc {src} failed ({proc.returncode}):\n{log_text.decode()}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)  # atomic: a reader never sees half a file
    if errors:
        raise KernelError("\n".join(errors))
    return time.perf_counter() - t0


def load(source: str, argtypes: dict[str, list]) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed, with
    ``argtypes`` declared on its C functions (each returns an int).
    Pointers and the stream must be ``ctypes.c_void_p``: an undeclared
    argument passes as a 32-bit int and cuts a pointer."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            build_all((source,))
            try:
                lib = ctypes.CDLL(str(library_path(source)))
            except OSError as e:
                raise KernelError(f"{source}: cannot load {library_path(source)}: {e}") from e
            for name, types in argtypes.items():
                fn = getattr(lib, name)
                fn.argtypes = types
                fn.restype = ctypes.c_int
            _libs[source] = lib
        return lib


def check_launch(name: str, err: int) -> None:
    if err != 0:
        raise KernelError(f"{name}: CUDA launch failed with error {err}")


class LaunchCounter:
    """Counts one kernel's launches; a wrapper adds one per launch."""

    def __init__(self) -> None:
        self._n = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self._n += 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def count(self) -> int:
        return self._n
