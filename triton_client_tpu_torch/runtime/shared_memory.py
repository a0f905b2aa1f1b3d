"""System shared-memory regions for the KServe serving path (the port's
copy of ``runtime/shared_memory.py``: numpy and mmap only).

Triton's system-shared-memory extension lets a same-host client hand
tensors to the server through a POSIX shm segment instead of the gRPC
wire: the client registers a region (name -> shm key + byte range),
then sends infer requests whose input tensors carry
``shared_memory_region`` / ``shared_memory_offset`` /
``shared_memory_byte_size`` parameters and NO raw content. The server
writes requested outputs into a client region the same way. The region
keys, offsets and bounds checks are the JAX package's, so either
package's client can use either package's server.

POSIX ``shm_open(key)`` maps to ``/dev/shm/<key>`` on Linux, so
regions are plain mmaps over files there (the segments tritonclient's
``create_shared_memory_region`` creates), without python's
``multiprocessing.shared_memory`` resource tracker (which unlinks
attached segments at interpreter exit on < 3.13).

Lifecycle contract (Triton's):
  * the CLIENT creates the segment, writes tensors, and eventually
    unlinks it;
  * the SERVER only registers (attaches) and unregisters (detaches) —
    it never unlinks the backing file.
"""

from __future__ import annotations

import collections
import mmap
import os
import threading
from dataclasses import dataclass

import numpy as np

_SHM_DIR = "/dev/shm"


def _shm_path(key: str) -> str:
    # POSIX keys conventionally start with "/"; shm_open("/foo") is
    # /dev/shm/foo. Reject path traversal — keys are wire-controlled.
    name = key[1:] if key.startswith("/") else key
    if not name or "/" in name or name.startswith("."):
        raise ValueError(f"invalid shared-memory key {key!r}")
    return os.path.join(_SHM_DIR, name)


class SharedMemoryRegion:
    """One mapped shm segment. ``create`` (client side) makes and owns
    the backing file; ``attach`` (server side) maps an existing one."""

    def __init__(self, key: str, mm: mmap.mmap, size: int, owns: bool):
        self.key = key
        self._mm = mm
        self.size = size
        self._owns = owns
        self._closed = False

    @classmethod
    def create(cls, key: str, byte_size: int) -> "SharedMemoryRegion":
        path = _shm_path(key)
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
        except FileExistsError:
            # a stale segment from a crashed run (same pid after a
            # container restart): reclaim it. O_EXCL on the retry keeps
            # the window race-free; a symlink planted at the name fails
            # both opens rather than being followed.
            os.unlink(path)
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
        try:
            os.ftruncate(fd, byte_size)
            mm = mmap.mmap(fd, byte_size)
        finally:
            os.close(fd)
        return cls(key, mm, byte_size, owns=True)

    @classmethod
    def attach(cls, key: str, byte_size: int = 0) -> "SharedMemoryRegion":
        path = _shm_path(key)
        fd = os.open(path, os.O_RDWR)
        try:
            actual = os.fstat(fd).st_size
            if byte_size and byte_size > actual:
                raise ValueError(
                    f"shared-memory region {key!r} is {actual} bytes; "
                    f"{byte_size} requested"
                )
            mm = mmap.mmap(fd, actual)
        finally:
            os.close(fd)
        return cls(key, mm, actual, owns=False)

    # -- tensor IO ------------------------------------------------------------

    def write(self, arr: np.ndarray, offset: int = 0) -> int:
        """Copy ``arr``'s bytes into the region; returns bytes written."""
        arr = np.ascontiguousarray(arr)
        n = arr.nbytes
        if offset < 0 or offset + n > self.size:
            raise ValueError(
                f"write of {n} bytes at offset {offset} exceeds region "
                f"{self.key!r} ({self.size} bytes)"
            )
        # numpy-to-numpy copy releases the GIL (a plain mmap slice
        # assignment holds it) — concurrent serving clients on a small
        # host overlap their memcpys
        dst = np.frombuffer(self._mm, np.uint8, count=n, offset=offset)
        np.copyto(dst, arr.view(np.uint8).reshape(-1))
        return n

    def read(self, offset: int, byte_size: int) -> memoryview:
        """Zero-copy view of a byte range (valid until close())."""
        if offset < 0 or offset + byte_size > self.size:
            raise ValueError(
                f"read of {byte_size} bytes at offset {offset} exceeds "
                f"region {self.key!r} ({self.size} bytes)"
            )
        return memoryview(self._mm)[offset : offset + byte_size]

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self._mm.close()
        except BufferError:
            # zero-copy views handed out by read() are still alive
            # (e.g. a batched request not yet dispatched): leave the
            # mapping to the GC rather than invalidating live tensors.
            pass
        if self._owns:
            try:
                os.unlink(_shm_path(self.key))
            except FileNotFoundError:
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


@dataclass(frozen=True)
class _Registered:
    region: SharedMemoryRegion
    key: str
    offset: int
    byte_size: int


class SystemSharedMemoryRegistry:
    """Server-side name -> attached region map behind the
    SystemSharedMemory{Register,Status,Unregister} RPCs."""

    def __init__(self) -> None:
        self._regions: dict[str, _Registered] = {}
        self._lock = threading.Lock()

    def register(
        self, name: str, key: str, offset: int = 0, byte_size: int = 0
    ) -> None:
        with self._lock:
            if name in self._regions:
                raise ValueError(
                    f"shared-memory region {name!r} is already registered"
                )
            region = SharedMemoryRegion.attach(key, offset + byte_size)
            self._regions[name] = _Registered(
                region, key, offset, byte_size or (region.size - offset)
            )

    def unregister(self, name: str) -> None:
        with self._lock:
            reg = self._regions.pop(name, None)
        if reg is not None:
            reg.region.close()

    def unregister_all(self) -> None:
        with self._lock:
            regs, self._regions = list(self._regions.values()), {}
        for reg in regs:
            reg.region.close()

    def status(self, name: str = "") -> dict[str, _Registered]:
        with self._lock:
            if name:
                if name not in self._regions:
                    raise KeyError(f"shared-memory region {name!r} not registered")
                return {name: self._regions[name]}
            return dict(self._regions)

    # -- codec hooks ----------------------------------------------------------

    def read(self, name: str, offset: int, byte_size: int) -> memoryview:
        """Bytes of a registered region; ``offset`` is relative to the
        region's registered base offset (Triton semantics)."""
        with self._lock:
            if name not in self._regions:
                raise ValueError(
                    f"shared-memory region {name!r} is not registered"
                )
            reg = self._regions[name]
        if offset < 0 or byte_size > reg.byte_size - offset:
            raise ValueError(
                f"request for {byte_size} bytes at offset {offset} exceeds "
                f"registered window of {name!r} ({reg.byte_size} bytes)"
            )
        return reg.region.read(reg.offset + offset, byte_size)

    def write(self, name: str, offset: int, arr: np.ndarray) -> int:
        with self._lock:
            if name not in self._regions:
                raise ValueError(
                    f"shared-memory region {name!r} is not registered"
                )
            reg = self._regions[name]
        if offset < 0 or arr.nbytes > reg.byte_size - offset:
            raise ValueError(
                f"output of {arr.nbytes} bytes at offset {offset} exceeds "
                f"registered window of {name!r} ({reg.byte_size} bytes)"
            )
        # region.write is the single designed host copy on the response
        # path: readback view -> client's mapped segment (it handles
        # non-contiguous inputs itself; no pre-copy here)
        return reg.region.write(arr, reg.offset + offset)


class PoolSlot:
    """One pipeline slot of a :class:`ShmRegionPool`: a set of
    client-owned regions keyed by logical tensor name, each generation-
    tagged so a grown (re-created) segment never reuses a registered
    name. A slot is exclusively owned by one in-flight request between
    ``acquire`` and ``release``; its regions persist across requests so
    registration is amortized to once per (slot, input, size class)."""

    __slots__ = ("index", "busy", "regions", "_gen", "_pool")

    def __init__(self, pool: "ShmRegionPool", index: int) -> None:
        self._pool = pool
        self.index = index
        self.busy = False
        self.regions: dict[str, SharedMemoryRegion] = {}
        self._gen: dict[str, int] = {}

    def region_for(self, name: str, nbytes: int) -> SharedMemoryRegion:
        """The slot's region for one logical tensor, created or grown
        on demand. Growth burns a generation (segment names are
        register-once server-side) and replaces the old registration
        only AFTER the new register succeeds, so a failed register RPC
        leaks nothing and leaves the old region usable."""
        region = self.regions.get(name)
        if region is not None and region.size >= nbytes:
            return region
        gen = self._gen.get(name, 0)
        self._gen[name] = gen + 1
        rname = f"{self._pool.tag}_s{self.index}_{name}_g{gen}"
        new = SharedMemoryRegion.create(f"/{rname}", max(nbytes, 1))
        try:
            self._pool.register_fn(rname, new.key, new.size)
        except Exception:
            new.close()  # unlinks; server maps by its own fd if it
            raise        # did register, so unlinking is safe either way
        if region is not None:
            self._pool.unregister_fn(region.key.lstrip("/"))
            region.close()
        self.regions[name] = new
        return new

    def retire(self, name: str) -> None:
        """Drop one logical region (unregister + unlink). The cancel
        path retires the output arena: a cancelled server may write
        into it arbitrarily late, so the segment must never be handed
        to the slot's next owner — the next use re-creates it under a
        fresh generation name."""
        region = self.regions.pop(name, None)
        if region is not None:
            self._pool.unregister_fn(region.key.lstrip("/"))
            region.close()


class ShmRegionPool:
    """Client-side pool of shm slots sized to the pipeline depth.

    Pooling per ``(slot, input, generation)`` gives every in-flight
    request exclusive segments (a region must stay untouched until its
    response arrives): ``depth`` concurrent requests ride shm, the
    ``depth+1``-th blocks in ``acquire`` — backpressure that mirrors
    the server's staging-slot pipeline depth.

    ``register_fn(name, key, byte_size)`` / ``unregister_fn(name)`` are
    the owner channel's RPC hooks; unregister must be best-effort (it
    is called on the growth path against possibly-gone registrations).
    """

    def __init__(
        self,
        tag: str,
        depth: int,
        register_fn,
        unregister_fn,
    ) -> None:
        self.tag = tag
        self.depth = max(1, int(depth))
        self.register_fn = register_fn
        self.unregister_fn = unregister_fn
        self._slots = [PoolSlot(self, i) for i in range(self.depth)]
        self._free: collections.deque[PoolSlot] = collections.deque(
            self._slots
        )
        self._cv = threading.Condition()
        self._closed = False
        # gate-test observability: acquires, high-water in-flight, and
        # the alias counter a correct pool keeps at zero forever
        self._acquires = 0
        self._max_in_flight = 0
        self._aliased = 0

    def acquire(self, timeout_s: float | None = None) -> PoolSlot:
        with self._cv:
            if not self._cv.wait_for(
                lambda: self._free or self._closed, timeout=timeout_s
            ):
                raise TimeoutError(
                    f"no free shm slot within {timeout_s}s "
                    f"({self.depth} in flight)"
                )
            if self._closed:
                raise RuntimeError("shm region pool is closed")
            slot = self._free.popleft()
            if slot.busy:  # invariant violation — must never happen
                self._aliased += 1
                raise RuntimeError(
                    f"shm slot {slot.index} handed out while busy"
                )
            slot.busy = True
            self._acquires += 1
            in_flight = self.depth - len(self._free)
            if in_flight > self._max_in_flight:
                self._max_in_flight = in_flight
            return slot

    def release(self, slot: PoolSlot) -> None:
        """Idempotent: resolve-path ``finally`` and cancel hooks may
        both fire for one request."""
        with self._cv:
            if self._closed or not slot.busy:
                return
            slot.busy = False
            # LIFO: the just-released slot goes to the front so low
            # concurrency reuses warm slots (regions already sized and
            # registered) instead of rotating cold ones into play
            self._free.appendleft(slot)
            self._cv.notify()

    def regions(self) -> list[SharedMemoryRegion]:
        return [r for s in self._slots for r in s.regions.values()]

    def reregister_all(self) -> None:
        """Restart recovery: push every slot's segments back into a
        server whose registry came up empty. The guarded unregister
        first is ONLY the duplicate-name guard (if merely SOME regions
        were lost, a blind register hits the rejection; unknown-name
        unregister is a no-op)."""
        for region in self.regions():
            rname = region.key.lstrip("/")
            self.unregister_fn(rname)
            self.register_fn(rname, region.key, region.size)

    def stats(self) -> dict:
        with self._cv:
            return {
                "depth": self.depth,
                "in_flight": self.depth - len(self._free),
                "max_in_flight": self._max_in_flight,
                "acquires": self._acquires,
                "aliased": self._aliased,
                "regions": sum(len(s.regions) for s in self._slots),
                "region_bytes": sum(
                    r.size for s in self._slots
                    for r in s.regions.values()
                ),
            }

    def close(self) -> None:
        """Unregister (best effort, via the owner's hook) and unlink
        every segment; wake blocked acquirers with an error."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._cv.notify_all()
        for slot in self._slots:
            for region in slot.regions.values():
                self.unregister_fn(region.key.lstrip("/"))
                region.close()
            slot.regions.clear()
