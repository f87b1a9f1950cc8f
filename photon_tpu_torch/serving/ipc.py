"""Worker↔scorer IPC transports for the serving front line.

A copy of the JAX package's ``serving/ipc.py``: it imports neither JAX nor
torch, and ``tests/test_torch_frontline.py`` compares the code, so edit
both or neither.

Two interchangeable transports carry :mod:`photon_tpu_torch.serving.wire`
frames between a front-end worker process and the device-owning scorer
process (docs/serving.md §"Front line"):

* :class:`ShmRing` — a **lock-free SPSC byte ring** over
  ``multiprocessing.shared_memory``. Head/tail are monotonically
  increasing u64 byte counters at fixed 8-byte-aligned offsets; the
  producer only writes the tail, the consumer only writes the head, so
  there is no cross-process lock anywhere on the hot path. (CPython
  writes an aligned 8-byte slice with a single ``memcpy``, which is
  atomic on every platform this project targets; the socket transport
  below is the fallback for anything more exotic.) Monotonic counters
  sidestep the classic empty-vs-full ambiguity: ``tail - head`` is the
  exact number of unread bytes.
* :class:`SocketChannel` — a connected ``AF_UNIX`` stream socket with
  the same u32-length framing. Slightly higher per-frame cost (two
  syscalls) but zero shared-memory assumptions; it is also the accept
  path workers use to introduce themselves when rings are disabled.

Both expose the same three calls — ``send(frame)``, ``recv(timeout)``,
``close()`` — so the frontline service and the workers are transport-
agnostic. ``send`` is thread-safe (the scorer's response path has two
producers: the batcher callback and the control plane); ``recv`` assumes
a single reader, which both sides guarantee by construction.

jax-free by design: workers import this at boot.
"""
from __future__ import annotations

import os
import socket
import struct
import threading
import time
from typing import Optional

_U64 = struct.Struct("<Q")
_LEN = struct.Struct("<I")
_RING_HEADER = 16  # [0:8) head (consumer-owned), [8:16) tail (producer-owned)

DEFAULT_RING_BYTES = 1 << 20  # 1 MiB per direction per worker


class RingFull(RuntimeError):
    """Producer timed out waiting for ring space (backpressure signal)."""


class TransportClosed(RuntimeError):
    """The peer went away (worker exit / scorer exit)."""


def _sleep_backoff(spins: int) -> None:
    # Adaptive wait: burn a few polls for sub-µs latency, then yield with
    # escalating sleeps so an idle ring costs ~nothing.
    if spins < 64:
        return
    if spins < 256:
        time.sleep(0)
    elif spins < 1024:
        time.sleep(50e-6)
    else:
        time.sleep(500e-6)


class ShmRing:
    """One direction of a shared-memory frame ring (SPSC, lock-free)."""

    def __init__(self, shm, *, owner: bool):
        self._shm = shm
        self._buf = shm.buf
        self._cap = shm.size - _RING_HEADER
        self._owner = owner
        self._send_lock = threading.Lock()  # in-process producers only
        self._closed = False

    # -- construction ------------------------------------------------------

    @classmethod
    def create(cls, name: str, capacity: int = DEFAULT_RING_BYTES):
        from multiprocessing import shared_memory

        shm = shared_memory.SharedMemory(
            name=name, create=True, size=capacity + _RING_HEADER)
        shm.buf[:_RING_HEADER] = b"\x00" * _RING_HEADER
        return cls(shm, owner=True)

    @classmethod
    def attach(cls, name: str):
        from multiprocessing import shared_memory

        shm = shared_memory.SharedMemory(name=name)
        # The attaching process must NOT let its resource tracker unlink
        # the segment at exit — the creator owns the lifetime. (The
        # tracker auto-registers on attach in CPython's implementation.)
        try:
            from multiprocessing import resource_tracker

            resource_tracker.unregister(shm._name, "shared_memory")
        except Exception:  # noqa: BLE001 - tracker details vary by version
            pass
        return cls(shm, owner=False)

    # -- counters ----------------------------------------------------------

    def _head(self) -> int:
        return _U64.unpack_from(self._buf, 0)[0]

    def _tail(self) -> int:
        return _U64.unpack_from(self._buf, 8)[0]

    def _set_head(self, v: int) -> None:
        _U64.pack_into(self._buf, 0, v)

    def _set_tail(self, v: int) -> None:
        _U64.pack_into(self._buf, 8, v)

    # -- data movement -----------------------------------------------------

    def _write_at(self, pos: int, data: bytes) -> None:
        off = pos % self._cap
        first = min(len(data), self._cap - off)
        base = _RING_HEADER
        self._buf[base + off: base + off + first] = data[:first]
        if first < len(data):
            self._buf[base: base + len(data) - first] = data[first:]

    def _read_at(self, pos: int, n: int) -> bytes:
        off = pos % self._cap
        first = min(n, self._cap - off)
        base = _RING_HEADER
        out = bytes(self._buf[base + off: base + off + first])
        if first < n:
            out += bytes(self._buf[base: base + (n - first)])
        return out

    def send(self, frame: bytes, timeout: Optional[float] = 5.0) -> None:
        need = _LEN.size + len(frame)
        if need > self._cap:
            raise ValueError(
                f"frame of {len(frame)} bytes exceeds ring capacity "
                f"{self._cap}; raise the ring size"
            )
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._send_lock:
            spins = 0
            while True:
                if self._closed:
                    raise TransportClosed("ring closed")
                tail = self._tail()
                if self._cap - (tail - self._head()) >= need:
                    break
                if deadline is not None and time.monotonic() >= deadline:
                    raise RingFull(
                        f"ring full for {timeout:.1f}s "
                        f"({tail - self._head()} unread bytes)"
                    )
                spins += 1
                _sleep_backoff(spins)
            self._write_at(tail, _LEN.pack(len(frame)))
            self._write_at(tail + _LEN.size, frame)
            # Publish AFTER the payload bytes are in place: the consumer
            # only looks past `tail`, so a torn frame is never visible.
            self._set_tail(tail + need)

    def recv(self, timeout: Optional[float] = None) -> Optional[bytes]:
        deadline = None if timeout is None else time.monotonic() + timeout
        spins = 0
        while True:
            if self._closed:
                return None
            head = self._head()
            if self._tail() != head:
                break
            if deadline is not None and time.monotonic() >= deadline:
                return None
            spins += 1
            _sleep_backoff(spins)
        n = _LEN.unpack(self._read_at(head, _LEN.size))[0]
        frame = self._read_at(head + _LEN.size, n)
        self._set_head(head + _LEN.size + n)
        return frame

    def pending_bytes(self) -> int:
        return self._tail() - self._head()

    def close(self) -> None:
        self._closed = True
        try:
            # Release the memoryview before closing the mapping or CPython
            # refuses to close the shm (exported pointers).
            self._buf = None
            self._shm.close()
            if self._owner:
                self._shm.unlink()
        except Exception:  # noqa: BLE001 - teardown best-effort
            pass


class RingChannel:
    """Duplex frame channel from two one-direction rings."""

    def __init__(self, send_ring: ShmRing, recv_ring: ShmRing):
        self._send = send_ring
        self._recv = recv_ring

    def send(self, frame: bytes, timeout: Optional[float] = 5.0) -> None:
        self._send.send(frame, timeout=timeout)

    def recv(self, timeout: Optional[float] = None) -> Optional[bytes]:
        return self._recv.recv(timeout=timeout)

    def close(self) -> None:
        self._send.close()
        self._recv.close()


def ring_names(token: str, worker_id: int) -> tuple[str, str]:
    """Shared-memory segment names for one worker's (request, response)
    rings. Short and unique per box: shm names live in a global
    namespace."""
    return (f"ph-{token}-w{worker_id}q", f"ph-{token}-w{worker_id}r")


def create_worker_rings(
    token: str, worker_id: int, capacity: int = DEFAULT_RING_BYTES,
) -> RingChannel:
    """Scorer side: create both rings; returns the SCORER's view (sends
    responses, receives requests)."""
    req_name, resp_name = ring_names(token, worker_id)
    req = ShmRing.create(req_name, capacity)
    resp = ShmRing.create(resp_name, capacity)
    return RingChannel(send_ring=resp, recv_ring=req)


def attach_worker_rings(token: str, worker_id: int) -> RingChannel:
    """Worker side: attach to rings the scorer created; returns the
    WORKER's view (sends requests, receives responses)."""
    req_name, resp_name = ring_names(token, worker_id)
    req = ShmRing.attach(req_name)
    resp = ShmRing.attach(resp_name)
    return RingChannel(send_ring=req, recv_ring=resp)


class SocketChannel:
    """u32-length-framed duplex channel over a connected stream socket."""

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._send_lock = threading.Lock()
        self._recv_buf = b""
        self._closed = False
        sock.setblocking(True)

    @classmethod
    def connect(cls, path: str, timeout: float = 5.0) -> "SocketChannel":
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(timeout)
        s.connect(path)
        return cls(s)

    def send(self, frame: bytes, timeout: Optional[float] = 5.0) -> None:
        with self._send_lock:
            if self._closed:
                raise TransportClosed("socket closed")
            try:
                self._sock.settimeout(timeout)
                self._sock.sendall(_LEN.pack(len(frame)) + frame)
            except (BrokenPipeError, ConnectionError, OSError) as e:
                raise TransportClosed(f"peer gone: {e}") from None

    def _read_exact(self, n: int, deadline: Optional[float]) -> Optional[bytes]:
        while len(self._recv_buf) < n:
            if self._closed:
                return None
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._sock.settimeout(min(remaining, 0.5))
            else:
                self._sock.settimeout(0.5)
            try:
                chunk = self._sock.recv(1 << 16)
            except socket.timeout:
                continue
            except OSError as e:
                raise TransportClosed(f"peer gone: {e}") from None
            if not chunk:
                raise TransportClosed("peer closed the connection")
            self._recv_buf += chunk
        out = self._recv_buf[:n]
        self._recv_buf = self._recv_buf[n:]
        return out

    def recv(self, timeout: Optional[float] = None) -> Optional[bytes]:
        deadline = None if timeout is None else time.monotonic() + timeout
        hdr = self._read_exact(_LEN.size, deadline)
        if hdr is None:
            return None
        n = _LEN.unpack(hdr)[0]
        # The length prefix is committed; finish the frame even if the
        # caller's timeout elapsed mid-frame (partial reads would desync).
        return self._read_exact(n, None)

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass


class SocketListener:
    """Scorer-side accept loop companion for the socket fallback."""

    def __init__(self, path: str):
        self.path = path
        if os.path.exists(path):
            os.unlink(path)
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(path)
        self._sock.listen(64)
        self._sock.settimeout(0.5)
        self._closed = False

    def accept(self) -> Optional[SocketChannel]:
        while not self._closed:
            try:
                conn, _ = self._sock.accept()
                return SocketChannel(conn)
            except socket.timeout:
                continue
            except OSError:
                return None
        return None

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass
        try:
            os.unlink(self.path)
        except OSError:
            pass


def shm_available() -> bool:
    """Can this box create POSIX shared memory? (Containers sometimes
    mount /dev/shm noexec-tiny or not at all — fall back to sockets.)"""
    try:
        ring = ShmRing.create(f"ph-probe-{os.getpid()}", 4096)
        ring.close()
        return True
    except Exception:  # noqa: BLE001 - any failure means "use sockets"
        return False
