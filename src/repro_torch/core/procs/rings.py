"""Copy of `repro/core/procs/rings.py`.

SPSC byte rings over ``multiprocessing.shared_memory``.

The process backend's mailboxes (paper §3.1, per-worker queue pairs)
must cross an address-space boundary, so the in-process ``SPSCQueue``
(a plain deque) is replaced by a shared-memory ring of length-prefixed
frames:

    [ head u64 | tail u64 | capacity u64 | data region ... ]

The creator writes the *logical* capacity into the header and attachers
read it back from there — never from ``shm.size``, which platforms that
page-round segments (macOS ``ftruncate``) report larger than requested;
a derived capacity would differ between the two sides and corrupt the
ring at the first wrap. ``head``/``tail`` are *monotonic byte counters*
(never wrapped); the
data offset is ``counter % capacity``. The producer owns ``tail``, the
consumer owns ``head`` — single writer per cursor, so no cross-process
lock is needed. 8-byte aligned cursor stores are effectively atomic on
x86-64/ARM64 (CPython writes them with one memcpy), and the payload is
fully written *before* the tail store that publishes it; on strongly
ordered x86 that suffices, and in practice the GIL release around the
syscall-free memoryview writes keeps ARM happy too. This is the same
"good-enough SPSC" contract real runtimes (e.g. AMReX/Perilla forwarders)
use for worker mailboxes.

Frames are ``u32 length | u32 crc32`` + payload, always contiguous:
when a frame does not fit before the end of the data region the
producer writes a ``WRAP`` marker (or, with < 4 bytes left, nothing)
and skips to the region start; the consumer mirrors the skip. The CRC
covers the payload; a mismatch at pop raises
:class:`~repro_torch.core.errors.RingCorruption` *after* advancing past the
frame, so one corrupt frame costs one structured error, not a desynced
ring — the process driver treats it as a worker fault (kill + respawn
+ retry). Frames larger than half the capacity — or pushes that time
out against a full ring — take the **fallback lane**: the raw frame
goes through a ``SimpleQueue`` (pipe) and a 4-byte ``FALLBACK`` marker
keeps its position in the ring (the pipe transport has its own
integrity, so fallback frames carry no ring-side CRC), preserving FIFO
order even for payloads the ring cannot hold.
"""
from __future__ import annotations

import struct
import time
import zlib
from multiprocessing import shared_memory
from typing import Optional

from ..errors import RingCorruption

_U64 = struct.Struct("<Q")
_U32 = struct.Struct("<I")

_HDR = 24                      # head u64 @0, tail u64 @8, capacity @16
_FHDR = 8                      # frame header: u32 length + u32 crc32
WRAP = 0xFFFFFFFF              # skip to data-region start
FALLBACK = 0xFFFFFFFE          # pop one frame from the fallback queue

# one frame must leave room for a trailing marker; keep it conservative
_MAX_INLINE_FRAC = 2           # inline frames <= capacity // 2


def attach_shm(name: str) -> shared_memory.SharedMemory:
    """Attach to an existing segment without adopting ownership. On
    CPython < 3.13 ``SharedMemory(name=...)`` re-registers the segment
    with the ``resource_tracker`` (bpo-39959); that is harmless here
    because every attacher is a ``multiprocessing`` child of the
    creator (under ``forkserver`` the server passes each new child the
    creator's tracker), so the whole tree shares ONE tracker process and the
    re-register is a set-add no-op. Do NOT unregister (the tempting
    bpo-39959 workaround): that would strip the creator's own tracker
    entry and turn its eventual ``unlink()`` into tracker-side KeyError
    noise. The creator remains the sole unlinker."""
    return shared_memory.SharedMemory(name=name)


class ShmRing:
    """One direction of a worker mailbox. Construct with ``create=True``
    in the owning (parent) process; workers attach with
    :meth:`attach`. Exactly one producer process/thread and one consumer
    process/thread; the parent side serializes its multiple producer
    threads externally (``ProcessDispatch`` holds one lock per ring)."""

    def __init__(self, capacity: int = 1 << 20, *, create: bool = True,
                 name: Optional[str] = None, fallback=None) -> None:
        if create and capacity < 64:
            raise ValueError("capacity must be >= 64 bytes")
        if create:
            self.shm = shared_memory.SharedMemory(
                create=True, size=_HDR + capacity)
            self.capacity = capacity
            self.shm.buf[:_HDR] = b"\0" * _HDR
            _U64.pack_into(self.shm.buf, 16, capacity)
        else:
            self.shm = attach_shm(name)
            # read the creator's logical capacity from the header:
            # shm.size may be page-rounded above what was requested
            self.capacity = _U64.unpack_from(self.shm.buf, 16)[0]
        self.name = self.shm.name
        self.owner = create
        self.fallback = fallback         # SimpleQueue for oversize frames
        self.consumer_alive = None       # optional liveness probe; see push
        # local-side counters (not shared; each side counts its own ops)
        self.pushed = 0
        self.popped = 0
        self.fallbacks = 0
        # fault-injection hook (core.procs.chaos): flip one payload byte
        # of the next inline push AFTER its CRC is computed, so the
        # consumer's check fires deterministically
        self._corrupt_next = False

    @classmethod
    def attach(cls, name: str, fallback=None) -> "ShmRing":
        return cls(create=False, name=name, fallback=fallback)

    # -- cursor access --------------------------------------------------
    def _head(self) -> int:
        return _U64.unpack_from(self.shm.buf, 0)[0]

    def _tail(self) -> int:
        return _U64.unpack_from(self.shm.buf, 8)[0]

    def _set_head(self, v: int) -> None:
        _U64.pack_into(self.shm.buf, 0, v)

    def _set_tail(self, v: int) -> None:
        _U64.pack_into(self.shm.buf, 8, v)

    def __len__(self) -> int:
        return self._tail() - self._head()

    # -- producer -------------------------------------------------------
    def try_push(self, frame: bytes) -> bool:
        """Append one frame if it fits (inline or as a fallback marker
        when a fallback queue is wired and the frame is oversize).
        Returns False when the ring lacks space right now."""
        n = len(frame)
        if self.fallback is not None and \
                n + _FHDR > self.capacity // _MAX_INLINE_FRAC:
            return self._push_fallback(frame)
        return self._push_inline(frame)

    def push(self, frame: bytes, spin_s: float = 0.5) -> None:
        """Blocking append: spin (with micro-sleeps) until the consumer
        frees space, then degrade to the fallback lane if one exists.
        A ring that stays full past ``spin_s`` is not by itself a dead
        consumer — a worker grinding through a long task body with a
        full exec ring is alive and will drain eventually — so when a
        ``consumer_alive`` probe is wired (the driver points it at
        ``Process.is_alive`` / the worker's parent-process sentinel) the
        producer keeps
        waiting while it returns True. BufferError is raised only when
        the probe says dead, or no probe exists to say otherwise."""
        deadline = time.perf_counter() + spin_s
        while True:
            if self.try_push(frame):
                return
            if time.perf_counter() > deadline:
                if self.fallback is not None and \
                        self._push_fallback(frame, spin_s):
                    return
                if self.consumer_alive is not None \
                        and self.consumer_alive():
                    deadline = time.perf_counter() + spin_s
                    continue             # slow consumer, not a dead one
                raise BufferError(
                    f"ring {self.name} full for {spin_s}s "
                    f"(consumer dead?)")
            time.sleep(5e-6)

    def _push_inline(self, frame: bytes) -> bool:
        n = len(frame)
        cap = self.capacity
        if n + _FHDR > cap // _MAX_INLINE_FRAC:
            return False                 # never fits: caller's problem
        head, tail = self._head(), self._tail()
        free = cap - (tail - head)
        off = tail % cap
        contig = cap - off
        if contig < n + _FHDR:
            # frame would straddle the region end: burn `contig` bytes
            # (with a WRAP marker when the length field fits)
            if free < contig + n + _FHDR:
                return False
            if contig >= 4:
                _U32.pack_into(self.shm.buf, _HDR + off, WRAP)
            tail += contig
            off = 0
        elif free < n + _FHDR:
            return False
        _U32.pack_into(self.shm.buf, _HDR + off, n)
        _U32.pack_into(self.shm.buf, _HDR + off + 4,
                       zlib.crc32(frame) & 0xFFFFFFFF)
        self.shm.buf[_HDR + off + _FHDR:_HDR + off + _FHDR + n] = frame
        if self._corrupt_next and n:
            self.shm.buf[_HDR + off + _FHDR] ^= 0xFF
            self._corrupt_next = False
        self._set_tail(tail + _FHDR + n)  # publish AFTER the payload
        self.pushed += 1
        return True

    def _push_fallback(self, frame: bytes, spin_s: float = 0.5) -> bool:
        """Route the frame through the pipe, keeping its FIFO slot with
        an in-ring marker. Ordering matters, twice over. The marker is
        secured and published BEFORE the put(): (a) a timed-out attempt
        then leaves NOTHING behind — enqueueing first would orphan the
        queue entry on timeout and the caller's retry would enqueue a
        duplicate, desynchronizing every later FALLBACK pop from its
        frame; (b) put() on a ``multiprocessing.SimpleQueue`` blocks
        once the frame outgrows the pipe buffer and only unblocks when
        the consumer get()s — the consumer must already be able to see
        the marker that tells it to, or both sides deadlock. The
        consumer's get() at worst blocks briefly on a put() still in
        flight, which is harmless."""
        deadline = time.perf_counter() + spin_s
        cap = self.capacity
        while True:
            head, tail = self._head(), self._tail()
            off = tail % cap
            contig = cap - off
            if contig < 4 and cap - (tail - head) >= contig + 4:
                tail += contig           # markerless end-of-region skip
                off, contig = 0, cap
            if contig >= 4 and cap - (tail - head) >= 4:
                _U32.pack_into(self.shm.buf, _HDR + off, FALLBACK)
                self._set_tail(tail + 4)
                self.fallback.put(frame)  # put AFTER the marker publish
                self.pushed += 1
                self.fallbacks += 1
                return True
            if time.perf_counter() > deadline:
                return False
            time.sleep(5e-6)

    # -- consumer -------------------------------------------------------
    def pop(self) -> Optional[bytes]:
        """Dequeue one frame, or None when the ring is empty. Raises
        :class:`RingCorruption` when a frame's payload fails its CRC32
        check — the head has already advanced past the bad frame, so
        the next pop reads the next frame."""
        while True:
            head, tail = self._head(), self._tail()
            if head == tail:
                return None
            cap = self.capacity
            off = head % cap
            contig = cap - off
            if contig < 4:               # producer skipped, markerless
                self._set_head(head + contig)
                continue
            n = _U32.unpack_from(self.shm.buf, _HDR + off)[0]
            if n == WRAP:
                self._set_head(head + contig)
                continue
            if n == FALLBACK:
                self._set_head(head + 4)
                self.popped += 1
                return self.fallback.get()
            crc = _U32.unpack_from(self.shm.buf, _HDR + off + 4)[0]
            frame = bytes(self.shm.buf[_HDR + off + _FHDR:
                                       _HDR + off + _FHDR + n])
            self._set_head(head + _FHDR + n)
            self.popped += 1
            actual = zlib.crc32(frame) & 0xFFFFFFFF
            if actual != crc:
                raise RingCorruption(
                    f"ring {self.name}: frame at offset {off} failed "
                    f"CRC32 (stored {crc:#010x}, computed "
                    f"{actual:#010x})", ring=self.name,
                    expected=crc, actual=actual)
            return frame

    # -- lifecycle ------------------------------------------------------
    def close(self) -> None:
        try:
            self.shm.close()
        except Exception:                # pragma: no cover - teardown
            pass

    def unlink(self) -> None:
        """Owner-side destroy. Safe to call once; attachers never do."""
        if not self.owner:
            return
        try:
            self.shm.unlink()
        except FileNotFoundError:        # pragma: no cover - teardown
            pass
