"""Copy of `repro/core/messages.py`.

Runtime request messages (paper §3.1).

Two request kinds only — Submit and Done; task deletion is covered by the
extra FINISHED -> COMPLETED state transition instead of a third message.

The same types serve both routings: in ``dast``/``ddast`` mode a message
sits in the creating/executing worker's queue pair; in ``sharded`` mode
one message object is pushed to the mailbox of every shard its WD's
regions hash to, and each shard processes only its own portion of the
deps (see ``core.shards.router``). :class:`SubmitBatchMessage` is the
batched Submit: one mailbox entry carrying up to ``batch_size`` per-shard
task portions, so the per-message manager overhead that dominates at
high shard counts is paid once per batch.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import List, Sequence, Tuple

from .wd import WorkDescriptor


@dataclass
class SubmitTaskMessage:
    """Worker wants the task inserted in the dependence graph to discover
    its predecessors. MUST be processed in per-worker insertion order and
    by at most one manager per worker queue at a time."""
    wd: WorkDescriptor


@dataclass
class SubmitBatchMessage:
    """Batched Submit for ``sharded`` mode: the receiving shard inserts
    its portion of every WD in ``wds`` under ONE lock acquisition and the
    whole entry costs one manager pop+dispatch. Order within ``wds`` is
    the producer's creation order, so the §3.1 per-region submission
    ordering invariant is preserved batch-internally exactly as FIFO
    mailbox order preserves it across entries."""
    wds: List[WorkDescriptor]


@dataclass
class DoneTaskMessage:
    """Worker finished executing the task; successors must be notified and
    newly-ready ones scheduled. May be processed concurrently by any
    manager — execution finish order carries no semantics."""
    wd: WorkDescriptor


@dataclass
class DoneBatchMessage:
    """Batched Done for ``sharded`` mode, symmetric to
    :class:`SubmitBatchMessage`: the receiving shard scrubs its portion
    of every WD in ``wds`` under ONE lock acquisition and the whole
    entry costs one manager pop+dispatch. Legal because Done processing
    order carries no semantics (see :class:`DoneTaskMessage`) — only the
    per-WD latch arithmetic must balance, and it is unchanged."""
    wds: List[WorkDescriptor]


# ---------------------------------------------------------------------------
# Compact binary wire forms (process backend, core.procs).
#
# The in-process messages above carry live WorkDescriptor references —
# meaningless across an address-space boundary. The process backend
# ships the SAME two batch shapes, but flattened to what the other side
# actually needs: a Submit entry is (wd_id, payload, label) where
# ``payload`` is the pickled (func, args) pair, and a Done entry is
# (wd_id, t_start, t_end, status, blob) where ``blob`` is the pickled
# result (status 0), empty (status 1: result not picklable, dropped),
# or a UTF-8 traceback (status 2: body raised; status 3: replay-plane
# body raised). Struct-framed rather than pickled wholesale so a batch
# entry costs a fixed ~14/29-byte header per task, not a pickler walk
# over dataclasses.

_SUBMIT_HDR = struct.Struct("<QIH")      # wd_id, len(payload), len(label)
_DONE_HDR = struct.Struct("<QddBI")      # wd_id, t0, t1, status, len(blob)
_COUNT = struct.Struct("<I")

DONE_OK = 0              # blob = pickled result
DONE_NO_RESULT = 1       # result not picklable; dropped (blob empty)
DONE_ERROR = 2           # body raised; blob = UTF-8 traceback
DONE_PLANE_ERROR = 3     # replay-plane body raised; wd_id is the sid


def encode_submit_batch(entries: Sequence[Tuple[int, bytes, str]]) -> bytes:
    """Wire form of :class:`SubmitBatchMessage`: one frame per batch."""
    parts = [_COUNT.pack(len(entries))]
    for wd_id, payload, label in entries:
        lb = label.encode("utf-8")
        parts.append(_SUBMIT_HDR.pack(wd_id, len(payload), len(lb)))
        parts.append(payload)
        parts.append(lb)
    return b"".join(parts)


def decode_submit_batch(buf: bytes,
                        off: int = 0) -> List[Tuple[int, bytes, str]]:
    (count,) = _COUNT.unpack_from(buf, off)
    off += _COUNT.size
    out = []
    for _ in range(count):
        wd_id, plen, llen = _SUBMIT_HDR.unpack_from(buf, off)
        off += _SUBMIT_HDR.size
        payload = bytes(buf[off:off + plen])
        off += plen
        label = bytes(buf[off:off + llen]).decode("utf-8")
        off += llen
        out.append((wd_id, payload, label))
    return out


def encode_done_batch(
        entries: Sequence[Tuple[int, float, float, int, bytes]]) -> bytes:
    """Wire form of :class:`DoneBatchMessage`: one frame per batch."""
    parts = [_COUNT.pack(len(entries))]
    for wd_id, t0, t1, status, blob in entries:
        parts.append(_DONE_HDR.pack(wd_id, t0, t1, status, len(blob)))
        parts.append(blob)
    return b"".join(parts)


def decode_done_batch(
        buf: bytes,
        off: int = 0) -> List[Tuple[int, float, float, int, bytes]]:
    (count,) = _COUNT.unpack_from(buf, off)
    off += _COUNT.size
    out = []
    for _ in range(count):
        wd_id, t0, t1, status, blen = _DONE_HDR.unpack_from(buf, off)
        off += _DONE_HDR.size
        blob = bytes(buf[off:off + blen])
        off += blen
        out.append((wd_id, t0, t1, status, blob))
    return out
