"""Copy of `repro/core/procs/serial.py`.

Frame layer for the process backend's ring mailboxes.

One ring frame = 1 kind byte + a kind-specific body. The two hot kinds
are exactly the §3.1 message shapes in their compact binary wire form
(``core.messages.encode_submit_batch`` / ``encode_done_batch``); control
and trace frames are cold-path and carry a small pickled payload.

    EXEC   parent -> worker   submit batch: [(wd_id, payload, label)]
    DONE   worker -> parent   done batch:   [(wd_id, t0, t1, st, blob)]
    CTRL   parent -> worker   u8 op + pickled body
                               SHUTDOWN: body None — ship trace, exit
                               ITER: body = replay-plane descriptor dict
                               (shm names + offsets + generation); the
                               ONE boundary message per worker a
                               replayed iteration costs
    TRACE  worker -> parent   pickled list of event tuples (shipped once
                               at shutdown; merged by TraceRecorder)
    READY  worker -> parent   pickled dict (pid, the clock at ready, a
                               start-up error or None): the port's one new
                               kind, sent once, before any DONE, when the
                               worker's rings, counter row, modules and
                               device context are up; the parent counts a
                               task's timeout from it, never from before
"""
from __future__ import annotations

import pickle
from typing import Any, List, Sequence, Tuple

from ..messages import (decode_done_batch, decode_submit_batch,
                        encode_done_batch, encode_submit_batch)

K_EXEC = 1
K_DONE = 2
K_CTRL = 3
K_TRACE = 4
K_READY = 5

OP_SHUTDOWN = 0
OP_ITER = 1


def frame_exec(entries: Sequence[Tuple[int, bytes, str]]) -> bytes:
    return bytes([K_EXEC]) + encode_submit_batch(entries)


def frame_done(
        entries: Sequence[Tuple[int, float, float, int, bytes]]) -> bytes:
    return bytes([K_DONE]) + encode_done_batch(entries)


def frame_ctrl(op: int, body: Any = None) -> bytes:
    return bytes([K_CTRL, op]) + pickle.dumps(body, protocol=4)


def frame_trace(events: List[tuple]) -> bytes:
    return bytes([K_TRACE]) + pickle.dumps(events, protocol=4)


def frame_ready(info: dict) -> bytes:
    return bytes([K_READY]) + pickle.dumps(info, protocol=4)


def parse(frame: bytes):
    """-> (kind, decoded body). CTRL bodies decode to (op, payload)."""
    kind = frame[0]
    if kind == K_EXEC:
        return kind, decode_submit_batch(frame, 1)
    if kind == K_DONE:
        return kind, decode_done_batch(frame, 1)
    if kind == K_CTRL:
        return kind, (frame[1], pickle.loads(frame[2:]))
    if kind in (K_TRACE, K_READY):
        return kind, pickle.loads(frame[1:])
    raise ValueError(f"unknown frame kind {kind}")
