"""Length-prefixed frame protocol for the shard-worker RPC (pipe or socket).

One frame is::

    uint32_be header_len | header_json[header_len] | payload

``payload`` length comes from ``header["payload_len"]`` (0 when absent).
Array payloads are raw ``.npy`` bytes (``np.lib.format``), so result
vectors cross the link without pickling and parse straight back into
numpy — the npy header carries dtype/shape, the JSON header carries
everything else (request id, op, error info, scalar extras).

Unknown JSON header fields are ignored by both sides, which is how the
protocol evolves without version negotiation.  Two such optional fields
carry distributed tracing (:mod:`repro_torch.obs`): a traced request stamps
``"tp"`` (a W3C-style traceparent string) on its header, and the reply to a
traced request ships the worker-side span dicts home as ``"spans"`` (a
list; the client adopts them into its local tracer).  Old peers on either
side simply drop the fields — tracing degrades to "no remote spans", never
to an error.  Traced stats replies similarly add ``"hist"`` (a serialized
fixed-bucket latency histogram) next to the legacy ``"latencies"`` window.

Both sides write whole frames under a lock and flush once, so frames never
interleave; reads are blocking and a short read (EOF) returns ``(None,
b"")`` — the peer is gone.  A frame whose *framing itself* is corrupt (a
length beyond :data:`MAX_FRAME_BYTES`, a negative payload length, a
non-JSON header) raises the typed :class:`ProtocolError` instead: once the
byte stream desynchronizes nothing after it can be trusted, so readers
treat it as link death (worker pools map it to ``WorkerDied``) rather than
attempting a multi-GB allocation on a garbage length prefix.
"""
from __future__ import annotations

import io
import json
import struct
from typing import BinaryIO

import numpy as np

_LEN = struct.Struct(">I")

# Sanity cap on peer-supplied lengths.  Result payloads are npy vectors of
# node ids — even a full-corpus result at paper scale is tens of MB — so
# anything near 4 GB is a corrupt or hostile length prefix, not data.  The
# cap bounds the allocation a single frame can demand from the reader.
MAX_FRAME_BYTES = 1 << 30


class ProtocolError(ValueError):
    """The frame stream is corrupt (bad length prefix or non-JSON header).

    Subclasses :class:`ValueError` so writer-side guards surface through the
    same ``(OSError, ValueError)`` handling as a broken pipe: a link whose
    framing cannot be trusted is a dead link.
    """


def write_frame(stream: BinaryIO, header: dict, payload: bytes = b"") -> None:
    """Write one frame and flush.  The caller must hold the stream's write
    lock across the call — both writes below land inside it, so framing
    atomicity is preserved without concatenating header and payload into
    one throwaway bytes object (payloads are multi-MB npy results; the old
    ``pack + raw + payload`` concat copied every one of them per frame)."""
    header = dict(header)
    if payload:
        if len(payload) > MAX_FRAME_BYTES:
            raise ProtocolError(
                f"payload of {len(payload)} bytes exceeds MAX_FRAME_BYTES "
                f"({MAX_FRAME_BYTES})"
            )
        header["payload_len"] = len(payload)
    data = json.dumps(header, separators=(",", ":"), default=_json_default)
    raw = data.encode()
    stream.write(_LEN.pack(len(raw)) + raw)  # one small buffered write
    if payload:
        # large writes bypass the stream buffer and go straight to the fd /
        # socket — no copy of the payload is ever made on this side
        stream.write(memoryview(payload))
    stream.flush()


def _json_default(obj):
    # numpy scalars (counter rollups, doc counts) serialize as their value
    if hasattr(obj, "item"):
        return obj.item()
    raise TypeError(f"not JSON serializable: {type(obj).__name__}")


def _read_exact(stream: BinaryIO, n: int) -> bytes | None:
    buf = b""
    while len(buf) < n:
        chunk = stream.read(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def read_frame(stream: BinaryIO) -> tuple[dict | None, bytes]:
    """Read one frame; ``(None, b"")`` means the stream ended (peer gone).

    Raises :class:`ProtocolError` when the stream is *corrupt* rather than
    merely closed: a peer-supplied length beyond :data:`MAX_FRAME_BYTES`
    (never allocate on a garbage prefix), a negative payload length, or a
    header that is not JSON.
    """
    head = _read_exact(stream, _LEN.size)
    if head is None:
        return None, b""
    header_len = _LEN.unpack(head)[0]
    if header_len > MAX_FRAME_BYTES:
        raise ProtocolError(
            f"header length {header_len} exceeds MAX_FRAME_BYTES "
            f"({MAX_FRAME_BYTES}) — corrupt length prefix"
        )
    raw = _read_exact(stream, header_len)
    if raw is None:
        return None, b""
    try:
        header = json.loads(raw)
    except ValueError as e:
        raise ProtocolError(f"non-JSON frame header: {e}") from e
    if not isinstance(header, dict):
        raise ProtocolError(
            f"frame header is {type(header).__name__}, expected object"
        )
    n = int(header.get("payload_len", 0))
    if n < 0 or n > MAX_FRAME_BYTES:
        raise ProtocolError(
            f"payload length {n} out of range [0, {MAX_FRAME_BYTES}]"
        )
    payload = b""
    if n:
        payload = _read_exact(stream, n)
        if payload is None:
            return None, b""
    return header, payload


def dump_array(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.lib.format.write_array(
        buf, np.ascontiguousarray(arr), allow_pickle=False
    )
    return buf.getvalue()


def load_array(payload: bytes) -> np.ndarray:
    return np.lib.format.read_array(io.BytesIO(payload), allow_pickle=False)
