"""Length-prefixed RPC framing of the cluster transport.

The reference's wire format (sieve/rpc.py), byte for byte: an 8-byte
big-endian length prefix followed by a JSON object, or by a v2 columnar
body (the 0x02 version byte, a little-endian ``uint32`` header length, a
JSON header carrying a ``_cols`` manifest, then the raw little-endian
column payloads). A frame written by either package decodes alike in the
other, so a coordinator of one drives workers of the other.

``recv_msg`` returns ``None`` on a cleanly closed peer (EOF mid-header or
mid-body); socket timeouts propagate as ``socket.timeout``, so callers
bound every read. :class:`FrameDecoder` turns an arbitrary byte stream
(reads of any size, mid-frame included) back into messages. A length
prefix over ``MAX_FRAME`` and a malformed body raise ``ValueError``: the
caller closes the connection.

The service's columnar batch helpers are the reference's too: a batch
request as ``b_op``/``b_a``/``b_b`` columns, its reply as ``r_ok``/
``r_val`` plus a sparse error map, and ``primes`` replies as raw bitset
words or an int64 value column, whichever is smaller.
"""

from __future__ import annotations

import json
import socket
import struct

import numpy as np

# Upper bound on one frame: a peer that sends a garbage length prefix is
# cut off instead of being buffered for a body that never comes.
MAX_FRAME = 256 << 20

#: wire versions this build speaks: v1 JSON bodies, v2 adds columnar
#: frames. ``hello`` intersects the peers' sets and takes the max; without
#: a hello everything is v1.
WIRE_V1 = 1
WIRE_V2 = 2
SUPPORTED_WIRE = (WIRE_V1, WIRE_V2)

#: first body byte of a v2 frame; a JSON object opens with ``{`` (0x7b)
V2_MAGIC = 0x02

#: dtypes a v2 column may carry -> itemsize (a closed whitelist)
_V2_DTYPES = {"<u1": 1, "<u4": 4, "<i8": 8, "<f8": 8}

#: batch member opcodes for the ``b_op`` request column
OP_PI = 0
OP_IS_PRIME = 1
OP_COUNT = 2
OP_NAMES = ("pi", "is_prime", "count")

_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1


def encode_msg(msg: dict) -> bytes:
    """One complete wire frame (length prefix + JSON body)."""
    blob = json.dumps(msg).encode()
    return struct.pack(">Q", len(blob)) + blob


def _canon_dtype(arr: np.ndarray) -> str:
    """Little-endian dtype string for the manifest (``|u1`` -> ``<u1``)."""
    s = arr.dtype.str
    if s[0] == "|":
        s = "<" + s[1:]
    elif s[0] == ">":
        raise ValueError(f"big-endian column dtype {s!r} not encodable")
    if s not in _V2_DTYPES:
        raise ValueError(f"dtype {s!r} not in the v2 wire whitelist")
    return s


def encode_msg_v2(msg: dict, cols: dict[str, np.ndarray] | None) -> bytes:
    """One v2 wire frame: header JSON + packed little-endian columns.

    The header is ``msg`` plus a ``_cols`` manifest of ``[name, dtype,
    count]`` triples; the payloads follow in manifest order.
    ``cols=None`` (or empty) gives a plain JSON frame."""
    if not cols:
        return encode_msg(msg)
    entries = []
    payloads = []
    nbytes = 0
    for name, arr in cols.items():
        a = np.ascontiguousarray(arr)
        ds = _canon_dtype(a)
        entries.append([name, ds, int(a.size)])
        payloads.append(a.data)
        nbytes += a.size * _V2_DTYPES[ds]
    header = dict(msg)
    header["_cols"] = entries
    hblob = json.dumps(header).encode()
    length = 5 + len(hblob) + nbytes
    return b"".join(
        [struct.pack(">Q", length), bytes((V2_MAGIC,)),
         struct.pack("<I", len(hblob)), hblob, *payloads]
    )


def decode_body(blob: bytes) -> dict:
    """Decode one frame body, v1 JSON or v2 columnar, to a message.

    A v2 column lands in the dict as a read-only ``np.frombuffer`` view
    over ``blob``; the ``_cols`` manifest stays in the dict. Malformed
    structure raises ``ValueError``, as a non-JSON v1 body does."""
    if blob[:1] != b"\x02":
        return json.loads(blob)
    if len(blob) < 5:
        raise ValueError("v2 frame truncated before header length")
    (hlen,) = struct.unpack_from("<I", blob, 1)
    end = 5 + hlen
    if end > len(blob):
        raise ValueError(
            f"v2 header of {hlen} bytes overruns the {len(blob)}-byte frame"
        )
    msg = json.loads(blob[5:end])
    if not isinstance(msg, dict):
        raise ValueError("v2 header is not a JSON object")
    manifest = msg.get("_cols", [])
    if not isinstance(manifest, list):
        raise ValueError("v2 _cols manifest is not a list")
    off = end
    for ent in manifest:
        if (not isinstance(ent, list) or len(ent) != 3
                or not isinstance(ent[0], str)):
            raise ValueError(f"malformed v2 column entry {ent!r}")
        name, ds, count = ent
        isize = _V2_DTYPES.get(ds)
        if isize is None:
            raise ValueError(f"v2 column {name!r} has unknown dtype {ds!r}")
        if not isinstance(count, int) or isinstance(count, bool) or count < 0:
            raise ValueError(f"v2 column {name!r} has bad count {count!r}")
        size = count * isize
        if off + size > len(blob):
            raise ValueError(
                f"v2 column {name!r} ({size} bytes at {off}) overruns "
                f"the {len(blob)}-byte frame"
            )
        msg[name] = np.frombuffer(blob, dtype=ds, count=count, offset=off)
        off += size
    if off != len(blob):
        raise ValueError(
            f"v2 frame has {len(blob) - off} trailing bytes past its columns"
        )
    return msg


def send_msg(sock: socket.socket, msg: dict) -> None:
    sock.sendall(encode_msg(msg))


class FrameDecoder:
    """Incremental frame decoder: feed it whatever ``recv`` returned and
    it yields every complete message, keeping the undecoded tail."""

    __slots__ = ("_buf", "_max_frame")

    def __init__(self, max_frame: int = MAX_FRAME):
        self._buf = bytearray()
        self._max_frame = max_frame

    def feed(self, data: bytes) -> list[dict]:
        self._buf += data
        out: list[dict] = []
        while True:
            if len(self._buf) < 8:
                return out
            (length,) = struct.unpack(">Q", bytes(self._buf[:8]))
            if length > self._max_frame:
                raise ValueError(
                    f"frame of {length} bytes exceeds MAX_FRAME "
                    f"({self._max_frame})"
                )
            if len(self._buf) < 8 + length:
                return out
            blob = bytes(self._buf[8:8 + length])
            del self._buf[:8 + length]
            out.append(decode_body(blob))

    def buffered(self) -> int:
        """Bytes waiting for the rest of their frame."""
        return len(self._buf)


def recv_msg(sock: socket.socket) -> dict | None:
    header = _recv_exact(sock, 8)
    if header is None:
        return None
    (length,) = struct.unpack(">Q", header)
    blob = _recv_exact(sock, length)
    if blob is None:
        return None
    return decode_body(blob)


def _recv_exact(sock: socket.socket, n: int) -> bytes | None:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def parse_addr(addr: str) -> tuple[str, int]:
    host, port = addr.rsplit(":", 1)
    return host, int(port)


# --- columnar batch encoding -------------------------------------------------
#
# A batch request becomes three parallel columns instead of a list of
# member dicts: ``b_op`` (uint8 opcode), ``b_a`` (int64: x, or lo for
# count) and ``b_b`` (int64: hi for count, 0 otherwise). The reply is
# ``r_ok`` (uint8) + ``r_val`` (int64) columns plus a *sparse* JSON
# ``errors`` map {member index -> typed outcome dict} in the header, so
# the all-ok hot path never serializes a single per-member dict.

_PI_KEYS = frozenset(("op", "x"))
_COUNT_KEYS = frozenset(("op", "lo", "hi", "kind"))


def _wire_int(v) -> bool:
    return type(v) is int and _I64_MIN <= v <= _I64_MAX


def batch_items_to_cols(items) -> tuple[dict[str, np.ndarray], list] | None:
    """``(cols, member ops)`` for a columnar-eligible batch, else None.

    Eligible means every member is a well-formed ``pi``/``is_prime``/
    ``count`` dict with int64-range arguments; anything else (unknown
    ops, malformed members, huge ints) returns None and the caller
    ships the batch as v1 JSON, where the server's existing per-member
    validation produces the typed outcome.
    """
    if not items:
        return None
    # plain lists + one bulk np.array at the end: per-element ndarray
    # stores cost ~4x this loop on the 1024-member hot path
    b_op: list[int] = []
    b_a: list[int] = []
    b_b: list[int] = []
    ops: list = []
    for m in items:
        if type(m) is not dict:
            return None
        op = m.get("op")
        if op == "pi" or op == "is_prime":
            x = m.get("x")
            # key-set discipline without issuperset: op and x checked
            # out, so len(m) == 2 means keys are exactly {op, x}
            if (type(x) is not int or x > _I64_MAX or x < _I64_MIN
                    or len(m) != 2):
                return None
            b_op.append(OP_PI if op == "pi" else OP_IS_PRIME)
            b_a.append(x)
            b_b.append(0)
        elif op == "count":
            lo, hi = m.get("lo"), m.get("hi")
            if (type(lo) is not int or lo > _I64_MAX or lo < _I64_MIN
                    or type(hi) is not int or hi > _I64_MAX
                    or hi < _I64_MIN
                    or m.get("kind", "primes") != "primes"
                    or len(m) != (4 if "kind" in m else 3)):
                return None
            b_op.append(OP_COUNT)
            b_a.append(lo)
            b_b.append(hi)
        else:
            return None
        ops.append(op)
    return {"b_op": np.array(b_op, dtype=np.uint8),
            "b_a": np.array(b_a, dtype=np.int64),
            "b_b": np.array(b_b, dtype=np.int64)}, ops


def batch_cols_to_items(b_op, b_a, b_b) -> list[dict]:
    """Rebuild v1 member dicts from request columns (the fallback path)."""
    items: list[dict] = []
    for o, x, y in zip(b_op.tolist(), b_a.tolist(), b_b.tolist()):
        if o == OP_PI:
            items.append({"op": "pi", "x": x})
        elif o == OP_IS_PRIME:
            items.append({"op": "is_prime", "x": x})
        elif o == OP_COUNT:
            items.append({"op": "count", "lo": x, "hi": y})
        else:
            # unknown opcode -> an op name no handler knows, so the
            # member gets the ordinary typed bad_request outcome
            items.append({"op": f"opcode_{o}"})
    return items


class BatchOutcomes:
    """Columnar batch result: ok flags + int64 values + sparse errors.

    The server's vectorized fast path builds one directly; the fallback
    and router paths convert a list of outcome dicts via
    :meth:`from_items`. ``wire()`` yields the v2 header fields and
    columns; ``to_items()`` rebuilds the v1 outcome list for JSON
    connections. ``ops`` is per-member op names (or a ``b_op`` opcode
    array), needed only to rebuild dicts — the wire never carries it,
    the client remembers what it asked.
    """

    __slots__ = ("ok", "val", "errors", "ops")

    def __init__(self, ok, val, errors, ops):
        self.ok = ok
        self.val = val
        self.errors = errors
        self.ops = ops

    @classmethod
    def from_items(cls, outcomes: list[dict]) -> "BatchOutcomes":
        n = len(outcomes)
        ok = np.zeros(n, dtype=np.uint8)
        val = np.zeros(n, dtype=np.int64)
        errors: dict[str, dict] = {}
        ops: list = []
        for i, o in enumerate(outcomes):
            ops.append(o.get("op"))
            if o.get("ok"):
                ok[i] = 1
                val[i] = int(o.get("value") or 0)
            else:
                errors[str(i)] = o
        return cls(ok, val, errors, ops)

    def _op_names(self) -> list:
        if isinstance(self.ops, np.ndarray):
            return [OP_NAMES[c] if c < len(OP_NAMES) else f"opcode_{c}"
                    for c in self.ops.tolist()]
        return list(self.ops)

    def wire(self) -> tuple[dict, dict[str, np.ndarray]]:
        """(extra header fields, columns) for a v2 reply."""
        extra = {"vkind": "batch"}
        if self.errors:
            extra["errors"] = self.errors
        return extra, {"r_ok": self.ok, "r_val": self.val}

    def to_items(self) -> list[dict]:
        names = self._op_names()
        out: list[dict] = []
        for i, (okf, v) in enumerate(zip(self.ok.tolist(), self.val.tolist())):
            err = self.errors.get(str(i))
            if err is not None:
                out.append(err)
                continue
            op = names[i]
            out.append({"ok": True, "op": op,
                        "value": bool(v) if op == "is_prime" else v})
        return out


def batch_reply_value(reply: dict, ops: list | None) -> list[dict]:
    """Rebuild the v1 outcome list from a v2 batch reply, in place.

    Pops the reply's column keys; ``ops`` is the member op list the
    client recorded at send time (the wire does not repeat it).
    """
    ok = reply.pop("r_ok")
    val = reply.pop("r_val")
    errors = reply.pop("errors", None) or {}
    if ops is None:
        ops = ["?"] * ok.size
    if not errors:
        # all-ok hot path: no per-index error lookups
        return [{"ok": True, "op": op,
                 "value": bool(v) if op == "is_prime" else v}
                for op, v in zip(ops, val.tolist())]
    out: list[dict] = []
    for i, (op, v) in enumerate(zip(ops, val.tolist())):
        err = errors.get(str(i))
        if err is not None:
            out.append(err)
        else:
            out.append({"ok": True, "op": op,
                        "value": bool(v) if op == "is_prime" else v})
    return out


# --- binary primes replies ---------------------------------------------------
#
# A hot ``primes`` window is dense: shipping it as the wheel layout's
# raw bitset words (one ``p_words`` uint32 column) beats both JSON and
# an int64 value column by ~30x. The header carries the layout name and
# the effective window so the client can reconstruct values locally;
# sparse windows (few primes over a wide range) flip to an int64
# ``p_vals`` column when that is smaller.


def primes_to_cols(vals: np.ndarray, packing: str,
                   lo: int, hi: int) -> tuple[dict, dict[str, np.ndarray]]:
    """(extra header fields, columns) for a v2 ``primes`` reply."""
    from sieve_torch.bitset import get_layout, pack_words

    lo = max(int(lo), 2)
    hi = int(hi)
    layout = get_layout(packing)
    nbits = layout.nbits(lo, hi) if hi > lo else 0
    words_bytes = 4 * ((nbits + 31) // 32)
    vals = np.ascontiguousarray(vals, dtype=np.int64)
    if nbits and words_bytes < 8 * vals.size:
        cand = vals
        if layout.extra_primes:
            cand = vals[vals >= layout.first_candidate(2)]
        flags = np.zeros(nbits, dtype=bool)
        if cand.size:
            base_g = layout.gidx(layout.first_candidate(lo))
            flags[layout.gidx_np(cand) - base_g] = True
        return ({"vkind": "primes", "prepr": "bitset", "packing": packing,
                 "plo": lo, "phi": hi, "pnbits": nbits},
                {"p_words": pack_words(flags)})
    return ({"vkind": "primes", "prepr": "values"}, {"p_vals": vals})


def primes_reply_value(reply: dict, as_array: bool = False):
    """Rebuild the v1 ``primes`` value from a v2 reply, in place.

    Returns a plain int list by default; ``as_array=True`` keeps the
    decoded int64 array (the router's shard legs pass it through to
    their own reply encode without ever touching Python ints).
    """
    from sieve_torch.bitset import get_layout, unpack_words

    if reply.pop("prepr", None) == "bitset":
        words = reply.pop("p_words")
        layout = get_layout(reply.pop("packing"))
        lo = reply.pop("plo")
        hi = reply.pop("phi")
        nbits = reply.pop("pnbits")
        flags = unpack_words(np.ascontiguousarray(words, dtype=np.uint32),
                             nbits)
        vals = layout.values_np(lo, np.nonzero(flags)[0])
        extras = [p for p in layout.extra_primes if lo <= p < hi]
        if as_array:
            if extras:
                vals = np.concatenate(
                    (np.asarray(extras, dtype=np.int64),
                     vals.astype(np.int64, copy=False))
                )
            return vals.astype(np.int64, copy=False)
        return extras + vals.tolist()
    vals = reply.pop("p_vals")
    return vals if as_array else vals.tolist()
