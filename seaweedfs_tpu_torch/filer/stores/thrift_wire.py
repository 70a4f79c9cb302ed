"""Minimal Apache Thrift binary-protocol client (TBinaryProtocol,
strict framing) over a plain socket.

Supports exactly what the hbase filer store needs to drive HBase's
Thrift2 gateway (THBaseService): CALL/REPLY messages, struct/list/
string/i32/i64/bool field encoding, and declared-exception decoding.
No thrift library is used; the encoding below follows the
public Thrift binary protocol spec (thrift.apache.org,
TBinaryProtocol.java): strict messages lead with
``0x8001`` | version, fields are ``(type:i8, id:i16, value)`` ending in
a 0x00 stop byte.

Value model: python values are encoded by explicit (type, value) pairs
so field ids/types stay visible at call sites — a deliberate mirror of
the IDL, auditable against hbase's ``hbase.thrift``.
"""

from __future__ import annotations

import socket
import struct
import threading

VERSION_1 = 0x80010000
CALL, REPLY, EXCEPTION = 1, 2, 3

# thrift type ids (TType)
BOOL, BYTE, DOUBLE = 2, 3, 4
I16, I32, I64 = 6, 8, 10
STRING, STRUCT, MAP, SET, LIST = 11, 12, 13, 14, 15
STOP = 0


class ThriftError(IOError):
    """Server-side TApplicationException or declared IDL exception."""


class ThriftProtocolError(ThriftError):
    """Framing failure; the connection must be discarded."""


# -- encoding ---------------------------------------------------------------

def enc_value(ttype: int, v) -> bytes:
    if ttype == BOOL:
        return b"\x01" if v else b"\x00"
    if ttype == BYTE:
        return struct.pack(">b", v)
    if ttype == I16:
        return struct.pack(">h", v)
    if ttype == I32:
        return struct.pack(">i", v)
    if ttype == I64:
        return struct.pack(">q", v)
    if ttype == DOUBLE:
        return struct.pack(">d", v)
    if ttype == STRING:
        b = v if isinstance(v, bytes) else str(v).encode()
        return struct.pack(">i", len(b)) + b
    if ttype == STRUCT:
        return enc_struct(v)
    if ttype == LIST:
        etype, elems = v
        return (struct.pack(">bi", etype, len(elems))
                + b"".join(enc_value(etype, e) for e in elems))
    if ttype == MAP:
        ktype, vtype, pairs = v
        return (struct.pack(">bbi", ktype, vtype, len(pairs))
                + b"".join(enc_value(ktype, k) + enc_value(vtype, val)
                           for k, val in pairs))
    raise ValueError(f"unsupported thrift type {ttype}")


def enc_struct(fields: list[tuple[int, int, object]]) -> bytes:
    """fields: [(field_id, ttype, value), ...] -> struct bytes."""
    out = []
    for fid, ttype, v in fields:
        out.append(struct.pack(">bh", ttype, fid))
        out.append(enc_value(ttype, v))
    out.append(b"\x00")
    return b"".join(out)


# -- decoding ---------------------------------------------------------------

class Reader:
    def __init__(self, f):
        self.f = f

    def read(self, n: int) -> bytes:
        b = self.f.read(n)
        if len(b) != n:
            raise ThriftProtocolError("connection closed mid-message")
        return b

    def i8(self) -> int:
        return struct.unpack(">b", self.read(1))[0]

    def i16(self) -> int:
        return struct.unpack(">h", self.read(2))[0]

    def i32(self) -> int:
        return struct.unpack(">i", self.read(4))[0]

    def i64(self) -> int:
        return struct.unpack(">q", self.read(8))[0]

    def binary(self) -> bytes:
        return self.read(self.i32())

    def value(self, ttype: int):
        if ttype == BOOL:
            return self.read(1) != b"\x00"
        if ttype == BYTE:
            return self.i8()
        if ttype == DOUBLE:
            return struct.unpack(">d", self.read(8))[0]
        if ttype == I16:
            return self.i16()
        if ttype == I32:
            return self.i32()
        if ttype == I64:
            return self.i64()
        if ttype == STRING:
            return self.binary()
        if ttype == STRUCT:
            return self.struct()
        if ttype in (LIST, SET):
            etype = self.i8()
            return [self.value(etype) for _ in range(self.i32())]
        if ttype == MAP:
            ktype, vtype = self.i8(), self.i8()
            return [(self.value(ktype), self.value(vtype))
                    for _ in range(self.i32())]
        raise ThriftProtocolError(f"unsupported thrift type {ttype}")

    def struct(self) -> dict[int, object]:
        """-> {field_id: value}; nested structs are dicts too."""
        fields: dict[int, object] = {}
        while True:
            ttype = self.i8()
            if ttype == STOP:
                return fields
            fid = self.i16()
            fields[fid] = self.value(ttype)


# -- client -----------------------------------------------------------------

class ThriftClient:
    """One-connection strict-binary-protocol client; call() is
    lock-serialized like the RESP/pg wire clients in this package."""

    def __init__(self, host: str, port: int, *, timeout: float = 30):
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._f = self._sock.makefile("rb")
        self._lock = threading.Lock()
        self._seq = 0

    def close(self) -> None:
        try:
            self._f.close()
            if self._sock is not None:  # call() Nones it after poisoning
                self._sock.close()
        except OSError:
            pass

    def call(self, method: str, args: list[tuple[int, int, object]]
             ) -> dict[int, object]:
        """-> the REPLY struct ({0: success, or exception fields}).
        Raises ThriftError on EXCEPTION messages or declared-exception
        reply fields; any framing failure poisons the connection."""
        name = method.encode()
        msg = (struct.pack(">I", VERSION_1 | CALL)
               + struct.pack(">i", len(name)) + name)
        with self._lock:
            if self._sock is None:
                raise ThriftProtocolError(
                    "connection is closed (previous I/O error)")
            self._seq += 1
            try:
                self._sock.sendall(msg + struct.pack(">i", self._seq)
                                   + enc_struct(args))
                r = Reader(self._f)
                head = r.i32() & 0xFFFFFFFF  # strict header, unsigned view
                if head & 0xFFFF0000 != VERSION_1:
                    raise ThriftProtocolError(
                        f"bad thrift version 0x{head:x}")
                mtype = head & 0xFF
                rname = r.binary()
                seq = r.i32()
                if seq != self._seq or rname != name:
                    raise ThriftProtocolError(
                        f"reply mismatch: {rname!r} seq {seq}")
                reply = r.struct()
            except ThriftProtocolError:
                self.close()
                self._sock = None
                raise
            except OSError:
                self.close()
                self._sock = None
                raise
            if mtype == EXCEPTION:
                # TApplicationException {1: message, 2: type}
                msg = reply.get(1, b"?")
                raise ThriftError(msg.decode("utf-8", "replace")
                                  if isinstance(msg, bytes) else str(msg))
            for fid, v in reply.items():
                if fid != 0 and isinstance(v, dict):
                    # declared exception (TIOError {1: message})
                    raise ThriftError(
                        v.get(1, b"server exception").decode("utf-8",
                                                             "replace")
                        if isinstance(v.get(1), bytes) else str(v))
            return reply
