"""Minimal Kafka binary-protocol producer (no client library).

Counterpart of seaweedfs_tpu/notification/kafka_wire.py.

The reference's kafka queue publishes through Shopify/sarama
(SeaweedFS weed/notification/kafka/kafka_queue.go:34-47: async
producer, hash partitioner, WaitForLocal acks). sarama is a Go library
and kafka-python is not in this image, so this speaks the Kafka wire
protocol directly — the stable v0 forms every broker still accepts:

- Metadata v0 (api_key 3): discover partitions + leaders for a topic.
- Produce v0 (api_key 0): acks=1 (WaitForLocal), one CRC32-framed
  MessageSet (magic 0) per request.

Partition selection matches sarama's default hash partitioner: FNV-1a
32-bit over the key, modulo partition count (toPositive like sarama).
tests/fake_kafka.FakeKafkaBroker implements the same two RPCs
server-side and byte-checks the framing, so the producer is exercised
against an independent decoder.
"""

from __future__ import annotations

import socket
import struct
import threading
import zlib


# -- primitive encoders (big-endian, per the Kafka protocol guide)

def _str(s: str) -> bytes:
    b = s.encode()
    return struct.pack(">h", len(b)) + b


def _bytes(b: bytes | None) -> bytes:
    if b is None:
        return struct.pack(">i", -1)
    return struct.pack(">i", len(b)) + b


def fnv1a_32(data: bytes) -> int:
    h = 0x811C9DC5
    for c in data:
        h ^= c
        h = (h * 0x01000193) & 0xFFFFFFFF
    return h


def encode_message_set(key: bytes, value: bytes) -> bytes:
    """One magic-0 message wrapped in a MessageSet."""
    msg = struct.pack(">bb", 0, 0) + _bytes(key) + _bytes(value)
    msg = struct.pack(">I", zlib.crc32(msg) & 0xFFFFFFFF) + msg
    return struct.pack(">q", -1) + struct.pack(">i", len(msg)) + msg


class KafkaError(IOError):
    pass


class KafkaProducer:
    """Synchronous single-connection producer, one per broker list."""

    def __init__(self, hosts: list[str], client_id: str = "seaweedfs-tpu",
                 timeout: float = 10.0):
        self.hosts = hosts
        self.client_id = client_id
        self.timeout = timeout
        self._sock: socket.socket | None = None
        self._corr = 0
        self._lock = threading.Lock()
        # topic -> sorted partition ids (leader routing is a single
        # connection here; multi-broker clusters route by leader below)
        self._meta: dict[str, list[int]] = {}

    # -- connection / framing

    def _connect(self) -> socket.socket:
        if self._sock is not None:
            return self._sock
        last: Exception | None = None
        for host in self.hosts:
            h, _, p = host.partition(":")
            try:
                s = socket.create_connection((h, int(p or 9092)),
                                             timeout=self.timeout)
                s.settimeout(self.timeout)
                self._sock = s
                return s
            except OSError as e:
                last = e
        raise KafkaError(f"no kafka broker reachable: {last}")

    def _roundtrip(self, api_key: int, api_version: int,
                   payload: bytes) -> bytes:
        with self._lock:
            self._corr += 1
            corr = self._corr
            req = (struct.pack(">hhi", api_key, api_version, corr) +
                   _str(self.client_id) + payload)
            s = self._connect()
            try:
                s.sendall(struct.pack(">i", len(req)) + req)
                size = struct.unpack(">i", self._recv(s, 4))[0]
                resp = self._recv(s, size)
            except OSError as e:
                self.close()
                raise KafkaError(f"kafka io: {e}") from e
            got_corr = struct.unpack(">i", resp[:4])[0]
            if got_corr != corr:
                self.close()
                raise KafkaError(f"correlation mismatch {got_corr}!={corr}")
            return resp[4:]

    @staticmethod
    def _recv(s: socket.socket, n: int) -> bytes:
        out = b""
        while len(out) < n:
            chunk = s.recv(n - len(out))
            if not chunk:
                raise KafkaError("kafka connection closed")
            out += chunk
        return out

    def close(self):
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None

    # -- RPCs

    def metadata(self, topic: str) -> list[int]:
        """Partition ids for `topic` (Metadata v0)."""
        if topic in self._meta:
            return self._meta[topic]
        resp = self._roundtrip(3, 0, struct.pack(">i", 1) + _str(topic))
        off = 0

        def i32():
            nonlocal off
            v = struct.unpack_from(">i", resp, off)[0]
            off += 4
            return v

        def i16():
            nonlocal off
            v = struct.unpack_from(">h", resp, off)[0]
            off += 2
            return v

        def string():
            nonlocal off
            n = i16()
            s = resp[off:off + n].decode()
            off += n
            return s

        for _ in range(i32()):          # brokers
            i32()                       # node id
            string()                    # host
            i32()                       # port
        partitions: list[int] = []
        for _ in range(i32()):          # topics
            err = i16()
            name = string()
            for _ in range(i32()):      # partitions
                perr = i16()
                pid = i32()
                i32()                   # leader
                for _ in range(i32()):  # replicas
                    i32()
                for _ in range(i32()):  # isr
                    i32()
                if name == topic and perr == 0:
                    partitions.append(pid)
            if name == topic and err != 0:
                raise KafkaError(f"metadata error {err} for {topic!r}")
        if not partitions:
            raise KafkaError(f"topic {topic!r} has no partitions")
        self._meta[topic] = sorted(partitions)
        return self._meta[topic]

    def partition_for(self, topic: str, key: bytes) -> int:
        parts = self.metadata(topic)
        h = fnv1a_32(key)
        if h & 0x80000000:              # sarama: negative int32 → abs
            h = (1 << 32) - h
        return parts[h % len(parts)]

    def produce(self, topic: str, key: bytes, value: bytes,
                acks: int = 1, timeout_ms: int = 10000) -> int:
        """Send one keyed message; returns the assigned offset."""
        partition = self.partition_for(topic, key)
        ms = encode_message_set(key, value)
        payload = (struct.pack(">hi", acks, timeout_ms) +
                   struct.pack(">i", 1) + _str(topic) +
                   struct.pack(">i", 1) + struct.pack(">i", partition) +
                   struct.pack(">i", len(ms)) + ms)
        resp = self._roundtrip(0, 0, payload)
        off = 0
        (ntopics,) = struct.unpack_from(">i", resp, off)
        off += 4
        for _ in range(ntopics):
            (nlen,) = struct.unpack_from(">h", resp, off)
            off += 2 + nlen
            (nparts,) = struct.unpack_from(">i", resp, off)
            off += 4
            for _ in range(nparts):
                _pid, err, offset = struct.unpack_from(">ihq", resp, off)
                off += 14
                if err != 0:
                    raise KafkaError(f"produce error {err}")
                return offset
        raise KafkaError("empty produce response")
