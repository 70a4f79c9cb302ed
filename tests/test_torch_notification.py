"""The port's notification queues against the JAX package's, on the CPU.

The registry and `load_configuration`, the in-process `MemoryQueue`, and
the three wire queues, each against an in-repo fake that decodes the
wire independently: Kafka (tests/fake_kafka.py: Metadata v0, Produce v0,
the MessageSet CRC recomputed), SQS and Pub/Sub (tests/fake_cloud.py).
The same seeded events go through both packages' queues, each into a
fake of its own, and what the fakes received is compared with tolerance
0: Kafka's (partition, key, value) bytes, SQS's form fields, Pub/Sub's
messages.

Then the filer's publisher: each package's filer starts in a directory
whose notification.toml enables `kafka` at a fake broker, one seeded
script of gRPC creates, updates, renames and deletes runs through it, and
the (partition, key, value) bytes each broker holds are compared. Both
packages' entry, filer and server clocks are pinned to one fake clock
and the metadata log flushes only at close, so the events' timestamps
and signatures are the same bytes too. `fs.meta.notify` through both
packages' shells on one filer publishes the same bytes. Where the
reference is at fault (ROADMAP.md C), a test shows both answers: a
queue that cannot initialize starts the reference's filer without a
publisher and stops the port's."""

import base64
import io
import os
import random
import socket
import time

import numpy as np
import pytest

from seaweedfs_tpu import notification as ref_notification
from seaweedfs_tpu.filer import entry as ref_entry
from seaweedfs_tpu.filer import filer as ref_filer_core
from seaweedfs_tpu.filer import meta_log as ref_meta_log
from seaweedfs_tpu.notification import kafka_wire as ref_kafka_wire
from seaweedfs_tpu.pb import filer_pb2 as ref_filer_pb2
from seaweedfs_tpu.pb import rpc as ref_rpc
from seaweedfs_tpu.server import filer as ref_filer_server
from seaweedfs_tpu.shell.env import CommandEnv as RefEnv
from seaweedfs_tpu.shell.registry import run_command as ref_run_command
from seaweedfs_tpu_torch import command, notification
from seaweedfs_tpu_torch.filer import entry as port_entry
from seaweedfs_tpu_torch.filer import filer as filer_core
from seaweedfs_tpu_torch.filer import meta_log
from seaweedfs_tpu_torch.notification import kafka_wire
from seaweedfs_tpu_torch.pb import filer_pb2, rpc
from seaweedfs_tpu_torch.server import filer as filer_server
from seaweedfs_tpu_torch.shell.env import CommandEnv
from seaweedfs_tpu_torch.shell.registry import run_command

from .fake_cloud import FakePubSub, FakeSqs
from .fake_kafka import FakeKafkaBroker
from tests import torch_ports

PKGS = {
    "ref": dict(notification=ref_notification, kafka_wire=ref_kafka_wire,
                pb=ref_filer_pb2, rpc=ref_rpc,
                Filer=ref_filer_server.FilerServer, Env=RefEnv,
                run=ref_run_command),
    "port": dict(notification=notification, kafka_wire=kafka_wire,
                 pb=filer_pb2, rpc=rpc, Filer=filer_server.FilerServer,
                 Env=CommandEnv, run=run_command),
}

_PORTS = random.Random(os.getpid() + 53)
_RESERVED = {p + d for p in (8888, 9333, 8080) for d in (0, 10000, 11000)}


def _free_port_pair() -> int:
    """A free HTTP port whose +10000 twin is free too, below the kernel's
    ephemeral range."""
    for _ in range(400):
        port = torch_ports.draw(_PORTS, 12000, 21000)
        if {port, port + 10000, port + 11000} & _RESERVED:
            continue
        try:
            for p in (port, port + 10000):
                with socket.socket() as s:
                    s.bind(("", p))
        except OSError:
            continue
        return port
    raise RuntimeError("no free port pair")


def _events(pb, seed: int, n: int = 40) -> list:
    """(key, EventNotification) pairs from a seeded generator."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        ev = pb.EventNotification()
        name = f"f{int(rng.integers(0, 1 << 20)):06x}"
        ev.new_entry.name = name
        ev.new_entry.attributes.file_size = int(rng.integers(0, 1 << 30))
        ev.new_entry.content = rng.integers(
            0, 256, int(rng.integers(0, 300)), dtype=np.uint8).tobytes()
        if i % 3 == 0:
            ev.old_entry.name = f"old{i}"
            ev.delete_chunks = True
        out.append((f"/d{int(rng.integers(0, 6))}/{name}", ev))
    return out


# -- the registry and the in-process queue -------------------------------------


def test_the_registry_and_load_configuration_like_the_reference():
    for name, k in PKGS.items():
        n = k["notification"]
        assert sorted(n.QUEUES) == sorted(ref_notification.QUEUES), name
        q = n.load_configuration(
            {"notification": {"memory": {"enabled": True}}})
        assert isinstance(q, n.MemoryQueue)
        assert n.current_queue() is q
        assert n.load_configuration({"notification": {}}) is None
        assert n.load_configuration({"log": {"enabled": False}}) is None
        with pytest.raises(KeyError):
            n.load_configuration({"notification": {"nope": {
                "enabled": True}}})
        with pytest.raises(RuntimeError):
            n.QUEUES["gocdk_pub_sub"].initialize({})
        n.set_active(None)
        assert n.current_queue() is None
        assert n.current_queue("log") is n.QUEUES["log"]


def test_the_memory_queue_keeps_what_the_reference_keeps():
    drained = {}
    for name, k in PKGS.items():
        q = k["notification"].MemoryQueue(capacity=25)
        for key, ev in _events(k["pb"], 5):
            q.send_message(key, ev)
        got = q.drain()
        drained[name] = [(key, ev.SerializeToString()) for key, ev in got]
        assert q.drain() == []
        assert len(got) == 25
    assert drained["port"] == drained["ref"]


# -- Kafka ---------------------------------------------------------------------


@pytest.mark.parametrize("data", [b"", b"a", b"/d1/f00ab12", bytes(range(256))])
def test_kafka_framing_and_partitioning_like_the_reference(data):
    assert kafka_wire.fnv1a_32(data) == ref_kafka_wire.fnv1a_32(data)
    assert kafka_wire.encode_message_set(data, data[::-1]) == \
        ref_kafka_wire.encode_message_set(data, data[::-1])


def _through_kafka(k, seed: int, partitions: int = 4) -> dict:
    broker = FakeKafkaBroker(topic="swfs", partitions=partitions)
    try:
        q = k["notification"].KafkaQueue()
        q.initialize({"hosts": [broker.addr], "topic": "swfs"})
        for key, ev in _events(k["pb"], seed):
            q.send_message(key, ev)
        q._producer.close()
        assert broker.crc_failures == 0
        return {pid: list(m) for pid, m in broker.messages.items()}
    finally:
        broker.close()


@pytest.mark.parametrize("seed", [1, 2])
def test_kafka_sends_the_references_bytes_to_its_partitions(seed):
    got = {name: _through_kafka(k, seed) for name, k in PKGS.items()}
    assert got["port"] == got["ref"]
    assert sum(len(m) for m in got["port"].values()) == 40
    assert len([p for p, m in got["port"].items() if m]) > 1
    # the value is the serialized event
    key, value = next(m for m in got["port"].values() if m)[0]
    ev = filer_pb2.EventNotification.FromString(value)
    assert key.decode().endswith("/" + ev.new_entry.name)


def test_kafka_sends_one_key_to_one_partition():
    broker = FakeKafkaBroker(topic="t", partitions=4)
    try:
        q = notification.KafkaQueue()
        q.initialize({"hosts": [broker.addr], "topic": "t"})
        for i in range(5):
            ev = filer_pb2.EventNotification()
            ev.new_entry.name = f"v{i}"
            q.send_message("/same/key", ev)
        used = [pid for pid, msgs in broker.messages.items() if msgs]
        assert len(used) == 1 and len(broker.messages[used[0]]) == 5
        want = kafka_wire.fnv1a_32(b"/same/key")
        want = (1 << 32) - want if want & 0x80000000 else want
        assert used == [want % 4]
    finally:
        broker.close()


def test_an_unreachable_broker_fails_fast():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead = f"127.0.0.1:{s.getsockname()[1]}"
    for name, k in PKGS.items():
        q = k["notification"].KafkaQueue()
        t0 = time.perf_counter()
        with pytest.raises(IOError):
            q.initialize({"hosts": [dead], "topic": "t"})
        assert time.perf_counter() - t0 < 5, name


# -- SQS and Pub/Sub -----------------------------------------------------------


def test_sqs_sends_what_the_reference_sends():
    sent = {}
    for name, k in PKGS.items():
        srv = FakeSqs(queue="events")
        try:
            q = k["notification"].AwsSqsQueue()
            q.initialize({"aws_access_key_id": "AK",
                          "aws_secret_access_key": "SK",
                          "region": "us-east-1", "sqs_queue_name": "events",
                          "endpoint": srv.endpoint})
            assert q.queue_url == f"{srv.endpoint}/123/events"
            for key, ev in _events(k["pb"], 9, 8):
                q.send_message(key, ev)
            assert srv.bad_auth == 0  # every call carried a SigV4 signature
            sent[name] = [{f: v for f, v in m.items() if f != "QueueUrl"}
                          for m in srv.messages]
            body = filer_pb2.EventNotification.FromString(
                base64.b64decode(srv.messages[0]["MessageBody"]))
            assert body.new_entry.name
        finally:
            srv.close()
    assert sent["port"] == sent["ref"] and len(sent["port"]) == 8


def test_sqs_refuses_a_queue_that_does_not_exist():
    srv = FakeSqs(queue="exists")
    try:
        for name, k in PKGS.items():
            with pytest.raises(RuntimeError):
                k["notification"].AwsSqsQueue().initialize({
                    "aws_access_key_id": "AK",
                    "aws_secret_access_key": "SK",
                    "sqs_queue_name": "missing", "endpoint": srv.endpoint})
    finally:
        srv.close()


def test_pub_sub_publishes_what_the_reference_publishes():
    sent = {}
    for name, k in PKGS.items():
        srv = FakePubSub(project="proj", topic="events")
        try:
            q = k["notification"].GooglePubSubQueue()
            q.initialize({"project_id": "proj", "topic": "events",
                          "endpoint": srv.endpoint, "token": "tok"})
            # the topic is created once, then found
            k["notification"].GooglePubSubQueue().initialize({
                "project_id": "proj", "topic": "events",
                "endpoint": srv.endpoint, "token": "tok"})
            for key, ev in _events(k["pb"], 11, 8):
                q.send_message(key, ev)
            sent[name] = (list(srv.created_topics), list(srv.messages))
        finally:
            srv.close()
    assert sent["port"] == sent["ref"]
    assert len(sent["port"][0]) == 1 and len(sent["port"][1]) == 8


# -- the filer's publisher -----------------------------------------------------


class Clock:
    """A stand-in for the `time` module the entry and filer modules
    read: every call moves it on by one microsecond."""

    def __init__(self):
        self.ns = 1_700_000_000_000_000_000

    def time_ns(self) -> int:
        self.ns += 1000
        return self.ns

    def time(self) -> float:
        return self.time_ns() / 1e9

    def __getattr__(self, name):
        return getattr(time, name)


def _kafka_toml(path, broker) -> None:
    path.write_text(f'[notification.kafka]\nenabled = true\n'
                    f'hosts = ["{broker.addr}"]\ntopic = "{broker.topic}"\n')


def _filer_script(stub, pb) -> None:
    """Creates, updates, renames and deletes through the filer's gRPC."""
    rng = np.random.default_rng(3)

    def entry(name, directory=False, size=0):
        e = pb.Entry(name=name, is_directory=directory)
        e.attributes.mtime = e.attributes.crtime = 1_700_000_000
        e.attributes.file_mode = 0o755 if directory else 0o644
        if not directory:
            e.content = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
            e.attributes.file_size = size
        return e

    stub.CreateEntry(pb.CreateEntryRequest(
        directory="/", entry=entry("pub", True)), timeout=10)
    for i in range(12):
        stub.CreateEntry(pb.CreateEntryRequest(
            directory=f"/pub/d{i % 3}", entry=entry(
                f"f{i:02d}", size=int(rng.integers(1, 900)))), timeout=10)
    e = stub.LookupDirectoryEntry(pb.LookupDirectoryEntryRequest(
        directory="/pub/d1", name="f04"), timeout=10).entry
    e.attributes.mime = "text/plain"
    stub.UpdateEntry(pb.UpdateEntryRequest(directory="/pub/d1", entry=e),
                     timeout=10)
    stub.AtomicRenameEntry(pb.AtomicRenameEntryRequest(
        old_directory="/pub/d0", old_name="f03", new_directory="/pub/d2",
        new_name="moved"), timeout=10)
    stub.DeleteEntry(pb.DeleteEntryRequest(
        directory="/pub/d1", name="f07", is_delete_data=True), timeout=10)
    stub.DeleteEntry(pb.DeleteEntryRequest(
        directory="/pub", name="d0", is_delete_data=True,
        is_recursive=True), timeout=10)


def _started(k, port: int):
    fs = k["Filer"](ip="127.0.0.1", port=port, master="127.0.0.1:1",
                    store="memory")
    fs.start()
    return fs


def _stopped(fs) -> None:
    fs.stop()
    fs._http_server.server_close()
    fs._grpc_server.stop(None).wait(10)
    for mod in (rpc, ref_rpc):
        mod.reset_channels()


def _published(name: str, tmp_path, port: int) -> dict:
    k = PKGS[name]
    broker = FakeKafkaBroker(topic="swfs-filer", partitions=3)
    d = tmp_path / name
    d.mkdir()
    _kafka_toml(d / "notification.toml", broker)
    fs = None
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.chdir(d)
            clock = Clock()
            for mod in (ref_entry, port_entry, ref_filer_core, filer_core,
                        ref_filer_server, filer_server):
                mp.setattr(mod, "time", clock)
            for mod in (ref_meta_log, meta_log):
                mp.setattr(mod.MetaLog, "_flush_loop",
                           lambda self: self._stop.wait())
            fs = _started(k, port)
            assert fs.filer.notification_queue is \
                k["notification"].QUEUES["kafka"]
            _filer_script(k["rpc"].filer_stub(f"127.0.0.1:{port + 10000}"),
                          k["pb"])
        return {pid: list(m) for pid, m in broker.messages.items()}
    finally:
        if fs is not None:
            _stopped(fs)
        k["notification"].set_active(None)
        broker.close()


def test_the_filer_publishes_the_references_bytes(tmp_path):
    port = _free_port_pair()
    got = {name: _published(name, tmp_path, port) for name in PKGS}
    assert got["port"] == got["ref"]
    msgs = [m for p in got["port"].values() for m in p]
    # one per call of the script: 13 creates, an update, a rename, two
    # deletes (the directories a create implies are made without events)
    assert len(msgs) == 17
    keys = {k.decode() for k, _ in msgs}
    assert {"/pub/d2/moved", "/pub/d1/f07", "/pub/d0"} <= keys
    renamed = [filer_pb2.EventNotification.FromString(v) for k, v in msgs
               if k == b"/pub/d2/moved"]
    assert renamed[0].old_entry.name == "f03"
    assert renamed[0].new_parent_path == "/pub/d2"


def test_a_publish_that_fails_does_not_fail_the_write(tmp_path,
                                                      monkeypatch):
    broker = FakeKafkaBroker(topic="swfs-filer", partitions=2)
    _kafka_toml(tmp_path / "notification.toml", broker)
    monkeypatch.chdir(tmp_path)
    port = _free_port_pair()
    fs = _started(PKGS["port"], port)
    try:
        broker.close()
        fs.filer.notification_queue._producer.close()
        stub = rpc.filer_stub(f"127.0.0.1:{port + 10000}")
        e = filer_pb2.Entry(name="x", content=b"abc")
        stub.CreateEntry(filer_pb2.CreateEntryRequest(directory="/w",
                                                      entry=e), timeout=10)
        assert fs.filer.find_entry("/w/x").content == b"abc"
    finally:
        _stopped(fs)
        notification.set_active(None)


def test_a_queue_that_cannot_initialize_stops_the_filer(tmp_path,
                                                        monkeypatch):
    """notification.toml enables kafka at a broker that does not answer.
    The reference's filer warns and starts with no publisher, so every
    event is lost; the port's fails at start, before its store opens."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead = f"127.0.0.1:{s.getsockname()[1]}"
    (tmp_path / "notification.toml").write_text(
        f'[notification.kafka]\nenabled = true\nhosts = ["{dead}"]\n')
    monkeypatch.chdir(tmp_path)
    port = _free_port_pair()
    ref = ref_filer_server.FilerServer(ip="127.0.0.1", port=port,
                                       master="127.0.0.1:1",
                                       store_dir=str(tmp_path / "ref"))
    assert ref.filer.notification_queue is None
    with pytest.raises(RuntimeError, match="notification queue 'kafka'"):
        filer_server.FilerServer(ip="127.0.0.1", port=port,
                                 master="127.0.0.1:1",
                                 store_dir=str(tmp_path / "port"))
    assert not os.path.exists(tmp_path / "port" / "filer.db")
    with pytest.raises(SystemExit) as e:
        command.main(["filer", "-ip", "127.0.0.1", "-port", str(port),
                      "-master", "127.0.0.1:1", "-dir",
                      str(tmp_path / "cli")])
    assert "notification queue 'kafka'" in str(e.value.code)
    ref_notification.set_active(None)


def test_fs_meta_notify_publishes_the_references_bytes(tmp_path):
    port = _free_port_pair()
    fs = _started(PKGS["port"], port)
    got = {}
    try:
        _filer_script(rpc.filer_stub(f"127.0.0.1:{port + 10000}"),
                      filer_pb2)
        for name, k in PKGS.items():
            broker = FakeKafkaBroker(topic="notify", partitions=3)
            d = tmp_path / name
            d.mkdir()
            _kafka_toml(d / "notification.toml", broker)
            try:
                with pytest.MonkeyPatch.context() as mp:
                    mp.chdir(d)
                    out = io.StringIO()
                    env = k["Env"]("127.0.0.1:1", filer=f"127.0.0.1:{port}")
                    assert k["run"](env, "fs.meta.notify /pub", out) == 0, \
                        out.getvalue()
                got[name] = (out.getvalue(),
                             {p: list(m) for p, m in broker.messages.items()})
            finally:
                k["notification"].set_active(None)
                broker.close()
    finally:
        _stopped(fs)
    assert got["port"] == got["ref"]
    # /pub/d1 and /pub/d2 and their 3 and 5 files: one message per entry
    assert got["port"][0].strip() == "notified 10 entries under /pub"
    assert sum(len(m) for m in got["port"][1].values()) == 10


def test_fs_meta_notify_without_a_queue_says_so(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for name, k in PKGS.items():
        out = io.StringIO()
        env = k["Env"]("127.0.0.1:1", filer="127.0.0.1:1")
        assert k["run"](env, "fs.meta.notify /", out) == 1
        assert "no notification queue configured" in out.getvalue(), name
