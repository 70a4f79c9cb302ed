"""Pluggable metadata-event publishers.

Counterpart of seaweedfs_tpu/notification/__init__.py (SeaweedFS
weed/notification/configuration.go): filer mutations can be published to
an external queue. Publishers register by
name; `log` and `memory` are built in, and the cloud queues are real
wire implementations with no client library: `kafka` speaks the Kafka
binary protocol (kafka_wire.py), `aws_sqs` the SigV4-signed query API,
`google_pub_sub` the REST publish API. Only `gocdk_pub_sub` stays
gated (a Go-only portability layer whose backends are covered above).

Where the reference differs (ROADMAP.md C): its filer logs a queue that
fails to initialize and starts without one; the port's filer does not
start (server/filer.py).
"""

from __future__ import annotations

import threading
from collections import deque

from ..pb import filer_pb2
from ..utils import glog


class MessageQueue:
    """Publisher SPI (notification.MessageQueue interface)."""

    name = "none"

    def initialize(self, config: dict) -> None:  # pragma: no cover
        pass

    def send_message(self, key: str,
                     message: filer_pb2.EventNotification) -> None:
        raise NotImplementedError


class LogQueue(MessageQueue):
    """Logs events (the reference's `log` publisher)."""

    name = "log"

    def send_message(self, key, message):
        glog.info(f"notify {key}: delete_chunks={message.delete_chunks} "
                  f"new={message.new_entry.name!r}")


class MemoryQueue(MessageQueue):
    """In-process queue for tests and the replicate command's local mode."""

    name = "memory"

    def __init__(self, capacity: int = 65536):
        self.events: deque[tuple[str, filer_pb2.EventNotification]] = \
            deque(maxlen=capacity)
        self._cond = threading.Condition()

    def send_message(self, key, message):
        copied = filer_pb2.EventNotification()
        copied.CopyFrom(message)
        with self._cond:
            self.events.append((key, copied))
            self._cond.notify_all()

    def drain(self, timeout: float = 0.0):
        with self._cond:
            if not self.events and timeout > 0:
                self._cond.wait(timeout)
            out = list(self.events)
            self.events.clear()
            return out


class KafkaQueue(MessageQueue):
    """Kafka publisher (notification/kafka/kafka_queue.go) over the
    in-repo wire-protocol producer — key = path, value = serialized
    EventNotification, hash-partitioned, acks=WaitForLocal."""

    name = "kafka"

    def __init__(self):
        self._producer = None
        self.topic = ""

    def initialize(self, config):
        from .kafka_wire import KafkaProducer

        hosts = config.get("hosts", ["localhost:9092"])
        if isinstance(hosts, str):
            hosts = [hosts]
        self.topic = config.get("topic", "seaweedfs_filer")
        self._producer = KafkaProducer(hosts)
        self._producer.metadata(self.topic)  # fail fast like sarama dial

    def send_message(self, key, message):
        if self._producer is None:
            raise RuntimeError("kafka queue not initialized")
        self._producer.produce(self.topic, key.encode(),
                               message.SerializeToString())


class AwsSqsQueue(MessageQueue):
    """SQS publisher (notification/aws_sqs/aws_sqs_pub.go): GetQueueUrl
    at init, then SendMessage per event — SigV4-signed query-API calls
    via the same signer the S3 tier/sink clients use. Deliberate
    deviation: the reference sends raw marshaled proto bytes as
    MessageBody (aws_sqs_pub.go SendMessage), which SQS rejects for
    payloads that aren't valid UTF-8; this queue base64-encodes the
    body so every event is deliverable. DelaySeconds=10 matches the
    reference."""

    name = "aws_sqs"

    def __init__(self):
        self.queue_url = ""
        self.endpoint = ""
        self.access_key = self.secret_key = ""
        self.region = "us-east-1"

    def initialize(self, config):
        import requests

        self.access_key = config.get("aws_access_key_id", "")
        self.secret_key = config.get("aws_secret_access_key", "")
        self.region = config.get("region", "us-east-1")
        self.endpoint = (config.get("endpoint", "") or
                         f"https://sqs.{self.region}.amazonaws.com")
        queue = config.get("sqs_queue_name", "")
        r = requests.post(self.endpoint, data=self._form({
            "Action": "GetQueueUrl", "QueueName": queue,
            "Version": "2012-11-05"}), headers=self._headers(
                {"Action": "GetQueueUrl", "QueueName": queue,
                 "Version": "2012-11-05"}), timeout=30)
        if r.status_code >= 300:
            raise RuntimeError(f"sqs GetQueueUrl {queue}: {r.status_code}")
        import xml.etree.ElementTree as ET

        url = ET.fromstring(r.content).findtext(".//{*}QueueUrl") or ""
        if not url:
            raise RuntimeError(f"unable to find queue {queue}")
        self.queue_url = url

    @staticmethod
    def _form(fields: dict) -> bytes:
        import urllib.parse

        return urllib.parse.urlencode(sorted(fields.items())).encode()

    def _headers(self, fields: dict) -> dict:
        body = self._form(fields)
        headers = {"Content-Type":
                   "application/x-www-form-urlencoded; charset=utf-8"}
        if self.access_key:
            from ..s3api.sigv4_client import sign_request

            headers.update(sign_request(
                "POST", self.endpoint, body, self.access_key,
                self.secret_key, self.region, service="sqs"))
            headers["Content-Type"] = \
                "application/x-www-form-urlencoded; charset=utf-8"
        return headers

    def send_message(self, key, message):
        import base64

        import requests

        if not self.queue_url:
            raise RuntimeError("sqs queue not initialized")
        fields = {
            "Action": "SendMessage", "Version": "2012-11-05",
            "QueueUrl": self.queue_url,
            "DelaySeconds": "10",
            "MessageBody": base64.b64encode(
                message.SerializeToString()).decode(),
            # the reference attaches the path as a message attribute
            "MessageAttribute.1.Name": "key",
            "MessageAttribute.1.Value.DataType": "String",
            "MessageAttribute.1.Value.StringValue": key,
        }
        r = requests.post(self.endpoint, data=self._form(fields),
                          headers=self._headers(fields), timeout=30)
        if r.status_code >= 300:
            raise IOError(f"sqs SendMessage: {r.status_code} {r.text[:200]}")


class GooglePubSubQueue(MessageQueue):
    """Pub/Sub publisher (notification/google_pub_sub/google_pub_sub.go):
    REST publish with base64 data + key attribute; creates the topic on
    first use like the reference. Auth is a static bearer token
    (service-account JWT exchange needs RSA signing the stdlib lacks)."""

    name = "google_pub_sub"

    def __init__(self):
        self.project = self.topic = self.token = ""
        self.endpoint = "https://pubsub.googleapis.com"

    def initialize(self, config):
        import requests

        self.project = config.get("project_id", "")
        self.topic = config.get("topic", "seaweedfs_filer")
        self.token = config.get("token", "")
        self.endpoint = (config.get("endpoint", "") or
                         self.endpoint).rstrip("/")
        # ensure-topic like the reference (google_pub_sub.go): check
        # Exists first so publish-only credentials on an existing topic
        # pass; only create when missing; fail hard otherwise
        topic_url = (f"{self.endpoint}/v1/projects/{self.project}/topics/"
                     f"{self.topic}")
        r = requests.get(topic_url, headers=self._headers(), timeout=30)
        if r.status_code == 404:
            r = requests.put(topic_url, headers=self._headers(), timeout=30)
            if r.status_code >= 300 and r.status_code != 409:
                raise RuntimeError(
                    f"pubsub create-topic {self.topic}: {r.status_code} "
                    f"{r.text[:200]}")
        elif r.status_code >= 300:
            raise RuntimeError(
                f"pubsub topic check {self.topic}: {r.status_code} "
                f"{r.text[:200]}")

    def _headers(self) -> dict:
        h = {"Content-Type": "application/json"}
        if self.token:
            h["Authorization"] = f"Bearer {self.token}"
        return h

    def send_message(self, key, message):
        import base64
        import json as _json

        import requests

        r = requests.post(
            f"{self.endpoint}/v1/projects/{self.project}/topics/"
            f"{self.topic}:publish",
            data=_json.dumps({"messages": [{
                "data": base64.b64encode(
                    message.SerializeToString()).decode(),
                "attributes": {"key": key}}]}),
            headers=self._headers(), timeout=30)
        if r.status_code >= 300:
            raise IOError(f"pubsub publish: {r.status_code} {r.text[:200]}")


class _GatedQueue(MessageQueue):
    """Placeholder for publishers whose client library is unavailable."""

    def __init__(self, name: str, module: str):
        self.name = name
        self._module = module

    def initialize(self, config):
        raise RuntimeError(
            f"notification publisher {self.name!r} needs the {self._module} "
            f"client library, which is not available in this environment")

    def send_message(self, key, message):
        self.initialize({})


QUEUES: dict[str, MessageQueue] = {}


def register(q: MessageQueue) -> MessageQueue:
    QUEUES[q.name] = q
    return q


register(LogQueue())
register(MemoryQueue())
register(KafkaQueue())
register(AwsSqsQueue())
register(GooglePubSubQueue())
# gocdk is a Go-only portability layer over the three queues above;
# its concrete backends are all reachable directly here
register(_GatedQueue("gocdk_pub_sub", "gocloud.dev"))


def load_configuration(config: dict) -> MessageQueue | None:
    """notification.toml shape: {"notification": {"log": {"enabled": true}}}
    (LoadConfiguration, configuration.go)."""
    section = config.get("notification", config)
    for name, sub in section.items():
        if isinstance(sub, dict) and sub.get("enabled"):
            q = QUEUES.get(name)
            if q is None:
                raise KeyError(f"unknown notification queue {name!r}")
            q.initialize(sub)
            set_active(q)
            return q
    return None


_active: MessageQueue | None = None


def set_active(q: MessageQueue | None) -> None:
    """Record the process's configured publisher (filer startup /
    fs.configure set this; fs.meta.notify reads it)."""
    global _active
    _active = q


def current_queue(default: str = "") -> MessageQueue | None:
    """The active publisher, or a named registered one as fallback."""
    if _active is not None:
        return _active
    return QUEUES.get(default) if default else None
