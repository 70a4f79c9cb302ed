# Hand-built protobuf module for the metadata ring plane (a copy of
# seaweedfs_tpu/pb/meta_ring_pb2.py).
#
# protoc is not available in this container (pb/regen.sh documents the
# normal path), so the FileDescriptorProto for proto/meta_ring.proto is
# constructed programmatically and registered in the default pool — the
# wire format is identical to generated code, and `sh regen.sh` will
# simply overwrite this module with protoc output when the toolchain
# exists. Messages live in the master_pb package: they extend the
# existing Seaweed master service (pb/rpc.py MASTER_SERVICE) with the
# GetMetaRing / JoinMetaRing RPCs, and the filer service proxies
# GetMetaRing so gateway planes (S3/mount/WebDAV) never need a master
# address — any shard hands out the ring it is serving under.

from __future__ import annotations

from google.protobuf import descriptor_pb2, descriptor_pool, message_factory

_F = descriptor_pb2.FieldDescriptorProto

_TYPES = {
    "double": _F.TYPE_DOUBLE,
    "bool": _F.TYPE_BOOL,
    "string": _F.TYPE_STRING,
    "uint32": _F.TYPE_UINT32,
    "uint64": _F.TYPE_UINT64,
}

_PACKAGE = "master_pb"


def _build() -> descriptor_pb2.FileDescriptorProto:
    fdp = descriptor_pb2.FileDescriptorProto(
        name="meta_ring.proto", package=_PACKAGE, syntax="proto3")

    def msg(name: str, *fields):
        m = fdp.message_type.add()
        m.name = name
        for number, fname, ftype, *rest in fields:
            f = m.field.add()
            f.name = fname
            f.number = number
            f.label = (_F.LABEL_REPEATED if "repeated" in rest
                       else _F.LABEL_OPTIONAL)
            if ftype in _TYPES:
                f.type = _TYPES[ftype]
            else:
                f.type = _F.TYPE_MESSAGE
                f.type_name = f".{_PACKAGE}.{ftype}"

    msg("GetMetaRingRequest")
    # The full ring picture: membership + the epoch it was published
    # under. Virtual-node positions are NOT carried — they are a pure
    # deterministic function of (shards, replicas), pinned by a golden
    # test, so every process derives the identical layout.
    msg("MetaRingResponse",
        (1, "epoch", "uint64"),
        (2, "shards", "string", "repeated"),
        (3, "replicas", "uint32"))
    # Filer shards announce/renew membership over their heartbeat loop;
    # the response doubles as an epoch-bumped ring update so a joining
    # or steady-state shard converges in one round trip.
    msg("JoinMetaRingRequest",
        (1, "address", "string"),
        (2, "leave", "bool"))
    return fdp


_pool = descriptor_pool.Default()
try:
    _file = _pool.Add(_build())
# lint: allow-broad-except(the pool raises a bare error when the file is
# already registered; the lookup below is the recovery)
except Exception:  # already registered (re-import through a fresh module)
    _file = _pool.FindFileByName("meta_ring.proto")


def _cls(name: str):
    return message_factory.GetMessageClass(
        _pool.FindMessageTypeByName(f"{_PACKAGE}.{name}"))


GetMetaRingRequest = _cls("GetMetaRingRequest")
MetaRingResponse = _cls("MetaRingResponse")
JoinMetaRingRequest = _cls("JoinMetaRingRequest")
