# Hand-built protobuf module for the pluggable code-geometry plane
# (ISSUE 11).
#
# protoc is not available in this container (pb/regen.sh documents the
# normal path), so the FileDescriptorProto for proto/ec_geometry.proto is
# constructed programmatically and registered in the default pool — the
# scrub_pb2 / ec_stream_pb2 pattern. Messages live in the
# volume_server_pb package and REPLACE the request/response types of two
# existing VolumeServer RPCs in pb/rpc.py:
#
#   * VolumeEcShardsGenerate gains a `geometry` name (field 5; fields
#     1-4 match volume_server_pb2.VolumeEcShardsGenerateRequest number
#     for number, so old clients stay wire-compatible);
#   * VolumeEcShardsRebuild's request gains `shard_ids` (the
#     genuinely-missing set — the rebuilder no longer rebuilds shards
#     that merely aren't local) and its response reports the geometry it
#     operated on plus the survivor bytes the minimal-read plan read.
#
# Cross-class serialization is safe: the stub's serializer is
# `NewClass.SerializeToString(msg)` which protobuf dispatches on the
# message's own descriptor, and the field numbers coincide.

from __future__ import annotations

from google.protobuf import descriptor_pb2, descriptor_pool, message_factory

_F = descriptor_pb2.FieldDescriptorProto

_TYPES = {
    "string": _F.TYPE_STRING,
    "uint32": _F.TYPE_UINT32,
    "uint64": _F.TYPE_UINT64,
}

_PACKAGE = "volume_server_pb"


def _build() -> descriptor_pb2.FileDescriptorProto:
    fdp = descriptor_pb2.FileDescriptorProto(
        name="ec_geometry.proto", package=_PACKAGE, syntax="proto3")

    def msg(name: str, *fields):
        m = fdp.message_type.add()
        m.name = name
        for number, fname, ftype, *rest in fields:
            f = m.field.add()
            f.name = fname
            f.number = number
            f.label = (_F.LABEL_REPEATED if "repeated" in rest
                       else _F.LABEL_OPTIONAL)
            f.type = _TYPES[ftype]

    msg("EcGenerateRequest",
        (1, "volume_id", "uint32"),
        (2, "collection", "string"),
        (3, "data_shards", "uint32"),
        (4, "parity_shards", "uint32"),
        (5, "geometry", "string"))      # registered code-geometry name
    msg("EcRebuildRequest",
        (1, "volume_id", "uint32"),
        (2, "collection", "string"),
        (3, "shard_ids", "uint32", "repeated"))  # genuinely-missing set
    msg("EcRebuildResponse",
        (1, "rebuilt_shard_ids", "uint32", "repeated"),
        (2, "geometry", "string"),               # what the rebuild used
        (3, "survivor_bytes_read", "uint64"),    # minimal-read plan cost
        (4, "survivor_shards", "uint32"))
    return fdp


_pool = descriptor_pool.Default()
try:
    _file = _pool.Add(_build())
# lint: allow-broad-except(the pool raises a bare error when the file is
# already registered; the lookup below is the recovery)
except Exception:  # already registered (re-import through a fresh module)
    _file = _pool.FindFileByName("ec_geometry.proto")


def _cls(name: str):
    return message_factory.GetMessageClass(
        _pool.FindMessageTypeByName(f"{_PACKAGE}.{name}"))


EcGenerateRequest = _cls("EcGenerateRequest")
EcRebuildRequest = _cls("EcRebuildRequest")
EcRebuildResponse = _cls("EcRebuildResponse")
