# Hand-built protobuf module for the streaming replica->EC conversion
# plane (ISSUE 6).
#
# protoc is not available in this container (pb/regen.sh documents the
# normal path), so the FileDescriptorProto for proto/ec_stream.proto is
# constructed programmatically and registered in the default pool — the
# wire format is identical to generated code, and `sh regen.sh` will
# simply overwrite this module with protoc output when the toolchain
# exists. Messages live in the volume_server_pb package: they extend the
# existing VolumeServer service (pb/rpc.py VOLUME_SERVICE) with the
# VolumeEcShardsStream / VolumeEcShardsStreamStatus /
# VolumeEcShardsGenerateStreamed RPCs.

from __future__ import annotations

from google.protobuf import descriptor_pb2, descriptor_pool, message_factory

_F = descriptor_pb2.FieldDescriptorProto

_TYPES = {
    "double": _F.TYPE_DOUBLE,
    "bool": _F.TYPE_BOOL,
    "string": _F.TYPE_STRING,
    "bytes": _F.TYPE_BYTES,
    "int32": _F.TYPE_INT32,
    "uint32": _F.TYPE_UINT32,
    "uint64": _F.TYPE_UINT64,
}

_PACKAGE = "volume_server_pb"


def _build() -> descriptor_pb2.FileDescriptorProto:
    fdp = descriptor_pb2.FileDescriptorProto(
        name="ec_stream.proto", package=_PACKAGE, syntax="proto3")

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
            else:  # message-typed field
                f.type = _F.TYPE_MESSAGE
                f.type_name = f".{_PACKAGE}.{ftype}"

    # -- the slab stream (source -> destination, client-streaming) --------
    msg("EcStreamHeader",
        (1, "volume_id", "uint32"),
        (2, "collection", "string"),
        (3, "shard_ids", "uint32", "repeated"),
        (4, "shard_size", "uint64"),   # final size of EVERY shard file
        (5, "resume", "bool"),         # append after the receiver's prefix
        (6, "source", "string"))       # source server address (diagnostics)
    msg("EcStreamSlab",
        (1, "shard_id", "uint32"),
        (2, "offset", "uint64"),       # byte offset within the shard file
        (3, "data", "bytes"),
        (4, "crc", "uint32"))          # crc32c(data) — verified in transit
    msg("EcStreamShardDigest",
        (1, "shard_id", "uint32"),
        (2, "crc", "uint32"),          # whole-shard crc32c (slab-folded)
        (3, "size", "uint64"))
    msg("EcStreamCommit",
        (1, "digests", "EcStreamShardDigest", "repeated"))
    msg("VolumeEcShardsStreamRequest",
        # exactly one of header/slab/commit is set per message; the first
        # message MUST be the header
        (1, "header", "EcStreamHeader"),
        (2, "slab", "EcStreamSlab"),
        (3, "commit", "EcStreamCommit"))
    msg("VolumeEcShardsStreamResponse",
        (1, "shards", "EcStreamShardDigest", "repeated"),
        (2, "bytes_received", "uint64"))

    # -- resume progress probe --------------------------------------------
    msg("VolumeEcShardsStreamStatusRequest",
        (1, "volume_id", "uint32"),
        (2, "collection", "string"),
        (3, "shard_ids", "uint32", "repeated"))
    msg("EcStreamShardProgress",
        (1, "shard_id", "uint32"),
        (2, "size", "uint64"))         # contiguous bytes durably on disk
    msg("VolumeEcShardsStreamStatusResponse",
        (1, "shards", "EcStreamShardProgress", "repeated"))

    # -- the pipelined generate (shell -> source server) ------------------
    msg("EcStreamTarget",
        (1, "address", "string"),
        (2, "shard_ids", "uint32", "repeated"))
    msg("VolumeEcShardsGenerateStreamedRequest",
        (1, "volume_id", "uint32"),
        (2, "collection", "string"),
        (3, "data_shards", "uint32"),
        (4, "parity_shards", "uint32"),
        (5, "targets", "EcStreamTarget", "repeated"),
        (6, "geometry", "string"))     # code-geometry name (ISSUE 11)
    msg("EcStreamTargetResult",
        (1, "address", "string"),
        (2, "ok", "bool"),
        (3, "error", "string"),
        (4, "bytes_streamed", "uint64"),
        (5, "resumes", "uint32"),
        (6, "resumed_bytes", "uint64"))
    msg("VolumeEcShardsGenerateStreamedResponse",
        (1, "targets", "EcStreamTargetResult", "repeated"),
        (2, "encode_seconds", "double"),
        (3, "wall_seconds", "double"),
        (4, "overlap_ratio", "double"),  # encode_seconds / wall_seconds
        (5, "bytes_streamed", "uint64"),
        (6, "resumes", "uint32"))
    return fdp


_pool = descriptor_pool.Default()
try:
    _file = _pool.Add(_build())
# lint: allow-broad-except(the pool raises a bare error when the file is
# already registered; the lookup below is the recovery)
except Exception:  # already registered (re-import through a fresh module)
    _file = _pool.FindFileByName("ec_stream.proto")


def _cls(name: str):
    return message_factory.GetMessageClass(
        _pool.FindMessageTypeByName(f"{_PACKAGE}.{name}"))


EcStreamHeader = _cls("EcStreamHeader")
EcStreamSlab = _cls("EcStreamSlab")
EcStreamShardDigest = _cls("EcStreamShardDigest")
EcStreamCommit = _cls("EcStreamCommit")
VolumeEcShardsStreamRequest = _cls("VolumeEcShardsStreamRequest")
VolumeEcShardsStreamResponse = _cls("VolumeEcShardsStreamResponse")
VolumeEcShardsStreamStatusRequest = _cls("VolumeEcShardsStreamStatusRequest")
EcStreamShardProgress = _cls("EcStreamShardProgress")
VolumeEcShardsStreamStatusResponse = _cls(
    "VolumeEcShardsStreamStatusResponse")
EcStreamTarget = _cls("EcStreamTarget")
VolumeEcShardsGenerateStreamedRequest = _cls(
    "VolumeEcShardsGenerateStreamedRequest")
EcStreamTargetResult = _cls("EcStreamTargetResult")
VolumeEcShardsGenerateStreamedResponse = _cls(
    "VolumeEcShardsGenerateStreamedResponse")
