# Hand-built protobuf module for the cross-server syndrome-verify
# gather plane (ISSUE 13).
#
# protoc is not available in this container (pb/regen.sh documents the
# normal path), so the FileDescriptorProto for proto/ec_gather.proto is
# constructed programmatically and registered in the default pool — the
# wire format is identical to generated code, and `sh regen.sh` will
# simply overwrite this module with protoc output when the toolchain
# exists. Messages live in the volume_server_pb package: they extend the
# existing VolumeServer service (pb/rpc.py VOLUME_SERVICE) with the
# VolumeEcShardsRead range RPC — the ISSUE-6 VolumeEcShardsStream slab
# transport run in REVERSE: a scrubbing holder pulls chunked,
# CRC-verified, offset-addressed survivor ranges from the peers that
# hold them, so an EC volume whose shards are split across servers can
# still be syndrome-verified somewhere.

from __future__ import annotations

from google.protobuf import descriptor_pb2, descriptor_pool, message_factory

_F = descriptor_pb2.FieldDescriptorProto

_TYPES = {
    "bool": _F.TYPE_BOOL,
    "string": _F.TYPE_STRING,
    "bytes": _F.TYPE_BYTES,
    "uint32": _F.TYPE_UINT32,
    "uint64": _F.TYPE_UINT64,
}

_PACKAGE = "volume_server_pb"


def _build() -> descriptor_pb2.FileDescriptorProto:
    fdp = descriptor_pb2.FileDescriptorProto(
        name="ec_gather.proto", package=_PACKAGE, syntax="proto3")

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

    msg("EcShardRange",
        (1, "shard_id", "uint32"),
        (2, "offset", "uint64"),    # byte offset within the shard file
        (3, "size", "uint64"))      # 0 = to end of shard
    msg("VolumeEcShardsReadRequest",
        (1, "volume_id", "uint32"),
        (2, "collection", "string"),
        (3, "ranges", "EcShardRange", "repeated"),
        (4, "slab", "uint32"))      # slab granularity; 0 = server default
    # one slab per message — the EcStreamSlab wire shape (ec_stream.proto)
    msg("VolumeEcShardsReadResponse",
        (1, "shard_id", "uint32"),
        (2, "offset", "uint64"),
        (3, "data", "bytes"),
        (4, "crc", "uint32"))       # crc32c(data) — verified in transit
    return fdp


_pool = descriptor_pool.Default()
try:
    _file = _pool.Add(_build())
# lint: allow-broad-except(the pool raises a bare error when the file is
# already registered; the lookup below is the recovery)
except Exception:  # already registered (re-import through a fresh module)
    _file = _pool.FindFileByName("ec_gather.proto")


def _cls(name: str):
    return message_factory.GetMessageClass(
        _pool.FindMessageTypeByName(f"{_PACKAGE}.{name}"))


EcShardRange = _cls("EcShardRange")
VolumeEcShardsReadRequest = _cls("VolumeEcShardsReadRequest")
VolumeEcShardsReadResponse = _cls("VolumeEcShardsReadResponse")
