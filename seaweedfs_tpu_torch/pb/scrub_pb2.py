# Hand-built protobuf module for the scrub/anti-entropy plane.
#
# protoc is not available in this container (pb/regen.sh documents the
# normal path), so the FileDescriptorProto for proto/scrub.proto is
# constructed programmatically and registered in the default pool — the
# wire format is identical to generated code, and `sh regen.sh` will
# simply overwrite this module with protoc output when the toolchain
# exists. Messages live in the volume_server_pb package: they extend the
# existing VolumeServer service (pb/rpc.py VOLUME_SERVICE) with the
# VolumeDigest / VolumeScrub / ScrubStatus RPCs.

from __future__ import annotations

from google.protobuf import descriptor_pb2, descriptor_pool, message_factory

_F = descriptor_pb2.FieldDescriptorProto

_TYPES = {
    "double": _F.TYPE_DOUBLE,
    "bool": _F.TYPE_BOOL,
    "string": _F.TYPE_STRING,
    "int32": _F.TYPE_INT32,
    "uint32": _F.TYPE_UINT32,
    "uint64": _F.TYPE_UINT64,
}

_PACKAGE = "volume_server_pb"


def _build() -> descriptor_pb2.FileDescriptorProto:
    fdp = descriptor_pb2.FileDescriptorProto(
        name="scrub.proto", package=_PACKAGE, syntax="proto3")

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

    msg("NeedleDigestEntry",
        (1, "needle_id", "uint64"),
        (2, "crc", "uint32"),
        (3, "size", "int32"),   # negative = tombstone
        # replica-epoch causality tag (ISSUE 13; storage/epoch.py) —
        # all-zero for pre-epoch records; excluded from divergence
        # comparison, used to order same-timestamp conflicts
        (4, "epoch_incarnation", "uint64"),
        (5, "epoch_seq", "uint64"),
        (6, "epoch_server", "uint32"))
    msg("ShardDigest",
        (1, "shard_id", "uint32"),
        (2, "crc", "uint32"),
        (3, "size", "uint64"))
    msg("VolumeDigestRequest",
        (1, "volume_id", "uint32"),
        (2, "collection", "string"),
        (3, "include_entries", "bool"))
    msg("VolumeDigestResponse",
        (1, "volume_id", "uint32"),
        (2, "needle_count", "uint64"),
        (3, "rolling_crc", "uint32"),
        (4, "entries", "NeedleDigestEntry", "repeated"),
        (5, "is_ec", "bool"),
        (6, "shard_digests", "ShardDigest", "repeated"),
        (7, "tombstone_count", "uint64"))
    msg("ScrubFinding",
        (1, "volume_id", "uint32"),
        (2, "kind", "string"),   # needle_crc | ec_parity | replica_divergence
        (3, "needle_id", "uint64"),
        (4, "shard_id", "uint32"),
        (5, "detail", "string"),
        (6, "state", "string"),  # found | repaired | failed
        (7, "found_at_unix", "double"))
    msg("VolumeScrubRequest",
        (1, "volume_id", "uint32"),  # 0 = every volume on the server
        (2, "full", "bool"),         # ignore the cursor, sweep from 0
        (3, "repair", "bool"))       # escalate findings into repair
    msg("VolumeScrubResponse",
        (1, "volumes_scrubbed", "uint64"),
        (2, "needles_checked", "uint64"),
        (3, "bytes_verified", "uint64"),
        (4, "findings", "ScrubFinding", "repeated"),
        (5, "repaired", "uint64"),
        # anti-entropy peer pairs whose VolumeDigest probe failed even
        # after retry — partial sweep coverage made visible (ISSUE 13)
        (6, "skipped_pairs", "uint64"))
    msg("ScrubStatusRequest")
    # master-side fleet-scrub pause toggle (mirrors Disable/EnableVacuum)
    msg("DisableScrubRequest")
    msg("DisableScrubResponse")
    msg("EnableScrubRequest")
    msg("EnableScrubResponse")
    msg("VolumeScrubCursor",
        (1, "volume_id", "uint32"),
        (2, "offset", "uint64"),
        (3, "volume_size", "uint64"),
        (4, "sweeps", "uint64"))
    msg("ScrubStatusResponse",
        (1, "cursors", "VolumeScrubCursor", "repeated"),
        (2, "findings", "ScrubFinding", "repeated"),
        (3, "sweeps_completed", "uint64"),
        (4, "running", "bool"),
        (5, "last_sweep_unix", "double"),
        (6, "suspect_backlog", "uint32"))
    return fdp


_pool = descriptor_pool.Default()
try:
    _file = _pool.Add(_build())
# lint: allow-broad-except(the pool raises a bare error when the file is
# already registered; the lookup below is the recovery)
except Exception:  # already registered (re-import through a fresh module)
    _file = _pool.FindFileByName("scrub.proto")


def _cls(name: str):
    return message_factory.GetMessageClass(
        _pool.FindMessageTypeByName(f"{_PACKAGE}.{name}"))


NeedleDigestEntry = _cls("NeedleDigestEntry")
ShardDigest = _cls("ShardDigest")
VolumeDigestRequest = _cls("VolumeDigestRequest")
VolumeDigestResponse = _cls("VolumeDigestResponse")
ScrubFinding = _cls("ScrubFinding")
VolumeScrubRequest = _cls("VolumeScrubRequest")
VolumeScrubResponse = _cls("VolumeScrubResponse")
ScrubStatusRequest = _cls("ScrubStatusRequest")
DisableScrubRequest = _cls("DisableScrubRequest")
DisableScrubResponse = _cls("DisableScrubResponse")
EnableScrubRequest = _cls("EnableScrubRequest")
EnableScrubResponse = _cls("EnableScrubResponse")
VolumeScrubCursor = _cls("VolumeScrubCursor")
ScrubStatusResponse = _cls("ScrubStatusResponse")
