# Hand-built protobuf module for the QoS grant plane (ISSUE 8).
#
# protoc is not available in this container (pb/regen.sh documents the
# normal path), so the FileDescriptorProto for proto/qos.proto is
# constructed programmatically and registered in the default pool — the
# wire format is identical to generated code, and `sh regen.sh` will
# simply overwrite this module with protoc output when the toolchain
# exists. Messages live in the master_pb package: they extend the
# existing Seaweed master service (pb/rpc.py MASTER_SERVICE) with the
# QosGrant RPC.

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
        name="qos.proto", package=_PACKAGE, syntax="proto3")

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

    msg("QosGrantRequest",
        (1, "address", "string"),
        (2, "work_class", "string"),
        (3, "requested_bytes", "uint64"),
        (4, "pressure", "double"),
        (5, "gc_depth", "uint64"),
        (6, "dispatch_depth", "uint64"))
    msg("QosGrantResponse",
        (1, "granted_bytes", "uint64"),
        (2, "lease_ttl_seconds", "double"),
        (3, "cluster_rate_bytes", "uint64"),
        (4, "error", "string"))
    return fdp


_pool = descriptor_pool.Default()
try:
    _file = _pool.Add(_build())
# lint: allow-broad-except(the pool raises a bare error when the file is
# already registered; the lookup below is the recovery)
except Exception:  # already registered (re-import through a fresh module)
    _file = _pool.FindFileByName("qos.proto")


def _cls(name: str):
    return message_factory.GetMessageClass(
        _pool.FindMessageTypeByName(f"{_PACKAGE}.{name}"))


QosGrantRequest = _cls("QosGrantRequest")
QosGrantResponse = _cls("QosGrantResponse")
