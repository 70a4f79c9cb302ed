"""gRPC plumbing: service descriptors, generic stubs/servicers, channels.

The reference centralizes its gRPC conventions in
SeaweedFS weed/pb/grpc_client_server.go — 1GB max message size (:27),
keepalive (:47-60), and a process-wide cache of client connections keyed by
address (:95-122). This module provides the same, plus a generic stub /
servicer builder (protoc's Python gRPC plugin is not in this environment,
so service classes are derived from descriptor tables instead of generated
code — the wire format is identical).

Counterpart of seaweedfs_tpu/pb/rpc.py with the tables that the volume
server, the master, the filer and the gateways (S3, mount, IAM, the MQ
broker) serve or dial, and the TiKV, YDB and etcd tables that the filer's
network stores dial.

Convention kept from the reference: a server's gRPC port is its HTTP port
+ 10000 (weed/pb/server_address.go).
"""

from __future__ import annotations

import threading
from concurrent import futures

import grpc

from . import (
    ec_gather_pb2,
    ec_geometry_pb2,
    ec_stream_pb2,
    filer_pb2,
    master_pb2,
    meta_ring_pb2,
    mount_pb2,
    mq_pb2,
    qos_pb2,
    s3_pb2,
    scrub_pb2,
    volume_server_pb2,
)
from ..utils import failpoint, trace

MAX_MESSAGE_SIZE = 1 << 30  # grpc_client_server.go:27
GRPC_PORT_DELTA = 10000

_CHANNEL_OPTIONS = [
    ("grpc.max_send_message_length", MAX_MESSAGE_SIZE),
    ("grpc.max_receive_message_length", MAX_MESSAGE_SIZE),
    ("grpc.keepalive_time_ms", 30_000),
    ("grpc.keepalive_timeout_ms", 20_000),
]


def _m(name, req, resp, *, cs=False, ss=False):
    return {"name": name, "req": req, "resp": resp, "cs": cs, "ss": ss}


# -- service descriptors ---------------------------------------------------

M = master_pb2
V = volume_server_pb2
F = filer_pb2

MASTER_SERVICE = ("master_pb.Seaweed", [
    _m("SendHeartbeat", M.Heartbeat, M.HeartbeatResponse, cs=True, ss=True),
    _m("KeepConnected", M.KeepConnectedRequest, M.KeepConnectedResponse, cs=True, ss=True),
    _m("LookupVolume", M.LookupVolumeRequest, M.LookupVolumeResponse),
    _m("Assign", M.AssignRequest, M.AssignResponse),
    _m("Statistics", M.StatisticsRequest, M.StatisticsResponse),
    _m("CollectionList", M.CollectionListRequest, M.CollectionListResponse),
    _m("CollectionDelete", M.CollectionDeleteRequest, M.CollectionDeleteResponse),
    _m("VolumeList", M.VolumeListRequest, M.VolumeListResponse),
    _m("LookupEcVolume", M.LookupEcVolumeRequest, M.LookupEcVolumeResponse),
    _m("VacuumVolume", M.VacuumVolumeRequest, M.VacuumVolumeResponse),
    _m("DisableVacuum", M.DisableVacuumRequest, M.DisableVacuumResponse),
    _m("EnableVacuum", M.EnableVacuumRequest, M.EnableVacuumResponse),
    _m("DisableScrub", scrub_pb2.DisableScrubRequest,
       scrub_pb2.DisableScrubResponse),
    _m("EnableScrub", scrub_pb2.EnableScrubRequest,
       scrub_pb2.EnableScrubResponse),
    _m("VolumeMarkReadonly", M.VolumeMarkReadonlyRequest, M.VolumeMarkReadonlyResponse),
    _m("GetMasterConfiguration", M.GetMasterConfigurationRequest, M.GetMasterConfigurationResponse),
    _m("LeaseAdminToken", M.LeaseAdminTokenRequest, M.LeaseAdminTokenResponse),
    _m("ReleaseAdminToken", M.ReleaseAdminTokenRequest, M.ReleaseAdminTokenResponse),
    _m("ListClusterNodes", M.ListClusterNodesRequest, M.ListClusterNodesResponse),
    _m("Ping", M.PingRequest, M.PingResponse),
    # QoS plane (qos.proto; messages in pb/qos_pb2.py): volume servers
    # lease cluster-wide background byte budgets and report pressure
    _m("QosGrant", qos_pb2.QosGrantRequest, qos_pb2.QosGrantResponse),
    # metadata ring plane (meta_ring.proto; messages in
    # pb/meta_ring_pb2.py): filer shards join/renew over their
    # heartbeat loop, every client plane fetches the published ring
    _m("GetMetaRing", meta_ring_pb2.GetMetaRingRequest,
       meta_ring_pb2.MetaRingResponse),
    _m("JoinMetaRing", meta_ring_pb2.JoinMetaRingRequest,
       meta_ring_pb2.MetaRingResponse),
    _m("RaftListClusterServers", M.RaftListClusterServersRequest, M.RaftListClusterServersResponse),
    _m("RaftAddServer", M.RaftAddServerRequest, M.RaftAddServerResponse),
    _m("RaftRemoveServer", M.RaftRemoveServerRequest, M.RaftRemoveServerResponse),
])

VOLUME_SERVICE = ("volume_server_pb.VolumeServer", [
    _m("BatchDelete", V.BatchDeleteRequest, V.BatchDeleteResponse),
    _m("VacuumVolumeCheck", V.VacuumVolumeCheckRequest, V.VacuumVolumeCheckResponse),
    _m("VacuumVolumeCompact", V.VacuumVolumeCompactRequest, V.VacuumVolumeCompactResponse, ss=True),
    _m("VacuumVolumeCommit", V.VacuumVolumeCommitRequest, V.VacuumVolumeCommitResponse),
    _m("VacuumVolumeCleanup", V.VacuumVolumeCleanupRequest, V.VacuumVolumeCleanupResponse),
    _m("DeleteCollection", V.DeleteCollectionRequest, V.DeleteCollectionResponse),
    _m("AllocateVolume", V.AllocateVolumeRequest, V.AllocateVolumeResponse),
    _m("VolumeSyncStatus", V.VolumeSyncStatusRequest, V.VolumeSyncStatusResponse),
    _m("VolumeIncrementalCopy", V.VolumeIncrementalCopyRequest, V.VolumeIncrementalCopyResponse, ss=True),
    _m("VolumeMount", V.VolumeMountRequest, V.VolumeMountResponse),
    _m("VolumeUnmount", V.VolumeUnmountRequest, V.VolumeUnmountResponse),
    _m("VolumeDelete", V.VolumeDeleteRequest, V.VolumeDeleteResponse),
    _m("VolumeMarkReadonly", V.VolumeMarkReadonlyRequest, V.VolumeMarkReadonlyResponse),
    _m("VolumeMarkWritable", V.VolumeMarkWritableRequest, V.VolumeMarkWritableResponse),
    _m("VolumeConfigure", V.VolumeConfigureRequest, V.VolumeConfigureResponse),
    _m("VolumeStatus", V.VolumeStatusRequest, V.VolumeStatusResponse),
    _m("VolumeCopy", V.VolumeCopyRequest, V.VolumeCopyResponse, ss=True),
    _m("ReadVolumeFileStatus", V.ReadVolumeFileStatusRequest, V.ReadVolumeFileStatusResponse),
    _m("CopyFile", V.CopyFileRequest, V.CopyFileResponse, ss=True),
    _m("ReadNeedleBlob", V.ReadNeedleBlobRequest, V.ReadNeedleBlobResponse),
    _m("WriteNeedleBlob", V.WriteNeedleBlobRequest, V.WriteNeedleBlobResponse),
    _m("ReadAllNeedles", V.ReadAllNeedlesRequest, V.ReadAllNeedlesResponse, ss=True),
    _m("VolumeTailSender", V.VolumeTailSenderRequest, V.VolumeTailSenderResponse, ss=True),
    _m("VolumeTailReceiver", V.VolumeTailReceiverRequest, V.VolumeTailReceiverResponse),
    # geometry-aware forms (ec_geometry.proto; messages in
    # pb/ec_geometry_pb2.py): wire-compatible supersets of the original
    # volume_server_pb2 request/response types — field numbers coincide,
    # so old-style messages serialize through them unchanged
    _m("VolumeEcShardsGenerate", ec_geometry_pb2.EcGenerateRequest,
       V.VolumeEcShardsGenerateResponse),
    _m("VolumeEcShardsRebuild", ec_geometry_pb2.EcRebuildRequest,
       ec_geometry_pb2.EcRebuildResponse),
    _m("VolumeEcShardsCopy", V.VolumeEcShardsCopyRequest, V.VolumeEcShardsCopyResponse),
    _m("VolumeEcShardsDelete", V.VolumeEcShardsDeleteRequest, V.VolumeEcShardsDeleteResponse),
    _m("VolumeEcShardsMount", V.VolumeEcShardsMountRequest, V.VolumeEcShardsMountResponse),
    _m("VolumeEcShardsUnmount", V.VolumeEcShardsUnmountRequest, V.VolumeEcShardsUnmountResponse),
    _m("VolumeEcShardRead", V.VolumeEcShardReadRequest, V.VolumeEcShardReadResponse, ss=True),
    _m("VolumeEcBlobDelete", V.VolumeEcBlobDeleteRequest, V.VolumeEcBlobDeleteResponse),
    _m("VolumeEcShardsToVolume", V.VolumeEcShardsToVolumeRequest, V.VolumeEcShardsToVolumeResponse),
    _m("VolumeTierMoveDatToRemote", V.VolumeTierMoveDatToRemoteRequest,
       V.VolumeTierMoveDatToRemoteResponse, ss=True),
    _m("VolumeTierMoveDatFromRemote", V.VolumeTierMoveDatFromRemoteRequest,
       V.VolumeTierMoveDatFromRemoteResponse, ss=True),
    _m("VolumeServerStatus", V.VolumeServerStatusRequest, V.VolumeServerStatusResponse),
    _m("VolumeServerLeave", V.VolumeServerLeaveRequest, V.VolumeServerLeaveResponse),
    _m("ReadNeedleMeta", V.ReadNeedleMetaRequest, V.ReadNeedleMetaResponse),
    _m("FetchAndWriteNeedle", V.FetchAndWriteNeedleRequest, V.FetchAndWriteNeedleResponse),
    _m("Query", V.QueryRequest, V.QueriedStripe, ss=True),
    _m("VolumeNeedleStatus", V.VolumeNeedleStatusRequest, V.VolumeNeedleStatusResponse),
    _m("Ping", V.PingRequest, V.PingResponse),
    # integrity plane (scrub.proto; messages in pb/scrub_pb2.py)
    _m("VolumeDigest", scrub_pb2.VolumeDigestRequest,
       scrub_pb2.VolumeDigestResponse),
    _m("VolumeScrub", scrub_pb2.VolumeScrubRequest,
       scrub_pb2.VolumeScrubResponse),
    _m("ScrubStatus", scrub_pb2.ScrubStatusRequest,
       scrub_pb2.ScrubStatusResponse),
    # streaming replica->EC conversion (ec_stream.proto; messages in
    # pb/ec_stream_pb2.py): the source pushes shard slabs to their
    # destinations WHILE the encode runs (storage/ec_stream.py)
    _m("VolumeEcShardsStream", ec_stream_pb2.VolumeEcShardsStreamRequest,
       ec_stream_pb2.VolumeEcShardsStreamResponse, cs=True),
    _m("VolumeEcShardsStreamStatus",
       ec_stream_pb2.VolumeEcShardsStreamStatusRequest,
       ec_stream_pb2.VolumeEcShardsStreamStatusResponse),
    _m("VolumeEcShardsGenerateStreamed",
       ec_stream_pb2.VolumeEcShardsGenerateStreamedRequest,
       ec_stream_pb2.VolumeEcShardsGenerateStreamedResponse),
    # cross-server syndrome-verify gather (ec_gather.proto; messages in
    # pb/ec_gather_pb2.py): the VolumeEcShardsStream slab transport run
    # in reverse — a scrubbing holder pulls chunked, CRC-verified,
    # offset-addressed survivor ranges from their holders
    _m("VolumeEcShardsRead", ec_gather_pb2.VolumeEcShardsReadRequest,
       ec_gather_pb2.VolumeEcShardsReadResponse, ss=True),
])

FILER_SERVICE = ("filer_pb.SeaweedFiler", [
    _m("LookupDirectoryEntry", F.LookupDirectoryEntryRequest, F.LookupDirectoryEntryResponse),
    _m("ListEntries", F.ListEntriesRequest, F.ListEntriesResponse, ss=True),
    _m("CreateEntry", F.CreateEntryRequest, F.CreateEntryResponse),
    _m("UpdateEntry", F.UpdateEntryRequest, F.UpdateEntryResponse),
    _m("AppendToEntry", F.AppendToEntryRequest, F.AppendToEntryResponse),
    _m("DeleteEntry", F.DeleteEntryRequest, F.DeleteEntryResponse),
    _m("AtomicRenameEntry", F.AtomicRenameEntryRequest, F.AtomicRenameEntryResponse),
    _m("StreamRenameEntry", F.StreamRenameEntryRequest, F.StreamRenameEntryResponse, ss=True),
    _m("AssignVolume", F.AssignVolumeRequest, F.AssignVolumeResponse),
    _m("LookupVolume", F.LookupVolumeRequest, F.LookupVolumeResponse),
    _m("CollectionList", F.CollectionListRequest, F.CollectionListResponse),
    _m("DeleteCollection", F.DeleteCollectionRequest, F.DeleteCollectionResponse),
    _m("Statistics", F.StatisticsRequest, F.StatisticsResponse),
    _m("GetFilerConfiguration", F.GetFilerConfigurationRequest, F.GetFilerConfigurationResponse),
    _m("SubscribeMetadata", F.SubscribeMetadataRequest, F.SubscribeMetadataResponse, ss=True),
    _m("SubscribeLocalMetadata", F.SubscribeMetadataRequest, F.SubscribeMetadataResponse, ss=True),
    _m("KvGet", F.KvGetRequest, F.KvGetResponse),
    _m("KvPut", F.KvPutRequest, F.KvPutResponse),
    _m("CacheRemoteObjectToLocalCluster", F.CacheRemoteObjectToLocalClusterRequest,
       F.CacheRemoteObjectToLocalClusterResponse),
    _m("Ping", F.PingRequest, F.PingResponse),
    # metadata ring proxy: a shard serves the ring it is routing under,
    # so gateways bootstrap from their seed filer without ever holding
    # a master address
    _m("GetMetaRing", meta_ring_pb2.GetMetaRingRequest,
       meta_ring_pb2.MetaRingResponse),
])


def tikv_pd_service():
    """pdpb.PD subset (proto/tikv_pd.proto) — real kvproto names, so
    the stub talks to an actual Placement Driver unchanged."""
    from . import tikv_pd_pb2 as P

    return ("pdpb.PD", [
        _m("GetMembers", P.GetMembersRequest, P.GetMembersResponse),
        _m("GetRegion", P.GetRegionRequest, P.GetRegionResponse),
        _m("GetStore", P.GetStoreRequest, P.GetStoreResponse),
    ])


def tikv_service():
    """tikvpb.Tikv RawKV subset (proto/tikv_rpc.proto)."""
    from . import tikv_kvrpc_pb2 as K

    return ("tikvpb.Tikv", [
        _m("RawGet", K.RawGetRequest, K.RawGetResponse),
        _m("RawPut", K.RawPutRequest, K.RawPutResponse),
        _m("RawDelete", K.RawDeleteRequest, K.RawDeleteResponse),
        _m("RawScan", K.RawScanRequest, K.RawScanResponse),
        _m("RawDeleteRange", K.RawDeleteRangeRequest,
           K.RawDeleteRangeResponse),
    ])


def ydb_table_service():
    """Ydb.Table.V1.TableService subset (proto/ydb_table_v1.proto) —
    real package/service names, so method paths and Any type_urls
    match an actual YDB endpoint."""
    from . import ydb_table_pb2 as Y

    return ("Ydb.Table.V1.TableService", [
        _m("CreateSession", Y.CreateSessionRequest,
           Y.CreateSessionResponse),
        _m("DeleteSession", Y.DeleteSessionRequest,
           Y.DeleteSessionResponse),
        _m("ExecuteDataQuery", Y.ExecuteDataQueryRequest,
           Y.ExecuteDataQueryResponse),
        _m("ExecuteSchemeQuery", Y.ExecuteSchemeQueryRequest,
           Y.ExecuteSchemeQueryResponse),
    ])


def etcd_kv_service():
    """etcdserverpb.KV subset (proto/etcd_kv.proto) — names match the
    real etcd v3 API so the stub talks to an actual etcd unchanged.
    Lazy: the etcd store is the only consumer."""
    from . import etcd_kv_pb2 as E

    return ("etcdserverpb.KV", [
        _m("Range", E.RangeRequest, E.RangeResponse),
        _m("Put", E.PutRequest, E.PutResponse),
        _m("DeleteRange", E.DeleteRangeRequest, E.DeleteRangeResponse),
    ])


# -- generic stub / servicer -----------------------------------------------

class InjectedRpcError(grpc.RpcError):
    """Synthetic RpcError raised by an armed `pb.<Method>` failpoint —
    carries a status code so client-side retry classification treats it
    exactly like a real transport failure."""

    def __init__(self, status_code, details: str):
        self._code = status_code
        self._details = details
        super().__init__(f"{status_code}: {details}")

    def code(self):
        return self._code

    def details(self):
        return self._details


def _failpoint_guard(fn, method_name: str, address: str):
    """Per-call chaos hook + trace-context injection. An armed failpoint
    named `pb.<Method>` (optionally @-matched against the dialed
    address) surfaces as gRPC UNAVAILABLE before the wire is touched.
    One dict probe when the registry is empty — negligible against
    marshalling costs. The ctx comma-terminates the address (failpoint
    ctx convention) so a match for port 1234 cannot substring-hit port
    12345.

    Tracing: when the calling thread is inside a span, its
    W3C `traceparent` rides the call as gRPC metadata — every stub in
    the process propagates context with zero per-callsite wiring."""
    name = f"pb.{method_name}"
    ctx = f"{address},"

    def call(*args, **kwargs):
        try:
            failpoint.fail(name, ctx=ctx)
        except failpoint.FailpointError as e:
            raise InjectedRpcError(grpc.StatusCode.UNAVAILABLE, str(e))
        tp = trace.traceparent()
        if tp:
            md = list(kwargs.get("metadata") or ())
            md.append((trace.TRACEPARENT, tp))
            kwargs["metadata"] = md
        return fn(*args, **kwargs)

    return call


class Stub:
    """Callable-per-method client stub built from a service descriptor."""

    def __init__(self, channel: grpc.Channel, service, address: str = ""):
        full_name, methods = service
        for m in methods:
            path = f"/{full_name}/{m['name']}"
            if m["cs"] and m["ss"]:
                fn = channel.stream_stream(path, m["req"].SerializeToString, m["resp"].FromString)
            elif m["ss"]:
                fn = channel.unary_stream(path, m["req"].SerializeToString, m["resp"].FromString)
            elif m["cs"]:
                fn = channel.stream_unary(path, m["req"].SerializeToString, m["resp"].FromString)
            else:
                fn = channel.unary_unary(path, m["req"].SerializeToString, m["resp"].FromString)
            setattr(self, m["name"], _failpoint_guard(fn, m["name"], address))


def add_servicer(server: grpc.Server, service, servicer,
                 component: str | None = None, address: str = ""):
    """Register `servicer` (an object with one method per RPC name) for the
    given descriptor on a grpc.Server. With `component`, and ONLY when
    that component's server TLS actually loads (the reference returns
    creds+authenticator together from LoadServerTLS and neither on
    failure, tls.go:26-87), every handler first validates the mTLS
    peer's common name against [grpc.<component>].allowed_commonNames /
    grpc.allowed_wildcard_domain (tls.go:64-76).

    -> the loaded grpc.ServerCredentials (or None). Pass them to
    serve_port so the port binds from the SAME config read that armed
    the authenticator — re-reading there would open a drift window
    (cert rotation mid-start = CN checks active on a plaintext port)."""
    auth = None
    creds = None
    if component is not None:
        from ..security.tls import (
            load_authenticator,
            load_server_credentials,
        )
        from ..utils.config import load_config

        conf = load_config("security")  # ONE read feeds both
        creds = load_server_credentials(component, conf)
        if creds is not None:
            auth = load_authenticator(component, conf)
    full_name, methods = service
    handlers = {}

    def guarded(behavior, streaming: bool):
        if auth is None or not auth.active:
            return behavior
        if streaming:
            def stream_wrap(request, context):
                auth.check_context(context)
                yield from behavior(request, context)
            return stream_wrap

        def unary_wrap(request, context):
            auth.check_context(context)
            return behavior(request, context)
        return unary_wrap

    def traced(behavior, method_name: str, streaming: bool):
        """Server-side trace extraction: a handler runs under
        a span ONLY when the caller sent `traceparent` metadata — roots
        belong to the ingress planes, not to heartbeat/background RPC
        chatter. Streaming handlers use non-activating spans: their
        generator bodies suspend mid-`with`, and an activated span
        would leak this worker thread's TLS between resumptions."""
        name = f"grpc.{method_name}"

        def metadata_of(context):
            try:
                return context.invocation_metadata()
            # lint: allow-broad-except(tracing must never fail a call; the call
            # runs untraced)
            except Exception:  # noqa: BLE001 — tracing must never fail a call
                return None

        if streaming:
            def stream_wrap(request, context):
                md = metadata_of(context)
                if not trace.carrier_has_context(md):
                    yield from behavior(request, context)
                    return
                with trace.span(name, carrier=md, component=component or "",
                                server=address, activate=False):
                    yield from behavior(request, context)
            return stream_wrap

        def unary_wrap(request, context):
            md = metadata_of(context)
            if not trace.carrier_has_context(md):
                return behavior(request, context)
            with trace.span(name, carrier=md, component=component or "",
                            server=address):
                return behavior(request, context)
        return unary_wrap

    for m in methods:
        behavior = traced(guarded(getattr(servicer, m["name"]), m["ss"]),
                          m["name"], m["ss"])
        kw = dict(request_deserializer=m["req"].FromString,
                  response_serializer=m["resp"].SerializeToString)
        if m["cs"] and m["ss"]:
            h = grpc.stream_stream_rpc_method_handler(behavior, **kw)
        elif m["ss"]:
            h = grpc.unary_stream_rpc_method_handler(behavior, **kw)
        elif m["cs"]:
            h = grpc.stream_unary_rpc_method_handler(behavior, **kw)
        else:
            h = grpc.unary_unary_rpc_method_handler(behavior, **kw)
        handlers[m["name"]] = h
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(full_name, handlers),)
    )
    return creds


def new_server(max_workers: int = 32) -> grpc.Server:
    return grpc.server(
        futures.ThreadPoolExecutor(max_workers=max_workers),
        options=_CHANNEL_OPTIONS,
    )


# -- channel cache (grpc_client_server.go:95-122) --------------------------

_channels: dict[str, grpc.Channel] = {}
_channels_lock = threading.Lock()
# Outbound mTLS credentials from security.toml, loaded once
# (LoadClientTLS, security/tls.go:89); None = plaintext. Resolution
# order: [grpc.client], then the first configured server component —
# the reference dials with the CALLING component's cert (master dials
# as grpc.master etc.); one process here can host several components
# behind this shared channel cache, so it presents ONE client identity,
# preferring the dedicated [grpc.client] pair. Server-only configs
# (no [grpc.client]) still dial secured instead of being locked out.
_client_creds: grpc.ChannelCredentials | None = None
_client_creds_loaded = False


def _client_credentials_locked() -> grpc.ChannelCredentials | None:
    """Resolve/cache outbound creds; _channels_lock must be held."""
    global _client_creds, _client_creds_loaded
    if not _client_creds_loaded:
        from ..security.tls import load_client_credentials

        for component in ("client", "master", "volume", "filer",
                          "msg_broker", "s3"):
            _client_creds = load_client_credentials(component)
            if _client_creds is not None:
                break
        _client_creds_loaded = True
    return _client_creds


def cached_channel(address: str) -> grpc.Channel:
    # creds resolve under the SAME lock hold that fills the cache, so a
    # concurrent reset_channels() can't interleave and seed the fresh
    # cache with stale credentials
    with _channels_lock:
        ch = _channels.get(address)
        if ch is None:
            creds = _client_credentials_locked()
            if creds is not None:
                ch = grpc.secure_channel(address, creds,
                                         options=_CHANNEL_OPTIONS)
            else:
                ch = grpc.insecure_channel(address,
                                           options=_CHANNEL_OPTIONS)
            _channels[address] = ch
        return ch


def reset_channels() -> None:
    global _client_creds, _client_creds_loaded
    with _channels_lock:
        for ch in _channels.values():
            ch.close()
        _channels.clear()
        _client_creds = None
        _client_creds_loaded = False


_UNSET = object()


def serve_port(server: grpc.Server, address: str, component: str,
               creds=_UNSET) -> int:
    """Bind a server port with [grpc.<component>] mutual TLS when
    security.toml configures it, plaintext otherwise (the LoadServerTLS
    dispatch every reference server runs at startup). Pass the creds
    add_servicer returned to bind from the same config read; omitted,
    they load fresh here."""
    if creds is _UNSET:
        from ..security.tls import load_server_credentials

        creds = load_server_credentials(component)
    if creds is not None:
        return server.add_secure_port(address, creds)
    return server.add_insecure_port(address)


def derived_grpc_port(http_port: int) -> int:
    """gRPC port for an HTTP port: +10000 (server_address.go convention),
    wrapping downward when that would pass the 65535 port ceiling."""
    p = http_port + GRPC_PORT_DELTA
    return p if p <= 65535 else http_port - GRPC_PORT_DELTA


def derived_admin_port(http_port: int) -> int:
    """Native-plane admin listener for a public port: +11000, wrapping
    downward past the ceiling (same rule as derived_grpc_port, offset
    chosen not to collide with the gRPC shadow)."""
    p = http_port + 11000
    return p if p <= 65535 else http_port - 11000


def grpc_address(http_address: str) -> str:
    """HTTP host:port -> gRPC host:port (+10000 convention)."""
    host, _, port = http_address.rpartition(":")
    return f"{host}:{derived_grpc_port(int(port))}"


def master_stub(address: str) -> Stub:
    return Stub(cached_channel(address), MASTER_SERVICE, address)


def volume_stub(address: str) -> Stub:
    return Stub(cached_channel(address), VOLUME_SERVICE, address)


MQ_SERVICE = ("messaging_pb.SeaweedMessaging", [
    _m("FindBrokerLeader", mq_pb2.FindBrokerLeaderRequest, mq_pb2.FindBrokerLeaderResponse),
    _m("AssignSegmentBrokers", mq_pb2.AssignSegmentBrokersRequest, mq_pb2.AssignSegmentBrokersResponse),
    _m("CheckSegmentStatus", mq_pb2.CheckSegmentStatusRequest, mq_pb2.CheckSegmentStatusResponse),
    _m("CheckBrokerLoad", mq_pb2.CheckBrokerLoadRequest, mq_pb2.CheckBrokerLoadResponse),
    _m("Publish", mq_pb2.PublishRequest, mq_pb2.PublishResponse, cs=True, ss=True),
    _m("Subscribe", mq_pb2.SubscribeRequest, mq_pb2.SubscribeResponse, ss=True),
])

S3_SERVICE = ("s3_pb.SeaweedS3", [
    _m("Configure", s3_pb2.S3ConfigureRequest, s3_pb2.S3ConfigureResponse),
])

MOUNT_SERVICE = ("mount_pb.SeaweedMount", [
    _m("Configure", mount_pb2.ConfigureRequest, mount_pb2.ConfigureResponse),
])

# SeaweedIdentityAccessManagement declares no RPCs (iam.proto:11-13); the
# table is kept so that add_servicer accepts it.
IAM_SERVICE = ("iam_pb.SeaweedIdentityAccessManagement", [])


def filer_stub(address: str) -> Stub:
    return Stub(cached_channel(address), FILER_SERVICE, address)


def mq_stub(address: str) -> Stub:
    return Stub(cached_channel(address), MQ_SERVICE, address)


def s3_stub(address: str) -> Stub:
    return Stub(cached_channel(address), S3_SERVICE, address)


def mount_stub(address: str) -> Stub:
    return Stub(cached_channel(address), MOUNT_SERVICE, address)
