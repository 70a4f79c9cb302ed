"""EC lifecycle commands: ec.encode / ec.rebuild / ec.balance / ec.decode.

Counterpart of seaweedfs_tpu/shell/commands/ec.py (SeaweedFS
weed/shell/command_ec_encode.go:57-188, command_ec_rebuild.go:58-230,
command_ec_balance.go, command_ec_decode.go). The encode hot loop itself
runs on the volume server's coder (the CUDA kernels by default); these
commands orchestrate the shard lifecycle over gRPC exactly like the
reference shell does.

Addition over SeaweedFS: `-geometry` and `-dataShards/-parityShards`
flags (SeaweedFS hard-codes 10+4).

`ec.encode` streams by default, as the reference does: placement is
planned first, and one VolumeEcShardsGenerateStreamed on the source
pushes each destination's shards to it while the product runs
(storage/ec_stream.py). `-stream 0`, or `SWFS_EC_STREAM=0` in the
environment, selects the generate-then-copy path.
"""

from __future__ import annotations

import argparse
import os
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor

from ...pb import (
    ec_geometry_pb2 as eg,
    ec_stream_pb2 as es,
    master_pb2,
    volume_server_pb2 as vs,
)
from ..registry import command


def _collect_ec_nodes(env, topo=None):
    """-> [(url, free_slots, shard_count)] sorted by free slots desc
    (collectEcNodes / sortEcNodesByFreeslotsDecending)."""
    nodes = []
    for dn in env.collect_data_nodes(topo):
        free = shards = 0
        for disk in dn.disk_infos.values():
            free += disk.free_volume_count
            for e in disk.ec_shard_infos:
                shards += bin(e.ec_index_bits).count("1")
        nodes.append([dn.id, free, shards])
    nodes.sort(key=lambda n: -n[1])
    return nodes


def _volume_locations(env, vid: int) -> list[str]:
    resp = env.master_stub().LookupVolume(
        master_pb2.LookupVolumeRequest(volume_or_file_ids=[str(vid)]), timeout=10)
    for e in resp.volume_id_locations:
        return [l.url for l in e.locations]
    return []


def _ec_shard_holders(env, vid: int) -> dict[int, list[str]]:
    resp = env.master_stub().LookupEcVolume(
        master_pb2.LookupEcVolumeRequest(volume_id=vid), timeout=10)
    return {sl.shard_id: [l.url for l in sl.locations]
            for sl in resp.shard_id_locations}


@command("ec.encode", "erasure-code one volume (or a whole collection)")
def ec_encode(env, args, out):
    p = argparse.ArgumentParser(prog="ec.encode")
    p.add_argument("-volumeId", type=int, default=0)
    p.add_argument("-collection", default="")
    p.add_argument("-fullPercent", type=float, default=95.0)
    p.add_argument("-dataShards", type=int, default=0)
    p.add_argument("-parityShards", type=int, default=0)
    p.add_argument("-geometry", default="",
                   help="code geometry name from the registry "
                        "(models/geometry.py), e.g. rs_10_4 (default) or "
                        "lrc_10_2_2 — locally-repairable: single-shard "
                        "repair reads 5 survivors instead of 10")
    p.add_argument("-parallelCopy", type=int, default=10)
    p.add_argument("-parallelEncode", type=int, default=4,
                   help="volumes erasure-coded concurrently; concurrent "
                        "VolumeEcShardsGenerate pipelines on one server "
                        "coalesce into stacked device dispatches "
                        "(ops/dispatch.py)")
    p.add_argument("-stream", type=int, default=None, choices=(0, 1),
                   help="pipelined encode+distribute: placement "
                        "is computed BEFORE encoding and each "
                        "destination's shards stream to it while the GF "
                        "product runs (default on; env escape hatch "
                        "SWFS_EC_STREAM=0). 0 = classic "
                        "generate-then-copy")
    opts = p.parse_args(args)
    env.confirm_is_locked()
    _validate_geometry_opt(opts, out)

    from ...utils import trace

    vids = ([opts.volumeId] if opts.volumeId
            else _collect_full_volume_ids(env, opts.collection, opts.fullPercent))
    if not vids:
        print("no volumes qualify for ec encoding", file=out)
        return
    if opts.parallelEncode <= 1 or len(vids) == 1:
        for vid in vids:
            # root a trace per conversion: the generate/stream RPCs and
            # every destination's sink work become one dumpable tree
            with trace.span("shell.ec.encode", component="shell",
                            vid=vid) as tsp:
                _do_ec_encode(env, vid, opts, out)
            if tsp.trace_id:
                print(f"trace {tsp.trace_id} "
                      f"(trace.dump -trace={tsp.trace_id})", file=out)
        return
    # encode volumes concurrently: the per-volume shard lifecycle is
    # independent, and overlapping the servers' encode pipelines is what
    # lets the EC dispatch scheduler amortize device round-trips across
    # volumes. Placement shares one in-flight load ledger — concurrent
    # encoders see the same pre-copy topology snapshot, so without it
    # every thread would crown the same emptiest node/rack and pile all
    # volumes' shards there. Failures surface after every volume had its
    # attempt.
    errors: list[tuple[int, Exception]] = []
    shared = _SharedPlacement()

    def one(vid):
        try:
            with trace.span("shell.ec.encode", component="shell",
                            vid=vid):
                _do_ec_encode(env, vid, opts, out, shared=shared)
        # lint: allow-broad-except(each volume's failure is kept and
        # re-raised once every volume had its attempt)
        except Exception as e:  # KeyboardInterrupt/SystemExit still abort
            errors.append((vid, e))

    with ThreadPoolExecutor(max_workers=opts.parallelEncode) as ex:
        list(ex.map(one, vids))
    for vid, e in errors:
        print(f"volume {vid}: ec encode failed: {e}", file=out)
    if errors:
        raise errors[0][1]


def _collect_full_volume_ids(env, collection: str, full_percent: float) -> list[int]:
    """Full + quiet volumes (collectVolumeIdsForEcEncode,
    command_ec_encode.go:271)."""
    resp = env.volume_list()
    limit = resp.volume_size_limit_mb * 1024 * 1024
    vids = []
    for dn in env.collect_data_nodes():
        for disk in dn.disk_infos.values():
            for v in disk.volume_infos:
                if collection and v.collection != collection:
                    continue
                if limit and v.size >= limit * full_percent / 100.0:
                    vids.append(v.id)
    return sorted(set(vids))


class _SharedPlacement:
    """Cross-thread ledger of shard placements already decided by THIS
    ec.encode invocation but not yet visible in topology heartbeats:
    node/rack counts that concurrent volumes' placement loops fold into
    their sort keys so the load spreads instead of piling onto whichever
    node the shared stale snapshot ranks emptiest."""

    def __init__(self):
        import threading

        self.lock = threading.Lock()
        self.node_load: dict[str, int] = defaultdict(int)
        self.rack_load: dict[tuple[str, str], int] = defaultdict(int)


def _validate_geometry_opt(opts, out) -> None:
    """Registry-backed -geometry validation: fail fast in the
    shell, before any replica is frozen, with the registered names in
    the error."""
    if not getattr(opts, "geometry", ""):
        return
    from ...models import geometry as geom_mod

    try:
        cg = geom_mod.get(opts.geometry)
    except ValueError as e:
        print(str(e), file=out)
        raise
    if not cg.volume_capable:
        msg = (f"geometry {opts.geometry!r} is not volume-capable "
               f"(stripe-level codec only); volume-capable: "
               f"{[n for n in geom_mod.names() if geom_mod.get(n).volume_capable]}")
        print(msg, file=out)
        raise ValueError(msg)
    if (opts.dataShards and opts.dataShards != cg.data_shards) or \
            (opts.parityShards and opts.parityShards != cg.parity_shards):
        msg = (f"geometry {opts.geometry!r} is {cg.data_shards}+"
               f"{cg.parity_shards}; -dataShards/-parityShards disagree")
        print(msg, file=out)
        raise ValueError(msg)


def _geometry_total_shards(opts) -> int:
    if getattr(opts, "geometry", ""):
        from ...models import geometry as geom_mod

        return geom_mod.get(opts.geometry).total_shards
    return (opts.dataShards or 10) + (opts.parityShards or 4)


def _stream_enabled(opts) -> bool:
    """-stream flag wins; else SWFS_EC_STREAM env (default on)."""
    if getattr(opts, "stream", None) is not None:
        return bool(opts.stream)
    return os.environ.get("SWFS_EC_STREAM", "1").lower() not in (
        "0", "false", "off")


def _plan_placement(env, total_shards: int, shared) -> dict[str, list[int]]:
    """Spread shards across servers (balancedEcDistribution), rack-aware:
    losing one rack must cost as few shards of this volume as possible
    (SeaweedFS README's "rack-aware placement";
    pickRackToBalanceShardsInto in command_ec_balance.go). In streaming
    mode this runs BEFORE the encode so shard bytes go straight to their
    destinations."""
    topo = env.volume_list().topology_info  # one snapshot for both views
    nodes = _collect_ec_nodes(env, topo)
    if not nodes:
        raise ValueError("no ec-capable nodes")
    racks = env.node_racks(topo)
    alloc: dict[str, list[int]] = defaultdict(list)
    rack_load: dict[tuple[str, str], int] = defaultdict(int)
    with shared.lock:
        for sid in range(total_shards):
            nodes.sort(key=lambda n: (
                rack_load[racks.get(n[0], ("", n[0]))]
                + shared.rack_load[racks.get(n[0], ("", n[0]))],
                len(alloc[n[0]]) + shared.node_load[n[0]],
                -n[1]))
            chosen = nodes[0][0]
            alloc[chosen].append(sid)
            rack_load[racks.get(chosen, ("", chosen))] += 1
        for node, sids in alloc.items():
            shared.node_load[node] += len(sids)
            shared.rack_load[racks.get(node, ("", node))] += len(sids)
    return alloc


def _do_ec_encode(env, vid: int, opts, out, shared=None) -> None:
    locations = _volume_locations(env, vid)
    if not locations:
        raise ValueError(f"volume {vid} not found in topology")
    source = locations[0]
    collection = opts.collection or _find_collection(env, vid)
    total_shards = _geometry_total_shards(opts)
    if shared is None:
        shared = _SharedPlacement()  # serial path: ledger is a no-op
    stream = _stream_enabled(opts)

    # 1. freeze writes on every replica (markVolumeReplicasWritable false)
    frozen: list[str] = []
    for addr in locations:
        env.volume_stub(addr).VolumeMarkReadonly(
            vs.VolumeMarkReadonlyRequest(volume_id=vid), timeout=30)
        frozen.append(addr)

    # 2+3. generate + distribute + mount. Any failure BEFORE the plain
    # volume is deleted rolls the replicas back to writable — the
    # conversion never happened, so the volume must not stay frozen.
    try:
        if stream:
            alloc = _do_stream_encode(env, vid, collection, source,
                                      total_shards, opts, shared, out)
        else:
            alloc = _do_copy_encode(env, vid, collection, source,
                                    total_shards, opts, shared, out)
    except BaseException:
        for addr in frozen:
            try:
                env.volume_stub(addr).VolumeMarkWritable(
                    vs.VolumeMarkWritableRequest(volume_id=vid),
                    timeout=30)
            # lint: allow-broad-except(best-effort rollback; the encode's
            # own failure is re-raised below)
            except Exception:  # noqa: BLE001 — best-effort rollback
                pass
        raise

    # 4. retire moved shards from source + delete the plain volume
    moved = [sid for t, sids in alloc.items() if t != source for sid in sids]
    if moved:
        env.volume_stub(source).VolumeEcShardsDelete(
            vs.VolumeEcShardsDeleteRequest(
                volume_id=vid, collection=collection, shard_ids=moved),
            timeout=60)
    for addr in locations:
        env.volume_stub(addr).VolumeDelete(
            vs.VolumeDeleteRequest(volume_id=vid), timeout=60)
    spread = {t: sids for t, sids in alloc.items() if sids}
    print(f"volume {vid}: shards spread {dict(spread)}", file=out)


def _cleanup_targets(env, vid, collection, targets) -> None:
    """Best-effort unwind of a failed distribute: unmount + delete this
    volume's shards at every target so no destination keeps serving (or
    advertising) EC shards of a volume whose conversion is being rolled
    back to plain replicas."""
    for target in targets:
        try:
            env.volume_stub(target).VolumeEcShardsUnmount(
                vs.VolumeEcShardsUnmountRequest(
                    volume_id=vid, shard_ids=list(range(32))), timeout=60)
        # lint: allow-broad-except(best-effort unwind: nothing may be
        # mounted yet, and the caller re-raises the encode's failure)
        except Exception:  # noqa: BLE001 — nothing may be mounted yet
            pass
        try:
            env.volume_stub(target).VolumeEcShardsDelete(
                vs.VolumeEcShardsDeleteRequest(
                    volume_id=vid, collection=collection,
                    shard_ids=list(range(32))), timeout=60)
        # lint: allow-broad-except(best-effort unwind, as above)
        except Exception:  # noqa: BLE001 — best-effort cleanup
            pass


def _do_copy_encode(env, vid, collection, source, total_shards, opts,
                    shared, out) -> dict[str, list[int]]:
    """Classic three-phase path: generate all shards on the source, THEN
    copy them to their destinations, then mount."""
    env.volume_stub(source).VolumeEcShardsGenerate(
        eg.EcGenerateRequest(
            volume_id=vid, collection=collection,
            data_shards=opts.dataShards, parity_shards=opts.parityShards,
            geometry=getattr(opts, "geometry", "")),
        timeout=24 * 3600)
    print(f"volume {vid}: generated {total_shards} shards on {source}"
          + (f" ({opts.geometry})" if getattr(opts, "geometry", "")
             else ""),
          file=out)
    alloc = _plan_placement(env, total_shards, shared)

    def copy_to(target_and_sids):
        target, sids = target_and_sids
        if target != source:
            env.volume_stub(target).VolumeEcShardsCopy(
                vs.VolumeEcShardsCopyRequest(
                    volume_id=vid, collection=collection, shard_ids=sids,
                    copy_ecx_file=True, copy_ecj_file=True, copy_vif_file=True,
                    source_data_node=source), timeout=3600)
        env.volume_stub(target).VolumeEcShardsMount(
            vs.VolumeEcShardsMountRequest(
                volume_id=vid, collection=collection, shard_ids=sids),
            timeout=60)

    try:
        with ThreadPoolExecutor(max_workers=max(1, opts.parallelCopy)) as ex:
            list(ex.map(copy_to, alloc.items()))
    except BaseException:
        # one target's copy/mount failed AFTER others may have mounted:
        # un-advertise everything before the caller restores the plain
        # replicas to writable, or stale EC locations would shadow them
        _cleanup_targets(env, vid, collection,
                         [t for t in alloc if t != source])
        raise
    return alloc


def _do_stream_encode(env, vid, collection, source, total_shards, opts,
                      shared, out) -> dict[str, list[int]]:
    """Pipelined path: placement FIRST, then one
    VolumeEcShardsGenerateStreamed that encodes and pushes each remote
    destination's shards to it while the GF matmul is still running. A
    destination the stream could not finish (even after slab-range
    resume) falls back to the classic copy — the source holds all shard
    files either way, so the conversion still completes."""
    alloc = _plan_placement(env, total_shards, shared)
    req = es.VolumeEcShardsGenerateStreamedRequest(
        volume_id=vid, collection=collection,
        data_shards=opts.dataShards, parity_shards=opts.parityShards,
        geometry=getattr(opts, "geometry", ""))
    for target, sids in alloc.items():
        if target != source and sids:
            req.targets.add(address=target, shard_ids=sids)
    try:
        resp = env.volume_stub(source).VolumeEcShardsGenerateStreamed(
            req, timeout=24 * 3600)
    except BaseException:
        # destinations may hold partially streamed .ecXX files with no
        # .ecx — clean them best-effort so a failed encode leaks
        # neither disk nor a stale shard set (the outer handler still
        # restores replica writability)
        _cleanup_targets(env, vid, collection,
                         [t.address for t in req.targets])
        raise
    failed = {r.address for r in resp.targets if not r.ok}
    resumed = sum(r.resumes for r in resp.targets)
    print(f"volume {vid}: streamed {total_shards} shards from {source} "
          f"({resp.bytes_streamed} bytes overlapped, overlap ratio "
          f"{resp.overlap_ratio:.2f}"
          + (f", {resumed} resume(s)" if resumed else "")
          + (f", fallback copy for {sorted(failed)}" if failed else "")
          + ")", file=out)

    def finish_target(target_and_sids):
        target, sids = target_and_sids
        if target != source:
            # streamed destinations only need the index files; failed
            # ones pull their shard bytes too (generate-then-copy)
            env.volume_stub(target).VolumeEcShardsCopy(
                vs.VolumeEcShardsCopyRequest(
                    volume_id=vid, collection=collection,
                    shard_ids=sids if target in failed else [],
                    copy_ecx_file=True, copy_ecj_file=True,
                    copy_vif_file=True, source_data_node=source),
                timeout=3600)
        env.volume_stub(target).VolumeEcShardsMount(
            vs.VolumeEcShardsMountRequest(
                volume_id=vid, collection=collection, shard_ids=sids),
            timeout=60)

    try:
        with ThreadPoolExecutor(max_workers=max(1, opts.parallelCopy)) as ex:
            list(ex.map(finish_target, alloc.items()))
    except BaseException:
        # mirror of _do_copy_encode: a failed mount/index-copy must not
        # leave other destinations' already-mounted shards advertised
        # while the plain replicas come back writable
        _cleanup_targets(env, vid, collection,
                         [t for t in alloc if t != source])
        raise
    return alloc


def _find_collection(env, vid: int) -> str:
    for dn in env.collect_data_nodes():
        for disk in dn.disk_infos.values():
            for v in disk.volume_infos:
                if v.id == vid:
                    return v.collection
    return ""


@command("ec.rebuild", "rebuild missing EC shards from survivors")
def ec_rebuild(env, args, out):
    p = argparse.ArgumentParser(prog="ec.rebuild")
    p.add_argument("-collection", default="")
    p.add_argument("-volumeId", type=int, default=0)
    opts = p.parse_args(args)
    env.confirm_is_locked()

    from ...models import geometry as geom_mod

    vols = _all_ec_volumes(env, opts.collection)
    for vid, holders in sorted(vols.items()):
        if opts.volumeId and vid != opts.volumeId:
            continue
        collection = _find_ec_collection(env, vid)
        d, p, code = _ec_geometry(env, vid, holders, collection)
        if not code:
            # no holder's .vif was readable: planning blind would copy a
            # survivor set the rebuilding node may not be able to solve from
            print(f"volume {vid}: cannot read volume geometry (.vif) "
                  f"from any shard holder — skipping rebuild", file=out)
            continue
        total = d + p
        present = set(holders)
        if len(present) >= total:
            continue
        geom = geom_mod.get(code)
        missing = tuple(i for i in range(total) if i not in present)
        try:
            plan = geom.repair_plan(missing, tuple(sorted(present)))
        except (geom_mod.UnsolvableError, ValueError):
            print(f"volume {vid} ({code}): only {len(present)} shards "
                  f"left, cannot rebuild {list(missing)}", file=out)
            continue
        _rebuild_one(env, vid, holders, missing, plan, code, collection,
                     out)


def _all_ec_volumes(env, collection: str = "",
                    topo=None) -> dict[int, dict[int, list[str]]]:
    """vid -> shard -> [holders] from topology (EcShardMap.registerEcNode)."""
    vols: dict[int, dict[int, list[str]]] = defaultdict(lambda: defaultdict(list))
    for dn in env.collect_data_nodes(topo):
        for disk in dn.disk_infos.values():
            for e in disk.ec_shard_infos:
                if collection and e.collection != collection:
                    continue
                for sid in range(32):
                    if e.ec_index_bits >> sid & 1:
                        vols[e.id][sid].append(dn.id)
    return {vid: dict(m) for vid, m in vols.items()}


def _ec_vif(env, vid: int, holders: dict[int, list[str]],
            collection: str) -> dict:
    """Read the volume's .vif sidecar from any shard holder over the
    CopyFile RPC — the shard-set metadata (shard counts AND code
    geometry) is readable without mounting anything."""
    import json

    addrs = sorted({a for hs in holders.values() for a in hs})
    for addr in addrs:
        buf = bytearray()
        try:
            for chunk in env.volume_stub(addr).CopyFile(
                    vs.CopyFileRequest(
                        volume_id=vid, ext=".vif", collection=collection,
                        is_ec_volume=True,
                        ignore_source_file_not_found=True), timeout=30):
                buf += chunk.file_content
        # lint: allow-broad-except(an unreachable holder or a missing
        # .vif moves on to the next holder)
        except Exception:  # noqa: BLE001 — try the next holder
            continue
        if buf:
            try:
                return json.loads(bytes(buf))
            except ValueError:
                continue
    return {}


def _ec_geometry(env, vid: int, holders=None, collection="") -> tuple:
    """(data, parity, code_name) from a holder's .vif.

    code_name is "" when NO holder's .vif could be read — callers that
    PLAN from the geometry (ec.rebuild) must treat that as an error
    rather than assume RS: mis-planning an lrc volume as rs copies a
    survivor set the rebuilding node cannot solve from. (A .vif that parses
    but predates the geometry field is legitimately RS.)"""
    vif = _ec_vif(env, vid, holders or {}, collection) if holders else {}
    if not vif:
        return 10, 4, ""
    d = vif.get("dataShards", 10)
    p = vif.get("parityShards", 4)
    return d, p, vif.get("geometry", "") or f"rs_{d}_{p}"


def _rebuild_one(env, vid: int, holders: dict[int, list[str]],
                 missing: tuple[int, ...], plan, code: str,
                 collection: str, out) -> None:
    # the rebuilding node: most free slots (command_ec_rebuild.go:132)
    rebuild_node = _collect_ec_nodes(env)[0][0]
    local = {sid for sid, hs in holders.items() if rebuild_node in hs}
    # minimal-read copy set: only the survivors the repair
    # plan actually reads travel to the rebuilding node — under lrc_10_2_2 a
    # single lost group shard moves 5 shards' bytes, not 10-13
    to_copy = [sid for sid in plan.reads
               if sid not in local and holders.get(sid)]
    copied = []
    for sid in to_copy:
        env.volume_stub(rebuild_node).VolumeEcShardsCopy(
            vs.VolumeEcShardsCopyRequest(
                volume_id=vid, collection=collection, shard_ids=[sid],
                copy_ecx_file=not local and not copied,
                copy_ecj_file=not local and not copied,
                copy_vif_file=not local and not copied,
                source_data_node=holders[sid][0]), timeout=3600)
        copied.append(sid)
    resp = env.volume_stub(rebuild_node).VolumeEcShardsRebuild(
        eg.EcRebuildRequest(volume_id=vid, collection=collection,
                            shard_ids=list(missing)),
        timeout=24 * 3600)
    rebuilt = list(resp.rebuilt_shard_ids)
    env.volume_stub(rebuild_node).VolumeEcShardsMount(
        vs.VolumeEcShardsMountRequest(volume_id=vid, collection=collection,
                                      shard_ids=rebuilt), timeout=60)
    # drop the temporary survivor copies, keep what was rebuilt + already local
    drop = [sid for sid in copied if sid not in rebuilt]
    if drop:
        env.volume_stub(rebuild_node).VolumeEcShardsDelete(
            vs.VolumeEcShardsDeleteRequest(volume_id=vid, collection=collection,
                                           shard_ids=drop), timeout=60)
    geom_used = getattr(resp, "geometry", "") or code
    print(f"volume {vid}: rebuilt shards {rebuilt} on {rebuild_node} "
          f"(geometry {geom_used}, read {len(plan.reads)} survivors, "
          f"{resp.survivor_bytes_read} bytes)", file=out)


def _find_ec_collection(env, vid: int) -> str:
    for dn in env.collect_data_nodes():
        for disk in dn.disk_infos.values():
            for e in disk.ec_shard_infos:
                if e.id == vid:
                    return e.collection
    return ""


@command("ec.balance", "even out EC shard distribution across servers")
def ec_balance(env, args, out):
    p = argparse.ArgumentParser(prog="ec.balance")
    p.add_argument("-collection", default="")
    p.add_argument("-apply", action="store_true",
                   help="actually move shards (dry-run by default)")
    opts = p.parse_args(args)
    env.confirm_is_locked()

    topo = env.volume_list().topology_info  # one snapshot for all views
    vols = _all_ec_volumes(env, opts.collection, topo)
    shard_count: dict[str, int] = defaultdict(int)
    for vid, m in vols.items():
        for sid, hs in m.items():
            for h in hs:
                shard_count[h] += 1
    nodes = [n[0] for n in _collect_ec_nodes(env, topo)]
    for n in nodes:
        shard_count.setdefault(n, 0)
    if not shard_count:
        print("no ec shards in cluster", file=out)
        return
    avg = sum(shard_count.values()) / len(shard_count)
    racks = env.node_racks(topo)
    moves = []
    for vid, m in sorted(vols.items()):
        collection = _find_ec_collection(env, vid)
        # rack -> how many of THIS volume's shards it already holds
        vol_rack: dict[tuple[str, str], int] = defaultdict(int)
        for sid, hs in m.items():
            for h in hs:
                vol_rack[racks.get(h, ("", h))] += 1
        for sid, hs in sorted(m.items()):
            src = hs[0]
            if shard_count[src] <= avg + 1:
                continue
            # among nodes with headroom, prefer the emptiest rack for this
            # volume, then the emptiest node (pickRackToBalanceShardsInto);
            # filtering by headroom FIRST keeps the rack preference from
            # selecting a full node and skipping the move entirely
            cands = [n for n in shard_count
                     if n not in hs and shard_count[n] < avg]
            dst = min(cands,
                      key=lambda n: (vol_rack[racks.get(n, ("", n))],
                                     shard_count[n]),
                      default=None)
            if dst is None:
                continue
            moves.append((vid, collection, sid, src, dst))
            shard_count[src] -= 1
            shard_count[dst] += 1
            vol_rack[racks.get(dst, ("", dst))] += 1
            vol_rack[racks.get(src, ("", src))] -= 1
    for vid, collection, sid, src, dst in moves:
        print(f"move volume {vid} shard {sid}: {src} -> {dst}", file=out)
        if not opts.apply:
            continue
        env.volume_stub(dst).VolumeEcShardsCopy(
            vs.VolumeEcShardsCopyRequest(
                volume_id=vid, collection=collection, shard_ids=[sid],
                copy_ecx_file=True, copy_ecj_file=True, copy_vif_file=True,
                source_data_node=src), timeout=3600)
        env.volume_stub(dst).VolumeEcShardsMount(
            vs.VolumeEcShardsMountRequest(volume_id=vid, collection=collection,
                                          shard_ids=[sid]), timeout=60)
        env.volume_stub(src).VolumeEcShardsUnmount(
            vs.VolumeEcShardsUnmountRequest(volume_id=vid, shard_ids=[sid]),
            timeout=60)
        env.volume_stub(src).VolumeEcShardsDelete(
            vs.VolumeEcShardsDeleteRequest(volume_id=vid, collection=collection,
                                           shard_ids=[sid]), timeout=60)
    if not moves:
        print("ec shards already balanced", file=out)


@command("ec.decode", "decode an EC volume back into a normal volume")
def ec_decode(env, args, out):
    p = argparse.ArgumentParser(prog="ec.decode")
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-collection", default="")
    opts = p.parse_args(args)
    env.confirm_is_locked()
    vid = opts.volumeId

    holders = _ec_shard_holders(env, vid)
    if not holders:
        raise ValueError(f"ec volume {vid} not found")
    collection = opts.collection or _find_ec_collection(env, vid)
    # gather every shard onto the server already holding the most
    counts: dict[str, int] = defaultdict(int)
    for hs in holders.values():
        for h in hs:
            counts[h] += 1
    target = max(counts, key=counts.get)
    first_copy = True
    for sid, hs in sorted(holders.items()):
        if target in hs:
            continue
        env.volume_stub(target).VolumeEcShardsCopy(
            vs.VolumeEcShardsCopyRequest(
                volume_id=vid, collection=collection, shard_ids=[sid],
                copy_ecx_file=first_copy, copy_ecj_file=first_copy,
                copy_vif_file=first_copy, source_data_node=hs[0]),
            timeout=3600)
        first_copy = False
    env.volume_stub(target).VolumeEcShardsToVolume(
        vs.VolumeEcShardsToVolumeRequest(volume_id=vid, collection=collection),
        timeout=24 * 3600)
    # retire shards everywhere
    all_servers = {h for hs in holders.values() for h in hs} | {target}
    for addr in all_servers:
        env.volume_stub(addr).VolumeEcShardsUnmount(
            vs.VolumeEcShardsUnmountRequest(
                volume_id=vid, shard_ids=list(range(32))), timeout=60)
        env.volume_stub(addr).VolumeEcShardsDelete(
            vs.VolumeEcShardsDeleteRequest(
                volume_id=vid, collection=collection,
                shard_ids=list(range(32))), timeout=60)
    print(f"volume {vid}: decoded back to a normal volume on {target}", file=out)
