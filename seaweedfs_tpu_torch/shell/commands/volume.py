"""volume.* admin commands (counterpart of
seaweedfs_tpu/shell/commands/volume.py; SeaweedFS
weed/shell/command_volume_*.go).

`volume.tier.upload` and `volume.tier.download` move a sealed volume's
`.dat` to a tier backend of its server (`-tierConfig`) and back;
`volume.tier.move` moves volumes between disk types. `volume.fsck` walks
the filer given with `shell -filer`.
"""

from __future__ import annotations

import argparse
from collections import defaultdict

from ...pb import master_pb2, volume_server_pb2 as vs
from ..registry import command


@command("volume.list", "print the cluster volume topology")
def volume_list(env, args, out):
    resp = env.volume_list()
    topo = resp.topology_info
    for dc in topo.data_center_infos:
        print(f"DataCenter {dc.id}", file=out)
        for rack in dc.rack_infos:
            print(f"  Rack {rack.id}", file=out)
            for dn in rack.data_node_infos:
                vols = ecs = 0
                for disk in dn.disk_infos.values():
                    vols += len(disk.volume_infos)
                    ecs += len(disk.ec_shard_infos)
                print(f"    DataNode {dn.id} volumes:{vols} ecShards:{ecs}",
                      file=out)
                for disk in dn.disk_infos.values():
                    for v in disk.volume_infos:
                        print(f"      volume id:{v.id} size:{v.size} "
                              f"collection:{v.collection!r} "
                              f"file_count:{v.file_count} "
                              f"deleted:{v.delete_count} "
                              f"read_only:{v.read_only}", file=out)
                    for e in disk.ec_shard_infos:
                        sids = [i for i in range(32) if e.ec_index_bits >> i & 1]
                        print(f"      ec volume id:{e.id} "
                              f"collection:{e.collection!r} shards:{sids}",
                              file=out)


@command("volume.vacuum", "compact volumes above a garbage threshold")
def volume_vacuum(env, args, out):
    p = argparse.ArgumentParser(prog="volume.vacuum")
    p.add_argument("-garbageThreshold", type=float, default=0.3)
    p.add_argument("-volumeId", type=int, default=0)
    opts = p.parse_args(args)
    env.master_stub().VacuumVolume(
        master_pb2.VacuumVolumeRequest(
            garbage_threshold=opts.garbageThreshold,
            volume_id=opts.volumeId), timeout=3600)
    print("vacuum triggered", file=out)


@command("volume.mark", "mark a volume readonly/writable on a server")
def volume_mark(env, args, out):
    p = argparse.ArgumentParser(prog="volume.mark")
    p.add_argument("-node", required=True)
    p.add_argument("-volumeId", type=int, required=True)
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("-readonly", action="store_true")
    g.add_argument("-writable", action="store_true")
    opts = p.parse_args(args)
    stub = env.volume_stub(opts.node)
    if opts.readonly:
        stub.VolumeMarkReadonly(
            vs.VolumeMarkReadonlyRequest(volume_id=opts.volumeId), timeout=30)
    else:
        stub.VolumeMarkWritable(
            vs.VolumeMarkWritableRequest(volume_id=opts.volumeId), timeout=30)
    print(f"volume {opts.volumeId} marked", file=out)


@command("volume.delete", "delete a volume from a server")
def volume_delete(env, args, out):
    p = argparse.ArgumentParser(prog="volume.delete")
    p.add_argument("-node", required=True)
    p.add_argument("-volumeId", type=int, required=True)
    opts = p.parse_args(args)
    env.confirm_is_locked()
    env.volume_stub(opts.node).VolumeDelete(
        vs.VolumeDeleteRequest(volume_id=opts.volumeId), timeout=60)
    print(f"volume {opts.volumeId} deleted from {opts.node}", file=out)


@command("volume.copy", "copy a volume from one server to another")
def volume_copy(env, args, out):
    p = argparse.ArgumentParser(prog="volume.copy")
    p.add_argument("-from", dest="src", required=True)
    p.add_argument("-to", dest="dst", required=True)
    p.add_argument("-volumeId", type=int, required=True)
    opts = p.parse_args(args)
    env.confirm_is_locked()
    for resp in env.volume_stub(opts.dst).VolumeCopy(
            vs.VolumeCopyRequest(volume_id=opts.volumeId,
                                 source_data_node=opts.src), timeout=24 * 3600):
        if resp.processed_bytes:
            print(f"  copied {resp.processed_bytes} bytes", file=out)
    print(f"volume {opts.volumeId}: {opts.src} -> {opts.dst}", file=out)


@command("volume.move", "move a volume between servers (copy + delete)")
def volume_move(env, args, out):
    p = argparse.ArgumentParser(prog="volume.move")
    p.add_argument("-from", dest="src", required=True)
    p.add_argument("-to", dest="dst", required=True)
    p.add_argument("-volumeId", type=int, required=True)
    opts = p.parse_args(args)
    env.confirm_is_locked()
    for _ in env.volume_stub(opts.dst).VolumeCopy(
            vs.VolumeCopyRequest(volume_id=opts.volumeId,
                                 source_data_node=opts.src), timeout=24 * 3600):
        pass
    env.volume_stub(opts.src).VolumeDelete(
        vs.VolumeDeleteRequest(volume_id=opts.volumeId), timeout=60)
    print(f"volume {opts.volumeId} moved {opts.src} -> {opts.dst}", file=out)


def _replica_index(env):
    """vid -> {server: VolumeInformationMessage} + replica placement."""
    index: dict[int, dict[str, master_pb2.VolumeInformationMessage]] = defaultdict(dict)
    for dn in env.collect_data_nodes():
        for disk in dn.disk_infos.values():
            for v in disk.volume_infos:
                index[v.id][dn.id] = v
    return index


@command("volume.fix.replication", "re-replicate under-replicated volumes")
def volume_fix_replication(env, args, out):
    p = argparse.ArgumentParser(prog="volume.fix.replication")
    p.add_argument("-apply", action="store_true")
    opts = p.parse_args(args)
    env.confirm_is_locked()
    index = _replica_index(env)
    all_nodes = [dn.id for dn in env.collect_data_nodes()]
    fixes = 0
    for vid, replicas in sorted(index.items()):
        any_info = next(iter(replicas.values()))
        want = _copy_count(any_info.replica_placement)
        have = len(replicas)
        if have >= want:
            continue
        candidates = [n for n in all_nodes if n not in replicas]
        if not candidates:
            print(f"volume {vid}: under-replicated ({have}/{want}) "
                  f"but no free server", file=out)
            continue
        src = next(iter(replicas))
        dst = candidates[0]
        print(f"volume {vid}: {have}/{want} replicas; copy {src} -> {dst}",
              file=out)
        fixes += 1
        if opts.apply:
            for _ in env.volume_stub(dst).VolumeCopy(
                    vs.VolumeCopyRequest(volume_id=vid, source_data_node=src),
                    timeout=24 * 3600):
                pass
    if not fixes:
        print("all volumes sufficiently replicated", file=out)


def _copy_count(rp_byte: int) -> int:
    return rp_byte // 100 + rp_byte // 10 % 10 + rp_byte % 10 + 1


@command("volume.balance", "even out volume counts across servers")
def volume_balance(env, args, out):
    p = argparse.ArgumentParser(prog="volume.balance")
    p.add_argument("-apply", action="store_true")
    opts = p.parse_args(args)
    env.confirm_is_locked()
    counts: dict[str, list[int]] = {}
    for dn in env.collect_data_nodes():
        vids = []
        for disk in dn.disk_infos.values():
            vids.extend(v.id for v in disk.volume_infos)
        counts[dn.id] = vids
    if not counts:
        return
    avg = sum(len(v) for v in counts.values()) / len(counts)
    moves = []
    replica_idx = _replica_index(env)
    for src, vids in sorted(counts.items(), key=lambda kv: -len(kv[1])):
        while len(vids) > avg + 0.5:
            dst = min(counts, key=lambda n: len(counts[n]))
            if len(counts[dst]) + 1 > avg + 0.5 or dst == src:
                break
            vid = next((v for v in vids if dst not in replica_idx[v]), None)
            if vid is None:
                break
            moves.append((vid, src, dst))
            vids.remove(vid)
            counts[dst].append(vid)
    for vid, src, dst in moves:
        print(f"move volume {vid}: {src} -> {dst}", file=out)
        if opts.apply:
            for _ in env.volume_stub(dst).VolumeCopy(
                    vs.VolumeCopyRequest(volume_id=vid, source_data_node=src),
                    timeout=24 * 3600):
                pass
            env.volume_stub(src).VolumeDelete(
                vs.VolumeDeleteRequest(volume_id=vid), timeout=60)
    if not moves:
        print("volumes already balanced", file=out)


@command("volume.check.disk", "cross-check replica contents of every volume")
def volume_check_disk(env, args, out):
    """Digest-manifest replica check (command_volume_check_disk.go — but
    where the reference ships file-id lists, this compares per-needle
    digest manifests via the VolumeDigest RPC: ~20 bytes per volume when
    replicas agree, ~16 bytes per needle only when they don't). Also
    covers EC volumes: per-shard whole-file CRCs are cross-checked for
    every shard id held by more than one server, and a holder with a
    full local shard set gets a syndrome verify (detect-only)."""
    from ...pb import scrub_pb2

    p = argparse.ArgumentParser(prog="volume.check.disk")
    p.add_argument("-volumeId", type=int, default=0)
    p.add_argument("-slow", action="store_true",
                   help="also syndrome-verify EC volumes on their holders")
    opts = p.parse_args(args)
    index = _replica_index(env)
    issues = 0
    for vid, replicas in sorted(index.items()):
        if opts.volumeId and vid != opts.volumeId:
            continue
        if len(replicas) < 2:
            continue
        digests = {}
        for server in replicas:
            d = env.volume_stub(server).VolumeDigest(
                scrub_pb2.VolumeDigestRequest(volume_id=vid), timeout=60)
            # rolling CRC covers live entries; tombstone_count is
            # informational only (deletion HISTORY may differ between
            # converged replicas — e.g. one vacuumed)
            digests[server] = (d.rolling_crc, d.needle_count)
        if len(set(digests.values())) > 1:
            issues += 1
            print(f"volume {vid} replicas diverge: {digests}", file=out)
            # name the diverging needles: entry lists ship only now
            entries = {}
            for server in replicas:
                d = env.volume_stub(server).VolumeDigest(
                    scrub_pb2.VolumeDigestRequest(
                        volume_id=vid, include_entries=True), timeout=120)
                entries[server] = {e.needle_id: (e.crc, e.size)
                                   for e in d.entries}
            all_ids = set()
            for m in entries.values():
                all_ids |= m.keys()

            def norm(nid):
                # tombstone ≈ absent: deletion history may legitimately
                # differ between converged replicas
                vals = set()
                for m in entries.values():
                    got = m.get(nid)
                    vals.add(None if got is not None and got[1] < 0
                             else got)
                return vals

            diverging = [nid for nid in sorted(all_ids)
                         if len(norm(nid)) > 1]
            for nid in diverging[:20]:
                print(f"  needle {nid:x}: "
                      + ", ".join(f"{s}={entries[s].get(nid)}"
                                  for s in sorted(entries)), file=out)
            if len(diverging) > 20:
                print(f"  ... and {len(diverging) - 20} more", file=out)
    # EC volumes: shard-integrity coverage (the old check skipped them)
    ec_holders: dict[int, dict[str, dict[int, tuple[int, int]]]] = {}
    ec_cols: dict[int, str] = {}
    for dn in env.collect_data_nodes():
        for disk in dn.disk_infos.values():
            for e in disk.ec_shard_infos:
                if opts.volumeId and e.id != opts.volumeId:
                    continue
                ec_cols.setdefault(e.id, e.collection)
                try:
                    d = env.volume_stub(dn.id).VolumeDigest(
                        scrub_pb2.VolumeDigestRequest(volume_id=e.id),
                        timeout=120)
                except Exception as ex:  # noqa: BLE001 — keep checking
                    print(f"ec volume {e.id} on {dn.id}: digest failed: "
                          f"{ex}", file=out)
                    continue
                ec_holders.setdefault(e.id, {})[dn.id] = {
                    s.shard_id: (s.crc, s.size) for s in d.shard_digests}
    for vid, holders in sorted(ec_holders.items()):
        by_shard: dict[int, dict[str, tuple[int, int]]] = {}
        for server, shards in holders.items():
            for sid, cs in shards.items():
                by_shard.setdefault(sid, {})[server] = cs
        # report the code geometry the check operates on:
        # readable from any holder's .vif — mixed-geometry clusters name
        # each volume's layout explicitly
        from .ec import _ec_geometry

        hmap = {sid: sorted(copies) for sid, copies in by_shard.items()}
        d, pshards, code = _ec_geometry(env, vid, hmap,
                                        ec_cols.get(vid, ""))
        print(f"ec volume {vid}: geometry "
              f"{code or 'unknown (.vif unreadable)'} "
              f"({d}+{pshards}), {len(by_shard)} shard ids on "
              f"{len(holders)} holder(s)", file=out)
        for sid, copies in sorted(by_shard.items()):
            if len(copies) > 1 and len(set(copies.values())) > 1:
                issues += 1
                print(f"ec volume {vid} shard {sid} copies diverge: "
                      f"{copies}", file=out)
        if opts.slow:
            # the holder with the most shards runs the syndrome verify;
            # when no holder has a full local set, the scrub plane's
            # cross-server gather fetches a repair-plan's worth of
            # survivor ranges from peers — a split volume is VERIFIED,
            # never skipped
            best = max(holders, key=lambda s: len(holders[s]))
            split = len(holders[best]) < len(by_shard)
            r = env.volume_stub(best).VolumeScrub(
                scrub_pb2.VolumeScrubRequest(volume_id=vid, full=True),
                timeout=3600)
            bad = [f for f in r.findings if f.kind == "ec_parity"]
            if bad:
                issues += len(bad)
                for f in bad:
                    print(f"ec volume {vid}: {f.detail} "
                          f"(shard {f.shard_id}, {f.state})", file=out)
            elif r.bytes_verified:
                print(f"ec volume {vid}: syndrome verified clean via "
                      f"{best}"
                      + (" (cross-server gather)" if split else ""),
                      file=out)
            else:
                issues += 1
                print(f"ec volume {vid}: syndrome verify could not "
                      f"cover the volume from {best}", file=out)
    print(f"{issues} integrity issue(s) found", file=out)


@command("volume.scrub",
         "volume.scrub -node=<server> [-volumeId=n] [-full] [-detectOnly] "
         "| -status")
def volume_scrub(env, args, out):
    """On-demand integrity pass (and status view) of one volume server's
    scrub plane: needle CRC sweep + EC syndrome verify + anti-entropy,
    with findings escalated into self-healing repair unless -detectOnly."""
    from ...pb import scrub_pb2

    p = argparse.ArgumentParser(prog="volume.scrub")
    p.add_argument("-node", required=True)
    p.add_argument("-volumeId", type=int, default=0)
    p.add_argument("-full", action="store_true",
                   help="ignore the sweep cursor, verify from offset 0")
    p.add_argument("-detectOnly", action="store_true",
                   help="report findings without repairing")
    p.add_argument("-status", action="store_true",
                   help="show cursors/findings instead of scrubbing")
    opts = p.parse_args(args)
    stub = env.volume_stub(opts.node)
    if opts.status:
        st = stub.ScrubStatus(scrub_pb2.ScrubStatusRequest(), timeout=30)
        print(f"running:{st.running} sweeps:{st.sweeps_completed} "
              f"suspectBacklog:{st.suspect_backlog}", file=out)
        for c in st.cursors:
            print(f"  cursor vol {c.volume_id}: offset {c.offset} "
                  f"(sweeps {c.sweeps})", file=out)
        for f in st.findings:
            print(f"  finding vol {f.volume_id} {f.kind} "
                  f"needle={f.needle_id:x} shard={f.shard_id} "
                  f"[{f.state}] {f.detail}", file=out)
        return
    r = stub.VolumeScrub(scrub_pb2.VolumeScrubRequest(
        volume_id=opts.volumeId, full=opts.full,
        repair=not opts.detectOnly), timeout=3600)
    print(f"scrubbed {r.volumes_scrubbed} volume(s): "
          f"{r.needles_checked} needles, {r.bytes_verified} bytes, "
          f"{len(r.findings)} finding(s), {r.repaired} repaired"
          + (f", {r.skipped_pairs} peer pair(s) skipped"
             if r.skipped_pairs else ""), file=out)
    for f in r.findings:
        print(f"  vol {f.volume_id} {f.kind} needle={f.needle_id:x} "
              f"shard={f.shard_id} [{f.state}] {f.detail}", file=out)


@command("volumeServer.evacuate", "move everything off one volume server")
def volume_server_evacuate(env, args, out):
    p = argparse.ArgumentParser(prog="volumeServer.evacuate")
    p.add_argument("-node", required=True)
    p.add_argument("-apply", action="store_true")
    opts = p.parse_args(args)
    env.confirm_is_locked()
    targets = [dn.id for dn in env.collect_data_nodes() if dn.id != opts.node]
    if not targets:
        raise ValueError("no other servers to evacuate to")
    index = _replica_index(env)
    i = 0
    for vid, replicas in sorted(index.items()):
        if opts.node not in replicas:
            continue
        dst = next((t for t in targets[i:] + targets[:i]
                    if t not in replicas), None)
        i = (i + 1) % len(targets)
        if dst is None:
            print(f"volume {vid}: no destination without a replica", file=out)
            continue
        print(f"move volume {vid}: {opts.node} -> {dst}", file=out)
        if opts.apply:
            for _ in env.volume_stub(dst).VolumeCopy(
                    vs.VolumeCopyRequest(volume_id=vid,
                                         source_data_node=opts.node),
                    timeout=24 * 3600):
                pass
            env.volume_stub(opts.node).VolumeDelete(
                vs.VolumeDeleteRequest(volume_id=vid), timeout=60)


@command("volumeServer.leave", "ask a volume server to stop heartbeating")
def volume_server_leave(env, args, out):
    p = argparse.ArgumentParser(prog="volumeServer.leave")
    p.add_argument("-node", required=True)
    opts = p.parse_args(args)
    env.volume_stub(opts.node).VolumeServerLeave(
        vs.VolumeServerLeaveRequest(), timeout=30)
    print(f"{opts.node} asked to leave", file=out)


@command("volume.tier.upload", "move a sealed volume's .dat to a tier backend")
def volume_tier_upload(env, args, out):
    """command_volume_tier_upload.go: .dat -> remote backend, reads
    range-fetch afterward."""
    p = argparse.ArgumentParser(prog="volume.tier.upload")
    p.add_argument("-node", required=True)
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-dest", required=True, help="tier backend name")
    p.add_argument("-keepLocalDatFile", action="store_true")
    opts = p.parse_args(args)
    env.confirm_is_locked()
    stub = env.volume_stub(opts.node)
    for resp in stub.VolumeTierMoveDatToRemote(
            vs.VolumeTierMoveDatToRemoteRequest(
                volume_id=opts.volumeId,
                destination_backend_name=opts.dest,
                keep_local_dat_file=opts.keepLocalDatFile), timeout=3600):
        print(f"moved {resp.processed} bytes "
              f"({resp.processed_percentage:.0f}%)", file=out)


@command("volume.tier.download", "bring a tiered volume's .dat back to disk")
def volume_tier_download(env, args, out):
    """command_volume_tier_download.go."""
    p = argparse.ArgumentParser(prog="volume.tier.download")
    p.add_argument("-node", required=True)
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-keepRemoteDatFile", action="store_true")
    opts = p.parse_args(args)
    env.confirm_is_locked()
    stub = env.volume_stub(opts.node)
    for resp in stub.VolumeTierMoveDatFromRemote(
            vs.VolumeTierMoveDatFromRemoteRequest(
                volume_id=opts.volumeId,
                keep_remote_dat_file=opts.keepRemoteDatFile), timeout=3600):
        print(f"downloaded {resp.processed} bytes "
              f"({resp.processed_percentage:.0f}%)", file=out)


@command("volume.mount", "volume.mount -node=<server> -volumeId=<n>")
def volume_mount(env, args, out):
    p = argparse.ArgumentParser(prog="volume.mount")
    p.add_argument("-node", required=True)
    p.add_argument("-volumeId", type=int, required=True)
    opts = p.parse_args(args)
    env.volume_stub(opts.node).VolumeMount(
        vs.VolumeMountRequest(volume_id=opts.volumeId), timeout=30)
    print(f"mounted volume {opts.volumeId} on {opts.node}", file=out)


@command("volume.unmount", "volume.unmount -node=<server> -volumeId=<n>")
def volume_unmount(env, args, out):
    p = argparse.ArgumentParser(prog="volume.unmount")
    p.add_argument("-node", required=True)
    p.add_argument("-volumeId", type=int, required=True)
    opts = p.parse_args(args)
    env.volume_stub(opts.node).VolumeUnmount(
        vs.VolumeUnmountRequest(volume_id=opts.volumeId), timeout=30)
    print(f"unmounted volume {opts.volumeId} on {opts.node}", file=out)


@command("volume.configure.replication",
         "volume.configure.replication -volumeId=<n> -replication=XYZ")
def volume_configure_replication(env, args, out):
    """command_volume_configure_replication.go: rewrite a volume's replica
    placement on every server holding it."""
    p = argparse.ArgumentParser(prog="volume.configure.replication")
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-replication", required=True)
    opts = p.parse_args(args)
    env.confirm_is_locked()
    changed = 0
    for dn in env.collect_data_nodes():
        for disk in dn.disk_infos.values():
            for v in disk.volume_infos:
                if v.id == opts.volumeId:
                    env.volume_stub(dn.id).VolumeConfigure(
                        vs.VolumeConfigureRequest(
                            volume_id=opts.volumeId,
                            replication=opts.replication), timeout=30)
                    changed += 1
    if not changed:
        raise RuntimeError(f"volume {opts.volumeId} not found")
    print(f"configured replication={opts.replication} on {changed} replicas",
          file=out)


@command("volume.grow",
         "volume.grow [-collection=c] [-replication=XYZ] [-count=n]")
def volume_grow(env, args, out):
    """command_volume_grow semantics via the master's grow endpoint."""
    import requests

    from ...utils.http import requests_verify, url_for

    p = argparse.ArgumentParser(prog="volume.grow")
    p.add_argument("-collection", default="")
    p.add_argument("-replication", default="")
    p.add_argument("-count", type=int, default=1)
    opts = p.parse_args(args)
    r = requests.get(
        url_for(env.master, "/vol/grow"),
        params={"collection": opts.collection,
                "replication": opts.replication,
                "count": opts.count}, timeout=60,
        verify=requests_verify()).json()
    if "error" in r:
        raise RuntimeError(r["error"])
    print(f"grew {r.get('count', 0)} volumes", file=out)


@command("volume.fsck",
         "volume.fsck [-verbose] — cross-check filer chunks vs volumes")
def volume_fsck(env, args, out):
    """command_volume_fsck.go (simplified): walk the filer namespace,
    verify every referenced chunk's volume exists in the topology and the
    needle is readable; report dangling references."""
    import requests

    from ...pb import filer_pb2
    from ...pb import rpc as _rpc

    verbose = "-verbose" in args
    stub = _rpc.filer_stub(_rpc.grpc_address(env.require_filer()))
    topo = env.volume_list().topology_info
    known_vids = set()
    for dc in topo.data_center_infos:
        for rack in dc.rack_infos:
            for dn in rack.data_node_infos:
                for disk in dn.disk_infos.values():
                    known_vids.update(v.id for v in disk.volume_infos)
                    known_vids.update(
                        ec.id for ec in disk.ec_shard_infos)
    checked = missing_vol = unreadable = 0

    def walk(d):
        nonlocal checked, missing_vol, unreadable
        for resp in stub.ListEntries(filer_pb2.ListEntriesRequest(
                directory=d, limit=1 << 20)):
            e = resp.entry
            path = d.rstrip("/") + "/" + e.name
            if e.is_directory:
                walk(path)
                continue
            for c in e.chunks:
                checked += 1
                vid = int(c.file_id.split(",")[0])
                if vid not in known_vids:
                    missing_vol += 1
                    print(f"  {path}: chunk {c.file_id}: volume {vid} "
                          f"not in topology", file=out)
                    continue
                if verbose:
                    urls = env.master_client.lookup_file_id(c.file_id)
                    # the C++ plane 307s an EC volume's HEAD to Python
                    r = requests.head(urls[0], timeout=10,
                                      allow_redirects=True)
                    if r.status_code != 200:
                        unreadable += 1
                        print(f"  {path}: chunk {c.file_id}: HTTP "
                              f"{r.status_code}", file=out)

    walk("/")
    print(f"checked {checked} chunks: {missing_vol} dangling volume refs, "
          f"{unreadable} unreadable", file=out)


@command("volume.delete.empty",
         "volume.delete.empty [-quietFor=24h] [-force]  (drop 0-file volumes)")
def volume_delete_empty(env, args, out):
    """command_volume_delete_empty.go: delete volumes that hold no live
    files and have been quiet long enough."""
    import time as _time

    p = argparse.ArgumentParser(prog="volume.delete.empty")
    p.add_argument("-quietFor", default="24h")
    p.add_argument("-force", action="store_true")
    opts = p.parse_args(args)
    env.confirm_is_locked()
    from ..registry import parse_duration

    cutoff = _time.time() - parse_duration(opts.quietFor, flag="-quietFor")
    deleted = 0
    for dn in env.collect_data_nodes():
        for disk in dn.disk_infos.values():
            for v in disk.volume_infos:
                if v.file_count - v.delete_count > 0:
                    continue
                if v.modified_at_second and v.modified_at_second > cutoff:
                    continue
                if opts.force:
                    env.volume_stub(dn.id).VolumeDelete(
                        vs.VolumeDeleteRequest(volume_id=v.id), timeout=60)
                    print(f"deleted empty volume {v.id} on {dn.id}", file=out)
                else:
                    print(f"would delete empty volume {v.id} on {dn.id} "
                          f"(rerun with -force)", file=out)
                deleted += 1
    if not deleted:
        print("no empty volumes", file=out)


@command("volume.tier.move",
         "volume.tier.move -fromDiskType=hdd -toDiskType=ssd "
         "[-collection=x] [-apply]")
def volume_tier_move(env, args, out):
    """command_volume_tier_move.go: migrate volumes onto servers that have
    the target disk type (copy there, delete at the source)."""
    p = argparse.ArgumentParser(prog="volume.tier.move")
    p.add_argument("-fromDiskType", default="")
    p.add_argument("-toDiskType", required=True)
    p.add_argument("-collection", default="")
    p.add_argument("-apply", action="store_true")
    opts = p.parse_args(args)
    env.confirm_is_locked()

    def norm(dt: str) -> str:
        return "" if dt in ("", "hdd") else dt

    # destination servers offering the target disk type, with room
    dests = []
    sources = []  # (vid, server)
    replicas = _replica_index(env)
    for dn in env.collect_data_nodes():
        for dtype, disk in dn.disk_infos.items():
            if norm(dtype) == norm(opts.toDiskType):
                free = disk.max_volume_count - disk.volume_count
                if free > 0:
                    dests.append([dn.id, free])
            if norm(dtype) == norm(opts.fromDiskType):
                for v in disk.volume_infos:
                    if opts.collection and v.collection != opts.collection:
                        continue
                    sources.append((v.id, dn.id))
    if not dests:
        print(f"no server offers disk type {opts.toDiskType!r} with room",
              file=out)
        return
    moved = 0
    for vid, src in sources:
        # a destination must not already hold this volume (ALREADY_EXISTS)
        holders = set(replicas.get(vid, {}))
        dest = next((d for d in dests
                     if d[0] != src and d[1] > 0 and d[0] not in holders),
                    None)
        if dest is None:
            print(f"volume {vid}: no destination with room", file=out)
            continue
        print(f"volume {vid}: {src} -> {dest[0]} ({opts.toDiskType})",
              file=out)
        if opts.apply:
            try:
                for _ in env.volume_stub(dest[0]).VolumeCopy(
                        vs.VolumeCopyRequest(volume_id=vid,
                                             source_data_node=src,
                                             disk_type=opts.toDiskType),
                        timeout=24 * 3600):
                    pass
                env.volume_stub(src).VolumeDelete(
                    vs.VolumeDeleteRequest(volume_id=vid), timeout=60)
            except Exception as e:  # keep moving the rest
                print(f"  volume {vid} move failed: {e}", file=out)
                continue
        moved += 1
        dest[1] -= 1
        replicas.setdefault(vid, {})[dest[0]] = None
    if not moved:
        print("nothing to move", file=out)


@command("volume.scrub.disable", "pause the master's fleet scrub loop")
def volume_scrub_disable(env, args, out):
    """Incident knob: stops the master from nudging servers to scrub
    (per-server daemons keep their own schedule; on-demand volume.scrub
    still works)."""
    from ...pb import scrub_pb2

    env.master_stub().DisableScrub(
        scrub_pb2.DisableScrubRequest(), timeout=10)
    print("disabled", file=out)


@command("volume.scrub.enable", "resume the master's fleet scrub loop")
def volume_scrub_enable(env, args, out):
    from ...pb import scrub_pb2

    env.master_stub().EnableScrub(
        scrub_pb2.EnableScrubRequest(), timeout=10)
    print("enabled", file=out)


@command("volume.vacuum.disable", "pause the master's periodic vacuum")
def volume_vacuum_disable(env, args, out):
    """command_volume_vacuum_disable.go via master DisableVacuum."""
    env.master_stub().DisableVacuum(
        master_pb2.DisableVacuumRequest(), timeout=10)
    print("disabled", file=out)


@command("volume.vacuum.enable", "resume the master's periodic vacuum")
def volume_vacuum_enable(env, args, out):
    """command_volume_vacuum_enable.go via master EnableVacuum."""
    env.master_stub().EnableVacuum(
        master_pb2.EnableVacuumRequest(), timeout=10)
    print("enabled", file=out)
