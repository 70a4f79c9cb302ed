"""Server status pages.

Counterpart of seaweedfs_tpu/server/ui.py (SeaweedFS
weed/server/{master_ui,volume_server_ui}/templates.go and the filer's
HTML directory browser, filer_ui/templates.go): small server-rendered pages on each server's HTTP
port — cluster topology on the master, disk/volume tables on the volume
server, a breadcrumbed directory listing on the filer. No assets, no JS
frameworks; a shared shell keeps them consistent.
"""

from __future__ import annotations

import html
import time

from ..utils.http import url_for

_STYLE = """
body{font-family:system-ui,sans-serif;margin:2em;color:#222}
h1{font-size:1.4em} h2{font-size:1.1em;margin-top:1.4em}
table{border-collapse:collapse;margin:.5em 0}
td,th{border:1px solid #ccc;padding:.25em .6em;text-align:left}
th{background:#f2f2f2} a{color:#06c;text-decoration:none}
.muted{color:#888;font-size:.85em}
"""


def page(title: str, body: str) -> bytes:
    return (f"<!DOCTYPE html><html><head><meta charset='utf-8'>"
            f"<title>{html.escape(title)}</title><style>{_STYLE}</style>"
            f"</head><body><h1>{html.escape(title)}</h1>{body}"
            f"<p class='muted'>seaweedfs-tpu · {time.strftime('%F %T')}"
            f"</p></body></html>").encode()


class Raw(str):
    """Marker for cells that are pre-built trusted markup. Only code in
    this module constructs Raw — every other value (including anything a
    client or heartbeat supplied that merely LOOKS like markup) is
    escaped."""


def link(href: str, text: str) -> Raw:
    return Raw(f"<a href='{html.escape(href, quote=True)}'>"
               f"{html.escape(text)}</a>")


def table(headers: list[str], rows: list[list]) -> str:
    out = ["<table><tr>"]
    out += [f"<th>{html.escape(str(h))}</th>" for h in headers]
    out.append("</tr>")
    for row in rows:
        out.append("<tr>")
        out += [f"<td>{c if isinstance(c, Raw) else html.escape(str(c))}"
                f"</td>" for c in row]
        out.append("</tr>")
    out.append("</table>")
    return "".join(out)


def kv_table(pairs: list[tuple[str, object]]) -> str:
    return table(["", ""], [[k, v] for k, v in pairs])


def master_ui(ms) -> bytes:
    """master_ui/templates.go equivalent."""
    total, used, files = ms.topo.statistics()
    body = kv_table([
        ("Address", ms.address),
        ("Leader", ms.leader_address()),
        ("Is leader", ms.is_leader()),
        ("Capacity", f"{total:,} B"),
        ("Used", f"{used:,} B"),
        ("Files", f"{files:,}"),
        ("Volume size limit",
         f"{ms.topo.volume_size_limit // (1 << 20)} MB"),
    ])
    rows = []
    for dn in sorted(ms.topo.nodes.values(), key=lambda n: n.url):
        ec = sum(bin(e.bits).count("1") for e in dn.ec_shards.values())
        rows.append([dn.data_center, dn.rack,
                     link(url_for(dn.url, "/ui"), dn.url),
                     len(dn.volumes), dn.max_volume_count, ec])
    body += "<h2>Topology</h2>" + table(
        ["DataCenter", "Rack", "Node", "Volumes", "Max", "EC shards"], rows)
    if ms.raft is not None:
        st = ms.raft.status()
        body += "<h2>Raft</h2>" + kv_table(
            [("Role", st["role"]), ("Term", st["term"]),
             ("Commit", st["commit_index"]),
             ("Peers", ", ".join(st["peers"]) or "—")])
    body += ("<p><a href='/metrics'>metrics</a> · "
             "<a href='/dir/status'>dir status</a> · "
             "<a href='/cluster/status'>cluster status</a></p>")
    return page(f"SeaweedFS-TPU Master {ms.address}", body)


def volume_ui(srv) -> bytes:
    """volume_server_ui/templates.go equivalent."""
    store = srv.store
    body = kv_table([
        ("Address", srv.address),
        ("Masters", ", ".join(srv.masters)),
        ("Data center", store.data_center or "—"),
        ("Rack", store.rack or "—"),
    ])
    rows = []
    for loc in store.locations:
        rows.append([loc.directory, loc.disk_type or "hdd",
                     len(loc.volumes), len(loc.ec_volumes),
                     loc.max_volume_count])
    body += "<h2>Disks</h2>" + table(
        ["Directory", "Type", "Volumes", "EC volumes", "Max"], rows)
    vrows = []
    for loc in store.locations:
        for vid, v in sorted(loc.volumes.items()):
            vrows.append([vid, v.collection or "—", f"{v.data_size():,}",
                          v.file_count(), v.deleted_count(),
                          "ro" if v.read_only else "rw"])
    body += "<h2>Volumes</h2>" + table(
        ["Id", "Collection", "Size", "Files", "Deleted", "Mode"], vrows)
    erows = []
    for loc in store.locations:
        for vid, ev in sorted(loc.ec_volumes.items()):
            erows.append([vid, getattr(ev, "collection", "") or "—",
                          ", ".join(str(s)
                                    for s in sorted(ev.shard_files))])
    if erows:
        body += "<h2>EC volumes</h2>" + table(
            ["Id", "Collection", "Shards"], erows)
    body += "<p><a href='/metrics'>metrics</a> · <a href='/status'>status"
    body += "</a></p>"
    return page(f"SeaweedFS-TPU Volume Server {srv.address}", body)


def filer_ui(srv, path: str, entries) -> bytes:
    """filer_ui/templates.go equivalent: breadcrumbed directory browser."""
    crumbs = ["<a href='/?ui=1'>/</a>"]
    acc = ""
    for part in [p for p in path.split("/") if p]:
        acc += "/" + part
        crumbs.append(f"<a href='{html.escape(acc)}?ui=1'>"
                      f"{html.escape(part)}</a>")
    body = "<p>" + " / ".join(crumbs) + "</p>"
    rows = []
    for e in entries:
        name = e.name + ("/" if e.is_directory else "")
        href = e.full_path + ("?ui=1" if e.is_directory else "")
        rows.append([link(href, name),
                     f"{e.size():,}", e.attr.mime or "—",
                     time.strftime("%F %T", time.localtime(e.attr.mtime))
                     if e.attr.mtime else "—"])
    body += table(["Name", "Size", "Mime", "Modified"], rows)
    body += f"<p class='muted'>{len(rows)} entries · filer {srv.address}</p>"
    return page(f"SeaweedFS-TPU Filer {path}", body)
