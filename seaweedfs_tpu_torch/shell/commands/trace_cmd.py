"""`trace.dump` — gather one trace's spans from every server it touched
(counterpart of seaweedfs_tpu/shell/commands/trace_cmd.py).

The tracing plane (utils/trace.py) keeps each span in the
PROCESS that produced it; a request that crossed s3 -> filer -> three
volume servers left pieces of its tree on each. This command walks the
cluster — the master, every registered volume server, and the shell's
filer if one is configured — asking each `/debug/traces?trace=<id>`,
merges the spans (deduped by span id: in-process test clusters share
one store), and prints them as a time-ordered tree with per-span
attributes, so one X-Trace-Id from a slow response turns into a full
per-plane latency breakdown at the terminal.
"""

from __future__ import annotations

import json

import requests

from ...utils.http import requests_verify, url_for
from ..registry import command


def _fetch(addr: str, trace_id: str) -> list[dict]:
    try:
        r = requests.get(url_for(addr, "/debug/traces"),
                         params={"trace": trace_id}, timeout=10,
                         verify=requests_verify())
        if r.status_code != 200:
            return []
        return r.json().get("spans", [])
    except (requests.RequestException, ValueError):
        return []


def gather_trace(env, trace_id: str,
                 extra: list[str] | None = None) -> tuple[list[dict],
                                                          list[str]]:
    """-> (spans deduped+sorted, servers queried). Queries the master,
    every data node from the topology, the shell's filer, and any
    `extra` addresses."""
    targets = [env.master]
    try:
        for dn in env.collect_data_nodes():
            if dn.id not in targets:
                targets.append(dn.id)
    # lint: allow-broad-except(a dead master still leaves
    # the extra targets to query)
    except Exception:  # noqa: BLE001 — a dead master still leaves extras
        pass
    if env.filer and env.filer not in targets:
        targets.append(env.filer)
    for addr in extra or []:
        if addr and addr not in targets:
            targets.append(addr)
    spans: list[dict] = []
    seen: set[str] = set()
    for addr in targets:
        for s in _fetch(addr, trace_id):
            if s.get("spanId") in seen:
                continue
            seen.add(s.get("spanId"))
            spans.append(s)
    spans.sort(key=lambda s: s.get("startUnix", 0))
    return spans, targets


def _render(spans: list[dict], out) -> None:
    if not spans:
        print("no spans found (expired from every ring, or wrong id?)",
              file=out)
        return
    t0 = spans[0].get("startUnix", 0)
    by_id = {s["spanId"]: s for s in spans}

    def depth(s, hop=0):
        if hop > 32:  # cycles can't happen, but never loop on bad data
            return hop
        p = by_id.get(s.get("parentId", ""))
        return 0 if p is None else depth(p, hop + 1) + 1

    for s in spans:
        off_ms = (s.get("startUnix", 0) - t0) * 1000.0
        attrs = " ".join(f"{k}={v}" for k, v in
                         sorted(s.get("attrs", {}).items()))
        err = f" ERROR={s['error']}" if s.get("error") else ""
        indent = "  " * depth(s)
        print(f"  {off_ms:9.2f}ms {s.get('durationMs', -1):9.2f}ms "
              f"{(s.get('component') or '-'):7s} "
              f"{(s.get('server') or '-'):21s} "
              f"{indent}{s.get('name', '?')}"
              + (f" [{attrs}]" if attrs else "") + err, file=out)


@command("trace.dump",
         "gather a trace's spans from every server it touched "
         "(-trace=<id> [-server=addr,addr] [-json])")
def trace_dump(env, args, out):
    trace_id = ""
    extra: list[str] = []
    as_json = False
    for a in args:
        if a.startswith("-trace="):
            trace_id = a.split("=", 1)[1]
        elif a.startswith("-server="):
            extra.extend(x for x in a.split("=", 1)[1].split(",") if x)
        elif a == "-json":
            as_json = True
        elif not a.startswith("-") and not trace_id:
            trace_id = a  # bare positional id
    if not trace_id:
        raise RuntimeError("usage: trace.dump -trace=<trace id> "
                           "[-server=host:port,...] [-json]")
    spans, targets = gather_trace(env, trace_id, extra)
    if as_json:
        print(json.dumps({"traceId": trace_id, "spans": spans}, indent=2),
              file=out)
        return
    servers = sorted({s.get("server") or "?" for s in spans})
    print(f"trace {trace_id}: {len(spans)} span(s) from "
          f"{len(servers)} server(s) (queried {len(targets)})", file=out)
    print(f"  servers: {', '.join(servers)}", file=out)
    print("   startOff   duration comp    server                span",
          file=out)
    _render(spans, out)
