"""`qos.status` — one view of the QoS/admission plane across the fleet
(counterpart of seaweedfs_tpu/shell/commands/qos_cmd.py).

Walks the cluster (master, every registered volume server, the shell's
filer and any `-server=` extras) asking each `/status` for its `Qos`
section and prints: the master's grant ledger (cluster budget, per-class
granted/denied, per-server pressure), each volume server's live pressure
score + governor lease state, and each ingress plane's tenant buckets
with recent rejections (tenant, retry-after, trace id — the handle
`trace.dump` turns into a per-plane breakdown).
"""

from __future__ import annotations

import json

import requests

from ...utils.http import requests_verify, url_for
from ..registry import command


def _status(addr: str) -> dict:
    try:
        r = requests.get(url_for(addr, "/status"), timeout=10,
                         verify=requests_verify())
        if r.status_code != 200:
            return {}
        return r.json()
    except (requests.RequestException, ValueError):
        return {}


def _fmt_admission(adm: dict, out) -> None:
    print(f"    admitted={adm.get('admitted', 0)} "
          f"rejected={adm.get('rejected', 0)} "
          f"defaultRps={adm.get('defaultRps', 0)}", file=out)
    for tenant, b in sorted(adm.get("tenants", {}).items()):
        print(f"      tenant {tenant:24s} rate={b.get('rate', 0):g} "
              f"burst={b.get('burst', 0):g} tokens={b.get('tokens', 0)}",
              file=out)
    for rej in adm.get("recentRejections", [])[-5:]:
        print(f"      rejected {rej.get('tenant', '?'):24s} "
              f"retryAfter={rej.get('retryAfterS', 0)}s "
              f"trace={rej.get('traceId', '') or '-'}", file=out)


@command("qos.status",
         "QoS/admission plane across the fleet: grant ledger, pressure, "
         "tenant buckets ([-server=addr,addr] [-json])")
def qos_status(env, args, out):
    extra: list[str] = []
    as_json = False
    for a in args:
        if a.startswith("-server="):
            extra.extend(x for x in a.split("=", 1)[1].split(",") if x)
        elif a == "-json":
            as_json = True
    targets = [("master", env.master)]
    try:
        for dn in env.collect_data_nodes():
            targets.append(("volume", dn.id))
    # lint: allow-broad-except(a dead master still leaves
    # the extra targets to query)
    except Exception:  # noqa: BLE001 — a dead master still leaves extras
        pass
    if env.filer:
        targets.append(("filer", env.filer))
    for addr in extra:
        if addr and all(addr != t[1] for t in targets):
            targets.append(("server", addr))

    gathered = {}
    for kind, addr in targets:
        st = _status(addr)
        qos = st.get("Qos")
        if qos is not None:
            gathered[addr] = {"kind": kind, "qos": qos}
    if as_json:
        print(json.dumps(gathered, indent=2), file=out)
        return
    if not gathered:
        print("no Qos sections found (servers down, or pre-QoS builds?)",
              file=out)
        return
    for addr, entry in gathered.items():
        kind, qos = entry["kind"], entry["qos"]
        print(f"{kind} {addr}:", file=out)
        ledger = qos.get("ledger")
        if ledger is not None:
            print(f"  ledger: clusterBudgetMBps="
                  f"{ledger.get('clusterBudgetMBps', 0)} "
                  f"granted={ledger.get('grantedBytes', {})} "
                  f"denied={ledger.get('deniedGrants', {})}", file=out)
            for saddr, s in sorted(ledger.get("servers", {}).items()):
                print(f"    server {saddr:21s} "
                      f"pressure={s.get('pressure', 0):.3f} "
                      f"age={s.get('ageSeconds', 0)}s", file=out)
        if "pressure" in qos and "governor" in qos:
            gov = qos["governor"]
            print(f"  pressure={qos['pressure']:.3f} "
                  f"(gcDepth={qos.get('groupCommitDepth', 0)} "
                  f"dispatchDepth={qos.get('dispatchDepth', 0)})",
                  file=out)
            print(f"  governor: enabled={gov.get('enabled')} "
                  f"tokens={gov.get('tokens', {})} "
                  f"waits={gov.get('waitSeconds', {})} "
                  f"denials={gov.get('denials', 0)}", file=out)
        adm = qos.get("tenantAdmission")
        if adm is not None:
            print(f"  admission ({adm.get('plane', '?')}):", file=out)
            _fmt_admission(adm, out)
        grants = qos.get("grants")
        if grants and kind in ("master", "volume"):
            for klass, g in sorted(grants.items()):
                if any(g.values()):
                    print(f"  class {klass}: {g}", file=out)
