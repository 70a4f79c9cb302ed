"""`weed benchmark` equivalent: concurrent small-file write/read benchmark
with latency percentiles (counterpart of seaweedfs_tpu/command/benchmark.py;
SeaweedFS weed/command/benchmark.go:73-111, percentile printer :437).

Client efficiency matters when comparing against the reference's Go
client on the same host: this tool uses raw http.client keepalive
connections (one per worker thread) and can amortize master assigns over
`assign_batch` files via the fid "_delta" suffix the assign API hands out
(Assign count=N; needle.go ParsePath:117-142 semantics).

`-filer` and `-nativeClient` run the compiled client loop of the C++ data
plane (native/dataplane.cpp swdp_bench, through
native.dataplane.bench_loop): `-filer` PUTs and GETs whole objects under
/buckets/ through a filer (its C++ hot plane under `server -filer`),
`-nativeClient` drives the volume servers after batched assigns.
"""

from __future__ import annotations

import http.client
import secrets
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..operation import assign
from ..wdclient import MasterClient

_tl = threading.local()


def _conn(addr: str) -> http.client.HTTPConnection:
    """Per-(thread, server) keepalive connection."""
    conns = getattr(_tl, "conns", None)
    if conns is None:
        conns = _tl.conns = {}
    c = conns.get(addr)
    if c is None:
        host, _, port = addr.partition(":")
        c = conns[addr] = http.client.HTTPConnection(host, int(port),
                                                     timeout=30)
    return c


def _request(addr: str, method: str, path: str, body=None, headers=None):
    """One keepalive request; transparently follows a single 307 (the
    native data plane redirects non-fast paths to the python listener)
    and reconnects once on a dropped keepalive connection."""
    for attempt in (0, 1):
        c = _conn(addr)
        try:
            c.request(method, path, body=body, headers=headers or {})
            r = c.getresponse()
            data = r.read()
        except (http.client.HTTPException, OSError):
            c.close()
            if attempt:
                raise
            continue
        if r.status == 307:
            loc = r.getheader("Location") or ""
            host = loc.split("//", 1)[1]
            dest, _, path2 = host.partition("/")
            return _request(dest, method, "/" + path2, body, headers)
        return r.status, data
    raise IOError("unreachable")


def _pcts(lat_s: np.ndarray) -> dict:
    """avg/p50/p99 (ms) over COMPLETED samples only — zero slots are
    requests that never finished and must not flatten the stats."""
    lat_s = lat_s[lat_s > 0]
    if lat_s.size == 0:
        return {}
    ms = lat_s * 1000
    return {"avg_ms": round(float(ms.mean()), 3),
            "p50_ms": round(float(np.percentile(ms, 50)), 3),
            "p95_ms": round(float(np.percentile(ms, 95)), 3),
            "p99_ms": round(float(np.percentile(ms, 99)), 3),
            "max_ms": round(float(ms.max()), 3)}


def _percentiles(lat: np.ndarray) -> str:
    d = _pcts(lat)
    if not d:
        return "no samples"
    return (f"avg {d['avg_ms']:.1f} ms, p50 {d['p50_ms']:.1f}, "
            f"p95 {d['p95_ms']:.1f}, p99 {d['p99_ms']:.1f}, "
            f"max {d['max_ms']:.1f}")


def run_benchmark(opts) -> dict:
    if getattr(opts, "filer", ""):
        return run_benchmark_filer(opts)
    if getattr(opts, "nativeClient", False):
        return run_benchmark_native(opts)
    n, size, conc = opts.n, opts.size, opts.c
    batch = max(1, int(getattr(opts, "assignBatch", 0) or 1))
    master = opts.master
    payload = secrets.token_bytes(size)
    lat_w = np.zeros(n)
    fids: list[str | None] = [None] * n
    headers = {"Content-Type": "application/octet-stream"}

    def write_range(start: int, count: int):
        """One worker chunk: assign in batches, PUT each fid."""
        done = start
        while done < start + count:
            todo = min(batch, start + count - done)
            a = assign(master, count=todo, collection=opts.collection)
            if a.error:
                done += todo
                continue
            hdrs = dict(headers)
            if a.auth:
                hdrs["Authorization"] = f"Bearer {a.auth}"
            for j in range(todo):
                fid = a.fid if j == 0 else f"{a.fid}_{j}"
                t0 = time.perf_counter()
                try:
                    status, _ = _request(a.url, "PUT", f"/{fid}",
                                         body=payload, headers=hdrs)
                except (OSError, http.client.HTTPException):
                    status = 599
                lat_w[done + j] = time.perf_counter() - t0
                if status < 300:
                    fids[done + j] = fid
            done += todo

    per = n // conc
    ranges = [(i * per, per) for i in range(conc)]
    ranges[-1] = (ranges[-1][0], n - ranges[-1][0])
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=conc) as ex:
        list(ex.map(lambda r: write_range(*r), ranges))
    dt_w = time.perf_counter() - t0
    written = [f for f in fids if f]
    wr = {"requests_per_sec": n / dt_w, "total_s": dt_w,
          "failed": n - len(written), "mb_per_sec": n * size / dt_w / 1e6}
    print(f"\nwrite: {wr['requests_per_sec']:.1f} req/s, "
          f"{wr['mb_per_sec']:.2f} MB/s, {dt_w:.2f} s total, "
          f"{wr['failed']} failed"
          + (f" (assign batch {batch})" if batch > 1 else ""))
    ok_mask = np.array([f is not None for f in fids], dtype=bool)
    print(f"write latency: {_percentiles(lat_w[ok_mask])}")

    results = {"write": wr}
    if not getattr(opts, "skipRead", False):
        mc = MasterClient(master)
        lat_r = np.zeros(len(written))
        ok_count = [0] * conc

        def read_range(t: int, start: int, count: int):
            ok = 0
            for i in range(start, min(start + count, len(written))):
                t0 = time.perf_counter()
                try:
                    urls = mc.lookup_file_id(written[i])
                    addr = urls[0].split("//", 1)[1].split("/", 1)[0]
                    status, data = _request(addr, "GET", "/" + written[i])
                    ok += status == 200 and len(data) == size
                except (OSError, IndexError, http.client.HTTPException):
                    pass
                lat_r[i] = time.perf_counter() - t0
            ok_count[t] = ok

        per = max(1, len(written) // conc)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=conc) as ex:
            list(ex.map(lambda a: read_range(*a),
                        [(t, t * per,
                          per if t < conc - 1 else len(written) - t * per)
                         for t in range(conc)]))
        dt_r = time.perf_counter() - t0
        total_ok = sum(ok_count)
        rd = {"requests_per_sec": len(written) / dt_r, "total_s": dt_r,
              "failed": len(written) - total_ok}
        print(f"\nread: {rd['requests_per_sec']:.1f} req/s, {dt_r:.2f} s "
              f"total, {rd['failed']} failed")
        print(f"read latency: {_percentiles(lat_r)}")
        results["read"] = rd
    return results


def run_benchmark_filer(opts) -> dict:
    """Benchmark whole-object PUT/GET THROUGH THE FILER (the plain
    benchmark drives the volume servers directly; this variant goes
    through filer paths and is served by the C++ filer hot plane when
    `server -filer` runs with it)."""
    import ctypes

    from ..native.dataplane import bench_loop

    n, size, conc = opts.n, opts.size, opts.c
    addr = opts.filer
    payload = secrets.token_bytes(size)
    run_id = secrets.token_hex(4)
    # per-worker directories keep no single directory pathological
    jobs = []
    per = n // conc
    for w in range(conc):
        count = per if w < conc - 1 else n - per * (conc - 1)
        jobs.append([f"buckets/bench-{run_id}/w{w:02d}/f{i:07d}"
                     for i in range(count)])

    def run_phase(is_put: bool):
        lats = []
        oks = [0] * len(jobs)

        def worker(i):
            lat = (ctypes.c_int64 * len(jobs[i]))()
            oks[i] = bench_loop(addr, jobs[i],
                                payload if is_put else None, lat)
            lats.append(np.ctypeslib.as_array(lat).copy())

        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=conc) as ex:
            list(ex.map(worker, range(len(jobs))))
        dt = time.perf_counter() - t0
        lat_s = np.concatenate(lats) / 1e9 if lats else np.zeros(0)
        return sum(oks), dt, lat_s

    ok_w, dt_w, lat_w = run_phase(True)
    wr = {"requests_per_sec": n / dt_w, "total_s": dt_w, "failed": n - ok_w,
          "mb_per_sec": n * size / dt_w / 1e6, **_pcts(lat_w)}
    print(f"\nfiler write: {wr['requests_per_sec']:.1f} req/s, "
          f"{wr['mb_per_sec']:.2f} MB/s, {dt_w:.2f} s total, "
          f"{wr['failed']} failed (via {addr})")
    print(f"write latency: {_percentiles(lat_w)}")
    results = {"write": wr}
    if not getattr(opts, "skipRead", False):
        ok_r, dt_r, lat_r = run_phase(False)
        rd = {"requests_per_sec": n / dt_r, "total_s": dt_r,
              "failed": n - ok_r, **_pcts(lat_r)}
        print(f"\nfiler read: {rd['requests_per_sec']:.1f} req/s, "
              f"{dt_r:.2f} s total, {rd['failed']} failed")
        print(f"read latency: {_percentiles(lat_r)}")
        results["read"] = rd
    return results


def run_benchmark_native(opts) -> dict:
    """Compiled-client benchmark: assigns batched through the master, then
    the C++ keepalive loop (native/dataplane.cpp swdp_bench) drives the
    PUT/GET hot loops — the counterpart of the reference's Go client."""
    import ctypes

    from ..native.dataplane import bench_loop

    n, size, conc = opts.n, opts.size, opts.c
    # native client defaults to batched assigns (Go-client parity); an
    # explicit -assignBatch value (incl. 1) is honored
    batch = max(1, int(getattr(opts, "assignBatch", 0) or 64))
    master = opts.master
    payload = secrets.token_bytes(size)

    # plan: reserve all fids up front (count=N assigns), grouped by server
    by_addr: dict[str, list[str]] = {}
    got = 0
    while got < n:
        todo = min(batch, n - got)
        a = assign(master, count=todo, collection=opts.collection)
        if a.error:
            raise RuntimeError(a.error)
        fl = by_addr.setdefault(a.url, [])
        fl.append(a.fid)
        fl.extend(f"{a.fid}_{j}" for j in range(1, todo))
        got += todo

    # split each server's list across conc workers
    jobs = []
    for addr, fl in by_addr.items():
        per = max(1, len(fl) // conc)
        for i in range(0, len(fl), per):
            jobs.append((addr, fl[i:i + per]))

    def run_phase(is_put: bool):
        lats = []
        oks = [0] * len(jobs)

        def worker(i):
            addr, fl = jobs[i]
            lat = (ctypes.c_int64 * len(fl))()
            oks[i] = bench_loop(addr, fl, payload if is_put else None, lat)
            lats.append(np.ctypeslib.as_array(lat).copy())

        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=conc) as ex:
            list(ex.map(worker, range(len(jobs))))
        dt = time.perf_counter() - t0
        lat_s = np.concatenate(lats) / 1e9 if lats else np.zeros(0)
        return sum(oks), dt, lat_s

    ok_w, dt_w, lat_w = run_phase(True)
    wr = {"requests_per_sec": n / dt_w, "total_s": dt_w, "failed": n - ok_w,
          "mb_per_sec": n * size / dt_w / 1e6, **_pcts(lat_w)}
    print(f"\nwrite: {wr['requests_per_sec']:.1f} req/s, "
          f"{wr['mb_per_sec']:.2f} MB/s, {dt_w:.2f} s total, "
          f"{wr['failed']} failed (native client, assign batch {batch})")
    print(f"write latency: {_percentiles(lat_w)}")
    results = {"write": wr}

    if not getattr(opts, "skipRead", False):
        ok_r, dt_r, lat_r = run_phase(False)
        rd = {"requests_per_sec": n / dt_r, "total_s": dt_r,
              "failed": n - ok_r, **_pcts(lat_r)}
        print(f"\nread: {rd['requests_per_sec']:.1f} req/s, {dt_r:.2f} s "
              f"total, {rd['failed']} failed (native client)")
        print(f"read latency: {_percentiles(lat_r)}")
        results["read"] = rd
    return results
