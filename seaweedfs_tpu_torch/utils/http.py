"""Small shared HTTP helpers for the threaded servers and clients.

Conditional requests (conformance pass): the
reference leans on Go's net/http for RFC 7232/7233 semantics; here the
same rules live in three small pure functions shared by the volume and
filer read handlers:

  * `not_modified` — If-None-Match is a LIST of entity-tags (or ``*``)
    compared WEAKLY for GET/HEAD (RFC 7232 §3.2: weak comparison, so
    ``W/"abc"`` matches ``"abc"``), and it takes precedence over
    If-Modified-Since (§3.3).
  * `range_applies` — If-Range (RFC 7233 §3.2): an entity-tag validator
    must match STRONGLY (a weak tag never matches), a date validator
    matches only on exact Last-Modified equality; a failed validator
    means "serve the full 200", never an error.
  * `parse_etag_list` — quote/weak-prefix tolerant splitter.

Scheme plumbing: every data-plane URL the cluster builds for itself
goes through `data_scheme`/`url_for`, so flipping ``SWFS_HTTPS`` moves
the whole fleet (volume + filer + S3 HTTP planes, and every internal
client leg) onto TLS in one switch.
"""

from __future__ import annotations

import email.utils
import os


# -- conditional requests (RFC 7232 / 7233) --------------------------------

def parse_etag_list(value: str) -> list[str]:
    """Split an If-None-Match / If-Match header into entity-tags,
    keeping quotes and W/ prefixes intact. ``*`` yields ["*"]."""
    out = []
    rest = value.strip()
    while rest:
        rest = rest.lstrip(", \t")
        if not rest:
            break
        if rest.startswith("*"):
            return ["*"]
        weak = rest.startswith(("W/", "w/"))
        body = rest[2:] if weak else rest
        if body.startswith('"'):
            end = body.find('"', 1)
            if end < 0:  # unterminated: take the rest verbatim
                out.append(rest)
                break
            tag = body[:end + 1]
            out.append(("W/" if weak else "") + tag)
            rest = body[end + 1:]
        else:
            # token without quotes (lenient: some clients send bare md5s)
            tok, _, rest = rest.partition(",")
            if tok.strip():
                out.append(tok.strip())
    return out


def _opaque(tag: str) -> str:
    """Entity-tag's opaque value: weak prefix stripped, quotes kept."""
    return tag[2:] if tag.startswith(("W/", "w/")) else tag


def weak_etag_match(a: str, b: str) -> bool:
    """RFC 7232 §2.3.2 weak comparison: opaque values equal."""
    return _opaque(a) == _opaque(b)


def strong_etag_match(a: str, b: str) -> bool:
    """Strong comparison: equal AND neither is weak."""
    return (not a.startswith(("W/", "w/"))
            and not b.startswith(("W/", "w/")) and a == b)


def _parse_http_date(value: str) -> float | None:
    try:
        return email.utils.parsedate_to_datetime(value).timestamp()
    except (TypeError, ValueError):
        return None


def not_modified(headers, etag: str, mtime: int) -> bool:
    """Conditional-GET decision (RFC 7232 §3.3 precedence, the reference's
    filer/volume read handlers): If-None-Match wins when present —
    evaluated with WEAK comparison over the full entity-tag list (``*``
    matches any representation); If-Modified-Since is consulted only in
    its absence."""
    inm = headers.get("If-None-Match")
    if inm is not None:
        tags = parse_etag_list(inm)
        if "*" in tags:
            return True
        return any(weak_etag_match(t, etag) for t in tags)
    ims = headers.get("If-Modified-Since")
    if ims and mtime:
        since = _parse_http_date(ims)
        if since is None:
            return False
        return mtime <= since
    return False


def range_applies(headers, etag: str, mtime: int) -> bool:
    """If-Range evaluation (RFC 7233 §3.2): True -> honor the Range
    header; False -> the validator is stale, serve the full 200. No
    If-Range header -> True. An entity-tag validator must match
    STRONGLY; a date validator matches only exact Last-Modified
    equality (a date is only a strong validator when nothing else
    changed in that second — exactness is the conservative read)."""
    ir = headers.get("If-Range")
    if ir is None:
        return True
    ir = ir.strip()
    if ir.startswith(('"', "W/", "w/")):
        return strong_etag_match(ir, etag)
    since = _parse_http_date(ir)
    if since is None or not mtime:
        return False
    return int(since) == int(mtime)


def parse_range(rng_h: str, size: int):
    """'bytes=a-b' -> clamped (start, stop) half-open span; 'bytes=-N' is
    a suffix range (the LAST N bytes); unsatisfiable (start past EOF,
    inverted, empty suffix) -> "invalid" (416 with `Content-Range:
    bytes */size`); malformed -> None (serve the full body, like Go's
    http.ServeContent leniency). Shared by the filer AND volume read
    handlers so both planes answer RFC 7233 identically — the C++ fast
    path serves only clean `bytes=lo-hi`/`lo-` forms and redirects
    everything else here."""
    lo, _, hi = rng_h[len("bytes="):].partition("-")
    try:
        if lo == "" and hi:  # suffix: last N bytes
            n = int(hi)
            if n <= 0 or size <= 0:
                # zero-length representation: every suffix range is
                # unsatisfiable (an empty (0, 0) span would render the
                # malformed 'Content-Range: bytes 0--1/0')
                return "invalid"
            return max(0, size - n), size
        start = int(lo)
        stop = int(hi) + 1 if hi else size
    except ValueError:
        return None
    if start >= size or stop <= start:
        return "invalid"
    return start, min(stop, size)


# -- scheme plumbing (SWFS_HTTPS) ------------------------------------------

def https_on() -> bool:
    """THE process-wide HTTPS gate for the data planes
    (security.tls.https_enabled delegates here — one parse of the
    accepted falsy set, so the listeners and the client legs can never
    read the same env differently)."""
    return (os.environ.get("SWFS_HTTPS", "") or "").lower() \
        not in ("", "0", "false", "off")


def data_scheme() -> str:
    return "https" if https_on() else "http"


def url_for(addr: str, path: str = "") -> str:
    """Scheme-correct URL for a cluster data-plane address."""
    if path and not path.startswith("/"):
        path = "/" + path
    return f"{data_scheme()}://{addr}{path}"


_VERIFY_CACHE: tuple | None = None  # ((env fingerprint), resolved value)


def requests_verify():
    """`verify=` for requests-based clients: the configured CA path
    when HTTPS is on (fail-fast certificate rejection), False for
    self-signed dev clusters, True (inert default) on plain HTTP.
    Cached per env fingerprint — hot request paths resolve this per
    call, and a config-file CA would otherwise re-read and re-parse
    security.toml every time (the file is static per process; the env
    gate is what tests flip)."""
    global _VERIFY_CACHE
    if not https_on():
        return True
    key = (os.environ.get("SWFS_HTTPS", ""),
           os.environ.get("SWFS_HTTPS_CA", ""))
    cached = _VERIFY_CACHE
    if cached is not None and cached[0] == key:
        return cached[1]
    from ..security.tls import requests_verify as _rv

    val = _rv()
    _VERIFY_CACHE = (key, val)
    return val
