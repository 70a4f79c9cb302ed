"""Mutual-TLS for the gRPC planes, configured by security.toml.

Rebuild of SeaweedFS weed/security/tls.go: `LoadServerTLS`
(:26) builds server credentials from the ``[grpc.<component>]``
cert/key pair plus the shared ``grpc.ca`` root, with
``RequireClientCert`` — all gRPC TLS is MUTUAL; `LoadClientTLS` (:89)
builds the matching client credentials from ``[grpc.client]`` (or a
component-specific section). When a section is absent or incomplete
both sides fall back to plaintext, exactly like the reference (every
cert field defaults to "" in security.toml and LoadClientTLS returns
insecure creds on any missing file).

Common-name authorization (`allowed_commonNames` /
`grpc.allowed_wildcard_domain`, tls.go:64-76 Authenticator) is
enforced here at the server via each servicer's peer-identity check
hook; grpcio surfaces the verified client cert through
``context.auth_context()``.

The HTTP data planes speak TLS too: `load_http_server_context`
builds an ``ssl.SSLContext`` from the ``[https.<component>]`` cert/key
(mirroring the reference's ``https.volume.*`` / ``https.client.*``
options) or from the ``SWFS_HTTPS*`` env gate, with an optional
client-CA for mutual TLS; `load_http_client_context` / `requests_verify`
give every data-plane client the matching trust anchor. For tests and
the traffic harness, `ensure_self_signed` mints a throwaway CA plus a
SAN=localhost server cert via the ``openssl`` binary (no python
`cryptography` dependency), so a whole spawned cluster can share one
trust root — and rotating just the server cert under the same CA is the
TLS-flap chaos scenario's handshake-only restart.
"""

from __future__ import annotations

import os
import ssl
import subprocess
import threading

import grpc

from ..utils import glog
from ..utils.config import get_path, load_config


def _read(path: str) -> bytes | None:
    if not path:
        return None
    try:
        with open(path, "rb") as f:
            return f.read()
    except OSError as e:
        glog.warning(f"security.toml TLS file {path!r}: {e}")
        return None


def _section(conf: dict, component: str) -> tuple[bytes, bytes, bytes] | None:
    """(ca, cert, key) bytes for grpc.<component>, or None."""
    ca = _read(get_path(conf, "grpc.ca", ""))
    cert = _read(get_path(conf, f"grpc.{component}.cert", ""))
    key = _read(get_path(conf, f"grpc.{component}.key", ""))
    if not (ca and cert and key):
        return None
    return ca, cert, key


def load_server_credentials(component: str, conf: dict | None = None
                            ) -> grpc.ServerCredentials | None:
    """grpc.ServerCredentials for [grpc.<component>] — mutual TLS with
    require_client_auth, or None for plaintext (LoadServerTLS)."""
    conf = load_config("security") if conf is None else conf
    sec = _section(conf, component)
    if sec is None:
        return None
    ca, cert, key = sec
    return grpc.ssl_server_credentials(
        [(key, cert)], root_certificates=ca, require_client_auth=True)


def load_client_credentials(component: str = "client",
                            conf: dict | None = None
                            ) -> grpc.ChannelCredentials | None:
    """grpc.ChannelCredentials for [grpc.client] (LoadClientTLS), or
    None for plaintext."""
    conf = load_config("security") if conf is None else conf
    sec = _section(conf, component)
    if sec is None:
        return None
    ca, cert, key = sec
    return grpc.ssl_channel_credentials(
        root_certificates=ca, private_key=key, certificate_chain=cert)


class CommonNameAuthenticator:
    """tls.go:21 Authenticator: restrict verified client certs to an
    allow-list of common names and/or a wildcard domain."""

    def __init__(self, allowed_common_names: str = "",
                 allowed_wildcard_domain: str = ""):
        self.names = {s.strip() for s in allowed_common_names.split(",")
                      if s.strip()}
        self.wildcard = allowed_wildcard_domain

    @property
    def active(self) -> bool:
        return bool(self.names or self.wildcard)

    def allow(self, common_name: str) -> bool:
        if not self.active:
            return True
        if common_name in self.names:
            return True
        # plain suffix match, exactly the reference (tls.go
        # Authenticate: strings.HasSuffix) — NOT a glob, so metachars
        # in the configured domain stay literal
        return bool(self.wildcard) and common_name.endswith(self.wildcard)

    def check_context(self, context) -> None:
        """Abort the RPC unless the peer cert's CN is allowed."""
        if not self.active:
            return
        auth = context.auth_context() or {}
        cns = [v.decode("utf-8", "replace")
               for v in auth.get("x509_common_name", [])]
        if not any(self.allow(cn) for cn in cns):
            context.abort(grpc.StatusCode.UNAUTHENTICATED,
                          f"client common name {cns} not allowed")


def load_authenticator(component: str, conf: dict | None = None
                       ) -> CommonNameAuthenticator:
    conf = load_config("security") if conf is None else conf
    return CommonNameAuthenticator(
        get_path(conf, f"grpc.{component}.allowed_commonNames", "") or "",
        get_path(conf, "grpc.allowed_wildcard_domain", "") or "")


# -- HTTPS data plane --------------------------------------------
#
# Config resolution order for the HTTP planes, per field:
#   1. SWFS_HTTPS_CERT / SWFS_HTTPS_KEY / SWFS_HTTPS_CA env (the harness
#      and tests inject one shared self-signed pair into every spawned
#      server this way);
#   2. security.toml [https.<component>] cert/key/ca (the reference's
#      https.volume.* option family);
# and the whole plane is gated by SWFS_HTTPS: unset/0 = plain HTTP even
# when certs are configured (so one security.toml can serve TLS and
# plaintext deployments), any other value = TLS required — a configured
# gate with NO resolvable cert is a hard error, not a silent downgrade.


def https_enabled() -> bool:
    # single gate definition: utils.http owns the SWFS_HTTPS parse (it
    # can't import this module's gRPC stack; we can import it freely)
    from ..utils.http import https_on

    return https_on()


def _http_field(component: str, field: str, conf: dict | None) -> str:
    env = os.environ.get(f"SWFS_HTTPS_{field.upper()}", "")
    if env:
        return env
    if conf is None:
        conf = load_config("security")
    return get_path(conf, f"https.{component}.{field}", "") or ""


def load_http_server_context(component: str, conf: dict | None = None
                             ) -> ssl.SSLContext | None:
    """ssl.SSLContext for a data-plane listener, or None for plain HTTP.
    With an `https.<component>.mutual_ca` (or SWFS_HTTPS_MUTUAL_CA) the
    listener REQUIRES client certificates signed by it (the reference's
    mTLS shape); without one it serves ordinary one-way TLS.
    (SWFS_HTTPS_CA / `https.client.ca` is the CLIENT-side trust anchor
    — it never changes what this listener demands.)"""
    if not https_enabled():
        return None
    cert = _http_field(component, "cert", conf)
    key = _http_field(component, "key", conf)
    if not (cert and key):
        raise FileNotFoundError(
            f"SWFS_HTTPS is set but no cert/key for https.{component} "
            f"(set SWFS_HTTPS_CERT/SWFS_HTTPS_KEY or security.toml "
            f"[https.{component}])")
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cert, key)
    mutual = _http_field(component, "mutual_ca", conf)
    if mutual:
        ctx.load_verify_locations(mutual)
        ctx.verify_mode = ssl.CERT_REQUIRED
    return ctx


def load_http_client_context(conf: dict | None = None
                             ) -> ssl.SSLContext | None:
    """Client-side context for dialing the HTTPS data planes: verifies
    the server against SWFS_HTTPS_CA / https.client.ca. With no CA
    configured, verification is DISABLED (self-signed dev clusters) —
    production deployments configure the CA and get fail-fast
    certificate rejection (utils.retry.ssl_error_is_retryable)."""
    if not https_enabled():
        return None
    ca = os.environ.get("SWFS_HTTPS_CA", "") \
        or get_path(conf if conf is not None else load_config("security"),
                    "https.client.ca", "") or ""
    if ca:
        ctx = ssl.create_default_context(cafile=ca)
        ctx.check_hostname = False  # cluster nodes dial by ip:port
        return ctx
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_NONE
    return ctx


def requests_verify():
    """The `verify=` argument for requests-based clients dialing the
    data planes: the configured CA path, or False (self-signed dev).
    HTTPS-on resolution only — callers go through
    utils.http.requests_verify, which gates on https_on() first (and
    returns the inert True on plain HTTP) and caches the result."""
    return os.environ.get("SWFS_HTTPS_CA", "") \
        or get_path(load_config("security"), "https.client.ca", "") \
        or False


_SELF_SIGNED_LOCK = threading.Lock()


def ensure_self_signed(directory: str, *, rotate: bool = False
                       ) -> dict[str, str]:
    """Mint (or reuse) a test CA + localhost server cert in `directory`
    via the openssl binary -> {"cert", "key", "ca"} paths. One CA per
    directory: every server re-using the directory chains to the same
    root, so one SWFS_HTTPS_CA verifies the whole spawned cluster.
    `rotate=True` re-issues ONLY the server cert/key under the existing
    CA — the TLS-flap scenario's certificate rotation (clients keep
    verifying; only live connections break)."""
    os.makedirs(directory, exist_ok=True)
    ca = os.path.join(directory, "ca.pem")
    ca_key = os.path.join(directory, "ca.key")
    cert = os.path.join(directory, "cert.pem")
    key = os.path.join(directory, "key.pem")
    ext = os.path.join(directory, "san.cnf")

    def run(*args):
        subprocess.run(["openssl", *args], check=True,
                       capture_output=True)

    with _SELF_SIGNED_LOCK:
        if not (os.path.exists(ca) and os.path.exists(ca_key)):
            run("genrsa", "-out", ca_key, "2048")
            run("req", "-x509", "-new", "-key", ca_key, "-days", "3650",
                "-subj", "/CN=swfs-test-ca", "-out", ca)
        if rotate or not (os.path.exists(cert) and os.path.exists(key)):
            with open(ext, "w") as f:
                f.write("subjectAltName=DNS:localhost,IP:127.0.0.1\n")
            csr = os.path.join(directory, "srv.csr")
            run("genrsa", "-out", key, "2048")
            run("req", "-new", "-key", key, "-subj", "/CN=localhost",
                "-out", csr)
            run("x509", "-req", "-in", csr, "-CA", ca, "-CAkey", ca_key,
                "-CAcreateserial", "-days", "3650", "-extfile", ext,
                "-out", cert)
    return {"cert": cert, "key": key, "ca": ca}


def https_env(paths: dict[str, str]) -> dict[str, str]:
    """The env block that switches a spawned server/client process onto
    the given self-signed pair (harness/test helper)."""
    return {"SWFS_HTTPS": "1", "SWFS_HTTPS_CERT": paths["cert"],
            "SWFS_HTTPS_KEY": paths["key"], "SWFS_HTTPS_CA": paths["ca"]}
