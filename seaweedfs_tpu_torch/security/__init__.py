"""Security: JWT-authorized writes/reads, IP-whitelist guard.

Rebuild of SeaweedFS weed/security/ — `GenJwtForVolumeServer` /
`GenJwtForFilerServer` (jwt.go:30,53) become HS256 tokens minted per fid;
`Guard` (guard.go:52) wraps handlers with an IP whitelist. TLS material for
gRPC (tls.go) is carried as file paths in SecurityConfig and handed to
grpc.ssl_* credentials when set.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import ipaddress
import json
import time
from dataclasses import dataclass, field


def _b64(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _unb64(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


class JwtError(Exception):
    pass


def encode_jwt(claims: dict, key: bytes) -> str:
    """HS256 JWT (the signing scheme the reference's golang-jwt use compiles
    down to for symmetric keys)."""
    header = _b64(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
    payload = _b64(json.dumps(claims, separators=(",", ":")).encode())
    signing_input = f"{header}.{payload}".encode()
    sig = hmac.new(key, signing_input, hashlib.sha256).digest()
    return f"{header}.{payload}.{_b64(sig)}"


def decode_jwt(token: str, key: bytes) -> dict:
    try:
        header, payload, sig = token.split(".")
    except ValueError:
        raise JwtError("malformed token")
    signing_input = f"{header}.{payload}".encode()
    expect = hmac.new(key, signing_input, hashlib.sha256).digest()
    if not hmac.compare_digest(expect, _unb64(sig)):
        raise JwtError("bad signature")
    claims = json.loads(_unb64(payload))
    if "exp" in claims and claims["exp"] < time.time():
        raise JwtError("token expired")
    return claims


def normalize_fid(fid: str) -> str:
    """Canonical token scope for a request fid: strip the filename
    extension ("3,01ab.jpg" -> "3,01ab"). The delta suffix ("3,01ab_1")
    is NOT stripped — the delta offsets the needle KEY
    (storage/file_id.py parse_needle_id_cookie), i.e. names a different
    needle, so a token must be minted for the exact delta it covers."""
    return fid.split(".", 1)[0]


def gen_write_jwt(key: bytes, fid: str, expires_sec: int = 10) -> str:
    """GenJwtForVolumeServer (jwt.go:30): authorizes one fid write."""
    if not key:
        return ""
    return encode_jwt(
        {"exp": int(time.time()) + expires_sec, "fid": normalize_fid(fid)},
        key)


def gen_read_jwt(key: bytes, fid: str, expires_sec: int = 10) -> str:
    if not key:
        return ""
    return encode_jwt(
        {"exp": int(time.time()) + expires_sec, "fid": normalize_fid(fid)},
        key)


def verify_fid_jwt(token: str, key: bytes, fid: str) -> None:
    """Token must cover exactly this fid.

    The reference requires exact equality with the filename extension
    already stripped from the request (volume_server_handlers.go:183,
    ``sc.Fid == vid+","+fid``). Prefix matching (or an empty fid claim,
    which would prefix-match everything) would let a token minted for one
    needle authorize writes to any needle whose hex fid extends it. Both
    sides are normalized (see normalize_fid) so tokens minted from
    extension-bearing paths — e.g. by the replica fan-out, which signs the
    raw request path — still verify.
    """
    claims = decode_jwt(token, key)
    claimed = normalize_fid(claims.get("fid", ""))
    base = normalize_fid(fid)
    if not claimed or claimed != base:
        raise JwtError(f"token fid {claimed!r} does not match {base!r}")


@dataclass
class Guard:
    """IP whitelist gate (guard.go:52). Empty whitelist = open."""

    whitelist: list[str] = field(default_factory=list)
    signing_key: bytes = b""
    read_signing_key: bytes = b""
    expires_sec: int = 10

    def _networks(self):
        if not hasattr(self, "_nets"):
            nets = []
            for item in self.whitelist:
                try:
                    if "/" in item:
                        nets.append(ipaddress.ip_network(item, strict=False))
                    else:
                        nets.append(ipaddress.ip_network(item + "/32"))
                except ValueError:
                    continue
            self._nets = nets
        return self._nets

    def is_allowed(self, remote_ip: str) -> bool:
        if not self.whitelist:
            return True
        try:
            addr = ipaddress.ip_address(remote_ip)
        except ValueError:
            return False
        return any(addr in net for net in self._networks())

    def check_write_jwt(self, token: str, fid: str) -> None:
        if not self.signing_key:
            return
        if not token:
            raise JwtError("missing write jwt")
        verify_fid_jwt(token, self.signing_key, fid)

    def check_read_jwt(self, token: str, fid: str) -> None:
        if not self.read_signing_key:
            return
        if not token:
            raise JwtError("missing read jwt")
        verify_fid_jwt(token, self.read_signing_key, fid)
