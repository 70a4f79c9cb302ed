"""Client-side AWS Signature V4 signer.

Counterpart of seaweedfs_tpu/s3api/sigv4_client.py, the client side of
the gateway's verifier in auth.py (SeaweedFS
weed/s3api/auth_signature_v4.go). Used by the shell's s3.* traffic
and by tests to produce authenticated requests against any S3
endpoint, including this framework's own gateway.
"""

from __future__ import annotations

import hashlib
import hmac
import time
import urllib.parse


def _uri_encode(s: str, keep_slash: bool = False) -> str:
    safe = "-_.~" + ("/" if keep_slash else "")
    return urllib.parse.quote(s, safe=safe)


def sign_request(method: str, url: str, payload: bytes, access_key: str,
                 secret_key: str, region: str = "us-east-1",
                 service: str = "s3", amz_now: time.struct_time | None = None
                 ) -> dict[str, str]:
    """-> headers dict (Host, X-Amz-Date, X-Amz-Content-Sha256,
    Authorization) for the given request."""
    u = urllib.parse.urlparse(url)
    now = amz_now or time.gmtime()
    amz_date = time.strftime("%Y%m%dT%H%M%SZ", now)
    date = amz_date[:8]
    payload_hash = hashlib.sha256(payload).hexdigest()
    host = u.netloc

    headers = {
        "Host": host,
        "X-Amz-Date": amz_date,
        "X-Amz-Content-Sha256": payload_hash,
    }
    signed_names = sorted(h.lower() for h in headers)
    canonical_headers = "".join(
        f"{name}:{headers[next(h for h in headers if h.lower() == name)].strip()}\n"
        for name in signed_names)
    signed_headers = ";".join(signed_names)

    query_pairs = urllib.parse.parse_qsl(u.query, keep_blank_values=True)
    canonical_query = "&".join(
        f"{_uri_encode(k)}={_uri_encode(v)}"
        for k, v in sorted(query_pairs))

    canonical_request = "\n".join([
        method,
        _uri_encode(urllib.parse.unquote(u.path) or "/", keep_slash=True),
        canonical_query,
        canonical_headers,
        signed_headers,
        payload_hash,
    ])
    scope = f"{date}/{region}/{service}/aws4_request"
    string_to_sign = "\n".join([
        "AWS4-HMAC-SHA256", amz_date, scope,
        hashlib.sha256(canonical_request.encode()).hexdigest()])

    def h(key: bytes, msg: str) -> bytes:
        return hmac.new(key, msg.encode(), hashlib.sha256).digest()

    k = h(("AWS4" + secret_key).encode(), date)
    k = h(k, region)
    k = h(k, service)
    k = h(k, "aws4_request")
    signature = hmac.new(k, string_to_sign.encode(),
                         hashlib.sha256).hexdigest()

    headers["Authorization"] = (
        f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
        f"SignedHeaders={signed_headers}, Signature={signature}")
    return headers


def presign_url(method: str, url: str, access_key: str, secret_key: str,
                *, expires: int = 3600, region: str = "us-east-1",
                service: str = "s3",
                amz_now: time.struct_time | None = None) -> str:
    """Generate a presigned URL (query-string auth, auth_signature_v4.go's
    presigned flow): anyone holding the URL can perform `method` until
    X-Amz-Date + X-Amz-Expires."""
    u = urllib.parse.urlparse(url)
    now = amz_now or time.gmtime()
    amz_date = time.strftime("%Y%m%dT%H%M%SZ", now)
    date = amz_date[:8]
    scope = f"{date}/{region}/{service}/aws4_request"
    qs = dict(urllib.parse.parse_qsl(u.query, keep_blank_values=True))
    qs.update({
        "X-Amz-Algorithm": "AWS4-HMAC-SHA256",
        "X-Amz-Credential": f"{access_key}/{scope}",
        "X-Amz-Date": amz_date,
        "X-Amz-Expires": str(expires),
        "X-Amz-SignedHeaders": "host",
    })
    canonical_query = "&".join(f"{_uri_encode(k)}={_uri_encode(v)}"
                               for k, v in sorted(qs.items()))
    canonical_request = "\n".join([
        method,
        _uri_encode(urllib.parse.unquote(u.path) or "/", keep_slash=True),
        canonical_query,
        f"host:{u.netloc}\n",
        "host",
        "UNSIGNED-PAYLOAD",
    ])
    string_to_sign = "\n".join([
        "AWS4-HMAC-SHA256", amz_date, scope,
        hashlib.sha256(canonical_request.encode()).hexdigest()])

    def h(key: bytes, msg: str) -> bytes:
        return hmac.new(key, msg.encode(), hashlib.sha256).digest()

    k = h(("AWS4" + secret_key).encode(), date)
    k = h(k, region)
    k = h(k, service)
    k = h(k, "aws4_request")
    sig = hmac.new(k, string_to_sign.encode(), hashlib.sha256).hexdigest()
    qs["X-Amz-Signature"] = sig
    return u._replace(query=urllib.parse.urlencode(qs)).geturl()


def _v2_sign(secret_key: str, string_to_sign: str) -> str:
    import base64

    return base64.b64encode(hmac.new(
        secret_key.encode(), string_to_sign.encode(),
        hashlib.sha1).digest()).decode()


def _v2_subresource(query: str) -> str:
    """Signed subresource portion of the query, in the verifier's order."""
    from .auth import IdentityAccessManagement as _IAM

    qs = urllib.parse.parse_qs(query, keep_blank_values=True)
    sub = []
    for key in _IAM._V2_SUBRESOURCES:
        if key in qs:
            v = qs[key][0]
            sub.append(f"{key}={v}" if v else key)
    return "&".join(sub)


def _v2_string_to_sign(method: str, path: str, query: str, date: str,
                       content_type: str = "", content_md5: str = "",
                       amz_headers: dict | None = None) -> str:
    canonical_amz = "".join(
        f"{k.lower()}:{v}\n" for k, v in sorted((amz_headers or {}).items()))
    resource = urllib.parse.quote(urllib.parse.unquote(path), safe="/-_.~")
    sub = _v2_subresource(query)
    if sub:
        resource += "?" + sub
    return "\n".join([method, content_md5, content_type, date,
                      canonical_amz + resource])


def sign_request_v2(method: str, url: str, access_key: str, secret_key: str,
                    content_type: str = "") -> dict[str, str]:
    """Legacy AWS signature v2 headers (counterpart of the gateway's
    _verify_v2; auth_signature_v2.go signatureV2)."""
    u = urllib.parse.urlparse(url)
    date = time.strftime("%a, %d %b %Y %H:%M:%S GMT", time.gmtime())
    sts = _v2_string_to_sign(method, u.path or "/", u.query, date,
                             content_type)
    sig = _v2_sign(secret_key, sts)
    headers = {"Date": date, "Authorization": f"AWS {access_key}:{sig}"}
    if content_type:
        headers["Content-Type"] = content_type
    return headers


def presign_url_v2(method: str, url: str, access_key: str, secret_key: str,
                   *, expires: int = 3600) -> str:
    """Legacy presigned URL: ?AWSAccessKeyId&Expires&Signature."""
    u = urllib.parse.urlparse(url)
    exp = str(int(time.time()) + expires)
    sts = _v2_string_to_sign(method, u.path or "/", u.query, exp)
    sig = _v2_sign(secret_key, sts)
    qs = dict(urllib.parse.parse_qsl(u.query, keep_blank_values=True))
    qs.update({"AWSAccessKeyId": access_key, "Expires": exp,
               "Signature": sig})
    return u._replace(query=urllib.parse.urlencode(qs)).geturl()
