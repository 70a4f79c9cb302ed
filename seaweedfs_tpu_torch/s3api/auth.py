"""AWS Signature V4 verification for the S3 gateway.

Counterpart of seaweedfs_tpu/s3api/auth.py (SeaweedFS
weed/s3api/auth_signature_v4.go + auth_credentials.go): identities hold
(accessKey, secretKey, actions); requests are verified by recomputing
the V4 signature over the canonical request. Anonymous access is allowed
when no identities are configured (the reference behaves the same with an
empty s3 config).
"""

from __future__ import annotations

import hashlib
import hmac
import urllib.parse
from dataclasses import dataclass, field


@dataclass
class Identity:
    name: str
    access_key: str
    secret_key: str
    actions: list[str] = field(default_factory=lambda: ["Admin"])

    def allows(self, action: str, bucket: str = "") -> bool:
        for a in self.actions:
            if a == "Admin":
                return True
            a_name, _, a_bucket = a.partition(":")
            if a_name != action:
                continue
            if not a_bucket or a_bucket == bucket or (
                    a_bucket.endswith("*") and bucket.startswith(a_bucket[:-1])):
                return True
        return False


class AuthError(Exception):
    def __init__(self, code: str, message: str):
        super().__init__(message)
        self.code = code


class IdentityAccessManagement:
    def __init__(self, identities: list[Identity] | None = None):
        self.identities = {i.access_key: i for i in (identities or [])}

    @property
    def enabled(self) -> bool:
        return bool(self.identities)

    def lookup(self, access_key: str) -> Identity:
        ident = self.identities.get(access_key)
        if ident is None:
            raise AuthError("InvalidAccessKeyId",
                            "The access key Id you provided does not exist")
        return ident

    def authenticate(self, method: str, path: str, query: str,
                     headers, payload_hash: str) -> Identity | None:
        """-> Identity, or None when the request carries no credentials
        (anonymous). Whether anonymous may proceed is an authorization
        question (bucket ACL / policy) decided by the caller — the
        reference splits authenticate/authorize the same way."""
        if not self.enabled:
            return None
        auth = headers.get("Authorization", "")
        if auth.startswith("AWS4-HMAC-SHA256 "):
            return self._verify_v4(auth, method, path, query, headers,
                                   payload_hash)
        if auth.startswith("AWS "):  # legacy signature v2
            return self._verify_v2(auth, method, path, query, headers)
        qs = urllib.parse.parse_qs(query)
        if "X-Amz-Signature" in qs:
            return self._verify_presigned(method, path, qs, headers)
        if "Signature" in qs and "AWSAccessKeyId" in qs:
            return self._verify_presigned_v2(method, path, query, qs,
                                             headers)
        if auth:
            raise AuthError("AccessDenied", "Unsupported Authorization type")
        return None  # anonymous

    # -- header auth -------------------------------------------------------

    def _verify_v4(self, auth: str, method: str, path: str, query: str,
                   headers, payload_hash: str) -> Identity:
        fields = {}
        for part in auth[len("AWS4-HMAC-SHA256 "):].split(","):
            k, _, v = part.strip().partition("=")
            fields[k] = v
        try:
            cred = fields["Credential"]
            signed_headers = fields["SignedHeaders"].split(";")
            given_sig = fields["Signature"]
        except KeyError as e:
            raise AuthError("AuthorizationHeaderMalformed", f"missing {e}")
        access_key, date, region, service, _ = _split_credential(cred)
        ident = self.lookup(access_key)
        amz_date = headers.get("x-amz-date") or headers.get("X-Amz-Date") or ""
        creq = _canonical_request(method, path, query, headers,
                                  signed_headers, payload_hash)
        sig = _signature(ident.secret_key, amz_date, date, region, service, creq)
        if not hmac.compare_digest(sig, given_sig):
            raise AuthError("SignatureDoesNotMatch",
                            "The request signature we calculated does not "
                            "match the signature you provided")
        return ident

    # -- legacy signature v2 (auth_signature_v2.go) ------------------------

    # subresources included in the canonicalized resource (resourceList)
    _V2_SUBRESOURCES = (
        "acl", "delete", "lifecycle", "location", "logging", "notification",
        "partNumber", "policy", "requestPayment", "response-cache-control",
        "response-content-disposition", "response-content-encoding",
        "response-content-language", "response-content-type",
        "response-expires", "torrent", "uploadId", "uploads", "versionId",
        "versioning", "versions", "website",
    )

    def _v2_string_to_sign(self, method: str, path: str, query: str,
                           headers, date: str) -> str:
        """getStringToSignV2: Verb\\nContent-MD5\\nContent-Type\\nDate\\n
        CanonicalizedAmzHeaders + CanonicalizedResource."""
        amz: dict[str, list[str]] = {}
        for k in headers.keys():
            lk = k.lower()
            if not lk.startswith("x-amz-") or lk in amz:
                continue
            if hasattr(headers, "get_all"):  # email.message.Message
                vals = headers.get_all(k) or []
            else:
                vals = [headers.get(k, "")]
            amz[lk] = [" ".join(str(v).split()) for v in vals]
        canonical_amz = "".join(f"{k}:{','.join(v)}\n"
                                for k, v in sorted(amz.items()))
        qs = urllib.parse.parse_qs(query, keep_blank_values=True)
        sub = []
        for key in self._V2_SUBRESOURCES:
            if key in qs:
                v = qs[key][0]
                sub.append(f"{key}={v}" if v else key)
        resource = urllib.parse.quote(urllib.parse.unquote(path), safe="/-_.~")
        if sub:
            resource += "?" + "&".join(sub)
        return "\n".join([method,
                          headers.get("Content-MD5", "") or "",
                          headers.get("Content-Type", "") or "",
                          date,
                          canonical_amz + resource])

    def _v2_signature(self, secret: str, string_to_sign: str) -> str:
        import base64
        import hashlib as _hashlib

        return base64.b64encode(hmac.new(
            secret.encode(), string_to_sign.encode(),
            _hashlib.sha1).digest()).decode()

    def _verify_v2(self, auth: str, method: str, path: str, query: str,
                   headers) -> Identity:
        """Authorization: AWS AccessKeyId:Signature (doesSignV2Match)."""
        access_key, _, given = auth[len("AWS "):].strip().partition(":")
        if not given:
            raise AuthError("AuthorizationHeaderMalformed", "bad v2 header")
        ident = self.lookup(access_key)
        date = headers.get("Date", "") or headers.get("x-amz-date", "")
        self._check_v2_freshness(date)
        sts = self._v2_string_to_sign(method, path, query, headers, date)
        want = self._v2_signature(ident.secret_key, sts)
        if not hmac.compare_digest(want, given):
            raise AuthError("SignatureDoesNotMatch",
                            "v2 signature mismatch")
        return ident

    @staticmethod
    def _check_v2_freshness(date: str) -> None:
        """v2 signatures carry no payload-hash claim, so bound their replay
        window by the signed Date (AWS's 15-minute skew rule)."""
        import email.utils
        import time as _time

        try:
            signed_at = email.utils.parsedate_to_datetime(date).timestamp()
        except (TypeError, ValueError):
            raise AuthError("AccessDenied", "missing or bad Date header")
        if abs(_time.time() - signed_at) > 900:
            raise AuthError("AccessDenied", "Request has expired")

    def _verify_presigned_v2(self, method: str, path: str, raw_query: str,
                             qs: dict, headers) -> Identity:
        """?AWSAccessKeyId=..&Expires=..&Signature=..
        (doesPresignV2SignatureMatch)."""
        import time as _time

        ident = self.lookup(qs["AWSAccessKeyId"][0])
        expires = qs.get("Expires", [""])[0]
        try:
            if int(expires) < _time.time():
                raise AuthError("AccessDenied", "Request has expired")
        except ValueError:
            raise AuthError("AccessDenied", "bad Expires")
        # strip the auth params from the RAW query (re-encoding decoded
        # values would corrupt '+', '&' or '=' inside them)
        rest = "&".join(
            p for p in raw_query.split("&")
            if p.split("=", 1)[0] not in ("AWSAccessKeyId", "Expires",
                                          "Signature"))
        sts = self._v2_string_to_sign(method, path, rest, headers, expires)
        want = self._v2_signature(ident.secret_key, sts)
        given = qs["Signature"][0]
        if not hmac.compare_digest(want, given):
            raise AuthError("SignatureDoesNotMatch",
                            "presigned v2 signature mismatch")
        return ident

    # -- presigned URLs ----------------------------------------------------

    def _verify_presigned(self, method: str, path: str, qs: dict,
                          headers) -> Identity:
        cred = qs["X-Amz-Credential"][0]
        access_key, date, region, service, _ = _split_credential(cred)
        ident = self.lookup(access_key)
        # expiry window (auth_signature_v4.go doesPresignedSignatureMatch:
        # X-Amz-Expires is mandatory — a presigned URL without it would
        # otherwise validate forever)
        if "X-Amz-Expires" not in qs:
            raise AuthError("AuthorizationQueryParametersError",
                            "X-Amz-Expires is required")
        import datetime as _dt

        try:
            expires = int(qs["X-Amz-Expires"][0])
        except ValueError:
            raise AuthError("AuthorizationQueryParametersError",
                            "X-Amz-Expires must be an integer")
        if not 1 <= expires <= 604800:
            raise AuthError("AuthorizationQueryParametersError",
                            "X-Amz-Expires must be between 1 and 604800")
        try:
            t0 = _dt.datetime.strptime(
                qs.get("X-Amz-Date", [""])[0], "%Y%m%dT%H%M%SZ"
            ).replace(tzinfo=_dt.timezone.utc)
        except ValueError:
            raise AuthError("AccessDenied", "bad X-Amz-Date")
        if _dt.datetime.now(_dt.timezone.utc) > t0 + _dt.timedelta(
                seconds=expires):
            raise AuthError("AccessDenied", "Request has expired")
        signed_headers = qs["X-Amz-SignedHeaders"][0].split(";")
        given_sig = qs["X-Amz-Signature"][0]
        amz_date = qs["X-Amz-Date"][0]
        # canonical query excludes the signature itself
        pairs = []
        for k in sorted(qs):
            if k == "X-Amz-Signature":
                continue
            for v in qs[k]:
                pairs.append(f"{_uri_encode(k)}={_uri_encode(v)}")
        creq = _canonical_request(method, path, "&".join(pairs), headers,
                                  signed_headers, "UNSIGNED-PAYLOAD",
                                  query_is_canonical=True)
        sig = _signature(ident.secret_key, amz_date, date, region, service, creq)
        if not hmac.compare_digest(sig, given_sig):
            raise AuthError("SignatureDoesNotMatch", "presigned signature mismatch")
        return ident


def _split_credential(cred: str):
    parts = cred.split("/")
    if len(parts) != 5:
        raise AuthError("AuthorizationHeaderMalformed", f"bad credential {cred}")
    return parts  # access_key, date, region, service, aws4_request


def _uri_encode(s: str, keep_slash: bool = False) -> str:
    safe = "-_.~" + ("/" if keep_slash else "")
    return urllib.parse.quote(s, safe=safe)


def _canonical_request(method: str, path: str, query: str, headers,
                       signed_headers: list[str], payload_hash: str,
                       query_is_canonical: bool = False) -> str:
    if query_is_canonical:
        cq = query
    else:
        qs = urllib.parse.parse_qs(query, keep_blank_values=True)
        pairs = []
        for k in sorted(qs):
            for v in sorted(qs[k]):
                pairs.append(f"{_uri_encode(k)}={_uri_encode(v)}")
        cq = "&".join(pairs)
    chdrs = ""
    for h in signed_headers:
        v = headers.get(h, "")
        chdrs += f"{h}:{' '.join(v.split())}\n"
    return "\n".join([
        method,
        # decode then encode once: the wire path is already percent-encoded
        # and clients sign the singly-encoded form (S3-style SigV4)
        _uri_encode(urllib.parse.unquote(path), keep_slash=True),
        cq,
        chdrs,
        ";".join(signed_headers),
        payload_hash,
    ])


def _signature(secret: str, amz_date: str, date: str, region: str,
               service: str, canonical_request: str) -> str:
    scope = f"{date}/{region}/{service}/aws4_request"
    string_to_sign = "\n".join([
        "AWS4-HMAC-SHA256", amz_date, scope,
        hashlib.sha256(canonical_request.encode()).hexdigest(),
    ])
    def h(key, msg):
        return hmac.new(key, msg.encode(), hashlib.sha256).digest()
    k = h(("AWS4" + secret).encode(), date)
    k = h(k, region)
    k = h(k, service)
    k = h(k, "aws4_request")
    return hmac.new(k, string_to_sign.encode(), hashlib.sha256).hexdigest()
