"""Bucket policy storage + evaluation.

Counterpart of seaweedfs_tpu/s3api/policy.py (SeaweedFS
weed/s3api/policy/policy.go) and the bucket
policy handlers (s3api_bucket_policy_handlers.go): an AWS-style JSON policy
document attached to a bucket, evaluated per request alongside identity
actions. Supported subset (what the reference's own evaluator covers):

  * Effect Allow / Deny (explicit Deny wins)
  * Principal "*" / {"AWS": "*"} / {"AWS": [arns or access keys]}
  * Action "s3:*" or concrete names, mapped onto this gateway's verbs
  * Resource "arn:aws:s3:::bucket", "arn:aws:s3:::bucket/*" and
    key-prefix wildcards
"""

from __future__ import annotations

import fnmatch
import json

# s3 policy action name -> gateway action verb (same table the IAM API uses)
_ACTION_VERBS = {
    "s3:GetObject": "Read",
    "s3:GetObjectVersion": "Read",
    "s3:ListBucket": "List",
    "s3:ListBucketVersions": "List",
    "s3:PutObject": "Write",
    "s3:DeleteObject": "Write",
    "s3:DeleteObjectVersion": "Write",
    # tag reads ride the Read action (matching the gateway's _action_for);
    # tag writes are the distinct Tagging action
    "s3:GetObjectTagging": "Read",
    "s3:PutObjectTagging": "Tagging",
    "s3:DeleteObjectTagging": "Tagging",
    "s3:GetBucketAcl": "ReadAcp",
    "s3:PutBucketAcl": "WriteAcp",
    "s3:GetObjectAcl": "ReadAcp",
    "s3:PutObjectAcl": "WriteAcp",
    "s3:*": "*",
    "*": "*",
}


class PolicyError(ValueError):
    pass


class BucketPolicy:
    def __init__(self, doc: dict):
        if not isinstance(doc, dict) or not isinstance(
                doc.get("Statement"), list):
            raise PolicyError("policy must carry a Statement list")
        self.doc = doc
        for st in doc["Statement"]:
            if st.get("Effect") not in ("Allow", "Deny"):
                raise PolicyError(f"bad Effect {st.get('Effect')!r}")

    @classmethod
    def parse(cls, blob: bytes) -> "BucketPolicy":
        try:
            return cls(json.loads(blob))
        except json.JSONDecodeError as e:
            raise PolicyError(f"invalid policy JSON: {e}")

    def to_bytes(self) -> bytes:
        return json.dumps(self.doc).encode()

    # -- evaluation --------------------------------------------------------

    def decide(self, *, principal: str | None, action: str, bucket: str,
               key: str = "") -> str | None:
        """-> "Allow", "Deny", or None (policy silent). `principal` is the
        caller's access key, or None for anonymous."""
        verdict: str | None = None
        for st in self.doc["Statement"]:
            if not self._principal_matches(st.get("Principal"), principal):
                continue
            if not self._action_matches(st.get("Action"), action):
                continue
            if not self._resource_matches(st.get("Resource"), bucket, key):
                continue
            if st["Effect"] == "Deny":
                return "Deny"  # explicit deny short-circuits
            verdict = "Allow"
        return verdict

    @staticmethod
    def _principal_matches(principal, caller: str | None) -> bool:
        if principal is None:
            return False
        if principal == "*":
            return True
        if isinstance(principal, dict):
            aws = principal.get("AWS", [])
            ids = [aws] if isinstance(aws, str) else list(aws)
            if "*" in ids:
                return True
            return caller is not None and any(
                caller == i or i.endswith(f":user/{caller}") for i in ids)
        return False

    @staticmethod
    def _action_matches(actions, verb: str) -> bool:
        if actions is None:
            return False
        names = [actions] if isinstance(actions, str) else list(actions)
        for name in names:
            mapped = _ACTION_VERBS.get(name)
            if mapped == "*" or mapped == verb:
                return True
        return False

    @staticmethod
    def _resource_matches(resources, bucket: str, key: str) -> bool:
        if resources is None:
            return False
        arns = [resources] if isinstance(resources, str) else list(resources)
        bucket_arn = f"arn:aws:s3:::{bucket}"
        object_arn = f"arn:aws:s3:::{bucket}/{key}" if key else bucket_arn
        for arn in arns:
            if arn in ("*", "arn:aws:s3:::*"):
                return True
            if fnmatch.fnmatchcase(bucket_arn, arn) or fnmatch.fnmatchcase(
                    object_arn, arn):
                return True
        return False
