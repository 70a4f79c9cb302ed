"""The S3 identity list in the filer (counterpart of the configuration
store of seaweedfs_tpu/iamapi/__init__.py; SeaweedFS weed/iamapi/).

The identities live at /etc/iam/identity.json in the filer, where the
shell's `s3.configure` writes them and the S3 gateway's `SeaweedS3.
Configure` takes them from. The IAM API server itself (`IamServer`, the
CLI's `iam`) is not part of the port yet: ROADMAP.md A2d (other
gateways).
"""

from __future__ import annotations

import json
import time

from ..pb import filer_pb2, rpc
from ..s3api.auth import Identity

IAM_CONFIG_DIR = "/etc/iam"
IAM_CONFIG_FILE = "identity.json"


class IamConfigStore:
    """Identities <-> /etc/iam/identity.json in the filer."""

    def __init__(self, filer: str):
        self.filer = filer

    @property
    def _stub(self):
        return rpc.filer_stub(rpc.grpc_address(self.filer))

    def load(self) -> list[Identity]:
        try:
            resp = self._stub.LookupDirectoryEntry(
                filer_pb2.LookupDirectoryEntryRequest(
                    directory=IAM_CONFIG_DIR, name=IAM_CONFIG_FILE),
                timeout=10)
        # lint: allow-broad-except(an unreadable identity file reads as no
        # identities, as in the reference; the caller writes a new one)
        except Exception:  # noqa: BLE001
            return []
        if not resp.entry.content:
            return []
        conf = json.loads(resp.entry.content)
        out = []
        for ident in conf.get("identities", []):
            creds = (ident.get("credentials") or [{}])[0]
            out.append(Identity(
                name=ident.get("name", ""),
                access_key=creds.get("accessKey", ""),
                secret_key=creds.get("secretKey", ""),
                actions=ident.get("actions", [])))
        return out

    def save(self, identities: list[Identity]) -> None:
        conf = {"identities": [
            {"name": i.name,
             "credentials": [{"accessKey": i.access_key,
                              "secretKey": i.secret_key}],
             "actions": i.actions}
            for i in identities]}
        entry = filer_pb2.Entry(name=IAM_CONFIG_FILE,
                                content=json.dumps(conf, indent=2).encode())
        entry.attributes.file_mode = 0o600
        entry.attributes.mtime = int(time.time())
        stub = self._stub
        # CreateEntry upserts in the filer; parents are auto-created
        stub.CreateEntry(filer_pb2.CreateEntryRequest(
            directory=IAM_CONFIG_DIR, entry=entry), timeout=10)
