"""Shell command environment: master connection + exclusive cluster lock.

Counterpart of seaweedfs_tpu/shell/env.py (SeaweedFS's shell CommandEnv:
weed/shell/commands.go, command_lock_unlock.go, wdclient/exclusive_locks/):
commands that mutate cluster topology must hold the admin lease obtained
via LeaseAdminToken.
"""

from __future__ import annotations

import time

from ..pb import master_pb2, rpc
from ..wdclient import MasterClient

LOCK_NAME = "admin"


class CommandEnv:
    def __init__(self, masters: str | list[str], *, filer: str = ""):
        self.master_client = MasterClient(masters)
        self.filer = filer  # filer address for fs.* commands
        self.cwd = "/"      # fs.cd state
        self._lock_token = 0
        self._lock_ts = 0

    def require_filer(self) -> str:
        if not self.filer:
            raise RuntimeError(
                "this command needs a filer; start the shell with -filer")
        return self.filer

    @property
    def master(self) -> str:
        return self.master_client.current_master

    def master_stub(self):
        return rpc.master_stub(rpc.grpc_address(self.master))

    def volume_stub(self, server_http_addr: str):
        return rpc.volume_stub(rpc.grpc_address(server_http_addr))

    # -- exclusive lock (command_lock_unlock.go) ---------------------------

    def acquire_lock(self, client_name: str = "shell") -> None:
        resp = self.master_stub().LeaseAdminToken(
            master_pb2.LeaseAdminTokenRequest(
                previous_token=self._lock_token,
                previous_lock_time=self._lock_ts,
                lock_name=LOCK_NAME, client_name=client_name,
            ), timeout=10)
        self._lock_token, self._lock_ts = resp.token, resp.lock_ts_ns

    def release_lock(self) -> None:
        if not self._lock_token:
            return
        self.master_stub().ReleaseAdminToken(
            master_pb2.ReleaseAdminTokenRequest(
                previous_token=self._lock_token,
                previous_lock_time=self._lock_ts, lock_name=LOCK_NAME,
            ), timeout=10)
        self._lock_token = self._lock_ts = 0

    @property
    def is_locked(self) -> bool:
        return bool(self._lock_token)

    def confirm_is_locked(self) -> None:
        if not self.is_locked:
            raise RuntimeError(
                "need to run `lock` before this command; `unlock` when done")

    # -- topology helpers --------------------------------------------------

    def volume_list(self) -> master_pb2.VolumeListResponse:
        return self.master_stub().VolumeList(
            master_pb2.VolumeListRequest(), timeout=30)

    def collect_data_nodes(self, topo=None) -> list[master_pb2.DataNodeInfo]:
        """Pass a prefetched topology_info to keep node and rack views on
        one consistent snapshot."""
        out = []
        topo = topo if topo is not None else self.volume_list().topology_info
        for dc in topo.data_center_infos:
            for rack in dc.rack_infos:
                out.extend(rack.data_node_infos)
        return out

    def node_racks(self, topo=None) -> dict[str, tuple[str, str]]:
        """node url -> (data_center, rack) from the master topology."""
        out = {}
        topo = topo if topo is not None else self.volume_list().topology_info
        for dc in topo.data_center_infos:
            for rack in dc.rack_infos:
                for dn in rack.data_node_infos:
                    out[dn.id] = (dc.id, rack.id)
        return out

    def wait_heartbeat(self, seconds: float = 1.2) -> None:
        """Give volume servers a pulse to re-report after a mutation."""
        time.sleep(seconds)
