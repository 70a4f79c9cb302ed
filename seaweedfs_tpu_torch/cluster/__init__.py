"""Cluster membership registry: filer/broker groups with leader hinting.

Counterpart of seaweedfs_tpu/cluster/__init__.py (SeaweedFS
weed/cluster/cluster.go): the master tracks
which filers (and message-queue brokers) are alive, grouped by
``filer_group``, and designates up to three of them per group as
"leaders" — the nodes other filers aggregate metadata from and clients
prefer. Membership changes produce update events that the master pushes
to every KeepConnected subscriber (cluster.go:92-112, ensureGroupLeaders
at :236).

Semantics kept from the reference:
  * membership is refcounted per address (a node that connects twice must
    disconnect twice before it is removed, cluster.go:63-90);
  * at most MAX_LEADERS leaders per (group, type); a joining node fills a
    vacant slot, a departing leader is replaced by the FRESHEST remaining
    member (least likely to churn away, cluster.go:273-298);
  * master-type nodes are not tracked here — Raft owns master membership,
    so add/remove just echo an update event (cluster.go:168-178).

This is a host-side control-plane structure: pure Python, no pb imports;
the master server converts NodeUpdate events into KeepConnectedResponse
messages.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

MASTER_TYPE = "master"
VOLUME_TYPE = "volumeServer"
FILER_TYPE = "filer"
BROKER_TYPE = "broker"

MAX_LEADERS = 3


@dataclass
class ClusterNode:
    address: str
    version: str = ""
    data_center: str = ""
    rack: str = ""
    created_ts: float = field(default_factory=time.time)
    counter: int = 1


@dataclass(frozen=True)
class NodeUpdate:
    """One membership/leadership change to push to KeepConnected clients."""

    node_type: str
    address: str
    filer_group: str = ""
    is_leader: bool = False
    is_add: bool = True


class _Group:
    """Members + leader slots for one (filer_group, node_type)."""

    def __init__(self) -> None:
        self.members: dict[str, ClusterNode] = {}
        self.leaders: list[str | None] = [None] * MAX_LEADERS

    # -- leader slots ------------------------------------------------------

    def is_leader(self, address: str) -> bool:
        return address in self.leaders

    def leader_addresses(self) -> list[str]:
        return [a for a in self.leaders if a]

    def _add_leader_if_vacant(self, address: str) -> bool:
        if self.is_leader(address):
            return False
        for i, slot in enumerate(self.leaders):
            if slot is None:
                self.leaders[i] = address
                return True
        return False

    def _remove_leader(self, address: str) -> bool:
        if not self.is_leader(address):
            return False
        self.leaders[self.leaders.index(address)] = None
        return True


class Cluster:
    """Thread-safe registry over all (filer_group, node_type) groups."""

    def __init__(self) -> None:
        self._groups: dict[tuple[str, str], _Group] = {}
        self._mu = threading.Lock()

    def _group(self, filer_group: str, node_type: str,
               create: bool = False) -> _Group | None:
        key = (filer_group, node_type)
        g = self._groups.get(key)
        if g is None and create:
            g = self._groups[key] = _Group()
        return g

    # -- membership --------------------------------------------------------

    def add_cluster_node(self, filer_group: str, node_type: str,
                         address: str, *, version: str = "",
                         data_center: str = "",
                         rack: str = "") -> list[NodeUpdate]:
        """Register a node connection; returns update events to broadcast."""
        if node_type == MASTER_TYPE:
            return [NodeUpdate(node_type, address, is_add=True)]
        if node_type not in (FILER_TYPE, BROKER_TYPE):
            return []
        with self._mu:
            g = self._group(filer_group, node_type, create=True)
            existing = g.members.get(address)
            if existing is not None:
                existing.counter += 1
                return []
            g.members[address] = ClusterNode(
                address, version=version, data_center=data_center, rack=rack)
            became_leader = g._add_leader_if_vacant(address)
            return [NodeUpdate(node_type, address, filer_group=filer_group,
                               is_leader=became_leader, is_add=True)]

    def remove_cluster_node(self, filer_group: str, node_type: str,
                            address: str) -> list[NodeUpdate]:
        """Unregister one connection; refcounted. May promote a new leader."""
        if node_type == MASTER_TYPE:
            return [NodeUpdate(node_type, address, is_add=False)]
        with self._mu:
            g = self._group(filer_group, node_type)
            if g is None:
                return []
            node = g.members.get(address)
            if node is None:
                return []
            node.counter -= 1
            if node.counter > 0:
                return []
            del g.members[address]
            if not g._remove_leader(address):
                return [NodeUpdate(node_type, address,
                                   filer_group=filer_group,
                                   is_leader=False, is_add=False)]
            out = [NodeUpdate(node_type, address, filer_group=filer_group,
                              is_leader=True, is_add=False)]
            # promote the freshest non-leader member: the node that joined
            # most recently is the least likely to be on its way out
            candidates = [n for n in g.members.values()
                          if not g.is_leader(n.address)]
            if candidates:
                freshest = max(candidates, key=lambda n: n.created_ts)
                if g._add_leader_if_vacant(freshest.address):
                    out.append(NodeUpdate(node_type, freshest.address,
                                          filer_group=filer_group,
                                          is_leader=True, is_add=True))
            return out

    # -- queries -----------------------------------------------------------

    def list_cluster_nodes(self, filer_group: str,
                           node_type: str) -> list[ClusterNode]:
        with self._mu:
            g = self._group(filer_group, node_type)
            return list(g.members.values()) if g else []

    def list_leaders(self, filer_group: str, node_type: str) -> list[str]:
        with self._mu:
            g = self._group(filer_group, node_type)
            return g.leader_addresses() if g else []

    def is_one_leader(self, filer_group: str, node_type: str,
                      address: str) -> bool:
        with self._mu:
            g = self._group(filer_group, node_type)
            return g.is_leader(address) if g else False
