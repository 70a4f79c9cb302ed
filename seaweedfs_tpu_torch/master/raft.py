"""Raft consensus for master HA.

Counterpart of seaweedfs_tpu/master/raft.py (SeaweedFS
weed/server/raft_server.go + raft_hashicorp.go; SeaweedFS ships both a goraft and a hashicorp/raft backend; this is
one implementation with pluggable transports). The replicated state
machine is tiny, exactly like the reference's: MaxVolumeId commands
(weed/topology/cluster_commands.go) so every master allocates disjoint
volume ids; leadership gates Assign/grow operations and is advertised to
clients via KeepConnected.

Full Raft per the paper: randomized election timeouts, term/vote/log
persistence, log matching + conflict truncation, commit on majority
match, snapshot/compaction on restart.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from dataclasses import dataclass, field

from ..utils import glog, locks

FOLLOWER, CANDIDATE, LEADER = "follower", "candidate", "leader"


@dataclass
class LogEntry:
    term: int
    index: int
    command: dict = field(default_factory=dict)


class NotLeader(Exception):
    def __init__(self, leader: str | None):
        super().__init__(f"not the leader (leader: {leader or 'unknown'})")
        self.leader = leader


class LocalTransport:
    """In-process transport: a shared registry of nodes (tests +
    single-process multi-master)."""

    def __init__(self, registry: dict | None = None):
        self.registry = registry if registry is not None else {}
        self.partitioned: set[str] = set()  # node ids cut off (tests)

    def register(self, node: "RaftNode") -> None:
        self.registry[node.node_id] = node

    def call(self, target: str, method: str, payload: dict) -> dict | None:
        node = self.registry.get(target)
        if node is None or target in self.partitioned or \
                payload.get("_from") in self.partitioned:
            return None
        try:
            return getattr(node, "handle_" + method)(payload)
        # lint: allow-broad-except(an in-process peer that raises is an
        # unreachable peer, as HttpTransport reads a failed POST)
        except Exception:
            return None


class HttpTransport:
    """POST JSON to a peer master's /cluster/raft endpoint
    (the goraft backend rides the master HTTP port the same way)."""

    # timeout must stay well under ELECTION_MIN: a slow/black-holed peer
    # otherwise delays the whole heartbeat round past the election timeout
    # and healthy followers keep deposing the leader
    TIMEOUT = 0.3

    def call(self, target: str, method: str, payload: dict) -> dict | None:
        import requests

        from ..utils.http import requests_verify, url_for

        try:
            r = requests.post(url_for(target, "/cluster/raft"),
                              json={"method": method, "payload": payload},
                              timeout=self.TIMEOUT,
                              verify=requests_verify())
            if r.status_code == 200:
                return r.json()
        except requests.RequestException:
            pass
        return None


class RaftNode:
    HEARTBEAT = 0.15
    ELECTION_MIN, ELECTION_MAX = 0.5, 1.0

    def __init__(self, node_id: str, peers: list[str], apply_fn, *,
                 transport=None, state_dir: str | None = None,
                 snapshot_fn=None, restore_fn=None):
        self.node_id = node_id
        self.peers = [p for p in peers if p != node_id]
        self.apply_fn = apply_fn
        self.snapshot_fn = snapshot_fn  # () -> dict
        self.restore_fn = restore_fn    # dict -> None
        self.transport = transport or HttpTransport()
        self.state_dir = state_dir

        self.term = 0
        self.voted_for: str | None = None
        self.log: list[LogEntry] = []
        self.snapshot_index = 0  # last log index folded into the snapshot
        self.snapshot_term = 0
        self.commit_index = 0
        self.last_applied = 0
        self.role = FOLLOWER
        self.leader_id: str | None = None
        self._removed = False  # dropped from membership by a config entry

        self._next_index: dict[str, int] = {}
        self._match_index: dict[str, int] = {}
        self._snap_cache: tuple[int, dict] | None = None  # (index, state)
        self._snap_sent_at: dict[str, float] = {}  # peer -> last send time
        # raft state lock on the lock witness: rank 50 sits between
        # master.vid_propose (40, which proposes INTO raft) and the
        # admin/keepalive planes — commit waiters share the same lock
        self._mu = locks.wrlock("raft.mu", rank=50)
        self._commit_cv = locks.wcondition("raft.mu", lock=self._mu)
        self._election_deadline = 0.0
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        from concurrent.futures import ThreadPoolExecutor

        self._pool = ThreadPoolExecutor(
            max_workers=max(4, 2 * len(self.peers)),
            thread_name_prefix=f"raft-{node_id}")
        self._load_state()

    # -- persistence (raft_server.go resumeState) --------------------------

    def _state_path(self) -> str | None:
        if not self.state_dir:
            return None
        os.makedirs(self.state_dir, exist_ok=True)
        return os.path.join(
            self.state_dir, f"raft-{self.node_id.replace(':', '_')}.json")

    def _persist(self) -> None:
        path = self._state_path()
        if not path:
            return
        snap = self.snapshot_fn() if self.snapshot_fn else None
        blob = {
            "term": self.term, "voted_for": self.voted_for,
            "commit_index": self.commit_index,
            "snapshot_index": self.snapshot_index,
            "snapshot_term": self.snapshot_term,
            "snapshot": snap,
            "peers": list(self.peers),  # survives config-entry compaction
            "removed": self._removed,  # a removed node must stay removed
            "log": [{"term": e.term, "index": e.index,
                     "command": e.command} for e in self.log],
        }
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(blob, f)
        os.replace(tmp, path)

    def _load_state(self) -> None:
        path = self._state_path()
        if not path or not os.path.exists(path):
            return
        with open(path) as f:
            blob = json.load(f)
        self.term = blob["term"]
        self.voted_for = blob.get("voted_for")
        self.snapshot_index = blob.get("snapshot_index", 0)
        self.snapshot_term = blob.get("snapshot_term", 0)
        self.log = [LogEntry(e["term"], e["index"], e["command"])
                    for e in blob["log"]]
        if blob.get("peers") is not None:
            self.peers = [p for p in blob["peers"] if p != self.node_id]
        # without this a removed node restarting with peers=[] would
        # self-elect as a phantom single-node leader (split brain)
        self._removed = bool(blob.get("removed", False))
        if blob.get("snapshot") is not None and self.restore_fn:
            self.restore_fn(blob["snapshot"])
            self.commit_index = self.last_applied = self.snapshot_index
        # replay ONLY entries known committed at persist time — replaying
        # past the durable commit point would apply entries a new leader
        # may since have overwritten (Raft safety)
        durable_commit = blob.get("commit_index", self.snapshot_index)
        for e in self.log:
            if self.last_applied < e.index <= durable_commit:
                if e.command.get("op") == "raft_config":
                    self._apply_config(e.command)
                elif e.command.get("op") != "noop":
                    self.apply_fn(e.command)
                self.commit_index = self.last_applied = e.index

    def compact(self) -> None:
        """Fold applied entries into the snapshot (raft snapshot).

        Requires a snapshot_fn: without one there is nothing to send a
        lagging follower via InstallSnapshot, so discarding entries would
        silently lose state for any peer behind the compaction point.
        """
        with self._mu:
            if self.snapshot_fn is None:
                return
            keep = [e for e in self.log if e.index > self.last_applied]
            if len(keep) != len(self.log):
                folded = [e for e in self.log
                          if e.index <= self.last_applied]
                if folded:
                    self.snapshot_index = folded[-1].index
                    self.snapshot_term = folded[-1].term
                self.log = keep
            self._persist()

    # -- log helpers -------------------------------------------------------

    def _last_index(self) -> int:
        return self.log[-1].index if self.log else self.snapshot_index

    def _last_term(self) -> int:
        return self.log[-1].term if self.log else self.snapshot_term

    def _entry_at(self, index: int) -> LogEntry | None:
        for e in self.log:
            if e.index == index:
                return e
        return None

    def _term_at(self, index: int) -> int | None:
        if index == 0:
            return 0
        if index == self.snapshot_index:
            return self.snapshot_term
        e = self._entry_at(index)
        return e.term if e else None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self._reset_election_timer()
        t = threading.Thread(target=self._ticker, daemon=True)
        t.start()
        self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        with self._mu:
            self._persist()
        self._pool.shutdown(wait=False, cancel_futures=True)

    def _reset_election_timer(self) -> None:
        self._election_deadline = time.monotonic() + random.uniform(
            self.ELECTION_MIN, self.ELECTION_MAX)

    def _ticker(self) -> None:
        while not self._stop.is_set():
            with self._mu:
                role = self.role
            if role == LEADER:
                self._broadcast_append()
                self._stop.wait(self.HEARTBEAT)
            else:
                if time.monotonic() >= self._election_deadline \
                        and not self._removed:
                    self._run_election()
                self._stop.wait(0.02)

    # -- election ----------------------------------------------------------

    def _run_election(self) -> None:
        with self._mu:
            if not self.peers:  # single node: immediate leadership
                self.term += 1
                self._become_leader()
                return
            self.role = CANDIDATE
            self.term += 1
            self.voted_for = self.node_id
            term = self.term
            self._persist()
            self._reset_election_timer()
            last_index, last_term = self._last_index(), self._last_term()
        votes = 1
        payload = {"_from": self.node_id, "term": term,
                   "candidate": self.node_id,
                   "last_log_index": last_index, "last_log_term": last_term}
        for resp in self._fanout("request_vote",
                                 {p: payload for p in self.peers}).values():
            if resp is None:
                continue
            with self._mu:
                if resp["term"] > self.term:
                    self._step_down(resp["term"])
                    return
                if resp.get("granted") and self.role == CANDIDATE and \
                        self.term == term:
                    votes += 1
        with self._mu:
            if self.role == CANDIDATE and self.term == term and \
                    votes * 2 > len(self.peers) + 1:
                self._become_leader()

    def _become_leader(self) -> None:
        self.role = LEADER
        self.leader_id = self.node_id
        nxt = self._last_index() + 1
        self._next_index = {p: nxt for p in self.peers}
        self._match_index = {p: 0 for p in self.peers}
        # no-op entry at the new term (Raft §8): the commit rule only counts
        # current-term entries, so without this a prior leader's tail (e.g.
        # the config entry that removed it) would stay uncommitted on the
        # followers until the next client proposal
        if self.peers:
            self.log.append(LogEntry(self.term, nxt, {"op": "noop"}))
            self._persist()
        glog.info(f"raft: {self.node_id} became leader (term {self.term})")

    def _step_down(self, term: int) -> None:
        if term > self.term:
            self.term = term
            self.voted_for = None
        self.role = FOLLOWER
        self._persist()
        self._reset_election_timer()

    # -- RPC handlers ------------------------------------------------------

    def _is_member(self, node: str) -> bool:
        return node == self.node_id or node in self.peers

    def handle_request_vote(self, p: dict) -> dict:
        with self._mu:
            # a server removed from the cluster must not be able to win —
            # or even disturb — elections (its campaigns would otherwise
            # inflate terms and depose the live leader forever). Don't
            # adopt its term either.
            if not self._is_member(p["candidate"]):
                return {"term": self.term, "granted": False}
            if p["term"] < self.term:
                return {"term": self.term, "granted": False}
            if p["term"] > self.term:
                self._step_down(p["term"])
            up_to_date = (p["last_log_term"], p["last_log_index"]) >= \
                (self._last_term(), self._last_index())
            if up_to_date and self.voted_for in (None, p["candidate"]):
                self.voted_for = p["candidate"]
                self._persist()
                self._reset_election_timer()
                return {"term": self.term, "granted": True}
            return {"term": self.term, "granted": False}

    def handle_append_entries(self, p: dict) -> dict:
        with self._mu:
            if not self._is_member(p["leader"]):
                # heartbeats from a removed ex-leader must not reset our
                # election timer or drag our term around
                return {"term": self.term, "success": False}
            if p["term"] < self.term:
                return {"term": self.term, "success": False}
            if p["term"] > self.term or self.role != FOLLOWER:
                self._step_down(p["term"])
            self.term = p["term"]
            self.leader_id = p["leader"]
            self._reset_election_timer()
            prev_index, prev_term = p["prev_index"], p["prev_term"]
            if prev_index > 0:
                t = self._term_at(prev_index)
                if t is None or t != prev_term:
                    return {"term": self.term, "success": False}
            for ent in p["entries"]:
                e = LogEntry(ent["term"], ent["index"], ent["command"])
                existing = self._entry_at(e.index)
                if existing is not None and existing.term != e.term:
                    # conflict: truncate from here
                    self.log = [x for x in self.log if x.index < e.index]
                    existing = None
                if existing is None:
                    self.log.append(e)
            if p["entries"]:
                self._persist()
            if p["leader_commit"] > self.commit_index:
                self.commit_index = min(p["leader_commit"],
                                        self._last_index())
                self._apply_committed()
            return {"term": self.term, "success": True}

    def handle_install_snapshot(self, p: dict) -> dict:
        """InstallSnapshot (Raft §7): a follower whose next entry was
        compacted away on the leader restores the leader's state machine
        snapshot, then resumes AppendEntries past it."""
        with self._mu:
            if p["term"] < self.term:
                return {"term": self.term, "ok": False}
            if p["term"] > self.term or self.role != FOLLOWER:
                self._step_down(p["term"])
            self.term = p["term"]
            self.leader_id = p["leader"]
            self._reset_election_timer()
            idx, tm = p["snapshot_index"], p["snapshot_term"]
            if idx <= self.commit_index:
                # stale: we already have (and applied) everything it covers
                return {"term": self.term, "ok": True}
            if self.restore_fn is None:
                return {"term": self.term, "ok": False}
            self.restore_fn(p["snapshot"])
            self.snapshot_index, self.snapshot_term = idx, tm
            # keep only the log suffix past the snapshot
            self.log = [e for e in self.log if e.index > idx]
            self.commit_index = idx
            self.last_applied = idx
            self._persist()
            return {"term": self.term, "ok": True}

    # -- replication -------------------------------------------------------

    def _fanout(self, method: str, payloads: dict[str, dict]
                ) -> dict[str, dict | None]:
        """Call all peers concurrently so one slow/dead peer can't stretch
        the round past the election timeout."""
        if not payloads:
            return {}
        if len(payloads) == 1:
            peer, payload = next(iter(payloads.items()))
            return {peer: self.transport.call(peer, method, payload)}
        futs = {p: self._pool.submit(self.transport.call, p, method, pl)
                for p, pl in payloads.items()}
        return {p: f.result() for p, f in futs.items()}

    def _broadcast_append(self) -> None:
        with self._mu:
            if self.role != LEADER:
                return
            term = self.term
            peers = list(self.peers)
        payloads: dict[str, dict] = {}
        sent: dict[str, tuple[int, list]] = {}
        snap_payloads: dict[str, dict] = {}
        snap_index = 0
        with self._mu:
            for peer in peers:
                nxt = self._next_index.get(peer, self._last_index() + 1)
                if nxt <= self.snapshot_index and self.snapshot_fn:
                    # the peer's next entry was compacted away: ship the
                    # live state machine snapshot instead. It covers
                    # exactly the applied prefix, so label it last_applied.
                    # The built snapshot is cached until the state machine
                    # advances, and resends to a peer are rate-limited so a
                    # dead/lagging peer doesn't cost a rebuild+reship every
                    # 150ms heartbeat.
                    now = time.monotonic()
                    if now - self._snap_sent_at.get(peer, 0.0) < 1.0:
                        continue
                    if self._snap_cache is None or \
                            self._snap_cache[0] != self.last_applied:
                        self._snap_cache = (self.last_applied,
                                            self.snapshot_fn())
                    snap_index = self._snap_cache[0]
                    if not snap_payloads:
                        snap = {
                            "_from": self.node_id, "term": term,
                            "leader": self.node_id,
                            "snapshot_index": snap_index,
                            "snapshot_term":
                                self._term_at(snap_index) or self.term,
                            "snapshot": self._snap_cache[1],
                        }
                    snap_payloads[peer] = snap
                    self._snap_sent_at[peer] = now
                    continue
                prev_index = nxt - 1
                prev_term = self._term_at(prev_index) or 0
                entries = [{"term": e.term, "index": e.index,
                            "command": e.command}
                           for e in self.log if e.index >= nxt]
                sent[peer] = (nxt, entries)
                payloads[peer] = {
                    "_from": self.node_id, "term": term,
                    "leader": self.node_id, "prev_index": prev_index,
                    "prev_term": prev_term, "entries": entries,
                    "leader_commit": self.commit_index}
        for peer, resp in self._fanout("install_snapshot",
                                       snap_payloads).items():
            if resp is None:
                continue
            with self._mu:
                if resp["term"] > self.term:
                    self._step_down(resp["term"])
                    return
                if resp.get("ok"):
                    self._match_index[peer] = max(
                        self._match_index.get(peer, 0), snap_index)
                    self._next_index[peer] = snap_index + 1
                    self._snap_sent_at.pop(peer, None)
        for peer, resp in self._fanout("append_entries", payloads).items():
            if resp is None:
                continue
            nxt, entries = sent[peer]
            with self._mu:
                if resp["term"] > self.term:
                    self._step_down(resp["term"])
                    return
                if resp["success"]:
                    if entries:
                        self._match_index[peer] = entries[-1]["index"]
                        self._next_index[peer] = entries[-1]["index"] + 1
                else:
                    self._next_index[peer] = max(1, nxt - 1)
        with self._mu:
            if self.role != LEADER:
                return
            # advance commit to the highest majority-matched index
            for e in reversed(self.log):
                if e.index <= self.commit_index or e.term != self.term:
                    continue
                matched = 1 + sum(1 for p in self.peers
                                  if self._match_index.get(p, 0) >= e.index)
                if matched * 2 > len(self.peers) + 1:
                    self.commit_index = e.index
                    self._apply_committed()
                    break

    def _apply_committed(self) -> None:
        while self.last_applied < self.commit_index:
            self.last_applied += 1
            e = self._entry_at(self.last_applied)
            if e is None:
                continue
            if e.command.get("op") == "raft_config":
                self._apply_config(e.command)
            elif e.command.get("op") != "noop":
                self.apply_fn(e.command)
        self._commit_cv.notify_all()

    def _apply_config(self, cmd: dict) -> None:
        """Replicated single-step membership change (cluster_commands.go /
        raft AddVoter-RemoveServer, without joint consensus — adequate for
        one-at-a-time add/remove, which is all the shell exposes)."""
        members = list(cmd.get("peers", []))
        if self.node_id not in members:
            # we were removed: stop participating (members refuse our
            # votes/appends; _removed stops our own campaigning). Re-joining
            # requires a restart with the current member list + raft.add.
            self.peers = []
            self._removed = True
            if self.role == LEADER:
                self.role = FOLLOWER
                self.leader_id = None
            return
        self.peers = [p for p in members if p != self.node_id]
        for p in self.peers:
            self._next_index.setdefault(p, self._last_index() + 1)
            self._match_index.setdefault(p, 0)

    # -- client API --------------------------------------------------------

    def propose(self, command: dict, timeout: float = 5.0) -> int:
        """Replicate a command; returns its log index once committed."""
        with self._mu:
            if self.role != LEADER:
                raise NotLeader(self.leader_id)
            entry = LogEntry(self.term, self._last_index() + 1, command)
            self.log.append(entry)
            self._persist()
        self._broadcast_append()
        deadline = time.monotonic() + timeout
        with self._commit_cv:
            while self.commit_index < entry.index:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"command at index {entry.index} not committed")
                self._commit_cv.wait(remaining)
            # commit advanced past our index, but a new leader may have
            # overwritten it — success only if OUR entry (same term) is
            # what got committed (Raft §5.4.2)
            committed = self._entry_at(entry.index)
            if committed is None or committed.term != entry.term:
                raise NotLeader(self.leader_id)
        return entry.index

    def add_peer(self, peer_id: str, timeout: float = 5.0) -> None:
        """Commit a config entry adding `peer_id` as a voter."""
        with self._mu:
            if self.role != LEADER:
                raise NotLeader(self.leader_id)
            members = {self.node_id, peer_id, *self.peers}
        self.propose({"op": "raft_config", "peers": sorted(members)},
                     timeout=timeout)

    def remove_peer(self, peer_id: str, timeout: float = 5.0) -> None:
        """Commit a config entry removing `peer_id` from the cluster."""
        with self._mu:
            if self.role != LEADER:
                raise NotLeader(self.leader_id)
            members = {self.node_id, *self.peers} - {peer_id}
        self.propose({"op": "raft_config", "peers": sorted(members)},
                     timeout=timeout)

    def status(self) -> dict:
        with self._mu:
            return {"id": self.node_id, "role": self.role,
                    "term": self.term, "leader": self.leader_id,
                    "commit_index": self.commit_index,
                    "log_len": len(self.log),
                    "snapshot_index": self.snapshot_index,
                    "peers": list(self.peers)}
