"""redis_lua filer store: mutations as server-side Lua scripts.

Counterpart of seaweedfs_tpu/filer/stores/redis_lua.py (SeaweedFS
weed/filer/redis_lua/, UniversalRedisLuaStore + stored_procedure/*.lua):
the data layout is exactly redis2's — the entry blob at the full-path
key, the directory's children in a ``<dir>\\x00`` sorted set — but each
mutation runs as ONE atomic Lua script on the server (go-redis
Script.Run = EVALSHA with EVAL fallback on NOSCRIPT), so the entry write
and its directory-index update cannot interleave with another client's,
without MULTI/EXEC round trips.

The scripts here are this package's own formulations of the same
semantics (insert = SET [EX ttl] + ZADD NX; delete = DEL entry+listkey
+ ZREM; delete-children = DEL every child + its list key, then clear
the set). Reads (find/list/kv) are the parent RedisStore's plain
commands, like the reference. Entry blobs and the directory index are
byte-compatible with this repo's redis/redis2 stores.
"""

from __future__ import annotations

import hashlib

from ..filerstore import register_store
from .redis import RedisStore, RespError, _dir_set_key

INSERT_SCRIPT = """\
local path = KEYS[1]
local dirset = KEYS[2]
local blob = ARGV[1]
local ttl = tonumber(ARGV[2])
local name = ARGV[3]
if ttl > 0 then
  redis.call('SET', path, blob, 'EX', ttl)
else
  redis.call('SET', path, blob)
end
if name ~= '' then
  redis.call('ZADD', dirset, 'NX', 0, name)
end
return 0
"""

DELETE_SCRIPT = """\
local path = KEYS[1]
local pathset = KEYS[2]
local dirset = KEYS[3]
local name = ARGV[1]
redis.call('DEL', path, pathset)
if name ~= '' then
  redis.call('ZREM', dirset, name)
end
return 0
"""

DELETE_CHILDREN_SCRIPT = """\
local dir = KEYS[1]
local dirset = KEYS[2]
local names = redis.call('ZRANGE', dirset, 0, -1)
for _, name in ipairs(names) do
  redis.call('DEL', dir .. '/' .. name)
end
redis.call('DEL', dirset)
return #names
"""
# NB: child LIST keys (child .. '\\0') are deliberately left to the
# python-side recursion — each subdirectory level runs this script for
# its own set, which must still be readable when its turn comes.


class ScriptRunner:
    """go-redis Script.Run over the RESP client: EVALSHA by the sha1 of
    the script body, falling back to EVAL (which also loads it) when
    the server answers NOSCRIPT."""

    def __init__(self, client, script: str):
        self.client = client
        self.script = script
        self.sha = hashlib.sha1(script.encode()).hexdigest()

    def run(self, keys: list[bytes], args: list) -> object:
        try:
            return self.client.cmd("EVALSHA", self.sha, str(len(keys)),
                                   *keys, *args)
        except RespError as e:
            if not str(e).startswith("NOSCRIPT"):
                raise
            return self.client.cmd("EVAL", self.script, str(len(keys)),
                                   *keys, *args)


class RedisLuaStore(RedisStore):
    """RedisStore whose mutations are atomic server-side scripts
    (UniversalRedisLuaStore, universal_redis_store.go:49)."""

    name = "redis_lua"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._insert = ScriptRunner(self.client, INSERT_SCRIPT)
        self._delete = ScriptRunner(self.client, DELETE_SCRIPT)
        self._delete_children = ScriptRunner(self.client,
                                             DELETE_CHILDREN_SCRIPT)

    def insert_entry(self, entry) -> None:
        from ...pb import filer_pb2

        blob = filer_pb2.FullEntry(
            dir=entry.parent, entry=entry.to_pb()).SerializeToString()
        ttl = entry.attr.ttl_sec if entry.attr else 0
        self._insert.run(
            [entry.full_path.encode(), _dir_set_key(entry.parent)],
            [blob, str(max(0, ttl)), entry.name.encode()])

    update_entry = insert_entry

    def delete_entry(self, full_path: str) -> None:
        d, _, name = full_path.rpartition("/")
        self._delete.run(
            [full_path.encode(), _dir_set_key(full_path),
             _dir_set_key(d or "/")],
            [name.encode()])

    def delete_folder_children(self, full_path: str) -> None:
        """One atomic level at a time; recursion over subdirectories
        happens here (the whole-subtree contract every store in this
        package keeps), reading each level BEFORE its set is dropped."""
        stack = [full_path.rstrip("/") or "/"]
        while stack:
            d = stack.pop()
            children = [(d.rstrip("/") or "") + "/" + m.decode()
                        for m in self.client.cmd(
                            "ZRANGEBYLEX", _dir_set_key(d),
                            "-", "+") or []]
            if not children:
                continue  # leaf: no set, nothing for the script to do
            # KEYS[1] is the '/'-stripped dir ('' for root) so the
            # script's dir..'/'..name concatenation yields /name, not
            # //name, at the root
            self._delete_children.run(
                [d.rstrip("/").encode(), _dir_set_key(d)], [])
            stack.extend(children)


register_store("redis_lua", RedisLuaStore)
