"""collection.* commands (counterpart of
seaweedfs_tpu/shell/commands/collection.py; SeaweedFS
weed/shell/command_collection_*.go)."""

from __future__ import annotations

import argparse

from ...pb import master_pb2
from ..registry import command


@command("collection.list", "list collections")
def collection_list(env, args, out):
    resp = env.master_stub().CollectionList(
        master_pb2.CollectionListRequest(
            include_normal_volumes=True, include_ec_volumes=True), timeout=10)
    for c in resp.collections:
        print(f"collection: {c.name!r}", file=out)
    print(f"total {len(resp.collections)} collections", file=out)


@command("collection.delete", "delete a whole collection (destructive)")
def collection_delete(env, args, out):
    p = argparse.ArgumentParser(prog="collection.delete")
    p.add_argument("-collection", required=True)
    p.add_argument("-force", action="store_true")
    opts = p.parse_args(args)
    env.confirm_is_locked()
    if not opts.force:
        print("add -force to actually delete", file=out)
        return
    env.master_stub().CollectionDelete(
        master_pb2.CollectionDeleteRequest(name=opts.collection), timeout=120)
    print(f"collection {opts.collection!r} deleted", file=out)
