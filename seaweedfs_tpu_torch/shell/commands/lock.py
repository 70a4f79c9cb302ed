"""lock / unlock — exclusive admin lease (counterpart of
seaweedfs_tpu/shell/commands/lock.py; SeaweedFS
weed/shell/command_lock_unlock.go)."""

from __future__ import annotations

from ..registry import command


@command("lock", "acquire the exclusive cluster admin lock")
def lock(env, args, out):
    env.acquire_lock()
    print("acquired cluster admin lock", file=out)


@command("unlock", "release the exclusive cluster admin lock")
def unlock(env, args, out):
    env.release_lock()
    print("released cluster admin lock", file=out)
