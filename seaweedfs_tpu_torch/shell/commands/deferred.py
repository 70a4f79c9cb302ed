"""The reference's shell commands that stand on parts the port does not
carry yet: remote storage (`remote.*`) and the MQ broker (`mq.*`). Each
fails, naming the ROADMAP.md item that will port it, so that none reads
as an unknown command."""

from __future__ import annotations

from ..registry import command

ROADMAP_REMOTE = "ROADMAP.md A2d (remote_storage)"
ROADMAP_GATEWAYS = "ROADMAP.md A2d (other gateways)"

DEFERRED = {
    **{name: ROADMAP_REMOTE for name in (
        "remote.configure", "remote.mount", "remote.unmount",
        "remote.meta.sync", "remote.cache", "remote.uncache",
        "remote.mount.buckets")},
    "mq.topic.list": ROADMAP_GATEWAYS,
}


def _deferred(name: str, item: str):
    def run(env, args, out):
        raise RuntimeError(f"{name} is not part of the PyTorch port yet: "
                           f"{item}")
    return run


for _name, _item in DEFERRED.items():
    command(_name, f"not part of the PyTorch port yet: {_item}")(
        _deferred(_name, _item))
