# the command modules of the port; `deferred` registers the reference's
# remote.* and mq.* commands, each failing with its ROADMAP.md item
from . import (  # noqa: F401
    cluster,
    collection,
    deferred,
    ec,
    fs,
    lock,
    qos_cmd,
    s3,
    trace_cmd,
    volume,
)
