# the command modules of the port; the reference's fs.*, remote.* and
# s3/mq commands need the filer and gateways (ROADMAP.md A2d)
from . import (  # noqa: F401
    cluster,
    collection,
    ec,
    lock,
    qos_cmd,
    trace_cmd,
    volume,
)
