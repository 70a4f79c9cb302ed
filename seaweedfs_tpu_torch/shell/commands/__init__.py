# the command modules of the port
from . import (  # noqa: F401
    cluster,
    collection,
    ec,
    fs,
    lock,
    qos_cmd,
    remote,
    s3,
    trace_cmd,
    volume,
)
