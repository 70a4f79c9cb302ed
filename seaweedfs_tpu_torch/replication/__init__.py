"""Async cross-cluster replication.

Counterpart of seaweedfs_tpu/replication/ (SeaweedFS weed/replication/):
a metadata-event source
(the filer's SubscribeMetadata stream) drives ReplicationSinks that mirror
entries into another filer, a local directory, or a cloud store. Driven by
`filer.sync` (continuous two-filer sync, command/filer_sync.go)
and `filer.replicate` (queue-driven, command/filer_replicate.go).
"""

from .replicator import Replicator
from .sink import FilerSink, LocalSink, ReplicationSink, new_sink
from .source import FilerSource
from .sync import FilerSyncLoop

__all__ = ["Replicator", "ReplicationSink", "FilerSink", "LocalSink",
           "new_sink", "FilerSource", "FilerSyncLoop"]
