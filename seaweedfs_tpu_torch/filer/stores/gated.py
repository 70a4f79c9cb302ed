"""Client-library-gated filer stores.

Counterpart of seaweedfs_tpu/filer/stores/gated.py: stores whose client
libraries are not installed register here as placeholders that fail at
construction with clear guidance. Each maps to its package under SeaweedFS
weed/filer/<name>/.
"""

from __future__ import annotations

from ..filerstore import register_store

_GATED = {
    "rocksdb": "python-rocksdb (cgo-gated in the reference too)",
}


def _make(name: str, lib: str):
    class GatedStore:
        def __init__(self, **_kwargs):
            raise RuntimeError(
                f"filer store {name!r} needs the {lib} client library, "
                f"which is not installed; use "
                f"`memory`, `sqlite`, or `leveldb`")

    GatedStore.name = name
    GatedStore.__name__ = f"Gated_{name}"
    return GatedStore


for _name, _lib in _GATED.items():
    register_store(_name, _make(_name, _lib))
