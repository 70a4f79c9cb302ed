"""Native (C++) runtime components: the volume-server HTTP data plane and
the filer hot plane (counterpart of seaweedfs_tpu/native/)."""

from .dataplane import (
    NativeBuildError,
    NativeDataPlane,
    NativeFilerPlane,
    native_available,
)

__all__ = ["NativeBuildError", "NativeDataPlane", "NativeFilerPlane",
           "native_available"]
