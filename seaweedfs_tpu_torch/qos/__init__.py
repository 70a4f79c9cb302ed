"""QoS / admission plane: the control plane over every data
plane this repo has grown.

Three coupled pieces:

  * **Admission** (`admission.py`) — per-tenant token-bucket rate limits
    at the filer and S3 ingress. A request over budget is rejected EARLY
    (filer HTTP 429, S3 503 `SlowDown`) with a `Retry-After` hint and a
    trace id, instead of timing out late deep in the data plane. Every
    rejection is attributable: the decision lands on the request's span
    and in a bounded rejection log (`/status.Qos`).
  * **Priority** (`priority.py`) — strict priority classes between
    foreground I/O and background work (repair > scrub > EC archival),
    generalizing the scrub QPS-backoff into CLUSTER-WIDE token
    grants the master leases to volume servers over the `QosGrant` RPC.
    Foreground never touches the grant plane (fail-open by
    construction); background classes fail CLOSED when the master is
    unreachable — paused background work is safe, unthrottled is not.
  * **Pressure** (`pressure.py`) — per-volume-server backpressure score
    folded from the group-commit buffer depth and the EC-dispatch queue
    depth (both already measured by the tracing plane). Grant
    refreshes carry it to the master, which folds it into `assign`
    placement (avoid hot servers) and can shed assigns outright above
    `SWFS_QOS_SHED_PRESSURE`.

Everything defaults to OFF/unlimited: with no `SWFS_QOS_*` env set the
plane observes (status/metrics) but never rejects, throttles or moves
placement — tier-1 behavior is unchanged.
"""

from .admission import (  # noqa: F401
    Decision,
    TenantAdmission,
    TokenBucket,
    filer_tenant,
    s3_access_key_hint,
    s3_tenant,
)
from .pressure import SIGNAL, PressureSignal, pressure_score  # noqa: F401
from .priority import (  # noqa: F401
    BACKGROUND_CLASSES,
    DEFAULT_MAX_GRANT_BYTES,
    BackgroundGovernor,
    GrantLedger,
    QosUnavailable,
)
