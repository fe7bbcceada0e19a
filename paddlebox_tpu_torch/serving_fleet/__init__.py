"""The serving fleet: replica routing, supervision, failover and
autoscaling (reference: paddlebox_tpu/serving_fleet/).

  * :mod:`router`: :class:`FleetRouter`, the health-checked front door: a
    healthy / degraded / ejected state machine per replica fed by periodic
    ``/healthz`` probes, round-robin routing with per-request failover,
    degraded replicas used only when no healthy one can take a request;
  * :mod:`supervisor`: :class:`ReplicaSupervisor` spawns and watches the
    replica processes and restarts a crashed one with jittered backoff; it
    grows (``spawn_replica``, a fresh bind-probed port) and shrinks
    (``retire_replica``, never resurrected) the fleet on demand;
  * :mod:`autoscaler`: :class:`FleetAutoscaler` turns the fleet's own
    telemetry (queue depth, admission-wait estimate, shed rate) into spawn
    and drain-retire decisions with hysteresis and a cooldown, and runs
    freshness-gated rolling restarts one replica at a time;
  * admission control lives in each server
    (:mod:`paddlebox_tpu_torch.inference.admission`): a bounded queue and
    deadline-aware 429 shedding, so the fleet sheds at the edge instead of
    queuing into saturation.

``python -m paddlebox_tpu_torch.serve --replicas N --router-port P`` wires
the three together; each replica is a ``python -m
paddlebox_tpu_torch.serve`` process that serves on the card (``--cpu``
passes through).
"""

from paddlebox_tpu_torch.serving_fleet.router import (  # noqa: F401
    DEGRADED,
    EJECTED,
    HEALTHY,
    FleetRouter,
    ReplicaHandle,
)
from paddlebox_tpu_torch.serving_fleet.supervisor import (  # noqa: F401
    ReplicaProc,
    ReplicaSupervisor,
)
from paddlebox_tpu_torch.serving_fleet.autoscaler import (  # noqa: F401
    AutoscalerConfig,
    FleetAutoscaler,
)
