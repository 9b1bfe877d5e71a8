"""Roll tracing, flight recorder & fleet health telemetry (observability
layer).

Four read-mostly, fail-open parts:

- :mod:`trace` — span model + recorder: every fleet roll becomes one
  causal span tree (roll → pool → wave → slice-group → node → phase,
  plus wait spans), recorded at the engine's existing choke points,
  crash-durable via the node-annotation write plane, continued across
  controller failover by ``manager.adopt()``.
- :mod:`flightrec` — black box: a fixed-size ring of recent facts and
  a throttled, byte-capped on-disk spool of redacted JSON snapshots
  dumped when something goes wrong (stuck detector, infeasibility,
  quarantine, circuit-open, crash-adoption).
- :mod:`critical` — critical-path makespan attribution: on roll
  completion, bucket the makespan into phase-time vs budget-wait vs
  window-hold vs quarantine vs API-retry, compare per-phase actuals
  against the PhaseClocks projection, and publish the top drift
  contributors (CR ``makespanBreakdown``, metrics, ``make trace``).
- :mod:`telemetry` + :mod:`baseline` — fleet health: every probe
  battery's measured side channel (TFLOPs, HBM GB/s, ICI bus BW,
  execute time) lands in a bounded per-node ring riding the combined
  transition patch (zero extra writes, re-adopted across restarts),
  folds into per-(generation, pool) median+MAD baselines, and yields
  health scores plus sustained-deviation straggler verdicts —
  observe-only unless ``healthGate.quarantineStragglers`` opts in.

Observability is observe-only by contract: every entry point fails
open, so a recorder or telemetry failure can never block a state
transition (drops are counted into ``trace_drops_total`` /
``telemetry_drops_total`` instead).  See docs/observability.md.
"""

from k8s_operator_libs_tpu_torch.obs.trace import (  # noqa: F401
    CompletedTrace,
    Span,
    TraceRecorder,
    format_anchor,
    parse_anchor,
)
from k8s_operator_libs_tpu_torch.obs.flightrec import (  # noqa: F401
    FlightRecorder,
    redact,
)
from k8s_operator_libs_tpu_torch.obs.baseline import (  # noqa: F401
    BaselineStat,
    compute_baselines,
    health_score,
    node_badness,
)
from k8s_operator_libs_tpu_torch.obs.telemetry import (  # noqa: F401
    TelemetryPlane,
    format_ring,
    parse_ring,
)
from k8s_operator_libs_tpu_torch.obs.critical import (  # noqa: F401
    Attribution,
    analyze,
    expected_from_tracker,
    makespan_breakdown,
    phase_drift,
    render_breakdown,
    render_tree,
)
