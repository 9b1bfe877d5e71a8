"""Predictive rollout planning.

Three cooperating read-only parts:

- :mod:`planner` — deterministic analytic planner: one snapshot + one
  policy in, an ordered-wave :class:`~planner.RollPlan` with projected
  durations and a completion time out.  Zero API write verbs.
- :mod:`twin` — digital twin: clones the snapshot into a fresh
  ``FakeCluster`` and runs the REAL engine against it on an accelerated
  fake clock, validating the analytic plan against actual engine
  behavior (with what-if knobs: inject preemptions, decline elastic
  offers, close a window).
- :mod:`drift` — live drift watchdog: anchors an active roll to its
  admitted plan, republishes the ETA every tick, and triggers a bounded
  re-plan when reality diverges beyond a threshold.
- :mod:`clocks` — per-pool EWMA phase clocks measured from observed
  transitions, feeding the watchdog's re-plans (and serialized through
  CR status so estimates survive controller failover).

The one write-adjacent consumer is plan-GUIDED admission
(``planning.admissionMode: packed``): the engine's admission pass reads
the watchdog's fresh plan to order chargeable groups
(first-fit-decreasing within each generation class) — planning itself
still never writes.

See docs/rollout-planning.md.
"""

from k8s_operator_libs_tpu_torch.planning.planner import (  # noqa: F401
    PhaseClocks,
    PlanAssumptions,
    PlannedGroup,
    PlanWave,
    RollPlan,
    find_infeasibilities,
    plan_roll,
)
from k8s_operator_libs_tpu_torch.planning.twin import (  # noqa: F401
    TwinResult,
    run_twin,
)
from k8s_operator_libs_tpu_torch.planning.drift import (  # noqa: F401
    DriftReport,
    DriftWatchdog,
)
from k8s_operator_libs_tpu_torch.planning.clocks import (  # noqa: F401
    PhaseClockTracker,
)
