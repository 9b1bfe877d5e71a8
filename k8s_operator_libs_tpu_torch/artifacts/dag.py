"""Artifact dependency DAGs: composable driver stacks under one window.

Real TPU fleets never roll libtpu alone: the device driver, the network
driver and the device plugin form a *stack* whose pieces must upgrade
together under per-edge version-compatibility constraints (the K8s
Network Driver Model's composable-driver picture, PAPERS.md).  This
module is the pure-graph core of that generalization:

- :class:`ArtifactDAG` is built from the policy's ``artifacts`` stanza
  (duck-typed — this module never imports ``api.v1alpha1``, which
  imports *us* for admission validation) and validated once at
  admission: duplicate/empty names, dangling or self edges, cycles,
  lockstep/pinned-order conflicts and unsatisfiable version
  constraints all reject the policy through the existing
  ``_validate_feasibility`` path.
- ``lockstep`` edges merge their endpoints into one restart *step*:
  the artifacts' pods restart in the same pass, inside the same
  cordon/drain window.  ``pinned-order`` edges serialize: the
  downstream artifact's pods may not restart until the upstream
  artifact is fully synced (and its gate, if any, has passed).
- :meth:`topo_order` is deterministic (Kahn's algorithm, ties broken
  by the spec's item order), which is what lets the engine map the
  FIRST artifact in topological order onto the existing
  ``driver_pod``/``driver_daemon_set`` fields — a DAG of size 1 *is*
  the classic single-artifact code path, byte for byte.
- :meth:`rollback_order` is the reverse topological order, the unwind
  sequence a failed mid-stack roll reports artifact by artifact.

The DAG never touches the cluster: it is a validated shape the engine,
planner, twin and tracer all consult, the same read-only doctrine as
``planning/``.
"""

from __future__ import annotations

from typing import Optional

SKEW_LOCKSTEP = "lockstep"
SKEW_PINNED_ORDER = "pinned-order"
SKEW_MODES = (SKEW_LOCKSTEP, SKEW_PINNED_ORDER)

# Artifact gates: "" (none) or the fused battery's network-path checks
# (DCN reachability + ICI link state), which gate only the networking
# artifact's edge.
GATE_NONE = ""
GATE_NETWORK_PATH = "network-path"
GATE_MODES = (GATE_NONE, GATE_NETWORK_PATH)


class ArtifactDAGError(ValueError):
    """The artifacts stanza does not describe a usable DAG.  Raised at
    admission (``TPUUpgradePolicySpec._validate_feasibility``) so an
    invalid stack rejects the policy instead of wedging a roll."""


def _parse_version(v: str) -> tuple:
    """Dotted-numeric version -> comparable tuple.  Non-numeric
    components compare as strings after the numeric prefix (enough for
    driver tags like ``1.2.3`` or ``535.104.05``)."""
    parts: list = []
    for piece in str(v).split("."):
        try:
            parts.append((0, int(piece)))
        except ValueError:
            parts.append((1, piece))
    return tuple(parts)


_OPS = (">=", "<=", "==", "!=", ">", "<")


def constraint_satisfied(requires: str, version: str) -> bool:
    """Evaluate a ``requires`` constraint (``">=1.2"`` style) against a
    target version.  An empty constraint always holds; an unparseable
    one never does (it must reject at admission, not surprise mid-roll).
    """
    requires = (requires or "").strip()
    if not requires:
        return True
    for op in _OPS:
        if requires.startswith(op):
            want = requires[len(op):].strip()
            if not want:
                return False
            a, b = _parse_version(version), _parse_version(want)
            return {
                ">=": a >= b,
                "<=": a <= b,
                "==": a == b,
                "!=": a != b,
                ">": a > b,
                "<": a < b,
            }[op]
    # Bare version = exact match.
    return _parse_version(version) == _parse_version(requires)


class ArtifactDAG:
    """Validated artifact dependency DAG for one upgrade policy.

    Construction never raises; call :meth:`validate` (admission does)
    to surface :class:`ArtifactDAGError`.  All orders are deterministic
    so every controller incarnation — and the planner's projection —
    steps the stack identically.
    """

    def __init__(self, items, edges) -> None:
        # Duck-typed items/edges: anything with .name/.match_labels/
        # .target_version/.gate and .before/.after/.requires/.skew.
        self.items = list(items or [])
        self.edges = list(edges or [])
        self._index = {
            getattr(a, "name", ""): i for i, a in enumerate(self.items)
        }

    @classmethod
    def from_spec(cls, spec) -> Optional["ArtifactDAG"]:
        """Build from a policy's ``artifacts`` stanza (or None)."""
        if spec is None:
            return None
        return cls(getattr(spec, "items", None), getattr(spec, "edges", None))

    # -- basic shape ---------------------------------------------------------

    def size(self) -> int:
        return len(self.items)

    def names(self) -> list[str]:
        return [getattr(a, "name", "") for a in self.items]

    def artifact(self, name: str):
        i = self._index.get(name)
        return self.items[i] if i is not None else None

    def is_multi(self) -> bool:
        """Does this DAG actually change engine behavior?  A size-0/1
        DAG IS the classic single-artifact path."""
        return len(self.items) > 1

    # -- validation ----------------------------------------------------------

    def validate(self) -> None:
        names = self.names()
        seen: set[str] = set()
        for name in names:
            if not name:
                raise ArtifactDAGError("artifact with empty name")
            if name in seen:
                raise ArtifactDAGError(f"duplicate artifact name {name!r}")
            seen.add(name)
        for a in self.items:
            gate = getattr(a, "gate", "") or ""
            if gate not in GATE_MODES:
                raise ArtifactDAGError(
                    f"artifact {getattr(a, 'name', '')!r}: unknown gate "
                    f"{gate!r} (expected one of {GATE_MODES})"
                )
            if not getattr(a, "match_labels", None):
                raise ArtifactDAGError(
                    f"artifact {getattr(a, 'name', '')!r}: empty "
                    "DaemonSet selector (matchLabels)"
                )
        for e in self.edges:
            before = getattr(e, "before", "")
            after = getattr(e, "after", "")
            skew = getattr(e, "skew", SKEW_LOCKSTEP) or SKEW_LOCKSTEP
            if before not in seen or after not in seen:
                raise ArtifactDAGError(
                    f"dangling edge {before!r} -> {after!r}: both ends "
                    "must name declared artifacts"
                )
            if before == after:
                raise ArtifactDAGError(f"self-edge on artifact {before!r}")
            if skew not in SKEW_MODES:
                raise ArtifactDAGError(
                    f"edge {before!r} -> {after!r}: unknown skew "
                    f"{skew!r} (expected one of {SKEW_MODES})"
                )
            requires = getattr(e, "requires", "") or ""
            if requires:
                upstream = self.artifact(before)
                version = getattr(upstream, "target_version", "") or ""
                if not constraint_satisfied(requires, version):
                    raise ArtifactDAGError(
                        f"unsatisfiable constraint on edge {before!r} -> "
                        f"{after!r}: requires {requires!r} but "
                        f"{before!r} targets version {version!r}"
                    )
        # Cycle detection runs over the CONDENSED graph (lockstep
        # components merged): it simultaneously catches pinned-order
        # cycles and lockstep/pinned-order conflicts (a pinned-order
        # edge between two artifacts forced into one lockstep step is a
        # cycle of the condensation).
        self._levels()

    # -- stepping structure --------------------------------------------------

    def _components(self) -> dict[str, int]:
        """Union lockstep-connected artifacts into restart components.
        Returns name -> component id (root item index)."""
        parent = list(range(len(self.items)))

        def find(i: int) -> int:
            while parent[i] != i:
                parent[i] = parent[parent[i]]
                i = parent[i]
            return i

        for e in self.edges:
            skew = getattr(e, "skew", SKEW_LOCKSTEP) or SKEW_LOCKSTEP
            if skew != SKEW_LOCKSTEP:
                continue
            b = self._index.get(getattr(e, "before", ""))
            a = self._index.get(getattr(e, "after", ""))
            if b is None or a is None:
                continue
            rb, ra = find(b), find(a)
            if rb != ra:
                # Deterministic root: smaller item index wins.
                lo, hi = (rb, ra) if rb < ra else (ra, rb)
                parent[hi] = lo
        return {
            getattr(a, "name", ""): find(i)
            for i, a in enumerate(self.items)
        }

    def _levels(self) -> dict[str, int]:
        """name -> 1-based restart step.  Lockstep components share a
        step; pinned-order edges force strictly later steps; unrelated
        components may share a step (they restart in the same pass).
        Raises :class:`ArtifactDAGError` on a cycle."""
        comp = self._components()
        comp_ids = sorted(set(comp.values()))
        succ: dict[int, set[int]] = {c: set() for c in comp_ids}
        indeg: dict[int, int] = {c: 0 for c in comp_ids}
        for e in self.edges:
            skew = getattr(e, "skew", SKEW_LOCKSTEP) or SKEW_LOCKSTEP
            if skew != SKEW_PINNED_ORDER:
                continue
            b = comp.get(getattr(e, "before", ""))
            a = comp.get(getattr(e, "after", ""))
            if b is None or a is None:
                continue
            if b == a:
                raise ArtifactDAGError(
                    f"edge {getattr(e, 'before', '')!r} -> "
                    f"{getattr(e, 'after', '')!r} is pinned-order but its "
                    "ends are lockstep-connected (conflicting skew)"
                )
            if a not in succ[b]:
                succ[b].add(a)
                indeg[a] += 1
        level: dict[int, int] = {}
        ready = [c for c in comp_ids if indeg[c] == 0]
        for c in ready:
            level[c] = 1
        out = 0
        while ready:
            # Kahn over components, deterministic order.
            ready.sort()
            c = ready.pop(0)
            out += 1
            for n in sorted(succ[c]):
                level[n] = max(level.get(n, 1), level[c] + 1)
                indeg[n] -= 1
                if indeg[n] == 0:
                    ready.append(n)
        if out != len(comp_ids):
            raise ArtifactDAGError(
                "artifact dependency cycle (pinned-order edges form a "
                "loop across restart steps)"
            )
        return {name: level[c] for name, c in comp.items()}

    def levels(self) -> dict[str, int]:
        """Validated name -> 1-based restart step."""
        return self._levels()

    def serialized_steps(self) -> int:
        """Number of serialized restart steps inside one window — what
        an n-artifact stack costs over a single artifact.  The planner
        charges ``(serialized_steps - 1)`` extra pod-restart clocks per
        group; lockstep stacks collapse back toward 1."""
        lv = self._levels()
        return max(lv.values()) if lv else 1

    def topo_order(self) -> list[str]:
        """Artifacts in restart order: ascending step, ties broken by
        the spec's item order.  ``topo_order()[0]`` is the PRIMARY
        artifact — the engine maps it onto the existing driver
        DaemonSet fields."""
        lv = self._levels()
        return sorted(self.names(), key=lambda n: (lv[n], self._index[n]))

    def rollback_order(self) -> list[str]:
        """Reverse topological order: the unwind sequence a failed
        mid-stack roll reports, newest work first."""
        return list(reversed(self.topo_order()))

    def primary(self) -> Optional[str]:
        order = self.topo_order()
        return order[0] if order else None

    def gated_artifacts(self) -> list[str]:
        """Artifacts whose completion is gated by the fused battery's
        network-path checks."""
        return [
            getattr(a, "name", "")
            for a in self.items
            if (getattr(a, "gate", "") or "") == GATE_NETWORK_PATH
        ]


def artifact_dag_of(policy) -> Optional[ArtifactDAG]:
    """The policy's effective multi-artifact DAG, or None when the
    policy has no ``artifacts`` stanza OR the stanza holds a single
    artifact (the classic path; size-1 parity is the contract)."""
    spec = getattr(policy, "artifacts", None)
    dag = ArtifactDAG.from_spec(spec)
    if dag is None or not dag.is_multi():
        return None
    return dag
