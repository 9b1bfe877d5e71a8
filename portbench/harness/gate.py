"""The gate loop: one node's validation gate, closed loop, back to back.

A gate begins when the node reaches validation under a new driver
revision (drawn from the seed) and ends when the prober's verdict on the
node's fresh report is read.  In between, as the engine and the node do
it: the prober reads the node and rejects the report still there from
the previous revision, the node's agent runs its battery over the
node's GPUs and publishes its report, and the prober reads the node
again and judges the new report.  One gate at a time, as under
``maxParallelUpgrades`` 1.

Everything is the port's: ``FakeCluster``, ``HealthAgent`` (the
battery, ``run_host_probe``, fused), ``NodeReportProber``.  The loop
records, besides its spans, every battery's rows (a spy on the fused
battery's read-back), every verdict with the report it was made on, and,
for gates drawn from the seed, the deep probe's attention outputs.

On other gates drawn from the seed the spy plants a fault in one
member's inputs before the battery runs (an element of its stream
buffer, its ramp or its ring value, drawn from the seed): the port has
to compute it through to its rows, its report has to fail the check and
its prober has to reject the node.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from harness import trace as tr
from harness.fleet import KEYS, Fleet
from k8s_operator_libs_tpu_torch.health import fused, probes
from k8s_operator_libs_tpu_torch.health.agent import HealthAgent
from k8s_operator_libs_tpu_torch.health.slice_prober import NodeReportProber
from k8s_operator_libs_tpu_torch.upgrade.types import (
    NodeUpgradeState,
    UpgradeGroup,
)
from k8s_operator_libs_tpu_torch.workloads import ring_attention
from reference import attention as ref_attention
from reference import battery as ref_battery
from reference import verdict as ref_verdict


def revision_hash(rng: np.random.Generator) -> str:
    return f"{int(rng.integers(0, 1 << 40)):010x}"


def draw_plant(rng: np.random.Generator, members: int, elems: int) -> tuple:
    """A fault in one member's inputs, ``(kind, member, index, value)``
    as :func:`reference.battery.expected_rows` takes it: a whole number
    where the healthy input has another, so every sum stays exact."""
    kinds = ("stream", "ramp", "ring") if members >= 2 else ("stream",)
    kind = kinds[int(rng.integers(len(kinds)))]
    member = int(rng.integers(members))
    if kind == "stream":
        value = int(rng.integers(1, 65)) * (1 if rng.integers(2) else -1)
        return kind, member, int(rng.integers(elems)), float(value)
    healthy = member + 1 if kind == "ramp" else member
    value = int(rng.integers(0, 64))
    return kind, member, 0, float(value + (value >= healthy))


def apply_plant(inputs: list, plant: tuple) -> None:
    """Write ``plant`` into the fused battery's inputs: per member
    ``(a, b, x, ramp, ring)``."""
    kind, member, index, value = plant
    _, _, x, ramp, ring = inputs[member]
    {"stream": x, "ramp": ramp, "ring": ring}[kind][index] = value


class Loop:
    def __init__(self, run, cards: list) -> None:
        self.run = run
        self.cards = cards
        cfg, traffic = run.config, run.traffic
        self.deep = bool(traffic["deep"])
        self.gpus = int(cfg["gpus"])
        self.members = [cards[i % len(cards)] for i in range(self.gpus)]
        self.battery = cfg["battery"]
        self.rng = np.random.default_rng(run.seed)

        self.fleet = Fleet(cfg["api"])
        self.revision = revision_hash(self.rng)
        self.ds = self.fleet.driver_daemon_set(self.revision)
        self.node = self.fleet.gpu_node(cfg["node_name"], cfg["node_labels"])
        self.fleet.driver_pod(self.node, self.revision)
        self.agent = HealthAgent(
            self.fleet.cluster, self.node.name, KEYS,
            driver_revision=self.revision, devices=self.members,
            matmul_n=self.battery["matmul_n"], hbm_mib=self.battery["hbm_mib"],
            allreduce_elems=self.battery["allreduce_elems"], deep=self.deep,
            fused=self.battery["fused"],
        )
        prober_cfg = cfg["prober"]
        self.max_age_s = float(prober_cfg["max_report_age_s"])
        self.prober = NodeReportProber(
            KEYS, max_report_age_s=self.max_age_s,
            revision_resolver=lambda ds: self.revision,
            hbm_floor_fraction=prober_cfg["hbm_floor_fraction"],
            generation_floors=prober_cfg["generation_floors"],
        )

        # What the comparison reads: (gate, rows) of every battery,
        # (gate, kind, healthy, report, revision) of every verdict, and
        # (gate, output shards) of the sampled deep probes.
        self.gate_index = -1
        self.rows: list = []
        self.verdicts: list = []
        self.attention: list = []
        self.errors: list = []
        est = max(1, int(run.seconds / float(traffic["gate_s_estimate"])))
        k = min(int(traffic["sampled_outputs"]), est)
        self.sampled = set(int(i) for i in self.rng.choice(est, k, replace=False))
        k = min(int(traffic["planted_faults"]), est)
        elems = ref_battery.stream_elems(self.battery["hbm_mib"])
        self.plants = {int(g): draw_plant(self.rng, self.gpus, elems)
                       for g in self.rng.choice(est, k, replace=False)}

        real_run = fused._run

        def spy_run(key, inputs):
            plant = self.plants.get(self.gate_index)
            if plant is not None:
                apply_plant(inputs, plant)
            rows = real_run(key, inputs)
            self.rows.append((self.gate_index, rows))
            return rows

        run.patch(fused, "_run", spy_run)
        if self.deep:
            real_ring = ring_attention.ring_attention

            def spy_ring(*a, **kw):
                out = real_ring(*a, **kw)
                if self.gate_index in self.sampled or self.gate_index < 0:
                    self.attention.append((self.gate_index, out))
                return out

            run.patch(ring_attention, "ring_attention", spy_ring)
            real_deep = probes.ici_ring_attention_probe

            def spy_deep(*a, **kw):
                with run.span("deep_probe"):
                    return real_deep(*a, **kw)

            run.patch(probes, "ici_ring_attention_probe", spy_deep)

        # Set-up: the kernel library, the battery's shapes, the prober and
        # the publish path, warmed by two whole gates.
        run.phase("node")
        for g in (-2, -1):
            self.gate(g)
            run.phase(f"warm gate {g + 3}")
        tr.synchronize(cards)

    # -- one gate -------------------------------------------------------------

    def _group(self):
        node = self.fleet.cluster.get_node(self.node.name, cached=False)
        return node, UpgradeGroup(id=node.name, members=[NodeUpgradeState(
            node=node, driver_pod=None, driver_daemon_set=self.ds)])

    def gate(self, g: int) -> tuple:
        run = self.run
        self.gate_index = g
        t0 = time.perf_counter()
        self.revision = revision_hash(self.rng)
        self.agent.driver_revision = self.revision
        node, group = self._group()
        with run.span("verdict"):
            stale = self.prober.probe(group)
        self.verdicts.append((g, "stale", stale.healthy,
                              node.annotations.get(
                                  KEYS.health_report_annotation),
                              self.revision))
        with run.span("battery"):
            report = self.agent.probe_once()
        with run.span("publish"):
            self.agent.publish(report)
        node, group = self._group()
        with run.span("verdict"):
            fresh = self.prober.probe(group)
        t1 = time.perf_counter()
        self.verdicts.append((g, "fresh", fresh.healthy,
                              node.annotations.get(
                                  KEYS.health_report_annotation),
                              self.revision))
        return t0, t1

    # -- the window -------------------------------------------------------------

    def window(self, deadline: float) -> None:
        gates = []
        g = 0
        while time.perf_counter() < deadline:
            try:
                gates.append(self.gate(g))
            except Exception as e:  # noqa: BLE001 — counted as a failed gate
                self.errors.append(f"gate {g}: {type(e).__name__}: {e}")
                gates.append((time.perf_counter(), float("inf")))
            g += 1
        self.run.facts["gates"] = gates

    def finish(self) -> None:
        tr.synchronize(self.cards)

    def release(self) -> None:
        self.agent = None
        self.prober = None

    # -- the comparison -------------------------------------------------------

    def compare(self) -> dict:
        dev = self.cards[0]
        b = self.battery

        def expected(plant=None):
            return ref_battery.expected_rows(
                self.gpus, b["matmul_n"], b["hbm_mib"], dev, plant=plant)

        healthy_rows = expected()
        ran = {g for g, _ in self.rows}
        want_by_gate = {g: expected(p) for g, p in self.plants.items()
                        if g in ran}
        gap_by_gate: dict = {}
        wrong: list = []
        for g, rows in self.rows:
            want = want_by_gate.get(g, healthy_rows)
            gap = max((ref_battery.row_gap(r, w) for r, w in
                       zip(rows, want)), default=float("inf"))
            if len(rows) != len(want):
                gap = float("inf")
            gap_by_gate[g] = max(gap_by_gate.get(g, 0.0), gap)
            if gap != 0.0 and len(wrong) < 5:
                wrong.append(f"gate {g}: rows {rows}")
        row_gap = max(gap_by_gate.values(), default=float("inf"))
        # The checks each gate's battery has to fail: those the plant
        # moves off the healthy answers (every one where no battery ran).
        failing_by_gate = {g: set() for g in gap_by_gate}
        for g, want in want_by_gate.items():
            failing_by_gate[g] = ref_battery.failing_checks(want, healthy_rows)
        mismatches, report_faults = [], []
        everything = set(ref_battery.ENTRY_CHECK)
        for g, kind, healthy, raw, rev in self.verdicts:
            failing = failing_by_gate.get(g, everything)
            want_v = ref_verdict.verdict(raw, rev, self.gpus, self.deep,
                                         failing, self.max_age_s)
            if want_v != healthy:
                mismatches.append((g, kind))
            if kind == "fresh":
                report_faults += [f"gate {g}: {f}" for f in
                                  ref_verdict.report_faults(
                                      raw, self.gpus, self.deep, failing)]
        checks = {
            "row_gap": row_gap,
            "verdict_mismatches": float(len(mismatches)),
            "report_faults": float(len(report_faults)),
            "gate_errors": float(len(self.errors)),
        }
        if self.deep:
            checks["attention_gap"] = self.attention_gap(dev)
        bad = {g for g, _ in mismatches} | {
            g for g, gap in gap_by_gate.items() if gap != 0.0}
        planted = sum(1 for g in want_by_gate if g >= 0)
        return {"checks": checks,
                "attempted": len(self.run.facts.get("gates", [])),
                "failed": len({g for g in bad if g >= 0}) + len(self.errors),
                "notes": ([f"{planted} gates with a planted fault"]
                          + self.errors + wrong + report_faults)[:8]}

    def attention_gap(self, dev, precision: str = "bf16") -> float:
        """The widest gap between the sampled deep probes' outputs and
        whole-sequence causal attention on the probe's inputs."""
        if not self.attention:
            return float("inf")
        seq = ref_attention_seq(self.gpus)
        q, k, v = (t.to(dev) for t in ref_attention.probe_inputs(
            seq, DEEP_SHAPE[0], DEEP_SHAPE[1], DEEP_SHAPE[2]))
        want = ref_attention.causal_attention(q, k, v, precision)
        worst = 0.0
        for _, shards in self.attention:
            got = torch.cat([s.to(dev) for s in shards], dim=1)
            if got.shape != want.shape:
                return float("inf")
            d = float((got - want).abs().max())
            worst = max(worst, d if d == d else float("inf"))
        return worst


# The deep probe's specification (health/probes.py: ici_ring_attention_probe
# and ring_attention_soak): 128 positions a member, batch 1, 4 heads of 64.
DEEP_SEQ_PER_MEMBER = 128
DEEP_SHAPE = (1, 4, 64)


def ref_attention_seq(members: int) -> int:
    return DEEP_SEQ_PER_MEMBER * members
