"""The port bench's DCN, cross-ring, failure-injection and heterogeneous
stages on the CPU, at small sizes.

Each stage runs once a module (8 CPU members, the tiny canary, small
batteries, the failure roll's timeouts shortened) and its pins are held:
the DCN roll never has two nodes of one ring out but does have two of
different rings, and the pair's downtime covers both ring-a windows; the
failure roll reaches every pin of the bench's; the heterogeneous stage's
pins are those of the JAX package's own ``measure_heterogeneous``; the
cross-ring world of two worker processes on the CPU passes, and a worker
that dies, prints garbage or hangs is recorded, not raised; the
controller's own modes hold phase 17's pins, and each broken pin is
named; the bench's
line with every stage's pins (the controller roll's and each guard
stage's among them) stays within 2 KB and drops none.
"""

from __future__ import annotations

import json
import sys
import threading
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from k8s_operator_libs_tpu_torch import bench  # noqa: E402
from k8s_operator_libs_tpu_torch import bench_guard  # noqa: E402
from k8s_operator_libs_tpu_torch import bench_io  # noqa: E402
from k8s_operator_libs_tpu_torch.workloads.canary import (  # noqa: E402
    CanaryConfig,
    CanaryRunner,
)

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
MEMBERS = [CPU] * bench.GPUS_PER_NODE
TINY = CanaryConfig(vocab=64, d_model=32, n_heads=2, n_layers=1, d_ff=64,
                    seq_len=16, batch=4)
SMALL = bench.BatterySize(matmul_n=64, hbm_mib=1, allreduce_elems=64)
# The failure roll's clocks, shortened from the bench's (30 s gate, 10 s
# stuck threshold, 5 s recovery backoff, 2 s ladder rungs).
SHORT = dict(validation_timeout_s=4, stuck_threshold_s=1,
             recovery_backoff_s=0.5, evict_timeout_s=1, delete_timeout_s=1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # Six pytest workers share the host: one intra-op thread each.
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def dcn(_one_torch_thread):
    canary = CanaryRunner(TINY, device=CPU)
    canary.run_step()
    return bench.roll(MEMBERS, canary, threading.Lock(), pipeline=False,
                      attribution=False, sizes=(SMALL, SMALL), dcn=True)


@pytest.fixture(scope="module")
def failinj(_one_torch_thread):
    return bench.failure_injection_roll(MEMBERS, threading.Lock(),
                                        sizes=(SMALL, SMALL), **SHORT)


@pytest.fixture(scope="module")
def heterogeneous():
    return bench.heterogeneous_roll()


@pytest.fixture(scope="module")
def collective():
    # The workers inherit the env: one intra-op thread each.
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        return bench.dcn_collective_stage(device="cpu", size=SMALL,
                                          timeout_s=120.0)


def test_the_dcn_roll_keeps_each_ring_whole(dcn):
    assert dcn["complete"], dcn.get("final_states")
    assert dcn["max_ring_unavailable"] == 1
    assert dcn["max_concurrent_unavailable"] == 2
    assert dcn["canary_nodes"] == ["pool-0", "pool-1"]
    assert dcn["canary_error"] is None
    at: dict[str, dict[str, float]] = {}
    for t, name, state in dcn["transitions"]:
        at.setdefault(name, {}).setdefault(state, t)
    assert {n: s for n, s in ((n, max(v, key=v.get)) for n, v in at.items())
            } == {f"pool-{i}": "upgrade-done" for i in range(4)}
    # Ring-a's nodes roll one after the other, each beside ring-b's.
    assert at["pool-1"]["cordon-required"] >= at["pool-0"]["upgrade-done"]
    assert at["pool-3"]["cordon-required"] >= at["pool-2"]["upgrade-done"]
    # Each ring-a node is cordoned from before wait-for-jobs-required
    # until after uncordon-required is reached: the pair's pause, which
    # its longest gap covers.
    for node in ("pool-0", "pool-1"):
        paused = (at[node]["uncordon-required"]
                  - at[node]["wait-for-jobs-required"])
        assert 0 < paused <= dcn["downtime_s"]
    assert dcn["downtime_s"] < 60


def test_the_failure_roll_reaches_every_pin(failinj):
    pins = bench.failure_roll_pins(failinj)
    assert pins == {k: True for k in pins}, failinj
    assert failinj["gate_rejections"][0] == "no health report from node pool-1"
    assert failinj["stuck_event_sample"].startswith(
        "Upgrade stuck: group pool-1 has been in 'validation-required'")
    timeline = failinj["timeline"]
    assert (timeline["t_agent_killed"] < timeline["t_validation_start"]
            < timeline["t_failed"] <= timeline["t_recovered"])
    assert (timeline["t_validation_start"] < timeline["t_stuck_event"]
            < timeline["t_failed"])
    # Not before the gate's timeout: the engine waited it out.
    assert failinj["failed_within_s"] >= SHORT["validation_timeout_s"] - 1
    assert (timeline["t_node_down"] < timeline["t_quarantined"]
            < timeline["t_rejoined"])
    assert failinj["escalations"].get("force_delete", 0) >= 1
    kill = failinj["controller_kill"]
    assert kill["kills"] == 1 and kill["recovery_ticks"] >= 1
    assert kill["adopted"]["groups"] >= 1
    finals = {}
    for _, name, state in failinj["transitions"]:
        finals[name] = state
    assert finals == {f"pool-{i}": "upgrade-done" for i in range(4)}


def _record_held(**change) -> dict:
    timeline = {"t_validation_start": 10.0, "t_stuck_event": 20.5,
                "t_failed": 40.6}
    timeline.update(change.pop("timeline", {}))
    r = {"complete": True, "gate_named_victim": True,
         "stuck_events_naming_victim": 1, "validation_timeout_s": 30,
         "fail_slack_s": bench.FAILINJ_FAIL_SLACK_S,
         "failed_within_s": timeline["t_failed"]
         - timeline["t_validation_start"],
         "recovered": True, "quarantines": 1, "rejoins": 1,
         "stuck_pod_cleared": True,
         "controller_kill": {"kills": 1, "recovery_ticks": 2},
         "timeline": timeline}
    r.update(change)
    return r


@pytest.mark.parametrize("change, broken", [
    ({}, None),
    # A failure one recovery backoff late is not within the timeout.
    ({"timeline": {"t_failed": 45.0}}, "failed_within_timeout"),
    # A stuck event that only comes once the engine gave up is too late.
    ({"timeline": {"t_stuck_event": 41.0}}, "stuck_event_named_victim"),
    ({"timeline": {"t_stuck_event": 40.6}}, "stuck_event_named_victim"),
    ({"stuck_events_naming_victim": 0}, "stuck_event_named_victim"),
])
def test_the_failure_pins_hold_the_gate_s_clocks(change, broken):
    pins = bench.failure_roll_pins(_record_held(**change))
    assert {k for k, v in pins.items() if not v} == (
        {broken} if broken else set())


def test_the_heterogeneous_pins_are_the_reference_stage_s(heterogeneous):
    sys.path.insert(0, str(ROOT / "tools"))
    import bench_guard

    ref = bench_guard.measure_heterogeneous()
    pins = ("converged", "window_opened", "oldest_first",
            "held_transitions_while_closed", "held_cordons_while_closed")
    assert {k: heterogeneous[k] for k in pins} == {k: ref[k] for k in pins}
    assert heterogeneous["converged"] and heterogeneous["oldest_first"]
    assert heterogeneous["held_transitions_while_closed"] == 0
    assert heterogeneous["held_cordons_while_closed"] == 0
    assert heterogeneous["admission_order"] == [
        "h100-pcie", "h100-sxm", "h100-nvl"]
    assert heterogeneous["nodes"] == 6


def test_the_cross_ring_world_passes_on_the_cpu(collective):
    assert collective["ok"], collective
    for ring in ("ring-a", "ring-b"):
        verdict = collective["rings"][ring]
        assert verdict["dcn_collective"] is True
        assert verdict["healthy"] is True and verdict["failed"] == []
        assert verdict["world_size"] == 2
        # The CPU takes every kernel's plain version: no launch.
        assert set(verdict["launches"].values()) == {0}
        assert collective["gates"][ring] == {
            "healthy": True, "detail": "all 1 host report(s) healthy"}
    assert "NCCL refuses two ranks on one GPU" in collective["backend"]


@pytest.mark.parametrize(
    "source, timeout_s, error",
    [
        ("raise SystemExit(5)", 60.0, "worker rc=5"),
        ("print('not a report')", 60.0, "unparseable worker report"),
        ("print('{\"checks\": 1}')", 60.0, "unparseable worker report"),
        ("import time; time.sleep(60)", 1.0, "worker timed out after 1 s"),
    ],
    ids=["dies", "garbage", "bad_json", "hangs"],
)
def test_a_failed_worker_is_recorded_not_raised(source, timeout_s, error):
    stage = bench.dcn_collective_stage(
        device="cpu", timeout_s=timeout_s,
        worker_cmd=[sys.executable, "-c", source],
    )
    assert stage["ok"] is False
    for ring in ("ring-a", "ring-b"):
        assert stage["rings"][ring]["error"].startswith(error)
        assert stage["gates"][ring] == {
            "healthy": False,
            "detail": f"no health report from node dcn-{ring}",
        }


@pytest.fixture(scope="module")
def controller(_one_torch_thread):
    return bench.controller_roll(MEMBERS, SMALL)


@pytest.fixture(scope="module")
def modes(_one_torch_thread):
    return bench.controller_modes(MEMBERS, SMALL)


def test_the_controller_modes_hold_phase_17s_pins(modes):
    """``bench.controller_modes`` on the CPU members holds every pin
    ``chip_smoke.py`` phase 17 requires: each mode's roll complete in
    the generations' order, each node cordoned once, the sharded roll on
    dirty passes and idle after, the standby finishing the crashed
    leader's roll, the dry run's plan that order with no write, no fused
    fallback."""
    pins = bench.controller_modes_pins(modes)
    assert [name for name, ok in pins.items() if not ok] == [], {
        mode: modes[mode]["admitted"]
        for mode in ("watch", "sharded", "failover")}
    assert set(pins) == {
        f"{mode}_{pin}" for mode in ("watch", "sharded", "failover")
        for pin in ("complete", "order", "cordoned_once", "passes")
    } | {"sharded_dirty_passes", "sharded_idle_walks_none",
         "failover_crashed_leader", "failover_standby_took_over",
         "failover_one_leader", "dry_run_no_writes", "dry_run_order",
         "no_fused_fallback"}
    assert modes["dry_run"]["plan_order"] == bench.CONTROLLER_ORDER
    assert modes["dry_run"]["plan_waves"] == 4
    for mode in ("watch", "sharded", "failover"):
        # Each agent's first report, then one a validation at least.
        assert modes[mode]["batteries"] >= 8
        assert 0 < modes[mode]["wall_s"] < bench.MODES_DEADLINE_S
    failover = modes["failover"]
    crashed_at = failover["crashed"][1]
    (_, leader), (took_over_at, standby) = failover["lease_holders"]
    assert (leader, standby) == ("replica-a", "replica-b")
    # The standby waits out the crashed leader's term.
    assert took_over_at - crashed_at >= (
        bench.MODES_ELECTION["lease_duration_s"]
        - bench.MODES_ELECTION["renew_deadline_s"])
    assert failover["passes"]["replica-b"]["full"] > 0


@pytest.mark.parametrize("broken", [
    ("watch", "admitted", ["pool-1", "pool-3", "pool-2", "pool-0"]),
    ("sharded", "idle_tick_pools_walked", 1),
    ("failover", "most_leading_at_once", 2),
    ("failover", "cordons",
     {"pool-3": 1, "pool-1": 2, "pool-2": 1, "pool-0": 1}),
    ("dry_run", "writes", 1),
])
def test_each_broken_mode_pin_is_named(modes, broken):
    """Breaking one reading of the record breaks exactly its pins (of
    those the run held)."""
    mode, key, value = broken
    record = {k: dict(v) if isinstance(v, dict) else v
              for k, v in modes.items()}
    record[mode][key] = value
    held = bench.controller_modes_pins(modes)
    pins = bench.controller_modes_pins(record)
    assert [name for name, ok in pins.items() if held[name] and not ok] == {
        # The dry run's plan is held to the watch roll's admissions.
        "admitted": ["watch_order", "dry_run_order"],
        "idle_tick_pools_walked": ["sharded_idle_walks_none"],
        "most_leading_at_once": ["failover_one_leader"],
        "cordons": ["failover_cordoned_once"],
        "writes": ["dry_run_no_writes"],
    }[key]


def test_the_line_carries_every_stage_pin(dcn, failinj, heterogeneous,
                                          collective, controller, capsys,
                                          tmp_path):
    run = {"complete": True, "wall_s": 41.123456, "downtime_s": 9.876543,
           "node_windows_s": {f"pool-{i}": 10.123456 for i in range(4)},
           "lock": {"wait_in_longest_gap_s": 0.123456,
                    "wait_share": 0.012345},
           "attribution": {"ok": True, "victim": "pool-1"},
           "max_concurrent_unavailable": 1, "canary_steps": 12345,
           "canary_perf": {"median_step_s": 0.123456},
           "canary_error": None}
    records = {
        "card": {"kind": "NVIDIA H100 80GB HBM3", "count": 1},
        "battery": {"metrics": {"mxu_matmul": {"tflops": 612.345},
                                "hbm_bandwidth": {"gbps": 2987.654},
                                "ici_allreduce": {"busbw_gbps": 789.012}},
                    "fused_telemetry": {"battery_cache_hit": 1.0},
                    "failures": {}},
        "sequential": run, "pipelined": run,
        "elastic": {v: {"converged": True, "max_gap_s": 3.456789,
                        "downtime_s": 0.0} for v in ("accept", "decline")},
        "federation": {"converged": True},
        "dcn": dcn, "dcn_collective": collective,
        "failure_injection": failinj, "heterogeneous": heterogeneous,
        "controller": controller,
        # Each guard stage's ok and a headline of many digits.
        "guard": {name: {"ok": True, key: 1234.56789012}
                  for name, (_, key) in bench_guard.PINS.items()},
        "preflight": {"seconds": 8.123456},
    }
    summary = bench.summarize(records)
    line = bench_io.emit(bench.METRIC_NAME, 9.877, "s", 12.15, summary,
                         full_details=records,
                         details_path=str(tmp_path / "details.json"))
    assert capsys.readouterr().out == line + "\n"
    assert len(line.encode()) <= bench_io.MAX_LINE_BYTES
    details = json.loads(line)["details"]
    # Nothing was dropped to fit.
    assert set(details) == set(summary) | {"details_file"}
    assert details["dcn_complete"] is True
    assert details["dcn_ring_high_water"] == 1
    assert details["dcn_collective_ok"] is True
    assert details["failinj_recovered"] is True
    assert (details["failinj_quarantines"], details["failinj_rejoins"]) == (
        1, 1)
    assert details["failinj_stuck_pod_cleared"] is True
    assert details["failinj_recovery_ticks"] >= 1
    assert details["failinj_failed_within_s"] <= (
        SHORT["validation_timeout_s"] + bench.FAILINJ_FAIL_SLACK_S)
    assert details["controller_complete"] is True
    assert details["controller_admitted"] == [
        "pool-3", "pool-1", "pool-2", "pool-0"]
    assert details["controller_fleet_nodes"] == {
        "h100-pcie": 1.0, "h100-sxm": 2.0, "h100-nvl": 1.0}
    assert details["controller_passes"] == controller["passes"]
    assert details["guard"] == {name: [True, 1235.0]
                                for name in bench_guard.PINS}
    assert details["heterogeneous_converged"] is True
    assert details["heterogeneous_oldest_first"] is True
    assert details["heterogeneous_held_transitions"] == 0
