"""The port's regression guard (``bench_guard``) on the CPU, at small
sizes.

- On the reference's TPU-slice fleets (``tpu_slices=True``) each port
  stage gives the counts of the JAX package's ``tools/bench_guard.py``
  stage with the same size arguments: pools walked, requests, writes
  per transition, collapse ratio, waves and assignment, packed against
  greedy waves, spans, the confirmed node, the per-verb write delta.
  Times are not compared.
- On small GFD-labelled fleets each stage meets its pins, every node
  its own pool.
- The battery stage runs on the port's CPU members (the kernels' plain
  versions) and meets its count pins; its two ceilings are the card's.
- ``main()`` exits 1 on each broken pin, injected into a passing record,
  and stops at the first broken stage.
"""

from __future__ import annotations

import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest

from k8s_operator_libs_tpu_torch import bench_guard as T
from k8s_operator_libs_tpu_torch.bench_fleet import GFD_PRODUCTS
from k8s_operator_libs_tpu_torch.entry import members_of
from k8s_operator_libs_tpu_torch.fleet.profiles import known_generations
from k8s_operator_libs_tpu_torch.hw import chip_spec

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
import bench_guard as J  # noqa: E402

# Each stage's size arguments, the same for both packages.
SIZES = {
    "measure": dict(slices=4, hosts=4, ticks=3),
    "measure_sharded": dict(slices=8, hosts=4, idle_ticks=20),
    "measure_write_hygiene": dict(slices=2, hosts=4, idle_slices=8,
                                  idle_hosts=4, idle_ticks=10, storm=50),
    "measure_planner": dict(slices=16, hosts=4, twin_slices=4,
                            twin_hosts=2),
    "measure_packed_admission": dict(n_singles=7, n_quads=6,
                                     twin_singles=4, twin_quads=4),
    "measure_tracing": dict(slices=4, hosts=2, idle_slices=8, idle_hosts=4,
                            idle_ticks=5, storm=20),
    "measure_telemetry": dict(n_nodes=48, roll_slices=2, roll_hosts=2),
    "measure_incremental": dict(slices=50, hosts=4, idle_ticks=10),
}
MULTI = dict(slices=4, hosts=2)
TRACING_REPS = T.TRACING_TIMING_REPS
# The tracing pin here reads each leg's process CPU seconds a tick, not
# the wall seconds the card's run reads: at this size a leg's p99 is its
# slowest of 31 ticks of about 3 ms, and beside the other test workers a
# tick can wait 10-40 ms for a core, in most legs of one side at once.
CPU_TICKS = dict(cpu_ticks=True)
# The counts each stage's records must share (the spool's bytes hold
# timestamps, whose digits vary from run to run).
COUNTS = {
    "measure": ("nodes", "ticks", "sync_api_requests", "api_requests_total",
                "api_requests_per_tick", "cache_hits", "cache_misses"),
    "measure_sharded": ("nodes", "pools", "idle_pools_walked_total",
                        "idle_api_requests_total", "active_pools_walked"),
    "measure_write_hygiene": (
        "roll_transitions", "roll_node_writes", "roll_writes_per_transition",
        "writes_coalesced_keys", "conflict_replays", "idle_writes_total",
        "events_published", "event_collapse_ratio"),
    "measure_planner": ("pending_groups", "plan_waves", "plan_writes",
                        "twin_converged", "analytic_waves", "twin_waves",
                        "node_wave_agrees"),
    "measure_packed_admission": (
        "greedy_waves", "packed_waves", "greedy_duration_s",
        "packed_duration_s", "plan_writes", "engine_greedy_waves",
        "engine_packed_waves", "engine_packed_mode",
        "engine_plan_wave_agrees", "packed_admitted", "greedy_idle_ticks",
        "packed_idle_ticks"),
    "measure_tracing": ("trace_completed", "trace_spans", "trace_connected",
                        "trace_open_spans", "trace_drops", "trace_groups",
                        "idle_pools_walked_total", "idle_writes_total",
                        "storm_dumps", "storm_spool_files"),
    "measure_telemetry": ("nodes", "cohorts", "adopted", "straggler",
                          "straggler_confirmed", "straggler_streak",
                          "confirmed", "false_positives", "drops",
                          "writes_without_telemetry", "writes_with_telemetry",
                          "extra_writes", "rings_persisted"),
    "measure_multi_artifact": (
        "nodes", "groups", "converged", "cordons_per_node", "nodes_cordoned",
        "drains_per_node", "nodes_drained", "charges_per_group",
        "groups_charged", "write_delta", "extra_writes_clean",
        "window_savings", "skew_holds"),
    "measure_incremental": (
        "nodes", "pools", "resync_diff_mismatches", "snapshot_reused",
        "snapshot_shared", "idle_pools_walked_total",
        "idle_api_requests_total", "active_pools_walked", "matview_hits",
        "matview_rows", "matview_pools"),
}


def _jax(stage: str) -> dict:
    if stage == "measure_multi_artifact":
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(J, "MULTI_ART_N_SLICES", MULTI["slices"])
            mp.setattr(J, "MULTI_ART_HOSTS_PER_SLICE", MULTI["hosts"])
            return J.measure_multi_artifact()
    if stage == "measure_tracing":
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(J, "TRACING_TIMING_REPS", TRACING_REPS)
            return J.measure_tracing(**SIZES[stage])
    return getattr(J, stage)(**SIZES[stage])


def _port(stage: str, tpu_slices: bool) -> dict:
    if stage == "measure_multi_artifact":
        return T.measure_multi_artifact(tpu_slices=tpu_slices, **MULTI)
    if stage == "measure_packed_admission":
        return T.measure_packed_admission(**SIZES[stage])
    kw = dict(SIZES[stage], tpu_slices=tpu_slices)
    if stage == "measure_tracing":
        kw.update(reps=TRACING_REPS, **CPU_TICKS)
    return getattr(T, stage)(**kw)


@pytest.fixture(scope="module")
def write_hygiene():
    """The write-hygiene stage's three rolls at once: each waits out the
    informer's 30 s freshness bound before its first pod restart shows
    (the reference stage does the same)."""
    stage = "measure_write_hygiene"
    with ThreadPoolExecutor(3) as pool:
        runs = [pool.submit(_jax, stage), pool.submit(_port, stage, True),
                pool.submit(_port, stage, False)]
        return tuple(r.result() for r in runs)


def _records(stage: str, write_hygiene) -> tuple[dict, dict, dict]:
    """(JAX, port on TPU slices, port on GFD nodes) records of
    ``stage``."""
    if stage == "measure_write_hygiene":
        return write_hygiene
    return _jax(stage), _port(stage, True), _port(stage, False)


@pytest.mark.parametrize("stage", sorted(COUNTS))
def test_each_stage_gives_the_reference_counts_and_holds_its_pins(
        stage, write_hygiene):
    ref, port, gfd = _records(stage, write_hygiene)
    assert {k: port[k] for k in COUNTS[stage]} == {
        k: ref[k] for k in COUNTS[stage]}
    assert port["shape"] == "tpu-slices"
    assert T.check(port) == []
    if stage == "measure_packed_admission":
        # Always the reference's fleet, and the record says why.
        assert gfd["shape"] == "tpu-slices" and "GFD node" in gfd["why"]
        return
    assert gfd["shape"] == "gfd"
    assert T.check(gfd) == [], gfd


def test_both_tracing_legs_run_beside_the_same_heap(monkeypatch):
    """Every untraced and traced roll starts alike: each in a child
    interpreter of its own (``--tracing-leg``), a rep's two legs at once,
    the storm in the last traced leg only (the reference's legs share
    one process, whose first roll runs on a fresh heap and whose later
    legs run beside none, one or two earlier fleets)."""
    import subprocess

    legs, procs, other_running = [], [], []
    real_popen = subprocess.Popen

    def recording(cmd, **kw):
        assert cmd[-2] == "--tracing-leg"
        legs.append(json.loads(cmd[-1]))
        other_running.append(bool(procs) and procs[-1].poll() is None)
        procs.append(real_popen(cmd, **kw))
        return procs[-1]

    monkeypatch.setattr(T.subprocess, "Popen", recording)
    r = T.measure_tracing(**SIZES["measure_tracing"], reps=3, **CPU_TICKS)
    assert [leg["enable_tracing"] for leg in legs] == [False, True] * 3
    # A rep's traced leg starts while its untraced leg runs.
    assert other_running[1::2] == [True] * 3
    storm = SIZES["measure_tracing"]["storm"]
    assert [leg["storm"] for leg in legs] == [0] * 5 + [storm]
    assert all(leg["cpu_ticks"] for leg in legs)
    assert r["tick_clock"] == "process cpu"
    assert r["leg_processes"] == 6
    assert len(r["leg_p99_off_s"]) == len(r["leg_p99_on_s"]) == 3
    assert r["p99_tick_off_s"] == sorted(r["leg_p99_off_s"])[1]
    assert r["p99_tick_on_s"] == sorted(r["leg_p99_on_s"])[1]
    assert r["storm_dumps"] == storm and T.check(r) == []


def test_the_tracing_pin_reads_each_leg_s_median_p99():
    """The median leg's p99, not the least: one low untraced outlier
    (0.0574 s among 0.069-0.100 s on an H100 machine's host) cannot break the pin, and
    a traced leg slower in every rep still does."""
    def leg(p99):
        return {"ticks": [1.0] + [p99] * 10}

    off = [0.0995, 0.0574, 0.0828, 0.0693, 0.0742]
    on = [0.0917, 0.0664, 0.0711, 0.0733, 0.0741]
    assert T._median_leg([leg(p) for p in off])["ticks"][1] == 0.0742
    assert T._median_leg([leg(p) for p in on])["ticks"][1] == 0.0733
    assert T._median_leg([leg(0.2), leg(0.1)])["ticks"][1] == 0.1
    slower = T._median_leg([leg(p * 1.2) for p in off])["ticks"]
    allowed = 0.0742 * (1 + T.TRACING_OVERHEAD_CEILING_PCT / 100) + (
        T.TRACING_OVERHEAD_GRACE_S)
    assert T._p99(slower) > allowed


def test_a_tracing_leg_parks_the_heap_before_it(monkeypatch):
    """In its process a leg first rolls one node untimed (a fresh
    process's first pass pays one-time costs), then freezes the heap
    before it builds its fleet and unfreezes it after the roll; only a
    traced leg reads a trace, and only a leg given a storm runs one."""
    import gc

    events = []
    real_freeze, real_unfreeze = gc.freeze, gc.unfreeze

    def freeze():
        events.append("freeze")
        real_freeze()

    def unfreeze():
        events.append("unfreeze")
        real_unfreeze()

    class Recording(T.ClusterUpgradeStateManager):
        def __init__(self, *args, **kw):
            events.append("manager")
            super().__init__(*args, **kw)

    monkeypatch.setattr(T.gc, "freeze", freeze)
    monkeypatch.setattr(T.gc, "unfreeze", unfreeze)
    monkeypatch.setattr(T, "ClusterUpgradeStateManager", Recording)
    sizes = dict(slices=4, hosts=2)
    off = T.tracing_leg(False, **sizes)
    assert events == ["manager", "freeze", "manager", "unfreeze"]
    assert set(off) == {"ticks"} and len(off["ticks"]) > 4
    assert gc.get_freeze_count() == 0
    on = T.tracing_leg(True, storm=20, **sizes)
    assert on["trace_completed"] and on["trace_connected"]
    assert on["trace_open_spans"] == 0 and on["storm_dumps"] == 20
    assert 0 < on["spool_bytes"] <= T.TRACING_SPOOL_CAP_BYTES
    assert "storm_dumps" not in T.tracing_leg(True, **sizes)


@pytest.mark.parametrize("stage", ["measure_sharded", "measure_incremental"])
def test_every_gfd_node_is_its_own_pool(stage):
    r = _port(stage, False)
    assert r["pools"] == r["nodes"] == (SIZES[stage]["slices"]
                                        * SIZES[stage]["hosts"])
    assert r["active_pools_walked"] == 1
    if stage == "measure_incremental":
        assert r["matview_pools"] == r["nodes"]


def test_the_gfd_planner_mixes_the_three_h100_products():
    r = T.measure_planner(**SIZES["measure_planner"])
    # One node a group, four at a time.
    assert r["pending_groups"] == r["nodes"]
    assert r["plan_waves"] == r["nodes"] // 4
    assert list(GFD_PRODUCTS) == [p.name for p in known_generations()]


def test_telemetry_reads_the_h100_figures_from_hw():
    gens = T.telemetry_generations()
    assert [g[0] for g in gens] == list(GFD_PRODUCTS.values())
    for product, _, tflops, gbps in gens:
        assert (tflops, gbps) == (chip_spec(product).bf16_tflops,
                                  chip_spec(product).hbm_gbps)
    r = T.measure_telemetry(**SIZES["measure_telemetry"])
    assert r["confirmed"] == [r["straggler"]]
    assert r["straggler_generation"] == GFD_PRODUCTS["h100-pcie"]
    assert r["generation_tflops"] == {g[0]: g[2] for g in gens}


def test_the_gfd_stack_is_the_gpu_operator_s():
    r = T.measure_multi_artifact(**MULTI)
    assert r["stack"] == ["driver", "mofed-driver", "nvidia-device-plugin"]
    assert r["groups"] == r["nodes"] == MULTI["slices"] * MULTI["hosts"]
    assert r["write_delta"] == {"delete_pod": 2 * r["nodes"],
                                "create_pod": 2 * r["nodes"]}


@pytest.fixture(scope="module")
def battery():
    return T.measure_probe_battery(members_of(8, "cpu"), T.BATTERY_CPU_SIZES)


def test_the_battery_stage_holds_its_count_pins_on_cpu_members(battery):
    assert battery["devices"] == 8 and battery["device"] == "cpu"
    assert battery["checks_ok"], battery["failed_checks"]
    assert battery["fallbacks"] == 0
    assert battery["warm_cache_hit"]
    assert (battery["compile_cache_misses"],
            battery["compile_cache_hits"]) == (1, 1)
    assert battery["gate_passed"] and battery["validation_wall_s"] > 0


@pytest.fixture(scope="module")
def passing(write_hygiene, battery):
    """A passing record of every stage, from the small GFD runs (the
    100,000-node stage's from its small form).  The timing pins that a
    small CPU run cannot be held to are set to passing readings: the
    tracing legs' p99 and the battery's times (its ceilings are the
    card's)."""
    records = {
        "cached_reconcile": _port("measure", False),
        "sharded_reconcile": _port("measure_sharded", False),
        "write_hygiene": write_hygiene[2],
        "planner": _port("measure_planner", False),
        "packed_admission": _port("measure_packed_admission", False),
        "tracing": dict(_port("measure_tracing", False),
                        p99_tick_on_s=0.01, p99_tick_off_s=0.01),
        "telemetry": _port("measure_telemetry", False),
        "multi_artifact": T.measure_multi_artifact(**MULTI),
        "probe_battery": dict(battery, warm_s=0.1, validation_wall_s=0.5),
        "incremental_100k": dict(_port("measure_incremental", False),
                                 stage="incremental_100k"),
    }
    for r in records.values():
        assert T.check(r) == [], r
    return records


def _run_main(monkeypatch, capsys, records: dict) -> tuple[int, list, str]:
    ran = []

    def fake_stages(members=None, battery_sizes=None):
        def thunk(name):
            def run():
                ran.append(name)
                return json.loads(json.dumps(records[name]))
            return run
        return [(name, thunk(name)) for name in T.PINS]

    monkeypatch.setattr(T, "stages", fake_stages)
    rc = T.main([])
    out, err = capsys.readouterr()
    return rc, ran, err


BROKEN = [
    ("cached_reconcile", "api_requests_per_tick", 1.0),
    ("sharded_reconcile", "idle_pools_walked_total", 1),
    ("sharded_reconcile", "idle_api_requests_total", 1),
    ("sharded_reconcile", "idle_p99_tick_s", 0.06),
    ("sharded_reconcile", "active_pools_walked", 2),
    ("sharded_reconcile", "active_tick_s", 1.5),
    ("write_hygiene", "roll_writes_per_transition", 2.5),
    ("write_hygiene", "idle_writes_total", 1),
    ("write_hygiene", "event_collapse_ratio", 9.0),
    ("planner", "plan_wall_s", 1.5),
    ("planner", "plan_writes", 1),
    ("planner", "twin_converged", False),
    ("planner", "twin_waves", 0),
    ("planner", "node_wave_agrees", False),
    ("packed_admission", "packed_waves", 10 ** 6),
    ("packed_admission", "packed_duration_s", 1e9),
    ("packed_admission", "plan_writes", 1),
    ("packed_admission", "engine_greedy_converged", False),
    ("packed_admission", "engine_packed_converged", False),
    ("packed_admission", "engine_packed_waves", 10 ** 6),
    ("packed_admission", "engine_packed_mode", "greedy"),
    ("packed_admission", "engine_plan_wave_agrees", False),
    ("packed_admission", "greedy_idle_ticks", 1),
    ("packed_admission", "packed_idle_ticks", 1),
    ("tracing", "p99_tick_on_s", 0.0161),
    ("tracing", "trace_completed", False),
    ("tracing", "trace_connected", False),
    ("tracing", "trace_open_spans", 1),
    ("tracing", "trace_drops", 1),
    ("tracing", "bucket_sum_error_pct", 1.5),
    ("tracing", "idle_tracing_enabled", False),
    ("tracing", "idle_pools_walked_total", 1),
    ("tracing", "idle_writes_total", 1),
    ("tracing", "storm_dumps", 0),
    ("tracing", "spool_bytes", 64 * 1024 + 1),
    ("telemetry", "adopted", 1),
    ("telemetry", "straggler_confirmed", False),
    ("telemetry", "false_positives", 1),
    ("telemetry", "drops", 1),
    ("telemetry", "extra_writes", 1),
    ("telemetry", "rings_persisted", 1),
    ("multi_artifact", "converged", False),
    ("multi_artifact", "cordons_per_node", [1, 2]),
    ("multi_artifact", "nodes_drained", 1),
    ("multi_artifact", "charges_per_group", [2]),
    ("multi_artifact", "extra_writes_clean", False),
    ("multi_artifact", "window_savings", 1),
    ("probe_battery", "checks_ok", False),
    ("probe_battery", "fallbacks", 1),
    ("probe_battery", "warm_cache_hit", False),
    ("probe_battery", "warm_s", T.BATTERY_WARM_CEILING_S * 1.01),
    ("probe_battery", "gate_passed", False),
    ("probe_battery", "validation_wall_s",
     T.VALIDATION_WALL_CEILING_S * 1.01),
    ("incremental_100k", "resync_diff_mismatches", 1),
    ("incremental_100k", "idle_pools_walked_total", 1),
    ("incremental_100k", "idle_api_requests_total", 1),
    ("incremental_100k", "idle_p99_tick_s", 0.06),
    ("incremental_100k", "active_pools_walked", 0),
    ("incremental_100k", "active_tick_s", 1.5),
    ("incremental_100k", "matview_hits", 0),
    ("incremental_100k", "snapshot_shared", False),
    ("incremental_100k", "snapshot_build_s", 0.6),
    ("incremental_100k", "snapshot_reused", False),
    ("incremental_100k", "peak_rss_mib", 4097.0),
]


def test_main_passes_when_every_pin_holds(passing, monkeypatch, capsys):
    rc, ran, err = _run_main(monkeypatch, capsys, passing)
    assert rc == 0 and ran == list(T.PINS) and "FAIL" not in err


@pytest.mark.parametrize("stage, key, value", BROKEN,
                         ids=[f"{s}-{k}" for s, k, _ in BROKEN])
def test_main_exits_1_on_a_broken_pin(stage, key, value, passing,
                                      monkeypatch, capsys):
    records = dict(passing)
    records[stage] = dict(passing[stage], **{key: value})
    rc, ran, err = _run_main(monkeypatch, capsys, records)
    assert rc == 1
    # It stops at the broken stage and names it.
    assert ran == list(T.PINS)[:list(T.PINS).index(stage) + 1]
    assert f"bench-guard FAIL ({stage})" in err


def test_the_100k_stage_runs_in_a_child_of_its_own(monkeypatch):
    """``--stage incremental_100k`` in a child: the record parses and its
    peak RSS is the child's own, not the caller's."""
    import subprocess

    calls = []
    real_popen = subprocess.Popen

    def small_child(cmd, **kw):
        calls.append(cmd)
        code = ("import json, sys; from k8s_operator_libs_tpu_torch import "
                "bench_guard as T; r = T.measure_incremental(slices=10, "
                "hosts=4, idle_ticks=5); T.check(r); "
                "print(json.dumps(r, sort_keys=True))")
        return real_popen([sys.executable, "-c", code], **kw)

    monkeypatch.setattr(T.subprocess, "Popen", small_child)
    # A caller a GiB larger than the child: the child's ru_maxrss would
    # keep the caller's resident set from the fork, its own high water
    # does not.
    ballast = bytearray(1 << 30)
    ballast[::4096] = b"\1" * (len(ballast) // 4096)
    r = T.measure_in_child("incremental_100k")
    del ballast
    assert calls[0][-2:] == ["--stage", "incremental_100k"]
    assert r["process"] == "child" and r["ok"] and r["pools"] == 40
    assert r["peak_rss_mib"] < 1024


@pytest.mark.parametrize("package", ["reference", "port"])
def test_the_gfd_harness_runs_either_package(package):
    """``tests/guard_on_gfd.py`` runs the incremental stage of either
    package on GFD nodes: each node its own pool, the view's one pool a
    delta, the resident set before the stage beside its peak."""
    import subprocess

    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "guard_on_gfd.py"), package,
         "incremental", "--slices", "5", "--hosts", "4"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    r = json.loads(proc.stdout.splitlines()[-1])
    assert (r["package"], r["nodes"], r["torch_imported"]) == (
        package, 20, False)
    assert r["resync_diff_mismatches"] == 0
    assert r["active_pools_walked"] == 1 and r["matview_hits"] == 1
    assert r["matview_pools"] == 20
    assert 0 < r["start_rss_mib"] <= r["peak_rss_mib"]

