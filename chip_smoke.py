#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

``python3 chip_smoke.py --turn N`` takes only what a before-and-after
compares (phase 3's K4 timings, phase 7's ring-shift round and N
readings of each ICI probe) and prints it as one JSON line; a copy of
this file in another tree of the port (a parent's, say) reads that
tree's kernels and collectives on the same card.

It imports the port (``k8s_operator_libs_tpu_torch``) and nothing of JAX.
Phases:

1. the device: name, count, and ``nvidia-smi`` name and power limit;
2. build the hand-written kernels from ``kernels/csrc`` with nvcc, one
   process per source, all at once;
3. each kernel against its plain PyTorch version on the card: K1, its
   verifying pass (``stream_increment_verify_``, the fused battery's
   last stream pass with the stream's check) and K2 exactly, at the main
   path's shapes and at odd, unaligned, 0.25- and NaN-seeded inputs (a
   NaN at the first and at the last element of the 1 GiB stream); K3 within stated tolerances at every shape the
   ring paths give it (shards before, on and after the diagonal, and
   each path's full reference), the canary's attention shape, odd
   shapes, non-causal and wholly masked blocks, and K3's fused ring step
   (``block_attention_merge_``) there too, from the ring's first-step
   accumulator and from a random running one, within the same limits of
   its plain version and with its merge bit for bit torch's ``_merge``
   on the kernel's own block outputs; the ring on the card against the
   plain version's full attention, one fused launch a step; CUDA-event
   and profiler times beside the bound and one library call (K3 and the
   fused step at the ring's two shards and the canary's shape); then
   the fused battery at a small size on
   the card against the CPU; K4 bit for bit at 1 to 8 sources of 2^20
   and 2^22 elements, at a ragged length aligned and with unaligned
   offsets, and at every shape the main path gives it (the probe's
   reduce-scatter node, the ring shift's one element and 2^17, the
   sharded canary's tp and dp nodes, the elastic roll's dp node at dp 3 x
   tp 2), each with a NaN in one source,
   and the all-reduce (also its persistent form, into new outputs and
   in place) and ring shift (one library call and n K4 launches a call)
   over 2, 3, 4 and 8 members of the card against the plain version,
   with K4's times at those shapes (events, device time with the L2 warm
   and cold); K5 byte for byte at 2, 3, 4, 5 and 8 pieces of 2^20 and
   2^22 elements in all, ragged and unaligned, with the own range
   skipped, and with rows a pitch apart (whole vectors, rows of a length
   that is not a multiple of 16 bytes, rows with a byte head and tail),
   and the all-gather over 2, 3, 4 and 8 members against ``torch.cat``,
   with K5's times; K1's time also at a persistent grid of 8 blocks an
   SM, the design its tiles were chosen against; and every
   collective at the shapes the sharded and elastic canaries give it
   (the tp all-reduce of [16, 512, 1024] over 4 and 2 members, the
   gathers of [16, 512, 1024 / tp] along the last dimension, each timed,
   the dp all-reduce of a member's flat gradients over 2 members, and at
   tp 2 over 3);
4. the unfused battery at production size (n=4096 bf16, 1 GiB stream);
5. the fused battery twice (a warm-up-cache miss, then a hit), with its
   warm time and K2's launches a body (one: the check of C);
6. the node agent publishing a report, which the port's NodeReportProber
   accepts, and the LocalDeviceProber;
7. the host's collectives over 8 members of the one card: both ICI
   probes at their defaults (on the path, then 10 readings of each off
   it, their median printed), the fused battery (a miss, then a hit, with
   K2's launches a body) and
   the unfused one over the 8 members, the LocalDeviceProber over them,
   and a ring in which member 0 keeps its own value, which must fail
   with the JAX package's detail; and the host time to enqueue one
   all-reduce round (one graph launch), the probe's persistent round and
   a functional one, with the members on the card's stream and on 8
   distinct streams (an 8-card board's event traffic), the share of it
   in the kernel library's call (with one, two and three sets of output
   buffers in turn: two graphs a plan, repointed past two), and the bus
   bandwidth that time allows a board; and the ring shift round (one
   graph launch) at one element and 2^20 a member, by events and host
   enqueue;
8. ring attention on the card: the deep probe over an 8-member ring on
   the one card (S 1024), the soak at S 4096, each with one fused launch
   a ring step, the same two rings timed with the fused step and with the
   old one (K3, then the merge in torch ops) in turns, the elastic ring
   (a round, exclude, round, rejoin, round) and the battery with
   ``deep=True`` on one device, where the deep check is vacuous as in
   the JAX package;
9. the canary at the bench's width (103 M parameters) for 3 warm-up and
   20 timed steps, its throughput and sustained device step time; and
   the small canary on the card against the CPU with the same weights
   and batches;
10. the sharded canary at the bench's width over 8 members of the card
   (dp 2 x tp 4): its first loss against the one-device runner's on the
   same weights and batch, 3 warm-up and 10 timed steps, the launches
   and host time of its collectives a step; then the elastic runner at
   the same width over the 8 members in 2 slices: steps, an exclusion
   (8 to 4 members), steps, a rejoin, steps, with each resize's seconds
   and the longest gap between steps;
11. the gate and the cross-host paths: the agent's unfused report from
   a node labelled ``nvidia.com/gpu.product=NVIDIA-H100-80GB-HBM3`` and
   ``nvidia.com/gpu.count`` = the card count, with no slice, which
   ``NodeReportProber(generation_floors=True)`` must accept under the SXM
   profile's HBM floor and reject when labelled with one GPU more; the
   network-path checks over one member and over 8 members of the card,
   cold and warm, the fused battery at their sizes, the
   ``NetworkPathGateProber`` on the card's devices, and the gate over 8
   members with member 0 keeping its value, which must fail with the JAX
   package's detail; then D6: two child processes of this script form a
   gloo world from torchrun-style env over a loopback store and run the
   cross-host probe with the one-hot on the card (both must pass), then
   with ``ring-c`` expected as well and a live listener as their DCN
   peer (reachability passes, the collective fails naming ``ring-c``);
   and a one-rank NCCL world in this process, where the probe must fail
   closed.  NCCL refuses two ranks on one GPU, so the cross-process NCCL
   all-reduce is not verified on a one-card machine;
12. the port's roll: the CUDA preflight (``hostenv.probe_cuda_init``,
   in a child), ``entry()``'s loss on the card against the CPU's with the
   same weights and batch, ``dryrun_multichip(8)`` (a child under its
   watchdog), then the bench's sequential roll of four HGX H100 nodes
   with the attribution check (``bench.roll``: every node's agent over 8
   members of the card, the bench-width canary on pool-0, the H100
   floors at the gate): every node ends ``upgrade-done``, one at a time,
   the canary's downtime is under 120 s and the check names pool-1; its
   wall time, downtime, node windows and lock waits are printed;
13. the port's controller on the card (``bench.controller_roll``): the
   ``UpgradeController`` on its default keys and selector owns the
   driver and agent DaemonSets of four GPU Feature Discovery-labelled
   nodes (``nvidia.com/gpu.product`` NVL, 80GB-HBM3 twice and PCIe,
   named in the reverse of the profiles' order, no slice), with drain,
   one upgrade at a time and the generations' floors; the driver
   spec's version is bumped, and each node's agent (keys and revision
   from the agent DaemonSet's env) runs the fused battery over 8 members
   of the card at the bench's in-flight size between the controller's
   passes.  Every node ends ``upgrade-done``, admitted PCIe, then both
   SXM, then NVL; the controller's ``MetricsServer`` on a free loopback
   port, scraped over HTTP, serves ``fleet_nodes`` by generation (1, 2,
   1) and ``nodes_by_state`` 4 at ``upgrade-done``, and the status
   CLI's gather shows the same rows.  Its wall time, passes, node
   windows and launch counts are printed;
14. the elastic rolls and the federated roll (``bench.elastic_roll``,
   ``bench.federation_roll``): four GFD-labelled nodes, each one slice of
   the bench-width ``ElasticCanaryRunner`` over 8 members of the card,
   roll through the engine's elastic negotiation with the workload's
   coordinator answering the offers, one canary step a pass (the bench
   takes three), first accepting (dp 2 x tp 4, dp 3
   x tp 2 while a node is out: 4 accepted, 4 resizes down and 4 up, none
   left excluded), then declining (4 declined, no resize, every step
   at dp 2 x tp 4); each ends
   with every node ``upgrade-done``, and its longest gap between steps is
   printed with its parts (the slowest step, resize and pass's host
   time), which must bound it, beside the gap ceiling, each resize's
   seconds, the passes and the wall.  Then three member clusters of 64
   GFD-labelled nodes roll under the federation coordinator with cluster
   ``b`` partitioned for 20 ticks mid-roll: it converges with no write to
   ``b`` in the window, no budget violation, at most 8 writes of the
   durable phase record, one partition and one heal;
15. the bench's DCN, cross-ring, failure-injection and heterogeneous
   stages: the DCN roll (``bench.roll(..., dcn=True)``: the four nodes
   as rings ``ring-a`` and ``ring-b`` by ``nvidia.com/gpu-dcn-group``,
   two upgrades at a time, the bench-width canary as ring-a's pair)
   completes with one node of a ring out at most and two nodes out at
   once; the cross-ring collective (``bench.dcn_collective_stage``: two
   worker processes, ``python -m k8s_operator_libs_tpu_torch.bench
   --dcn-worker``, one a ring, in a gloo world, each its node's agent
   with the deep probe over 8 members of the card, publishing through
   the API server) passes ``dcn_collective`` on both rings and both
   gates with ``require_dcn_check``, and each worker prints its own
   launches, which must hold K1, its verifying pass, K2, K3, K4 and K5;
   the failure-injection roll (``bench.failure_injection_roll``) fails
   ``pool-1`` by name after its agent dies, within the 30 s gate timeout
   (and the slack the bench states) of its validation entry, names it in
   a stuck event, recovers it, quarantines and rejoins ``pool-2`` once,
   clears ``pool-3``'s stuck pod and recovers from the engine's kill;
   the heterogeneous stage (``bench.heterogeneous_roll``) admits PCIe
   then SXM, moves nothing of the held NVL pool while its window is
   closed, and converges;
16. the guard's stages (``bench_guard.stages``, the JAX package's
   ``tools/bench_guard.py`` on the port's engine): the cached reconcile
   (256 nodes), the sharded reconcile (4096 GFD nodes, 4096 pools), write
   hygiene, the planner (4096 nodes over H100 PCIe, SXM and NVL and its
   digital twin), packed admission (the reference's TPU slices), tracing
   (each timed roll in a child of its own), telemetry (256 nodes over the three H100 generations), the
   three-artifact stack (driver, NIC driver, device plugin over 256
   nodes), the fused battery and the async gate over the 8 members at
   production size (a path: K1, its verifying pass, K2, K4 and K5, no
   fallback), then the 100,000-node incremental reconcile (100,000
   pools) in a child of its own.  Each record is printed with its host
   seconds, and every pin must hold;
17. the controller's own modes (``bench.controller_modes``), each
   rolling phase 13's pool on a fresh cluster with every validation
   gated by the agents' fused batteries over 8 members of the card:
   first the dry run of a watch-mode controller (its plan's order, no
   write), then its watch-driven roll (resync 120 s, so the roll runs on
   events alone), the sharded one (4 shards, dirty passes, an idle tick
   after that walks no pool) and the leader-elected pair, whose leader
   stops without releasing its Lease once a node is done and whose
   standby takes the Lease and completes the roll, one leader at a
   time.  Each admits PCIe, both SXM, then NVL, cordons each node once,
   and prints its wall, passes and batteries;
18. the installed port: the package laid out as its wheel installs it
   (its ``.py`` files and the kernels' CUDA sources that
   ``pyproject.toml`` ships) in a read-only directory outside the
   checkout; a child process whose ``PYTHONPATH`` is that copy alone
   runs the build entry (``python -m
   k8s_operator_libs_tpu_torch.kernels.build``) into a fresh kernel
   directory, and a second one, with no ``nvcc`` reachable, runs one
   agent battery as the agent container does
   (``HealthAgent(...).run_once()`` on a ``FakeCluster`` node, the deep
   probe on, over 8 members of the card, at production size): its report
   must pass every check, K1-K5 launch with no fused fallback, every
   module and the library come from the copy and the kernel directory,
   and the copy stay byte for byte as it was.  The build's and the
   battery's seconds and the child's launches are printed;
19. the node's entry points as its DaemonSets start them: the port's
   ``KubeApiServer`` over a ``FakeCluster`` holding one GFD-labelled H100
   node, and each container a process of its own, ``python -m
   k8s_operator_libs_tpu_torch.health.agent`` or ``python -m
   k8s_operator_libs_tpu_torch.driver.safe_load_init``, that finds the
   server through ``KUBECONFIG`` alone (no in-cluster config, no token)
   with ``NODE_NAME`` and ``DRIVER_NAME`` set, and the cards this run
   was given.  The agent (its module run as ``__main__`` under a SIGTERM
   handler that prints its launches), with the deep probe on and its
   default battery (production size, every CUDA device), must publish a
   report under the driver's keys that names every check of the fused
   battery and the deep probe, each ok, carries the revision and counts
   every card; its process must have launched K1, K1's verifying pass
   and K2, and over two cards or more K3, K4 and K5 as well (on one card
   the link checks and the deep probe have no peer and do no work, and
   are printed as not exercised), while the kernel directory's listing
   stays as phase 2 left it (the child compiles nothing); with
   ``CUDA_VISIBLE_DEVICES=""`` it must publish an unhealthy report with
   0 devices and the enumeration's failure, and launch nothing; each
   exits 0 when it is terminated once its report lands.  The safe-load init container must announce itself and,
   once the parent removes its annotation, exit 0 within 10 s.  Each
   child has a deadline; its wall and the battery's seconds from the
   report are printed.

Kernel launch counts are zeroed just before each path of phases 4-17
(unfused, fused cold, fused warm, agent, local prober, the collective
paths, the ring paths, the battery with the deep flag, the canary, the
sharded and elastic canaries, the unfused agent of the labelled node,
the network-path checks, the roll, the controller's roll, both elastic
rolls, the DCN and failure-injection rolls, the guard's battery stage,
the controller's modes; phase 18's battery, in its child)
and read just after it: each
path names the kernels it must launch (K1 and K2 on the battery paths,
K1's verifying pass as well on the fused ones, K3 on the ring
paths, K4 and K5 on the all-reduce, sharded, 8-member network, every
roll and both elastic roll paths, K4 on the ring shift's: 2 x 8 on the
ring probe's), and no path
may have fallen back from the fused battery.  The cross-ring workers and
phase 18's battery and phase 19's agent are processes of their own:
each counts its launches and prints them (the agent, its module run as
``__main__``, at its termination; on one card it launches K1 and K2,
since its link checks and deep probe have no peer).  K4's launches are also split by
shape (k, len), from the plans' rounds.  A child process that fails or outlives its time fails
the run.
Any failure exits non-zero and prints no result; so does a machine
without a CUDA device.  The last line of standard output is one JSON
object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import math
import os
import socket
import subprocess
import sys
import threading
import time
from datetime import timedelta
from pathlib import Path

HERE = Path(__file__).resolve().parent

# NVIDIA data sheet, H100 SXM: fp32 outside the tensor cores.  The
# operations side of the elementwise kernels' bound (the bytes side,
# from the card's HBM rate, is the larger one for both).
FP32_PEAK_TFLOPS = 67.0
# Dense bf16 tensor cores, the operations side of K3's bound.
BF16_PEAK_TFLOPS = 989.0
PROD = dict(matmul_n=4096, hbm_mib=1024)
SMALL = dict(matmul_n=128, hbm_mib=1)
# K3 against its plain version, |kernel - plain|.  Both round q, k, p and
# v to bf16 and accumulate in fp32; the sums run in another order, so the
# scores differ by a few fp32 ulps.  m: 1e-4 absolute (|s| < 10).  l:
# 1e-4 relative.  num: 5e-2 absolute, the ring's own contract: a score
# that moves by an ulp can round p to the neighbouring bf16 value, which
# moves num by one bf16 step of p (at most 2^-8 p) times |v| (< 5 here).
K3_M_ATOL = 1e-4
K3_L_RTOL = 1e-4
K3_NUM_ATOL = 5e-2
RING_ATOL = 5e-2
# Rounds of each ring timed with the fused step and with the old one.
RING_TIMED_ROUNDS = 10
BENCH_CANARY = dict(vocab=1024, d_model=1024, n_heads=16, n_layers=8,
                    d_ff=4096, seq_len=512, batch=32)
TINY_CANARY = dict(vocab=64, d_model=64, n_heads=4, n_layers=2, d_ff=128,
                   seq_len=16, batch=8)
# Card against CPU on the small canary, each step's loss (about 4.7).
# The first loss comes from identical weights through the forward pass
# alone, where the card's TF32 products of bf16-rounded operands are
# exact: 1e-4 absolute (fp32 sums in another order, rare bf16 flips).
# Later losses: 1e-3 absolute.  In the backward pass TF32 rounds the
# fp32 gradient operand (2^-11) before the product's bf16 rounding
# (2^-8), and Adam moves a parameter by about lr whatever its gradient's
# size, so a near-zero gradient whose sign differs moves it by 2 lr; the
# CPU tests hold the port to JAX at 1e-3 as well.
TINY_FIRST_LOSS_ATOL = 1e-4
TINY_LOSS_ATOL = 1e-3
CANARY_TIMED_STEPS = 20
SHARDED_TIMED_STEPS = 10
# The sharded canary's first loss against the one-device runner's, same
# weights and batch (about 7.4): the card's TF32 products of
# bf16-rounded operands are exact, and the two differ only in the order
# of fp32 sums (the row-parallel products' partial sums added across the
# tp members) and in the rare bf16 roundings such a difference flips.
# 1e-4 absolute, the limit the small canary's first loss is held to.
SHARDED_FIRST_LOSS_ATOL = 1e-4
# NVLink one way per H100 SXM (NVIDIA data sheet): what an 8-card board's
# all-reduce of a 4 MiB shard needs at least, 2 * 7/8 * 4 MiB over it.
NVLINK_GBPS = 450.0
ICI_MEMBERS = 8
ALLREDUCE_ELEMS = 1 << 20
# Phase 11's cross-process world: one DCN group a process.
DCN_GROUPS = ("ring-a", "ring-b")
DCN_CHILD = "--dcn-child"
DCN_CHILD_TIMEOUT_S = 300
DCN_WARM_CALLS = 20
# Phase 14's elastic rolls take one canary step a pass, not the bench's
# three: phase 16's guard stages add about 400 s of host work, and the
# steps are the depth an elastic roll can lose without losing a pin.
ELASTIC_STEPS_PER_PASS = 1
# Readings of each ICI probe in phase 7 beside its path's one.
ICI_READINGS = 10
TURN_ARG = "--turn"
# Phase 12: entry()'s loss on the card against the CPU's, the same
# weights and batch: 1e-3 absolute, tests/test_torch_canary.py's loss
# limit against JAX.
ENTRY_LOSS_ATOL = 1e-3
PREFLIGHT_TIMEOUT_S = 120
DRYRUN_TIMEOUT_S = 300
# The buffer written between calls timed with a cold L2 (50 MB).
FLUSH_BYTES = 256 * 1024 * 1024


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAIL: {msg}")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dcn_child(group: str, peer: str) -> int:
    """One process of phase 11's world: join it from the torchrun-style
    env (gloo), run the cross-host probe over the card, then the battery
    at small size with ring-c expected as well and ``peer`` as the DCN
    peer; print one JSON line of the results."""
    import torch
    import torch.distributed as dist

    from k8s_operator_libs_tpu_torch.health.agent import (
        maybe_initialize_distributed,
    )
    from k8s_operator_libs_tpu_torch.health.probes import (
        dcn_collective_probe,
        run_host_probe,
    )

    dev = torch.device("cuda", 0)
    require(maybe_initialize_distributed(backend="gloo"),
            "the 2-process world did not form")
    require(maybe_initialize_distributed(backend="gloo"),
            "a second maybe_initialize_distributed call changed the world")
    tensor_devices = []
    all_reduce = dist.all_reduce

    def recorded(tensor, *args, **kwargs):
        tensor_devices.append(str(tensor.device))
        return all_reduce(tensor, *args, **kwargs)

    dist.all_reduce = recorded
    try:
        passing = dcn_collective_probe([dev], group, list(DCN_GROUPS))
        checks = run_host_probe(
            [dev], fused=True, allreduce_elems=8, dcn_peers=[peer],
            dcn_group=group, dcn_expected_groups=[*DCN_GROUPS, "ring-c"],
            **SMALL,
        )
    finally:
        dist.all_reduce = all_reduce
    # Warm calls, each rank entering together after a barrier: the
    # first call's latency holds the world's connection set-up and the
    # other rank's arrival.
    warm = []
    for _ in range(DCN_WARM_CALLS):
        dist.barrier()
        res = dcn_collective_probe([dev], group, list(DCN_GROUPS))
        require(res.ok, f"warm DCN probe: {res.detail}")
        warm.append(res.latency_ms)
    dist.destroy_process_group()
    by_name = {c.name: c.as_dict() for c in checks}
    bad = [f"{c.name}: {c.detail}" for c in checks
           if not c.ok and c.name != "dcn_collective"]
    require(not bad, f"DCN child's battery: {bad}")
    print(json.dumps({
        "tensor_devices": tensor_devices,
        "pass": passing.as_dict(),
        "reach": by_name["dcn_reachability"],
        "ring_c": by_name["dcn_collective"],
        "warm_ms": sorted(warm),
    }), flush=True)
    return 0


def ici_readings(reps: int) -> dict:
    """Both ICI probes over ``ICI_MEMBERS`` members of card 0, ``reps``
    times each: the all-reduce's bus bandwidth (GB/s) and the ring's
    latency (ms), each list sorted (phase 7, and ``turn``)."""
    import torch

    from k8s_operator_libs_tpu_torch.health.probes import (
        ici_allreduce_probe,
        ici_ring_probe,
    )

    members = [torch.device("cuda", 0)] * ICI_MEMBERS
    busbw, ring = [], []
    for _ in range(reps):
        ar = ici_allreduce_probe(members)
        require(ar.ok, f"ici_allreduce: {ar.detail}")
        busbw.append(ar.metrics["busbw_gbps"])
        rp = ici_ring_probe(members)
        require(rp.ok, f"ici_ring: {rp.detail}")
        ring.append(rp.latency_ms)
    return {"busbw_gbps": sorted(busbw), "ici_ring_ms": sorted(ring)}


def card_hbm_gbps(name: str) -> float:
    """The card's memory rate (GB/s) for the bounds, from the port's
    table (an H100 SXM's 3350 for a card it does not know)."""
    from k8s_operator_libs_tpu_torch import hw

    spec = hw.chip_spec(name)
    return spec.hbm_gbps if spec else 3350.0


def bound_ms(nbytes: float, ops: float, hbm_gbps: float,
             peak_tflops: float = FP32_PEAK_TFLOPS) -> tuple[float, str]:
    """The least time (ms) for ``nbytes`` of memory traffic and ``ops``
    operations, and which of the two bounds it."""
    by_bytes = nbytes / (hbm_gbps * 1e9) * 1e3
    by_ops = ops / (peak_tflops * 1e12) * 1e3
    return max(by_bytes, by_ops), (
        "bytes" if by_bytes >= by_ops else "operations"
    )


def events_ms(fn, iters: int, flush_buf=None) -> float:
    """Mean ms per call by CUDA events; with ``flush_buf`` each call
    starts with a cold L2 (the buffer written outside the timed span)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if flush_buf is None:
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters
    total = 0.0
    for _ in range(iters):
        flush_buf.zero_()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def device_ms(fn, iters: int, kernels: tuple, flush_buf=None) -> float:
    """Mean device time per call of the kernels whose names hold one of
    ``kernels``, from a torch.profiler trace: event times also hold host
    launch cost where a launch is shorter than the host's work.  With
    ``flush_buf`` each call starts with a cold L2 (writing the buffer is
    not one of ``kernels``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # A trace that shows none of the kernels (seen now and then on the
    # card, the launches made) is taken again, at most twice.
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                if flush_buf is not None:
                    flush_buf.zero_()
                fn()
            torch.cuda.synchronize()
        us = [op.self_device_time_total for op in prof.key_averages()
              if op.device_type == DeviceType.CUDA
              and any(k in op.key for k in kernels)]
        if us:
            return sum(us) / iters / 1e3
        print(f"[timing] trace {attempt + 1} showed no {kernels}; taken "
              f"again", flush=True)
    require(False, f"no {kernels} in three profiler traces")


def member_elems(tp: int) -> int:
    """A member's parameters in the sharded canary at the bench width
    (dp 2 x tp 4) or an elastic runner's smaller bundle (tp 2: dp 2 with
    one of two slices out, dp 3 with one of four): what the dp round
    reduces."""
    from k8s_operator_libs_tpu_torch.workloads import canary as C

    cfg = C.CanaryConfig(**BENCH_CANARY)

    def walk(shape, spec):
        if isinstance(spec, dict):
            return sum(walk(shape[k], spec[k]) for k in spec)
        return math.prod(shape) // (tp if "tp" in spec else 1)

    return walk(C.param_shapes(cfg), C.param_specs(cfg))


def k4_shapes() -> list[tuple[str, int, int]]:
    """(label, k, len): every shape the main path gives K4, then the two
    large rows kept from earlier runs."""
    from k8s_operator_libs_tpu_torch.kernels import collectives

    def node(elems: int, n: int) -> int:  # a round's first chunk
        a, b = collectives._chunks(elems, n)[0]
        return b - a

    chunk = node(ALLREDUCE_ELEMS, ICI_MEMBERS)
    canary = (BENCH_CANARY["batch"] // 2 * BENCH_CANARY["seq_len"]
              * BENCH_CANARY["d_model"])
    return [
        (f"reduce-scatter node of the probe's round, k 8 x {chunk}", 8,
         chunk),
        ("ring shift node on the main path, k 1 x 1", 1, 1),
        (f"ring shift node, k 1 x {chunk}", 1, chunk),
        (f"canary tp 4 all-reduce node, k 4 x {node(canary, 4)}", 4,
         node(canary, 4)),
        (f"canary tp 2 all-reduce node, k 2 x {node(canary, 2)}", 2,
         node(canary, 2)),
        (f"canary dp round node (tp 4), k 2 x {node(member_elems(4), 2)}",
         2, node(member_elems(4), 2)),
        (f"elastic dp round node (dp 3 x tp 2), k 3 x "
         f"{node(member_elems(2), 3)}", 3, node(member_elems(2), 3)),
        (f"k 8 x {ALLREDUCE_ELEMS} (32 MiB in)", 8, ALLREDUCE_ELEMS),
        ("k 8 x 4194304 (128 MiB in)", 8, 1 << 22),
    ]


def k4_timing(dev, gen, hbm_gbps: float) -> list[dict]:
    """K4 through ``peer_reduce`` at every shape of ``k4_shapes()``: by
    events, device time with the L2 warm (the inputs of the call before,
    as a round's chunks are when their producer just wrote them) and
    cold, the plain version and the library call (one sum over a
    pre-stacked [k, len] tensor, timed only).  Bound: each source read
    once and dst written once; k - 1 adds and a division an element,
    fp32."""
    import torch

    import k8s_operator_libs_tpu_torch.kernels as K

    flush_buf = torch.empty(FLUSH_BYTES // 4, device=dev)
    shapes = []
    for label, k, n in k4_shapes():
        iters = 200 if k * n <= 1 << 21 else 50 if k * n <= 1 << 23 else 20
        srcs = [torch.randn(n, device=dev, generator=gen) for _ in range(k)]
        stacked = torch.stack(srcs)
        dst = torch.empty(n, device=dev)
        b_ms, b_by = bound_ms(4 * (k + 1) * n, k * n, hbm_gbps)

        def run():
            K.peer_reduce(dst, srcs)

        shapes.append(dict(
            at=label, k=k, len=n,
            ms=events_ms(run, iters),
            device_ms=device_ms(run, iters, ("peer_reduce",)),
            device_cold_ms=device_ms(run, iters, ("peer_reduce",),
                                     flush_buf),
            plain_ms=events_ms(lambda: K.peer_reduce_plain(dst, srcs),
                               iters),
            library_ms=events_ms(lambda: stacked.sum(0), iters),
            bound_ms=b_ms, bound_by=b_by,
        ))
        del srcs, stacked, dst
    return shapes


def turn(reps: int) -> dict:
    """What a before-and-after on one card compares, for the tree of the
    port this file sits in: ``k4_timing``, the ring-shift round over
    ``ICI_MEMBERS`` members of card 0 by events (one element and
    ``ALLREDUCE_ELEMS`` a member), and ``ici_readings(reps)``."""
    import torch

    import k8s_operator_libs_tpu_torch.kernels as K

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out = {"peer_reduce": k4_timing(
        dev, gen, card_hbm_gbps(torch.cuda.get_device_name(0)))}
    out["ring_shift_round_ms"] = {}
    for elems in (1, ALLREDUCE_ELEMS):
        members = [torch.full((elems,), float(i), device=dev)
                   for i in range(ICI_MEMBERS)]
        out["ring_shift_round_ms"][elems] = events_ms(
            lambda: K.ring_shift(members), 200)
    out.update(ici_readings(reps))
    return out


# -- phase 18: the installed port -------------------------------------------
PORT_PACKAGE = "k8s_operator_libs_tpu_torch"
INSTALLED_CHILD_TIMEOUT_S = 600
INSTALLED_NODE = "gpu-node-installed"
# The agent's battery in the installed copy, one run as the agent
# container runs it: ``HealthAgent(...).run_once()`` publishing to a
# ``FakeCluster`` node, the deep probe on, over 8 members of the card, at
# production size; the kernel counts zeroed just before it and read just
# after.  ``build._nvcc()`` must raise: a rebuild could not run.  Prints
# one JSON line.
INSTALLED_BATTERY = """
import json, sys, time
t0 = time.perf_counter()
import torch
from k8s_operator_libs_tpu_torch import kernels as K
from k8s_operator_libs_tpu_torch.bench_fleet import GpuFleet
from k8s_operator_libs_tpu_torch.health import fused
from k8s_operator_libs_tpu_torch.health.agent import HealthAgent
from k8s_operator_libs_tpu_torch.k8s import FakeCluster
from k8s_operator_libs_tpu_torch.kernels import build
from k8s_operator_libs_tpu_torch.keys import driver_keys

try:
    nvcc = build._nvcc()
except RuntimeError as e:
    nvcc = "raises: " + str(e)
node, members = sys.argv[1], [torch.device("cuda", 0)] * int(sys.argv[2])
keys = driver_keys()
cluster = FakeCluster()
GpuFleet(cluster, keys).gpu_node(node)
agent = HealthAgent(cluster, node, keys, driver_revision="rev-installed",
                    devices=members, deep=True, matmul_n=int(sys.argv[3]),
                    hbm_mib=int(sys.argv[4]))
K.reset_launch_counts()
t1 = time.perf_counter()
agent.run_once()
torch.cuda.synchronize()
battery_s = time.perf_counter() - t1
counts = K.launch_counts()
counts["block_attention_merge_"] = K.block_attention_merge_.launches
print(json.dumps({
    "launches": counts,
    "battery_s": battery_s,
    "process_s": time.perf_counter() - t0,
    "library": build._LIB._name,
    "library_load_s": build.last_build_s,
    "nvcc": nvcc,
    "fallbacks": fused.battery_stats()["fallbacks"],
    "report": cluster.get_node(node).annotations[
        keys.health_report_annotation],
    "modules": {m: getattr(mod, "__file__", None)
                for m, mod in list(sys.modules.items())
                if m.split(".")[0] == "k8s_operator_libs_tpu_torch"},
}))
"""


def lay_out_install(site: Path) -> None:
    """Copy the port into ``site`` as its wheel installs it: the
    package's ``.py`` files and the package data ``pyproject.toml``
    names (the kernels' CUDA sources), and nothing else."""
    import tomllib

    pyproject = tomllib.loads((HERE / "pyproject.toml").read_text())
    package = HERE / PORT_PACKAGE
    files = [p for p in package.rglob("*.py") if "__pycache__" not in p.parts]
    for name, globs in pyproject["tool"]["setuptools"]["package-data"].items():
        where = HERE.joinpath(*name.split("."))
        files += [p for g in globs for p in where.glob(g)]
    for src in files:
        dst = site / src.relative_to(HERE)
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_bytes(src.read_bytes())


def set_read_only(top: Path, read_only: bool) -> None:
    for path in [top, *top.rglob("*")]:
        mode = path.stat().st_mode
        path.chmod(mode & ~0o222 if read_only else mode | 0o200)


def tree_digest(top: Path) -> str:
    import hashlib

    h = hashlib.sha256()
    for path in sorted(top.rglob("*")):
        h.update(str(path.relative_to(top)).encode() + b"\0")
        if path.is_file():
            h.update(path.read_bytes())
    return h.hexdigest()


def run_child(cmd: list[str], cwd: Path, env: dict, what: str
              ) -> tuple[str, float]:
    """Run a child to its end within ``INSTALLED_CHILD_TIMEOUT_S``;
    returns its standard output and seconds, or fails the run."""
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                              text=True, timeout=INSTALLED_CHILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        require(False, f"{what} outlived {INSTALLED_CHILD_TIMEOUT_S} s")
    seconds = time.perf_counter() - t0
    require(proc.returncode == 0,
            f"{what} exited {proc.returncode}:\n{proc.stdout[-4000:]}"
            f"\n{proc.stderr[-4000:]}")
    return proc.stdout, seconds


def installed_port(card: str, members: int = 8, matmul_n: int = 4096,
                   hbm_mib: int = 1024) -> dict:
    """Phase 18: the port run from an installed copy, not this checkout.

    The package is laid out as its wheel installs it in a read-only
    temporary directory.  A child (the working directory and
    ``PYTHONPATH`` that copy's only) runs the build entry into a fresh
    kernel directory; a second child, with no ``nvcc`` on ``PATH`` and
    ``CUDA_HOME`` naming an empty directory (unset, the lookup would take
    the toolkit's default location), runs one agent battery with the deep
    probe over ``members`` members of the card.  The report must pass
    every check, every module come from the copy, K1-K5 launch with no
    fused fallback, the library be the one the build entry made, and the
    copy stay byte for byte as it was."""
    import shutil
    import tempfile

    from k8s_operator_libs_tpu_torch.health.report import HealthReport
    from k8s_operator_libs_tpu_torch.kernels import build

    top = Path(tempfile.mkdtemp(prefix="installed-port-"))
    site, kdir, empty = top / "site", top / "kernels", top / "no-cuda"
    try:
        lay_out_install(site)
        empty.mkdir()
        set_read_only(site, True)
        before = tree_digest(site)
        base = {k: v for k, v in os.environ.items()
                if k not in ("PYTHONPATH", "CUDA_HOME", "CUDA_PATH")}
        base.update({"PYTHONPATH": str(site), build.KERNEL_DIR_ENV: str(kdir),
                     "PYTHONDONTWRITEBYTECODE": "1"})
        out, build_s = run_child([sys.executable, "-m", build.ENTRY], top,
                                 base, "the build entry")
        want = kdir / f"libport_kernels-{build._digest()}.so"
        require(out.split()[0] == str(want) and want.is_file(),
                f"the build entry made {out.strip()}, not {want}")
        print(f"[installed] the build entry compiled {want.name} into a "
              f"fresh kernel directory in {build_s:.2f} s (child, "
              f"interpreter start included): {out.strip()}", flush=True)

        env = dict(base)
        env["PATH"] = os.pathsep.join(
            d for d in env.get("PATH", "").split(os.pathsep)
            if d and not (Path(d) / "nvcc").exists())
        env["CUDA_HOME"] = str(empty)
        out, child_s = run_child(
            [sys.executable, "-c", INSTALLED_BATTERY, INSTALLED_NODE,
             str(members), str(matmul_n), str(hbm_mib)],
            top, env, "the installed battery")
        rec = json.loads(out.strip().splitlines()[-1])
        counts = rec["launches"]
        print(f"[launches] installed port, agent battery with the deep "
              f"probe over {members} members (child): "
              + ", ".join(f"{k} {n}" for k, n in counts.items()), flush=True)
        print(f"[installed] battery {rec['battery_s']:.3f} s, library loaded "
              f"in {rec['library_load_s']:.3f} s, child {child_s:.2f} s "
              f"(in-process {rec['process_s']:.2f} s) on {card}", flush=True)
        require(rec["nvcc"].startswith("raises: "),
                f"nvcc reachable in the installed child: {rec['nvcc']}")
        require(rec["library"] == str(want),
                f"the child loaded {rec['library']}, not {want}")
        strays = {m: f for m, f in rec["modules"].items()
                  if f is not None and site not in Path(f).parents}
        require(not strays and f"{PORT_PACKAGE}.kernels.build"
                in rec["modules"],
                f"modules not from the installed copy: {strays}")
        report = HealthReport.from_json(rec["report"])
        bad = [f"{c.name}: {c.detail}" for c in report.checks if not c.ok]
        require(report.healthy and not bad and report.node_name
                == INSTALLED_NODE, f"installed battery's report: {bad}")
        names = [c.name for c in report.checks]
        require("ici_ring_attention" in names,
                f"no deep probe in the installed report: {names}")
        for c in report.checks:
            if c.name in ("mxu_matmul", "hbm_bandwidth", "ici_allreduce",
                          "ici_ring"):
                require(c.metrics.get("fused") == 1.0,
                        f"installed battery's {c.name} is not fused")
        require(rec["fallbacks"] == 0,
                f"installed battery fell back {rec['fallbacks']} times")
        for kname in ("stream_increment_", "stream_increment_verify_",
                      "verify_stats", "block_attention", "peer_reduce",
                      "peer_gather"):
            require(counts.get(kname, 0) > 0,
                    f"{kname} was not launched by the installed battery")
        require(tree_digest(site) == before,
                "the installed copy changed under its battery")
        require(sorted(p.name for p in kdir.iterdir()) == [want.name],
                f"kernel directory holds {sorted(os.listdir(kdir))}")
        print(f"[installed] report {len(rec['report'])} bytes, checks "
              f"{names} all passed; {len(rec['modules'])} modules from the "
              f"read-only copy, unchanged", flush=True)
        return dict(build_s=build_s, battery_s=rec["battery_s"],
                    child_s=child_s, launches=counts)
    finally:
        if site.exists():
            set_read_only(site, False)
        shutil.rmtree(top, ignore_errors=True)


# -- phase 19: the node's entry points --------------------------------------
AGENT_MODULE = f"{PORT_PACKAGE}.health.agent"
SAFE_LOAD_MODULE = f"{PORT_PACKAGE}.driver.safe_load_init"
ENTRY_NODE = "gpu-node-entry"
ENTRY_REVISION = "rev-entry"
# From a child's start to its report: an interpreter with torch, CUDA's
# start, the library's load and one battery with the deep probe at
# production size (phase 18's child took 9.51 s for one over 8 members).
AGENT_DEADLINE_S = 300.0
# From the safe-load child's start to its annotation (no torch), and
# from the annotation's removal to the child's exit 0.
SAFE_LOAD_DEADLINE_S = 60.0
SAFE_LOAD_EXIT_S = 10.0
SAFE_LOAD_POLL_S = "0.05"
# Settings of the parent's environment that would change what a node's
# container does: an in-cluster config, a cross-host world, the agent's
# DaemonSet env.  Each child gets only what its phase gives it.  The
# card assignment (``CUDA_VISIBLE_DEVICES``) is inherited: the children
# use the cards this run was given and no other.
ENTRY_ENV_DROP = (
    "KUBERNETES_SERVICE_HOST", "KUBERNETES_SERVICE_PORT", "KUBECONFIG",
    "WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT", "HEALTH_DEEP_PROBE",
    "HEALTH_DCN_GROUP", "HEALTH_DCN_GROUPS", "HEALTH_DCN_PEERS",
    "HEALTH_PROBE_INTERVAL_S", "DRIVER_REVISION", "SAFE_LOAD_POLL_S",
)
# The agent's container runs ``python -m AGENT_MODULE``; here the same
# module runs as ``__main__`` under a SIGTERM handler that prints its
# process's kernel launches on one line and exits 0 (the agent runs until
# the kubelet stops it, so its counts are read at its termination).
ENTRY_LAUNCHES_TAG = "[entry-launches] "
ENTRY_COUNTING = f"""\
import json, os, runpy, signal, sys


def stop(signum, frame):
    from {PORT_PACKAGE} import kernels as K

    counts = K.launch_counts()
    counts["block_attention_merge_"] = K.block_attention_merge_.launches
    print({ENTRY_LAUNCHES_TAG!r} + json.dumps(counts), flush=True)
    sys.stderr.flush()
    os._exit(0)


signal.signal(signal.SIGTERM, stop)
runpy.run_module(sys.argv.pop(1), run_name="__main__", alter_sys=True)
"""


def write_kubeconfig(path: Path, host: str) -> Path:
    """A kubeconfig (JSON, which YAML reads) whose current context
    reaches ``host`` with no credentials."""
    path.write_text(json.dumps({
        "current-context": "local",
        "contexts": [{"name": "local",
                      "context": {"cluster": "local", "user": "local"}}],
        "clusters": [{"name": "local", "cluster": {"server": host}}],
        "users": [{"name": "local", "user": {}}],
    }))
    return path


class NodeEntryPoints:
    """The node's two containers as their DaemonSets start them, each
    ``python -m <module>`` in a process of its own from this checkout,
    against the port's ``KubeApiServer`` over a ``FakeCluster`` that
    holds one GFD-labelled H100 node.  The children find the server
    through ``KUBECONFIG`` alone: no in-cluster config, no token.  A
    context manager: on leaving it every child is killed and the server
    stopped."""

    def __init__(self, top: Path) -> None:
        from k8s_operator_libs_tpu_torch.bench_fleet import GpuFleet
        from k8s_operator_libs_tpu_torch.k8s import (
            FakeCluster,
            KubeApiServer,
        )
        from k8s_operator_libs_tpu_torch.keys import (
            DEFAULT_DRIVER_NAME,
            driver_keys,
        )

        self.top = top
        self.keys = driver_keys()
        self.store = FakeCluster()
        GpuFleet(self.store, self.keys).gpu_node(ENTRY_NODE)
        self.server = KubeApiServer(self.store)
        self.env = {k: v for k, v in os.environ.items()
                    if k not in ENTRY_ENV_DROP}
        self.env.update({"NODE_NAME": ENTRY_NODE,
                         "DRIVER_NAME": DEFAULT_DRIVER_NAME})
        self.children: list = []

    def __enter__(self) -> "NodeEntryPoints":
        self.server.start()
        self.env["KUBECONFIG"] = str(write_kubeconfig(
            self.top / "kubeconfig", self.server.host))
        return self

    def __exit__(self, *exc) -> None:
        for proc, _ in self.children:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        self.server.stop()

    def start(self, module: str, what: str, counted: bool = False,
              **env: str):
        """Start ``python -m module`` (with ``counted``, the module as
        ``__main__`` under ``ENTRY_COUNTING``) with the phase's env and
        ``env``; returns the process and its log (stdout and stderr)."""
        log = self.top / f"{what.replace(' ', '-')}.log"
        argv = (["-c", ENTRY_COUNTING, module] if counted
                else ["-m", module])
        with open(log, "w") as out:
            proc = subprocess.Popen(
                [sys.executable, *argv], cwd=HERE,
                env={**self.env, **env}, stdout=out,
                stderr=subprocess.STDOUT)
        self.children.append((proc, log))
        return proc, log

    @staticmethod
    def wait_for(cond, proc, log: Path, deadline_s: float, what: str,
                 t0: float) -> float:
        """Poll ``cond`` until it holds; fails the run if ``proc`` ends
        first or ``deadline_s`` passes.  Returns the seconds since
        ``t0``."""
        while not cond():
            if proc.poll() is not None:
                require(False, f"{what} exited {proc.returncode} first:\n"
                        f"{log.read_text()[-4000:]}")
            if time.perf_counter() - t0 > deadline_s:
                proc.kill()
                proc.wait()
                require(False, f"{what} outlived {deadline_s} s:\n"
                        f"{log.read_text()[-4000:]}")
            time.sleep(0.05)
        return time.perf_counter() - t0

    def annotations(self) -> dict:
        return self.store.get_node(ENTRY_NODE, cached=False).annotations

    def agent(self, what: str, **env: str) -> dict:
        """The agent container: started, waited on until its report
        lands under the driver's keys, then terminated (the agent runs
        until the kubelet stops it).  It must still be running when its
        report lands, and exit 0 at its termination with its process's
        kernel launches (``launches``)."""
        from k8s_operator_libs_tpu_torch.health.report import HealthReport

        key = self.keys.health_report_annotation
        self.store.patch_node_annotations(ENTRY_NODE, {key: None})
        t0 = time.perf_counter()
        proc, log = self.start(AGENT_MODULE, what, counted=True,
                               DRIVER_REVISION=ENTRY_REVISION, **env)
        report_s = self.wait_for(lambda: key in self.annotations(), proc,
                                 log, AGENT_DEADLINE_S, what, t0)
        raw = self.annotations()[key]
        require(proc.poll() is None, f"{what} exited {proc.returncode} "
                f"after its report:\n{log.read_text()[-4000:]}")
        proc.terminate()
        try:
            code = proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            require(False, f"{what} outlived its termination")
        text = log.read_text()
        tagged = [ln for ln in text.splitlines()
                  if ln.startswith(ENTRY_LAUNCHES_TAG)]
        require(code == 0 and len(tagged) == 1,
                f"{what} exited {code} at its termination, "
                f"{len(tagged)} launch lines:\n{text[-4000:]}")
        return dict(report=HealthReport.from_json(raw), raw=raw,
                    report_s=report_s, wall_s=time.perf_counter() - t0,
                    launches=json.loads(
                        tagged[0][len(ENTRY_LAUNCHES_TAG):]))

    def safe_load(self, what: str = "safe-load init") -> dict:
        """The safe-load init container: started, waited on until it
        announces itself, released by removing the annotation, and then
        it must exit 0 within ``SAFE_LOAD_EXIT_S``."""
        key = self.keys.safe_load_annotation
        t0 = time.perf_counter()
        proc, log = self.start(SAFE_LOAD_MODULE, what,
                               SAFE_LOAD_POLL_S=SAFE_LOAD_POLL_S)
        announced_s = self.wait_for(lambda: key in self.annotations(), proc,
                                    log, SAFE_LOAD_DEADLINE_S, what, t0)
        self.store.patch_node_annotations(ENTRY_NODE, {key: None})
        t1 = time.perf_counter()
        try:
            code = proc.wait(timeout=SAFE_LOAD_EXIT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            require(False, f"{what} did not exit within {SAFE_LOAD_EXIT_S} "
                    f"s of its release:\n{log.read_text()[-4000:]}")
        require(code == 0, f"{what} exited {code}:\n"
                f"{log.read_text()[-4000:]}")
        return dict(announced_s=announced_s,
                    exit_s=time.perf_counter() - t1,
                    wall_s=time.perf_counter() - t0)


def no_device_report(rec: dict) -> None:
    """The agent with no device must publish, not crash: an unhealthy
    report, 0 devices and the enumeration's failure as its detail, and
    no kernel launched."""
    report = rec["report"]
    require(not any(rec["launches"].values()),
            f"the no-device agent launched kernels: {rec['launches']}")
    checks = [(c.name, c.ok) for c in report.checks]
    require(not report.healthy and report.visible_devices == 0
            and checks == [("device_enumeration", False)]
            and "device enumeration failed" in report.checks[0].detail
            and report.driver_revision == ENTRY_REVISION,
            f"the no-device agent's report: {rec['raw']}")


def node_entry_points(card: str) -> dict:
    """Phase 19: the agent (healthy, every CUDA device this run was
    given, the deep probe on; then with no device visible) and the
    safe-load init container, each a process of its own from a
    kubeconfig.  The healthy report must name every check of the battery
    and the deep probe, each passed, and ``visible_devices`` the card
    count; the agent's process must have launched K1, its verifying pass
    and K2.  The link checks (``ici_allreduce``, ``ici_ring``) and the
    deep probe have work only over two devices or more: there they must
    have launched K4, K5 and K3; on one card the agent runs them on no
    peer, so they carry one device and are reported as not exercised.
    The kernel directory's listing must not change (the library is phase
    2's: no child compiles)."""
    import shutil
    import tempfile

    import torch

    from k8s_operator_libs_tpu_torch.kernels import build

    kdir = build.kernel_dir()
    listing = sorted(os.listdir(kdir))
    require(f"libport_kernels-{build._digest()}.so" in listing,
            f"phase 2's library is not in {kdir}: {listing}")
    top = Path(tempfile.mkdtemp(prefix="entry-points-"))
    try:
        with NodeEntryPoints(top) as node:
            healthy = node.agent("agent", HEALTH_DEEP_PROBE="1",
                                 HEALTH_PROBE_INTERVAL_S="3600")
            none = node.agent("agent with no device", HEALTH_DEEP_PROBE="1",
                              HEALTH_PROBE_INTERVAL_S="3600",
                              CUDA_VISIBLE_DEVICES="")
            safe = node.safe_load()
    finally:
        shutil.rmtree(top, ignore_errors=True)
    n_dev = torch.cuda.device_count()
    report = healthy["report"]
    names = [c.name for c in report.checks]
    bad = [f"{c.name}: {c.detail}" for c in report.checks if not c.ok]
    want = ["device_enumeration", "mxu_matmul", "hbm_bandwidth",
            "ici_allreduce", "ici_ring", "ici_ring_attention"]
    require(report.healthy and not bad and names == want
            and report.node_name == ENTRY_NODE
            and report.driver_revision == ENTRY_REVISION
            and report.visible_devices == n_dev,
            f"the agent's report: checks {names}, failed {bad}, "
            f"{report.visible_devices} devices")
    no_device_report(none)
    require(sorted(os.listdir(kdir)) == listing,
            f"a child changed the kernel directory: {sorted(os.listdir(kdir))}"
            f" against {listing}")
    links = report.checks[3:6]
    for c in links:
        require(c.metrics.get("devices") == float(n_dev),
                f"the agent's {c.name} ran over {c.metrics} devices, not "
                f"{n_dev}")
    # Each check that did work, and the kernels its work launches.
    ran = report.checks[1:3] + (links if n_dev >= 2 else [])
    must = ["stream_increment_", "stream_increment_verify_", "verify_stats"]
    if n_dev >= 2:
        must += ["peer_reduce", "peer_gather", "block_attention"]
    counts = healthy["launches"]
    print("[launches] phase 19 agent, every check from its report (its own "
          "process, read at its termination): "
          + ", ".join(f"{k} {n}" for k, n in counts.items()), flush=True)
    require(all(counts[k] > 0 for k in must),
            f"the agent's process launched {counts}; it must launch {must}")
    for c in ran[:4]:
        require(c.metrics.get("fused") == 1.0,
                f"the agent's {c.name} is not fused: {c.metrics}")
    idle = [c.name for c in links if n_dev < 2]
    body = report.checks[1].metrics
    deep_s = report.checks[5].latency_ms / 1e3
    checks_s = (body["battery_compile_ms"] + body["battery_execute_ms"]) / 1e3
    checks_s += deep_s
    print(f"[entry] agent (deep probe, {n_dev} CUDA device(s)): report after "
          f"{healthy['report_s']:.2f} s, child {healthy['wall_s']:.2f} s, "
          f"battery {checks_s:.3f} s from its report (fused warm-up "
          f"{body['battery_compile_ms'] / 1e3:.3f} s, body "
          f"{body['battery_execute_ms'] / 1e3:.3f} s, deep probe "
          f"{deep_s:.3f} s), checks with work {[c.name for c in ran]} "
          f"passed, launching {must}; not exercised (no peer on one card, "
          f"reported ok): {idle}; {report.visible_devices} devices, "
          f"revision {report.driver_revision}; no device: report after "
          f"{none['report_s']:.2f} s, unhealthy, 0 devices, no launch ("
          f"{none['report'].checks[0].detail}); safe-load init: announced "
          f"after {safe['announced_s']:.2f} s, exit 0 {safe['exit_s']:.3f} s"
          f" after its release, child {safe['wall_s']:.2f} s; kernel "
          f"directory unchanged; on {card}", flush=True)
    return dict(agent_s=healthy["wall_s"], battery_s=checks_s,
                no_device_s=none["wall_s"], safe_load_s=safe["wall_s"])


def nvidia_smi_name_power() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def main() -> int:
    import torch
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print(
            "chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
            file=sys.stderr,
        )
        return 1
    import k8s_operator_libs_tpu_torch as port
    import k8s_operator_libs_tpu_torch.kernels as K
    from k8s_operator_libs_tpu_torch.health import fused
    from k8s_operator_libs_tpu_torch.health.agent import HealthAgent
    from k8s_operator_libs_tpu_torch.artifacts import NetworkPathGateProber
    from k8s_operator_libs_tpu_torch.health.fused import (
        run_network_path_checks,
    )
    from k8s_operator_libs_tpu_torch.health.probes import (
        dcn_collective_probe,
        ici_allreduce_probe,
        ici_ring_attention_probe,
        ici_ring_probe,
        resolve_floors,
    )
    from k8s_operator_libs_tpu_torch.fleet.profiles import GPU_PRODUCT_LABELS
    from k8s_operator_libs_tpu_torch.health.slice_prober import (
        GPU_COUNT_LABELS,
    )
    from k8s_operator_libs_tpu_torch.health.report import HealthReport
    from k8s_operator_libs_tpu_torch.kernels import build
    from k8s_operator_libs_tpu_torch.kernels import collectives
    from k8s_operator_libs_tpu_torch.upgrade import UpgradeKeys
    from k8s_operator_libs_tpu_torch import bench as bench_mod
    from k8s_operator_libs_tpu_torch import entry as entry_mod
    from k8s_operator_libs_tpu_torch import hostenv
    from k8s_operator_libs_tpu_torch.workloads import canary as C
    from k8s_operator_libs_tpu_torch.workloads import ring_attention as R

    require(
        Path(port.__file__).resolve().parent.parent == HERE,
        f"the port was imported from {port.__file__}, not from this checkout",
    )

    # -- 1. device ---------------------------------------------------------
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = nvidia_smi_name_power()
    print(f"device: {name} x{count}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    print(card, flush=True)
    hbm_gbps = card_hbm_gbps(name)

    # -- 2. build ----------------------------------------------------------
    build.load_library()
    sources = ", ".join(str(s.relative_to(HERE)) for s in build.SOURCES)
    print(f"[build] kernels built and loaded in {build.last_build_s:.2f} s "
          f"({sources})", flush=True)

    # -- 3. kernels against their plain versions ---------------------------
    max_err = {"stream_increment_": 0.0, "stream_increment_verify_": 0.0,
               "verify_stats": 0.0,
               "block_attention": 0.0, "peer_reduce": 0.0,
               "peer_gather": 0.0}

    def same(kname: str, got: torch.Tensor, want: torch.Tensor, what: str):
        torch.cuda.synchronize()
        require(
            torch.equal(got.isnan(), want.isnan()),
            f"{kname} {what}: NaN pattern differs from the plain version",
        )
        diff = (got - want).abs().nan_to_num(0.0).max().item()
        max_err[kname] = max(max_err[kname], diff)
        require(diff == 0.0, f"{kname} {what}: max |kernel - plain| {diff}")

    n_x = PROD["hbm_mib"] * 1024 * 1024 // 4
    gen1 = torch.Generator(device=dev)
    gen1.manual_seed(1)
    for n, off in ((n_x, 0), (1_000_003, 0), (1_000_003, 1), (5, 3)):
        x = torch.zeros(n + off, device=dev)[off:]
        y = x.clone()
        for _ in range(3):
            K.stream_increment_(x)
            K.stream_increment_plain_(y)
        same("stream_increment_", x, y, f"n={n} offset={off}")
        require(x[0].item() == 3.0, "stream_increment_: 3 passes != 3.0")
        # The verifying pass, on the chain's values and on random ones,
        # then with a NaN at the first and at the last element.
        for values in ("chain", "random"):
            if values == "random":
                x.copy_(torch.randn(n, device=dev, generator=gen1))
                y.copy_(x)
            for center in (0.0, 0.5):
                what = f"n={n} offset={off} {values} center={center}"
                same("stream_increment_verify_",
                     K.stream_increment_verify_(x, center),
                     K.stream_increment_verify_plain_(y, center), what)
                same("stream_increment_", x, y, f"verifying pass, {what}")
        for where in (0, n - 1):
            x[where] = y[where] = float("nan")
            got = K.stream_increment_verify_(x, 0.0)
            same("stream_increment_verify_", got,
                 K.stream_increment_verify_plain_(y, 0.0),
                 f"n={n} offset={off} NaN at {where}")
            require(bool(got.isnan().all()),
                    f"stream_increment_verify_ n={n}: NaN at {where} gave "
                    f"{got.tolist()}")
            x[where] = y[where] = 0.0
        del x, y
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    # Both main-path shapes (x: fp32 1 GiB; C: bf16 4096^2), then odd,
    # unaligned and tiny inputs.
    odd = ((1_000_003, 0), (1_000_003, 1), (5, 3))
    for dtype, cases in (
        (torch.float32, ((n_x, 0), (4096 * 4096, 0)) + odd),
        (torch.bfloat16, ((4096 * 4096, 0),) + odd),
    ):
        for n, off in cases:
            x = torch.randn(n + off, device=dev, generator=gen).to(dtype)[off:]
            for center in (0.0, 0.5):
                same("verify_stats", K.verify_stats(x, center),
                     K.verify_stats_plain(x, center),
                     f"{dtype} n={n} offset={off} center={center}")
            del x
    c = torch.full((4096, 4096), 0.5, dtype=torch.bfloat16, device=dev)
    require(K.verify_stats(c, 0.5).tolist() == [0.5, 0.5, 0.0],
            "verify_stats on the exact 0.5 matrix")
    c[1234, 567] = 0.25
    got = K.verify_stats(c, 0.5)
    same("verify_stats", got, K.verify_stats_plain(c, 0.5), "0.25 seeded")
    require(got.tolist() == [0.25, 0.5, 0.25], f"0.25 seeded: {got.tolist()}")
    c[4095, 4095] = float("nan")
    got = K.verify_stats(c, 0.5)
    same("verify_stats", got, K.verify_stats_plain(c, 0.5), "NaN seeded")
    require(bool(got.isnan().all()), f"NaN seeded: {got.tolist()}")
    x = torch.full((n_x,), 8.0, device=dev)
    x[n_x - 1] = float("nan")
    require(bool(K.verify_stats(x, 0.0).isnan().all()),
            "NaN at the end of the 1 GiB stream did not propagate")
    del c, x
    print("[kernels] K1, its verifying pass and K2 match their plain "
          "versions exactly (1 GiB fp32, 4096^2 bf16, odd length, unaligned, "
          "0.25, NaN at the first and last element)", flush=True)

    def k3_inputs(b, sq, sk, h, d, seed):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        return (
            torch.randn((b, sq, h, d), device=dev, generator=g),
            torch.randn((b, sk, h, d), device=dev, generator=g),
            torch.randn((b, sk, h, d), device=dev, generator=g),
        )

    # (label, (B, Sq, Sk, H, D), q_offset, k_offset, causal).  Every shape
    # the ring paths of phase 7 give K3: the deep probe's shards are
    # member 3 of an 8-member ring (S_local 128) against blocks before, on
    # and after it, the soak's are S_local 512, the elastic ring's S_local
    # 64 at D 32; each path's full reference is one block over the whole
    # sequence (the elastic ring's at 8 and 6 members).
    k3_cases = [
        ("deep-probe shard, before the diagonal", (1, 128, 128, 4, 64),
         384, 0, True),
        ("deep-probe shard, on the diagonal", (1, 128, 128, 4, 64),
         384, 384, True),
        ("deep-probe shard, after the diagonal", (1, 128, 128, 4, 64),
         384, 640, True),
        ("deep-probe full reference, S 1024", (1, 1024, 1024, 4, 64),
         0, 0, True),
        ("soak shard, on the diagonal", (1, 512, 512, 16, 64),
         1536, 1536, True),
        ("soak full reference, S 4096", (1, 4096, 4096, 16, 64), 0, 0, True),
        ("elastic shard, before the diagonal", (1, 64, 64, 2, 32),
         192, 0, True),
        ("elastic shard, on the diagonal", (1, 64, 64, 2, 32),
         192, 192, True),
        ("elastic shard, after the diagonal", (1, 64, 64, 2, 32),
         192, 320, True),
        ("elastic full reference, 8 members", (1, 512, 512, 2, 32),
         0, 0, True),
        ("elastic full reference, 6 members", (1, 384, 384, 2, 32),
         0, 0, True),
        ("canary attention", (32, 512, 512, 16, 64), 0, 0, True),
        ("odd Sq = Sk = 100, D 16", (2, 100, 100, 3, 16), 0, 0, True),
        ("Sq 100, Sk 37, D 16, ragged diagonal", (2, 100, 37, 3, 16),
         50, 20, True),
        ("D 8", (1, 70, 90, 2, 8), 0, 0, True),
        ("D 128", (1, 96, 80, 2, 128), 16, 0, True),
        ("non-causal", (2, 128, 192, 4, 64), 0, 0, False),
        ("wholly masked", (1, 64, 64, 2, 64), 0, 1000, True),
    ]
    def k3_against_plain(label, got, plain):
        """K3's three limits on (num, m, l) against the plain version's."""
        num, m, l = got
        pnum, pm, pl = plain
        torch.cuda.synchronize()
        for t in got:
            require(bool(torch.isfinite(t).all()), f"K3 {label}: not finite")
        e_num = float((num - pnum).abs().max())
        e_m = float((m - pm).abs().max())
        e_l = float((l - pl).abs().max())
        e_l_rel = float(((l - pl).abs() / pl.abs().clamp_min(1.0)).max())
        max_err["block_attention"] = max(
            max_err["block_attention"], e_num, e_m, e_l
        )
        require(e_num <= K3_NUM_ATOL, f"K3 {label}: num off by {e_num}")
        require(e_m <= K3_M_ATOL, f"K3 {label}: m off by {e_m}")
        require(e_l_rel <= K3_L_RTOL, f"K3 {label}: l off by {e_l_rel}")
        return (f"max|num-plain| {e_num:.3e}, max|m-plain| {e_m:.3e}, "
                f"max|l-plain| {e_l:.3e} (relative {e_l_rel:.3e})")

    def k3_accumulators(b, sq, h, d, seed):
        """The ring's first-step accumulator (num 0, m NEG_INF, l 0) and a
        random running one (l > 0, m about a row max)."""
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        first = (torch.zeros((b, sq, h, d), device=dev),
                 torch.full((b, sq, h), R.NEG_INF, device=dev),
                 torch.zeros((b, sq, h), device=dev))
        running = (
            torch.randn((b, sq, h, d), device=dev, generator=g),
            torch.randn((b, sq, h), device=dev, generator=g) + 1.0,
            torch.rand((b, sq, h), device=dev, generator=g) * 20.0 + 0.5,
        )
        return (("first-step", first), ("running", running))

    for seed, (label, (b, sq, sk, h, d), qo, ko, causal) in enumerate(
        k3_cases
    ):
        q, k, v = k3_inputs(b, sq, sk, h, d, seed)
        block = K.block_attention(q, k, v, qo, ko, causal)
        errs = k3_against_plain(
            label, block, K.block_attention_plain(q, k, v, qo, ko, causal)
        )
        print(f"[K3] {label} {(b, sq, sk, h, d)} offsets {qo}/{ko} "
              f"causal={causal}: {errs}", flush=True)
        if label == "wholly masked":
            require(not any(t.any() for t in block),
                    "K3 wholly masked: want m 0, l 0, num 0 exactly")
        # The fused ring step: within the same limits of its plain
        # version, and its merge bit for bit _merge's on the card given
        # the kernel's own (num, m, l).
        for acc_label, acc in k3_accumulators(b, sq, h, d, 1000 + seed):
            what = f"{label}, fused step from a {acc_label} accumulator"
            got = K.block_attention_merge_(*(t.clone() for t in acc), q, k, v,
                                           qo, ko, causal)
            plain = K.block_attention_merge_plain(
                *(t.clone() for t in acc), q, k, v, qo, ko, causal
            )
            errs = k3_against_plain(what, got, plain)
            own = K.merge_plain(*acc, *block)
            torch.cuda.synchronize()
            for name_, g_, o_ in zip(("num", "m", "l"), got, own):
                require(torch.equal(g_, o_),
                        f"K3 {what}: the fused merge's {name_} is not "
                        f"_merge's bit for bit (max diff "
                        f"{float((g_ - o_).abs().max()):.3e})")
            print(f"[K3] {what}: {errs}; merge bit-equal to _merge",
                  flush=True)
            del got, plain, own
        del q, k, v, block
    print(f"[kernels] K3 and its fused ring step match their plain versions "
          f"within num {K3_NUM_ATOL}, m {K3_M_ATOL}, l {K3_L_RTOL} relative "
          f"({len(k3_cases)} cases, the fused step from a first-step and a "
          f"running accumulator; its merge bit-equal to _merge)", flush=True)

    # The ring on the card against a full reference that does not go
    # through K3 (the paths' own checks compare K3's ring with K3's full
    # pass): the plain version over the whole sequence, at the deep
    # probe's and the elastic ring's shapes.
    for s_local, h, d in ((128, 4, 64), (64, 2, 32)):
        fn, shard = R.make_ring_attention([dev] * 8)
        q, k, v = k3_inputs(1, 8 * s_local, 8 * s_local, h, d, 200)
        shards = (shard(q), shard(k), shard(v))
        before = (K.block_attention.launches,
                  K.block_attention_merge_.launches)
        out = torch.cat(fn(*shards), dim=1)
        # One launch a ring step: the fused step, n^2 of them.
        require((K.block_attention.launches - before[0],
                 K.block_attention_merge_.launches - before[1]) == (64, 64),
                f"ring of 8: {K.block_attention.launches - before[0]} K3 "
                f"launches, {K.block_attention_merge_.launches - before[1]} "
                f"fused, want 64 fused")
        pnum, _, pl = K.block_attention_plain(q, k, v, 0, 0, True)
        err = float((out - R._normalise(pnum, pl, q.dtype)).abs().max())
        print(f"[K3] ring of 8 on the card, S_local {s_local}, H {h}, D {d}, "
              f"against the plain full reference: max err {err:.3e}",
              flush=True)
        require(err < RING_ATOL, f"ring against the plain reference: {err}")
        del q, k, v, shards, out, pnum, pl

    # K4 bit for bit: the same fp32 adds in index order and IEEE division
    # as its plain version, so every bit agrees (NaN where either has one).
    def same_bits(got: torch.Tensor, want: torch.Tensor, what: str):
        torch.cuda.synchronize()
        nan = got.isnan()
        require(torch.equal(nan, want.isnan()),
                f"peer_reduce {what}: NaN pattern differs from plain")
        diff = (got - want).abs().nan_to_num(0.0).max().item()
        max_err["peer_reduce"] = max(max_err["peer_reduce"], diff)
        require(torch.equal(got[~nan].view(torch.int32),
                            want[~nan].view(torch.int32)),
                f"peer_reduce {what}: bits differ from plain (max {diff})")

    def k4_check(k: int, n: int, off: int, doff: int, what: str) -> int:
        """K4 bit for bit against its plain version, with a NaN at the
        last element of one source, with the divisors 1 and k.  The
        number of cases."""
        srcs = [torch.randn(n + off, device=dev, generator=gen)
                for _ in range(k)]
        srcs[k // 2][off + n - 1] = float("nan")
        dst = torch.empty(n + doff, device=dev)[doff:]
        cases = 0
        for divisor in (1.0, float(k)):
            want = torch.empty(n, device=dev)
            K.peer_reduce_plain(want, srcs, off, divisor)
            dst.fill_(0.0)
            K.peer_reduce(dst, srcs, off, divisor)
            same_bits(dst, want, f"{what} k={k} n={n} off={off}/{doff} "
                                 f"divisor={divisor}")
            require(bool(dst[n - 1].isnan()),
                    f"peer_reduce {what} k={k} n={n}: the NaN did not come "
                    f"out")
            cases += 1
        return cases

    k4_cases = 0
    for k in range(1, collectives.MAX_SOURCES + 1):
        # (length, source offset, dst offset): 2^20 and 2^22 (8 x 16 MiB
        # in, beyond the 50 MB L2), aligned; a ragged length aligned (a
        # scalar tail), with sources and dst unaligned alike (scalar head),
        # and apart (scalar throughout).
        for n, off, doff in ((1 << 20, 0, 0), (1 << 22, 0, 0),
                             (1_000_003, 0, 0), (1_000_003, 3, 3),
                             (1_000_003, 1, 0)):
            k4_cases += k4_check(k, n, off, doff, "")
    # The shapes the main path gives K4 (k4_shapes()), aligned as the
    # rounds give them.
    for label, k, n in k4_shapes():
        k4_cases += k4_check(k, n, 0, 0, label)
    for n in (2, 3, 4, 5, 8):
        # The main path's 4 MiB, a length ragged against every n, and the
        # network-path gate's 8 elements (chunks start on 16 bytes: two
        # of 4 elements, and empty ones for the other members).
        for elems in (ALLREDUCE_ELEMS, 1001, fused.NETWORK_ALLREDUCE_ELEMS):
            shards = [torch.randn(elems, device=dev, generator=gen)
                      for _ in range(n)]
            want = torch.empty(elems, device=dev)
            K.peer_reduce_plain(want, shards, 0, float(n))
            for j, out in enumerate(K.all_reduce(shards, float(n))):
                same_bits(out, want,
                          f"all_reduce of {n} x {elems}, member {j}")
            # The persistent round (the probe's), into new outputs and in
            # place, each run twice.
            copies = [t.clone() for t in shards]
            for target, label in ((None, "into new outputs"),
                                  (copies, "in place")):
                start = K.all_reduce_init(
                    copies if target else shards, float(n), out=target
                )
                for _ in range(2):
                    outs = start()
                    for j, out in enumerate(outs):
                        same_bits(out, want, f"all_reduce_init {label} of "
                                             f"{n} x {elems}, member {j}")
                    if target:  # the next round reduces the shards again
                        for t, src in zip(copies, shards):
                            t.copy_(src)
            # One library call (the plan's graph) and n K4 launches a
            # ring shift.
            rounds = {id(p_): p_.rounds for p_ in collectives._PLANS.values()}
            before = K.peer_reduce.launches
            ring = K.ring_shift(shards)
            calls = sum(p_.rounds - rounds.get(id(p_), 0)
                        for p_ in collectives._PLANS.values())
            require((calls, K.peer_reduce.launches - before) == (1, n),
                    f"ring_shift of {n} members: {calls} library calls, "
                    f"{K.peer_reduce.launches - before} K4 launches")
            for j, out in enumerate(ring):
                same_bits(out, shards[j - 1],
                          f"ring_shift of {n} x {elems}, member {j}")
            del shards, want, ring
    print(f"[kernels] K4 matches its plain version bit for bit "
          f"({k4_cases} cases: k 1 to 8; 2^20, 2^22, ragged, unaligned, "
          f"NaN, and every shape the main path gives it), and so do "
          f"all_reduce (one graph a round: "
          f"K4 and K5), its persistent round (into new outputs and in "
          f"place) and ring_shift (one graph a call: n K4 nodes) over 2, 3, "
          f"4, 5 and 8 members of the card (2^20, 1001 and "
          f"{fused.NETWORK_ALLREDUCE_ELEMS} elements)", flush=True)

    # K5 byte for byte: a copy, so every byte agrees with the plain
    # version.  Each case gathers k pieces into one destination and skips
    # one more range (the launching member's own), which must keep its
    # bytes.
    def same_bytes(got: torch.Tensor, want: torch.Tensor, what: str):
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs().nan_to_num(0.0).max().item()
        max_err["peer_gather"] = max(max_err["peer_gather"], diff)
        require(torch.equal(got.view(torch.uint8), want.view(torch.uint8)),
                f"peer_gather {what}: bytes differ from plain (max {diff})")

    k5_cases = 0
    for k in (2, 3, 4, 5, 8):
        # (elements a piece, piece offset into its buffer, gap between
        # ranges): the main path's 2^20 and 2^22 in all, aligned; ragged
        # pieces unaligned alike with dst, and apart.
        for total, skew, gap in ((1 << 20, 0, 0), (1 << 22, 0, 0),
                                 (1_000_003, 1, 1), (1_000_003, 3, 2)):
            n = total // (k + 1)
            pieces = [torch.randn(n + skew, device=dev, generator=gen)[skew:]
                      for _ in range(k)]
            # Range `skip` of the k + 1 is the launching member's own,
            # left out of the pieces: its bytes must stay.
            skip = k // 2
            offsets = [(i + (i >= skip)) * (n + gap) + gap
                       for i in range(k)]
            dst = torch.randn((k + 1) * (n + gap) + gap, device=dev,
                              generator=gen)
            want = dst.clone()
            K.peer_gather(dst, pieces, offsets)
            K.peer_gather_plain(want, pieces, offsets)
            same_bytes(dst, want, f"k={k} n={n} skew={skew} gap={gap}")
            k5_cases += 1
            del pieces, dst, want
    # Rows a pitch apart: the canary's gathers along the last dimension
    # (tp 4 and 2: 8192 rows of 256 or 512 fp32 a piece), then ragged
    # rows, unaligned, that take the byte path, and rows of 256 bytes that
    # share an offset 4 bytes past a 16-byte boundary with their
    # destination (a pitch of 16-byte multiples): whole vectors between a
    # byte head and tail on every row.  (k, rows, width, skew, gap,
    # first offset).
    for k, rows, width, skew, gap, lead in ((4, 16 * 512, 256, 0, 0, 0),
                                            (2, 16 * 512, 512, 0, 0, 0),
                                            (3, 1001, 67, 1, 1, 1),
                                            (5, 77, 1024, 3, 2, 2),
                                            (3, 129, 64, 1, 4, 1)):
        pitch = k * width + gap
        pieces = [torch.randn(rows * width + skew, device=dev,
                              generator=gen)[skew:] for _ in range(k)]
        offsets = [i * width + lead for i in range(k)]
        dst = torch.randn(rows * pitch, device=dev, generator=gen)
        want = dst.clone()
        K.peer_gather(dst, pieces, offsets, rows, pitch)
        K.peer_gather_plain(want, pieces, offsets, rows, pitch)
        same_bytes(dst, want, f"k={k} rows={rows} width={width} "
                              f"skew={skew} gap={gap}")
        k5_cases += 1
        del pieces, dst, want
    for n in (2, 3, 4, 8):
        for shape in ((ALLREDUCE_ELEMS,), (3, 5, 67)):
            shards = [torch.randn(shape, device=dev, generator=gen)
                      for _ in range(n)]
            for dim in range(len(shape)):
                want = torch.cat(shards, dim)
                for j, out in enumerate(K.all_gather(shards, dim)):
                    same_bytes(out, want, f"all_gather of {n} x {shape} "
                                          f"along {dim}, member {j}")
            del shards
    print(f"[kernels] K5 matches its plain version byte for byte ({k5_cases} "
          f"cases: k 2, 3, 4, 5, 8; 2^20, 2^22, ragged, unaligned, the own "
          f"range skipped; rows a pitch apart, whole, ragged and with byte "
          f"heads and tails), and all_gather matches "
          f"torch.cat over 2, 3, 4 and 8 members of the card", flush=True)

    # The collectives at the shapes the sharded canary (dp 2 x tp 4) and
    # the elastic runners' smaller bundles (dp 2 or 3 x tp 2) give them,
    # each against its plain version: the tp all-reduce of the
    # row-parallel outputs and the column inputs' gradients, the gathers
    # of the embedding and the logits along the last dimension, and the
    # dp all-reduce of one member's flat gradients (divisor dp).
    local_batch = BENCH_CANARY["batch"] // 2
    seq, width = BENCH_CANARY["seq_len"], BENCH_CANARY["d_model"]
    for dp, tp in ((2, 4), (2, 2), (3, 2)):
        shards = [torch.randn(local_batch, seq, width, device=dev,
                              generator=gen) for _ in range(tp)]
        want = torch.empty(shards[0].shape, device=dev)
        K.peer_reduce_plain(want, shards, 0, 1.0)
        for j, out in enumerate(K.all_reduce(shards)):
            same_bits(out, want, f"canary tp all-reduce of {tp} x "
                                 f"{tuple(want.shape)}, member {j}")
        pieces = [s[..., :width // tp].contiguous() for s in shards]
        want = torch.cat(pieces, -1)
        for j, out in enumerate(K.all_gather(pieces, -1)):
            same_bytes(out, want, f"canary gather of {tp} x "
                                  f"{tuple(pieces[0].shape)} along -1, "
                                  f"member {j}")
        del shards, pieces, want
        grads = [torch.randn(member_elems(tp), device=dev, generator=gen)
                 for _ in range(dp)]
        want = torch.empty(grads[0].shape, device=dev)
        K.peer_reduce_plain(want, grads, 0, float(dp))
        for j, out in enumerate(K.all_reduce(grads, float(dp))):
            same_bits(out, want, f"canary dp all-reduce of {dp} x "
                                 f"{grads[0].numel()} (tp {tp}), member {j}")
        del grads, want
    print(f"[kernels] all_reduce and all_gather match their plain versions "
          f"exactly at the sharded canaries' shapes (tp 4 and 2: [16, 512, "
          f"1024] over tp, [16, 512, 1024 / tp] gathered along -1, the dp "
          f"round of {member_elems(4)} elements over 2 and of "
          f"{member_elems(2)} over 2 and 3)", flush=True)

    flush_buf = torch.empty(FLUSH_BYTES // 4, device=dev)

    def time_ms(fn, iters: int, flush: bool = False) -> float:
        return events_ms(fn, iters, flush_buf if flush else None)

    def bound(nbytes: float, ops: float,
              peak_tflops: float = FP32_PEAK_TFLOPS) -> tuple[float, str]:
        return bound_ms(nbytes, ops, hbm_gbps, peak_tflops)

    def kernel_device_ms(fn, iters: int, *kernels: str,
                         flush: bool = False) -> float:
        return device_ms(fn, iters, kernels, flush_buf if flush else None)

    x = torch.zeros(n_x, device=dev)
    c = torch.full((4096, 4096), 0.5, dtype=torch.bfloat16, device=dev)
    timing = {}
    k1_bound, k1_by = bound(2 * 4 * n_x, n_x)
    # K1's kernel at a persistent grid, 8 blocks of 256 an SM (the kernel
    # strides over its tiles when given fewer blocks than tiles), launched
    # through the library directly: the design its grid of one tile a
    # block was measured against.
    lib = build.load_library()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    persistent_ms = time_ms(
        lambda: lib.battery_stream_increment(
            x.data_ptr(), n_x, 0, sms * 8,
            torch.cuda.current_stream(dev).cuda_stream),
        50,
    )
    timing["stream_increment_"] = dict(
        at=f"x fp32 [{n_x}] (1 GiB), in place",
        ms=time_ms(lambda: K.stream_increment_(x), 50),
        device_ms=kernel_device_ms(lambda: K.stream_increment_(x), 50,
                                   "stream_increment_kernel"),
        plain_ms=time_ms(lambda: K.stream_increment_plain_(x), 50),
        library_ms=time_ms(lambda: x.add_(1.0), 50),
        bound_ms=k1_bound, bound_by=k1_by,
        persistent_grid_ms=persistent_ms,
    )
    print(f"[timing] stream_increment_ at a persistent grid of {sms * 8} "
          f"blocks (8 an SM): {persistent_ms:.4f} ms by events on {card}",
          flush=True)
    # The verifying pass: K1's bytes, the 12 bytes of its result, and four
    # operations an element (the add and the three folds).  Its library
    # yardstick is two calls, x.add_(1.0) then torch.aminmax(x).
    kv_bound, kv_by = bound(2 * 4 * n_x + 12, 4 * n_x)
    timing["stream_increment_verify_"] = dict(
        at=f"x fp32 [{n_x}] (1 GiB), in place, center 0",
        ms=time_ms(lambda: K.stream_increment_verify_(x, 0.0), 50),
        # The pass and the two merges of its partials.
        device_ms=kernel_device_ms(
            lambda: K.stream_increment_verify_(x, 0.0), 50,
            "stream_increment_kernel", "merge_partials"),
        plain_ms=time_ms(lambda: K.stream_increment_verify_plain_(x, 0.0),
                         50),
        library_ms=time_ms(lambda: (x.add_(1.0), torch.aminmax(x)), 50),
        library="x.add_(1.0) then torch.aminmax(x), two calls",
        bound_ms=kv_bound, bound_by=kv_by,
    )
    shapes = []
    for label, t, flush in (
        (f"x fp32 [{n_x}] (1 GiB)", x, False),
        ("C bf16 [4096, 4096], cold L2", c, True),
    ):
        b_ms, b_by = bound(t.numel() * t.element_size() + 12, 4 * t.numel())
        shapes.append(dict(
            at=label,
            ms=time_ms(lambda: K.verify_stats(t, 0.5), 30, flush),
            # Both of K2's kernels (partials, merge), without the flushes.
            device_ms=kernel_device_ms(lambda: K.verify_stats(t, 0.5), 30,
                                       "verify_partials", "merge_partials"),
            plain_ms=time_ms(lambda: K.verify_stats_plain(t, 0.5), 30, flush),
            library_ms=time_ms(lambda: torch.aminmax(t), 30, flush),
            bound_ms=b_ms, bound_by=b_by,
        ))
    timing["verify_stats"] = dict(shapes[0], shapes=shapes)
    del x, c, flush_buf

    # K3 at the deep probe's shard and the soak's (the main path's
    # shapes) and at the canary's attention shape, each on the diagonal.
    # Bytes: fp32 q, k, v read once, num, m, l written once.  Operations:
    # 2 for each product of q.k and of p.v over the visible (i, j) pairs,
    # at the bf16 tensor-core rate.  The library call is SDPA on bf16
    # [B, H, S, D], the port never calls it.  The fused ring step
    # (block_attention_merge_) at the same shapes, from the ring's
    # first-step accumulator: bytes as K3's, plus acc_num, acc_m and
    # acc_l read; no one PyTorch call computes it.
    shapes, merge_shapes = [], []
    for label, (b, s_, h, d), iters in (
        ("deep-probe shard (1, 128, 4, 64), causal", (1, 128, 4, 64), 200),
        ("soak shard (1, 512, 16, 64), causal", (1, 512, 16, 64), 100),
        ("canary attention (32, 512, 16, 64), causal", (32, 512, 16, 64),
         20),
    ):
        q, k, v = k3_inputs(b, s_, s_, h, d, 100)
        qh, kh, vh = (t.transpose(1, 2).to(torch.bfloat16).contiguous()
                      for t in (q, k, v))
        pairs = s_ * (s_ + 1) // 2
        b_ms, b_by = bound(
            4 * (2 * b * s_ * h * d + 2 * b * s_ * h * d + 2 * b * s_ * h),
            4 * b * h * d * pairs, BF16_PEAK_TFLOPS,
        )
        shapes.append(dict(
            at=label,
            ms=time_ms(lambda: K.block_attention(q, k, v, 0, 0, True), iters),
            device_ms=kernel_device_ms(
                lambda: K.block_attention(q, k, v, 0, 0, True), iters,
                "block_attention_kernel",
            ),
            plain_ms=time_ms(
                lambda: K.block_attention_plain(q, k, v, 0, 0, True), iters
            ),
            library_ms=time_ms(
                lambda: F.scaled_dot_product_attention(
                    qh, kh, vh, is_causal=True
                ),
                iters,
            ),
            bound_ms=b_ms, bound_by=b_by,
        ))
        acc = (torch.zeros_like(q),
               torch.full((b, s_, h), R.NEG_INF, device=dev),
               torch.zeros((b, s_, h), device=dev))
        mb_ms, mb_by = bound(
            4 * (5 * b * s_ * h * d + 4 * b * s_ * h),
            4 * b * h * d * pairs, BF16_PEAK_TFLOPS,
        )
        merge_shapes.append(dict(
            at=f"{label}, fused ring step",
            entry="block_attention_merge_",
            ms=time_ms(
                lambda: K.block_attention_merge_(*acc, q, k, v, 0, 0, True),
                iters,
            ),
            device_ms=kernel_device_ms(
                lambda: K.block_attention_merge_(*acc, q, k, v, 0, 0, True),
                iters, "block_attention_kernel",
            ),
            plain_ms=time_ms(
                lambda: K.block_attention_merge_plain(*acc, q, k, v, 0, 0,
                                                      True),
                iters,
            ),
            library_ms=None,
            bound_ms=mb_ms, bound_by=mb_by,
        ))
        del q, k, v, qh, kh, vh, acc
    timing["block_attention"] = dict(shapes[0],
                                     shapes=shapes + merge_shapes)

    # K4 at every shape of the main path (the probe's reduce-scatter
    # node, the ring shift's, the canary's tp and dp nodes) and two large
    # rows.
    shapes = k4_timing(dev, gen, hbm_gbps)
    timing["peer_reduce"] = dict(shapes[0], shapes=shapes)

    # K5 at the main path's shapes: the all-reduce's all-gather launch (7
    # chunks of 2^17 from the other members) and the sharded canaries'
    # gathers (4 pieces of [16, 512, 256] fp32, the embedding's width and
    # the logits' vocab at tp 4, and 2 of [16, 512, 512] at the elastic
    # bundles' tp 2).  Bytes: each piece read once, written once.  The
    # library call is torch.cat of the pieces, timed only.
    shapes = []
    chunk = ALLREDUCE_ELEMS // ICI_MEMBERS
    for label, k, rows, n, iters in (
        (f"all-reduce all-gather launch, k 7 x {chunk}", 7, 1, chunk, 200),
        ("canary gather along -1, k 4 x [16, 512, 256]", 4, 16 * 512, 256,
         50),
        ("elastic gather along -1 (tp 2), k 2 x [16, 512, 512]", 2,
         16 * 512, 512, 50),
    ):
        pieces = [torch.randn(rows, n, device=dev, generator=gen)
                  for _ in range(k)]
        dst = torch.empty(rows, k * n, device=dev)
        offsets = [i * n for i in range(k)]
        args = (dst, pieces, offsets, rows, k * n)
        b_ms, b_by = bound(2 * 4 * k * rows * n, 0)
        shapes.append(dict(
            at=label,
            ms=time_ms(lambda: K.peer_gather(*args), iters),
            device_ms=kernel_device_ms(
                lambda: K.peer_gather(*args), iters, "peer_gather_kernel",
            ),
            plain_ms=time_ms(lambda: K.peer_gather_plain(*args), iters),
            library_ms=time_ms(lambda: torch.cat(pieces, -1), iters),
            bound_ms=b_ms, bound_by=b_by,
        ))
        if rows > 1:
            whole_ms = time_ms(lambda: K.all_gather(pieces, -1), iters)
            print(f"[timing] all_gather over {k} members of the card, "
                  f"[16, 512, {n}] along -1, the whole function (one round "
                  f"of {k} K5 launches, each writing the gathered layout): "
                  f"{whole_ms:.4f} ms by events, bound {k * b_ms:.4f} ms "
                  f"(bytes), {k} x torch.cat "
                  f"{k * shapes[-1]['library_ms']:.4f} ms on {card}",
                  flush=True)
        del pieces, dst, args
    timing["peer_gather"] = dict(shapes[0], shapes=shapes)

    for kname, t in timing.items():
        for s in t.get("shapes", [t]):
            device = (f" (device {s['device_ms']:.4f} ms by the profiler)"
                      if "device_ms" in s else "")
            library = ("none" if s["library_ms"] is None
                       else f"{s['library_ms']:.4f} ms")
            if "library" in s:
                library += f" ({s['library']})"
            print(f"[timing] {s.get('entry', kname)} {s['at']}: kernel "
                  f"{s['ms']:.4f} ms{device}, "
                  f"bound {s['bound_ms']:.4f} ms ({s['bound_by']}), "
                  f"plain {s['plain_ms']:.4f} ms, library {library} on "
                  f"{card}", flush=True)

    # The fused battery at a small size: the card against the CPU.
    on_gpu = port.run_host_probe([dev], fused=True, **SMALL)
    on_cpu = port.run_host_probe([torch.device("cpu")], fused=True, **SMALL)
    require(
        [(r.name, r.ok, r.detail) for r in on_gpu[1:]]
        == [(r.name, r.ok, r.detail) for r in on_cpu[1:]],
        "small fused battery: the card disagrees with the CPU reference",
    )
    print("[reference] small fused battery on the card matches the CPU",
          flush=True)

    # -- 4-6. the main path, with launch counts per path -------------------
    fused.reset_battery_cache()
    launches = {k: 0 for k in K.launch_counts()}
    # The fused ring step's own share of K3's launches.
    launches["block_attention_merge_"] = 0

    battery_kernels = ("stream_increment_", "verify_stats")
    # The fused battery checks its stream in K1's last pass.
    fused_kernels = battery_kernels + ("stream_increment_verify_",)
    ring_kernels = ("block_attention",)

    def k4_nodes(key) -> list[tuple[int, int]]:
        """(k, len) of each K4 node of the plan under ``key``."""
        kind, devices, a, _ = key
        n = len(devices)
        if kind == collectives.ALL_REDUCE:
            return [(n, hi - lo) for lo, hi in collectives._chunks(a, n)
                    if hi > lo]
        return [(1, a)] * n if kind == collectives.RING_SHIFT else []

    # K4's launches on the main path by (k, len): the plans' rounds times
    # their nodes; "standalone" for launches outside a plan.
    k4_by_shape: dict = {}

    def on_path(label: str, fn, must: tuple[str, ...]):
        """Run one path of the main path with the counts zeroed just
        before it and read just after it; each kernel the path names in
        ``must`` has to have launched.  K4's launches are also split by
        shape."""
        K.reset_launch_counts()
        rounds = {key: p_.rounds for key, p_ in collectives._PLANS.items()}
        out = fn()
        counts = K.launch_counts()
        fused_steps = K.block_attention_merge_.launches
        by_shape: dict = {}
        for key, p_ in list(collectives._PLANS.items()):
            ran = p_.rounds - rounds.get(key, 0)
            for shape in k4_nodes(key) if ran else ():
                by_shape[shape] = by_shape.get(shape, 0) + ran
        standalone = counts["peer_reduce"] - sum(by_shape.values())
        if standalone:
            by_shape["standalone"] = standalone
        print(f"[launches] {label}: "
              + ", ".join(f"{k} {n}" for k, n in counts.items())
              + f" (of K3's, fused ring steps {fused_steps}; K4 by (k, "
              f"len): {by_shape})", flush=True)
        for kname in must:
            require(counts[kname] > 0,
                    f"{kname} was not launched on the {label} path")
        for kname, n in counts.items():
            launches[kname] += n
        launches["block_attention_merge_"] += fused_steps
        for shape, n in by_shape.items():
            k4_by_shape[shape] = k4_by_shape.get(shape, 0) + n
        return out

    def launches_a_body(label: str, bodies: int) -> None:
        """K1 and K2 launches a fused battery body on the path just run
        (its counts stand until the next path's reset): K2 once, on C;
        K1 HBM_CHAIN_ITERS times, the last its verifying pass."""
        c = K.launch_counts()
        print(f"[fused] {label}: K2 launches a body "
              f"{c['verify_stats'] / bodies:g} (the check of C), K1 "
              f"{c['stream_increment_'] / bodies:g}, of them the verifying "
              f"pass {c['stream_increment_verify_'] / bodies:g} (the check "
              f"of the stream); {bodies} bodies", flush=True)
        require(c["verify_stats"] == bodies
                and c["stream_increment_verify_"] == bodies
                and c["stream_increment_"] == fused.HBM_CHAIN_ITERS * bodies,
                f"{label}: launches {c} over {bodies} bodies")

    def all_ok(checks, what: str) -> None:
        for r in checks:
            print(f"  {r.name}: ok={r.ok} {r.detail} "
                  f"{json.dumps({k: round(v, 4) for k, v in r.metrics.items()})}")
        bad = [f"{r.name}: {r.detail}" for r in checks if not r.ok]
        require(not bad, f"{what}: {bad}")

    t0 = time.perf_counter()
    unfused = on_path("unfused",
                      lambda: port.run_host_probe(fused=False, **PROD),
                      battery_kernels)
    print(f"[unfused] production battery in "
          f"{time.perf_counter() - t0:.2f} s on {card}:")
    all_ok(unfused, "unfused battery")
    for r in unfused:
        if r.metrics.get("timing_inconclusive"):
            print(f"  {r.name}: timing inconclusive (not a failure)")
        for k in ("tflops", "mfu", "gbps"):
            if k in r.metrics:
                print(f"  {r.name} {k} = {r.metrics[k]} on {card}")

    runs = []
    for attempt in ("cold", "warm"):
        checks = on_path(f"fused {attempt}",
                         lambda: port.run_host_probe(fused=True, **PROD),
                         fused_kernels)
        # A miss runs the body twice: the warm-up, then the run.
        launches_a_body(f"fused {attempt}", 2 if attempt == "cold" else 1)
        print(f"[fused] {attempt} production battery on {card}:")
        all_ok(checks, f"fused battery ({attempt})")
        runs.append(checks[1:])
    for checks, hit in zip(runs, (0.0, 1.0)):
        for r in checks:
            require(r.metrics.get("fused") == 1.0, f"{r.name} is not fused")
            require(r.metrics["battery_cache_hit"] == hit,
                    f"{r.name}: battery_cache_hit != {hit}")
    stats = fused.battery_stats()
    require(stats["fallbacks"] == 0, f"fused fallbacks: {stats}")
    for attempt, checks in zip(("cold", "warm"), runs):
        m = checks[0].metrics
        print(f"[fused] {attempt}: battery_compile_ms "
              f"{m['battery_compile_ms']:.3f}, battery_execute_ms "
              f"{m['battery_execute_ms']:.3f} on {card}")

    class RecordingClient:
        def __init__(self):
            self.patches = []

        def patch_node_annotations(self, node, patch):
            self.patches.append((node, dict(patch)))

    class Node:
        def __init__(self, name, annotations):
            self.name, self.annotations = name, annotations

    class Member:
        def __init__(self, node):
            self.node, self.driver_daemon_set = node, "driver-ds"

    class Group:
        def __init__(self, nodes):
            self.id, self.nodes, self.slice_info = nodes[0].name, nodes, None
            self.members = [Member(n) for n in nodes]

        def size(self):
            return len(self.nodes)

    keys = UpgradeKeys(driver_name="nvidia", domain="nvidia.com")
    client = RecordingClient()
    agent = HealthAgent(client, "gpu-node-0", keys,
                        driver_revision="rev-smoke", **PROD)
    report = on_path("agent", agent.run_once, fused_kernels)
    require(report.healthy, f"agent report unhealthy: {report.to_json()}")
    require(len(client.patches) == 1, f"patches: {client.patches}")
    node_name, patch = client.patches[0]
    raw = patch[keys.health_report_annotation]
    parsed = HealthReport.from_json(raw)
    require(parsed.healthy and parsed.visible_devices == count,
            f"published report: {raw}")
    for r in parsed.checks[1:]:
        require(r.metrics.get("fused") == 1.0,
                f"agent's published {r.name} is not fused: {raw}")
    group = Group([Node(node_name, {keys.health_report_annotation: raw})])
    verdict = port.NodeReportProber(
        keys, revision_resolver=lambda ds: "rev-smoke"
    ).probe(group)
    require(verdict.healthy, f"NodeReportProber: {verdict.detail}")
    local = on_path("local prober",
                    lambda: port.LocalDeviceProber(**PROD).probe(group),
                    fused_kernels)
    require(local.healthy, f"LocalDeviceProber: {local.detail}")
    stats = fused.battery_stats()
    require(stats["fallbacks"] == 0,
            f"fused fallbacks after the agent and local prober: {stats}")
    print(f"[agent] published {len(raw)} bytes; NodeReportProber: "
          f"{verdict.detail}; LocalDeviceProber: {local.detail}")
    # -- 7. the host's collectives over 8 members of the card ---------------
    members = [dev] * ICI_MEMBERS
    # The all-reduce round launches K4 (reduce-scatter) and K5
    # (all-gather); the ring shift K4 alone.
    collective_kernels = ("peer_reduce", "peer_gather")
    shift_kernels = ("peer_reduce",)
    t0 = time.perf_counter()
    ar = on_path("ICI all-reduce probe, 8 members",
                 lambda: ici_allreduce_probe(members), collective_kernels)
    print(f"[collectives] ici_allreduce in {time.perf_counter() - t0:.2f} s: "
          f"ok={ar.ok} {ar.detail} {json.dumps(ar.metrics)} (one card: the "
          f"bus bandwidth reads HBM and L2, not a link) on {card}",
          flush=True)
    require(ar.ok and ar.detail.startswith("psum over 8 devices exact; "),
            f"ici_allreduce: {ar.detail}")
    rp = on_path("ICI ring probe, 8 members",
                 lambda: ici_ring_probe(members), shift_kernels)
    print(f"[collectives] ici_ring: ok={rp.ok} {rp.detail} latency "
          f"{rp.latency_ms:.3f} ms on {card}", flush=True)
    require(rp.ok and rp.detail == ("all 8 locally-received ring link(s) "
                                    "verified (8-device ring)"),
            f"ici_ring: {rp.detail}")
    # The probe shifts twice (a warm-up, then the timed call): n K4 nodes
    # a call.
    require(K.launch_counts()["peer_reduce"] == 2 * ICI_MEMBERS,
            f"ici_ring: {K.launch_counts()['peer_reduce']} K4 launches, "
            f"want {2 * ICI_MEMBERS}")
    readings = ici_readings(ICI_READINGS)
    print(f"[collectives] {ICI_READINGS} more of each probe, median "
          f"(sorted): ici_allreduce "
          f"{readings['busbw_gbps'][ICI_READINGS // 2]:.2f} GB/s "
          f"({', '.join(f'{x:.2f}' for x in readings['busbw_gbps'])}); "
          f"ici_ring {readings['ici_ring_ms'][ICI_READINGS // 2]:.4f} ms "
          f"({', '.join(f'{x:.4f}' for x in readings['ici_ring_ms'])}) "
          f"on {card}", flush=True)

    fallbacks = fused.battery_stats()["fallbacks"]
    for attempt, hit in (("cold", 0.0), ("warm", 1.0)):
        checks = on_path(
            f"fused {attempt}, 8 members",
            lambda: port.run_host_probe(members, fused=True, **PROD),
            fused_kernels + collective_kernels,
        )
        launches_a_body(f"fused {attempt}, 8 members",
                        ICI_MEMBERS * (2 if attempt == "cold" else 1))
        m = checks[1].metrics
        print(f"[collectives] fused {attempt} battery over 8 members, "
              f"battery_execute_ms {m['battery_execute_ms']:.3f}, "
              f"battery_compile_ms {m['battery_compile_ms']:.3f}, "
              f"on {card}:")
        all_ok(checks, f"fused battery over 8 members ({attempt})")
        require([r.name for r in checks[3:]] == ["ici_allreduce", "ici_ring"],
                f"fused over 8 members: {[r.name for r in checks]}")
        require(checks[3].detail == "psum over 8 devices exact (4 rounds); "
                "fused battery (bus bandwidth unmeasured)", checks[3].detail)
        for r in checks[1:]:
            require(r.metrics.get("fused") == 1.0, f"{r.name} is not fused")
            require(r.metrics["battery_cache_hit"] == hit,
                    f"{r.name}: battery_cache_hit != {hit}")
    checks = on_path(
        "unfused, 8 members",
        lambda: port.run_host_probe(members, fused=False, **PROD),
        battery_kernels + collective_kernels,
    )
    print(f"[collectives] unfused battery over 8 members on {card}:")
    all_ok(checks, "unfused battery over 8 members")
    local8 = on_path(
        "local prober, 8 members",
        lambda: port.LocalDeviceProber(members, **PROD).probe(group),
        fused_kernels + collective_kernels,
    )
    require(local8.healthy, f"LocalDeviceProber over 8 members: "
                            f"{local8.detail}")
    require(fused.battery_stats()["fallbacks"] == fallbacks,
            f"fused fallbacks over 8 members: {fused.battery_stats()}")
    print(f"[collectives] LocalDeviceProber over 8 members: {local8.detail}",
          flush=True)

    # One injected fault: member 0 keeps its own value instead of
    # receiving member 7's.
    real_ring_shift = collectives.ring_shift

    def member_0_keeps_its_value(shards):
        outs = real_ring_shift(shards)
        outs[0] = shards[0].clone()
        return outs

    collectives.ring_shift = member_0_keeps_its_value
    try:
        bad = on_path("ICI ring probe, member 0 keeps its value",
                      lambda: ici_ring_probe(members), shift_kernels)
    finally:
        collectives.ring_shift = real_ring_shift
    print(f"[collectives] injected ring fault: ok={bad.ok} {bad.detail}",
          flush=True)
    require(not bad.ok and bad.detail == "link 7->0 delivered 0.0, "
            "expected 7.0" and bad.metrics["bad_links"] == 1.0,
            f"injected ring fault: {bad}")

    # One all-reduce round of the main path's shape on 8 members of the
    # card.  The round is one graph launch (its K4 and K5 kernels, the
    # phases ordered by graph edges) and the events that order it against
    # the members' streams.  The host's time to enqueue it is taken with
    # the 8 members on the card's current stream (what the probes on one
    # card pay: no event), and with them on 8 distinct streams, member 0
    # on the current one (the board-shaped figure: an 8-card board's
    # round waits on 7 other streams before and makes 7 wait after); each
    # for the probe's round (a persistent all-reduce into outputs made
    # once) and for a functional round (``all_reduce``: fresh outputs
    # each round).  Each figure is the mean over 20 back-to-back rounds
    # started on an idle card, the best and the median of 15 such runs
    # (the host's clock varies with its neighbours; the best is the cost
    # itself); the round's time with the device's work is by CUDA events
    # over 200 rounds.
    shards = [torch.full((ALLREDUCE_ELEMS,), float(i + 1), device=dev)
              for i in range(ICI_MEMBERS)]
    side = [torch.cuda.Stream(dev) for _ in range(ICI_MEMBERS - 1)]
    board = ([torch.cuda.current_stream(dev).cuda_stream]
             + [st.cuda_stream for st in side])

    def enqueue_us(fn, rounds: int = 20, reps: int = 15) -> tuple:
        for _ in range(rounds):
            fn()
        runs = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(rounds):
                fn()
            runs.append((time.perf_counter() - t0) / rounds * 1e6)
        torch.cuda.synchronize()
        runs.sort()
        return runs[0], runs[len(runs) // 2]

    before = K.launch_counts()
    K.all_reduce(shards)
    after = K.launch_counts()
    per_round = {k: after[k] - before[k] for k in ("peer_reduce",
                                                    "peer_gather")}
    rounds = {
        ("probe's round", "one stream"): K.all_reduce_init(shards),
        ("probe's round", "8 streams"):
            collectives._all_reduce_init(shards, 1.0, None, board),
        ("functional round", "one stream"): lambda: K.all_reduce(shards),
        ("functional round", "8 streams"):
            lambda: collectives._all_reduce(shards, 1.0, board),
    }
    enqueue = {key: enqueue_us(fn) for key, fn in rounds.items()}
    by_events = {key: time_ms(fn, 200) for key, fn in rounds.items()}
    for key, fn in rounds.items():
        for out in fn():
            require(bool((out == 36.0).all()),
                    f"the {key[0]} on {key[1]} of the card is wrong")
    # The library call alone, the round's pointers packed beforehand (the
    # events and the graph launch): with one set of output buffers, with
    # two in turn (a plan keeps two graphs, so neither is repointed), and
    # with three in turn (one graph repointed every round).  The rest of
    # a round's host time is the Python around the call.
    plan = collectives._plan(collectives.ALL_REDUCE,
                             (dev.index,) * ICI_MEMBERS, ALLREDUCE_ELEMS,
                             4 * ALLREDUCE_ELEMS)
    fixed = [[torch.empty_like(t) for t in shards] for _ in range(3)]
    packed = [
        plan.pack(*[t.data_ptr() for t in shards],
                  *[t.data_ptr() for t in outs], *streams)
        for streams in ([board[0]] * ICI_MEMBERS, board)
        for outs in fixed
    ]
    turn = [0]

    def library_call(first: int, sets: int):
        turn[0] = (turn[0] + 1) % sets
        plan.launch_fn(plan.handle, packed[first + turn[0]], 1.0)

    lib_us = {}
    for label, first in (("one stream", 0), ("8 streams", 3)):
        for sets in (1, 2, 3):
            lib_us[label, sets] = enqueue_us(
                lambda: library_call(first, sets)
            )[0]
    for outs in fixed:
        for out in outs:
            require(bool((out == 36.0).all()),
                    "the library's round on the card is wrong")
    del fixed, rounds
    # The ring shift over the 8 members, one graph launch a call: at the
    # main path's one element a member and at the round's 2^20.
    ones = [torch.full((1,), float(i), device=dev)
            for i in range(ICI_MEMBERS)]
    ring_rounds = {}
    for elems, members_ in ((1, ones), (ALLREDUCE_ELEMS, shards)):
        ring_rounds[elems] = (
            time_ms(lambda: K.ring_shift(members_), 200),
            enqueue_us(lambda: K.ring_shift(members_)),
        )
        for j, out in enumerate(K.ring_shift(members_)):
            require(torch.equal(out, members_[j - 1]),
                    f"ring shift of {elems} a member: member {j} is wrong")
    ring_round_ms = ring_rounds[ALLREDUCE_ELEMS][0]
    print(f"[collectives] ring shift round over {ICI_MEMBERS} members of "
          f"the card (one graph of {ICI_MEMBERS} K4 nodes): " + "; ".join(
              f"{elems} a member {ms:.4f} ms by events, host enqueue "
              f"{us[0] / 1e3:.4f} ms (median {us[1] / 1e3:.4f} ms)"
              for elems, (ms, us) in ring_rounds.items())
          + f" on {card}", flush=True)
    del ones
    moved = 2 * (ICI_MEMBERS - 1) / ICI_MEMBERS * 4 * ALLREDUCE_ELEMS
    link_ms = moved / (NVLINK_GBPS * 1e9) * 1e3
    floor = resolve_floors(name)
    floor_gbps = floor.ici_busbw_gbps if floor else None

    def ceiling(us: float) -> str:
        gbps = moved / (max(us * 1e-3, link_ms) * 1e-3) / 1e9
        verdict = ("clears" if floor and gbps >= floor_gbps else "misses")
        return f"{gbps:.2f} GB/s ({verdict} the floor)"

    print(f"[collectives] all-reduce round, {ICI_MEMBERS} members x "
          f"{ALLREDUCE_ELEMS} fp32 on one card: one graph launch of "
          f"{per_round['peer_reduce']} K4 and {per_round['peer_gather']} K5 "
          f"kernels; the board-shaped round (8 distinct streams of the "
          f"card) adds {ICI_MEMBERS} event records and "
          f"{2 * (ICI_MEMBERS - 1)} cross-stream waits; ring shift round "
          f"{ring_round_ms:.4f} ms; on {card}", flush=True)
    for kind in ("probe's round", "functional round"):
        print(f"[collectives] {kind}: host enqueue " + "; ".join(
            f"{where} {enqueue[kind, where][0] / 1e3:.4f} ms (median "
            f"{enqueue[kind, where][1] / 1e3:.4f} ms), round "
            f"{by_events[kind, where]:.4f} ms by events"
            for where in ("one stream", "8 streams"))
            + f" (target for 8 streams: under 0.065 ms); on {card}",
            flush=True)
    python_us = {key: us[0] - lib_us[key[1], 1]
                 for key, us in enqueue.items()}
    print(f"[collectives] the library call (events and graph launch, "
          f"pointers packed beforehand), one set of outputs / two in turn "
          f"/ three in turn (a graph repointed every round): "
          + "; ".join(
              f"{where} " + " / ".join(
                  f"{lib_us[where, k] / 1e3:.4f}" for k in (1, 2, 3))
              + " ms" for where in ("one stream", "8 streams"))
          + "; the Python around it: " + "; ".join(
              f"{kind} on {where} {us / 1e3:.4f} ms"
              for (kind, where), us in python_us.items())
          + f"; on {card}", flush=True)
    probe_board = enqueue["probe's round", "8 streams"][0]
    functional_board = enqueue["functional round", "8 streams"][0]
    print(f"[collectives] 8-card board: 2*7/8*4 MiB needs {link_ms:.4f} ms "
          f"over {NVLINK_GBPS:.0f} GB/s links; the board-shaped enqueue "
          f"caps the bus bandwidth at {ceiling(probe_board)} for the "
          f"probe's round and at {ceiling(functional_board)} for a "
          f"functional round, against the ICI floor of "
          f"{floor_gbps if floor else 'n/a'} GB/s; ici_allreduce_probe over "
          f"8 members of the card read "
          f"{ar.metrics.get('busbw_gbps', 0.0):.2f} GB/s", flush=True)
    del shards, side

    # -- 8. ring attention on the card ---------------------------------------
    ring = [dev] * 8
    t0 = time.perf_counter()
    deep = on_path("deep probe, 8-member ring on one card",
                   lambda: ici_ring_attention_probe(ring), ring_kernels)
    print(f"[ring] deep probe in {time.perf_counter() - t0:.2f} s on {card}: "
          f"ok={deep.ok} {deep.detail} latency {deep.latency_ms:.3f} ms "
          f"{json.dumps(deep.metrics)}", flush=True)
    require(deep.ok, f"deep probe: {deep.detail}")
    # Two rings of 8 (the checked call and the timed round), one fused
    # launch a step, and one K3 launch for the full reference.
    require((K.launch_counts()["block_attention"],
             K.block_attention_merge_.launches) == (129, 128),
            f"deep probe: {K.launch_counts()['block_attention']} K3 "
            f"launches, {K.block_attention_merge_.launches} fused; want "
            f"129 and 128")
    require(deep.metrics["global_seq"] == 1024.0, f"deep probe: {deep}")
    require(float(deep.detail.rsplit(" ", 1)[1]) < RING_ATOL,
            f"deep probe error: {deep.detail}")

    soak = on_path(
        "ring soak, S 4096",
        lambda: R.ring_attention_soak(ring, seq_per_device=512, heads=16,
                                      head_dim=64),
        ring_kernels,
    )
    print(f"[ring] soak S {soak['global_seq']} over {soak['devices']} "
          f"members: ok={soak['ok']} max err {soak['max_err']:.3e}, "
          f"latency {soak['latency_ms']:.3f} ms, moved {soak['moved_bytes']} "
          f"bytes, {soak['link_gbps']:.2f} GB/s (local copies: one card) "
          f"on {card}", flush=True)
    require(soak["ok"] and soak["max_err"] < RING_ATOL, f"soak: {soak}")
    require(soak["global_seq"] == 4096, f"soak: {soak}")
    require(K.block_attention_merge_.launches == 128,
            f"soak: {K.block_attention_merge_.launches} fused launches, "
            f"want 128")

    # The deep probe's ring and the soak's, timed with the fused step and
    # with the old one (K3 + torch _merge) in one run, in turns.
    def ring_old_step(q_shards, k_shards, v_shards, devices, causal=True):
        """ring_attention before the fused step, kept here to time against
        it: a step is K3, then the merge in torch ops."""
        n = len(devices)
        B, S, H, D = q_shards[0].shape
        accs = [
            (torch.zeros((B, S, H, D), device=d_),
             torch.full((B, S, H), R.NEG_INF, device=d_),
             torch.zeros((B, S, H), device=d_))
            for d_ in devices
        ]
        cur_k, cur_v = list(k_shards), list(v_shards)
        for step in range(n):
            for rank in range(n):
                block = K.block_attention(
                    q_shards[rank], cur_k[rank], cur_v[rank],
                    rank * S, ((rank - step) % n) * S, causal,
                )
                accs[rank] = K.merge_plain(*accs[rank], *block)
            if step + 1 < n:
                cur_k = [cur_k[(i - 1) % n].to(devices[i], non_blocking=True)
                         for i in range(n)]
                cur_v = [cur_v[(i - 1) % n].to(devices[i], non_blocking=True)
                         for i in range(n)]
        return [R._normalise(num, den, q.dtype)
                for (num, _, den), q in zip(accs, q_shards)]

    def ring_round_ms(old: bool, **kw) -> float:
        fused_ring = R.ring_attention
        if old:
            R.ring_attention = ring_old_step
        try:
            res = R.ring_attention_soak(ring, rounds=RING_TIMED_ROUNDS, **kw)
        finally:
            R.ring_attention = fused_ring
        require(res["ok"], f"ring ({'old' if old else 'fused'} step): {res}")
        return res["latency_ms"]

    ring_steps = {}
    for label, kw in (
        ("deep probe, S 1024", dict(seq_per_device=128)),
        ("soak, S 4096", dict(seq_per_device=512, heads=16, head_dim=64)),
    ):
        runs = {"fused": [], "old": []}
        for step in ("fused", "old", "old", "fused"):
            runs[step].append(ring_round_ms(step == "old", **kw))
        fused_ms = sum(runs["fused"]) / 2
        old_ms = sum(runs["old"]) / 2
        ring_steps[label] = dict(fused_ms=runs["fused"], old_ms=runs["old"],
                                 ratio=fused_ms / old_ms)
        print(f"[ring] {label} over [cuda:0] * 8, {RING_TIMED_ROUNDS} rounds "
              f"a run, runs fused, old, old, fused: fused step "
              f"{runs['fused'][0]:.3f} / {runs['fused'][1]:.3f} ms a round, "
              f"old step (K3 + torch _merge) {runs['old'][0]:.3f} / "
              f"{runs['old'][1]:.3f} ms; fused / old {fused_ms / old_ms:.3f} "
              f"on {card}", flush=True)

    def elastic_rounds():
        er = R.ElasticRingSoak(ring, n_slices=4)
        rounds = [er.run_round()]
        er.exclude_slice(2)
        rounds.append(er.run_round())
        er.rejoin_slice(2)
        rounds.append(er.run_round())
        return rounds

    rounds = on_path("elastic ring", elastic_rounds, ring_kernels)
    for r in rounds:
        print(f"[ring] elastic round: {json.dumps(r)}")
        require(r["ok"] and r["max_err"] < RING_ATOL, f"elastic: {r}")
    require([r["devices"] for r in rounds] == [8, 6, 8],
            f"elastic ring sizes: {rounds}")

    checks = on_path("battery with deep=True, one device",
                     lambda: port.run_host_probe([dev], deep=True, **PROD),
                     fused_kernels)
    print(f"[ring] battery with deep=True on one device, on {card}:")
    all_ok(checks, "battery with deep=True")
    require(checks[-1].name == "ici_ring_attention"
            and checks[-1].detail == "single device; no ring to soak",
            f"deep check on one device: {checks[-1]}")

    # -- 9. the canary -----------------------------------------------------
    def bench_canary():
        t0 = time.perf_counter()
        runner = C.CanaryRunner(C.CanaryConfig(**BENCH_CANARY), device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        warm = [runner.run_step() for _ in range(3)]
        warm_s = time.perf_counter() - t0
        runner.reset_timing()
        for _ in range(CANARY_TIMED_STEPS):
            runner.run_step()
        return runner, init_s, warm, warm_s

    runner, init_s, warm, warm_s = on_path("canary, bench width",
                                           bench_canary, ())
    losses = warm + runner.losses
    print(f"[canary] {runner.param_count()} parameters, init {init_s:.2f} s, "
          f"3 warm-up steps {warm_s:.2f} s; losses "
          f"{[round(x, 4) for x in losses]}", flush=True)
    require(len(runner.losses) >= 20, "fewer than 20 timed canary steps")
    require(all(math.isfinite(x) for x in losses),
            f"canary loss not finite: {losses}")
    require(losses[-1] < losses[0],
            f"canary loss did not decrease: {losses}")
    perf = runner.perf_summary()
    print(f"[canary] median step {perf['median_step_s'] * 1e3:.3f} ms, "
          f"{perf['tokens_per_s']:.1f} tokens/s, "
          f"{perf['achieved_tflops']:.2f} TFLOPS, MFU {perf.get('mfu')} "
          f"against {BF16_PEAK_TFLOPS:.0f}, max gap "
          f"{runner.max_gap_seconds():.4f} s, peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB "
          f"on {card}", flush=True)
    sustained = runner.sustained_perf_summary()
    print(f"[canary] sustained: {json.dumps(sustained)} on {card}",
          flush=True)

    # Where a step's device time goes: two steps under torch.profiler.
    # The device's busy share sums the kernels' times over the window's
    # wall time; the breakdown lists the aten ops by the device time of
    # the kernels each launched itself.
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            runner.run_step()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    ops = prof.key_averages()
    kernel_us = sum(op.self_device_time_total for op in ops
                    if op.device_type == DeviceType.CUDA)
    host_ops = [op for op in ops if op.device_type == DeviceType.CPU
                and op.self_device_time_total > 0]
    if kernel_us <= 0:
        print("[canary] profile: the trace holds no device time "
              "(device busy share not measured)", flush=True)
    else:
        print(f"[canary] profile of 2 steps: device busy "
              f"{kernel_us / 1e6 / window_s:.3f} of {window_s * 1e3:.1f} ms "
              f"wall, kernels {kernel_us / 2e3:.3f} ms a step, on {card}; "
              f"ops by the device time of their kernels, a step:")
        for op in sorted(host_ops, key=lambda op: op.self_device_time_total,
                         reverse=True)[:15]:
            print(f"  {op.key}: {op.self_device_time_total / 2e3:.3f} ms "
                  f"({op.self_device_time_total / kernel_us:.3f}), "
                  f"{op.count // 2} calls", flush=True)
    del runner

    tiny = C.CanaryConfig(**TINY_CANARY)
    on_cpu = C.CanaryRunner(tiny, device=torch.device("cpu"))
    on_card = C.CanaryRunner(tiny, device=dev)
    on_card.params = C.params_from_numpy(C.params_to_numpy(on_cpu.params),
                                         dev)
    on_card.opt_state = on_card.opt.init(on_card.params)
    for step in range(3):
        l_cpu, l_card = on_cpu.run_step(), on_card.run_step()
        print(f"[canary] small canary step {step}: CPU {l_cpu:.6f}, "
              f"card {l_card:.6f}, |diff| {abs(l_cpu - l_card):.2e}")
        atol = TINY_FIRST_LOSS_ATOL if step == 0 else TINY_LOSS_ATOL
        require(abs(l_cpu - l_card) <= atol,
                f"small canary step {step}: card {l_card} vs CPU {l_cpu}")

    # -- 10. the sharded canary and the elastic runner ---------------------
    bench = C.CanaryConfig(**BENCH_CANARY)
    grid = [dev] * ICI_MEMBERS
    sharded_kernels = ("peer_reduce", "peer_gather")

    def sharded_canary():
        mesh = C.make_mesh(grid)
        require(mesh.shape == {"dp": 2, "tp": 4}, f"mesh {mesh.shape}")
        single = C.CanaryRunner(bench, device=dev)
        single_first = single.run_step()
        del single
        t0 = time.perf_counter()
        runner = C.CanaryRunner(bench, mesh=mesh)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats(dev)
        warm = [runner.run_step() for _ in range(3)]
        runner.reset_timing()
        before = K.launch_counts()
        for _ in range(SHARDED_TIMED_STEPS):
            runner.run_step()
        after = K.launch_counts()
        per_step = {k: (after[k] - before[k]) / SHARDED_TIMED_STEPS
                    for k in sharded_kernels}
        return runner, single_first, warm, per_step, init_s

    runner, single_first, warm, per_step, init_s = on_path(
        "sharded canary, bench width, dp 2 x tp 4 on one card",
        sharded_canary, sharded_kernels,
    )
    losses = warm + runner.losses
    print(f"[sharded] {runner.param_count()} parameters over {grid.count(dev)}"
          f" members of the card (dp 2 x tp 4), init {init_s:.2f} s; losses "
          f"{[round(x, 4) for x in losses]}", flush=True)
    first_diff = abs(losses[0] - single_first)
    print(f"[sharded] first step: sharded {losses[0]:.6f}, one device "
          f"{single_first:.6f}, |diff| {first_diff:.2e} (limit "
          f"{SHARDED_FIRST_LOSS_ATOL})", flush=True)
    require(first_diff <= SHARDED_FIRST_LOSS_ATOL,
            f"sharded first loss {losses[0]} vs one device {single_first}")
    require(len(runner.losses) == SHARDED_TIMED_STEPS
            and all(math.isfinite(x) for x in losses),
            f"sharded canary losses: {losses}")
    require(losses[-1] < losses[0],
            f"sharded canary loss did not decrease: {losses}")
    perf = runner.perf_summary()
    print(f"[sharded] median step {perf['median_step_s'] * 1e3:.3f} ms, "
          f"{perf['tokens_per_s']:.1f} tokens/s, "
          f"{perf['achieved_tflops']:.2f} TFLOPS; per step K4 "
          f"{per_step['peer_reduce']:.1f}, K5 {per_step['peer_gather']:.1f} "
          f"launches; peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB on {card}",
          flush=True)
    # The host's time inside the collectives: two more steps with the
    # all-reduce and all-gather wrapped in a host clock (the list-level
    # autograd functions look them up on the module; the step's dp
    # all-reduce through the canary module's name).
    spent = {"s": 0.0, "calls": 0}

    def clocked(fn):
        def wrapper(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                spent["s"] += time.perf_counter() - t0
                spent["calls"] += 1
        return wrapper

    saved = (collectives.all_reduce, collectives.all_gather, C.all_reduce)
    collectives.all_reduce = clocked(saved[0])
    collectives.all_gather = clocked(saved[1])
    C.all_reduce = clocked(saved[2])
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            runner.run_step()
        step_s = (time.perf_counter() - t0) / 2
    finally:
        collectives.all_reduce, collectives.all_gather, C.all_reduce = saved
    print(f"[sharded] host time in the collectives: {spent['s'] / 2 * 1e3:.3f}"
          f" ms a step over {spent['calls'] // 2} calls, of a "
          f"{step_s * 1e3:.3f} ms step, on {card}", flush=True)
    del runner

    def elastic_canary():
        t0 = time.perf_counter()
        er = C.ElasticCanaryRunner(bench, grid, n_slices=2)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        sizes = []
        for action in (None, "exclude", "rejoin"):
            if action == "exclude":
                er.exclude_slice(1)
            elif action == "rejoin":
                er.rejoin_slice(1)
            sizes.append((er.active_device_count(), er.cfg.batch))
            for _ in range(3):
                er.run_step()
        return er, setup_s, sizes

    er, setup_s, sizes = on_path("elastic canary, bench width, 2 slices",
                                 elastic_canary, sharded_kernels)
    print(f"[elastic] set-up with the precompiled bundles {setup_s:.2f} s; "
          f"(members, batch) before, during and after the exclusion "
          f"{sizes}; losses {[round(x, 4) for x in er.losses]}", flush=True)
    for e in er.resize_events:
        print(f"[elastic] resize {e['direction']} (slice {e['slice']}): "
              f"{e['seconds']:.3f} s on {card}", flush=True)
    print(f"[elastic] max_gap_seconds {er.max_gap_seconds():.3f} over "
          f"{len(er.losses)} steps on {card}", flush=True)
    require(sizes == [(8, 32), (4, 32), (8, 32)], f"elastic sizes {sizes}")
    require([e["direction"] for e in er.resize_events] == ["down", "up"],
            f"elastic resizes {er.resize_events}")
    require(all(math.isfinite(x) for x in er.losses),
            f"elastic losses {er.losses}")
    del er

    # -- 11. the labelled gate, the network-path gate and D6 ----------------
    # The agent's unfused report from a node labelled as GPU Feature
    # Discovery labels an HGX H100 host, with no slice: the gate reads the
    # accelerator and the count from the labels and applies the SXM
    # profile's floors.
    class LabelledNode(Node):
        def __init__(self, name, annotations, gpus):
            super().__init__(name, annotations)
            self.labels = {GPU_PRODUCT_LABELS[0]: "NVIDIA-H100-80GB-HBM3",
                           GPU_COUNT_LABELS[0]: str(gpus)}

    client = RecordingClient()
    agent = HealthAgent(client, "gpu-node-1", keys,
                        driver_revision="rev-smoke", fused=False, **PROD)
    report = on_path("agent, unfused, labelled node", agent.run_once,
                     battery_kernels)
    require(report.healthy, f"unfused agent report: {report.to_json()}")
    raw = client.patches[0][1][keys.health_report_annotation]
    gated = port.NodeReportProber(keys, revision_resolver=lambda ds: "rev-smoke",
                                  generation_floors=True)
    labelled = LabelledNode("gpu-node-1", {keys.health_report_annotation: raw},
                            count)
    verdict = gated.probe(Group([labelled]))
    hbm_floor = gated._hbm_floor(Group([labelled]), labelled)
    hbm = next(c for c in report.checks if c.name == "hbm_bandwidth")
    measured = (f"{hbm.metrics['gbps']:.1f} GB/s" if "gbps" in hbm.metrics
                else "not measured (timing inconclusive)")
    print(f"[gate] labelled node ({GPU_PRODUCT_LABELS[0]}=NVIDIA-H100-80GB-"
          f"HBM3, {GPU_COUNT_LABELS[0]}={count}), generation floors: HBM "
          f"floor {hbm_floor:.1f} GB/s, measured {measured}; verdict "
          f"healthy={verdict.healthy}: {verdict.detail}; on {card}",
          flush=True)
    require(hbm_floor == 0.5 * 3350.0, f"HBM floor {hbm_floor}")
    require(verdict.healthy, f"labelled node rejected: {verdict.detail}")
    one_more = LabelledNode("gpu-node-1",
                            {keys.health_report_annotation: raw}, count + 1)
    verdict = gated.probe(Group([one_more]))
    print(f"[gate] the same report labelled with {count + 1} GPUs: "
          f"healthy={verdict.healthy}: {verdict.detail}", flush=True)
    require(not verdict.healthy and verdict.detail ==
            f"node gpu-node-1: host enumerates {count} chips, expected "
            f"{count + 1}", f"one GPU more: {verdict.detail}")

    # The network-path artifact gate: one member, then 8 of the card,
    # each cold (a warm-up-cache miss) and warm.
    net_fallbacks = fused.battery_stats()["fallbacks"]
    net_ms = {}
    for label, where in (("1 member", [dev]), ("8 members", members)):
        must = fused_kernels + (collective_kernels if len(where) > 1
                                else ())
        for attempt in ("cold", "warm"):
            t0 = time.perf_counter()
            checks = on_path(f"network-path checks, {label}, {attempt}",
                             lambda: run_network_path_checks(where), must)
            net_ms[label, attempt] = (time.perf_counter() - t0) * 1e3
            print(f"[network] run_network_path_checks over {label}, "
                  f"{attempt}: {net_ms[label, attempt]:.3f} ms on {card}:")
            all_ok(checks, f"network-path checks over {label} ({attempt})")
            require(checks[1].metrics["battery_cache_hit"]
                    == (attempt == "warm"), f"{label} {attempt}: cache")
    require(fused.battery_stats()["fallbacks"] == net_fallbacks,
            f"fused fallbacks on the network path: {fused.battery_stats()}")
    net_battery = fused.run_fused_battery(
        members, matmul_n=fused.NETWORK_MATMUL_N,
        hbm_mib=fused.NETWORK_HBM_MIB,
        allreduce_elems=fused.NETWORK_ALLREDUCE_ELEMS,
    )
    all_ok(net_battery, "the fused battery at the network sizes, 8 members")
    gate = NetworkPathGateProber().probe(Group([labelled]), "network-driver")
    print(f"[network] NetworkPathGateProber on the card's devices: "
          f"passed={gate.passed} {gate.detail}", flush=True)
    require(gate.passed, f"network-path gate: {gate.detail}")
    collectives.ring_shift = member_0_keeps_its_value
    try:
        gate = NetworkPathGateProber(
            runner=lambda: run_network_path_checks(members)
        ).probe(Group([labelled]), "network-driver")
    finally:
        collectives.ring_shift = real_ring_shift
    print(f"[network] the gate over 8 members, member 0 keeping its value: "
          f"passed={gate.passed} {gate.detail}", flush=True)
    require(not gate.passed and gate.detail ==
            "ici_link_state: link 7->0 delivered 0.0, expected 7.0",
            f"network-path gate with a ring fault: {gate.detail}")

    # D6: a 2-process gloo world over a loopback store, each process's
    # one-hot on the card; then ring-c expected as well, with a live
    # listener as the DCN peer.  NCCL refuses two ranks on one GPU, so the
    # cross-process NCCL all-reduce cannot run on a one-card machine.
    torch.cuda.empty_cache()
    listener = socket.socket()
    listener.bind(("127.0.0.1", 0))
    listener.listen(8)
    peer = f"127.0.0.1:{listener.getsockname()[1]}"
    master_port = free_port()
    children = []
    try:
        for rank, group_name in enumerate(DCN_GROUPS):
            env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(master_port), RANK=str(rank),
                       WORLD_SIZE=str(len(DCN_GROUPS)))
            children.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), DCN_CHILD,
                 group_name, peer],
                env=env, cwd=HERE, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True,
            ))
        outs = []
        for child in children:
            out, err = child.communicate(timeout=DCN_CHILD_TIMEOUT_S)
            require(child.returncode == 0,
                    f"DCN child failed ({child.returncode}):\n{out}\n"
                    f"{err[-4000:]}")
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        listener.close()
        for child in children:
            if child.poll() is None:
                child.kill()
                child.communicate()
    for rank, res in enumerate(outs):
        print(f"[dcn] rank {rank} ({DCN_GROUPS[rank]}), 2-process gloo world, "
              f"one-hot on {res['tensor_devices']}: {res['pass']['detail']} "
              f"in {res['pass']['latency_ms']:.3f} ms; ring-c expected: "
              f"reachability {res['reach']['detail']}; collective "
              f"{res['ring_c']['detail']} in "
              f"{res['ring_c']['latency_ms']:.3f} ms; {DCN_WARM_CALLS} warm "
              f"calls after a barrier: best {res['warm_ms'][0]:.3f} ms, "
              f"median {res['warm_ms'][DCN_WARM_CALLS // 2]:.3f} ms; on "
              f"{card}", flush=True)
        require(res["tensor_devices"] == ["cuda:0", "cuda:0"],
                f"the one-hot was not on the card: {res['tensor_devices']}")
        require(res["pass"]["ok"] and res["pass"]["detail"] ==
                "cross-slice psum completed; contributions: ring-a=1 "
                "ring-b=1", f"rank {rank}: {res['pass']}")
        require(res["reach"]["ok"], f"rank {rank}: {res['reach']}")
        require(not res["ring_c"]["ok"] and res["ring_c"]["detail"] ==
                "DCN collective missing contribution(s) from: ring-c; "
                "cross-slice psum completed; contributions: ring-a=1 "
                "ring-b=1 ring-c=0", f"rank {rank}: {res['ring_c']}")
    # A one-rank NCCL world on the card: the probe fails closed, and
    # NCCL's own all-reduce of a one-hot there is the identity.
    import torch.distributed as dist

    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
        world_size=1, timeout=timedelta(seconds=120),
    )
    try:
        one = dcn_collective_probe([dev], "ring-a", ["ring-a", "ring-b"])
        onehot = torch.tensor([0.0, 1.0], device=dev)
        dist.all_reduce(onehot)
        nccl_sum = onehot.tolist()
    finally:
        dist.destroy_process_group()
    print(f"[dcn] one-rank NCCL world on the card: ok={one.ok} {one.detail}; "
          f"NCCL's all-reduce of [0, 1] there gives {nccl_sum}; the "
          f"cross-process NCCL all-reduce stays unverified on a one-card "
          f"machine (NCCL refuses two ranks on one GPU)", flush=True)
    require(not one.ok and "world never formed" in one.detail,
            f"one-rank NCCL world: {one.detail}")
    require(nccl_sum == [0.0, 1.0], f"NCCL all-reduce of one rank: {nccl_sum}")

    # -- 12. the port's roll: preflight, entry, dry run, sequential roll ----
    t12 = time.perf_counter()
    pre = hostenv.probe_cuda_init(PREFLIGHT_TIMEOUT_S)
    print(f"[roll] CUDA preflight in a child: ok={pre['ok']} "
          f"{pre['device_name']} x{pre['count']} in {pre['seconds']:.2f} s "
          f"{pre['error'] or ''}", flush=True)
    require(pre["ok"] and pre["device_name"] == name
            and pre["count"] == count, f"CUDA preflight: {pre}")
    fn, (params, batch) = entry_mod.entry()
    require(batch.device.type == "cuda", f"entry() batch on {batch.device}")
    loss_card = float(fn(params, batch))
    cpu = torch.device("cpu")
    loss_cpu = float(fn(C.params_from_numpy(C.params_to_numpy(params), cpu),
                        batch.to(cpu)))
    print(f"[roll] entry(): loss on the card {loss_card:.6f}, on the CPU with "
          f"the same weights and batch {loss_cpu:.6f}, |diff| "
          f"{abs(loss_card - loss_cpu):.2e}", flush=True)
    require(abs(loss_card - loss_cpu) <= ENTRY_LOSS_ATOL,
            f"entry() loss: card {loss_card} vs CPU {loss_cpu}")
    t0 = time.perf_counter()
    entry_mod.dryrun_multichip(ICI_MEMBERS, timeout_s=DRYRUN_TIMEOUT_S)
    print(f"[roll] dryrun_multichip({ICI_MEMBERS}) exited 0 in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    torch.cuda.empty_cache()
    roll_canary = C.CanaryRunner(bench_mod.BENCH_CANARY, device=dev)
    for _ in range(3):
        roll_canary.run_step()
    pool_members = entry_mod.members_of(bench_mod.GPUS_PER_NODE, "cuda")
    roll_fallbacks = fused.battery_stats()["fallbacks"]
    seq = on_path(
        "sequential roll, 4 HGX nodes, attribution check",
        lambda: bench_mod.roll(pool_members, roll_canary, threading.Lock(),
                               pipeline=False, attribution=True),
        fused_kernels + collective_kernels,
    )
    finals = {}
    for _, node_name, state in seq["transitions"]:
        finals[node_name] = state
    lock = seq["lock"]
    print(f"[roll] sequential roll of {bench_mod.N_NODES} HGX H100 nodes "
          f"(agents over {len(pool_members)} members of the card, bench-width "
          f"canary on pool-0): complete={seq['complete']} in "
          f"{seq['wall_s']:.3f} s, {seq['ticks']} passes; canary downtime "
          f"{seq['downtime_s']:.3f} s over {seq['canary_steps']} steps "
          f"(median step {seq['canary_perf'].get('median_step_s', 0) * 1e3:.3f}"
          f" ms); node windows "
          + ", ".join(f"{k} {v:.3f} s" for k, v in
                      seq["node_windows_s"].items() if v is not None)
          + f"; {seq['batteries']} agent batteries, {seq['battery_s']:.3f} s; "
          f"lock wait {lock['wait_total_s']:.3f} s in all (share "
          f"{lock['wait_share']:.4f}), {lock['wait_in_longest_gap_s']:.3f} s "
          f"of the longest gap; on {card}", flush=True)
    print(f"[roll] attribution check: {seq['attribution']}", flush=True)
    require(seq["complete"] and finals == {
        f"pool-{i}": "upgrade-done" for i in range(bench_mod.N_NODES)
    }, f"sequential roll: complete={seq['complete']} states {finals} "
       f"{seq.get('final_states')}")
    require(fused.battery_stats()["fallbacks"] == roll_fallbacks,
            f"fused fallbacks on the roll: {fused.battery_stats()}")
    require(seq["canary_error"] is None,
            f"the canary failed during the roll: {seq['canary_error']}")
    require(math.isfinite(seq["downtime_s"])
            and 0 < seq["downtime_s"] < bench_mod.DOWNTIME_BUDGET_S,
            f"canary downtime {seq['downtime_s']}")
    require(seq["max_concurrent_unavailable"] == 1,
            f"nodes out at once: {seq['max_concurrent_unavailable']}")
    require(seq["attribution"]["ok"]
            and seq["attribution"]["detail"] == "no health report from node "
            "pool-1", f"attribution check: {seq['attribution']}")
    del roll_canary
    print(f"[roll] phase 12 took {time.perf_counter() - t12:.2f} s",
          flush=True)

    # -- 13. the port's controller rolls a GFD-labelled pool -------------
    t13 = time.perf_counter()
    ctl_fallbacks = fused.battery_stats()["fallbacks"]
    ctl = on_path(
        "controller roll, 4 GFD-labelled H100 nodes",
        lambda: bench_mod.controller_roll(pool_members),
        fused_kernels + collective_kernels,
    )
    products = dict(bench_mod.CONTROLLER_POOL)
    print(f"[controller] the port's UpgradeController (keys {ctl['keys']}, "
          f"agents' env {ctl['agent_env']}) rolled "
          + ", ".join(f"{n} ({products[n]})" for n in ctl["admitted"])
          + f" in that order: complete={ctl['complete']} in "
          f"{ctl['wall_s']:.3f} s, {ctl['passes']} passes; node windows "
          + ", ".join(f"{k} {v:.3f} s" for k, v in
                      sorted(ctl["node_windows_s"].items()) if v is not None)
          + f"; {ctl['batteries']} agent batteries over "
          f"{len(pool_members)} members, {ctl['battery_s']:.3f} s; on {card}",
          flush=True)
    print(f"[controller] scraped fleet_nodes {ctl['fleet_nodes']}, "
          f"nodes_by_state upgrade-done "
          f"{ctl['nodes_by_state'].get('upgrade-done')}; status generations "
          f"{ctl['status_generations']}", flush=True)
    require(ctl["complete"] and ctl["final_states"] == {
        name: "upgrade-done" for name in products
    }, f"controller roll: states {ctl['final_states']}")
    # PCIe, then both SXM, then NVL (the profiles' order, then the name).
    require(ctl["admitted"] == ["pool-3", "pool-1", "pool-2", "pool-0"],
            f"controller roll admitted {ctl['admitted']}")
    generations = {"h100-pcie": 1, "h100-sxm": 2, "h100-nvl": 1}
    require(ctl["fleet_nodes"] == {g: float(n) for g, n in
                                   generations.items()},
            f"fleet_nodes over HTTP: {ctl['fleet_nodes']}")
    require(ctl["nodes_by_state"].get("upgrade-done") == 4.0,
            f"nodes_by_state over HTTP: {ctl['nodes_by_state']}")
    require({g: row["nodes"] for g, row in
             (ctl["status_generations"] or {}).items()} == generations,
            f"status generations: {ctl['status_generations']}")
    require(ctl["keys"] == "nvidia.com/gpu-driver-upgrade-state"
            and ctl["agent_env"] == {"DRIVER_NAME": "gpu",
                                     "DRIVER_REVISION": ctl["revisions"][1]},
            f"controller and agents' keys: {ctl['keys']} {ctl['agent_env']}")
    require(fused.battery_stats()["fallbacks"] == ctl_fallbacks,
            f"fused fallbacks on the controller roll: {fused.battery_stats()}")
    print(f"[controller] phase 13 took {time.perf_counter() - t13:.2f} s",
          flush=True)

    # -- 14. the elastic rolls and the federated roll -----------------------
    t14 = time.perf_counter()
    torch.cuda.empty_cache()
    negotiated = {
        "accept": ({"accept": 4, "decline": 0, "timeout": 0},
                   {"down": 4, "up": 4}, 8),
        "decline": ({"accept": 0, "decline": 4, "timeout": 0},
                    {"down": 0, "up": 0}, 0),
    }
    for accept in (True, False):
        variant = "accept" if accept else "decline"
        er = on_path(
            f"elastic roll ({variant}), bench-width canary over "
            f"{len(pool_members)} members in {bench_mod.ELASTIC_N_SLICES} "
            f"slices",
            lambda: bench_mod.elastic_roll(
                pool_members, accept,
                steps_per_pass=ELASTIC_STEPS_PER_PASS),
            sharded_kernels,
        )
        parts = (er["slowest_step_s"] + er["slowest_resize_s"]
                 + er["slowest_pass_host_s"])
        print(f"[elastic-roll] {variant}: converged={er['converged']} in "
              f"{er['wall_s']:.3f} s, {er['passes']} passes, "
              f"{er['canary_steps']} steps (median "
              f"{er['median_step_s'] * 1e3:.3f} ms), meshes (dp, tp) "
              f"{er['meshes']}; negotiations {er['negotiations']}, resizes "
              f"{er['resizes']}, runner resizes {er['runner_resizes']}, "
              f"leftover excluded {er['leftover_excluded']}; on {card}",
              flush=True)
        print(f"[elastic-roll] {variant}: max_gap_s {er['max_gap_s']:.4f} "
              f"(ceiling {er['gap_ceiling_s']} s, downtime "
              f"{er['downtime_s']:.4f} s); its parts at most: slowest step "
              f"{er['slowest_step_s']:.4f} s + slowest resize "
              f"{er['slowest_resize_s']:.4f} s + slowest pass's host time "
              f"{er['slowest_pass_host_s']:.4f} s = {parts:.4f} s; the "
              f"roll's K4 {er['launches']['peer_reduce']}, K5 "
              f"{er['launches']['peer_gather']} launches; on {card}",
              flush=True)
        for e in er["resize_events"]:
            print(f"[elastic-roll] {variant}: resize {e['direction']} "
                  f"(slice {e['slice']}): {e['seconds']:.3f} s on {card}",
                  flush=True)
        want_neg, want_resizes, want_runner = negotiated[variant]
        require(er["converged"] and er["negotiations"] == want_neg
                and er["resizes"] == want_resizes
                and er["runner_resizes"] == want_runner
                and er["leftover_excluded"] == 0,
                f"elastic roll ({variant}): {er}")
        require(er["canary_steps"]
                == ELASTIC_STEPS_PER_PASS * er["passes"]
                and er["meshes"] == ([(2, 4), (3, 2)] if accept
                                     else [(2, 4)]),
                f"elastic roll ({variant}): {er['canary_steps']} steps over "
                f"{er['passes']} passes, meshes {er['meshes']}")
        require(0 < er["max_gap_s"] <= parts,
                f"elastic roll ({variant}): gap {er['max_gap_s']} past its "
                f"parts {parts}")
        require(min(er["launches"].values()) > 0,
                f"elastic roll ({variant}): launches {er['launches']}")
        del er
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    fed = bench_mod.federation_roll()
    fed_s = time.perf_counter() - t0
    print(f"[federation] {fed['clusters']} clusters of "
          f"{fed['nodes_per_cluster']} GFD-labelled nodes: "
          f"converged={fed['converged']} in {fed['ticks']} ticks, "
          f"{fed_s:.3f} s of host time; partition window "
          f"{fed['partition_window_ticks']} ticks "
          f"({fed['partition_window_skips']} skipped, "
          f"{fed['partition_window_writes']} writes), budget "
          f"violations {fed['global_budget_violations']}, peak unavailable "
          f"{fed['peak_global_unavailable']}, store writes "
          f"{fed['store_writes']}, partitions {fed['partitions_detected']}, "
          f"heals {fed['heals']}", flush=True)
    require(fed["converged"] and fed["partition_window_ticks"] == 20
            and fed["partition_window_writes"] == 0
            and fed["global_budget_violations"] == 0
            and fed["store_writes"] <= bench_mod.FED_STORE_WRITE_CEILING
            and fed["partitions_detected"] == 1 and fed["heals"] == 1,
            f"federated roll: {fed}")
    print(f"[elastic-roll] phase 14 took {time.perf_counter() - t14:.2f} s",
          flush=True)

    # -- 15. the DCN roll, the cross-ring collective, the failure roll and
    # the heterogeneous stage ----------------------------------------------
    t15 = time.perf_counter()
    torch.cuda.empty_cache()
    dcn_canary = C.CanaryRunner(bench_mod.BENCH_CANARY, device=dev)
    for _ in range(3):
        dcn_canary.run_step()
    stage_fallbacks = fused.battery_stats()["fallbacks"]
    dr = on_path(
        "dcn roll, 2 rings of 2 HGX nodes",
        lambda: bench_mod.roll(pool_members, dcn_canary, threading.Lock(),
                               pipeline=False, attribution=False, dcn=True),
        fused_kernels + collective_kernels,
    )
    dcn_finals = {node_name: state for _, node_name, state in
                  dr["transitions"]}
    print(f"[dcn-roll] {bench_mod.N_NODES} HGX H100 nodes in rings "
          f"{bench_mod.DCN_RINGS}, two at a time: complete={dr['complete']} "
          f"in {dr['wall_s']:.3f} s, {dr['ticks']} passes; ring high-water "
          f"{dr['max_ring_unavailable']}, nodes out at once "
          f"{dr['max_concurrent_unavailable']}; the pair "
          f"{dr['canary_nodes']}'s downtime {dr['downtime_s']:.3f} s over "
          f"{dr['canary_steps']} steps; node windows "
          + ", ".join(f"{k} {v:.3f} s" for k, v in
                      dr["node_windows_s"].items() if v is not None)
          + f"; lock wait share {dr['lock']['wait_share']:.4f}, "
          f"{dr['lock']['wait_in_longest_gap_s']:.3f} s of the longest gap; "
          f"on {card}", flush=True)
    require(dr["complete"] and dcn_finals == {
        f"pool-{i}": "upgrade-done" for i in range(bench_mod.N_NODES)
    }, f"dcn roll: complete={dr['complete']} states {dcn_finals}")
    require(dr["max_ring_unavailable"] == 1
            and dr["max_concurrent_unavailable"] == 2,
            f"dcn roll: ring high-water {dr['max_ring_unavailable']}, "
            f"concurrency {dr['max_concurrent_unavailable']}")
    require(dr["canary_error"] is None and math.isfinite(dr["downtime_s"])
            and 0 < dr["downtime_s"] < bench_mod.DOWNTIME_BUDGET_S,
            f"dcn roll canary: {dr['canary_error']} {dr['downtime_s']}")
    del dcn_canary
    torch.cuda.empty_cache()
    col = bench_mod.dcn_collective_stage()
    print(f"[dcn-collective] 2 worker processes, one a ring, each its "
          f"node's agent over {bench_mod.GPUS_PER_NODE} members of the card "
          f"(deep probe, battery {col['size']}): ok={col['ok']} in "
          f"{col['wall_s']:.3f} s; {col['backend']}", flush=True)
    for ring in ("ring-a", "ring-b"):
        v = col["rings"].get(ring, {})
        print(f"[dcn-collective] {ring}: dcn_collective "
              f"{v.get('dcn_collective')}, healthy {v.get('healthy')}, "
              f"world size {v.get('world_size')}, failed {v.get('failed')} "
              f"{v.get('error', '')}; gate {col['gates'][ring]}", flush=True)
        counts = v.get("launches") or {}
        print(f"[launches] cross-ring worker {ring} (its own process, "
              "counted there): "
              + ", ".join(f"{k} {n}" for k, n in counts.items()), flush=True)
        for kname in fused_kernels + ring_kernels + collective_kernels:
            require(counts.get(kname, 0) > 0,
                    f"{kname} was not launched by the {ring} worker")
    require(col["ok"], f"cross-ring collective: {col}")
    fr = on_path(
        "failure-injection roll, 4 HGX nodes",
        lambda: bench_mod.failure_injection_roll(pool_members,
                                                 threading.Lock()),
        fused_kernels + collective_kernels,
    )
    pins = bench_mod.failure_roll_pins(fr)
    kill = fr["controller_kill"]
    print(f"[failure-roll] complete={fr['complete']} in {fr['wall_s']:.3f} "
          f"s; {fr['victim']} failed {fr['failed_within_s']} s after its "
          f"validation entry (timeout {fr['validation_timeout_s']} s), gate "
          f"{fr['gate_rejections']}, {fr['stuck_events_naming_victim']} stuck "
          f"events naming it ({fr['stuck_event_sample']}); quarantines "
          f"{fr['quarantines']}, rejoins {fr['rejoins']}; escalations "
          f"{fr['escalations']}, stuck pod cleared {fr['stuck_pod_cleared']}; "
          f"engine kill at tick {kill['kill_tick']}, recovered after "
          f"{kill['recovery_ticks']} tick(s), adopted {kill['adopted']}; "
          f"{fr['batteries']} agent batteries; on {card}", flush=True)
    print(f"[failure-roll] timeline {fr['timeline']}", flush=True)
    print(f"[failure-roll] pins {pins}", flush=True)
    require(all(pins.values()), f"failure roll pins: {pins}")
    require(fused.battery_stats()["fallbacks"] == stage_fallbacks,
            f"fused fallbacks on the DCN and failure rolls: "
            f"{fused.battery_stats()}")
    t0 = time.perf_counter()
    het = bench_mod.heterogeneous_roll()
    print(f"[heterogeneous] {het['nodes']} GFD-labelled nodes in "
          f"{het['pools']} pools: converged={het['converged']} in "
          f"{het['ticks']} ticks, {time.perf_counter() - t0:.3f} s of host "
          f"time; admitted {het['admission_order']} (first ticks "
          f"{het['first_admit_ticks']}); the held pool's transitions "
          f"{het['held_transitions_while_closed']}, cordons "
          f"{het['held_cordons_while_closed']} while closed", flush=True)
    require(het["converged"] and het["window_opened"]
            and het["oldest_first"]
            and het["held_transitions_while_closed"] == 0
            and het["held_cordons_while_closed"] == 0,
            f"heterogeneous stage: {het}")
    print(f"[stages] phase 15 took {time.perf_counter() - t15:.2f} s",
          flush=True)

    # -- 16. the guard's stages over GFD-labelled H100 fleets ---------------
    # Host stages at the reference guard's node counts (each GFD node its
    # own pool: 4096 and 100,000 of them), the packed stage on the
    # reference's TPU slices, the fused battery and the async gate over
    # the 8 members at production size (counted as a path: it must launch
    # K1, its verifying pass, K2, K4 and K5, with no fused fallback), the
    # tracing stage's timed rolls each in a child of its own, the
    # 100,000-node stage last, in a child as well.
    t16 = time.perf_counter()
    from k8s_operator_libs_tpu_torch import bench_guard

    torch.cuda.empty_cache()
    for gname, run in bench_guard.stages(pool_members):
        t0 = time.perf_counter()
        if gname == "probe_battery":
            record = on_path(
                f"guard battery stage, fused battery over "
                f"{len(pool_members)} members at production size",
                run, fused_kernels + collective_kernels)
        else:
            record = run()
        failures = bench_guard.check(record)
        print(f"[guard] {gname}: {time.perf_counter() - t0:.3f} s on the "
              f"host of {card}; "
              + json.dumps(record, sort_keys=True, default=str), flush=True)
        require(not failures, f"guard stage {gname}: {failures}")
        if gname == "probe_battery":
            require(record["fallbacks"] == 0 and record["warm_cache_hit"],
                    f"guard battery stage: fallbacks {record['fallbacks']}, "
                    f"warm cache hit {record['warm_cache_hit']}")
        elif gname in ("sharded_reconcile", "incremental_100k"):
            require(record["pools"] == record["nodes"],
                    f"guard {gname}: {record['pools']} pools of "
                    f"{record['nodes']} GFD nodes")
    print(f"[guard] phase 16 took {time.perf_counter() - t16:.2f} s",
          flush=True)

    # -- 17. the controller's own modes on the card ------------------------
    # The watch-driven, sharded and leader-elected loops roll the
    # controller roll's pool, each on a fresh cluster, every validation
    # gated by the agents' fused batteries over the 8 members (a path:
    # K1, its verifying pass, K2, K4 and K5, no fused fallback); the
    # dry run's plan comes before the watch roll.
    t17 = time.perf_counter()
    torch.cuda.empty_cache()
    modes_fallbacks = fused.battery_stats()["fallbacks"]
    modes = on_path(
        "controller modes (watch, sharded, failover), 4 GFD-labelled H100 "
        "nodes",
        lambda: bench_mod.controller_modes(pool_members),
        fused_kernels + collective_kernels,
    )
    dry = modes["dry_run"]
    print(f"[modes] dry_run: plan {dry['plan_order']} in "
          f"{dry['plan_waves']} waves, {dry['writes']} writes", flush=True)
    for mode in ("watch", "sharded", "failover"):
        m = modes[mode]
        extra = ""
        if mode == "sharded":
            extra = (f"; an idle tick after walked "
                     f"{m.get('idle_tick_pools_walked')} pools")
        elif mode == "failover":
            extra = (f"; {m['crashed']} crashed (identity, s), Lease "
                     f"holders {m['lease_holders']}, at most "
                     f"{m['most_leading_at_once']} leading at once")
        print(f"[modes] {mode}: complete={m['complete']} in "
              f"{m['wall_s']:.3f} s, admitted {m['admitted']}, passes "
              f"{m['passes']}, cordons {m['cordons']}, node windows "
              + ", ".join(f"{k} {v:.3f} s" for k, v in
                          sorted(m["node_windows_s"].items())
                          if v is not None)
              + f"; {m['batteries']} agent batteries over "
              f"{len(pool_members)} members, {m['battery_s']:.3f} s{extra}; "
              f"on {card}", flush=True)
    modes_pins = bench_mod.controller_modes_pins(modes)
    print(f"[modes] pins {modes_pins}", flush=True)
    require(all(modes_pins.values()), f"controller modes' pins: {modes_pins}")
    require(fused.battery_stats()["fallbacks"] == modes_fallbacks,
            f"fused fallbacks on the controller modes: "
            f"{fused.battery_stats()}")
    print(f"[modes] phase 17 took {time.perf_counter() - t17:.2f} s",
          flush=True)

    # -- 18. the installed port ------------------------------------------
    # The battery and the deep probe from a read-only installed copy, its
    # kernel library prebuilt by the build entry and no nvcc reachable (a
    # path of its own, counted in the child: K1-K5, no fused fallback).
    t18 = time.perf_counter()
    torch.cuda.empty_cache()
    installed_port(card)
    print(f"[installed] phase 18 took {time.perf_counter() - t18:.2f} s",
          flush=True)

    # -- 19. the node's entry points -------------------------------------
    # The agent and the safe-load init container as their DaemonSets run
    # them: processes of their own, from a kubeconfig, against an API
    # server.  The agent loads phase 2's library; its launches are its
    # own process's, printed at its termination (K1 and K2 on one card).
    t19 = time.perf_counter()
    torch.cuda.empty_cache()
    node_entry_points(card)
    print(f"[entry] phase 19 took {time.perf_counter() - t19:.2f} s",
          flush=True)

    print("[launches] main path total: "
          + ", ".join(f"{k} {n}" for k, n in launches.items()), flush=True)

    # -- the kernel line, card, result -----------------------------------
    source = {
        "stream_increment_":
            "k8s_operator_libs_tpu_torch/kernels/csrc/battery_kernels.cu",
        "stream_increment_verify_":
            "k8s_operator_libs_tpu_torch/kernels/csrc/battery_kernels.cu",
        "verify_stats":
            "k8s_operator_libs_tpu_torch/kernels/csrc/battery_kernels.cu",
        "block_attention":
            "k8s_operator_libs_tpu_torch/kernels/csrc/attention_kernels.cu",
        "peer_reduce":
            "k8s_operator_libs_tpu_torch/kernels/csrc/collective_kernels.cu",
        "peer_gather":
            "k8s_operator_libs_tpu_torch/kernels/csrc/collective_kernels.cu",
    }
    replaces = {
        "stream_increment_": "k8s_operator_libs_tpu/health/probes.py:517",
        "stream_increment_verify_": "k8s_operator_libs_tpu/health/fused.py:204",
        "verify_stats": "k8s_operator_libs_tpu/health/fused.py:194",
        "block_attention":
            "k8s_operator_libs_tpu/workloads/ring_attention.py:55",
        "peer_reduce": "k8s_operator_libs_tpu/health/probes.py:617",
        "peer_gather": "k8s_operator_libs_tpu/workloads/canary.py:211",
    }
    for row in timing["block_attention"]["shapes"]:
        if row.get("entry") == "block_attention_merge_":
            row["launches"] = launches["block_attention_merge_"]
    for row in timing["peer_reduce"]["shapes"]:
        row["launches"] = k4_by_shape.get((row["k"], row["len"]), 0)
    print(f"[launches] K4 on the main path by (k, len): {k4_by_shape}",
          flush=True)
    timing["block_attention"]["ring_steps"] = ring_steps
    kernels = [
        dict(
            name=kname, route="cuda", source=source[kname],
            replaces=replaces[kname], launches=launches[kname],
            max_abs_err=max_err[kname], **timing[kname],
        )
        for kname in K.launch_counts()
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": name, "count": count},
    }))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == DCN_CHILD:
        sys.exit(dcn_child(sys.argv[2], sys.argv[3]))
    if len(sys.argv) == 3 and sys.argv[1] == TURN_ARG:
        import torch

        require(torch.cuda.is_available(), "no CUDA device")
        print(nvidia_smi_name_power(), flush=True)
        print(json.dumps(turn(int(sys.argv[2]))), flush=True)
        sys.exit(0)
    sys.exit(main())
