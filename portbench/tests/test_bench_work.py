"""The work counts behind the roofline and MFU shares, against hand
counts at small sizes, and against the port's own arithmetic where it
has one."""

import pytest

from harness import work


def test_battery_work_one_member_by_hand():
    # n 4: 8 products of 2·4³ flops; each reads two 4×4 bf16 operands and
    # writes one (96 bytes); 1 MiB of fp32 read and written 8 times; C
    # read once (32 bytes); no collective with one member.
    w = work.battery_work(1, 4, 1, 16)
    assert w["bf16_flops"] == 8 * 2 * 4**3
    assert w["bytes"] == 8 * 96 + 8 * 2 * (1 << 20) + 32


def test_battery_work_adds_the_collectives_per_member():
    one = work.battery_work(1, 4, 1, 16)
    two = work.battery_work(2, 4, 1, 16)
    # 4 rounds reading and writing 16 fp32 a member, and one ring value.
    assert two["bytes"] == 2 * (one["bytes"] + 4 * 2 * 16 * 4 + 2 * 4)
    assert two["bf16_flops"] == 2 * one["bf16_flops"]


def test_production_battery_is_bound_by_bytes():
    w = work.battery_work(8, 4096, 1024, 1 << 20)
    peak = work.H100_SXM
    t = work.least_time_s(w, peak)
    assert t == pytest.approx(w["bytes"] / 3.35e12)
    assert 0.040 < t < 0.050  # about 5.7 ms a member


def test_deep_probe_work_by_hand():
    w = work.deep_probe_work(2)
    s, bhd = 256, 4 * 64
    assert w["bf16_flops"] == 3 * 2 * 2 * bhd * s * s / 2
    assert w["bytes"] == 3 * 4 * s * bhd * 4
    assert work.deep_probe_work(1) == {"bf16_flops": 0.0, "bytes": 0.0}


def test_canary_params_at_the_bench_width():
    assert work.canary_params(1024, 1024, 8, 4096) == 102_777_856


def test_canary_flops_by_hand_and_as_the_port_counts_them():
    from k8s_operator_libs_tpu_torch.workloads.canary import (
        CanaryConfig,
        CanaryRunner,
    )

    cfg = dict(vocab=16, d_model=8, n_heads=2, n_layers=1, d_ff=32,
               seq_len=4, batch=2)
    n = 16 * 8 + (3 * 64 + 64 + 2 * 8 * 32 + 16) + 8 + 8 * 16
    want = 6.0 * n * 8 + 12.0 * 1 * 2 * 16 * 8
    assert work.canary_flops_per_step(**cfg) == want
    runner = CanaryRunner(CanaryConfig(**cfg), device="cpu")
    assert runner.flops_per_step() == want


def test_peaks_only_for_the_cards_in_the_table():
    assert work.peaks("NVIDIA H100 80GB HBM3") is work.H100_SXM
    assert work.peaks("NVIDIA H100 PCIe") is None
    assert work.peaks("cpu") is None
