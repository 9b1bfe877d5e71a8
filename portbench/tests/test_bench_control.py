"""The control: the reference computed in fp8 (e4m3), the precision below
the configurations' bf16, put in the program's place, has to come out as
not correct.  On the CPU at a size a test run holds; on the card (marked
``cuda``) at the cells' own sizes, on three seeds."""

import json

import pytest
import torch

import run
from harness import roll
from harness.gate import DEEP_SHAPE, ref_attention_seq
from reference import attention as ref_attention
from reference import battery as ref_battery

NODE = run.load_json(run.HERE / "configs" / "hgx-h100-node.json")
POOL = run.load_json(run.HERE / "configs" / "gpu-operator-pool4.json")
SMALL_CANARY = {**POOL["canary"], "vocab": 64, "d_model": 32, "n_heads": 4,
                "n_layers": 2, "d_ff": 64, "seq_len": 16, "batch": 8}


def battery_control(n, mib, device):
    want = ref_battery.expected_rows(NODE["gpus"], n, mib, device)
    low = ref_battery.expected_rows(NODE["gpus"], n, mib, device, "fp8")
    gap = max(ref_battery.row_gap(a, w) for a, w in zip(low, want))
    return run.judge({"row_gap": gap}, NODE["limits"])


def canary_control(c, seed, device):
    ref = roll.reference_training(c, seed, device, "bf16")
    low = roll.reference_training(c, seed, device, "fp8")
    checks = roll.training_checks(low["losses"], low["first_grad"],
                                  low["change"], ref)
    return run.judge(checks, POOL["limits"])


def attention_control(members, device, seed=0):
    q, k, v = (t.to(device) for t in ref_attention.probe_inputs(
        ref_attention_seq(members), *DEEP_SHAPE, seed=seed))
    want = ref_attention.causal_attention(q, k, v, "bf16")
    low = ref_attention.causal_attention(q, k, v, "fp8")
    return run.judge({"attention_gap": float((low - want).abs().max())},
                     NODE["limits"])


def test_battery_control_fails_on_the_cpu():
    correct, checks = battery_control(1024, 1, torch.device("cpu"))
    assert correct is False, checks


@pytest.mark.parametrize("seed", [2**31 + 1, 2**31 + 2, 2**31 + 3])
def test_canary_control_fails_on_the_cpu(seed):
    correct, checks = canary_control(SMALL_CANARY, seed, torch.device("cpu"))
    assert correct is False, checks


def test_attention_control_fails_on_the_cpu():
    correct, checks = attention_control(2, torch.device("cpu"))
    assert correct is False, checks


@pytest.mark.cuda
def test_battery_control_fails_at_the_cells_size(card):
    b = NODE["battery"]
    correct, checks = battery_control(b["matmul_n"], b["hbm_mib"], card)
    assert correct is False, checks


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [3_100_000_001, 3_100_000_002,
                                  3_100_000_003])
def test_canary_control_fails_at_the_cells_size(card, seed):
    correct, checks = canary_control(POOL["canary"], seed, card)
    print(json.dumps(checks))
    assert correct is False, checks


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_attention_control_fails_at_the_cells_size(card, seed):
    correct, checks = attention_control(NODE["gpus"], card, seed)
    print(json.dumps(checks))
    assert correct is False, checks
