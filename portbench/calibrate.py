"""The readings the comparison's limits are set from, on the card at the
cells' own sizes.

    python3 portbench/calibrate.py canary --seeds 12 --first 3000000001
    python3 portbench/calibrate.py attention --seeds 12
    python3 portbench/calibrate.py battery

Each prints one JSON line a seed (or one in all) with the program's
readings against the reference and the control's: the reference computed
in fp8 (e4m3) put in the program's place.  ``canary`` also reads a
planted fault, half of each batch left out, in the reference put in the
program's place.  The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent))


def canary(seeds: list, device) -> None:
    import torch

    from harness import roll
    from reference import canary as ref_canary

    c = json.loads((HERE / "configs" / "gpu-operator-pool4.json")
                   .read_text())["canary"]
    warm = json.loads((HERE / "traffic" / "roll.json")
                      .read_text())["canary_warm_steps"]
    for seed in seeds:
        runner, weights = roll.canary_runner(c, seed, device)
        prec = roll.warm_up(runner, warm)
        first = roll.FirstSteps(runner, weights, float(c["adam_b1"]))
        for _ in range(3):
            first.step()
        del runner, weights
        torch.cuda.empty_cache()
        ref = roll.reference_training(c, seed, device, "bf16", skip=warm)
        out = {"seed": seed, "precision": prec,
               "program": roll.training_checks(first.losses, first.grad,
                                               first.change, ref)}
        del first
        low = roll.reference_training(c, seed, device, "fp8", skip=warm)
        out["control_fp8"] = roll.training_checks(
            low["losses"], low["first_grad"], low["change"], ref)
        weights = roll.make_weights(c, roll.weight_seed(seed), device)
        feed = roll.Feed(c, roll.feed_seed(seed), device)
        half = [feed()[: c["batch"] // 2] for _ in range(warm + 3)][warm:]
        hb = ref_canary.train(weights, half, c, "bf16")
        out["fault_half_batch"] = roll.training_checks(
            hb["losses"], hb["first_grad"], hb["change"], ref)
        del weights, half
        print(json.dumps(out), flush=True)


def attention(seeds: list, device) -> None:
    import torch

    from harness.gate import DEEP_SHAPE, ref_attention_seq
    from k8s_operator_libs_tpu_torch.workloads.ring_attention import (
        make_ring_attention,
    )
    from reference import attention as ref_attention

    members = 8
    seq = ref_attention_seq(members)
    fn, shard = make_ring_attention([device] * members)
    for seed in [0] + seeds:
        q, k, v = ref_attention.probe_inputs(seq, *DEEP_SHAPE, seed=seed)
        out = torch.cat(fn(shard(q), shard(k), shard(v)), dim=1)
        q, k, v = (t.to(device) for t in (q, k, v))
        want = ref_attention.causal_attention(q, k, v, "bf16")
        low = ref_attention.causal_attention(q, k, v, "fp8")
        print(json.dumps({
            "inputs_seed": seed,
            "program": float((out - want).abs().max()),
            "control_fp8": float((low - want).abs().max()),
        }), flush=True)


def battery(device) -> None:
    from reference import battery as ref_battery

    cfg = json.loads((HERE / "configs" / "hgx-h100-node.json").read_text())
    b = cfg["battery"]
    want = ref_battery.expected_rows(cfg["gpus"], b["matmul_n"], b["hbm_mib"],
                                     device)
    low = ref_battery.expected_rows(cfg["gpus"], b["matmul_n"], b["hbm_mib"],
                                    device, precision="fp8")
    print(json.dumps({
        "control_fp8_row_gap": max(ref_battery.row_gap(a, w)
                                   for a, w in zip(low, want)),
        "rows": want[0], "control_rows": low[0]}), flush=True)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("what", choices=("canary", "attention", "battery"))
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--first", type=int, default=3_000_000_001)
    args = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    seeds = [args.first + i for i in range(args.seeds)]
    if args.what == "canary":
        canary(seeds, device)
    elif args.what == "attention":
        attention(seeds, device)
    else:
        battery(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
