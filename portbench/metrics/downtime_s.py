"""The training job's interruption per roll: the longest gap between
its steps in each roll, averaged over the rolls of the window in which
its node went out of service.  A roll still open at the window's end
counts its open gap while the job's node is out."""

import numpy as np


def read(run):
    w0, w1 = run.window
    steps = sorted(run.facts.get("canary_steps", ()))
    out = []
    for r in run.facts.get("rolls", ()):
        if not r["canary_out"] or r["start"] > w1:
            continue
        end = r["end"] if r["end"] is not None and r["end"] <= w1 else w1
        gap, prev = 0.0, None
        for t in steps:
            if t > end:
                break
            if prev is not None and t > r["start"]:
                # Nothing before the window counts: set-up is not a roll.
                gap = max(gap, t - max(prev, w0))
            prev = t
        if (r["end"] is None or r["end"] > w1) and prev is not None:
            gap = max(gap, end - prev)
        out.append(gap)
    return float(np.mean(out)) if out else None
