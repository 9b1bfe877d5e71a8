"""Tokens the training job trained in the window over the window:
pauses, waits on the card and contention all count."""

from harness.readers import window_steps


def read(run):
    steps = window_steps(run)
    if not steps:
        return None
    return len(steps) * run.facts["tokens_per_step"] / run.seconds
