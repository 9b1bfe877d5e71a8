"""Nodes that reached upgrade-done in the window, per minute of it.  The
window closes for this pace as for dispatched work: the roll open at the
deadline is waited for, and its nodes and its wait count."""


def read(run):
    done = run.facts.get("nodes_done", 0)
    return done / (run.facts["pace_s"] / 60.0) if done else None
