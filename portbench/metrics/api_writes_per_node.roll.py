"""API writes (patch, create, update, delete, evict) in the window over
the nodes that reached upgrade-done in it; the window closes at the end of
the roll open at the deadline, as for ``nodes_per_min``."""


def read(run):
    done = run.facts.get("nodes_done", 0)
    return run.facts["api_writes"] / done if done else None
