"""Device time of K4 and K5 (peer_reduce, peer_gather) per gate, from the
profiler's trace."""

from harness.readers import collective_ms_per_gate


def read(run):
    return collective_ms_per_gate(run)
