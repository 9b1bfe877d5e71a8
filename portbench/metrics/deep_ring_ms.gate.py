"""The mean of the program's ``deep.ring`` span: one ``ring_attention``
call's host time (a deep probe makes two)."""

from harness.readers import mean_span_ms


def read(run):
    return mean_span_ms(run, "deep.ring")
