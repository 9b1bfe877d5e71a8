"""The program's own layer spans and counters, laid into a run.

The port records spans and counters inside its layers when a caller
turns them on (``k8s_operator_libs_tpu_torch.layers``).  :func:`start`
turns them on; :func:`collect` takes what they recorded into the run:
each closed span under its dotted name in ``run.spans``, in
``time.perf_counter`` seconds like the harness's own spans, the records
themselves in ``run.facts["program_spans"]`` and the counters in
``run.facts["program_counters"]``.  Harness spans have plain names
(``battery``, ``publish``), program spans dotted ones (``battery.fused``),
so no reader of the one sees the other.  A port without layer spans
gives nothing, and its readers None.
"""

from __future__ import annotations


def _layers():
    try:
        from k8s_operator_libs_tpu_torch import layers
    except ImportError:
        return None
    return layers


def start() -> None:
    """Turn the program's layer recording on."""
    layers = _layers()
    if layers is not None:
        layers.record_layers(True)


def stop() -> None:
    """Turn it off; what it recorded stays for :func:`collect`."""
    layers = _layers()
    if layers is not None:
        layers.record_layers(False)


def collect(run) -> None:
    """Turn it off and lay what it recorded into ``run``."""
    layers = _layers()
    if layers is None:
        return
    layers.record_layers(False)
    spans, counters = layers.take_layers()
    for name, start_ns, end_ns, *_ in spans:
        if end_ns is not None:
            run.spans[name].append((start_ns / 1e9, end_ns / 1e9))
    run.facts["program_spans"] = spans
    run.facts["program_counters"] = counters
