"""The JAX package's ``tests/test_advice_r1.py`` against the port (drain
poll intervals, eviction rejections, the agent's unhealthy report, the
slice timer).

``port_module`` runs the file's source with the package prefix rewritten
on the port's fixtures, with its own ``eviction_client`` fixture.  Its
agent cases get the port's CPU device through ``cpu_devices``.  One case
departs (``DEPARTURES``): it breaks the reference's device enumeration
by patching the agent module's ``jax``, which the port's agent does not
import; its mirror breaks the port's enumeration, ``torch.cuda``.
"""

from __future__ import annotations

import torch

from k8s_operator_libs_tpu_torch.bench_fleet import ClusterFixture
from k8s_operator_libs_tpu_torch.health import agent as agent_mod
from k8s_operator_libs_tpu_torch.health.probes import CheckResult
from k8s_operator_libs_tpu_torch.k8s import FakeCluster
from k8s_operator_libs_tpu_torch.keys import driver_keys
from tests.test_torch_control_plane import (  # noqa: F401
    departed,
    port_cpu_devices,
    port_module,
    port_tests,
    unmirrored,
)

# Reference cases that cannot hold on the port, each with its reason and
# the port case that mirrors it.
DEPARTURES = {
    "test_agent_reports_zero_devices_when_backend_broken": (
        "it patches agent.jax.devices; the port's agent enumerates CUDA "
        "devices through torch and imports no jax",
        "test_agent_reports_zero_devices_when_cuda_broken",
    ),
}

globals().update(departed(port_tests(port_module("test_advice_r1.py")),
                          DEPARTURES))


def test_every_departure_has_its_mirror():
    assert unmirrored(DEPARTURES, globals()) == []


def test_agent_reports_zero_devices_when_cuda_broken(monkeypatch):
    """With the battery's enumeration failing and ``torch.cuda`` raising
    on a second enumeration, ``run_once`` publishes an unhealthy report
    with ``visible_devices == 0`` and the enumeration's detail."""
    keys = driver_keys()

    def broken_probe(*args, **kwargs):
        return [CheckResult("device_enumeration", False, 0.0,
                            "device enumeration failed: no CUDA device")]

    def exploding_count(*args, **kwargs):
        raise RuntimeError("CUDA driver initialization failed")

    monkeypatch.setattr(agent_mod, "run_host_probe", broken_probe)
    monkeypatch.setattr(torch.cuda, "device_count", exploding_count)
    cluster = FakeCluster()
    ClusterFixture(cluster, keys).node("host-0")
    report = agent_mod.HealthAgent(cluster, "host-0", keys,
                                   driver_revision="v2").run_once()
    assert report.visible_devices == 0
    assert not report.healthy
    raw = cluster.get_node("host-0", cached=False).annotations[
        keys.health_report_annotation]
    assert "device enumeration failed" in raw
