"""The node's two container entry points, started as their DaemonSets
start them: from a kubeconfig, with no service-account token.

The agent's ``main`` takes its client from the port's
``k8s.get_default_client()``, as the reference's does: the in-cluster
config, else the kubeconfig (fault 3e: it used to build a one-call
in-cluster annotator and raised outside a cluster).  The processes' cases
run ``chip_smoke.py`` phase 19's rig on the CPU: the agent with no device
and the safe-load init container (the healthy agent needs the card).
"""

from __future__ import annotations

import pytest
import torch

from k8s_operator_libs_tpu_torch.bench_fleet import ClusterFixture
from k8s_operator_libs_tpu_torch.health import agent as agent_mod
from k8s_operator_libs_tpu_torch.health.report import HealthReport
from k8s_operator_libs_tpu_torch.k8s import FakeCluster, KubeApiServer
from k8s_operator_libs_tpu_torch.keys import driver_keys

import chip_smoke

NODE = "gpu-node-0"


@pytest.fixture()
def api_server(tmp_path, monkeypatch):
    """A ``KubeApiServer`` over a store holding ``NODE``, reached through
    ``KUBECONFIG`` alone."""
    store = FakeCluster()
    ClusterFixture(store, driver_keys()).node(NODE)
    with KubeApiServer(store) as server:
        monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
        monkeypatch.delenv("DRIVER_NAME", raising=False)
        monkeypatch.setenv("KUBECONFIG", str(chip_smoke.write_kubeconfig(
            tmp_path / "kubeconfig", server.host)))
        monkeypatch.setenv("NODE_NAME", NODE)
        yield store


def test_the_agent_starts_from_a_kubeconfig(api_server, monkeypatch):
    """Fault 3e's pin: with no service-account token and a kubeconfig
    set, ``main()`` publishes its report under the driver's keys."""
    monkeypatch.setenv("DRIVER_REVISION", "rev-3e")

    class OneShotAgent(agent_mod.HealthAgent):
        def __init__(self, client, node_name, **kw):
            kw.update(devices=[torch.device("cpu")], matmul_n=64,
                      hbm_mib=1, allreduce_elems=64)
            super().__init__(client, node_name, **kw)

        def run_once(self):
            super().run_once()
            raise KeyboardInterrupt  # one publish, then out of the loop

    monkeypatch.setattr(agent_mod, "HealthAgent", OneShotAgent)
    with pytest.raises(KeyboardInterrupt):
        agent_mod.main()
    raw = api_server.get_node(NODE, cached=False).annotations[
        driver_keys().health_report_annotation]
    report = HealthReport.from_json(raw)
    assert report.node_name == NODE
    assert report.driver_revision == "rev-3e"
    assert report.visible_devices == 1


# -- the containers as processes (chip_smoke.py phase 19's rig) --------------


def test_the_agent_process_with_no_device_publishes_unhealthy(tmp_path):
    """``python -m …health.agent`` from a kubeconfig with no CUDA device
    visible: it publishes an unhealthy report with 0 devices and the
    enumeration's failure, is still running when it lands, and exits 0
    at its termination with its launches, none."""
    with chip_smoke.NodeEntryPoints(tmp_path) as node:
        rec = node.agent("agent with no device",
                         HEALTH_PROBE_INTERVAL_S="3600",
                         CUDA_VISIBLE_DEVICES="")
    chip_smoke.no_device_report(rec)
    assert rec["report"].node_name == chip_smoke.ENTRY_NODE
    assert set(rec["launches"]) == {
        "stream_increment_", "stream_increment_verify_", "verify_stats",
        "block_attention", "peer_reduce", "peer_gather",
        "block_attention_merge_"}


def test_the_safe_load_process_waits_for_its_release(tmp_path):
    """``python -m …driver.safe_load_init`` from a kubeconfig announces
    itself under the driver's keys, waits, and exits 0 once the
    annotation is removed."""
    with chip_smoke.NodeEntryPoints(tmp_path) as node:
        assert node.keys == driver_keys()
        rec = node.safe_load()
    assert rec["exit_s"] < chip_smoke.SAFE_LOAD_EXIT_S
    assert driver_keys().safe_load_annotation not in node.annotations()
