"""The port's copy of the upgrade engine, held to the JAX package's.

The port carries the engine's jax-free closure (the control plane:
``k8s/``, ``api/``, ``upgrade/``, ``planning/``, ``obs/`` and the rest)
as its own modules, with the package prefix rewritten.  Each copy must
stay the reference's code: its AST, docstrings stripped and the prefix
rewritten, must equal the reference's.  Then both engines roll the same
fleets behind the same scripted prober verdicts (the two scenarios of
``test_e2e_rolling_upgrade.py`` and four GPU-labelled nodes with no
slice) and must walk every node through the same states.
"""

from __future__ import annotations

import ast
import linecache
import re
import sys
import types
from pathlib import Path
from typing import Optional

import pytest
import torch
from _pytest.fixtures import getfixturemarker

import k8s_operator_libs_tpu as jpkg
import k8s_operator_libs_tpu_torch as tpkg
from k8s_operator_libs_tpu import api as japi
from k8s_operator_libs_tpu import k8s as jk8s
from k8s_operator_libs_tpu import upgrade as jup
from k8s_operator_libs_tpu_torch import api as tapi
from k8s_operator_libs_tpu_torch import bench_fleet
from k8s_operator_libs_tpu_torch import k8s as tk8s
from k8s_operator_libs_tpu_torch import upgrade as tup

ROOT = Path(__file__).resolve().parents[1]
REF = Path(jpkg.__file__).resolve().parent
PORT = Path(tpkg.__file__).resolve().parent
PREFIX = re.compile(r"\bk8s_operator_libs_tpu\b")

# Every module of the engine's closure that the port copies.  The
# closure's accelerator-side modules (hw.py, fleet/profiles.py,
# artifacts/gates.py) and the package's __init__ are the port's own.  The
# last is the repository's consumer example, which embeds the engine.
COPIED = (
    "consts.py",
    "api/__init__.py", "api/schema.py", "api/v1alpha1.py",
    "artifacts/__init__.py", "artifacts/dag.py",
    "driver/__init__.py",
    "fleet/__init__.py", "fleet/windows.py",
    "k8s/__init__.py", "k8s/apiserver.py", "k8s/client.py", "k8s/drain.py",
    "k8s/faults.py", "k8s/informer.py", "k8s/interface.py", "k8s/leader.py",
    "k8s/objects.py", "k8s/rest.py", "k8s/retry.py", "k8s/selectors.py",
    "k8s/writeplan.py",
    "topology/__init__.py", "topology/slices.py",
    "obs/__init__.py", "obs/baseline.py", "obs/critical.py",
    "obs/flightrec.py", "obs/trace.py",
    "planning/__init__.py", "planning/clocks.py", "planning/drift.py",
    "planning/twin.py",
    "upgrade/__init__.py", "upgrade/consts.py", "upgrade/types.py",
    "upgrade/util.py", "upgrade/node_state_provider.py",
    "upgrade/cordon_manager.py", "upgrade/drain_manager.py",
    "upgrade/pod_manager.py", "upgrade/validation_manager.py",
    "upgrade/safe_driver_load_manager.py", "upgrade/stuck.py",
    "upgrade/durable.py", "upgrade/matview.py",
    "coordination/protocol.py", "coordination/elastic.py",
    "coordination/workload.py", "coordination/__init__.py",
    "federation/registry.py", "federation/ledger.py", "federation/plan.py",
    "federation/canary.py", "federation/coordinator.py",
    "federation/__init__.py",
    "examples/consumer_operator.py",
)

_P = "k8s_operator_libs_tpu_torch"

# What the port's manifests.py adds after the reference's code: its
# command line, which is the port's own module.
_MANIFESTS_MAIN = f'''

if __name__ == "__main__":
    from {_P}.manifests_cli import main

    raise SystemExit(main())
'''

# The port's own copies: each is the reference's module with the prefix
# rewritten and these (reference snippet, port snippet) substitutions
# made, nothing else.  The engine's modules read a group's or a node's
# accelerator through ``fleet.profiles`` (``group_accelerator``,
# ``node_accelerator``), where a GPU node without a slice has its GPU
# Feature Discovery label, and a group's DCN ring the same way
# (``group_dcn_group``: a GPU node's ring label or JobSet); the
# reference reads the slice's alone.
OWN_COPIES: dict[str, list[tuple[str, str]]] = {
    "fleet/scheduler.py": [
        (
            f"from {_P}.fleet.profiles import generation_profile\n",
            f"from {_P}.fleet.profiles import (\n"
            "    generation_profile,\n"
            "    group_accelerator,\n"
            ")\n",
        ),
        (
            '    accelerator = ""\n'
            "    if group.slice_info is not None:\n"
            '        accelerator = group.slice_info.accelerator or ""\n'
            "    return generation_order_key(accelerator) + (group.id,)\n",
            "    return generation_order_key(group_accelerator(group)) + (group.id,)\n",
        ),
        (
            '    accelerator = ""\n'
            "    if group.slice_info is not None:\n"
            '        accelerator = group.slice_info.accelerator or ""\n'
            "    return generation_order_key(accelerator) + (-cost, group.id)\n",
            "    return generation_order_key(group_accelerator(group)) + (\n"
            "        -cost, group.id,\n"
            "    )\n",
        ),
    ],
    "upgrade/upgrade_state.py": [
        (
            f"from {_P}.fleet.profiles import generation_of\n",
            f"from {_P}.fleet.profiles import (\n"
            "    generation_of,\n"
            "    group_accelerator,\n"
            "    group_dcn_group,\n"
            ")\n",
        ),
        (
            "                    gen = (\n"
            "                        generation_of(group.slice_info.accelerator)\n"
            "                        if group.slice_info is not None\n"
            '                        else ""\n'
            '                    ) or "unknown"\n',
            "                    gen = (\n"
            "                        generation_of(group_accelerator(group))\n"
            '                        or "unknown"\n'
            "                    )\n",
        ),
        # A group's DCN ring: the in-flight rings, the
        # admission's deferral, its ledger claim and busy set, and the
        # rejoin's claim.
        (
            "        for group in state.all_groups():\n"
            "            if group.slice_info is None or "
            "group.slice_info.dcn_group is None:\n"
            "                continue\n"
            "            eff = group.effective_state(self.keys.state_label)\n"
            "            if eff in IN_PROGRESS_STATES or "
            "self._group_unavailable(group):\n"
            "                in_flight.add(group.slice_info.dcn_group)\n",
            "        for group in state.all_groups():\n"
            "            ring = group_dcn_group(group, self.keys)\n"
            "            if ring is None:\n"
            "                continue\n"
            "            eff = group.effective_state(self.keys.state_label)\n"
            "            if eff in IN_PROGRESS_STATES or "
            "self._group_unavailable(group):\n"
            "                in_flight.add(ring)\n",
        ),
        (
            "            if (\n"
            "                dcn_anti_affinity\n"
            "                and group.slice_info is not None\n"
            "                and group.slice_info.dcn_group is not None\n"
            "                and group.slice_info.dcn_group in busy_dcn\n"
            "            ):\n"
            "                logger.info(\n"
            '                    "slice %s deferred: another slice of DCN '
            'group %s is in "\n'
            '                    "flight (dcn_anti_affinity)",\n'
            "                    group.id,\n"
            "                    group.slice_info.dcn_group,\n"
            "                )\n",
            "            ring = group_dcn_group(group, self.keys)\n"
            "            if dcn_anti_affinity and ring is not None and ring "
            "in busy_dcn:\n"
            "                logger.info(\n"
            '                    "slice %s deferred: another slice of DCN '
            'group %s is in "\n'
            '                    "flight (dcn_anti_affinity)",\n'
            "                    group.id,\n"
            "                    ring,\n"
            "                )\n",
        ),
        (
            "                dcn = (\n"
            "                    group.slice_info.dcn_group\n"
            "                    if dcn_anti_affinity\n"
            "                    and group.slice_info is not None\n"
            "                    and group.slice_info.dcn_group is not None\n"
            "                    else None\n"
            "                )\n",
            "                dcn = ring if dcn_anti_affinity else None\n",
        ),
        (
            "            if (\n"
            "                group.slice_info is not None\n"
            "                and group.slice_info.dcn_group is not None\n"
            "            ):\n"
            "                busy_dcn.add(group.slice_info.dcn_group)\n",
            "            if ring is not None:\n"
            "                busy_dcn.add(ring)\n",
        ),
        (
            "                group.slice_info.dcn_group\n"
            "                if isinstance(policy, TPUUpgradePolicySpec)\n"
            "                and policy.dcn_anti_affinity\n"
            "                and group.slice_info is not None\n"
            "                else None\n",
            "                group_dcn_group(group, self.keys)\n"
            "                if isinstance(policy, TPUUpgradePolicySpec)\n"
            "                and policy.dcn_anti_affinity\n"
            "                else None\n",
        ),
    ],
    "upgrade/sharded.py": [
        (
            f"from {_P}.fleet.scheduler import pool_sort_key\n",
            f"from {_P}.fleet.profiles import (\n"
            "    group_accelerator,\n"
            "    group_dcn_group,\n"
            ")\n"
            f"from {_P}.fleet.scheduler import pool_sort_key\n",
        ),
        (
            "                if (\n"
            "                    dcn_anti_affinity\n"
            "                    and group.slice_info is not None\n"
            "                    and group.slice_info.dcn_group is not None\n"
            "                ):\n"
            "                    dcn_of[group.id] = group.slice_info.dcn_group\n",
            "                ring = group_dcn_group(group, manager.keys)\n"
            "                if dcn_anti_affinity and ring is not None:\n"
            "                    dcn_of[group.id] = ring\n",
        ),
        (
            "            accel = (\n"
            "                group.slice_info.accelerator\n"
            "                if group.slice_info is not None\n"
            '                else ""\n'
            "            )\n",
            "            accel = group_accelerator(group)\n",
        ),
    ],
    "planning/planner.py": [
        (
            f"from {_P}.fleet.scheduler import (\n",
            f"from {_P}.fleet.profiles import (\n"
            "    group_accelerator,\n"
            "    group_dcn_group,\n"
            ")\n"
            f"from {_P}.fleet.scheduler import (\n",
        ),
        (
            "            dcn = (\n"
            "                group.slice_info.dcn_group\n"
            "                if group.slice_info is not None\n"
            "                else None\n"
            "            )\n"
            "            if dcn:\n",
            "            dcn = group_dcn_group(group, manager.keys)\n"
            "            if dcn:\n",
        ),
        (
            "            dcn = (\n"
            "                group.slice_info.dcn_group\n"
            "                if group.slice_info is not None\n"
            "                else None\n"
            "            )\n"
            "            dcn_gate = ",
            "            dcn = group_dcn_group(group, manager.keys)\n"
            "            dcn_gate = ",
        ),
        (
            "            accelerator = (\n"
            "                group.slice_info.accelerator\n"
            "                if group.slice_info is not None\n"
            '                else ""\n'
            "            )\n",
            "            accelerator = group_accelerator(group)\n",
        ),
    ],
    # The operator's own loop.  The driver's keys and names are the NVIDIA
    # GPU operator's (``keys.py``), where the reference's are libtpu's.
    "driver/safe_load_init.py": [
        (
            f"from {_P}.upgrade.util import UpgradeKeys\n",
            f"from {_P}.keys import driver_keys, keys_from_env\n"
            f"from {_P}.upgrade.util import UpgradeKeys\n",
        ),
        ("    keys = keys or UpgradeKeys()\n", "    keys = keys or driver_keys()\n"),
        (
            "    keys = UpgradeKeys(\n"
            '        driver_name=os.environ.get("DRIVER_NAME", "libtpu")\n'
            "    )\n",
            "    keys = keys_from_env()\n",
        ),
    ],
    "metrics.py": [
        (
            f"            from {_P}.fleet.profiles import generation_of\n",
            f"            from {_P}.fleet.profiles import (\n"
            "                generation_of,\n"
            "                group_accelerator,\n"
            "            )\n",
        ),
        (
            "                    accel = getattr(\n"
            '                        getattr(group, "slice_info", None), '
            '"accelerator", ""\n'
            "                    )\n"
            '                    gen = generation_of(accel or "") or "unknown"\n',
            "                    gen = (\n"
            "                        generation_of(group_accelerator(group))\n"
            '                        or "unknown"\n'
            "                    )\n",
        ),
    ],
    "controller.py": [
        (
            f"from {_P}.k8s.retry import CircuitOpenError\n",
            f"from {_P}.k8s.retry import CircuitOpenError\n"
            f"from {_P}.keys import (\n"
            "    CONTROLLER_NAME,\n"
            "    DEFAULT_DRIVER_NAME,\n"
            "    DRIVER_DAEMONSET_NAME,\n"
            "    DRIVER_LABELS,\n"
            "    driver_keys,\n"
            ")\n",
        ),
        (
            "    EventRecorder,\n    UpgradeKeys,\n    log_event,\n",
            "    EventRecorder,\n    log_event,\n",
        ),
        (
            '        default_factory=lambda: {"app": "libtpu-driver"}\n'
            "    )\n"
            '    driver_name: str = "libtpu"\n',
            "        default_factory=lambda: dict(DRIVER_LABELS)\n"
            "    )\n"
            "    driver_name: str = DEFAULT_DRIVER_NAME\n",
        ),
        (
            '    lease_name: str = "tpu-upgrade-controller"\n',
            "    lease_name: str = CONTROLLER_NAME\n",
        ),
        (
            "        self.keys = UpgradeKeys(driver_name=config.driver_name)\n",
            "        self.keys = driver_keys(config.driver_name)\n",
        ),
        (
            '        default="app=libtpu-driver",\n',
            '        default=f"app={DRIVER_DAEMONSET_NAME}",\n',
        ),
        (
            '    parser.add_argument("--driver-name", default="libtpu")\n',
            '    parser.add_argument("--driver-name", default=DEFAULT_DRIVER_NAME)\n',
        ),
        (
            '        help="also reconcile the libtpu device-plugin DaemonSet",\n',
            '        help="also reconcile the NVIDIA driver DaemonSet",\n',
        ),
        (
            '        default="tpu-upgrade-controller",\n'
            '        help="Lease object name for --leader-elect",\n',
            "        default=CONTROLLER_NAME,\n"
            '        help="Lease object name for --leader-elect",\n',
        ),
    ],
    "status.py": [
        (
            f"from {_P}.upgrade.util import UpgradeKeys\n",
            f"from {_P}.fleet.profiles import (\n"
            "    group_accelerator,\n"
            "    group_dcn_group,\n"
            ")\n"
            f"from {_P}.keys import (\n"
            "    CONTROLLER_NAME,\n"
            "    DEFAULT_DRIVER_NAME,\n"
            "    DRIVER_DAEMONSET_NAME,\n"
            "    driver_keys,\n"
            ")\n"
            f"from {_P}.upgrade.util import UpgradeKeys\n",
        ),
        (
            '    lease_name: str = "tpu-upgrade-controller",\n',
            "    lease_name: str = CONTROLLER_NAME,\n",
        ),
        (
            "    keys = keys or UpgradeKeys()\n",
            "    keys = keys or driver_keys()\n",
        ),
        (
            '                "accelerator": (\n'
            '                    group.slice_info.accelerator if group.slice_info else ""\n'
            "                ),\n",
            '                "accelerator": group_accelerator(group),\n',
        ),
        (
            '                "dcn_group": (\n'
            "                    group.slice_info.dcn_group\n"
            "                    if group.slice_info and "
            "group.slice_info.dcn_group\n"
            '                    else ""\n'
            "                ),\n",
            '                "dcn_group": group_dcn_group(group, keys) or "",\n',
        ),
        (
            '        accel = group.slice_info.accelerator if group.slice_info else ""\n'
            '        gen = generation_of(accel) or "unknown"\n',
            '        gen = generation_of(group_accelerator(group)) or "unknown"\n',
        ),
        (
            '    parser.add_argument("--selector", default="app=libtpu-driver")\n'
            '    parser.add_argument("--driver-name", default="libtpu")\n',
            "    parser.add_argument(\n"
            '        "--selector", default=f"app={DRIVER_DAEMONSET_NAME}"\n'
            "    )\n"
            '    parser.add_argument("--driver-name", default=DEFAULT_DRIVER_NAME)\n',
        ),
        (
            '    parser.add_argument("--lease-name", default="tpu-upgrade-controller")\n',
            '    parser.add_argument("--lease-name", default=CONTROLLER_NAME)\n',
        ),
        (
            "        keys=UpgradeKeys(driver_name=args.driver_name),\n",
            "        keys=driver_keys(args.driver_name),\n",
        ),
    ],
    # The port renders and checks its own manifests (the reference's
    # are rendered by tools/gen_manifests.py into config/manifests/).
    "manifests.py": [
        (
            f"from {_P}.api.schema import POLICY_GROUP, POLICY_PLURAL\n",
            f"from {_P}.api.schema import POLICY_GROUP, POLICY_PLURAL\n"
            f"from {_P}.keys import (\n"
            "    CONTROLLER_NAME,\n"
            "    NODE_REPORTER_NAME,\n"
            "    OPERATOR_IMAGE,\n"
            ")\n",
        ),
        ('CONTROLLER_NAME = "tpu-upgrade-controller"\n', ""),
        (
            'NODE_REPORTER_NAME = "tpu-node-reporter"\n'
            'DEFAULT_IMAGE = "tpu-operator-libs:latest"\n',
            "DEFAULT_IMAGE = OPERATOR_IMAGE\n",
        ),
        (
            "            missing.append("
            "f\"{group or 'core'}/{resource}: needs one of {verbs}\")\n"
            "    return missing\n",
            "            missing.append("
            "f\"{group or 'core'}/{resource}: needs one of {verbs}\")\n"
            "    return missing\n" + _MANIFESTS_MAIN,
        ),
    ],
    "obs/telemetry.py": [
        (
            f"from {_P}.consts import get_logger\n",
            f"from {_P}.consts import get_logger\n"
            f"from {_P}.fleet.profiles import node_accelerator\n",
        ),
        (
            '            labels = getattr(node, "labels", None) or {}\n'
            '            gen = labels.get(_accelerator_label(), "")\n',
            "            gen = node_accelerator(node)\n",
        ),
        (
            "\n\ndef _accelerator_label() -> str:\n"
            f"    from {_P}.upgrade.consts import (\n"
            "        GKE_TPU_ACCELERATOR_LABEL,\n"
            "    )\n"
            "\n"
            "    return GKE_TPU_ACCELERATOR_LABEL\n",
            "",
        ),
    ],
}



def _spanned(method: str, span: str, how: str = "") -> tuple[str, str]:
    """The layer-span site that decorates ``method`` with ``span``."""
    return (f"\n    def {method}(",
            f'\n    @spanned("{span}"{how})\n    def {method}(')


_ENGINE_PROCESSORS = (
    "done_or_unknown_groups", "upgrade_required_groups",
    "cordon_required_groups", "wait_for_jobs_required_groups",
    "pod_deletion_required_groups", "drain_groups", "pod_restart_groups",
    "upgrade_failed_groups", "validation_required_groups",
    "uncordon_required_groups", "negotiation_groups", "rejoin_resize_groups",
    "preemption", "maintenance_windows", "quarantine",
)

# The port's layer spans (``layers.py``, a module of the port's own) at
# the engine's calls: each copy below is the reference's code with these
# (reference snippet, port snippet) sites added, and nothing else.
LAYER_SITES: dict[str, list[tuple[str, str]]] = {
    "k8s/client.py": [
        (
            f"from {_P}.k8s.selectors import (\n"
            "    matches_labels,\n"
            "    matches_selector,\n"
            ")\n",
            f"from {_P}.k8s.selectors import (\n"
            "    matches_labels,\n"
            "    matches_selector,\n"
            ")\n"
            f"from {_P}.layers import layer_span\n",
        ),
        (
            "    def _call(self, verb: str) -> None:\n"
            "        self.stats[verb] += 1\n"
            "        if self.api_latency_s > 0:\n"
            "            time.sleep(self.api_latency_s)\n"
            "        if self.fault_injector is not None:\n"
            "            self.fault_injector(verb)\n"
            "        if self.fault_schedule is not None:\n"
            "            self.fault_schedule.raise_for(verb)\n"
            "            # Data-plane faults (node NotReady/flap/delete,"
            " stuck pods,\n"
            "            # crash loops) mutate CLUSTER"
            " STATE rather than failing this\n"
            "            # call; API traffic is their"
            " clock, so both tiers (fake verbs\n"
            "            # and wire requests routed through"
            " this store) tick them.\n"
            "            self._apply_data_plane_faults(verb)\n",
            "    def _call(self, verb: str) -> None:\n"
            '        with layer_span("k8s", verb):\n'
            "            self.stats[verb] += 1\n"
            "            if self.api_latency_s > 0:\n"
            "                time.sleep(self.api_latency_s)\n"
            "            if self.fault_injector is not None:\n"
            "                self.fault_injector(verb)\n"
            "            if self.fault_schedule is not None:\n"
            "                self.fault_schedule.raise_for(verb)\n"
            "                self._apply_data_plane_faults(verb)\n",
        ),
    ],
    "k8s/drain.py": [
        (
            f"from {_P}.k8s.objects import Node, Pod\n",
            f"from {_P}.k8s.objects import Node, Pod\n"
            f"from {_P}.layers import count, layer_span, spanned\n",
        ),
        (
            "                issued.add(key)\n"
            "                pdb_blocked.discard(key)\n",
            "                issued.add(key)\n"
            '                count("drain.evictions")\n'
            "                pdb_blocked.discard(key)\n",
        ),
        (
            "            time.sleep(sleep_s)\n",
            '            with layer_span("drain.poll_sleep"):\n'
            "                time.sleep(sleep_s)\n",
        ),
        _spanned("run_node_drain", "drain.node"),
    ],
    "upgrade/upgrade_state.py": [
        (
            f"from {_P}.k8s.writeplan import WritePlan\n",
            f"from {_P}.k8s.writeplan import WritePlan\n"
            f"from {_P}.layers import count, spanned\n",
        ),
        _spanned("build_state", "engine.build_state",
                 ', opens="_layer_pass"'),
        (
            '        logger.info("building state")\n',
            '        logger.info("building state")\n'
            '        count("engine.passes")\n',
        ),
        _spanned("apply_state", "engine.apply_state",
                 ', joins="_layer_pass"'),
        _spanned("wait_for_async_work", "engine.async_wait",
                 ', joins="_layer_pass"'),
    ] + [
        _spanned(f"process_{p}", "engine." + p.removesuffix("_groups"))
        for p in _ENGINE_PROCESSORS
    ],
}


def _strip_docstrings(source: str) -> ast.Module:
    """``source`` parsed, without its module, class and function
    docstrings."""
    tree = ast.parse(source)
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                node.body = body[1:] or [ast.Pass()]
    return tree


def _code(source: str) -> str:
    """``ast.dump`` of ``source`` without its module, class and function
    docstrings."""
    return ast.dump(_strip_docstrings(source))


def _reference(module: str) -> str:
    """The reference's source of ``module`` with the prefix rewritten
    and its ``LAYER_SITES`` added: the package's, or for the consumer
    example the repository's ``examples/``."""
    top = ROOT if module.startswith("examples/") else REF
    source = PREFIX.sub(_P, (top / module).read_text())
    for ref_snippet, port_snippet in LAYER_SITES.get(module, ()):
        assert source.count(ref_snippet) == 1, (module, ref_snippet)
        source = source.replace(ref_snippet, port_snippet)
    return source


def _substituted(module: str) -> str:
    """The reference's ``module`` with its ``OWN_COPIES`` substitutions
    made; each reference snippet must occur exactly once."""
    source = _reference(module)
    for ref_snippet, port_snippet in OWN_COPIES[module]:
        assert source.count(ref_snippet) == 1, (module, ref_snippet)
        source = source.replace(ref_snippet, port_snippet)
    return source


@pytest.mark.parametrize("module", COPIED)
def test_copy_is_the_reference_code(module):
    assert _code((PORT / module).read_text()) == _code(_reference(module))


@pytest.mark.parametrize("module", sorted(OWN_COPIES))
def test_own_copy_is_the_reference_code_substituted(module):
    """An own copy is the reference's code but for its listed
    substitutions: made on the reference, they give the port's AST."""
    assert _code((PORT / module).read_text()) == _code(_substituted(module))


def test_the_copies_are_the_whole_closure():
    """Every module of the reference's engine closure and of its
    operator (controller, metrics, status, manifests, driver) is copied,
    an own copy, or one of the port's own modules: exactly one of
    these."""
    own = {"__init__.py", "hw.py", "fleet/profiles.py", "artifacts/gates.py",
           "keys.py", "driver/daemonset.py", "manifests_cli.py"}
    modules = ["controller.py", "metrics.py", "status.py", "manifests.py"]
    for package in ("api", "coordination", "driver", "federation", "k8s",
                    "obs", "planning", "topology", "upgrade"):
        modules += [str(p.relative_to(REF)) for p in (REF / package).glob("*.py")]
    for module in modules:
        kinds = (module in COPIED, module in OWN_COPIES, module in own)
        assert sum(kinds) == 1, (module, kinds)
    assert not own & (set(COPIED) | set(OWN_COPIES))
    assert not set(COPIED) & set(OWN_COPIES)
    assert all((PORT / m).is_file() for m in own)


# Public functions and classes of the reference without a port function
# or class of the same name, each with its counterpart elsewhere:
# ring_attention's shard_map body (the port's ring_attention drives every
# member from one process), hostenv's CPU env (the port's cpu_child_env)
# and its CPU pin (none, by design: see the port's hostenv).
UNPORTED_NAMES = {
    "workloads/ring_attention.py": {"ring_attention_sharded"},
    "hostenv.py": {"sanitized_cpu_env", "pin_current_process_to_cpu"},
}


def _public_defs(path: Path) -> set[str]:
    """The public functions and classes at the top of ``path``."""
    return {
        node.name for node in ast.parse(path.read_text()).body
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef))
        and not node.name.startswith("_")
    }


def _bound_names(path: Path) -> set[str]:
    """Every name ``path`` defines, assigns or imports, at any depth."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            names.add(node.id)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {a.asname or a.name.split(".")[0] for a in node.names}
    return names


def test_every_reference_module_has_its_counterpart():
    """Every module of the JAX package has a port module of the same
    path, and every public function and class of it a port function or
    class of the same name there, but for ``UNPORTED_NAMES``."""
    modules = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))
    assert len(modules) == 82
    assert [m for m in modules if not (PORT / m).is_file()] == []
    missing = {}
    for module in modules:
        lacking = _public_defs(REF / module) - _bound_names(PORT / module)
        if lacking:
            missing[module] = lacking
    assert missing == UNPORTED_NAMES


def port_module(test_file: str,
                modules: Optional[dict] = None,
                substitutions: tuple[tuple[str, str], ...] = (),
                ) -> types.ModuleType:
    """The reference's ``tests/<test_file>`` against the port: its source
    with the package prefix rewritten and ``tests.fixtures`` (if the file
    imports it: once at module level, and in any function body) replaced
    by the port's (``ENGINES``), executed as a module of its own.  ``modules`` maps another test module the file
    imports from (``"tests.test_chaos"``) to the port module that
    replaces it.  ``substitutions`` lists (reference, port) snippets of
    the rewritten source, each found exactly once, as ``OWN_COPIES`` does
    for a module: a test reads the port controller's keys this way."""
    fixtures = ENGINES["port"][3]
    sys.modules.setdefault(fixtures.__name__, fixtures)
    source = PREFIX.sub(_P, (ROOT / "tests" / test_file).read_text())
    # One module-level import of the fixtures, and any number inside a
    # function body (indented): all of them take the port's.
    assert len(re.findall(r"^from tests\.fixtures import", source,
                          re.MULTILINE)) <= 1, test_file
    source = source.replace(
        "from tests.fixtures import", f"from {fixtures.__name__} import"
    )
    for name, module in (modules or {}).items():
        assert f"from {name} import" in source, (test_file, name)
        source = source.replace(f"from {name} import",
                                f"from {module.__name__} import")
    for ref_snippet, port_snippet in substitutions:
        assert source.count(ref_snippet) == 1, (test_file, ref_snippet)
        source = source.replace(ref_snippet, port_snippet)
    name = f"_port_{Path(test_file).stem}"
    module = types.ModuleType(name)
    module.__file__ = str(ROOT / "tests" / test_file)
    sys.modules[name] = module
    filename = f"{Path(test_file).name}[port]"
    # A failure's traceback shows the lines the port ran.
    linecache.cache[filename] = (len(source), None,
                                 source.splitlines(True), filename)
    exec(compile(source, filename, "exec"), module.__dict__)
    return module


def port_keys(anchor: str) -> tuple[str, str]:
    """The ``port_module`` substitution that rebinds a reference test's
    ``UpgradeKeys`` to the port's ``keys.driver_keys`` just after
    ``anchor`` (a line of the rewritten source): the same driver name on
    the NVIDIA domain, the keys the port's ``UpgradeController`` writes.
    The controller's defaults stay the GPU operator's."""
    return anchor, (anchor
                    + f"from {_P}.keys import driver_keys as UpgradeKeys\n")


def port_tests(module: types.ModuleType) -> dict:
    """The tests of a ``port_module`` (its ``test_*`` functions and
    ``Test*`` classes) and the pytest fixtures it defines at module level
    (plain, parametrised or autouse), for a port test file to take into
    its globals: its cases then run on their own file's fixtures."""
    return {k: v for k, v in vars(module).items()
            if k.startswith(("test_", "Test"))
            or getfixturemarker(v) is not None}


def departed(tests: dict, departures: dict) -> dict:
    """``tests`` (a ``port_tests``) without the reference cases that
    ``departures`` names: a function by its name, a method as
    ``Class.method``, taken off its class (the class is the port
    module's own).  Each name must be found."""
    kept = dict(tests)
    for name in departures:
        cls, _, method = name.rpartition(".")
        if cls:
            assert method in vars(kept[cls]), name
            delattr(kept[cls], method)
        else:
            assert name in kept, name
            del kept[name]
    return kept


def unmirrored(departures: dict, namespace: dict) -> list:
    """The ``departures`` (name -> (reason, mirror)) whose reason is empty
    or whose mirror (``name`` or ``Class.method``) ``namespace`` lacks."""
    def found(name: str) -> bool:
        cls, _, method = name.rpartition(".")
        return (method in vars(namespace[cls]) if cls in namespace
                else not cls and name in namespace)

    return [name for name, (reason, mirror) in departures.items()
            if not (reason and found(mirror))]


@pytest.fixture(scope="session", name="cpu_devices")
def port_cpu_devices():
    """conftest's ``cpu_devices`` (JAX's 8 virtual CPU devices) for a
    ``port_module``'s cases that hand devices to the port's agent or
    battery: 8 members of the port's CPU device.  A port test file takes
    it by importing it."""
    return [torch.device("cpu")] * 8


_SOURCE = """from tests.fixtures import NAMESPACE
from k8s_operator_libs_tpu.upgrade import UpgradeKeys

KEYS = UpgradeKeys()
"""


@pytest.mark.parametrize("source, substitutions, refused", [
    (_SOURCE, (), False),
    # No fixtures import (tests/test_leader.py has none).
    (_SOURCE.split("\n", 1)[1], (), False),
    (_SOURCE + "from tests.fixtures import DRIVER_LABELS\n", (), True),
    # A second import inside a function body (tests/test_race.py's).
    (_SOURCE + "def f():\n    from tests.fixtures import make_node\n"
     "    return make_node\n", (), False),
    # Two inside functions as well, beside two at module level: refused.
    (_SOURCE + "from tests.fixtures import DRIVER_LABELS\n"
     "def f():\n    from tests.fixtures import make_node\n", (), True),
    (_SOURCE, (("KEYS = UpgradeKeys()", "KEYS = None"),), False),
    # A substitution is found exactly once, or refused.
    (_SOURCE, (("KEYS = UpgradeKey()", "KEYS = None"),), True),
    (_SOURCE + "KEYS = UpgradeKeys()\n",
     (("KEYS = UpgradeKeys()", "KEYS = None"),), True),
], ids=["one_fixtures_import", "none", "two_refused",
        "second_in_a_function", "two_at_module_level_refused", "substituted",
        "substitution_missing", "substitution_twice"])
def test_port_module_takes_a_file_and_its_substitutions(
        tmp_path, source, substitutions, refused):
    test_file = tmp_path / "test_example_port_module.py"
    test_file.write_text(source)
    if refused:
        with pytest.raises(AssertionError):
            port_module(str(test_file), substitutions=substitutions)
        return
    module = port_module(str(test_file), substitutions=substitutions)
    assert module.UpgradeKeys is tup.UpgradeKeys
    assert module.KEYS == (None if substitutions else tup.UpgradeKeys())
    if hasattr(module, "f"):
        assert module.f() is ENGINES["port"][3].make_node


_FIXTURES_SOURCE = """import pytest


@pytest.fixture()
def plain():
    return "plain"


@pytest.fixture(params=["fake", "rest"])
def tier(request):
    return request.param


@pytest.fixture(autouse=True)
def everywhere():
    yield


def helper():
    return 1


def test_one(plain, tier):
    pass


class TestTwo:
    def test_a(self):
        pass

    def test_b(self):
        pass
"""


def test_port_tests_takes_the_file_s_fixtures(tmp_path):
    """``port_tests`` takes the file's tests and every module-level
    pytest fixture (plain, parametrised, autouse), and nothing else."""
    test_file = tmp_path / "test_example_port_tests.py"
    test_file.write_text(_FIXTURES_SOURCE)
    taken = port_tests(port_module(str(test_file)))
    assert sorted(taken) == ["TestTwo", "everywhere", "plain", "test_one",
                             "tier"]
    assert getfixturemarker(taken["tier"]).params == ("fake", "rest")
    assert getfixturemarker(taken["everywhere"]).autouse


def test_departed_takes_cases_off_and_unmirrored_names_them(tmp_path):
    """``departed`` drops a function and a class's method, and refuses a
    name the file lacks; ``unmirrored`` names a departure whose mirror
    is missing or whose reason is empty."""
    test_file = tmp_path / "test_example_departed.py"
    test_file.write_text(_FIXTURES_SOURCE)
    taken = port_tests(port_module(str(test_file)))
    kept = departed(taken, {"test_one": (), "TestTwo.test_a": ()})
    assert "test_one" not in kept and "test_one" in taken
    assert [n for n in vars(kept["TestTwo"]) if n.startswith("test_")] == [
        "test_b"]
    for missing in ("test_three", "TestTwo.test_c"):
        with pytest.raises(AssertionError):
            departed(taken, {missing: ()})
    namespace = {"test_mirror": None, "TestTwo": kept["TestTwo"]}
    assert unmirrored({
        "a": ("reason", "test_mirror"),
        "b": ("reason", "TestTwo.test_b"),
        "c": ("reason", "test_absent"),
        "d": ("reason", "TestTwo.test_a"),
        "e": ("", "test_mirror"),
    }, namespace) == ["c", "d", "e"]


def test_port_keys_gives_a_test_the_controller_s_keys(tmp_path):
    """``port_keys`` rebinds ``UpgradeKeys`` after its anchor: the test
    reads the keys the port's controller writes, its driver name kept."""
    from k8s_operator_libs_tpu_torch.controller import (
        ControllerConfig,
        UpgradeController,
    )
    from k8s_operator_libs_tpu_torch.keys import driver_keys

    test_file = tmp_path / "test_example_port_keys.py"
    test_file.write_text(_SOURCE + 'OTHER = UpgradeKeys(driver_name="x")\n')
    module = port_module(str(test_file), substitutions=(port_keys(
        f"from {_P}.upgrade import UpgradeKeys\n"),))
    controller = UpgradeController(tk8s.FakeCluster(), ControllerConfig())
    assert module.KEYS == controller.keys == driver_keys()
    assert module.KEYS.state_label == "nvidia.com/gpu-driver-upgrade-state"
    assert module.OTHER == driver_keys("x")


# -- both engines on the same fleets ----------------------------------------


def _fixtures(package: str) -> types.ModuleType:
    """``tests/fixtures.py`` building objects of ``package``: for the
    port, the same source with the package prefix rewritten."""
    source = (ROOT / "tests" / "fixtures.py").read_text()
    if package != "k8s_operator_libs_tpu":
        source = PREFIX.sub(package, source)
    module = types.ModuleType(f"_fixtures_{package}")
    exec(compile(source, f"fixtures[{package}]", "exec"), module.__dict__)
    return module


# The port's fixtures are ``bench_fleet``, which begins with
# tests/fixtures.py's code (test_the_bench_fleet_begins_with_the_fixtures).
ENGINES = {
    "jax": (japi, jk8s, jup, _fixtures("k8s_operator_libs_tpu")),
    "port": (tapi, tk8s, tup, bench_fleet),
}


def _statements(source: str) -> list[str]:
    """``ast.dump`` of each top-level statement of ``source``, docstrings
    stripped."""
    return [ast.dump(s) for s in _strip_docstrings(source).body]


def test_the_bench_fleet_begins_with_the_fixtures():
    """``bench_fleet.py`` is ``tests/fixtures.py``'s code, the prefix
    rewritten, statement for statement, then the port's own part."""
    ref = _statements(PREFIX.sub(_P, (ROOT / "tests" / "fixtures.py")
                                 .read_text()))
    port = _statements((PORT / "bench_fleet.py").read_text())
    assert len(port) > len(ref)
    assert port[:len(ref)] == ref


class ScriptedProber:
    """Rejects each group's first probe, then passes: both engines see
    the same verdicts, the rejection included."""

    def __init__(self, upgrade) -> None:
        self.result = upgrade.ProbeResult
        self.calls: list[str] = []

    def probe(self, group):
        first = group.id not in self.calls
        self.calls.append(group.id)
        if first:
            return self.result(False, f"scripted rejection of {group.id}")
        return self.result(True, "scripted pass")


def _two_slices(fx, api):
    ds = fx.daemon_set(hash_suffix="h1", revision=1)
    nodes = fx.tpu_slice("pool-a", hosts=4) + fx.tpu_slice("pool-b", hosts=4)
    nodes.append(fx.node(name="plain-0"))
    for n in nodes:
        fx.driver_pod(n, ds, hash_suffix="h1")
        fx.workload_pod(n, labels={"app": "train"})
    policy = api.TPUUpgradePolicySpec(
        auto_upgrade=True,
        max_parallel_upgrades=1,
        max_unavailable=api.IntOrString("34%"),
        unavailability_unit="slice",
        pod_deletion=api.PodDeletionSpec(timeout_second=5),
        drain_spec=api.DrainSpec(enable=True, timeout_second=5),
        wait_for_completion=api.WaitForCompletionSpec(),
    )
    return ds, nodes, policy


def _node_unit(fx, api):
    ds = fx.daemon_set(hash_suffix="h1", revision=1)
    nodes = fx.tpu_slice("pool-a", hosts=2)
    for n in nodes:
        fx.driver_pod(n, ds, hash_suffix="h1")
    policy = api.TPUUpgradePolicySpec(
        auto_upgrade=True,
        max_parallel_upgrades=4,
        max_unavailable=api.IntOrString("100%"),
        unavailability_unit="node",
        drain_spec=api.DrainSpec(enable=True, timeout_second=5),
    )
    return ds, nodes, policy


def _gpu_nodes(fx, api):
    ds = fx.daemon_set(hash_suffix="h1", revision=1)
    nodes = [
        fx.node(name=f"pool-{i}", labels={
            "nvidia.com/gpu.product": "NVIDIA-H100-80GB-HBM3",
            "nvidia.com/gpu.count": "8",
        })
        for i in range(4)
    ]
    for n in nodes:
        fx.driver_pod(n, ds, hash_suffix="h1")
    policy = api.TPUUpgradePolicySpec(
        auto_upgrade=True,
        max_parallel_upgrades=1,
        drain_spec=api.DrainSpec(enable=True, timeout_second=5),
    )
    return ds, nodes, policy


def _roll(engine: str, scenario) -> tuple[dict, list]:
    """Roll ``scenario`` on ``engine`` from h1 to h2; returns each node's
    states, one a pass with repeats collapsed, and the probed groups."""
    api, k8s, upgrade, fixtures = ENGINES[engine]
    cluster = k8s.FakeCluster()
    fx = fixtures.ClusterFixture(cluster)
    ds, nodes, policy = scenario(fx, api)
    fx.bump_daemon_set_template(ds, "h2", revision=2)
    fx.auto_recreate_driver_pods(ds, "h2")
    keys = upgrade.UpgradeKeys()
    prober = ScriptedProber(upgrade)
    mgr = upgrade.ClusterUpgradeStateManager(
        cluster, keys=keys, poll_interval_s=0.005, poll_timeout_s=2.0
    )
    if policy.pod_deletion is not None:
        mgr.with_pod_deletion_enabled(
            lambda p: p.labels.get("app") == "train"
        )
    mgr.with_validation_enabled(prober)
    seen: dict[str, list[str]] = {n.name: [] for n in nodes}
    for _ in range(80):
        mgr.apply_state(
            mgr.build_state(fixtures.NAMESPACE, fixtures.DRIVER_LABELS),
            policy,
        )
        assert mgr.wait_for_async_work(30.0)
        for name, states in seen.items():
            state = cluster.get_node(name).labels.get(keys.state_label, "")
            if not states or states[-1] != state:
                states.append(state)
        if all(s[-1] == "upgrade-done" for s in seen.values()):
            break
    else:
        raise AssertionError(f"{engine} roll did not converge: {seen}")
    for n in nodes:
        pods = [p for p in cluster.list_pods(node_name=n.name)
                if p.labels.get("app") == fixtures.DRIVER_LABELS["app"]]
        assert [p.labels["controller-revision-hash"] for p in pods] == ["h2"]
        assert not cluster.get_node(n.name).spec.unschedulable
    return seen, prober.calls


@pytest.mark.parametrize(
    "scenario", [_two_slices, _node_unit, _gpu_nodes],
    ids=["two_slices", "node_unit", "four_gpu_nodes"],
)
def test_both_engines_walk_the_same_states(scenario):
    port, port_calls = _roll("port", scenario)
    ref, ref_calls = _roll("jax", scenario)
    assert port == ref
    # The generation tables differ (the port's holds the H100s, the JAX
    # package's the TPUs), and the engine admits the oldest generation
    # first: TPU slices, unknown to the port, may be probed in another
    # order.  The GPU pool is one generation: h100-sxm to the port, which
    # reads the nodes' GPU Feature Discovery label, and unknown to the
    # JAX package, which reads a slice's accelerator alone; either way
    # its nodes go in id order.
    assert sorted(port_calls) == sorted(ref_calls)
    if scenario is _gpu_nodes:
        assert port_calls == ref_calls
    assert len(port_calls) > len(set(port_calls))  # the rejections ran
    for states in port.values():
        assert states[-1] == "upgrade-done"
        assert "validation-required" in states


# -- a GPU node's generation (the engine reads GFD's label) ------------------

from k8s_operator_libs_tpu_torch.fleet import profiles as tprofiles  # noqa: E402
from k8s_operator_libs_tpu_torch.fleet import scheduler as tscheduler  # noqa: E402

# GPU Feature Discovery's product label of each H100 part, and the
# generation the port's profiles give it.
GFD_PRODUCTS = {
    "h100-pcie": "NVIDIA-H100-PCIe",
    "h100-sxm": "NVIDIA-H100-80GB-HBM3",
    "h100-nvl": "NVIDIA-H100-NVL",
}
# Node names in the reverse of the profiles' order, so admission by id
# and admission by generation differ.
MIXED_POOL = (
    ("node-0", "h100-nvl"), ("node-1", "h100-sxm"),
    ("node-2", "h100-sxm"), ("node-3", "h100-pcie"),
)


def _mixed_gpu_pool(fx, api):
    ds = fx.daemon_set(hash_suffix="h1", revision=1)
    nodes = [
        fx.node(name=name, labels={
            "nvidia.com/gpu.product": GFD_PRODUCTS[gen],
            "nvidia.com/gpu.count": "8",
        })
        for name, gen in MIXED_POOL
    ]
    for n in nodes:
        fx.driver_pod(n, ds, hash_suffix="h1")
    policy = api.TPUUpgradePolicySpec(
        auto_upgrade=True,
        max_parallel_upgrades=1,
        drain_spec=api.DrainSpec(enable=True, timeout_second=5),
    )
    return ds, nodes, policy


def _port_state(scenario=_mixed_gpu_pool):
    """The port's engine on ``scenario`` after the template bump: the
    cluster, manager, policy and one built state."""
    fixtures = ENGINES["port"][3]
    cluster = tk8s.FakeCluster()
    fx = fixtures.ClusterFixture(cluster)
    ds, nodes, policy = scenario(fx, tapi)
    fx.bump_daemon_set_template(ds, "h2", revision=2)
    fx.auto_recreate_driver_pods(ds, "h2")
    mgr = tup.ClusterUpgradeStateManager(
        cluster, keys=tup.UpgradeKeys(), poll_interval_s=0.005,
        poll_timeout_s=2.0,
    )
    state = mgr.build_state(fixtures.NAMESPACE, fixtures.DRIVER_LABELS)
    return cluster, mgr, policy, state


def test_a_gpu_group_sorts_under_its_generation():
    _, _, _, state = _port_state()
    groups = {g.id: g for g in state.all_groups()}
    assert {g.slice_info for g in groups.values()} == {None}
    for name, gen in MIXED_POOL:
        node = groups[name].nodes[0]
        assert tprofiles.node_accelerator(node) == GFD_PRODUCTS[gen]
        assert tprofiles.group_accelerator(groups[name]) == GFD_PRODUCTS[gen]
        profile = tprofiles.generation_profile(GFD_PRODUCTS[gen])
        assert tscheduler.group_sort_key(groups[name]) == (
            profile.order, -profile.watts_per_chip, gen, name,
        )
    # The profiles' order: PCIe, then both SXM (by id), then NVL.
    assert [g.id for g in tscheduler.order_groups(groups.values())] == [
        "node-3", "node-1", "node-2", "node-0",
    ]
    # Packed admission keeps generation primary: the NVL group with the
    # largest cost still sorts after the PCIe group with the smallest.
    costs = {"node-0": 8, "node-1": 2, "node-2": 4, "node-3": 1}
    packed = sorted(
        groups.values(),
        key=lambda g: tscheduler.packed_group_sort_key(g, costs[g.id]),
    )
    assert [g.id for g in packed] == ["node-3", "node-2", "node-1", "node-0"]


def test_a_node_accelerator_takes_the_tpu_label_first():
    node = tk8s.Node(metadata=tk8s.ObjectMeta(name="n", labels={
        "cloud.google.com/gke-accelerator": "nvidia-h100-80gb",
        "nvidia.com/gpu.product": "NVIDIA-H100-PCIe",
    }))
    assert tprofiles.node_accelerator(node) == "NVIDIA-H100-PCIe"
    node.labels["cloud.google.com/gke-tpu-accelerator"] = "tpu-v5p-slice"
    assert tprofiles.node_accelerator(node) == "tpu-v5p-slice"
    assert tprofiles.node_accelerator(tk8s.Node(
        metadata=tk8s.ObjectMeta(name="m"))) == ""


def test_a_mixed_gpu_pool_rolls_in_profile_order():
    """One slot: the engine admits PCIe, then both SXM, then NVL, and
    every node ends upgrade-done."""
    fixtures = ENGINES["port"][3]
    cluster, mgr, policy, _ = _port_state()
    keys = mgr.keys
    admitted: list[str] = []
    for _ in range(80):
        mgr.apply_state(
            mgr.build_state(fixtures.NAMESPACE, fixtures.DRIVER_LABELS),
            policy,
        )
        assert mgr.wait_for_async_work(30.0)
        states = {
            name: cluster.get_node(name).labels.get(keys.state_label, "")
            for name, _ in MIXED_POOL
        }
        for name, state in states.items():
            if state not in ("", "upgrade-required") and name not in admitted:
                admitted.append(name)
        if set(states.values()) == {"upgrade-done"}:
            break
    else:
        raise AssertionError(f"the mixed pool did not converge: {states}")
    assert admitted == ["node-3", "node-1", "node-2", "node-0"]


def test_a_preempted_sxm_node_counts_under_its_generation():
    cluster, mgr, policy, state = _port_state()
    fixtures = ENGINES["port"][3]
    cluster.patch_node_annotations(
        "node-1", {tup.consts.NODE_PREEMPTION_ANNOTATION: "true"}
    )
    mgr.apply_state(
        mgr.build_state(fixtures.NAMESPACE, fixtures.DRIVER_LABELS), policy
    )
    assert mgr.wait_for_async_work(30.0)
    assert mgr.preemptions == {"h100-sxm": 1}


def test_the_planner_and_telemetry_read_the_gfd_label():
    from k8s_operator_libs_tpu_torch.obs.telemetry import TelemetryPlane
    from k8s_operator_libs_tpu_torch.planning.planner import plan_roll

    _, mgr, policy, state = _port_state()
    plan = plan_roll(mgr, state, policy, now=1_700_000_000.0)
    accelerators = {g.group_id: g.accelerator for g in plan.groups}
    assert accelerators == {n: GFD_PRODUCTS[g] for n, g in MIXED_POOL}
    waves = {g.group_id: g.wave for g in plan.groups}
    assert sorted(waves, key=waves.get) == [
        "node-3", "node-1", "node-2", "node-0",
    ]

    class _Result:
        telemetry = {"node-1": {"tflops": 800.0}}

    group = next(g for g in state.all_groups() if g.id == "node-1")
    plane = TelemetryPlane()
    plane.observe_validation(group, _Result())
    assert plane._node_generation["node-1"] == "NVIDIA-H100-80GB-HBM3"
