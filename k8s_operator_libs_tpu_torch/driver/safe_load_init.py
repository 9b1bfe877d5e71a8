"""Safe-load init container: hold the driver's load until the node is
quiesced.

Counterpart of ``k8s_operator_libs_tpu.driver.safe_load_init``; its keys
come from ``DRIVER_NAME`` through :func:`..keys.keys_from_env`.

Node-side half of the safe-load handshake (controller side:
``upgrade.safe_driver_load_manager``; protocol shape per reference
docs/automatic-ofed-upgrade.md:43-66 and SURVEY.md §3.5):

1. on start, set the ``…driver-wait-for-safe-load`` annotation on this
   node — the upgrade state machine sees it and forces the node's slice
   through the full cordon/wait/delete/drain pipeline;
2. block while the annotation exists;
3. the controller removes the annotation once the slice is quiesced
   (instead of restarting the pod) — we exit 0 and the main driver
   container loads the driver onto a quiet node.

Crash-safety: setting the annotation is idempotent (re-running after a
restart re-announces), and if the controller already removed it between
our write and first poll we exit immediately.
"""

from __future__ import annotations

import os
import time
from typing import Optional

from k8s_operator_libs_tpu_torch.consts import get_logger
from k8s_operator_libs_tpu_torch.upgrade.consts import TRUE_STRING
from k8s_operator_libs_tpu_torch.keys import driver_keys, keys_from_env
from k8s_operator_libs_tpu_torch.upgrade.util import UpgradeKeys

logger = get_logger(__name__)

DEFAULT_POLL_S = 5.0


def announce_and_wait(
    client,
    node_name: str,
    keys: Optional[UpgradeKeys] = None,
    poll_interval_s: float = DEFAULT_POLL_S,
    timeout_s: float = 0.0,
) -> bool:
    """Set the safe-load annotation, then block until the controller
    removes it.  Returns True when unblocked; False on timeout
    (timeout_s == 0 waits forever — init containers are restarted by the
    kubelet, so no exit is safer than a premature driver load)."""
    keys = keys or driver_keys()
    annotation = keys.safe_load_annotation
    client.patch_node_annotations(node_name, {annotation: TRUE_STRING})
    logger.info(
        "node %s waiting for safe driver load (%s)", node_name, annotation
    )
    deadline = time.monotonic() + timeout_s if timeout_s > 0 else None
    while True:
        node = client.get_node(node_name, cached=False)
        if annotation not in node.annotations:
            logger.info("node %s unblocked; loading driver", node_name)
            return True
        if deadline is not None and time.monotonic() > deadline:
            logger.warning(
                "node %s safe-load wait timed out after %.0fs",
                node_name,
                timeout_s,
            )
            return False
        time.sleep(poll_interval_s)


def main() -> None:
    from k8s_operator_libs_tpu_torch.k8s import get_default_client

    node_name = os.environ.get("NODE_NAME", "")
    if not node_name:
        raise SystemExit("NODE_NAME is required")
    keys = keys_from_env()
    poll = float(os.environ.get("SAFE_LOAD_POLL_S", str(DEFAULT_POLL_S)))
    if not announce_and_wait(
        get_default_client(), node_name, keys, poll_interval_s=poll
    ):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
