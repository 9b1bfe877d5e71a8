"""The TPU-native upgrade engine.

Analogue of the reference's ``pkg/upgrade`` (see SURVEY.md §2.1): the
cluster-wide, label-driven, idempotent upgrade state machine plus its six
sub-managers — redesigned so the schedulable unit is an ICI slice (a group
of hosts forming one TPU torus) instead of a single node.
"""

from k8s_operator_libs_tpu_torch.upgrade.consts import (  # noqa: F401
    STATE_ORDER,
    UpgradeState,
)
from k8s_operator_libs_tpu_torch.upgrade.util import (  # noqa: F401
    EventRecorder,
    KeyedMutex,
    StringSet,
    UpgradeKeys,
    default_keys,
    get_upgrade_state_label_key,
    set_driver_name,
)
from k8s_operator_libs_tpu_torch.upgrade.types import (  # noqa: F401
    ClusterUpgradeState,
    NodeUpgradeState,
    UpgradeGroup,
)
from k8s_operator_libs_tpu_torch.upgrade.node_state_provider import (  # noqa: F401
    CacheSyncTimeout,
    NodeUpgradeStateProvider,
)
from k8s_operator_libs_tpu_torch.upgrade.cordon_manager import CordonManager  # noqa: F401
from k8s_operator_libs_tpu_torch.upgrade.drain_manager import (  # noqa: F401
    DrainConfiguration,
    DrainManager,
)
from k8s_operator_libs_tpu_torch.upgrade.pod_manager import (  # noqa: F401
    PodManager,
    PodManagerConfig,
)
from k8s_operator_libs_tpu_torch.upgrade.validation_manager import (  # noqa: F401
    PodValidationProber,
    ProbeResult,
    ValidationManager,
)
from k8s_operator_libs_tpu_torch.upgrade.safe_driver_load_manager import (  # noqa: F401
    SafeDriverLoadManager,
)
from k8s_operator_libs_tpu_torch.upgrade.stuck import (  # noqa: F401
    StuckGroup,
    StuckStateDetector,
)
from k8s_operator_libs_tpu_torch.upgrade.upgrade_state import (  # noqa: F401
    BuildStateError,
    ClusterUpgradeStateManager,
)
