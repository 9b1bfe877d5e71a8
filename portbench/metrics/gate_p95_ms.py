"""The 95th percentile of the gates completed in the window: from the
node reaching validation with the new revision to the prober's verdict."""

import numpy as np

from harness.readers import gates_ms


def read(run):
    ms = gates_ms(run)
    return float(np.percentile(ms, 95)) if ms else None
