"""idle_share (%, device_trace; layer: device): 100 (1 - union of device
operation intervals / length of the traced sub-window)."""
from perfbench.harness.readers import idle_pct


def read(run):
    return idle_pct(run)
