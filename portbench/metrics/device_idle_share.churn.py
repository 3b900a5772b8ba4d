"""Device: 1 less the union of device activity over the profiled part of
a churn window (draws and updates), in %."""
from portbench.lib.manifest import HERE, load_module

read = load_module(HERE / "metrics" / "device_idle_share.draws.py").read
