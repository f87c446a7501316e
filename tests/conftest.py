import os
import sys

# Tests run on the CPU with 8 virtual devices, so the mesh paths run
# without accelerator hardware.  JAX reads both variables when its first
# backend starts, which is after this file runs.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(__file__))
