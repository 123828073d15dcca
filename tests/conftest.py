"""Test configuration: run all tests on a virtual 8-device CPU mesh.

The benchmark and chip_smoke.py run on the GPU; tests use jax-on-CPU (the
reference's backend_cpu plays the same golden-answer role, reference:
examples/test_final_cost.py).  jax_platforms is set through jax.config
before any backend initializes, so no accelerator is touched even where
one is present.
"""

import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
