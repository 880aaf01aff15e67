"""Multi-device demos: data-parallel scene batches and a halo-decomposed
single large cloth (SURVEY.md C15/C16), on the default backend's devices.

    python examples/03_multichip.py        # needs 8 devices, e.g.
    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        JAX_PLATFORMS=cpu python examples/03_multichip.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import __graft_entry__ as graft


def main():
    graft.dryrun_multichip(8)


if __name__ == "__main__":
    main()
