"""Set-up that runs once per test run, before any test process starts.

The JAX package's C++ host tier (``stormtpu/native``) builds itself on
first import with ``make``, straight into ``libstormtpu_native.so``. Test
processes of one pytest-xdist run that import it at once on a fresh
checkout race on that build: a process that loads a half-written library
caches the failure, its native-gated tests skip and its routing differs.
Building the library here, in the controlling process (or the only one,
without xdist), leaves nothing for the workers to build. A failed build
(no compiler) is ignored: the package then falls back as it always has.
"""

import os
import subprocess

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "stormtpu", "native")


def pytest_configure(config):
    if hasattr(config, "workerinput"):
        return  # an xdist worker: the controller has built it
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR, "-s"], check=False,
                       capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError):
        pass
