"""Root test configuration: build the JAX package's native codec once.

``buildingsegment_tpu/native/binding.py`` runs ``make -B`` at its first
use when ``libbstnative.so`` is missing or older than its sources, and
tests/test_native.py asks for it while each test process collects.
Under pytest-xdist every worker collects at once, so several ``make
-B`` runs wrote the same library together, and a worker that loaded it
half-written skipped the native tests.  Here the library is brought up
to date once, in ``pytest_configure`` of the controlling process (before
xdist starts its workers), under an exclusive lock; the workers then
find it current and build nothing.

This module imports neither package nor JAX: tests/conftest.py must set
``XLA_FLAGS`` before JAX's first CPU client.  A failed build is reported
on stderr and changes nothing else: the native tests skip as before.
"""

import fcntl
import os
import subprocess
import sys

_ROOT = os.path.dirname(os.path.abspath(__file__))
_NATIVE = os.path.join(_ROOT, "buildingsegment_tpu", "native")
_LIB = os.path.join(_NATIVE, "libbstnative.so")
_LOCK = os.path.join(_ROOT, "buildingsegment_tpu_torch", "_build",
                     "native_make.lock")


def _stale() -> bool:
    """binding.py's rule: no library, or a source newer than it."""
    if not os.path.exists(_LIB):
        return True
    built = os.path.getmtime(_LIB)
    return any(
        os.path.getmtime(p) > built
        for p in (os.path.join(_NATIVE, f) for f in ("ply_codec.cpp",
                                                     "Makefile"))
        if os.path.exists(p))


def pytest_configure(config):
    if hasattr(config, "workerinput"):  # an xdist worker: the controller built
        return
    if not os.path.isdir(_NATIVE):
        return
    os.makedirs(os.path.dirname(_LOCK), exist_ok=True)
    with open(_LOCK, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not _stale():
                return
            try:
                res = subprocess.run(["make", "-B", "-C", _NATIVE],
                                     capture_output=True, text=True,
                                     timeout=120)
            except (OSError, subprocess.TimeoutExpired) as exc:
                msg = str(exc)
            else:
                if res.returncode == 0:
                    return
                msg = (res.stderr or res.stdout)[-2000:]
            sys.stderr.write(f"conftest: building the native codec failed "
                             f"(tests/test_native.py will skip): {msg}\n")
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
