"""Runtime utilities: watchdog hang detector, walltime parsing and the
persistent compile cache.

Parity target: reference src/utils/watchdog.cpp:7-40 (a pthread that
aborts the job if the main loop stops petting it within the -w window)
and the -t hh:mm:ss clean-stop walltime (reference: main.cpp, driver.cpp
:390-394).
"""

from __future__ import annotations

import os
import sys
import threading
import time


def parse_walltime(s: str) -> float:
    """hh:mm:ss (or mm:ss or ss) -> seconds."""
    parts = [float(p) for p in s.split(":")]
    t = 0.0
    for p in parts:
        t = t * 60.0 + p
    return t


class WatchDog:
    """Aborts the process if not petted within ``timeout`` seconds."""

    def __init__(self, timeout: float) -> None:
        self.timeout = timeout
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._watch, daemon=True)
        self._thread.start()

    def pet(self) -> None:
        self._last = time.monotonic()

    def stop(self) -> None:
        self._stop.set()

    def _watch(self) -> None:
        while not self._stop.wait(min(self.timeout / 4.0, 5.0)):
            if time.monotonic() - self._last > self.timeout:
                print(f"### WATCHDOG: main loop hung for more than "
                      f"{self.timeout} s, aborting", file=sys.stderr,
                      flush=True)
                os._exit(66)


# Fixed, git-ignored place for the persistent compile cache: the cache
# key includes the path, so a directory that moved would never hit.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def enable_compile_cache() -> None:
    """Turn on JAX's persistent compilation cache, so repeat runs of the
    same deck skip XLA recompiles (the reference has no analogue since
    C++ compiles ahead of time).

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    no directory is set here; otherwise the cache lives in
    ``DEFAULT_CACHE_DIR`` inside the checkout."""
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
