"""The JAX package's native mesh library, loaded for a port test.

`gaustar_tpu.native` runs `make` into its own directory at first import and
freezes `HAVE_NATIVE` then. Under pytest-xdist every worker imports it at
about the same moment, each runs its own `make`, and a worker can `CDLL` a
file that another worker's linker is still writing: its `HAVE_NATIVE` stays
False though the library is whole a moment later. `jax_native()` does not
read that flag. It takes a lock, then calls the package's own loader until
it returns the library (the build it waits for is the package's; it makes
none of its own)."""

from __future__ import annotations

import fcntl
import time
from pathlib import Path

LOCK = Path(__file__).resolve().parents[1] / "build" / "jax_native.lock"
DEADLINE_S = 120.0  # the package's own `make` timeout
RETRY_S = 0.5


def jax_native(module=None, lock_path: Path = LOCK):
    """The ctypes library of `module` (gaustar_tpu.native by default),
    loaded in this process; `module.HAVE_NATIVE` is set to match. Raises
    if the package's loader has not returned it within DEADLINE_S. The
    lock (`lock_path`) keeps this process's retries from interleaving with
    another's."""
    if module is None:
        from gaustar_tpu import native as module
    lock_path.parent.mkdir(parents=True, exist_ok=True)
    with open(lock_path, "w") as lock:  # closing it releases the lock
        fcntl.flock(lock, fcntl.LOCK_EX)
        t_end = time.monotonic() + DEADLINE_S
        while (lib := module._load()) is None:
            if time.monotonic() > t_end:
                raise RuntimeError(
                    f"{module.__name__}._load() returned no library within {DEADLINE_S:.0f} s: "
                    f"`make -C {Path(module._LIB_PATH).parent}` did not leave a loadable "
                    f"{Path(module._LIB_PATH).name} (is g++ / make installed?)")
            time.sleep(RETRY_S)
    module.HAVE_NATIVE = True
    return lib
