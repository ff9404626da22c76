"""Build native sources of the repository into shared libraries at first use.

Every library is compiled from the checkout's sources into ``build/`` at the
repository root (listed in `.gitignore`), under a name that carries a hash
of the sources and the compiler command, so an edited source is rebuilt and
an unchanged one is reused.  The compiler writes to a per-process temporary
name that is renamed into place, so concurrent test workers never load a
half-written file.  A failed build raises: there is no fallback.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import subprocess
import time

REPO = pathlib.Path(__file__).resolve().parents[1]
BUILD_DIR = REPO / "build"

# seconds each library took to build in this process (0.0 when reused),
# and the compiler's output of each build (register and spill reports)
BUILD_SECONDS: dict[str, float] = {}
BUILD_LOGS: dict[str, str] = {}


def build_library(name: str, sources: list[pathlib.Path],
                  command: list[str]) -> pathlib.Path:
    """Compile ``sources`` with ``command + ["-o", out, *sources]``."""
    h = hashlib.sha256(" ".join(command).encode())
    for s in sources:
        h.update(pathlib.Path(s).read_bytes())
    out = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    if out.exists():
        BUILD_SECONDS.setdefault(name, 0.0)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{out.name}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    r = subprocess.run([*command, "-o", str(tmp), *map(str, sources)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(
            f"building {name} failed (rc={r.returncode}):\n"
            f"{' '.join(command)}\n{r.stdout[-4000:]}\n{r.stderr[-4000:]}")
    os.replace(tmp, out)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    BUILD_LOGS[name] = r.stdout + r.stderr
    return out
