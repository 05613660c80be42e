"""Build (and cache) the native host-ingest library libstrling_io.so."""

from __future__ import annotations

import glob
import hashlib
import os
import subprocess

_SRC_DIR = os.path.join(os.path.dirname(__file__), "csrc")
_BUILD_DIR = os.path.join(os.path.dirname(__file__), "_build")
_LIB_DIRS = ("/usr/lib/x86_64-linux-gnu", "/lib/x86_64-linux-gnu",
             "/usr/lib64", "/usr/lib", "/lib")


def _link_arg(name: str) -> str:
    """`-l<name>` where the linker finds it; otherwise the path of the
    installed runtime library (some images ship lib<name>.so.N without the
    unversioned development symlink). The csrc code declares the few
    functions it calls from such libraries itself."""
    for d in _LIB_DIRS:
        if os.path.exists(os.path.join(d, f"lib{name}.so")):
            return f"-l{name}"
    for d in _LIB_DIRS:
        found = sorted(glob.glob(os.path.join(d, f"lib{name}.so.*")))
        if found:
            return found[0]
    return f"-l{name}"


def lib_path() -> str:
    """Compile csrc/strling_io.cc to a shared lib if needed; return its path."""
    srcs = sorted(
        os.path.join(_SRC_DIR, f) for f in os.listdir(_SRC_DIR) if f.endswith(".cc")
    )
    # hash headers too: a .h-only change must trigger a rebuild
    hdrs = sorted(
        os.path.join(_SRC_DIR, f) for f in os.listdir(_SRC_DIR) if f.endswith(".h")
    )
    h = hashlib.sha256()
    for s in srcs + hdrs:
        with open(s, "rb") as fh:
            h.update(fh.read())
    # -march=native code from one host may not run on another (the tree is
    # copied between machines), so the tag also keys the resolved target
    h.update(subprocess.run(
        ["g++", "-march=native", "-Q", "--help=target"],
        check=True, capture_output=True).stdout)
    tag = h.hexdigest()[:16]
    out = os.path.join(_BUILD_DIR, f"libstrling_io-{tag}.so")
    if os.path.exists(out):
        return out
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", "-pthread",
        *srcs, "-o", tmp, "-lz", _link_arg("lzma"), _link_arg("bz2"),
    ]
    subprocess.run(cmd, check=True)
    os.replace(tmp, out)
    # evict stale hash variants so the cache doesn't grow unboundedly
    for f in os.listdir(_BUILD_DIR):
        if (f.startswith("libstrling_io-") and f.endswith(".so")
                and f != os.path.basename(out)):
            try:
                os.unlink(os.path.join(_BUILD_DIR, f))
            except OSError:
                pass
    return out
