"""Process runtime services (AS_global / AS_UTL runtime equivalents).

The reference initializes every binary through AS_configure: a crash
catcher printing a demangled stack trace on fatal signals
(/root/reference/src/AS_UTL/AS_UTL_stackTrace.C), and a per-invocation
audit log `canu-logs/<time>_<host>_<pid>_<tool>` recording argv
(/root/reference/src/AS_global.C:59-160).  resource accounting comes
from getrusage (/root/reference/src/AS_UTL/timeAndSize.C).

Python equivalents: faulthandler dumps all-thread tracebacks on
SIGSEGV/SIGFPE/SIGABRT/SIGBUS into the same canu-logs directory; the
audit file carries argv + package/jax versions + device inventory;
rusage() wraps resource.getrusage.
"""

from __future__ import annotations

import os
import socket
import sys
import time


def audit_invocation(log_dir: str, tool: str = "canu_tpu") -> str:
    """Write the per-invocation audit record; returns its path."""
    os.makedirs(log_dir, exist_ok=True)
    name = f"{int(time.time())}_{socket.gethostname()}_{os.getpid()}_{tool}"
    path = os.path.join(log_dir, name)
    lines = [
        f"tool: {tool}",
        f"time: {time.strftime('%Y-%m-%dT%H:%M:%S')}",
        f"host: {socket.gethostname()}",
        f"pid:  {os.getpid()}",
        f"cwd:  {os.getcwd()}",
        f"argv: {' '.join(sys.argv)}",
        f"python: {sys.version.split()[0]}",
    ]
    try:
        import jax

        lines.append(f"jax: {jax.__version__}")
        lines.append(f"devices: {[str(d) for d in jax.devices()]}")
    except Exception as e:  # device probing must never kill the tool
        lines.append(f"jax: unavailable ({e})")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return path


_crash_log_fh = None  # keep the fd alive for faulthandler


def install_crash_catcher(log_dir: str) -> str:
    """Register fatal-signal tracebacks into canu-logs (stack trace role).

    Returns the crash-log path.  Idempotent per process.
    """
    global _crash_log_fh
    import faulthandler

    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(
        log_dir, f"{int(time.time())}_{socket.gethostname()}_{os.getpid()}_crash"
    )
    if _crash_log_fh is None:
        _crash_log_fh = open(path, "w")
        faulthandler.enable(file=_crash_log_fh, all_threads=True)
        import signal

        # SIGSEGV/SIGFPE/SIGABRT/SIGBUS are covered by enable(); register
        # USR1 for on-demand dumps (like the reference's sigaction set)
        try:
            faulthandler.register(signal.SIGUSR1, file=_crash_log_fh, all_threads=True)
        except (AttributeError, ValueError, OSError, RuntimeError):
            pass
    return path


def rusage() -> dict:
    """Wall/CPU/peak-RSS snapshot (timeAndSize equivalent)."""
    import resource

    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {
        "utime_s": ru.ru_utime,
        "stime_s": ru.ru_stime,
        "max_rss_mb": ru.ru_maxrss / 1024.0,
    }


def is_oom_error(exc: BaseException) -> bool:
    """True when exc (or its message) is a device out-of-memory."""
    s = f"{type(exc).__name__}: {exc}"
    return "RESOURCE_EXHAUSTED" in s or "Out of memory" in s or "OOM" in s


def recover_device_memory(backoff: float = 0.5) -> int:
    """Best-effort device-memory recovery between stage retries.

    The reference's executive resubmits only failed array indices with
    fresh processes, so a retry starts with a clean address space
    (/root/reference/src/pipelines/canu/Execution.pm:1036-1276).  Our
    stages retry IN-process: after a RESOURCE_EXHAUSTED the device still
    holds every live jax.Array (including the cached per-readset
    ReadIndex planes) and an immediate retry re-OOMs in milliseconds
    (observed round 3: attempt 2 died 4 ms after attempt 1).  This:

      1. deletes every live device array (caches rebuild lazily —
         ReadSet._read_index_cache entries hold now-deleted buffers, so
         callers must drop those caches; stages.overlap does);
      2. clears jax's compiled-computation caches (frees scratch/
         temp allocations retained by executables);
      3. halves the verify stage's in-flight HBM budget so the retry
         runs strictly smaller.

    Returns the number of deleted arrays.
    """
    import gc

    import jax

    n = 0
    try:
        for arr in jax.live_arrays():
            try:
                # skip small arrays: module/closure-level scalar constants
                # get baked into traced programs, and deleting one poisons
                # every future retrace that embeds it.  The OOM mass is in
                # the big planes (read index, DP inputs, sketches).
                if arr.nbytes < (1 << 16):
                    continue
                arr.delete()
                n += 1
            except Exception:
                pass
    except Exception:
        pass
    try:
        jax.clear_caches()
    except Exception:
        pass
    gc.collect()
    from ..ops import align as _align

    _align._INFLIGHT_BACKOFF = max(0.05, _align._INFLIGHT_BACKOFF * backoff)
    return n
