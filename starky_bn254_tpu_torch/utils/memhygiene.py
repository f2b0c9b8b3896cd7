"""Host-memory hygiene between proves.

glibc keeps freed arenas resident instead of returning them to the OS, so
a process that churns through hundreds of MB-sized short-lived host
buffers (a trace per batch, its copy for the RLC aux build, the proof's
readbacks) grows its resident set batch after batch. `trim()` is called at
batch boundaries by the pipelined prover; it is a no-op outside glibc."""

from __future__ import annotations

import ctypes

_libc = None
_missing = False


def trim() -> None:
    """Return freed glibc arenas to the OS (malloc_trim(0)); cheap (~ms)."""
    global _libc, _missing
    if _missing:
        return
    if _libc is None:
        try:
            libc = ctypes.CDLL("libc.so.6")
        except OSError:  # not glibc
            libc = None
        if libc is None or not hasattr(libc, "malloc_trim"):
            _missing = True
            return
        libc.malloc_trim.argtypes = [ctypes.c_size_t]
        libc.malloc_trim.restype = ctypes.c_int
        _libc = libc
    _libc.malloc_trim(0)
