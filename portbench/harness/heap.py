"""The host heap of a render run's process, fixed before its trainer is
built: glibc's ``mallopt`` thresholds, so that the freed heap stays in the
process.

Each frame reads its image and depth back from the card into fresh
pageable buffers, and the harness converts the image to uint8: several MB a
frame. Under glibc's dynamic thresholds a process can settle where each
frame's freed buffers are trimmed away and the next frame faults their
pages in again; on one H100's host that made whole 1,000-frame windows
1.6-2x slower and the uint8 conversion 4x (PERF.md §2). With blocks up to
32 MB taken from the heap and the heap's top kept up to 1 GB, every run
stays in the fast state. The ``render_triplane`` and ``render_dense``
generators set it; the program itself leaves the allocator as it is."""

from __future__ import annotations

# glibc's mallopt parameters (malloc.h)
M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3
_KEPT = []


def keep_host_heap() -> bool:
    """Set the thresholds once per process; False where the C library has
    no ``mallopt``."""
    if not _KEPT:
        import ctypes
        import ctypes.util

        try:
            mallopt = ctypes.CDLL(ctypes.util.find_library("c")).mallopt
        except (OSError, AttributeError, TypeError):
            _KEPT.append(False)
        else:
            _KEPT.append(bool(mallopt(M_MMAP_THRESHOLD, 32 << 20))
                         and bool(mallopt(M_TRIM_THRESHOLD, 1 << 30)))
    return _KEPT[0]
