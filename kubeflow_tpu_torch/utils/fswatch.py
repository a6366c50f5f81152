"""Event-driven config-file watching (native inotify, polling fallback).

The reference hot-reloads its mounted namespace-labels file via fsnotify
(profile_controller.go:368-399). Here the same capability is a small C
library (native/fswatch.c, inotify on the file's directory — ConfigMap
updates are ..data symlink swaps, which never fire IN_MODIFY on the file
itself) loaded through ctypes. When the prebuilt library is missing it is
compiled once into a fresh private mkdtemp (never a fixed world-writable
path), off the event loop; failing that, ``FileWatcher`` degrades to mtime
polling with the same interface, so callers never branch.
"""

from __future__ import annotations

import asyncio
import ctypes
import logging
import os
import subprocess
import tempfile
import threading

log = logging.getLogger(__name__)

_SOURCE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native", "fswatch.c",
)
# Only the package-adjacent prebuilt library is loaded from a fixed path
# (shipped in the image via native/Makefile). The compile fallback goes to
# a per-process private directory — loading/building at a predictable
# world-writable location like /tmp/libkfswatch.so would let any local
# user plant code that runs with the controller's credentials.
_PREBUILT = os.path.join(os.path.dirname(_SOURCE), "libkfswatch.so")

_lib = None
_lib_lock = threading.Lock()
_lib_tried = False


def _load_library():
    """Load (compiling on first use) libkfswatch; None on failure.

    Blocking (compiler invocation up to 60 s) — call off the event loop.
    """
    global _lib, _lib_tried
    with _lib_lock:
        if _lib_tried:
            return _lib
        _lib_tried = True
        try:
            _lib = _bind(ctypes.CDLL(_PREBUILT))
            return _lib
        except OSError:
            pass
        try:
            build_dir = tempfile.mkdtemp(prefix="kfswatch-")
            target = os.path.join(build_dir, "libkfswatch.so")
            subprocess.run(
                ["cc", "-O2", "-fPIC", "-shared", "-o", target, _SOURCE],
                check=True, capture_output=True, timeout=60,
            )
            _lib = _bind(ctypes.CDLL(target))
            # Linux keeps the mapping alive after unlink — clean the temp
            # dir now so crash-looping processes don't accumulate them.
            try:
                os.unlink(target)
                os.rmdir(build_dir)
            except OSError:
                pass
        except (OSError, subprocess.SubprocessError) as e:
            log.debug("native fswatch unavailable (%s); falling back to polling", e)
            _lib = None
        return _lib


def _bind(lib):
    lib.kfs_watch_open.argtypes = [ctypes.c_char_p]
    lib.kfs_watch_open.restype = ctypes.c_int
    lib.kfs_watch_wait.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.kfs_watch_wait.restype = ctypes.c_int
    lib.kfs_watch_close.argtypes = [ctypes.c_int]
    lib.kfs_watch_close.restype = None
    return lib


class FileWatcher:
    """Watch one file for changes; ``await wait(timeout)`` → bool changed.

    Change detection is always mtime-based (inotify events are for the
    whole directory, and a symlink swap may touch sibling files); the
    native layer only turns the poll cadence into an event-driven wakeup
    with sub-second latency. Native setup (library load, possibly a
    compile) happens lazily inside the first ``wait`` on an executor
    thread, so constructing a watcher never blocks the event loop.
    """

    def __init__(self, path: str):
        self.path = path
        self._last = self._mtime()
        self._fd: int | None = None
        self._setup_done = False
        # Close/wait/setup coordination: the fd may only be closed when no
        # executor thread is inside kfs_watch_wait (the kernel could
        # reassign the number under a blocked poll), and close() must not
        # block the event loop waiting for that poll — so the closing
        # thread hands the actual close() off to whichever side holds the
        # fd last (_closing flag).
        self._io_lock = threading.Lock()
        self._in_wait = 0  # count of executor threads inside kfs_watch_wait
        self._closing = False

    @property
    def native(self) -> bool:
        return self._fd is not None

    def _setup_native(self) -> None:
        """Runs on an executor thread (may compile the library)."""
        lib = _load_library()
        if lib is None:
            return
        fd = lib.kfs_watch_open(os.path.dirname(self.path).encode() or b".")
        if fd < 0:
            log.debug("inotify watch failed for %s; polling", self.path)
            return
        with self._io_lock:
            if self._closing:
                lib.kfs_watch_close(fd)  # close() raced the lazy setup
            else:
                self._fd = fd

    def _mtime(self):
        """Change signature: (inode, mtime, size), not mtime alone — a
        ConfigMap-style symlink swap always changes the resolved inode,
        but the old and new targets can carry the SAME mtime when they
        were written within one filesystem timestamp tick (tmpfs clock
        granularity), which made swap detection racy."""
        try:
            st = os.stat(self.path)
            return (st.st_ino, st.st_mtime_ns, st.st_size)
        except OSError:
            return None

    def _changed(self) -> bool:
        now = self._mtime()
        if now != self._last:
            self._last = now
            return True
        return False

    def _wait_native(self, timeout_ms: int) -> int:
        with self._io_lock:
            if self._fd is None or self._closing:
                return 0
            self._in_wait += 1
            fd = self._fd
        try:
            return _load_library().kfs_watch_wait(fd, timeout_ms)
        finally:
            with self._io_lock:
                self._in_wait -= 1
                if self._closing and self._in_wait == 0 and self._fd is not None:
                    _load_library().kfs_watch_close(self._fd)
                    self._fd = None

    async def wait(self, timeout: float = 2.0) -> bool:
        """Wait up to ``timeout`` seconds for a change to ``path``."""
        loop = asyncio.get_running_loop()
        if not self._setup_done:
            self._setup_done = True
            await loop.run_in_executor(None, self._setup_native)
        if self._fd is not None:
            await loop.run_in_executor(
                None, self._wait_native, int(timeout * 1000)
            )
        else:
            await asyncio.sleep(timeout)
        return self._changed()

    def close(self) -> None:
        """Non-blocking: if a wait is in flight on an executor thread, that
        thread performs the actual fd close when its poll returns."""
        with self._io_lock:
            self._closing = True
            if self._in_wait == 0 and self._fd is not None:
                _load_library().kfs_watch_close(self._fd)
                self._fd = None
