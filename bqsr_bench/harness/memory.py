"""Host memory of this process: its resident set, and the peak of it over
a stretch of time, sampled every millisecond by a child process.

A thread of this process cannot sample while the main thread holds the
interpreter lock (a copy of half a gigabyte into a ``BytesIO`` holds it
throughout), and ``/proc/self/clear_refs``, which would reset the kernel's
own high-water mark, is refused on the card's machine; a child process
reading ``/proc/<pid>/status`` sees every peak that lasts a few
milliseconds."""

from __future__ import annotations

import os
import subprocess
import sys

_WATCH = r"""
import os, select, sys
path, dt = "/proc/%s/status" % sys.argv[1], float(sys.argv[2])
def rss():
    try:
        with open(path, "rb") as f:
            for line in f:
                if line.startswith(b"VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0
top = rss()
while True:
    ready = select.select([0], [], [], dt)[0]
    cur = rss()
    top = max(top, cur)
    if ready:
        cmd = os.read(0, 1)
        if cmd != b"m":
            break
        os.write(1, b"%d\n" % top)
        top = cur
"""


def rss() -> int:
    """Resident bytes of this process now."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    raise OSError("no VmRSS in /proc/self/status")


class RssWatch:
    """``with RssWatch() as w:`` then ``w.mark()``: the highest resident set
    of this process since the previous mark (or the start); ``w.stop()``
    ends the sampling before the block does."""

    def __init__(self, interval_s: float = 0.001):
        self.interval_s = interval_s

    def __enter__(self):
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _WATCH, str(os.getpid()),
             str(self.interval_s)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE)
        return self

    def mark(self) -> int:
        self.proc.stdin.write(b"m")
        self.proc.stdin.flush()
        return int(self.proc.stdout.readline())

    def __exit__(self, *exc):
        self.stop()
        return False

    def stop(self) -> None:
        if self.proc is None:
            return
        try:
            self.proc.stdin.write(b"q")
            self.proc.stdin.close()
        except OSError:
            pass
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self.proc.stdout.close()
        self.proc = None
