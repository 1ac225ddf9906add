"""Append-only file logging with optional console echo.

Counterpart of robosat_tpu/log.py (the reference's robosat/log.py): one
line per message in a text file, flushed after every line so tails stay
live, echoed to stdout.
"""

import os
import sys


class Log:
    def __init__(self, path, out=sys.stdout):
        self.out = out
        self.fp = open(path, "a")

    def log(self, msg):
        print(msg, end=os.linesep, file=self.fp, flush=True)
        if self.out is not None:
            print(msg, file=self.out)

    def close(self):
        if self.fp is not None:
            self.fp.close()
            self.fp = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
