"""Debug helpers for long-running CLI processes (the port of
``pqdet_tpu/utils/debug.py``)."""

import faulthandler
import io
import signal


def register_stack_dump():
    """`kill -USR1 <pid>` dumps every thread's stack to stderr: the one way
    to ask a wedged run where it is (a no-op where stderr has no fileno,
    e.g. under pytest capture)."""
    try:
        faulthandler.register(signal.SIGUSR1)
    except (io.UnsupportedOperation, ValueError, AttributeError):
        pass


def enable_fault_dump():
    """A segfault or abort prints every thread's stack to stderr instead of
    a silent exit (a no-op where stderr has no fileno, e.g. under pytest
    capture)."""
    try:
        faulthandler.enable()
    except (io.UnsupportedOperation, ValueError, AttributeError):
        pass
