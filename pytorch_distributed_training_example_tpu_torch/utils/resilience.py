"""Preemption-safe shutdown for the serving loop.

The parts of ``pytorch_distributed_training_example_tpu/utils/resilience.py``
that ``serve.run.serve_loop`` uses: :func:`install` registers a
SIGTERM/SIGINT handler that only sets a flag, the loop polls
:func:`preempted` between steps, drains in-flight sequences and exits with
:data:`PREEMPTED_EXIT_CODE` through :class:`PreemptedExit`. A second signal
while the flag is already set restores the previous handlers, so a third
delivery force-kills a stuck shutdown. The retriable-I/O half of the JAX
module belongs to the checkpoint port and is not copied yet.
"""

from __future__ import annotations

import logging
import signal
import threading

log = logging.getLogger("pdtx")

#: Exit code of a graceful preemption shutdown (EX_TEMPFAIL), the same code
#: the JAX package's supervisor restarts on.
PREEMPTED_EXIT_CODE = 75

# The flag is process-wide on purpose: a signal handler has no other place
# to leave its note.
_flag = threading.Event()
_prev_handlers: dict[int, object] = {}


class PreemptedExit(SystemExit):
    """Raised by the serving session after its bounded drain."""

    def __init__(self):
        super().__init__(PREEMPTED_EXIT_CODE)


def _handle(signum, frame):
    if _flag.is_set():
        # Second delivery: restore the previous handlers so one more signal
        # terminates immediately instead of being swallowed.
        uninstall()
    _flag.set()


def install(signals=(signal.SIGTERM, signal.SIGINT)) -> bool:
    """Register the graceful-shutdown handler. Idempotent; main thread only.

    Returns False (and leaves handlers untouched) off the main thread, where
    ``signal.signal`` would raise.
    """
    if _prev_handlers:
        return True
    try:
        for s in signals:
            _prev_handlers[s] = signal.signal(s, _handle)
    except ValueError:  # not the main thread
        _prev_handlers.clear()
        log.warning("resilience: cannot install signal handlers off the main "
                    "thread — preemption-safe shutdown disabled")
        return False
    return True


def uninstall() -> None:
    """Restore the pre-:func:`install` handlers (tests; second-signal path)."""
    for s, h in list(_prev_handlers.items()):
        try:
            signal.signal(s, h)
        except (ValueError, TypeError):
            pass
    _prev_handlers.clear()


def preempted() -> bool:
    """True once a shutdown signal arrived; polled between serving steps."""
    return _flag.is_set()


def reset() -> None:
    """Clear the flag (tests only — a real preemption is never un-asked)."""
    _flag.clear()


def trip() -> None:
    """Set the flag programmatically (tests / cooperative shutdown)."""
    _flag.set()
