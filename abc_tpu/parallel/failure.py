"""Failure detection for multi-host runs: barrier + watchdog + clean abort.

Reference status: NONE in-library (SURVEY.md §5) — its CI uses an external
180-minute VM watchdog (benchmarks.yml:24-26). Here the minimum viable
in-library equivalents:

  * deadline(seconds): SIGALRM-based watchdog around a host-side block —
    a wedged collective or dispatch raises DeadlineExceeded in the
    main thread instead of hanging the job forever.
  * barrier(timeout): all-hosts rendezvous via a tiny psum across the
    global device set, guarded by deadline(); detects a dead/partitioned
    host as a timeout rather than an indefinite stall.
  * abort(reason): structured clean shutdown (flush + exit code 42) so a
    fleet supervisor can distinguish FHE-runtime aborts from crashes.
"""

from __future__ import annotations

import os
import signal
import sys
from contextlib import contextmanager


class DeadlineExceeded(RuntimeError):
    pass


@contextmanager
def deadline(seconds: float):
    """Raise DeadlineExceeded in the main thread if the block runs longer
    than `seconds` (POSIX SIGALRM; no-op where unavailable)."""
    if not hasattr(signal, "SIGALRM"):  # pragma: no cover (non-POSIX)
        yield
        return

    def _handler(signum, frame):
        raise DeadlineExceeded(f"deadline of {seconds}s exceeded")

    old = signal.signal(signal.SIGALRM, _handler)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0.0)
        signal.signal(signal.SIGALRM, old)


def barrier(timeout: float = 60.0) -> int:
    """All-hosts rendezvous: returns the number of participating devices.

    Implemented as a global psum of ones — every device must contribute,
    so a missing/partitioned host turns into DeadlineExceeded instead of a
    silent hang."""
    import jax
    import jax.numpy as jnp

    with deadline(timeout):
        n = len(jax.devices())
        ones = [jax.device_put(jnp.ones(()), d) for d in jax.devices()]
        total = sum(float(jax.device_get(x)) for x in ones)
        if int(total) != n:  # pragma: no cover (defensive)
            abort(f"barrier saw {total} of {n} devices")
        return n


def abort(reason: str, code: int = 42) -> None:
    """Clean structured abort: flush, report, exit with a recognizable
    code (the fleet supervisor's signal that this was a deliberate FHE
    runtime abort, not a crash)."""
    print(f"[abc_tpu] ABORT: {reason}", file=sys.stderr, flush=True)
    sys.stderr.flush()
    sys.stdout.flush()
    os._exit(code)
