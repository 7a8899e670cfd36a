"""The test session outlives ``bench.py``'s alarm.

Importing ``bench.py`` arms SIGALRM for the benchmark's own time budget
(``BENCH_BUDGET_S``, 420 s, plus 60) and installs SIGALRM and SIGTERM
handlers that end the process with ``os._exit``.  tests/test_bench_flops.py
imports it at module level, so every xdist worker arms that alarm while it
collects, and a whole run that lasts longer loses every worker at the same
moment ("node down: Not properly terminated") while the controller, which
collects nothing, lives on.  This module is collected after that one (the
suite collects in file-name order), so each collecting process disarms the
alarm here and puts back the default handlers: they are the benchmark's,
not a test's.
"""

import signal
import sys

if "bench" in sys.modules:
    signal.alarm(0)
    signal.signal(signal.SIGALRM, signal.SIG_DFL)
    signal.signal(signal.SIGTERM, signal.SIG_DFL)


def test_no_benchmark_alarm_is_armed():
    assert signal.alarm(0) == 0
    assert signal.getsignal(signal.SIGALRM) == signal.SIG_DFL
