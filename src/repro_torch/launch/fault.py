"""Fault-tolerance machinery: watchdog, retry supervisor (port of
``repro.launch.fault``).

  * ``Watchdog`` — a deadline thread armed around every step; if a step
    exceeds ``timeout_s`` (a hung collective, a straggler) it fires a
    callback (default: log and ``os._exit(17)``, so a supervisor sees a
    distinct exit code and restarts).
  * ``supervise`` — an in-process restart loop for tests and single-host
    runs: run fn, and on a crash run it again, up to ``max_restarts``
    times; fn must resume from its checkpoint directory.
"""
from __future__ import annotations

import logging
import os
import threading
import time
import traceback
from typing import Callable, Optional

log = logging.getLogger("repro_torch.fault")
WATCHDOG_EXIT_CODE = 17


class Watchdog:
    def __init__(self, timeout_s: float,
                 on_timeout: Optional[Callable[[], None]] = None):
        self.timeout_s = timeout_s
        self.on_timeout = on_timeout or self._default_action
        self._deadline = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._fired = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    @staticmethod
    def _default_action():
        log.error("watchdog fired: step exceeded deadline — exiting for restart")
        os._exit(WATCHDOG_EXIT_CODE)

    def arm(self) -> None:
        with self._lock:
            self._deadline = time.monotonic() + self.timeout_s

    def disarm(self) -> None:
        with self._lock:
            self._deadline = None

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=1.0)

    @property
    def fired(self) -> bool:
        return self._fired.is_set()

    def _loop(self) -> None:
        while not self._stop.wait(0.05):
            with self._lock:
                d = self._deadline
            if d is not None and time.monotonic() > d:
                self._fired.set()
                with self._lock:
                    self._deadline = None
                self.on_timeout()


def supervise(fn: Callable[[], None], max_restarts: int = 3,
              backoff_s: float = 0.5) -> int:
    """Run fn with restart-on-crash semantics. Returns restarts used."""
    restarts = 0
    while True:
        try:
            fn()
            return restarts
        except KeyboardInterrupt:
            raise
        except BaseException as e:  # noqa: BLE001 — supervisor boundary
            restarts += 1
            log.error("run crashed (%s); restart %d/%d", e, restarts, max_restarts)
            traceback.print_exc()
            if restarts > max_restarts:
                raise
            time.sleep(backoff_s * restarts)
