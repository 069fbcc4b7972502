"""A spawn of gloo ranks that runs while the test process computes the
JAX references: the port's sharded tests start their one rank spawn
first and join it after the JAX side has run.  (Not a test module.)"""

from __future__ import annotations

import threading

from fluxdistributed_tpu_torch.mesh import run_ranks


class Spawned:
    """``run_ranks(fn, n, *args)`` on a thread; :meth:`result` joins it
    and returns the ranks' results, or raises their error."""

    def __init__(self, fn, n: int, *args):
        self._box: dict = {}
        self._thread = threading.Thread(target=self._run, args=(fn, n, args),
                                        daemon=True)
        self._thread.start()

    def _run(self, fn, n, args):
        try:
            self._box["out"] = run_ranks(fn, n, *args)
        except BaseException as e:  # noqa: BLE001 — raised in result()
            self._box["err"] = e

    def result(self, timeout: float = 1200.0):
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError(f"the rank spawn did not end in {timeout} s")
        if "err" in self._box:
            raise self._box["err"]
        return self._box["out"]
