"""Port parity: ``fluxdistributed_tpu_torch/faults.py`` against the JAX
package's ``faults.py``.

The same ``FaultPlan`` spec, fired at the same sites and indices, gives
the same sequence of outcomes in both packages (returns, exceptions by
type and message, signals delivered, value corruptions, harness
params); ``with_retries`` backs off by the same sleeps (the jitter
stream is seeded alike) and gives up alike; ``SignalFlag`` escalates on
a second signal in both.  ``acquire_backend`` is the port's own: it
counts CUDA devices through torch and never falls back to the CPU
unasked.
"""

from __future__ import annotations

import os
import signal

import pytest

from fluxdistributed_tpu import faults as jfaults
from fluxdistributed_tpu_torch import faults
from fluxdistributed_tpu_torch.obs import get_registry

MODULES = {"jax": jfaults, "port": faults}

# (spec, calls): a call is (site, index) for fire, (site, index, value)
# for fire_value
CASES = {
    "sigterm_at_step": ({"sigterm_at_step": 3},
                        [("step", i) for i in range(6)]),
    "sigint_at_step": ({"sigint_at_step": 1},
                       [("step", i) for i in range(3)]),
    "loader_fail": ({"loader_fail": {"at": 1, "times": 2}},
                    [("loader", 0), ("loader", 1), ("loader", 1),
                     ("loader", 1), ("loader", 2)]),
    "backend_unavailable": ({"backend_unavailable": 2},
                            [("backend_init", None)] * 3),
    "fail_entries": ({"fail": [
        {"site": "serve.tick", "at": 2},
        {"site": "checkpoint_save", "times": 2, "message": "disk"},
        {"site": "step", "action": "sleep", "delay": 0.01}]},
        [("serve.tick", 1), ("serve.tick", 2), ("serve.tick", 2),
         ("checkpoint_save", None), ("checkpoint_save", 5),
         ("checkpoint_save", None), ("step", 0), ("step", 1)]),
    "value_actions": ({"fail": [
        {"site": "train.loss", "at": 2, "action": "nan"},
        {"site": "train.grad", "action": "inf", "times": 2}]},
        [("train.loss", 1, 0.5), ("train.loss", 2, 0.5),
         ("train.loss", 2, 0.5), ("train.grad", 0, 1.0),
         ("train.grad", 1, 1.0), ("train.grad", 2, 1.0),
         ("train.loss", 2, None)]),
    "params": ({"params": {"local_devices": 4}, "sigterm_at_step": 0},
               [("step", 0)]),
    "unknown_key": ({"sigkill_at_step": 1}, []),
    "unknown_action": ({"fail": [{"site": "step", "action": "boom"}]}, []),
    "fail_without_site": ({"fail": [{"at": 1}]}, []),
    "unknown_fail_key": ({"fail": [{"site": "step", "when": 1}]}, []),
}


def _trace(mod, spec, calls):
    """Every outcome of ``calls`` under ``spec``'s plan, with the signals
    each call delivered."""
    got = []
    handlers = {s: signal.signal(s, lambda n, f: got.append(n))
                for s in (signal.SIGTERM, signal.SIGINT)}
    out = []
    try:
        try:
            plan = mod.FaultPlan.from_spec(spec)
        except ValueError as e:
            return [("ValueError", str(e))]
        mod.install_plan(plan)
        for call in calls:
            try:
                if len(call) == 3:
                    r = repr(mod.fire_value(call[0], call[2], index=call[1]))
                else:
                    r = mod.fire(call[0], index=call[1])
                out.append(("ok", r, list(got)))
            except Exception as e:  # noqa: BLE001 — compared below
                out.append((type(e).__name__, str(e), list(got)))
            got.clear()
        out.append(("param", mod.param("local_devices"),
                    mod.active_plan() is plan))
    finally:
        mod.clear_plan()
        for s, h in handlers.items():
            signal.signal(s, h)
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_fault_plan_fires_as_jax(case):
    spec, calls = CASES[case]
    want = _trace(jfaults, spec, calls)
    assert _trace(faults, spec, calls) == want
    assert faults.active_plan() is None and faults.param("x", 7) == 7


def test_with_retries_backs_off_as_jax():
    """Recovering after two transients, and exhausting the attempts: the
    same sleeps (exponential with the seeded jitter) and the same
    give-up, in both packages."""
    def run(mod, fail_times, tries):
        calls, slept = {"n": 0}, []

        def flaky():
            calls["n"] += 1
            if calls["n"] <= fail_times:
                raise OSError(f"transient {calls['n']}")
            return 42

        try:
            out = mod.with_retries(flaky, tries=tries, backoff=0.1,
                                   jitter=0.1, sleep=slept.append,
                                   site="unit")
        except mod.RetryBudgetExceeded as e:
            out = (str(e), type(e.__cause__).__name__)
        return out, slept, calls["n"]

    for fail_times, tries in ((2, 5), (9, 4)):
        assert run(faults, fail_times, tries) == run(jfaults, fail_times,
                                                     tries)
    got = run(faults, 2, 5)
    assert got[0] == 42 and len(got[1]) == 2 and got[1][1] > got[1][0]
    for mod in MODULES.values():
        with pytest.raises(ValueError):
            mod.with_retries(lambda: 1, tries=0)
        with pytest.raises(KeyError):  # not retryable: raised at once
            mod.with_retries(lambda: {}["x"], tries=3, sleep=lambda s: None)


@pytest.mark.parametrize("pkg", sorted(MODULES))
def test_signal_flag_escalates_on_a_second_signal(pkg):
    mod = MODULES[pkg]
    with mod.SignalFlag() as flag:
        assert flag.installed and not flag.is_set()
        os.kill(os.getpid(), signal.SIGTERM)
        assert flag.is_set() and flag.reason == "sigterm"
        assert flag.received == signal.SIGTERM
        with pytest.raises(KeyboardInterrupt, match="second signal"):
            os.kill(os.getpid(), signal.SIGTERM)
    assert not flag.installed
    assert mod.PREEMPTED_RC == 75 and mod.HALTED_RC == 65


def test_acquire_backend_counts_cuda_devices_and_never_falls_back():
    """No card here: the default (cuda) acquisition retries and gives up
    with ``BackendUnavailable`` as the cause; the CPU is returned only
    when asked for; injected unavailability is retried, and the fault
    counters land in the port's registry."""
    import torch

    reg = get_registry()
    slept = []
    if torch.cuda.is_available():  # a card: its devices, no retry
        devs = faults.acquire_backend(tries=2, timeout=None, backoff=0.01,
                                      sleep=slept.append)
        assert devs and all(d.type == "cuda" for d in devs) and not slept
    else:
        with pytest.raises(faults.RetryBudgetExceeded) as ei:
            faults.acquire_backend(tries=2, timeout=None, backoff=0.01,
                                   sleep=slept.append)
        assert isinstance(ei.value.__cause__, faults.BackendUnavailable)
        assert "No visible device" in str(ei.value.__cause__)
        assert len(slept) == 1
    with pytest.raises(ValueError, match="unsupported device"):
        faults.acquire_backend(device="meta", timeout=None)
    before = reg.value("fdtpu_fault_retries_total", "backend_init") or 0
    injected = reg.value("fdtpu_fault_injected_total", "backend_init") or 0
    faults.install_plan(faults.FaultPlan().backend_unavailable(2))
    try:
        devs = faults.acquire_backend(device="cpu", tries=3, timeout=None,
                                      backoff=0.0, sleep=lambda s: None)
    finally:
        faults.clear_plan()
    assert [d.type for d in devs] == ["cpu"]
    assert reg.value("fdtpu_fault_retries_total", "backend_init") == \
        before + 2
    assert reg.value("fdtpu_fault_injected_total", "backend_init") == \
        injected + 2


def test_loader_retries_injected_failures_bit_identically():
    """The loader's ``"loader"`` site (the JAX ``data/loader.py``'s):
    two injected failures of batch 1 cost two retries and the same
    batches; more failures than retries surface to the consumer."""
    import numpy as np

    from fluxdistributed_tpu_torch.data import PrefetchLoader, SyntheticDataset

    ds = SyntheticDataset(nsamples=32, nclasses=4, shape=(4, 4, 3))

    def draw(retries=2):
        loader = PrefetchLoader(ds, 4, cycles=3, device="cpu",
                                retries=retries)
        return [{k: v.numpy().copy() for k, v in b.items()} for b in loader]

    want = draw()
    reg = get_registry()
    before = reg.value("fdtpu_fault_retries_total", "loader") or 0
    faults.install_plan(faults.FaultPlan().loader_fail(at=1, times=2))
    try:
        got = draw()
    finally:
        faults.clear_plan()
    assert reg.value("fdtpu_fault_retries_total", "loader") == before + 2
    for a, b in zip(got, want):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    faults.install_plan(faults.FaultPlan().loader_fail(at=1, times=3))
    try:
        with pytest.raises(RuntimeError, match="prefetch worker failed"):
            draw()
    finally:
        faults.clear_plan()
