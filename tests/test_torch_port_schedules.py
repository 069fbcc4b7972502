"""The port's deterministic-schedule race harness
(``fluxdistributed_tpu_torch/analysis/schedules.py``) against the JAX
package's, and over the port's own threaded objects.

Three blocks:

* **the harness** — plan mechanics (crossing accounting, explicit
  preemptions, seeded fuzz, the reproducer spec), interposition, and
  the toy pair of ``fixtures_analysis/toy_racy_scheduler.py`` loaded
  over the port's harness: the seeded race fails under its forced
  schedule, never without interposition, and the fixed variant
  survives the same schedule.  A seed's fuzz pattern and a plan's spec
  equal the JAX harness's.
* **the port's objects** — the ``Scheduler`` over
  ``serve/testing.FakeLMEngine`` under a fuzzed schedule, drain under
  preemption, concurrent ``FaultPlan`` arming, ``StepWatchdog`` beats
  and the ``FlightRecorder``, each instrumented, with the JAX suite's
  invariants (tokens match the ``fake_tokens`` oracle, drain admissions
  are all-or-nothing, no armed fault, beat or record is lost).
* the static pin: the port's ``faults.py`` and ``serve/scheduler.py``
  scan FDT3xx clean.
"""

import json
import os
import sys
import threading
import types

import pytest

from fluxdistributed_tpu.analysis import schedules as jschedules
from fluxdistributed_tpu_torch import faults
from fluxdistributed_tpu_torch.analysis import concurrency, schedules
from fluxdistributed_tpu_torch.obs import FlightRecorder, Registry, StepWatchdog
from fluxdistributed_tpu_torch.serve.scheduler import (Draining, Request,
                                                       Scheduler)
from fluxdistributed_tpu_torch.serve.testing import FakeLMEngine, fake_tokens

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures_analysis")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOY_SITE = "RacyToyScheduler._lock.release"


def _load_toy():
    """The toy fixture, its harness import bound to the port's
    harness."""
    path = os.path.join(FIXTURES, "toy_racy_scheduler.py")
    src = open(path).read()
    src = src.replace("from fluxdistributed_tpu.analysis import schedules",
                      "from fluxdistributed_tpu_torch.analysis import "
                      "schedules")
    assert "fluxdistributed_tpu_torch.analysis" in src
    mod = types.ModuleType("toy_racy_scheduler_port")
    exec(compile(src, path, "exec"), mod.__dict__)
    return mod


@pytest.fixture(autouse=True)
def _no_leaked_schedule():
    # a leaked plan would silently stall every other test's locks
    yield
    schedules.clear_schedule()
    assert schedules.active_schedule() is None


# ------------------------------------------------------------- the harness

def test_plan_counts_crossings_and_fires_explicit_preempt():
    plan = schedules.SchedulePlan()
    plan.preempt_at("a.acquire", at=2, delay=0.0)
    for _ in range(3):
        plan.cross("a.acquire")
    plan.cross("b.release")
    assert plan.crossings("a.acquire") == 3
    assert plan.crossings() == {"a.acquire": 3, "b.release": 1}
    assert plan.fired == 1
    hits = [e for e in plan.spec()["log"] if e["hit"]]
    assert [(e["site"], e["n"]) for e in hits] == [("a.acquire", 2)]


def test_plan_validates_arguments():
    plan = schedules.SchedulePlan()
    for bad in (lambda: plan.preempt_at("x", at=0),
                lambda: plan.preempt_at("x", delay=-1.0),
                lambda: plan.fuzz(prob=1.5)):
        with pytest.raises(ValueError):
            bad()


@pytest.mark.parametrize("seed", [0, 11, 12])
def test_fuzz_pattern_equals_the_jax_harness(seed):
    """A seed's stall pattern is a pure function of (seed, site, index),
    the same in both harnesses."""
    def pattern(mod):
        plan = mod.SchedulePlan(seed=seed).fuzz(prob=0.5, delay=0.0)
        for i in range(40):
            plan.cross(f"site{i % 4}.held")
        return tuple(e["hit"] for e in plan.spec()["log"])

    a = pattern(schedules)
    assert a == pattern(jschedules)
    assert any(a) and not all(a)


def test_spec_roundtrip_dump_and_jax_parity(tmp_path):
    def build(mod):
        plan = mod.SchedulePlan(seed=7)
        plan.preempt_at("s.release", at=3, times=2, delay=0.01)
        plan.fuzz(prob=0.1, delay=0.002)
        return plan

    spec = build(schedules).spec()
    assert spec == build(jschedules).spec()
    assert spec["schema"] == "fdtpu-schedule-repro/v1"
    clone = schedules.SchedulePlan.from_spec(spec).spec()
    assert (clone["seed"], clone["preempt"], clone["fuzz"]) == (
        7, spec["preempt"], spec["fuzz"])
    path = build(schedules).dump(str(tmp_path / "sub" / "repro.json"))
    assert json.load(open(path))["preempt"][0]["site"] == "s.release"


def test_run_under_schedule_dumps_reproducer_on_failure(tmp_path,
                                                        monkeypatch):
    monkeypatch.setenv(schedules.REPRO_DIR_ENV, str(tmp_path))
    plan = schedules.SchedulePlan(seed=3).preempt_at("x.held", delay=0.0)

    def boom():
        schedules.cross("x.held")
        raise AssertionError("race caught")

    with pytest.raises(AssertionError):
        schedules.run_under_schedule(plan, boom, repro_name="toy")
    assert schedules.active_schedule() is None
    repro = json.load(open(tmp_path / "toy-seed3.json"))
    assert repro["fired"] == 1 and repro["crossings"] == {"x.held": 1}
    # the success path dumps nothing
    assert schedules.run_under_schedule(
        schedules.SchedulePlan(seed=4), lambda: 41 + 1) == 42
    assert os.listdir(tmp_path) == ["toy-seed3.json"]


def test_instrument_swaps_primitives_idempotently():
    class Thing:
        def __init__(self):
            self._lock = threading.Lock()
            self._rlock = threading.RLock()
            self._ev = threading.Event()
            self.data = []

    t = schedules.instrument(Thing())
    assert isinstance(t._lock, schedules.TracedLock)
    assert isinstance(t._rlock, schedules.TracedLock)
    assert isinstance(t._ev, schedules.TracedEvent)
    assert t._lock.site == "Thing._lock"
    first = t._lock
    assert schedules.instrument(t)._lock is first
    with t._lock:
        assert t._lock.locked()
    assert not t._lock.locked()
    t._ev.set()
    assert t._ev.is_set() and t._ev.wait(0)
    schedules.cross("anything.at.all")  # inert with no plan installed
    plan = schedules.install_schedule(schedules.SchedulePlan())
    try:
        with t._lock:
            pass
        assert plan.crossings() == {"Thing._lock.acquire": 1,
                                    "Thing._lock.held": 1,
                                    "Thing._lock.release": 1}
    finally:
        schedules.clear_schedule()


def test_toy_race_caught_under_forced_schedule():
    toy = _load_toy()
    plan = schedules.SchedulePlan(seed=1).preempt_at(TOY_SITE, at=1,
                                                     delay=0.05)
    assert toy.lost_update_under(plan) is True
    assert plan.fired >= 1


def test_toy_race_missed_without_interposition():
    toy = _load_toy()
    old = sys.getswitchinterval()
    sys.setswitchinterval(0.5)
    try:
        for _ in range(20):
            assert toy.hammer(toy.RacyToyScheduler()) == 2
    finally:
        sys.setswitchinterval(old)


@pytest.mark.parametrize("fuzz_seed", [None, 0, 1, 2])
def test_toy_fix_survives_the_hostile_schedules(fuzz_seed):
    toy = _load_toy()
    if fuzz_seed is None:
        plan = schedules.SchedulePlan(seed=1).preempt_at(
            "FixedToyScheduler._lock.release", at=1, delay=0.05)
    else:
        plan = schedules.SchedulePlan(seed=fuzz_seed).fuzz(prob=0.5,
                                                           delay=0.01)
    assert toy.lost_update_under(plan, cls=toy.FixedToyScheduler) is False
    if fuzz_seed is None:
        assert plan.fired >= 1


# ------------------------------------------------------- the port's objects

def _drive_until(sched, pred, max_steps=100_000):
    for _ in range(max_steps):
        if pred():
            return
        sched.step()
    raise AssertionError("driver did not reach condition")


def test_scheduler_tokens_correct_under_fuzzed_schedule():
    eng = FakeLMEngine(max_slots=2)
    sched = schedules.instrument(Scheduler(eng, max_queue=64))
    reqs = [Request(prompt=[i, i + 1], max_new_tokens=4) for i in range(8)]
    plan = schedules.SchedulePlan(seed=5).fuzz(prob=0.3, delay=0.002)

    def run():
        barrier = threading.Barrier(2)

        def submitter(chunk):
            barrier.wait()
            for r in chunk:
                sched.submit(r)

        threads = [threading.Thread(target=submitter, args=(reqs[i::2],))
                   for i in range(2)]
        for t in threads:
            t.start()
        _drive_until(sched, lambda: all(r.done.is_set() for r in reqs))
        for t in threads:
            t.join()

    schedules.run_under_schedule(plan, run)
    assert plan.fired > 0
    for r in reqs:
        assert r.generated == fake_tokens(r.prompt, r.max_new_tokens)
    m = sched.metrics()
    assert m["requests_submitted"] == 8 and m["requests_finished"] == 8


def test_scheduler_drain_is_all_or_nothing_under_preemption():
    eng = FakeLMEngine(max_slots=2)
    sched = schedules.instrument(Scheduler(eng, max_queue=64))
    plan = schedules.SchedulePlan(seed=9)
    plan.preempt_at("Scheduler._lock.held", at=3, times=4, delay=0.01)
    accepted, refused = [], []
    acc_lock = threading.Lock()

    def run():
        barrier = threading.Barrier(3)

        def submitter(base):
            barrier.wait()
            for i in range(6):
                r = Request(prompt=[base, i], max_new_tokens=3)
                try:
                    sched.submit(r)
                except Draining:
                    with acc_lock:
                        refused.append(r)
                else:
                    with acc_lock:
                        accepted.append(r)

        threads = [threading.Thread(target=submitter, args=(b,))
                   for b in (10, 20)]
        for t in threads:
            t.start()
        barrier.wait()
        sched.begin_drain()
        for t in threads:
            t.join()
        sched.run_until_idle()

    schedules.run_under_schedule(plan, run)
    assert plan.fired > 0
    assert len(accepted) + len(refused) == 12
    for r in accepted:
        assert r.done.is_set()
        assert r.generated == fake_tokens(r.prompt, r.max_new_tokens)
    for r in refused:
        assert not r.done.is_set() and r.generated == []
    with pytest.raises(Draining):
        sched.submit(Request(prompt=[1], max_new_tokens=1))


def test_faultplan_concurrent_arming_under_preemption():
    plan = schedules.SchedulePlan(seed=4).fuzz(prob=0.4, delay=0.002)
    fp = schedules.instrument(faults.FaultPlan())
    fired = []

    def run():
        barrier = threading.Barrier(3)

        def armer(k):
            barrier.wait()
            for i in range(5):
                fp.fail(f"site-{k}-{i}", message="x")

        def firer():
            barrier.wait()
            for _ in range(40):
                try:
                    fp.fire("site-0-0")
                except faults.FaultInjected:
                    fired.append(1)

        threads = [threading.Thread(target=armer, args=(k,))
                   for k in (0, 1)] + [threading.Thread(target=firer)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    schedules.run_under_schedule(plan, run)
    assert plan.fired > 0
    # every armed fault is present: each never-fired single-shot site
    # still raises exactly once
    for k in (0, 1):
        for i in range(5):
            if (k, i) == (0, 0) and fired:
                continue
            with pytest.raises(faults.FaultInjected):
                fp.fire(f"site-{k}-{i}")


def test_watchdog_concurrent_beats_under_fuzz():
    reg = Registry()
    wd = schedules.instrument(StepWatchdog(registry=reg))
    plan = schedules.SchedulePlan(seed=6).fuzz(prob=0.3, delay=0.001)

    def run():
        barrier = threading.Barrier(2)

        def beater():
            barrier.wait()
            for _ in range(50):
                wd.beat()

        threads = [threading.Thread(target=beater) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wd.poll()

    schedules.run_under_schedule(plan, run)
    assert plan.fired > 0
    assert wd._beats == 100
    assert reg.value("fdtpu_watchdog_stalls_total") == 0.0


def test_flight_recorder_loses_nothing_under_fuzz(tmp_path):
    path = str(tmp_path / "flight.jsonl")
    fr = schedules.instrument(FlightRecorder(path, ring=512, flush_every=4))
    plan = schedules.SchedulePlan(seed=8).fuzz(prob=0.3, delay=0.001)

    def run():
        barrier = threading.Barrier(3)

        def writer(k):
            barrier.wait()
            for i in range(40):
                fr.record(src=k, i=i)

        threads = [threading.Thread(target=writer, args=(k,))
                   for k in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    schedules.run_under_schedule(plan, run)
    assert plan.fired > 0
    assert fr.recorded == 120
    fr.dump("ok")
    recs = [r for r in (json.loads(ln) for ln in open(path) if ln.strip())
            if r.get("kind") == "record"]
    assert len(recs) == 120
    for k in range(3):
        assert [r["i"] for r in recs if r["src"] == k] == list(range(40))


@pytest.mark.parametrize("rel", ["fluxdistributed_tpu_torch/faults.py",
                                 "fluxdistributed_tpu_torch/serve/scheduler.py"])
def test_fixed_sites_scan_clean(rel):
    assert concurrency.run_concurrency_checks(
        [os.path.join(ROOT, rel)]) == []
