"""The port's trainer supervisor (``fluxdistributed_tpu_torch/
supervise.py``, a copy of the JAX package's ``bin/supervise.py``
adapted to the port's CLI): exit classification and restarts.

The fast cases of ``tests/test_supervise.py`` on the port's
``Supervisor``: fake child scripts and a test-owned metrics endpoint
prove every exit class (done, preempted, crashed, stalled, escalated,
halted) and the argv rules in seconds.  The argv rewrite and the
metrics parsing are held to ``bin/supervise.py``'s on the same inputs
(exact equality).  Then ``--smoke --device cpu``: the port's CLI on
lm_tiny with an injected NaN (quarantined by the guard) and a hang
(SIGKILLed and resumed by the supervisor), which must still finish.
"""

from __future__ import annotations

import json
import pathlib
import sys
import textwrap
import threading
import time

import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "bin"))
import supervise as jsupervise  # noqa: E402

from fluxdistributed_tpu_torch import supervise  # noqa: E402
from fluxdistributed_tpu_torch.faults import HALTED_RC, PREEMPTED_RC  # noqa: E402
from fluxdistributed_tpu_torch.obs import MetricsServer  # noqa: E402
from fluxdistributed_tpu_torch.obs.metrics import Registry  # noqa: E402


def write_child(tmp_path, body: str) -> str:
    """A fake child script; ``marker`` (argv[1]) tells the first episode
    from the restarts."""
    path = tmp_path / "child.py"
    path.write_text(textwrap.dedent(body))
    return str(path)


def run_supervisor(cmd, tmp_path, **kw):
    led = tmp_path / "ledger.json"
    kw.setdefault("verbose", False)
    kw.setdefault("poll_interval", 0.05)
    kw.setdefault("backoff", 0.01)
    sup = supervise.Supervisor(cmd, ledger=str(led), **kw)
    rc = sup.run()
    return rc, json.loads(led.read_text())


def classes(ledger):
    return [e["class"] for e in ledger["episodes"]]


PREEMPT_ONCE = """
    import os, sys
    marker = sys.argv[1]
    if not os.path.exists(marker):
        open(marker, "w").write("x")
        sys.exit(75)
    sys.exit(0)
"""


def test_preempted_then_done_appends_resume_strips_fault_plan(tmp_path):
    child = write_child(tmp_path, PREEMPT_ONCE)
    cmd = [sys.executable, child, str(tmp_path / "m"),
           "--checkpoint-dir", "ck", "--fault-plan", "{}"]
    rc, led = run_supervisor(cmd, tmp_path)
    assert rc == 0 and led["completed"]
    assert classes(led) == ["preempted", "done"]
    assert led["resumes"] == 1 and led["restarts"] == 0
    ep2 = led["episodes"][1]["argv"]
    assert "--resume" in ep2
    assert "--fault-plan" not in ep2


def test_keep_fault_plan_flag(tmp_path):
    child = write_child(tmp_path, PREEMPT_ONCE)
    cmd = [sys.executable, child, str(tmp_path / "m"), "--fault-plan", "{}"]
    rc, led = run_supervisor(cmd, tmp_path, keep_fault_plan=True)
    assert rc == 0
    assert "--fault-plan" in led["episodes"][1]["argv"]
    # no --checkpoint-dir: nothing to resume from, no --resume
    assert "--resume" not in led["episodes"][1]["argv"]


def lint_stamp(postmortem: str) -> dict:
    """The postmortem's ``lint stamp:`` line, a JSON verdict."""
    line = next(ln for ln in postmortem.splitlines()
                if ln.startswith("lint stamp: "))
    return json.loads(line[len("lint stamp: "):])


def test_crash_restarts_bounded_with_backoff(tmp_path):
    child = write_child(tmp_path, "import sys; sys.exit(3)\n")
    rc, led = run_supervisor([sys.executable, child], tmp_path,
                             max_restarts=2)
    assert rc == 3
    assert classes(led) == ["crashed"] * 3
    assert led["result"] == "restart_budget_exhausted"
    assert not led["completed"]
    assert all(e["action"] != "stop" for e in led["episodes"][:-1])
    # a bad end writes the postmortem, with the port's lint stamp
    pm = (tmp_path / "ledger.json.postmortem.txt").read_text()
    stamp = lint_stamp(pm)
    assert stamp["new"] == 0 and set(stamp["layers"]) == {
        "ast", "concurrency"}


def test_guard_halt_rc_stops_immediately(tmp_path):
    child = write_child(tmp_path, f"import sys; sys.exit({HALTED_RC})\n")
    rc, led = run_supervisor([sys.executable, child], tmp_path)
    assert rc == HALTED_RC
    assert classes(led) == ["halted"]
    assert led["result"] == "halted" and not led["completed"]


def test_resume_budget_bounded(tmp_path):
    child = write_child(tmp_path, f"import sys; sys.exit({PREEMPTED_RC})\n")
    rc, led = run_supervisor([sys.executable, child], tmp_path,
                             max_resumes=2)
    assert rc == PREEMPTED_RC
    assert classes(led) == ["preempted"] * 3
    assert led["result"] == "resume_budget_exhausted"


def test_episode_records_in_the_runs_ledger(tmp_path):
    child = write_child(tmp_path, PREEMPT_ONCE)
    runs = tmp_path / "runs.jsonl"
    rc, _ = run_supervisor([sys.executable, child, str(tmp_path / "m")],
                           tmp_path, runs_ledger=str(runs))
    recs = [json.loads(line) for line in runs.read_text().splitlines()]
    assert rc == 0
    assert [r["phase"] for r in recs] == ["preempted", "done"]
    assert all(r["kind"] == "episode" for r in recs)


@pytest.fixture()
def metrics_endpoint():
    reg = Registry()
    srv = MetricsServer(registry=reg)
    srv.start(host="127.0.0.1", port=0)
    yield reg, srv.port
    srv.stop()


STALL_CHILD = """
    import os, sys, time
    marker, port = sys.argv[1], sys.argv[2]
    if not os.path.exists(marker):
        open(marker, "w").write("x")
        print(f"metrics: http://0.0.0.0:{port}/metrics (+ /healthz)",
              flush=True)
        time.sleep(120)  # wedged: the steps counter never moves again
    sys.exit(0)
"""


def test_stalled_child_is_sigkilled_and_restarted(tmp_path,
                                                  metrics_endpoint):
    reg, port = metrics_endpoint
    reg.counter("fdtpu_train_steps_total", "x").inc(3)
    child = write_child(tmp_path, STALL_CHILD)
    cmd = [sys.executable, child, str(tmp_path / "m"), str(port)]
    rc, led = run_supervisor(cmd, tmp_path, stall_timeout=1.0,
                             startup_grace=10.0)
    assert rc == 0 and led["completed"]
    assert classes(led) == ["stalled", "done"]
    assert led["episodes"][0]["steps"] == 3
    assert "fdtpu_train_steps_total" in led["episodes"][0]["counters"]


def test_watchdog_escalation_triggers_kill(tmp_path, metrics_endpoint):
    reg, port = metrics_endpoint
    reg.counter("fdtpu_train_steps_total", "x").inc(1)
    esc = reg.counter("fdtpu_watchdog_escalations_total", "x")
    child = write_child(tmp_path, STALL_CHILD)
    cmd = [sys.executable, child, str(tmp_path / "m"), str(port)]

    def tick():
        time.sleep(0.7)
        esc.inc()

    threading.Thread(target=tick, daemon=True).start()
    rc, led = run_supervisor(cmd, tmp_path, stall_timeout=30.0,
                             startup_grace=10.0)
    assert rc == 0
    assert classes(led) == ["escalated", "done"]
    assert led["episodes"][0]["wall_seconds"] < 10


METRICS_TEXT = ("# HELP x y\n# TYPE x counter\n"
                "fdtpu_train_steps_total 7\n"
                'fdtpu_fault_injected_total{site="a"} 2\n'
                'fdtpu_fault_injected_total{site="b"} 3\n'
                "not a number nan_is_fine nope\n")


def test_metrics_parsing_helpers():
    m = supervise.parse_metrics(METRICS_TEXT)
    assert m == jsupervise.parse_metrics(METRICS_TEXT)
    for name, want in (("fdtpu_train_steps_total", 7),
                       ("fdtpu_fault_injected_total", 5), ("missing", 0)):
        assert supervise.series_value(m, name) == want
        assert jsupervise.series_value(m, name) == want


@pytest.mark.parametrize("argv", [
    ["python", "-m", "t", "--checkpoint-dir", "ck", "--fault-plan", "{}"],
    ["python", "-m", "t", "--checkpoint-dir=ck", "--fault-plan={}"],
    ["python", "-m", "t", "--fault-plan", "{}", "--lr", "0.1"],
    ["python", "-m", "t", "--checkpoint-dir", "ck", "--resume"],
])
@pytest.mark.parametrize("keep", [False, True])
def test_argv_rules_match_bin_supervise(argv, keep):
    ours = supervise.Supervisor(argv, keep_fault_plan=keep, verbose=False)
    ref = jsupervise.Supervisor(argv, keep_fault_plan=keep, verbose=False)
    for first in (True, False):
        assert ours.episode_argv(first) == ref.episode_argv(first)
    for cls in ("done", "preempted", "halted", "crashed", "stalled",
                "escalated", "terminated"):
        assert ours._decide(cls) == ref._decide(cls), cls


def test_smoke_on_the_cpu(tmp_path):
    """The NaN is quarantined, the hang is killed and resumed, and the
    run finishes."""
    led = tmp_path / "ledger.json"
    rc = supervise.main(["--smoke", "--device", "cpu", "--quiet",
                         "--stall-timeout", "5", "--startup-grace", "30",
                         "--ledger", str(led)])
    assert rc == 0
    ledger = json.loads(led.read_text())
    cls = classes(ledger)
    assert ledger["completed"] and cls[-1] == "done"
    assert any(c in ("stalled", "escalated") for c in cls), cls
    assert "--fault-plan" not in ledger["episodes"][-1]["argv"]
    assert "--resume" in ledger["episodes"][-1]["argv"]


def test_crash_smoke_on_the_cpu(tmp_path):
    """A hard exit at step 12 with the flight recorder on: the dump is
    footer-less, its last record within a flush interval of the death,
    and the postmortem calls the death hard (with the port's lint
    stamp)."""
    led = tmp_path / "crash-ledger.json"
    rc = supervise.main(["--crash-smoke", "--device", "cpu", "--quiet",
                         "--ledger", str(led), "--artifacts",
                         str(tmp_path / "art")])
    assert rc == 0
    pm = (tmp_path / "crash-ledger.json.postmortem.txt").read_text()
    assert "hard death" in pm
    assert set(lint_stamp(pm)["layers"]) == {"ast", "concurrency"}
