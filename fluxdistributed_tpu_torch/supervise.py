"""Trainer supervisor: keep a run of the port's training CLI finishing
itself (``python -m fluxdistributed_tpu_torch.supervise``).

A copy of the JAX package's ``bin/supervise.py``, adapted to the port's
CLI: spawn the trainer, watch its heartbeats, classify every exit, and
restart within a bounded budget, so a run survives crashes, preemptions
and wedged collectives with no human input::

    python -m fluxdistributed_tpu_torch.supervise --ledger run/ledger.json \
        -- python -m fluxdistributed_tpu_torch.train --model lm_small ... \
            --checkpoint-dir run/ck --guard --metrics-port 0

Exit classification (the supervisor's whole job):

* **rc 0**: done; the supervisor exits 0.
* **rc 75** (``faults.PREEMPTED_RC``): the run checkpointed on SIGTERM;
  restart at once with ``--resume`` (bounded by ``--max-resumes``, no
  backoff: preemption is expected weather).
* **rc 65** (``faults.HALTED_RC``): the guard halted; not retryable by
  construction, so the supervisor stops and propagates the rc.
* **stall**: heartbeats stop.  The scraped ``fdtpu_train_steps_total``
  counter freezes past ``--stall-timeout`` (the metrics endpoint answers
  from its own thread while the loop is wedged), or
  ``fdtpu_watchdog_escalations_total`` ticks (the in-process
  wedged-collective verdict).  While the child's pause-aware watchdog
  reports not stalled, a frozen counter is long legitimate work (the
  first step's kernel builds, a blocking checkpoint) and the kill waits,
  bounded by ``--startup-grace``.  Then SIGKILL (a wedged loop cannot run
  a SIGTERM checkpoint anyway) and restart with ``--resume``: the
  guard's blocking checkpoints and the RESUME manifest make the kill
  lossless.
* **any other rc**: a crash; restart with ``--resume`` under exponential
  backoff, bounded by ``--max-restarts``.

Heartbeats come from the trainer's ``--metrics-port`` endpoint (the
supervisor reads the bound port off the ``metrics: http://...`` stdout
line, so ``--metrics-port 0`` works); before that line appears, stdout
activity itself is the liveness signal (bounded by ``--startup-grace``).

``--fault-plan`` is stripped from restart argv by default: an injected
fault models one occurrence of weather, and replaying it on every
restart would wedge the supervisor in the loop it exists to break
(``--keep-fault-plan`` keeps it, for chaos soaks).

Every episode lands in the ledger JSON (``--ledger``): rc,
classification, action taken, wall seconds, last step count and a
snapshot of the ``fdtpu_guard_* / fdtpu_fault_* / fdtpu_watchdog_*``
counters scraped before the exit; ``--runs-ledger`` appends one
``obs.runs`` record an episode, and a supervision that ends badly
writes a postmortem (the child's flight dump and the ledgers merged
into one timeline).  The postmortem's lint stamp reads the JAX
package's static-analysis pass, which the port does not have: it says
``unavailable``.

``--smoke`` runs the self-contained gate: the port's CLI on ``lm_tiny``
under a fault plan that injects a NaN (quarantined by the guard) and
then a hang (SIGKILLed and resumed by the supervisor); the run must
still finish.  ``--crash-smoke`` kills the CLI hard mid-run and checks
the flight dump and the postmortem.  Both run on the card unless given
``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from collections import deque
from typing import List, Optional

from .faults import HALTED_RC, PREEMPTED_RC

# the checkout's root: the children run from it and import the package
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: stdout line the trainer prints once its metrics endpoint is bound
METRICS_LINE_RE = re.compile(r"metrics: http://[^:]+:(\d+)/metrics")

#: metric families snapshotted into each ledger episode — the "why it
#: died" forensics
LEDGER_PREFIXES = ("fdtpu_guard_", "fdtpu_fault_", "fdtpu_watchdog_",
                   "fdtpu_train_steps_total",
                   "fdtpu_train_oom_skipped_total")


def parse_metrics(text: str) -> dict:
    """Prometheus exposition -> ``{series: value}`` (labels kept in the
    series name, like ``Registry.snapshot()``)."""
    out: dict = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        series, _, value = line.rpartition(" ")
        try:
            out[series] = float(value)
        except ValueError:
            continue
    return out


def series_value(metrics: dict, name: str) -> float:
    """Sum of every sample of family ``name`` (labeled or not)."""
    total = 0.0
    for k, v in metrics.items():
        if k == name or k.startswith(name + "{"):
            total += v
    return total


class Supervisor:
    """Spawn-watch-classify-restart for one trainer command.

    ``cmd`` is the full child argv (``[python, -m,
    fluxdistributed_tpu_torch.train, ...]``).
    The class is importable so tests drive it against fake children;
    :func:`main` is the CLI.
    """

    def __init__(
        self,
        cmd: List[str],
        ledger: Optional[str] = None,
        max_restarts: int = 3,
        max_resumes: int = 32,
        stall_timeout: float = 120.0,
        startup_grace: float = 600.0,
        poll_interval: float = 0.5,
        backoff: float = 5.0,
        backoff_cap: float = 300.0,
        keep_fault_plan: bool = False,
        verbose: bool = True,
        env: Optional[dict] = None,
        runs_ledger: Optional[str] = None,
    ):
        self.cmd = list(cmd)
        # the child must resolve the package even when it is not
        # installed (a checkout): front-load the checkout's root
        self.env = dict(os.environ, **(env or {}))
        self.env["PYTHONPATH"] = REPO + os.pathsep + self.env.get(
            "PYTHONPATH", "")
        self.ledger_path = ledger
        self.max_restarts = max_restarts
        self.max_resumes = max_resumes
        self.stall_timeout = stall_timeout
        self.startup_grace = startup_grace
        self.poll_interval = poll_interval
        self.backoff = backoff
        self.backoff_cap = backoff_cap
        self.keep_fault_plan = keep_fault_plan
        self.verbose = verbose
        #: cross-run ledger (obs.runs JSONL): one record per EPISODE,
        #: so the history survives even when the per-run ledger JSON is
        #: overwritten by the next supervision
        self.runs_ledger = runs_ledger
        self.episodes: List[dict] = []
        self.restarts = 0  # crash/stall restarts (budgeted + backoff)
        self.resumes = 0   # rc-75 requeues (budgeted, no backoff)
        self._terminate = threading.Event()
        self._metrics_url: Optional[str] = None
        self._last_line_at = time.monotonic()
        self._tail: deque = deque(maxlen=30)

    # -- argv shaping --------------------------------------------------
    def episode_argv(self, first: bool) -> List[str]:
        """The child argv for this episode: restarts gain ``--resume``
        (when a ``--checkpoint-dir`` exists to resume from) and drop
        the fault plan — an injected fault is one occurrence of
        weather, not a curse on every successor."""
        argv = list(self.cmd)
        if first:
            return argv
        if not self.keep_fault_plan:
            # both argparse spellings: "--fault-plan X" and
            # "--fault-plan=X"
            out = []
            skip_next = False
            for tok in argv:
                if skip_next:
                    skip_next = False
                    continue
                if tok == "--fault-plan":
                    skip_next = True
                    continue
                if tok.startswith("--fault-plan="):
                    continue
                out.append(tok)
            argv = out
        has_ckpt = any(t == "--checkpoint-dir"
                       or t.startswith("--checkpoint-dir=") for t in argv)
        if has_ckpt and "--resume" not in argv:
            argv.append("--resume")
        return argv

    # -- child watching ------------------------------------------------
    def _pump(self, proc: subprocess.Popen, name: str) -> None:
        try:
            for line in proc.stdout:  # type: ignore[union-attr]
                self._last_line_at = time.monotonic()
                m = METRICS_LINE_RE.search(line)
                if m:
                    self._metrics_url = (
                        f"http://127.0.0.1:{m.group(1)}/metrics")
                self._tail.append(line.rstrip()[:300])
                if self.verbose:
                    sys.stderr.write(f"[{name}] {line}")
        except (ValueError, OSError):
            pass  # stream closed at teardown

    def _scrape(self) -> Optional[dict]:
        url = self._metrics_url
        if url is None:
            return None
        try:
            with urllib.request.urlopen(url, timeout=2.0) as r:
                return parse_metrics(r.read().decode())
        except Exception:  # noqa: BLE001 — an unscrapeable endpoint is
            # just "no heartbeat this poll", never a supervisor crash
            return None

    def _watch(self, proc: subprocess.Popen) -> dict:
        """Block until the child exits (or we kill it); returns
        ``{rc, cls, steps, counters}`` — the raw episode verdict."""
        started = time.monotonic()
        self._metrics_url = None
        self._last_line_at = started
        last_steps = -1.0
        last_progress = started
        esc_seen: Optional[float] = None
        counters: dict = {}
        kill_cls: Optional[str] = None
        # the in-process watchdog's stalled gauge from the last good
        # scrape (None = absent/disabled): it is pause-aware (compiles,
        # blocking checkpoints, evals are exempt in-process), so while
        # it reads healthy a frozen step counter is long legitimate
        # work, not a wedge — deferral is bounded by startup_grace
        wd_gauge: Optional[float] = None
        scrape_ok = False
        while True:
            rc = proc.poll()
            if rc is not None:
                break
            if self._terminate.is_set():
                # forward the supervisor's own SIGTERM: the child gets
                # its graceful checkpoint-and-exit window
                try:
                    proc.send_signal(signal.SIGTERM)
                except (ProcessLookupError, OSError):
                    pass
                try:
                    proc.wait(timeout=self.stall_timeout)
                except subprocess.TimeoutExpired:
                    proc.kill()
                rc = proc.wait()
                kill_cls = "terminated"
                break
            time.sleep(self.poll_interval)
            now = time.monotonic()
            m = self._scrape()
            scrape_ok = m is not None
            if m is not None:
                counters = {k: v for k, v in m.items()
                            if k.startswith(LEDGER_PREFIXES)}
                steps = series_value(m, "fdtpu_train_steps_total")
                if steps > last_steps:
                    last_steps = steps
                    last_progress = now
                wd_gauge = (m["fdtpu_watchdog_stalled"]
                            if "fdtpu_watchdog_stalled" in m else None)
                esc = series_value(m, "fdtpu_watchdog_escalations_total")
                if esc_seen is None:
                    esc_seen = esc
                elif esc > esc_seen:
                    kill_cls = "escalated"
            elif self._metrics_url is None:
                # pre-endpoint (import + compile): stdout is the pulse
                if self._last_line_at > last_progress:
                    last_progress = self._last_line_at
                if now - last_progress <= self.startup_grace:
                    continue
                kill_cls = "stalled"
            if kill_cls is None and now - last_progress > self.stall_timeout:
                # frozen steps, but the endpoint answers and the
                # pause-aware watchdog says not-stalled: a long compile
                # or blocking checkpoint, not a wedge — hold fire until
                # startup_grace bounds even that (a dead watchdog
                # thread must not grant immortality)
                healthy_wait = (scrape_ok and wd_gauge is not None
                                and wd_gauge < 1)
                if not healthy_wait or now - last_progress > max(
                        self.stall_timeout, self.startup_grace):
                    kill_cls = "stalled"
            if kill_cls is not None:
                # SIGKILL, not SIGTERM: a wedged collective cannot run
                # the checkpoint-on-signal path, and the guard's
                # blocking checkpoints already made the kill lossless
                proc.kill()
                rc = proc.wait()
                break
        return {"rc": rc, "cls": kill_cls, "steps": max(last_steps, 0.0),
                "counters": counters}

    # -- the supervision loop ------------------------------------------
    def run(self) -> int:
        previous = {}
        for s in (signal.SIGTERM, signal.SIGINT):
            try:
                previous[s] = signal.signal(
                    s, lambda *_: self._terminate.set())
            except ValueError:
                pass  # not the main thread (tests)
        try:
            return self._run()
        finally:
            for s, old in previous.items():
                try:
                    signal.signal(s, old)
                except (ValueError, OSError):
                    pass

    def _run(self) -> int:
        result = "running"
        rc = 1
        n = 0
        while True:
            n += 1
            argv = self.episode_argv(first=n == 1)
            t0 = time.monotonic()
            self._tail.clear()  # each episode's ledger tail is its own
            proc = subprocess.Popen(
                argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True, bufsize=1, cwd=REPO, env=self.env)
            pump = threading.Thread(
                target=self._pump, args=(proc, f"ep{n}"), daemon=True)
            pump.start()
            verdict = self._watch(proc)
            pump.join(timeout=5)
            rc = verdict["rc"]
            cls = verdict["cls"] or {
                0: "done", PREEMPTED_RC: "preempted", HALTED_RC: "halted",
            }.get(rc, "crashed")
            episode = {
                "n": n, "argv": argv, "rc": rc, "class": cls,
                "wall_seconds": round(time.monotonic() - t0, 2),
                "steps": verdict["steps"],
                "counters": verdict["counters"],
                "log_tail": list(self._tail),
            }
            action, result = self._decide(cls)
            episode["action"] = action
            self.episodes.append(episode)
            self._append_episode_record(episode, result)
            self._log(f"episode {n}: rc={rc} class={cls} -> {action}")
            self.write_ledger(result)
            if action == "stop":
                break
            if action == "restart_backoff":
                pause = min(self.backoff * (2 ** (self.restarts - 1)),
                            self.backoff_cap)
                self._log(f"backing off {pause:.1f}s before restart")
                time.sleep(pause)
        self.write_ledger(result)
        if result not in ("done", "terminated"):
            # the supervision ended badly: merge the evidence into ONE
            # timeline NOW, while it is fresh — the operator reads a
            # postmortem, not four artifact files
            self.write_postmortem(result)
        if result == "done":
            return 0
        # a SIGKILLed child reports a negative rc; normalize so the
        # shell-visible code stays meaningful (75/65 propagate)
        return rc if isinstance(rc, int) and rc > 0 else 1

    def _decide(self, cls: str):
        """(action, running-result) for one classified exit."""
        if cls == "done":
            return "stop", "done"
        if cls in ("halted", "terminated"):
            # halted: retryable=false by construction; terminated: the
            # OPERATOR stopped us — both end supervision, rc propagates
            return "stop", cls
        if cls == "preempted":
            self.resumes += 1
            if self.resumes > self.max_resumes:
                return "stop", "resume_budget_exhausted"
            return "restart", "running"
        # crashed / stalled / escalated consume the restart budget;
        # stalls restart immediately (the chip was fine, the process
        # was not), crashes back off
        self.restarts += 1
        if self.restarts > self.max_restarts:
            return "stop", "restart_budget_exhausted"
        if cls == "crashed":
            return "restart_backoff", "running"
        return "restart", "running"

    # -- ledger --------------------------------------------------------
    def write_ledger(self, result: str) -> None:
        if not self.ledger_path:
            return
        payload = {
            "version": 1,
            "cmd": self.cmd,
            "episodes": self.episodes,
            "restarts": self.restarts,
            "resumes": self.resumes,
            "result": result,
            "completed": result == "done",
        }
        path = self.ledger_path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=2)
            f.write("\n")
        os.replace(tmp, path)

    def child_flight(self) -> Optional[str]:
        """The child's ``--flight`` dump path, scanned off the argv —
        the black box the postmortem opens when an episode hard-dies."""
        for i, tok in enumerate(self.cmd):
            if tok == "--flight" and i + 1 < len(self.cmd):
                return self.cmd[i + 1]
            if tok.startswith("--flight="):
                return tok.split("=", 1)[1]
        return None

    def _append_episode_record(self, episode: dict, result: str) -> None:
        """One cross-run ledger record per episode (obs.runs schema).
        The per-run ledger JSON is atomically OVERWRITTEN each episode;
        the append-only runs ledger is where episode history outlives
        the next supervision.  Best-effort by contract."""
        if not self.runs_ledger:
            return
        try:
            from .obs import runs as runs_lib

            cls = episode["class"]
            runs_lib.append_run(self.runs_ledger, runs_lib.run_record(
                "episode",
                phase=cls,
                retryable=cls in ("preempted", "crashed", "stalled",
                                  "escalated"),
                error=(None if cls == "done" else
                       f"episode class={cls} rc={episode['rc']}"),
                metrics={"steps": episode["steps"],
                         "wall_seconds": episode["wall_seconds"]},
                flight=self.child_flight(),
                episode=episode["n"],
                action=episode["action"],
                result=result,
            ))
        except Exception as e:  # noqa: BLE001 — forensics only
            self._log(f"runs-ledger append failed: "
                      f"{type(e).__name__}: {e}")

    def write_postmortem(self, result: str) -> Optional[str]:
        """Merge the child's flight dump + this supervision's episode
        ledger into one human-readable timeline (obs.runs), print it to
        stderr and (with ``--ledger``) persist it alongside as
        ``<ledger>.postmortem.txt``.  Returns the written path."""
        try:
            from .obs import runs as runs_lib

            text = runs_lib.postmortem_timeline(
                flight_path=self.child_flight(),
                supervisor_ledger=self.ledger_path,
                runs_path=self.runs_ledger)
            text += f"\nsupervision result: {result}"
            # static-health stamp (own guard: the lint pass parsing the
            # tree must not take the postmortem down with it) — a crash
            # report that says "new: 3, concurrency: 2" points straight
            # at an unlocked write before anyone replays the run
            try:
                from . import analysis

                text += ("\nlint stamp: "
                         + json.dumps(analysis.lint_verdict(),
                                      sort_keys=True))
            except Exception as e:  # noqa: BLE001 — forensics only
                text += (f"\nlint stamp: unavailable "
                         f"({type(e).__name__}: {e})"[:200])
            print(text, file=sys.stderr)
            if not self.ledger_path:
                return None
            path = self.ledger_path + ".postmortem.txt"
            with open(path, "w") as f:
                f.write(text + "\n")
            self._log(f"postmortem written to {path}")
            return path
        except Exception as e:  # noqa: BLE001 — the postmortem must
            # never mask the real exit code
            self._log(f"postmortem failed: {type(e).__name__}: {e}")
            return None

    def _log(self, msg: str) -> None:
        if self.verbose:
            print(f"supervise: {msg}", file=sys.stderr)


# ---------------------------------------------------------------------------
# the smoke gates
# ---------------------------------------------------------------------------


def _trainer(device: str, *flags: str) -> List[str]:
    """The port's training CLI on ``device`` with ``flags``."""
    return [sys.executable, "-m", "fluxdistributed_tpu_torch.train",
            *flags, "--device", device]


def _smoke_device(args) -> str:
    """``--device`` for the smoke child: the card unless ``cpu`` is
    asked for, and a missing card raises here, before anything runs."""
    from .device import resolve_device

    return str(resolve_device(args.device).type)


def smoke(args) -> int:
    """The self-contained supervise gate: a NaN at step 2 (the guard
    quarantines it), a hang at step 5 (the supervisor SIGKILLs and
    resumes), and the run must still finish: asserted, not hoped."""
    import tempfile

    device = _smoke_device(args)
    work = tempfile.mkdtemp(prefix="fdtpu-supervise-smoke-")
    ledger = args.ledger or os.path.join(work, "ledger.json")
    plan = {"fail": [
        {"site": "train.loss", "at": 2, "action": "nan"},
        {"site": "step", "at": 5, "action": "hang"},
    ]}
    cmd = _trainer(
        device, "--model", "lm_tiny", "--dataset", "synthetic-text",
        "--seqlen", "64", "--batch-size", "8", "--cycles", "8",
        "--opt", "adam", "--lr", "3e-3",
        "--print-every", "1", "--eval-every", "0",
        "--checkpoint-dir", os.path.join(work, "ck"),
        "--checkpoint-every", "2",
        "--guard", "--metrics-port", "0",
        "--fault-plan", json.dumps(plan))
    sup = Supervisor(
        cmd, ledger=ledger, max_restarts=3,
        stall_timeout=args.stall_timeout if args.stall_timeout != 120.0
        else 20.0,
        startup_grace=min(args.startup_grace, 300.0), poll_interval=0.25,
        backoff=1.0, verbose=not args.quiet)
    rc = sup.run()
    with open(ledger) as f:
        led = json.load(f)
    classes = [e["class"] for e in led["episodes"]]
    problems = []
    if rc != 0 or not led["completed"]:
        problems.append(f"run did not complete (rc={rc}, {led['result']})")
    if classes[-1:] != ["done"]:
        problems.append(f"last episode not done: {classes}")
    if not any(c in ("stalled", "escalated") for c in classes):
        problems.append(f"the hang was never killed: {classes}")
    quarantined = max(
        (series_value(e["counters"], "fdtpu_guard_quarantined_total")
         for e in led["episodes"]), default=0.0)
    if quarantined < 1:
        problems.append("the injected NaN was never quarantined")
    final_tail = "\n".join(led["episodes"][-1]["log_tail"])
    if "resumed from step" not in final_tail:
        problems.append("the post-SIGKILL episode did not resume from the "
                        "checkpoint and manifest")
    if problems:
        print("supervise smoke FAILED:", "; ".join(problems),
              file=sys.stderr)
        print(json.dumps(led, indent=2)[-3000:], file=sys.stderr)
        return 1
    print(f"supervise smoke OK: episodes={classes}, "
          f"quarantined={int(quarantined)}, restarts={led['restarts']}, "
          f"ledger={ledger}")
    return 0


def crash_smoke(args) -> int:
    """The crash-forensics gate: a fault plan ``os._exit``s the trainer
    at step 12 (the SIGKILL shape: no ``finally``, no flight footer) with
    the flight recorder on; the dump must be readable and footer-less,
    its last flushed record within one flush interval of the death, and
    the merged postmortem must call the death hard."""
    import tempfile

    device = _smoke_device(args)
    work = args.artifacts or tempfile.mkdtemp(prefix="fdtpu-crash-smoke-")
    os.makedirs(work, exist_ok=True)
    flight = os.path.join(work, "crash-flight.jsonl")
    runs_ledger = os.path.join(work, "crash-runs.jsonl")
    ledger = args.ledger or os.path.join(work, "crash-ledger.json")
    kill_at = 12
    plan = {"fail": [{"site": "step", "at": kill_at, "action": "exit"}]}
    cmd = _trainer(
        device, "--model", "SimpleCNN", "--dataset", "synthetic",
        "--num-classes", "4", "--image-size", "8",
        "--batch-size", "8", "--cycles", "20",
        "--print-every", "5", "--eval-every", "0",
        "--flight", flight, "--runs-ledger", runs_ledger,
        "--fault-plan", json.dumps(plan))
    sup = Supervisor(
        cmd, ledger=ledger, runs_ledger=runs_ledger,
        max_restarts=0,  # the death is the product
        startup_grace=300.0, poll_interval=0.25, verbose=not args.quiet)
    rc = sup.run()
    from .obs.flight import read_flight
    from .obs.runs import load_runs

    problems = []
    if rc == 0:
        problems.append("the killed run reported rc 0")
    try:
        fl = read_flight(flight)
    except OSError as e:
        print(f"crash smoke FAILED: no flight dump at {flight}: {e}",
              file=sys.stderr)
        return 1
    recs = fl["records"]
    flush_every = int((fl["header"] or {}).get("flush_every", 8))
    if fl["header"] is None:
        problems.append("flight dump has no header")
    if not recs:
        problems.append("flight dump has no records")
    if fl["end"] is not None:
        problems.append(f"a hard death left an end footer: {fl['end']}")
    last_step = recs[-1].get("step", -1) if recs else -1
    if recs and not (kill_at - 1 - flush_every
                     <= last_step <= kill_at - 1):
        problems.append(
            f"last flushed record step {last_step} is not within one "
            f"flush interval ({flush_every}) of death step {kill_at}")
    pm_path = ledger + ".postmortem.txt"
    try:
        with open(pm_path) as f:
            pm = f.read()
    except OSError:
        pm, problems = "", problems + [f"no postmortem written at {pm_path}"]
    if pm and "hard death" not in pm:
        problems.append("postmortem does not call the death hard")
    if pm and "lint stamp:" not in pm:
        problems.append("postmortem lacks the lint stamp line")
    eps = [r for r in load_runs(runs_ledger) if r.get("kind") == "episode"]
    if not eps:
        problems.append("no episode record in the runs ledger")
    if problems:
        print("crash smoke FAILED:", "; ".join(problems), file=sys.stderr)
        return 1
    print(f"crash smoke OK: {len(recs)} records flushed, last step "
          f"{last_step} (death at {kill_at}, flush interval "
          f"{flush_every}), footer absent, postmortem at {pm_path}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m fluxdistributed_tpu_torch.supervise",
        description="Keep a run of the port's training CLI finishing.",
        usage="python -m fluxdistributed_tpu_torch.supervise [options] -- "
              "python -m fluxdistributed_tpu_torch.train ...")
    p.add_argument("--ledger", default=None, metavar="PATH",
                   help="write the ledger JSON (per-episode rc/class/"
                        "action and scraped counters) here, atomically, "
                        "after every episode")
    p.add_argument("--max-restarts", type=int, default=3,
                   help="crash/stall restarts before giving up")
    p.add_argument("--max-resumes", type=int, default=32,
                   help="rc-75 preemption requeues before giving up")
    p.add_argument("--stall-timeout", type=float, default=120.0,
                   help="seconds without step progress (scraped "
                        "fdtpu_train_steps_total) before SIGKILL")
    p.add_argument("--startup-grace", type=float, default=600.0,
                   help="seconds of stdout silence tolerated before the "
                        "metrics endpoint appears (imports, kernel builds)")
    p.add_argument("--backoff", type=float, default=5.0,
                   help="first crash-restart pause; doubles per crash")
    p.add_argument("--keep-fault-plan", action="store_true",
                   help="do NOT strip --fault-plan from restart argv "
                        "(chaos soaks; by default it is stripped so an "
                        "injected hang is not replayed forever)")
    p.add_argument("--quiet", action="store_true",
                   help="suppress child log forwarding")
    p.add_argument("--runs-ledger", default=None, metavar="PATH",
                   help="append one obs.runs record per episode here (the "
                        "append-only history; --ledger is overwritten "
                        "per episode, this is not)")
    p.add_argument("--smoke", action="store_true",
                   help="run the self-contained NaN+hang smoke instead of "
                        "a user command")
    p.add_argument("--crash-smoke", action="store_true",
                   help="run the crash-forensics smoke: a hard kill, then "
                        "the flight dump and the postmortem checked")
    p.add_argument("--artifacts", default=None, metavar="DIR",
                   help="where --crash-smoke leaves its flight dump, "
                        "ledgers and postmortem (default: a temporary "
                        "directory)")
    p.add_argument("--device", default=None,
                   help="the smokes' device: cuda (the default) or cpu")
    p.add_argument("cmd", nargs=argparse.REMAINDER,
                   help="child command after `--`")
    return p


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    if args.smoke:
        return smoke(args)
    if args.crash_smoke:
        return crash_smoke(args)
    cmd = args.cmd
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        p.error("no child command given (append `-- python -m "
                "fluxdistributed_tpu_torch.train ...`, or use --smoke / "
                "--crash-smoke)")
    sup = Supervisor(
        cmd, ledger=args.ledger, max_restarts=args.max_restarts,
        max_resumes=args.max_resumes, stall_timeout=args.stall_timeout,
        startup_grace=args.startup_grace, backoff=args.backoff,
        keep_fault_plan=args.keep_fault_plan, verbose=not args.quiet,
        runs_ledger=args.runs_ledger)
    return sup.run()


if __name__ == "__main__":
    sys.exit(main())
