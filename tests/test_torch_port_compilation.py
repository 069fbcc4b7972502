"""Cold start in the port: ``compilation.py``, ``obs/jaxmon.py``, the
kernel build cache, ``prepare_training``'s cold-start controls and the
strict first calls, the engine's prewarm / AOT manifest /
``attention_impl``, and the CLIs' flags.

* ``config_tag`` and ``callable_tag`` on plain inputs (strings, numbers,
  plain functions and their closures) equal the JAX package's.
* The build cache across two child processes, with a stand-in ``nvcc``
  the test writes under a temporary ``CUDA_HOME`` (no card, no CUDA):
  the first process misses once per source, the second misses 0 times
  and hits once per source; an edited source, changed flags or another
  ``nvcc`` (another namespace) misses again.
* The AOT manifest (``fdtpu-aot-torch-v1``): round trip; a mismatch, a
  corrupt file, a tampered library copy and an edited source each fall
  back; ``load_or_compile`` falls back, then reuses.  (The JAX package's
  AOT round-trip tests do not run on this jax, so these hold the port to
  the module's documented contract.)
* The compile counters under the JAX series names, the steady-state
  flag, ``prepare_training(warmup=, aot=, strict_checks=)``,
  ``Observation(steady_after=)``, the prewarmed engine and the CLIs.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from fluxdistributed_tpu import compilation as jcomp
from fluxdistributed_tpu_torch import compilation, optim
from fluxdistributed_tpu_torch.obs import Observation, Registry, jaxmon
from fluxdistributed_tpu_torch.ops import _build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SERIES = ("fdtpu_jax_compiles_total", "fdtpu_jax_compile_seconds_total",
              "fdtpu_jax_steady_recompiles_total",
              "fdtpu_jax_cache_hits_total", "fdtpu_jax_cache_misses_total",
              "fdtpu_jax_cache_saved_seconds_total")


@pytest.fixture(autouse=True)
def _one_thread():
    # the models here are tiny: one intra-op thread, so that beside five
    # busy test workers no thread pool spins for cores it cannot get
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _restore_build_dir():
    # enabling the cache moves the process's kernel build directory:
    # later tests in this process get the default back
    d, c = _build._dir, compilation._cache_dir
    yield
    _build._dir, compilation._cache_dir = d, c


# ----------------------------------------------------------- tags (parity)

def _closure(lr, rho, name="update"):
    def inner(g):
        return lr * rho * g

    def update(g):
        return inner(g) + lr

    update.__name__ = name
    return update


TAG_PARTS = [
    ("attn_fn=<function core at 0x7f01>", 8),
    ("attn_fn=<function core at 0x9e22>", 8),
    ("x", 8, (1, 2), None, True, 3.5),
    ("dp", False, 1, 1, True, 0, None, False, "TransformerLM(dim=64)"),
    (_closure(0.1, 0.9),),
    (_closure(0.01, 0.9), "adam"),
    (_closure(0.1, 0.9, name="rule"), _closure(0.2, 0.5)),
    (lambda x: x,),
    (len, max),
]


@pytest.mark.parametrize("parts", TAG_PARTS, ids=range(len(TAG_PARTS)))
def test_config_tag_equals_the_jax_package(parts):
    assert compilation.config_tag(*parts) == jcomp.config_tag(*parts)


@pytest.mark.parametrize("fn", [_closure(0.1, 0.9), _closure(3e-4, 0.99),
                                lambda x: x, len, optim.momentum(0.1).rule,
                                optim.adam(1e-3).scalars],
                         ids=["closure", "closure2", "lambda", "builtin",
                              "momentum.rule", "adam.scalars"])
def test_callable_tag_equals_the_jax_package(fn):
    assert compilation.callable_tag(fn) == jcomp.callable_tag(fn)


def test_tags_see_hyperparameters_not_addresses():
    a = compilation.config_tag("attn_fn=<function core at 0x7f01>", 8)
    assert a == compilation.config_tag("attn_fn=<function core at 0x9e22>", 8)
    assert len(a) == 12
    assert (compilation.config_tag(optim.momentum(0.1).scalars)
            != compilation.config_tag(optim.momentum(0.2).scalars))
    tag = compilation.callable_tag(_closure(0.1, 0.9))
    assert tag.startswith("update:") and "0.1" in tag and "0.9" in tag
    assert "0x" not in tag


def test_fingerprint_and_namespace():
    a = compilation.topology_fingerprint()
    assert a == compilation.topology_fingerprint() and len(a) == 16
    assert compilation.topology_fingerprint(tag="x") != a
    assert (compilation.topology_fingerprint(tag="x")
            != compilation.topology_fingerprint(tag="y"))

    class M:
        shape = {"data": 2}

    assert compilation.topology_fingerprint(mesh=M()) != a
    ns = compilation.topology_namespace()
    assert ns == compilation.topology_namespace()
    assert ns.startswith("cpu-") and "/" not in ns and " " not in ns


def test_abstract_signature_tracks_shapes_dtypes_devices_and_structure():
    sig = compilation.abstract_signature
    x = torch.zeros(2, 3)
    base = sig((x, {"a": 1}))
    assert base == sig((torch.ones(2, 3), {"a": 5}))  # values never enter
    assert base != sig((torch.zeros(3, 2), {"a": 1}))
    assert base != sig((x.double(), {"a": 1}))
    assert base != sig((x, {"b": 1}))
    assert base != sig((x, [1]))
    assert sig((torch.zeros(2, device="meta"),)) != sig((torch.zeros(2),))
    lin = torch.nn.Linear(2, 3)
    assert sig((lin,)) == sig((torch.nn.Linear(2, 3),))
    assert sig((lin,)) != sig((torch.nn.Linear(2, 4),))


# ------------------------------------------------------------ build cache

STANDIN_NVCC = """\
#!{python}
import hashlib, sys, time
if "--version" in sys.argv:
    print("nvcc: stand-in compiler")
    print("Build {tag}")
    sys.exit(0)
out = sys.argv[sys.argv.index("-o") + 1]
src = sys.argv[-1]
time.sleep(0.05)
with open(out, "wb") as f:
    f.write(hashlib.sha1(open(src, "rb").read()
                         + " ".join(sys.argv[1:-3]).encode()).digest())
print("ptxas info    : 0 bytes stack frame (stand-in)")
"""

CHILD = """\
import json, sys
from pathlib import Path
from fluxdistributed_tpu_torch import compilation
from fluxdistributed_tpu_torch.ops import _build
_build.SOURCES = {p.stem: p for p in sorted(Path(sys.argv[2]).glob("*.cu"))}
if len(sys.argv) > 3:
    _build.NVCC_FLAGS = _build.NVCC_FLAGS + sys.argv[3:]
d = compilation.enable_persistent_cache(sys.argv[1])
logs = _build.build_all()
print(json.dumps({"dir": d, "built": sorted(n for n, l in logs.items() if l),
                  **compilation.compile_metrics()}))
"""


def _standin(tmp_path, tag="fake_1"):
    home = tmp_path / f"cuda-{tag}"
    (home / "bin").mkdir(parents=True)
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text(STANDIN_NVCC.format(python=sys.executable, tag=tag))
    nvcc.chmod(0o755)
    return str(home)


def _sources(tmp_path, n=3):
    src = tmp_path / "csrc"
    src.mkdir()
    for i in range(n):
        (src / f"k{i}.cu").write_text(f"// kernel {i}\n")
    return src


def _child(cuda_home, cache, src, *flags):
    env = dict(os.environ, CUDA_HOME=cuda_home,
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    p = subprocess.run([sys.executable, "-c", CHILD, str(cache), str(src),
                        *flags], capture_output=True, text=True, env=env,
                       timeout=240, cwd=ROOT)
    assert p.returncode == 0, p.stdout + p.stderr
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_build_cache_across_two_processes(tmp_path):
    home = _standin(tmp_path)
    src = _sources(tmp_path)
    cache = tmp_path / "cache"
    cold = _child(home, cache, src)
    assert (cold["cache_misses"], cold["cache_hits"], cold["compiles"]) == (
        3, 0, 3)
    assert cold["built"] == ["k0", "k1", "k2"] and cold["compile_seconds"] > 0
    assert os.path.dirname(cold["dir"]) == str(cache)
    assert "nvcc-build-fake-1" in os.path.basename(cold["dir"])
    warm = _child(home, cache, src)
    assert (warm["cache_misses"], warm["cache_hits"], warm["compiles"]) == (
        0, 3, 0)
    assert warm["built"] == [] and warm["dir"] == cold["dir"]
    # the hits skipped what the cold builds took
    assert warm["compile_seconds_saved"] == pytest.approx(
        cold["compile_seconds"], rel=0.2)
    # an edited source misses again, alone
    (src / "k1.cu").write_text("// kernel 1, edited\n")
    edited = _child(home, cache, src)
    assert (edited["cache_misses"], edited["cache_hits"]) == (1, 2)
    # changed flags miss every source
    flags = _child(home, cache, src, "-DFDTPU_TEST")
    assert (flags["cache_misses"], flags["cache_hits"]) == (3, 0)
    # another nvcc is another namespace: nothing is found there
    other = _child(_standin(tmp_path, tag="fake_2"), cache, src)
    assert (other["cache_misses"], other["cache_hits"]) == (3, 0)
    assert other["dir"] != cold["dir"]


@pytest.fixture
def fake_toolchain(tmp_path, monkeypatch):
    """The in-process kernel build on stand-in sources and a stand-in
    ``nvcc``, its globals restored after the test."""
    monkeypatch.setenv("CUDA_HOME", _standin(tmp_path))
    src = _sources(tmp_path, n=2)
    monkeypatch.setattr(_build, "SOURCES",
                        {p.stem: p for p in sorted(src.glob("*.cu"))})
    monkeypatch.setattr(_build, "_dir", tmp_path / "build")
    for name in ("_paths", "_loaded"):
        monkeypatch.setattr(_build, name, {})
    monkeypatch.setattr(_build, "_reported", set())
    compilation._nvcc_line.cache_clear()
    yield src
    compilation._nvcc_line.cache_clear()


# ------------------------------------------------------------ AOT manifest

def test_manifest_round_trip_and_fallbacks(tmp_path, fake_toolchain):
    _build.build_all()
    libs = {n: _build.library_path(n) for n in _build.SOURCES}
    prog = compilation.AotProgram(None, "sig0", libs)
    path = str(tmp_path / "aot" / f"step{compilation.AOT_SUFFIX}")
    compilation.save_executable(path, prog, fingerprint="fp0")
    blob = json.load(open(path))
    assert blob["magic"] == compilation.AOT_MAGIC == "fdtpu-aot-torch-v1"
    assert set(blob["libraries"]) == {"k0", "k1"}
    for name, meta in blob["libraries"].items():
        assert meta["key"] == _build.library_key(name)
    # the manifest names the build cache's libraries: it copies none
    assert os.listdir(tmp_path / "aot") == [os.path.basename(path)]

    got = compilation.load_executable(path, fingerprint="fp0",
                                      signature="sig0")
    assert got is not None and got.loaded
    # the loader finds them in the build cache: nothing is built
    for name in libs:
        proc, _, out, _ = _build._start(name)
        assert proc is None and out == got.libraries[name] == libs[name]

    assert compilation.load_executable(path, fingerprint="fp1") is None
    assert compilation.load_executable(path, fingerprint="fp0",
                                       signature="sig1") is None
    assert compilation.load_executable(str(tmp_path / "missing.aot.json"),
                                       fingerprint="fp0") is None
    # a library the cache holds with other content
    lib = libs["k0"]
    good = lib.read_bytes()
    lib.write_bytes(good + b"x")
    assert compilation.load_executable(path, fingerprint="fp0") is None
    lib.write_bytes(good)
    assert compilation.load_executable(path, fingerprint="fp0") is not None
    # another build cache, which lacks the libraries
    _build.set_build_dir(tmp_path / "other")
    assert compilation.load_executable(path, fingerprint="fp0") is None
    _build.set_build_dir(lib.parent)
    # an edited source: the saved library is another source's
    (fake_toolchain / "k1.cu").write_text("// kernel 1, edited\n")
    assert compilation.load_executable(path, fingerprint="fp0") is None
    # a corrupt file and another magic
    bad = tmp_path / "aot" / "bad.aot.json"
    bad.write_text("{not json")
    assert compilation.load_executable(str(bad), fingerprint="fp0") is None
    bad.write_text(json.dumps({**blob, "magic": "fdtpu-aot-v1"}))
    assert compilation.load_executable(str(bad), fingerprint="fp0") is None


def test_load_or_compile_falls_back_then_reuses(tmp_path):
    reg = Registry()
    calls = []

    def step(x, n=1):
        calls.append((tuple(x.shape), n))
        return x * n

    x = torch.ones(4)
    kw = dict(directory=str(tmp_path), name="step", fingerprint="fp",
              registry=reg)
    first = compilation.load_or_compile(step, (x,), {"n": 2}, **kw)
    assert calls == [((4,), 2)] and not first.loaded
    assert reg.value("fdtpu_aot_compiles_total") == 1
    assert len([f for f in os.listdir(tmp_path)
                if f.endswith(compilation.AOT_SUFFIX)]) == 1
    again = compilation.load_or_compile(step, (x,), {"n": 2}, **kw)
    assert again.loaded and calls == [((4,), 2)]  # nothing ran
    assert reg.value("fdtpu_aot_loads_total") == 1
    assert torch.equal(again(x, n=3), x * 3)  # calls go to fn
    # a new shape is a new file: it falls back and runs
    compilation.load_or_compile(step, (torch.ones(5),), {"n": 2}, **kw)
    assert reg.value("fdtpu_aot_compiles_total") == 2
    # a corrupt manifest falls back, never raises
    for f in os.listdir(tmp_path):
        (tmp_path / f).write_text("garbage")
    compilation.load_or_compile(step, (x,), {"n": 2}, **kw)
    assert reg.value("fdtpu_aot_compiles_total") == 3


# ------------------------------------------------------------ the counters

def test_counters_preregistered_under_the_jax_names():
    jaxmon.install()
    reg = jaxmon._registry
    for name in JAX_SERIES:
        assert reg.get(name) is not None, name
    assert set(jaxmon._HELP) == set(JAX_SERIES)
    assert jaxmon.installed()


def test_steady_state_nests_and_flags_builds(monkeypatch):
    warned = []
    monkeypatch.setattr(jaxmon, "_warn", warned.append)
    jaxmon.clear_steady()
    s0, c0 = jaxmon.steady_recompiles(), jaxmon.compile_count()
    m0, h0 = jaxmon.cache_misses(), jaxmon.cache_hits()
    jaxmon.record("build", 1.0, what="csrc/warm.cu")  # before steady
    jaxmon.record("capture", 0.5, what="the decode step")
    assert jaxmon.steady_recompiles() == s0 and not warned
    try:
        with jaxmon.steady_state():
            with jaxmon.steady_state():
                assert jaxmon._steady
            assert jaxmon._steady  # the inner exit restored the outer flag
            jaxmon.record("build", 2.0, what="csrc/late.cu")
            jaxmon.record("build", 2.0, cached=True, what="csrc/hit.cu")
        assert not jaxmon._steady
        jaxmon.mark_steady()
        jaxmon.record("capture", 0.1, what="the train step (8 steps)")
    finally:
        jaxmon.clear_steady()
    assert jaxmon.steady_recompiles() == s0 + 2
    assert jaxmon.compile_count() == c0 + 4
    assert (jaxmon.cache_misses(), jaxmon.cache_hits()) == (m0 + 2, h0 + 1)
    assert len(warned) == 2
    assert "nvcc build of csrc/late.cu" in warned[0]
    assert "CUDA graph capture of the train step" in warned[1]
    with pytest.raises(ValueError, match="unknown compile event"):
        jaxmon.record("trace", 1.0)


# ---------------------------------------------------------------- training

def _task(**kw):
    from fluxdistributed_tpu_torch.data import SyntheticTextDataset
    from fluxdistributed_tpu_torch.models import lm_loss_fn, lm_tiny
    from fluxdistributed_tpu_torch.train import prepare_training

    opt = kw.pop("opt", None) or optim.adam(1e-3)
    m = lm_tiny(vocab=64, device="cpu", seed=0)
    return prepare_training(m, SyntheticTextDataset(vocab=64, seqlen=16), opt,
                            loss_fn=lm_loss_fn(m), batch_size=4, cycles=4,
                            device="cpu", **kw)


def test_warmup_leaves_the_state_bitwise_untouched():
    from fluxdistributed_tpu_torch.tree import leaves

    plain, warm = _task(), _task(warmup=True)
    for part in ("params", "opt_state", "model_state"):
        a = leaves(getattr(plain.state, part))
        b = leaves(getattr(warm.state, part))
        assert len(a) == len(b) and (a or part == "model_state")
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert warm.state.step == plain.state.step == 0


def test_aot_tag_tells_two_optimizers_apart(tmp_path):
    from fluxdistributed_tpu_torch.obs import get_registry

    reg = get_registry()
    c0, l0 = (reg.value("fdtpu_aot_compiles_total"),
              reg.value("fdtpu_aot_loads_total"))
    t1 = _task(opt=optim.momentum(0.1, 0.9), aot=str(tmp_path))
    _task(opt=optim.momentum(0.01, 0.9), aot=str(tmp_path))
    assert reg.value("fdtpu_aot_compiles_total") == c0 + 2
    assert len(os.listdir(tmp_path)) == 2
    t3 = _task(opt=optim.momentum(0.1, 0.9), aot=str(tmp_path))
    assert reg.value("fdtpu_aot_loads_total") == l0 + 1
    assert t3.step_fn.loaded and not t1.step_fn.loaded
    # an AOT-loaded task trains as the fresh one does, bit for bit
    from fluxdistributed_tpu_torch.train import train

    for t in (t1, t3):
        train(t, print_every=0, eval_every=0)
    assert t1.losses == t3.losses and len(t1.losses) == 4


def test_strict_checks_name_the_op_and_pass_later_calls_through():
    task = _task(strict_checks=True)
    batch = next(iter(task.loader))
    bad = _task()
    with torch.no_grad():
        name = next(iter(bad.state.params))
        p = bad.state.params[name]
        p.view(-1)[0] = float("nan")
    with pytest.raises(FloatingPointError, match=r"aten\.\w+.*reads a NaN"):
        task.step_fn(bad.state, batch)
    # a fresh arming: calls 1 and 2 clean, call 3 passes straight through
    task = _task(strict_checks=True)
    state = task.state
    for _ in range(2):
        state, m = task.step_fn(state, batch)
        assert np.isfinite(float(m["loss"]))
    _, m = task.step_fn(bad.state, batch)  # no check left: no raise
    assert not np.isfinite(float(m["loss"]))


@pytest.mark.parametrize("aot", [False, True])
def test_strict_checks_keep_the_steps_attributes(tmp_path, aot):
    """The armed step still exposes the device loop's ``eager`` (what
    ``replay_item`` runs), through an AOT program too."""
    from fluxdistributed_tpu_torch.parallel.graphs import DeviceLoop

    task = _task(steps_per_call=2, strict_checks=True,
                 aot=str(tmp_path) if aot else None)
    loop = task.step_fn.fn.fn if aot else task.step_fn.fn
    assert isinstance(loop, DeviceLoop)
    eager = getattr(task.step_fn, "eager", None)
    assert eager is not None and eager.__self__ is loop
    assert eager.__func__ is DeviceLoop.eager


def test_strict_checks_name_an_op_that_makes_a_nan():
    from fluxdistributed_tpu_torch.train.trainer import _StrictFirstCalls

    def step(x):
        y = x * 2
        return torch.log(y - 10)  # log of a negative: made here

    armed = _StrictFirstCalls(step, "train step")
    with pytest.raises(FloatingPointError,
                       match=r"aten\.log\.default produced a NaN/Inf from "
                             "finite inputs in the first train step"):
        armed(torch.ones(3))


def test_observation_steady_after_trains_on_the_cpu():
    from fluxdistributed_tpu_torch.train import train

    task = _task()
    s0 = jaxmon.steady_recompiles()
    train(task, print_every=0, eval_every=0,
          observation=Observation(steady_after=1))
    assert len(task.losses) == 4 and not jaxmon._steady
    assert jaxmon.steady_recompiles() == s0
    full = Observation.full(steady_after=2)
    assert full.steady_after == 2


# ---------------------------------------------------------------- serving

def _engine_tokens(layout="dense", **kw):
    from fluxdistributed_tpu_torch.models import lm_tiny
    from fluxdistributed_tpu_torch.serve import LMEngine, Scheduler
    from fluxdistributed_tpu_torch.serve.scheduler import Request

    m = lm_tiny(vocab=64, device="cpu", seed=0)
    eng = LMEngine(m, max_slots=2, max_len=64, buckets=(8, 16),
                   layout=layout, **kw)
    stats = eng.compile_stats()
    sched = Scheduler(eng, max_queue=8)
    reqs = [Request(prompt=[1 + i, 2, 3, 4 + i] * (1 + i),
                    max_new_tokens=6) for i in range(3)]
    for r in reqs:
        sched.submit(r)
    sched.run_until_idle()
    return [r.generated for r in reqs], stats, eng


@pytest.mark.parametrize("layout,kv", [("dense", None), ("paged", None),
                                       ("paged", "int8")])
def test_a_prewarmed_engine_gives_a_fresh_engines_tokens(layout, kv):
    fresh, _, _ = _engine_tokens(layout, kv_dtype=kv)
    warm, stats, eng = _engine_tokens(layout, kv_dtype=kv, prewarm=True)
    assert warm == fresh
    assert stats["decode_compiles"] == 0  # no graph on the CPU
    assert eng.attention_impl == "pallas" and eng._warmed
    plain, _, eng = _engine_tokens(layout, kv_dtype=kv, attention_impl="xla")
    assert plain == fresh and eng.cache.plain_decode and not eng.cuda_graph


def test_engine_aot_manifest_round_trip_and_refusal(tmp_path):
    from fluxdistributed_tpu_torch.obs import get_registry

    reg = get_registry()
    c0, l0 = (reg.value("fdtpu_aot_compiles_total"),
              reg.value("fdtpu_aot_loads_total"))
    fresh, _, _ = _engine_tokens()
    a, _, _ = _engine_tokens(aot_dir=str(tmp_path))
    b, stats, _ = _engine_tokens(aot_dir=str(tmp_path))
    assert a == b == fresh
    assert reg.value("fdtpu_aot_compiles_total") == c0 + 1
    assert reg.value("fdtpu_aot_loads_total") == l0 + 1
    assert stats["aot_programs"] == 0  # the CPU launches no kernel
    with pytest.raises(ValueError,
                       match=r"unknown attention_impl 'flash' \(xla\|pallas\)"):
        _engine_tokens(attention_impl="flash")


# ------------------------------------------------------------------- CLIs

def _jax_parser(rel):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "jcli_" + os.path.basename(rel)[:-3], os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.build_parser()


@pytest.mark.parametrize("rel,mod", [
    ("bin/driver.py", "fluxdistributed_tpu_torch.train.__main__"),
    ("bin/serve.py", "fluxdistributed_tpu_torch.serve.__main__"),
    ("bin/infer.py", "fluxdistributed_tpu_torch.infer")])
def test_cli_flags_cover_the_jax_clis(rel, mod):
    import importlib

    def opts(parser):
        return {o for a in parser._actions for o in a.option_strings}

    missing = opts(_jax_parser(rel)) - opts(
        importlib.import_module(mod).build_parser())
    # the JAX server picks its mode with --lm; the port's follows --model
    assert missing <= {"--lm"}, missing


def test_train_cli_takes_the_cold_start_flags(tmp_path):
    from fluxdistributed_tpu_torch.train.__main__ import run

    argv = ["--model", "lm_tiny", "--seqlen", "32", "--batch-size", "4",
            "--opt", "adam", "--lr", "3e-3", "--cycles", "4", "--device",
            "cpu", "--eval-every", "0", "--print-every", "0"]
    from fluxdistributed_tpu_torch.obs import get_registry

    reg = get_registry()
    plain = run(argv)
    flags = ["--compile-cache", str(tmp_path / "cc"), "--aot",
             str(tmp_path / "aot"), "--prewarm", "--steady-after", "2",
             "--strict-checks"]
    c0, l0 = (reg.value("fdtpu_aot_compiles_total"),
              reg.value("fdtpu_aot_loads_total"))
    cold = run(argv + flags)
    warm = run(argv + flags)
    assert plain.losses == cold.losses == warm.losses
    assert reg.value("fdtpu_aot_compiles_total") == c0 + 1
    assert reg.value("fdtpu_aot_loads_total") == l0 + 1
    assert os.listdir(tmp_path / "cc") == [compilation.topology_namespace()]


def test_serve_cli_takes_the_cold_start_flags(tmp_path):
    from fluxdistributed_tpu_torch.serve.__main__ import (build_parser,
                                                          build_server)

    args = build_parser().parse_args(
        ["--model", "lm_tiny", "--vocab", "64", "--max-slots", "2",
         "--max-len", "64", "--buckets", "8,16", "--platform", "cpu",
         "--prewarm", "--compile-cache", str(tmp_path / "cc"),
         "--aot-dir", str(tmp_path / "aot"), "--attention-impl", "xla"])
    from fluxdistributed_tpu_torch.train.__main__ import platform_device

    platform_device(args)
    assert args.device == "cpu"
    server, sched = build_server(args)
    try:
        eng = sched.engine
        assert eng.attention_impl == "xla" and eng._warmed
        assert os.listdir(tmp_path / "aot")
        assert compilation.persistent_cache_dir().startswith(
            str(tmp_path / "cc"))
    finally:
        server.close()
    from fluxdistributed_tpu_torch.serve.__main__ import main

    with pytest.raises(SystemExit, match="--platform tpu"):
        main(["--platform", "tpu"])
    with pytest.raises(SystemExit, match="conflicts"):
        main(["--platform", "gpu", "--device", "cpu"])
