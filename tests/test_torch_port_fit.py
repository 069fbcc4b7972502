"""Pricing a step: memstats' static half (``obs/memstats.py``,
``obs/pricing.py``), the fit checker (``python -m
fluxdistributed_tpu_torch.fit``) and the layout picker
(``parallel/layout.py``), against the JAX package.

The static half of JAX ``tests/test_memstats.py``, JAX
``tests/test_fit.py``'s six tests on the port's CLI (in process, and one
``python -m`` run that prices every registered variant and holds them to
the committed baseline: fake pricing is deterministic), and JAX
``tests/test_layout.py``'s picker tests with each budget placed against
each package's own priced rows.  Pricing has power: the priced peak of a
plain-attention step exceeds the flash step's by at least its scores,
and a kernel's shape-only branch that returned a wrong shape fails the
priced step.
"""

from __future__ import annotations

import copy
import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fluxdistributed_tpu_torch import optim
from fluxdistributed_tpu_torch.obs import memstats
from fluxdistributed_tpu_torch.obs.pricing import price_step, pricing
from fluxdistributed_tpu_torch.parallel import layout as layout_lib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
fit = importlib.import_module("fluxdistributed_tpu_torch.fit")


# ---- step_memory ---------------------------------------------------------------

def test_step_memory_real_program():
    """A priced program's keys, its exact argument bytes and XLA's
    identity ``peak = argument + output + temp - alias``; an argument
    written in place is an aliased output."""
    def f(x, y):
        y.add_(1.0)
        return (x * 2.0).sum()

    with pricing(None, device="cpu"):
        x = torch.zeros((16, 16), dtype=torch.float32)
        y = torch.zeros(8, dtype=torch.float32)
        mem = memstats.step_memory(f, (x, y))
    assert mem["source"] == "fake" and mem["generated_code_bytes"] == 0
    for key in ("argument_bytes", "output_bytes", "temp_bytes",
                "alias_bytes", "peak_bytes"):
        assert isinstance(mem[key], int), key
    assert mem["argument_bytes"] == 16 * 16 * 4 + 8 * 4
    assert mem["alias_bytes"] == 8 * 4
    assert mem["peak_bytes"] == (mem["argument_bytes"] + mem["output_bytes"]
                                 + mem["temp_bytes"] - mem["alias_bytes"])
    assert mem["temp_bytes"] >= 16 * 16 * 4  # x * 2 before its sum


def test_step_memory_unavailable_paths():
    """A step on real tensors, or one that needs values (a data-dependent
    shape), cannot be priced: None, never a raise."""
    assert memstats.step_memory(lambda x: x, (1,)) is None
    assert memstats.step_memory(lambda x: x * 2, (torch.zeros(2),)) is None
    with pricing(None, device="cpu"):
        x = torch.zeros(8)
        assert memstats.step_memory(lambda t: t[t > 0], (x,)) is None


def _mem(peak):
    return {"memory": {"peak_bytes": peak, "argument_bytes": 1,
                       "output_bytes": 1, "temp_bytes": 1,
                       "alias_bytes": 0}}


def test_check_memory_baseline_semantics():
    baseline = memstats.build_baseline(
        {"a": _mem(1000), "b": _mem(2000)}, tolerance=0.5)
    assert baseline["schema"] == memstats.BASELINE_SCHEMA
    res = memstats.check_memory_baseline(
        {"a": _mem(1000), "b": _mem(2000)}, baseline)
    assert res["failures"] == [] and res["checked"] == 2
    ok = memstats.check_memory_baseline({"a": _mem(1400),
                                         "b": _mem(2000)}, baseline)
    assert ok["failures"] == []
    bad = memstats.check_memory_baseline({"a": _mem(1600),
                                          "b": _mem(2000)}, baseline)
    assert len(bad["failures"]) == 1 and "regressed" in bad["failures"][0]
    new = memstats.check_memory_baseline(
        {"a": _mem(1000), "c": _mem(10)}, baseline)
    assert any("not covered" in f for f in new["failures"])
    assert any("stale" in n for n in new["notes"])
    degraded = memstats.check_memory_baseline(
        {"a": {"memory": None}, "b": _mem(2000)}, baseline)
    assert degraded["failures"] == []
    assert any("unavailable" in n for n in degraded["notes"])
    shrunk = memstats.check_memory_baseline(
        {"a": _mem(100), "b": _mem(2000)}, baseline)
    assert shrunk["failures"] == []
    assert any("shrank" in n for n in shrunk["notes"])


def test_pp_plan_memory_check_band():
    """The planner's per-stage estimate against the priced peak of the
    real planned 1F1B step it drives (rank 0, stage 0), inside the
    documented band; a degenerate factor fails it."""
    from fluxdistributed_tpu_torch import mesh as mesh_lib
    from fluxdistributed_tpu_torch.data import SyntheticTextDataset
    from fluxdistributed_tpu_torch.models import TransformerLM
    from fluxdistributed_tpu_torch.parallel.pp_plan import plan_from_model
    from fluxdistributed_tpu_torch.train import prepare_training

    model = TransformerLM(vocab=64, dim=16, depth=6, num_heads=2,
                          mlp_dim=32, dtype=torch.float32, device="cpu")
    plan = plan_from_model(model, 4, 2, batch_size=8, seqlen=16,
                           device="cpu")
    assert plan.stage_bytes and max(plan.stage_bytes) > 0
    with pricing(8, device="cpu") as pr:
        mesh = mesh_lib.make_mesh({"data": 2, "pipe": 4}, device="cpu")
        task = prepare_training(
            pr.module(model), SyntheticTextDataset(vocab=64, seqlen=16),
            optim.adam(1e-3), mesh=mesh, batch_size=16, cycles=1,
            device="cpu", spmd="pp_1f1b", num_microbatches=2, topk=(),
            pp_plan=plan)
        batch = pr.batch({"tokens": ((16, 16), torch.int64)}, shards=2)
        report = memstats.pp_plan_memory_check(
            plan, task.step_fn, (task.state, batch))
        tight = memstats.pp_plan_memory_check(
            plan, task.step_fn, (task.state, batch), factor=0.001)
    assert report["measured"] is not None
    assert report["within"] is True, report
    assert tight["within"] is False


def test_pp_plan_memory_check_degrades(monkeypatch):
    from fluxdistributed_tpu_torch.parallel.pp_plan import plan_stages

    plan = plan_stages([1.0] * 4, 2, 2, block_bytes=[10.0] * 4)
    monkeypatch.setattr(memstats, "step_memory", lambda fn, args: None)
    report = memstats.pp_plan_memory_check(plan, None, ())
    assert report["within"] is None and report["measured"] is None


# ---- the fit checker (JAX test_fit.py) ------------------------------------------

@pytest.fixture()
def artifact(tmp_path):
    """A v2 artifact with one small and one provably oversized variant,
    fingerprinted for this process."""
    from fluxdistributed_tpu_torch.obs.profile import (Profile,
                                                       describe_topology)
    from fluxdistributed_tpu_torch.obs.runs import topology_fingerprint

    def mem(peak):
        return {"memory": {"peak_bytes": peak, "argument_bytes": peak,
                           "output_bytes": 0, "temp_bytes": 0,
                           "alias_bytes": 0, "generated_code_bytes": 0}}

    prof = Profile(
        fingerprint=topology_fingerprint(), topology=describe_topology(),
        memory={"state": None, "step": None,
                "variants": {"small": mem(1_000), "huge": mem(10**15),
                             "dark": {"memory": None}}},
        comms={"step": {}, "variants": {}})
    path = tmp_path / "fit.profile.json"
    prof.save(str(path))
    return str(path)


def test_ranking_and_fit_verdicts(artifact, capsys):
    rc = fit.main(["--profile", artifact, "--hbm-bytes", "1e6", "--json"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out)
    rows = {r["variant"]: r for r in out["rows"]}
    assert rows["small"]["fits"] is True
    assert rows["small"]["headroom_bytes"] == 1_000_000 - 1_000
    assert rows["huge"]["fits"] is False
    assert rows["dark"]["fits"] is None
    assert [r["variant"] for r in out["rows"]] == ["small", "huge", "dark"]


def test_require_rejects_oversized_and_accepts_fitting(artifact):
    assert fit.main(["--profile", artifact, "--hbm-bytes", "1e6",
                     "--require", "huge"]) == 3
    assert fit.main(["--profile", artifact, "--hbm-bytes", "1e6",
                     "--require", "small"]) == 0
    assert fit.main(["--profile", artifact, "--hbm-bytes", "1e6",
                     "--require", "nope"]) == 2
    assert fit.main(["--profile", artifact, "--hbm-bytes", "1e6",
                     "--require", "dark"]) == 3


def test_no_budget_on_cpu_is_informational(artifact, capsys):
    assert fit.main(["--profile", artifact]) == 0
    out = capsys.readouterr().out
    assert "no HBM budget" in out and "--hbm-bytes" in out


def test_baseline_check_workflow(artifact, tmp_path, capsys):
    base = str(tmp_path / "membase.json")
    assert fit.main(["--profile", artifact, "--update-baseline",
                     "--baseline", base]) == 0
    doc = json.load(open(base))
    assert set(doc["variants"]) == {"small", "huge"}
    assert fit.main(["--profile", artifact, "--check",
                     "--baseline", base, "--hbm-bytes", "1e6"]) == 0
    capsys.readouterr()
    doc["variants"]["small"]["peak_bytes"] = 100
    json.dump(doc, open(base, "w"))
    assert fit.main(["--profile", artifact, "--check",
                     "--baseline", base, "--hbm-bytes", "1e6"]) == 1
    assert "small" in capsys.readouterr().out
    del doc["variants"]["huge"]
    doc["variants"]["small"]["peak_bytes"] = 1_000
    json.dump(doc, open(base, "w"))
    assert fit.main(["--profile", artifact, "--check",
                     "--baseline", base, "--hbm-bytes", "1e6"]) == 1
    assert "not covered" in capsys.readouterr().out
    assert fit.main(["--profile", artifact, "--check", "--baseline",
                     str(tmp_path / "absent.json")]) == 2


def test_topology_gate(tmp_path, capsys):
    from fluxdistributed_tpu_torch.obs.profile import Profile

    prof = Profile(fingerprint="deadbeefdeadbeef",
                   topology={"platform": "tpu", "device_count": 256})
    path = str(tmp_path / "foreign.json")
    prof.save(path)
    with pytest.raises(SystemExit, match="does not match"):
        fit.main(["--profile", path, "--hbm-bytes", "1e6"])
    assert fit.main(["--profile", path, "--hbm-bytes", "1e6",
                     "--allow-mismatch"]) == 0
    assert "topology gate skipped" in capsys.readouterr().err


def test_committed_baseline_covers_every_registered_variant():
    from fluxdistributed_tpu_torch.analysis.variants import (
        VARIANT_BUILDERS, variant_names)

    base = json.load(open(fit.default_baseline_path()))
    covered = set(base["variants"])
    for name in variant_names():
        assert any(v == name or v.startswith(name + ":")
                   for v in covered), name
    assert base["schema"] == "fdtpu-membaseline/v1"
    assert VARIANT_BUILDERS


def test_collect_prices_every_variant_and_holds_the_baseline(tmp_path):
    """``python -m fluxdistributed_tpu_torch.fit --collect --check`` in a
    process of its own: every registered program priced on 8 fake
    ranks, each within the committed baseline; the dense prefill
    programs cannot run fake (their write selects rows by a mask) and
    are listed unavailable; the same artifact then ranks (exit 3 for a
    variant that does not fit a tiny budget)."""
    out = str(tmp_path / "p.json")
    env = {**os.environ, "PYTHONPATH": REPO}
    p = subprocess.run(
        [sys.executable, "-m", "fluxdistributed_tpu_torch.fit",
         "--collect", out, "--host-devices", "8", "--device", "cpu",
         "--check"], capture_output=True, text=True, timeout=300, env=env,
        cwd=str(tmp_path))
    assert p.returncode == 0, p.stdout + p.stderr
    assert "0 failure(s)" in p.stdout
    doc = json.load(open(out))
    variants = doc["memory"]["variants"]
    assert {n for n, e in variants.items() if not e["memory"]} == {
        "serve:prefill_b16", "serve:prefill_b32", "serve:prefill_b64"}
    assert all("DynamicOutputShape" in variants[n]["unavailable"]
               for n in ("serve:prefill_b16",))
    assert doc["comms"]["variants"]["zero1_fused"]["recorded"]
    assert fit.main(["--profile", out, "--host-devices", "8",
                     "--hbm-bytes", "5e4", "--require", "pp_1f1b"]) == 3


# ---- the layout picker against JAX (test_layout.py) ------------------------------

def _port_lm():
    from fluxdistributed_tpu_torch.models import TransformerLM

    with torch.device("meta"):
        return TransformerLM(vocab=256, dim=128, depth=2, num_heads=4,
                             mlp_dim=512, dtype=torch.float32, device="meta")


@pytest.fixture(scope="module")
def priced():
    """One pricing sweep of each package (no buffer allocated in either)
    over the same LM and batch on 8 ranks."""
    import jax

    from fluxdistributed_tpu import optim as joptim
    from fluxdistributed_tpu.models.transformer_lm import TransformerLM
    from fluxdistributed_tpu.parallel import layout as jlayout

    jmodel = TransformerLM(vocab=256, dim=128, depth=2, num_heads=4,
                           mlp_dim=512, dtype=jax.numpy.float32)
    jbatch = {"tokens": jax.ShapeDtypeStruct((16, 32), np.int32)}
    jrows = jlayout.price_layouts(jmodel, jbatch, joptim.adam(1e-3))
    model = _port_lm()
    batch = {"tokens": ((16, 32), torch.int32)}
    rows = layout_lib.price_layouts(model, batch, optim.adam(1e-3),
                                    ndev=8, device="cpu")
    return {"jax": (jlayout, jmodel, jbatch, jrows, joptim),
            "port": (model, batch, rows)}


def _jpick(priced, budget, names=None):
    jlayout, jmodel, jbatch, jrows, joptim = priced["jax"]
    rows = [r for r in jrows if names is None or r["layout"] in names]
    return jlayout.pick(jmodel, jbatch, joptim.adam(1e-3), hbm_bytes=budget,
                        rows=rows)


def _pick(priced, budget, names=None):
    model, batch, rows = priced["port"]
    rows = [r for r in rows if names is None or r["layout"] in names]
    return layout_lib.pick(model, batch, hbm_bytes=budget, rows=rows,
                           ndev=8)


def test_pick_generous_budget_prefers_dp_by_ledger(priced):
    rep = _pick(priced, 1e9)
    assert rep.chosen.name == "dp" == _jpick(priced, 1e9).chosen.name
    by = {r["layout"]: r for r in rep.rows}
    assert by["dp"]["fits"] is True
    fitting = [r for r in rep.rows if r.get("fits")]
    assert by["dp"]["comms_bytes"] == min(r["comms_bytes"] for r in fitting)
    doc = rep.to_json()
    assert doc["chosen"] == "dp" and json.dumps(doc)
    assert doc["schema"] == "fdtpu-layout-pick/v1"


def test_pick_squeezed_budget_excludes_dp(priced):
    """A budget below dp's priced peak and above fsdp's, placed against
    each package's own rows: dp does not fit, a sharded layout is
    chosen.  Over dp, fsdp and dp_fsdp both pick fsdp (fewest bytes
    among the fitting); over every candidate the port picks fsdp_tp,
    whose ledger is the smallest here, where JAX's GSPMD rematerializes
    its fsdp_tp step (8.5 MB a step) and picks fsdp."""
    names = {"dp", "fsdp", "dp_fsdp"}
    for pick, rows in ((_pick, priced["port"][2]),
                       (_jpick, priced["jax"][3])):
        by = {r["layout"]: r for r in rows}
        assert by["fsdp"]["peak_bytes"] < by["dp"]["peak_bytes"]
        budget = (by["dp"]["peak_bytes"] + by["fsdp"]["peak_bytes"]) / 2
        rep = pick(priced, budget)
        assert rep.chosen.name != "dp"
        assert next(r for r in rep.rows
                    if r["layout"] == rep.chosen.name)["fits"] is True
        assert next(r for r in rep.rows
                    if r["layout"] == "dp")["fits"] is False
        assert pick(priced, budget, names).chosen.name == "fsdp"
    by = {r["layout"]: r for r in priced["port"][2]}
    budget = (by["dp"]["peak_bytes"] + by["fsdp"]["peak_bytes"]) / 2
    assert _pick(priced, budget).chosen.name == "fsdp_tp"


def test_pick_nothing_fits_raises_with_report(priced):
    with pytest.raises(layout_lib.LayoutError, match="no layout fits") as ei:
        _pick(priced, 1000.0)
    rep = ei.value.report
    assert rep.chosen is None and len(rep.rows) == len(priced["port"][2])
    assert "DOES NOT FIT" in rep.describe()


def test_pick_no_budget_ranks_by_ledger_only(priced):
    rep = _pick(priced, None)
    assert rep.budget_bytes is None  # no card here
    assert rep.chosen.name == "dp" == _jpick(priced, None).chosen.name
    assert "collective" in rep.reason


def test_pick_survives_unavailable_ledger_and_custom_layouts(priced):
    model, batch, rows = priced["port"]
    crippled = copy.deepcopy(rows)
    for r in crippled:
        r.pop("comms", None)
        r["comms_bytes"] = None
        r.pop("comms_bytes_per_axis", None)
        r["comms_unavailable"] = "Boom: synthetic"
    rep = layout_lib.pick(model, batch, hbm_bytes=1e9, rows=crippled)
    assert rep.chosen is not None
    assert "ledger unavailable" in rep.reason
    text = rep.describe()
    assert "invalid: None" not in text
    assert "collective ledger unavailable" in text
    renamed = copy.deepcopy(rows)
    for r in renamed:
        r["layout"] = "custom_" + r["layout"]
    rep2 = layout_lib.pick(model, batch, hbm_bytes=1e9, rows=renamed)
    assert rep2.chosen.name.startswith("custom_")
    assert rep2.chosen.devices() == 8
    custom = layout_lib.Layout("dp_fsdp", dp=4, fsdp=2)
    priced_custom = layout_lib.price_layouts(
        model, batch, optim.adam(1e-3), layouts=[custom], ndev=8,
        device="cpu")
    rep3 = layout_lib.pick(model, batch, hbm_bytes=1e9, rows=priced_custom)
    assert (rep3.chosen.dp, rep3.chosen.fsdp) == (4, 2), rep3.chosen


def test_pick_budget_without_memory_model_degrades(priced):
    model, batch, rows = priced["port"]
    dark = copy.deepcopy(rows)
    for r in dark:
        r.pop("memory", None)
        r["peak_bytes"] = None
    rep = layout_lib.pick(model, batch, hbm_bytes=1e9, rows=dark)
    assert rep.chosen is not None
    assert "memory model unavailable" in rep.reason


def test_rank_memory_is_the_fit_checker_ranking(priced):
    model, batch, rows = priced["port"]
    by = {r["layout"]: r for r in rows}
    budget = by["dp"]["peak_bytes"] - 1
    ranked = {r["variant"]: r for r in memstats.rank_memory(
        {r["layout"]: {"memory": r.get("memory")} for r in rows
         if "invalid" not in r}, budget)}
    rep = layout_lib.pick(model, batch, hbm_bytes=budget, rows=rows)
    for r in rep.rows:
        if "invalid" in r:
            continue
        assert r["fits"] == ranked[r["layout"]]["fits"]
        assert r["headroom_bytes"] == ranked[r["layout"]]["headroom_bytes"]
    assert "invalid" in by["tp"]  # 4 heads do not split over 8 ranks


def test_cli_layout_auto_trains(tmp_path, capsys):
    """``--layout auto`` through the CLI on one gloo rank: one process
    prices before its group forms, prints the ranking, writes the report
    and trains on the choice."""
    cli = importlib.import_module("fluxdistributed_tpu_torch.train.__main__")
    report = tmp_path / "pick.json"
    task = cli.run(["--model", "lm_tiny", "--vocab", "64", "--seqlen", "16",
                    "--batch-size", "8", "--cycles", "2", "--opt", "adam",
                    "--lr", "3e-3", "--attn", "flash", "--device", "cpu",
                    "--layout", "auto", "--hbm-bytes", "1e9",
                    "--layout-report", str(report)])
    out = capsys.readouterr().out
    assert "layout pick:" in out and "<== chosen" in out
    doc = json.loads(report.read_text())
    assert doc["schema"] == "fdtpu-layout-pick/v1"
    assert doc["chosen"] == "dp" and doc["rows"][0]["fits"] is True
    assert doc["rows"][0]["memory"]["source"] == "fake"
    assert len(task.losses) == 2


def test_layout_rows_priced_in_a_child_equal_in_process():
    """Under a real group the coordinator prices in a spawned child
    (``price_layouts_in_child`` over the CLI's picklable builder): its
    rows equal the same pricing in this process."""
    import functools

    cli = importlib.import_module("fluxdistributed_tpu_torch.train.__main__")
    from fluxdistributed_tpu_torch.data import SyntheticTextDataset

    args = cli.build_parser().parse_args(
        ["--model", "lm_tiny", "--vocab", "64", "--seqlen", "16",
         "--batch-size", "8", "--attn", "flash", "--device", "cpu",
         "--layout", "auto"])
    shapes = cli._batch_shapes(args, SyntheticTextDataset(vocab=64,
                                                          seqlen=16))
    child = layout_lib.price_layouts_in_child(
        functools.partial(cli.pricing_inputs, args, shapes), ndev=2,
        device="cpu")
    model, batch, opt, loss = cli.pricing_inputs(args, shapes)
    here = layout_lib.price_layouts(model, batch, opt, loss_fn=loss, ndev=2,
                                    device="cpu")
    assert child == here
    assert [r["layout"] for r in here] == ["dp", "fsdp", "tp"]
    assert here[0]["memory"]["source"] == "fake"


# ---- pricing has power ---------------------------------------------------------

def _lm_step_peak(attn_fn, T=128):
    from fluxdistributed_tpu_torch import mesh as mesh_lib
    from fluxdistributed_tpu_torch.data import SyntheticTextDataset
    from fluxdistributed_tpu_torch.models import TransformerLM, lm_loss_fn
    from fluxdistributed_tpu_torch.train import prepare_training

    with torch.device("meta"):
        model = TransformerLM(vocab=64, dim=64, depth=2, num_heads=2,
                              mlp_dim=128, dtype=torch.float32,
                              attn_fn=attn_fn, device="meta")
    with pricing(2, device="cpu") as pr:
        m = mesh_lib.data_mesh(2, device="cpu")
        fm = pr.module(model)
        task = prepare_training(fm, SyntheticTextDataset(vocab=64, seqlen=T),
                                optim.adam(1e-3), mesh=m, batch_size=4,
                                cycles=1, device="cpu",
                                loss_fn=lm_loss_fn(fm), topk=())
        batch = pr.batch({"tokens": ((4, T), torch.int64)}, shards=2)
        return price_step(task.step_fn, (task.state, batch), mesh=m)


def test_plain_attention_prices_its_scores():
    """The plain core keeps B x H x T x T f32 scores for its backward,
    the flash kernels (priced through their shape-only branches) none:
    the plain step's priced peak exceeds the flash step's by at least
    one layer's scores."""
    from fluxdistributed_tpu_torch.ops import attention_core

    B, H, T = 2, 2, 128  # this rank's rows
    plain = _lm_step_peak(None)["memory"]["peak_bytes"]
    flash = _lm_step_peak(attention_core("flash", 128))["memory"]
    assert plain - flash["peak_bytes"] >= B * H * T * T * 4
    assert flash["source"] == "fake"


def test_a_wrong_shape_only_branch_fails_the_priced_step(monkeypatch):
    """A shape-only branch that returned a wrong shape is not priced
    around: the step fails, whether B1's output or its row LSE came
    back one row short."""
    fa = importlib.import_module(
        "fluxdistributed_tpu_torch.ops.flash_attention")
    from fluxdistributed_tpu_torch.ops import attention_core

    real_fwd = fa._fwd  # B1's launch or shape-only branch
    for which in (0, 1):
        def short(*args, which=which, **kw):
            outs = list(real_fwd(*args, **kw))
            outs[which] = (outs[which][:, :-1] if which == 0
                           else outs[which][..., :-1])
            return tuple(outs)

        monkeypatch.setattr(fa, "_fwd", short)
        with pytest.raises((RuntimeError, ValueError)):
            _lm_step_peak(attention_core("flash", 128))
    monkeypatch.setattr(fa, "_fwd", real_fwd)
    assert _lm_step_peak(attention_core("flash", 128))["memory"]
