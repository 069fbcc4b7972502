"""Port parity for the serving stack (``fluxdistributed_tpu_torch.serve``)
on the CPU.

The golden test is the JAX package's (``tests/test_serve_engine.py``):
every request served by the port's slot engine under interleaved
admissions reproduces, token for token, what the JAX package's
sequential ``generate`` produces for that prompt with the same weights
(f32, greedy).  The rest pin the scheduler's contract on the port:
slot exhaustion queues FIFO, the bounded queue sheds load, temperature
sampling is reproducible per seed, the HTTP round trip works, and the
entry points refuse to run on a missing GPU unless asked for the CPU.
"""

import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluxdistributed_tpu.models import generate as jax_generate
from fluxdistributed_tpu.models import lm_tiny as jax_lm_tiny
from fluxdistributed_tpu_torch import resolve_device
from fluxdistributed_tpu_torch.models import generate, lm_tiny, load_flax_params
from fluxdistributed_tpu_torch.serve import (
    LMEngine, QueueFull, Request, Scheduler, serve_lm)

CONFIGS = {
    "plain": {},
    "window_gqa": {"window": 6, "sinks": 1, "num_kv_heads": 2},
}
SMALL = dict(depth=2, dim=64, mlp_dim=128)


def _pair(config, vocab=32):
    jm = jax_lm_tiny(vocab=vocab, dtype=jnp.float32, **SMALL, **CONFIGS[config])
    params = jm.init(jax.random.PRNGKey(0), np.zeros((1, 2), np.int32),
                     train=False)["params"]
    tm = lm_tiny(vocab=vocab, dtype=torch.float32, device="cpu", **SMALL,
                 **CONFIGS[config])
    load_flax_params(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm


def _jax_refs(jm, params, prompts, new):
    """JAX sequential generate() per prompt; prompts of one length share
    a batched call (one compile per length)."""
    out = {}
    for n in sorted({len(p) for p in prompts}):
        group = [p for p in prompts if len(p) == n]
        toks = np.asarray(jax_generate(jm.clone(decode=True), params,
                                       np.asarray(group, np.int32),
                                       total_len=n + new))
        for p, row in zip(group, toks):
            out[tuple(p)] = [int(t) for t in row]
    return [out[tuple(p)] for p in prompts]


def _port(config="plain"):
    return lm_tiny(vocab=32, dtype=torch.float32, device="cpu", **SMALL,
                   **CONFIGS[config])


@pytest.mark.parametrize("config,chunk", [("plain", None),
                                          ("window_gqa", None),
                                          ("window_gqa", 4)])
def test_parity_interleaved_admissions(config, chunk):
    """Engine output == JAX sequential generate() for every request,
    with admissions arriving mid-flight and prompts spanning buckets
    (and, chunked, a padded final chunk in the exactly-sized ring)."""
    jm, params, tm = _pair(config)
    engine = LMEngine(tm, max_slots=3, max_len=32, buckets=(4, 8),
                      prefill_chunk=chunk)
    sched = Scheduler(engine, max_queue=16)
    rng = np.random.default_rng(7)
    # both buckets, and a prompt exactly filling the larger one
    prompts = [[int(t) for t in rng.integers(0, 32, n)]
               for n in (3, 3, 6, 6, 8, 8)]
    reqs = [Request(prompt=p, max_new_tokens=9) for p in prompts]
    sched.submit(reqs[0]); sched.submit(reqs[1])
    sched.step(); sched.step()
    sched.submit(reqs[2]); sched.submit(reqs[3])
    sched.step()
    sched.submit(reqs[4]); sched.submit(reqs[5])
    sched.run_until_idle()
    for r, ref in zip(reqs, _jax_refs(jm, params, prompts, 9)):
        assert r.tokens == ref, (config, r.prompt)
    if config == "window_gqa":
        assert engine.kv_rows_per_slot == 6 + 1
    kv = engine.kv_cache_bytes()
    assert kv["reserved"] == kv["predicted"]


@pytest.mark.parametrize("case", ["learned_pos", "int8", "fp8_window",
                                  "chunk_rewind"])
def test_engine_matches_port_generate(case):
    """Engine == the port's sequential generate() (itself pinned to the
    JAX package in test_torch_port_lm.py) on the paths the golden test
    does not reach: learned positions, quantised KV, and a padded final
    chunk that would run past the batch-1 cache (the rewind)."""
    kw, ekw, gkw, max_len = {}, {}, {}, 32
    prompts = [[5, 3, 7], [1, 2], [4, 4, 4, 1, 9, 2, 6]]
    if case == "learned_pos":
        kw = dict(use_rope=False, max_len=32)
    elif case in ("int8", "fp8_window"):
        q = case.split("_")[0]
        ekw, gkw = dict(kv_dtype=q), dict(kv_quant=q)
        if case == "fp8_window":
            kw = dict(window=5, sinks=1)
    else:  # chunks of 6 at 0, 6, 12: the last would end at 18 > 16
        max_len, ekw = 16, dict(prefill_chunk=6)
        prompts = [list(range(1, 15)), [3, 1]]
    tm = lm_tiny(vocab=32, dtype=torch.float32, device="cpu", **SMALL, **kw)
    engine = LMEngine(tm, max_slots=2, max_len=max_len, buckets=(8,), **ekw)
    new = 2 if case == "chunk_rewind" else 6
    reqs = [Request(prompt=p, max_new_tokens=new) for p in prompts]
    Scheduler(engine).generate_all(reqs)
    for r, p in zip(reqs, prompts):
        ref = generate(tm, [p], len(p) + new, **gkw)[0].tolist()
        assert r.tokens == ref, (case, p)
    stats = engine.compile_stats()
    assert stats["decode_kernel_launches"] == 0  # CPU: the plain version
    assert {"decode_compiles", "prefill_compiles", "insert_compiles"} <= set(stats)


def test_slot_exhaustion_queues():
    tm = _port()
    engine = LMEngine(tm, max_slots=2, max_len=32, buckets=(4,))
    sched = Scheduler(engine, max_queue=8)
    prompts = [[1], [2], [3], [4], [5]]
    reqs = [Request(prompt=p, max_new_tokens=5) for p in prompts]
    for r in reqs:
        sched.submit(r)
    assert sched.queue_depth == 5
    sched.step()
    assert sched.active_slots == 2 and sched.queue_depth == 3
    seen = []
    while not sched.idle:
        seen.append(sched.active_slots)
        sched.step()
    assert max(seen) <= 2
    for r, p in zip(reqs, prompts):
        assert r.state == "done"
        assert r.tokens == generate(tm, [p], len(p) + 5)[0].tolist()
    assert reqs[0].finished_at <= reqs[-1].finished_at


def test_queue_full_backpressure_and_validation():
    engine = LMEngine(_port(), max_slots=1, max_len=16, buckets=(4,))
    sched = Scheduler(engine, max_queue=2)
    for p in ([1], [2]):
        sched.submit(Request(prompt=p, max_new_tokens=4))
    with pytest.raises(QueueFull):
        sched.submit(Request(prompt=[3], max_new_tokens=4))
    assert sched.metrics()["requests_rejected"] == 1
    with pytest.raises(ValueError, match="max_len"):
        sched.submit(Request(prompt=[1, 2], max_new_tokens=15))
    with pytest.raises(ValueError, match="largest prefill bucket"):
        sched.submit(Request(prompt=list(range(17)), max_new_tokens=1))
    sched.run_until_idle()  # the accepted ones still drain
    assert sched.metrics()["requests_finished"] == 2


def test_temperature_sampling_reproducible_and_in_range():
    tm = _port()

    def run(seed):
        engine = LMEngine(tm, max_slots=2, max_len=32, buckets=(4,))
        reqs = [Request(prompt=[1, 2], max_new_tokens=12, temperature=0.9,
                        seed=seed),
                Request(prompt=[3], max_new_tokens=12, temperature=0.9,
                        seed=seed + 1)]
        Scheduler(engine).generate_all(reqs)
        return [r.tokens for r in reqs]

    a = run(0)
    assert a == run(0), "same seeds must reproduce the same stream"
    assert all(0 <= t < 32 for toks in a for t in toks)
    assert run(123) != a, "different seeds should diverge"


def test_http_generate_round_trip():
    tm = _port()
    engine = LMEngine(tm, max_slots=2, max_len=32, buckets=(8,))
    server, httpd = serve_lm(Scheduler(engine), vocab=32, port=0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        body = json.dumps({"prompt_tokens": [4, 5, 6],
                           "max_tokens": 6}).encode()
        with urllib.request.urlopen(base + "/v1/generate", body,
                                    timeout=60) as r:
            out = json.loads(r.read())
        assert out["tokens"] == generate(tm, [[4, 5, 6]], 9)[0].tolist()
        assert len(out["generated"]) == 6
        body = json.dumps({"prompt_tokens": [1], "max_tokens": 3,
                           "stream": True}).encode()
        with urllib.request.urlopen(base + "/v1/generate", body,
                                    timeout=60) as r:
            lines = [json.loads(x) for x in r.read().splitlines() if x]
        assert [x["token"] for x in lines[:-1]] == lines[-1]["generated"]
        assert lines[-1]["done"] is True
        with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
            health = json.loads(r.read())
        assert health["ok"] and health["memory"]["available"] is False
        assert health["memory"]["kv_cache"]["reserved"] > 0
        with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
            text = r.read().decode()
        assert "fdtpu_serve_requests_finished 2" in text
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()
        th.join(timeout=10)
    assert not th.is_alive()


def test_entry_points_refuse_a_missing_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm_tiny(vocab=32, **SMALL)
    from fluxdistributed_tpu_torch.serve.__main__ import build_parser, build_server

    args = build_parser().parse_args(["--model", "lm_tiny", "--vocab", "32"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_server(args)
    assert resolve_device("cpu").type == "cpu"
