"""The port's serving slice on the CPU: engine identity inside the port,
parity of the host-side pieces with the JAX package, the launcher, and the
package's hygiene.

Identity: as in tests/test_serve.py, continuous batching (slot eviction,
re-admission, per-slot positions, multi-token L3 programs) changes
scheduling only — every request's greedy stream equals running it alone
through prefill + one-token decode, token for token (float32 on the CPU;
observed: no row of the CPU products depends on the batch it sits in).
The linkage cases run on the dense smoke model, on the MoE one
(moonshot-v1-16b-a3b-smoke: 4 experts, top-2, capacity factor 1.25) and
on the RWKV one (rwkv6-7b-smoke: recurrent state rows in place of K/V,
overwritten by each admission). The MoE capacity is per routing group;
the engine groups an admission's prompt as the sequential run does (one
prefill) and each decode token alone, so the streams match with the
tokens that capacity drops too.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (L3_NSS, LinkageConfig, MetricWriter,  # noqa: E402
                              preset)
from repro_torch.models import (ModelOptions, decode_step,  # noqa: E402
                                init_params, prefill)
from repro_torch.serve import (Request, ServeEngine, Telemetry,  # noqa: E402
                               serve_report, synthetic_requests)
from repro_torch.serve import scheduler as tsched  # noqa: E402
from repro_torch.serve.telemetry import validate_events, validate_spans  # noqa: E402
from torch_threads import cap_threads  # noqa: E402

cap_threads()

CFG = get_config("tinyllama-1.1b").smoke()
ARCHS = {"tinyllama": CFG, "moe": get_config("moonshot-v1-16b-a3b").smoke(),
         "rwkv": get_config("rwkv6-7b").smoke(),
         "jamba": get_config("jamba-v0.1-52b").smoke()}
OPTS = ModelOptions(attn_impl="ref", dtype=torch.float32)
MAX_LEN = 48
SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")


@pytest.fixture(scope="module")
def params():
    return init_params(CFG, torch.Generator().manual_seed(0), "cpu")


@pytest.fixture(scope="module", params=list(ARCHS))
def engine_model(request, params):
    """(config, parameters) of the dense, the MoE, the RWKV and the jamba
    (Mamba, attention and MoE layers) smoke model."""
    cfg = ARCHS[request.param]
    if cfg is CFG:
        return cfg, params
    return cfg, init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def sequential_tokens(params, req, max_len=MAX_LEN, opts=OPTS, cfg=CFG):
    """Reference: the request alone, prefill + one-token decode loop."""
    logits, cache = prefill(params, torch.from_numpy(req.prompt)[None], cfg,
                            opts, max_len=max_len)
    nxt = torch.argmax(logits, -1).to(torch.int32)
    out = [int(nxt[0])]
    for _ in range(req.max_new_tokens - 1):
        logits, cache = decode_step(params, cache, nxt, cfg, opts)
        nxt = torch.argmax(logits, -1).to(torch.int32)
        out.append(int(nxt[0]))
    return out


def _assert_token_identical(params, linkage, requests, n_slots,
                            load="closed", opts=OPTS, cfg=CFG, **kw):
    eng = ServeEngine(cfg, params, opts, linkage, n_slots=n_slots,
                      max_len=MAX_LEN, **kw)
    completions, wall = eng.run(requests, load=load)
    assert len(completions) == len(requests)
    by_rid = {c.rid: c for c in completions}
    for req in requests:
        got = by_rid[req.rid].tokens.tolist()
        want = sequential_tokens(params, req, cfg=cfg)
        assert got == want, f"rid {req.rid}: engine {got} != sequential {want}"
    return eng, completions, wall


# ---------------------------------------------------------------------------
# token identity across the linkage spectrum (tests/test_serve.py:66-106)
# ---------------------------------------------------------------------------

def test_engine_matches_sequential_l2(engine_model):
    """2 slots, 5 requests: every slot is evicted and re-admitted at least
    once, and the streams still match the solo runs token for token."""
    cfg, params = engine_model
    reqs = synthetic_requests(5, prompt_len=8, max_new_tokens=6,
                              vocab_size=cfg.vocab_size, seed=0)
    eng, _, _ = _assert_token_identical(params, preset("byp"), reqs, n_slots=2,
                                        cfg=cfg)
    assert eng.sched.n_free == 2          # everything evicted at the end


def test_engine_matches_sequential_l3_ret(engine_model):
    """L3: 3 tokens per program, RET (deferred sync); budgets that are not
    multiples of K force mid-program finishes + slot reuse."""
    cfg, params = engine_model
    lk = LinkageConfig(level=L3_NSS, ret_async=True, decode_steps=3)
    reqs = synthetic_requests(5, prompt_len=8, max_new_tokens=7,
                              vocab_size=cfg.vocab_size, seed=1)
    _assert_token_identical(params, lk, reqs, n_slots=2, cfg=cfg)


@pytest.mark.parametrize("name", ["linux", "base", "nss_shortcut"])
def test_engine_matches_sequential_across_presets(engine_model, name):
    """L0/L1 (functional cache), and the full shortcut preset on the CPU
    (kernel wrappers -> plain versions; the sequential reference stays on
    the plain model path)."""
    cfg, params = engine_model
    lk = dataclasses.replace(preset(name), decode_steps=4)
    opts = lk.model_options(OPTS)
    reqs = synthetic_requests(3, prompt_len=8, max_new_tokens=6,
                              vocab_size=cfg.vocab_size, seed=4)
    _assert_token_identical(params, lk, reqs, n_slots=2, opts=opts, cfg=cfg)


def test_engine_mixed_budgets_waste_accounting(params):
    lk = LinkageConfig(level=L3_NSS, decode_steps=4)
    prompts = np.random.default_rng(2).integers(
        0, CFG.vocab_size, size=(3, 8), dtype=np.int32)
    reqs = [Request(rid=i, prompt=prompts[i], max_new_tokens=m)
            for i, m in enumerate([2, 6, 9])]
    eng, comps, _ = _assert_token_identical(params, lk, reqs, n_slots=3)
    assert {len(c.tokens) for c in comps} == {2, 6, 9}
    assert eng.tokens_wasted > 0


def test_engine_open_loop(params):
    reqs = synthetic_requests(4, prompt_len=8, max_new_tokens=5,
                              vocab_size=CFG.vocab_size, seed=3, rate=500.0)
    _, comps, wall = _assert_token_identical(params, preset("byp"), reqs,
                                             n_slots=2, load="open")
    rep = serve_report(comps, wall)
    assert rep["total_tokens"] == 4 * 5
    assert rep["p99_latency_s"] >= rep["p50_latency_s"] >= 0.0


def test_engine_bucketed_prompts(params):
    """Power-of-two admission buckets with the true_len fix-up give the
    unpadded streams."""
    reqs = synthetic_requests(3, prompt_len=0, max_new_tokens=5,
                              vocab_size=CFG.vocab_size, seed=5,
                              prompt_lens=[3, 9, 12])
    _assert_token_identical(params, preset("ret_byp"), reqs, n_slots=2,
                            bucket_prompts=True)


def test_engine_eos_stops_early(params):
    """An EOS at an iret sync point finishes the request; the stream is the
    sequential one cut after its first EOS."""
    req = synthetic_requests(1, 8, 10, CFG.vocab_size, seed=6)[0]
    want = sequential_tokens(params, req)
    eos = want[3]
    req = dataclasses.replace(req, eos_id=eos)
    eng = ServeEngine(CFG, params, OPTS, preset("byp"), n_slots=1,
                      max_len=MAX_LEN)
    (c,), _ = eng.run([req])
    assert c.tokens.tolist() == want[:want.index(eos) + 1]


def test_engine_rejects_overlong_request(params):
    eng = ServeEngine(CFG, params, OPTS, preset("byp"), n_slots=1,
                      max_len=16)
    req = Request(rid=0, prompt=np.zeros(10, np.int32), max_new_tokens=10)
    with pytest.raises(ValueError, match="max_len"):
        eng.run([req])


def test_engine_telemetry_trace_is_valid(params):
    """The ported telemetry records a schema-valid trace with legal
    lifecycle spans, and its TTFT matches serve_report."""
    from repro_torch.serve.telemetry import span_latencies
    tel = Telemetry(trace=True)
    eng = ServeEngine(CFG, params, OPTS, preset("nss"), n_slots=2,
                      max_len=MAX_LEN, telemetry=tel)
    reqs = synthetic_requests(3, 8, 5, CFG.vocab_size, seed=7)
    comps, wall = eng.run(reqs)
    events = tel.trace.events
    validate_events(events)
    validate_spans(events)
    lat = span_latencies(events)
    for c in comps:
        assert abs(lat[c.rid]["ttft_s"] - c.ttft_s) < 1e-9
    assert "engine_steps_total" in tel.metrics.render()


# ---------------------------------------------------------------------------
# parity with the JAX package's host-side pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(n=5, prompt_len=8, max_new_tokens=6, vocab_size=256, seed=0),
    dict(n=4, prompt_len=8, max_new_tokens=5, vocab_size=256, seed=3,
         rate=500.0),
    dict(n=6, prompt_len=0, max_new_tokens=4, vocab_size=32000, seed=9,
         prompt_lens=[3, 9, 12], shared_prefix_len=2, eos_id=7),
])
def test_synthetic_requests_match_jax(kw):
    from repro.serve.scheduler import synthetic_requests as jreqs
    got, want = synthetic_requests(**kw), jreqs(**kw)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.rid, a.max_new_tokens, a.arrival_s, a.eos_id) == (
            b.rid, b.max_new_tokens, b.arrival_s, b.eos_id)
        np.testing.assert_array_equal(a.prompt, b.prompt)


def test_scheduler_decisions_match_jax():
    """The slot scheduler admits, places and frees as the JAX package's
    does (FIFO admission, lowest free slot first) under a seeded random mix
    of enqueues, admissions and releases; prompt buckets agree too."""
    from repro.serve import scheduler as jsched
    logs = []
    for mod in (tsched, jsched):
        rng = np.random.default_rng(0)
        s, log, rid = mod.SlotScheduler(3), [], 0
        for t in range(200):
            op = int(rng.integers(0, 3))
            if op == 0:
                s.enqueue(mod.Request(rid=rid, prompt=np.zeros(
                    int(rng.integers(1, 9)), np.int32), max_new_tokens=4))
                rid += 1
            elif op == 1 and s.can_admit():
                slot, req = s.admit_next(now=float(t))
                log.append(("admit", slot, req.rid))
            elif op == 2 and s.active:
                slot = sorted(s.active)[int(rng.integers(0, len(s.active)))]
                log.append(("release", slot, s.release(slot).req.rid))
            peek = s.peek()
            log.append((s.n_free, s.n_queued,
                        None if peek is None else peek.rid))
        logs.append(log)
    assert logs[0] == logs[1]
    for n in range(1, 130):
        for max_len in (16, 48, 128):
            assert tsched.bucket_len(n, max_len) == jsched.bucket_len(
                n, max_len)
    for mod in (tsched, jsched):
        with pytest.raises(ValueError):
            mod.SlotScheduler(1).enqueue(mod.Request(
                rid=0, prompt=np.zeros(0, np.int32), max_new_tokens=1))


def test_serve_report_has_the_jax_keys(params):
    """Same completions -> the port's report has every key the JAX
    engine's report has (engine utilization included)."""
    import jax
    from repro.configs import get_config as jget
    from repro.core import preset as jpreset
    from repro.models import ModelOptions as JOpts, init_params as jinit
    from repro.serve import ServeEngine as JEngine, serve_report as jreport
    from repro.serve import synthetic_requests as jreqs
    jcfg = jget("tinyllama-1.1b").smoke()
    jeng = JEngine(jcfg, jinit(jax.random.PRNGKey(0), jcfg), JOpts(),
                   jpreset("byp"), n_slots=2, max_len=MAX_LEN)
    jcomps, jwall = jeng.run(jreqs(2, 8, 3, CFG.vocab_size))
    eng = ServeEngine(CFG, params, OPTS, preset("byp"), n_slots=2,
                      max_len=MAX_LEN)
    comps, wall = eng.run(synthetic_requests(2, 8, 3, CFG.vocab_size))
    got = serve_report(comps, wall, eng.utilization())
    want = jreport(jcomps, jwall, jeng.utilization())
    assert set(got) == set(want)
    assert set(serve_report([], 0.0)) == set(jreport([], 0.0))


# ---------------------------------------------------------------------------
# the launcher (python -m repro_torch.launch.serve ... --device cpu)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("load,extra", [
    ("open", ["--rate", "200"]),
    ("closed", ["--preset", "ret_byp", "--slots", "2"]),
    ("seq", ["--batch", "2"]),
    ("closed", ["--arch", "moonshot-v1-16b-a3b", "--dtype", "bf16"]),
    ("seq", ["--arch", "moonshot-v1-16b-a3b", "--dtype", "bf16",
             "--batch", "2"]),
])
def test_launcher_prints_a_report(load, extra, capsys):
    from repro_torch.launch import serve as launch
    rc = launch.main(["--device", "cpu", "--load", load, "--requests", "2",
                      "--prompt-len", "8", "--gen-len", "6", *extra])
    assert rc == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["load"] == load and rep["device"] == "cpu"
    assert rep["dtype"] == ("bfloat16" if "bf16" in extra else "float32")
    assert rep["total_tokens"] == 2 * 6 * (2 if load == "seq" else 1)
    assert rep["tokens_per_s"] > 0


def test_launcher_writes_trace_and_metrics(tmp_path, capsys):
    """--trace (Chrome JSON, loadable by load_trace and schema-valid) and
    --metrics (Prometheus text) through the launcher."""
    from repro_torch.launch import serve as launch
    from repro_torch.serve.telemetry import load_trace
    trace, metrics = tmp_path / "t.json", tmp_path / "m.prom"
    launch.main(["--device", "cpu", "--load", "closed", "--requests", "2",
                 "--prompt-len", "8", "--gen-len", "4", "--trace",
                 str(trace), "--metrics", str(metrics)])
    rep = json.loads(capsys.readouterr().out)
    events = load_trace(str(trace))
    assert rep["trace_events"] == len(events) > 0
    validate_events(events)
    assert "engine_completions_total" in metrics.read_text()


@pytest.mark.parametrize("flags,want", [
    (["--kv", "paged", "--kv-dtype", "int8", "--preempt", "swap"],
     dict(kv_backend="paged", kv_dtype="int8")),
    (["--spec-decode", "ngram", "--preempt", "swap"],
     dict(kv_backend="slotted", spec_decode="ngram")),
    (["--preempt", "swap"], dict(kv_backend="slotted")),
    (["--kv", "paged", "--kv-dtype", "fp8", "--prefix-cache", "x.npz"],
     dict(kv_backend="paged", kv_dtype="fp8")),
])
def test_launcher_tier_flags_serve(flags, want, tmp_path, capsys):
    """The host tier's flags serve as JAX's launcher does: ``--preempt
    swap`` on paged builds the host tier (its keys in the report; nothing
    preempts at the default pool), on slotted it has nothing to swap;
    ``--prefix-cache`` saves the cache after the run and a second run
    warm-starts from it and promotes what it restored."""
    from repro_torch.launch import serve as launch
    flags = [str(tmp_path / f) if f.endswith(".npz") else f for f in flags]
    argv = ["--device", "cpu", "--load", "closed", "--requests", "2",
            "--prompt-len", "16", "--gen-len", "4", *flags]
    assert launch.main(argv) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["total_tokens"] == 2 * 4
    assert {k: rep[k] for k in want} == want
    assert rep["preempt_policy"].startswith(
        "swap" if "swap" in flags else "recompute")
    assert rep["swap_preemptions"] == rep["swap_resumes"] == 0
    # the host tier exists on paged under swap or a warm start
    assert ("kv_host_blocks_total" in rep) == (want["kv_backend"] == "paged"
                                               and "swap" in flags)
    if "--prefix-cache" in flags:
        assert rep["prefix_cache_saved"] > 0
        assert "prefix_cache_restored" not in rep
        assert launch.main(argv) == 0
        rep = json.loads(capsys.readouterr().out)
        assert rep["prefix_cache_restored"] > 0
        assert rep["kv_prefix_promotions"] > 0


@pytest.mark.parametrize("flags", [
    ["--chunked", "--prefix-cache", "x.npz"],
    ["--prefix-cache", "x.npz"],
])
def test_launcher_prefix_cache_needs_paged(flags, tmp_path):
    """``--prefix-cache`` without ``--kv paged`` raises JAX's
    ``ValueError`` before serving, and writes no file."""
    from repro_torch.launch import serve as launch
    flags = [str(tmp_path / f) if f.endswith(".npz") else f for f in flags]
    with pytest.raises(ValueError, match="--kv paged"):
        launch.main(["--device", "cpu", "--requests", "1", *flags])
    assert not (tmp_path / "x.npz").exists()


@pytest.mark.parametrize("flags,item", [
    (["--arch", "moonshot-v1-16b-a3b", "--mesh", "1,2"], "entry 9c"),
    (["--temperature", "0.7", "--arch", "rwkv6-7b", "--mesh", "1,2"],
     "entry 9c"),
])
def test_out_of_slice_options_raise(flags, item, capsys):
    """The MoE and RWKV models at a model axis > 1, which raised before
    any rank started until ROADMAP ``item`` ported them, serve over two
    spawned ranks on the CPU (greedy and sampled): rank 0 reports the mesh
    and every request."""
    from repro_torch.launch import serve as launch
    assert item == "entry 9c"
    assert launch.main(["--device", "cpu", "--requests", "1", "--load",
                        "closed", "--prompt-len", "8", "--gen-len", "4",
                        *flags]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["mesh"] == "1x2" and rep["requests"] == 1
    assert rep["total_tokens"] == 4 and len(rep["ranks"]) == 2


def test_launcher_serves_sampled(capsys):
    """--temperature with --top-k serves every request and reports."""
    from repro_torch.launch import serve as launch
    assert launch.main(["--device", "cpu", "--load", "closed", "--requests",
                        "2", "--prompt-len", "8", "--gen-len", "6",
                        "--temperature", "0.7", "--top-k", "5"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["requests"] == 2 and rep["total_tokens"] == 2 * 6
    assert rep["tokens_per_s"] > 0


@pytest.mark.parametrize("arch", ["rwkv", "jamba"])
@pytest.mark.parametrize("mode", [dict(chunked=True),
                                  dict(spec_decode="ngram")])
def test_recurrent_archs_refuse_chunk_and_verify_passes(arch, mode):
    """RWKV and Mamba layers carry a recurrent state: the chunk and verify
    passes refuse them with JAX's ``ValueError`` (``_check_pageable``)."""
    cfg = ARCHS[arch]
    p = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="plain-attention"):
        ServeEngine(cfg, p, OPTS, preset("byp"), n_slots=1, max_len=MAX_LEN,
                    **mode)


def test_cuda_request_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: a cuda request is honoured")
    from repro_torch import resolve_device
    from repro_torch.launch import serve as launch
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        launch.run_engine("tinyllama-1.1b", "byp", requests=1)
    # the lower entry points default to cuda as well
    from repro_torch.convert import params_from_jax
    from repro_torch.models import init_cache, init_params
    from repro_torch.serve.cache import init_slot_cache
    tree = {"embed": np.zeros((4, 2), np.float32),
            "final_norm": {"scale": np.ones(2, np.float32)},
            "blocks": ({"norm1": {"scale": np.ones((1, 2), np.float32)}},)}
    for call in (lambda: params_from_jax(tree),
                 lambda: init_cache(CFG, 1, 8),
                 lambda: init_slot_cache(CFG, 1, 8),
                 lambda: init_params(CFG, torch.Generator(), "cuda")):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def test_metric_writer_drains_tensors_and_reraises():
    got = []
    w = MetricWriter(lambda step, m: got.append((step, m)))
    w.submit(1, {"loss": torch.tensor(2.5), "n": 3})
    w.close()
    assert got == [(1, {"loss": 2.5, "n": 3})]

    def bad(step, m):
        raise RuntimeError("sink down")
    w = MetricWriter(bad)
    w.submit(0, {})
    with pytest.raises(RuntimeError, match="sink down"):
        w.close()


# ---------------------------------------------------------------------------
# hygiene
# ---------------------------------------------------------------------------

def test_port_imports_neither_jax_nor_the_jax_package():
    """Every repro_torch module imports in a fresh interpreter without
    pulling in jax or any module of the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib')) or m == 'repro'\n"
        "             or m.startswith('repro.'))\n"
        "assert len(names) >= 20, names\n"
        "assert {'repro_torch.serve.paging', 'repro_torch.kernels.paged_decode',\n"
        "        'repro_torch.kernels.paged_prefill',\n"
        "        'repro_torch.kernels.kv_quant',\n"
        "        'repro_torch.kernels.moe_route',\n"
        "        'repro_torch.configs.moonshot_v1_16b_a3b',\n"
        "        'repro_torch.kernels.rwkv6', 'repro_torch.configs.rwkv6_7b',\n"
        "        'repro_torch.kernels.mamba_ssm',\n"
        "        'repro_torch.configs.jamba_v0_1_52b'\n"
        "        } <= set(names), names\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
