"""Serving over a (data, model) mesh: the port's sharded engine held against
its unsharded engine and sequential decoding (JAX
``tests/test_mesh_serve.py``'s tier-1 set, on gloo ranks on the CPU).

Each mesh shape (1x2, 2x1, 2x2) is spawned once for the module
(``repro_torch.launch.mesh.spawn``: one process a rank, one intra-op
thread each) and its ranks run a list of cases
(``repro_torch.launch.mesh_cases.run_cases``); the same cases run
unsharded in this process meanwhile, and each parametrised test asserts
over one case's results. The model is the smoke tinyllama-1.1b in fp32
(4 query heads, 2 KV heads: at model 2 a rank holds 2 and 1).

- Data-only meshes (2x1): token streams bit-identical to the unsharded
  engine and to sequential decoding.
- Model meshes (1x2, 2x2): teacher-forced logits (prefill, decode steps
  slotted and paged, a paged chunk pass; over int8 pools too, each rank
  replaying its heads of the unsharded run's K/V writes) within 1e-5 of
  max(1, |logit|) of the unsharded port (row-parallel sums reorder the
  float additions), and the streams equal on JAX's workloads.
- One case each: chunked, paged copy-on-write, recompute preemption,
  sampled replay, swap against recompute, a warm start from a prefix
  cache saved by the mesh, speculation, open load with the TTFT tuner,
  one KV head (MQA: the heads do not split, each rank holds ``wk``/``wv``
  whole).
- The KV leaf bytes halve at model 2 (and at data 2 on slot rows); MoE,
  Mamba and RWKV models serve the unsharded streams at 1x2 and 2x1
  (``tests/test_torch_mesh_zoo.py`` holds the whole zoo over every mesh).
"""
import dataclasses
import threading

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch.mesh import spawn
from repro_torch.launch.mesh_cases import model, options, run_cases
from repro_torch.models import decode_step, prefill
from repro_torch.serve import Request, synthetic_requests
from torch_threads import cap_threads  # noqa: E402

cap_threads()


ARCH = "tinyllama-1.1b"
V, MAX_LEN = get_config(ARCH).smoke().vocab_size, 48
PRESETS = ("base", "nss_shortcut", "ret_byp_shortcut")
BACKENDS = ("slotted", "paged")
MESHES = {"1x2": "1,2", "2x1": "2,1", "2x2": "2,2"}
REL_TOL = 1e-5


def _matrix_requests():
    """4 requests over 2 slots with an 8-token shared prefix."""
    return synthetic_requests(4, prompt_len=12, max_new_tokens=6,
                              vocab_size=V, seed=7, shared_prefix_len=8)


def _spec_requests():
    rng = np.random.default_rng(5)
    return [Request(rid=i, prompt=np.tile(rng.integers(0, V, 6,
                                                       dtype=np.int32), 3),
                    max_new_tokens=14) for i in range(4)]


def _serve(name, preset, requests, **engine):
    """A serve case; L3 programs of 4 decode steps unless said (a 6-token
    budget then ends inside a program, and the gloo ranks exchange a
    fraction of the preset's 32 microsteps' collectives)."""
    engine.setdefault("decode_steps", 4)
    extra = {k: engine.pop(k) for k in ("decode_steps", "load", "arch",
                                        "overrides") if k in engine}
    engine = dict(dict(n_slots=2, max_len=MAX_LEN, block_size=8), **engine)
    return dict(name=name, kind="serve", preset=preset, requests=requests,
                engine=engine, **extra)


def _teacher(name, preset, backend, **kw):
    rng = np.random.default_rng(11)
    return dict(name=name, kind="teacher", preset=preset, backend=backend,
                prompt=rng.integers(0, V, 12).tolist(),
                feed=rng.integers(0, V, 5).tolist(), max_len=MAX_LEN, **kw)


MATRIX = [(kv, p) for kv in BACKENDS for p in PRESETS]
CHUNKED = [("slotted", "nss_shortcut", "1x2"), ("paged", "base", "2x1"),
           ("paged", "ret_byp_shortcut", "1x2")]
MQA = (("n_kv_heads", 1),)
RECURRENT = ("moonshot-v1-16b-a3b", "jamba-v0.1-52b", "rwkv6-7b")
INT8_TEACHER = "teacher/paged-int8/nss_shortcut"


def _cases(mesh_name, warm_path):
    reqs = _matrix_requests()
    cases = [_serve(f"matrix/{kv}/{p}", p, reqs, kv=kv) for kv, p in MATRIX]
    cases += [_serve(f"chunked/{kv}/{p}", p, reqs, kv=kv, chunked=True,
                     chunk_budget=6)
              for kv, p, m in CHUNKED if m == mesh_name]
    if mesh_name != "2x1":
        cases += [_teacher(f"teacher/{kv}/{p}", p, kv) for kv, p in MATRIX]
        cases += [_teacher(INT8_TEACHER, "nss_shortcut", "paged",
                           kv_dtype="int8", kv_writes="record")]
    if mesh_name == "1x2":
        base = synthetic_requests(1, prompt_len=16, max_new_tokens=4,
                                  vocab_size=V, seed=9)[0]
        swap = synthetic_requests(4, prompt_len=8, max_new_tokens=12,
                                  vocab_size=V, seed=3)
        sampled = synthetic_requests(2, prompt_len=8, max_new_tokens=4,
                                     vocab_size=V, seed=2)
        tight = dict(kv="paged", n_slots=3, block_size=4, num_blocks=9)
        cases += [
            _serve("cow", "base", [dataclasses.replace(base, rid=i)
                                   for i in range(3)], kv="paged"),
            _serve("preemption", "base", swap, **tight),
            _serve("sampled", "base", sampled,
                   sampling=dict(temperature=0.7, top_k=16, seed=42)),
            _serve("greedy", "base", sampled),
            _serve("swap", "nss_shortcut", swap, decode_steps=4,
                   preempt="swap", **tight),
            _serve("recompute", "nss_shortcut", swap, decode_steps=4,
                   **tight),
            dict(_serve("warm", "base", reqs, kv="paged"), kind="warm",
                 path=warm_path),
            _serve("spec", "nss_shortcut", _spec_requests(), decode_steps=3,
                   kv="paged", spec_decode="ngram", spec_width=6),
            _serve("spec-plain", "nss_shortcut", _spec_requests(),
                   decode_steps=3, kv="paged"),
            _serve("open-tuner", "nss_shortcut",
                   synthetic_requests(5, prompt_len=10, max_new_tokens=5,
                                      vocab_size=V, seed=4, rate=200.0),
                   load="open", decode_steps=2, kv="paged", chunked=True,
                   chunk_budget=8, ttft_slo_s=0.001),
            _serve("mqa/slotted", "base", reqs, overrides=MQA),
            _serve("mqa/paged", "nss_shortcut", reqs, kv="paged",
                   overrides=MQA),
            _teacher("mqa/teacher", "nss_shortcut", "paged", overrides=MQA),
            _serve("int8", "nss_shortcut", reqs, kv="paged",
                   kv_dtype="int8"),
        ]
    if mesh_name in ("1x2", "2x1"):
        cases += [_serve(f"recurrent/{a}", "base", reqs, arch=a)
                  for a in RECURRENT]
    if mesh_name == "2x1":
        cases += [_serve("open", "nss_shortcut",
                         synthetic_requests(5, prompt_len=10,
                                            max_new_tokens=5, vocab_size=V,
                                            seed=4, rate=200.0),
                         load="open", decode_steps=2)]
    return cases


_SEQ = {}


def sequential_tokens(preset, req):
    """The request alone: prefill + one-token greedy decode, unsharded."""
    key = (preset, req.rid, req.prompt.tobytes(), req.max_new_tokens)
    if key not in _SEQ:
        cfg, params = model(ARCH)
        _, opts = options(preset)
        logits, cache = prefill(params, torch.from_numpy(req.prompt)[None],
                                cfg, opts, MAX_LEN)
        out = [int(torch.argmax(logits, -1))]
        for _ in range(req.max_new_tokens - 1):
            logits, cache = decode_step(
                params, cache, torch.tensor(out[-1:], dtype=torch.int32),
                cfg, opts)
            out.append(int(torch.argmax(logits, -1)))
        _SEQ[key] = out
    return _SEQ[key]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{mesh: (rank 0's results, every rank's results)} and the unsharded
    results: the three meshes spawned at once, beside the unsharded
    cases."""
    tmp = tmp_path_factory.mktemp("mesh")
    cases = {m: _cases(m, str(tmp / f"{m}.npz")) for m in MESHES}
    # a case that records its K/V writes runs unsharded first, and the
    # ranks replay their heads of the record
    recorded = {}
    for cs in cases.values():
        for i, c in enumerate(cs):
            if c.get("kv_writes") == "record":
                if c["name"] not in recorded:
                    recorded[c["name"]] = run_cases(None, [c])[c["name"]]
                cs[i] = dict(c, kv_writes=recorded[c["name"]]["kv_writes"])
    sharded, errors = {}, []

    def spawn_one(m, spec):
        try:
            sharded[m] = spawn(run_cases, spec, "cpu", (cases[m],),
                               deadline_s=600)
        except Exception as e:       # re-raised in the test thread below
            errors.append(e)

    threads = [threading.Thread(target=spawn_one, args=item)
               for item in MESHES.items()]
    for t in threads:
        t.start()
    unique = {}
    for m, cs in cases.items():
        for c in cs:
            if c["name"] not in recorded:
                unique.setdefault(c["name"], dict(
                    c, path=str(tmp / "one_device.npz"))
                    if c["kind"] == "warm" else c)
    reference = dict(run_cases(None, list(unique.values())), **recorded)
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return {m: (out[0], out) for m, out in sharded.items()}, reference


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("kv,preset", MATRIX)
def test_mesh_identity_matrix(runs, kv, preset, mesh_name):
    """Streams equal the unsharded engine's and sequential decoding's, on
    every rank."""
    sharded, ref = runs
    name = f"matrix/{kv}/{preset}"
    r0, ranks = sharded[mesh_name]
    for r in ranks:
        assert r[name]["streams"] == ref[name]["streams"], (mesh_name, name)
    for req in _matrix_requests():
        assert r0[name]["streams"][req.rid] == sequential_tokens(preset, req)
    if kv == "paged":
        assert r0[name]["util"]["kv_prefix_shared_tokens"] > 0
    assert r0[name]["util"]["mesh"] == mesh_name.replace(",", "x")


@pytest.mark.parametrize("mesh_name", ["1x2", "2x2"])
@pytest.mark.parametrize("kv,preset", MATRIX + [("paged-int8",
                                                 "nss_shortcut")])
def test_mesh_teacher_forced_logits(runs, kv, preset, mesh_name):
    """Prefill, 5 decode steps (and on the paged pools a chunk pass),
    the same tokens fed: within 1e-5 of max(1, |logit|) of unsharded.
    Over int8 pools each rank holds its KV heads' codes and per-(block,
    head) scales, and replays its heads of the unsharded run's K/V
    writes: the codes are the unsharded pool's and only the arithmetic
    differs (a code or a scale of another head would move the logits by
    far more)."""
    sharded, ref = runs
    name = f"teacher/{kv}/{preset}"
    want = ref[name]["logits"]
    for r in sharded[mesh_name][1]:
        got = r[name]["logits"]
        assert got.shape == want.shape
        err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
        assert err.max() <= REL_TOL, (name, float(err.max()))


def test_mesh_int8_pool_streams(runs):
    """The paged engine over int8 pools at 1x2: every rank's streams are
    the unsharded engine's, and its K pool leaf holds half the heads."""
    sharded, ref = runs
    for r in sharded["1x2"][1]:
        assert r["int8"]["streams"] == ref["int8"]["streams"]
        assert r["int8"]["kv_leaf_bytes"] * 2 == ref["int8"]["kv_leaf_bytes"]


@pytest.mark.parametrize("kv,preset,mesh_name", CHUNKED)
def test_mesh_chunked_identity(runs, kv, preset, mesh_name):
    sharded, ref = runs
    name = f"chunked/{kv}/{preset}"
    r0 = sharded[mesh_name][0]
    assert r0[name]["util"]["step_mode"] == "chunked"
    assert r0[name]["streams"] == ref[name]["streams"]
    for req in _matrix_requests():
        assert r0[name]["streams"][req.rid] == sequential_tokens(preset, req)


def test_mesh_paged_cow_identity(runs):
    sharded, ref = runs
    r0 = sharded["1x2"][0]["cow"]
    assert r0["streams"] == ref["cow"]["streams"]
    assert r0["util"]["kv_cow_forks"] >= 2
    assert r0["util"]["kv_prefix_shared_tokens"] == 15 * 2
    base = synthetic_requests(1, prompt_len=16, max_new_tokens=4,
                              vocab_size=V, seed=9)[0]
    want = sequential_tokens("base", base)
    assert all(s == want for s in r0["streams"].values())


def test_mesh_paged_preemption_identity(runs):
    sharded, ref = runs
    r0 = sharded["1x2"][0]["preemption"]
    assert r0["streams"] == ref["preemption"]["streams"]
    assert r0["preemptions"] > 0 and r0["pool_hwm"] <= 9


def test_mesh_sampling_replays(runs):
    sharded, ref = runs
    r0 = sharded["1x2"][0]
    assert r0["sampled"]["streams"] == ref["sampled"]["streams"]
    assert r0["sampled"]["streams"] != r0["greedy"]["streams"]


def test_mesh_swap_vs_recompute_identity(runs):
    sharded, ref = runs
    r0 = sharded["1x2"][0]
    assert r0["swap"]["streams"] == ref["recompute"]["streams"]
    assert r0["recompute"]["streams"] == ref["recompute"]["streams"]
    assert r0["swap"]["swap_preemptions"] > 0
    assert r0["swap"]["swap_resumes"] > 0
    u = r0["swap"]["util"]
    assert u["kv_swap_out_blocks"] > 0 and u["kv_swap_in_blocks"] > 0


def test_mesh_warm_start_identity(runs, tmp_path_factory):
    """A prefix cache saved on 1x2 (rank 0 writes the unsharded layout)
    warms a 1x2 restart: the same streams, 8 shared tokens a request on
    the first batch, promotions through per-shard imports."""
    sharded, ref = runs
    r0 = sharded["1x2"][0]["warm"]
    assert r0["saved"] > 0 and r0["saved"] == ref["warm"]["saved"]
    assert r0["second"]["streams"] == r0["first"]["streams"]
    assert r0["first"]["streams"] == ref["warm"]["first"]["streams"]
    u = r0["second"]["util"]
    assert u["kv_prefix_shared_tokens"] == 8 * 4
    assert u["kv_prefix_promotions"] > 0


def test_mesh_spec_identity(runs):
    sharded, ref = runs
    r0 = sharded["1x2"][0]
    assert r0["spec"]["streams"] == r0["spec-plain"]["streams"]
    assert r0["spec"]["streams"] == ref["spec"]["streams"]
    u = r0["spec"]["util"]
    assert u["spec_steps"] > 0 and u["spec_accepted_tokens"] > 0


@pytest.mark.parametrize("mesh_name,name", [("1x2", "open-tuner"),
                                            ("2x1", "open")])
def test_mesh_open_load(runs, mesh_name, name):
    """Open-load arrivals (rank 0's clock, broadcast) and the TTFT tuner's
    budget (rank 0's) keep every rank's schedule one: the streams are the
    unsharded engine's on every rank."""
    sharded, ref = runs
    for r in sharded[mesh_name][1]:
        assert r[name]["streams"] == ref[name]["streams"]
        assert len(r[name]["streams"]) == 5


@pytest.mark.parametrize("name", ["mqa/slotted", "mqa/paged"])
def test_mesh_unsplit_kv_heads(runs, name):
    """One KV head at model 2: the cache stays whole on both ranks (JAX's
    spec replicates it), and each rank holds ``wk``/``wv`` whole where
    JAX's spec column-shards them."""
    sharded, ref = runs
    r0 = sharded["1x2"][0][name]
    assert r0["streams"] == ref[name]["streams"]
    assert r0["kv_leaf_bytes"] == ref[name]["kv_leaf_bytes"]
    logits = sharded["1x2"][0]["mqa/teacher"]["logits"]
    want = ref["mqa/teacher"]["logits"]
    err = np.abs(logits - want) / np.maximum(1.0, np.abs(want))
    assert err.max() <= REL_TOL


@pytest.mark.parametrize("mesh_name,kv,ratio", [
    ("1x2", "slotted", 2), ("1x2", "paged", 2), ("2x2", "slotted", 4),
    ("2x2", "paged", 2), ("2x1", "slotted", 2), ("2x1", "paged", 1)])
def test_mesh_shards_kv_memory(runs, mesh_name, kv, ratio):
    """Per-shard KV residency: the model axis splits the KV heads, the data
    axis the slot rows; the paged pools' block axis is not split (JAX's
    spec), so 2x1 paged holds the whole pool on each rank."""
    sharded, ref = runs
    name = f"matrix/{kv}/base"
    whole = ref[name]["kv_leaf_bytes"]
    for r in sharded[mesh_name][1]:
        assert r[name]["kv_leaf_bytes"] * ratio == whole
        assert r[name]["kv_bytes_per_shard"] <= ref[name][
            "kv_bytes_per_shard"]


@pytest.mark.parametrize("arch", RECURRENT)
def test_mesh_recurrent_and_moe(runs, arch):
    """At model 2 (experts, Mamba channels or RWKV heads split over it)
    every rank serves the unsharded streams, and so do the 2x1 ranks."""
    sharded, ref = runs
    name = f"recurrent/{arch}"
    for r in sharded["1x2"][1]:
        assert r[name]["streams"] == ref[name]["streams"]
        assert r[name]["kv_bytes_per_shard"] < ref[name][
            "kv_bytes_per_shard"]
    assert sharded["2x1"][0][name]["streams"] == ref[name]["streams"]


def _never_runs(mesh):
    raise AssertionError("a rank started")


def test_spawn_defaults_to_the_card():
    """``spawn`` runs its ranks on ``cuda`` unless asked for the CPU, and
    resolves the device before it starts any rank: without a GPU it
    raises at once."""
    import inspect
    assert inspect.signature(spawn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            spawn(_never_runs, "2,1")


@pytest.mark.parametrize("device,backend,shared", [
    ("cuda", "gloo", True), ("cuda", "nccl", False), ("cpu", "gloo", False)])
def test_in_turn_only_where_ranks_share_a_card(device, backend, shared):
    """``Mesh.in_turn`` takes turns (a world barrier a turn) only where
    every rank computes on one card: gloo over CUDA. With a card a rank
    (NCCL) or on the CPU it calls ``fn`` at once, with no collective."""
    from repro_torch.launch.mesh import Mesh

    class World:
        size, barriers = 2, 0

        def barrier(self):
            self.barriers += 1

    world = World()
    mesh = Mesh({"data": 1, "model": 2}, world=world, device=device,
                backend=backend)
    calls = []
    assert mesh.shares_card is shared
    assert mesh.in_turn(lambda: calls.append(1) or "built") == "built"
    assert calls == [1]
    assert world.barriers == (mesh.size if shared else 0)
