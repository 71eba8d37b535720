"""The zoo's MoE, Mamba and RWKV models over a (data, model) mesh: expert
parallelism (``tp_experts``, ``ep_resident``), Mamba's inner channels and
RWKV's heads split over "model", and a fleet's replicas over one mesh,
on gloo ranks on the CPU.

Each mesh (1x2, 2x1, 2x2) is spawned once for the module, all three at
once (``repro_torch.launch.mesh.spawn``: a process a rank, one intra-op
thread each); its ranks run a list of cases (``_rank``: the serving ones
through ``repro_torch.launch.mesh_cases``, the training ones here), and
this process computes the references meanwhile. The models are the smoke
configs of moonshot-v1-16b-a3b, mixtral-8x7b, kimi-k2-1t-a32b,
jamba-v0.1-52b and rwkv6-7b on JAX's init (``convert.train_state_from_jax``);
the oracles are JAX's *unsharded* functions (JAX's mesh serving fails
under jax 0.9.0, ROADMAP R1) and the port's unsharded paths.

- Teacher-forced logits at 1x2 and 2x2 (prefill of 12 tokens, 4 slotted
  decode steps; moonshot also paged, with a chunk pass): within 1e-4 of
  JAX's ``prefill`` / ``decode_step_slots`` (the tolerance
  ``test_torch_moe.py``, ``test_torch_mamba.py`` and
  ``test_torch_rwkv.py`` hold these models to unsharded), and within 1e-5
  of max(1, |logit|) of the port's unsharded path. One moonshot case runs
  at capacity factor 0.5, where its prefill drops tokens.
- Streams: the engine's at 1x2, 2x1 and 2x2 equal the unsharded port's.
- Bytes a rank at model 2: the Mamba conv and scan states and the RWKV
  state half of unsharded, the expert weights E/tp of the whole.
- Training: step 1's loss, aux loss and every piece's max |dgrad| over
  its max |grad| (the router, ``x_proj``, ``conv_w`` and the RWKV mixes
  among them) against JAX's jitted unsharded ``loss_fn`` gradient, for
  moonshot at 1x2 and 2x2, jamba and rwkv6 at 1x2 and moonshot with
  ``ep_resident`` at 2x1 and 2x2; one ``ShardedTrainStep`` against JAX's
  ``make_train_step``; an ``ep_resident`` checkpoint saved at 2x1 and
  restored onto one device bit for bit.
- The fleet over a mesh: ``FleetEngine`` at 1x2, 2 replicas, colocated and
  disaggregated, fp32 and int8 blocks, streams equal to the unsharded
  fleet's (``launch/fleet.py --mesh 1,2`` runs in
  ``tests/test_torch_fleet.py``).
- The all-to-all's ``Function`` through ``torch.autograd.gradcheck`` in
  float64 over 2 ranks.
"""
import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import (L1_BASE, LinkageConfig,  # noqa: E402
                              build_sharded_train_step)
from repro_torch.data import DataConfig, Pipeline, stage  # noqa: E402
from repro_torch.launch import mesh_cases  # noqa: E402
from repro_torch.launch.mesh import mesh_shape, spawn  # noqa: E402
from repro_torch.models import ModelOptions  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.serve import synthetic_requests  # noqa: E402
from repro_torch.sharding import comm  # noqa: E402
from repro_torch.sharding.rules import gather, shard, unshard  # noqa: E402
from torch_threads import cap_threads  # noqa: E402

cap_threads()

MOE, JAMBA, RWKV = "moonshot-v1-16b-a3b", "jamba-v0.1-52b", "rwkv6-7b"
ZOO = (MOE, "mixtral-8x7b", "kimi-k2-1t-a32b", JAMBA, RWKV)
MESHES = {"1x2": (1, 2), "2x1": (2, 1), "2x2": (2, 2)}
V, MAX_LEN = 256, 32
#: teacher-forced logits against JAX's and against the unsharded port's
JAX_ATOL, REL_TOL = 1e-4, 1e-5
#: training: the loss against JAX's (rtol), a piece's max |dgrad| over its
#: max |grad| against JAX's and against the unsharded port's
LOSS_RTOL, GRAD_JAX, GRAD_PORT = 1e-4, 1e-4, 5e-5
B, S, LR = 4, 16, 1e-3
OCFG = AdamWConfig(lr=LR, warmup_steps=2, total_steps=50, weight_decay=0.0)
#: the flash and rmsnorm Functions (plain on the CPU), plain scans
KOPTS = ModelOptions(attn_impl="kernel", scan_impl="ref", dtype=torch.float32,
                     fused_norm=True)
DROP = 0.5                       # moonshot's capacity factor in the drop case


def _moe_drop():
    m = get_config(MOE).smoke().moe
    return (("moe", dataclasses.replace(m, capacity_factor=DROP)),)


#: teacher-forced cases: (name, arch, overrides, backend)
TEACHER = [(a, a, (), "slotted") for a in ZOO] + [
    ("moonshot/drop", MOE, _moe_drop(), "slotted"),
    ("moonshot/paged", MOE, (), "paged")]
#: training cases: (name, arch, ep_resident, meshes)
TRAIN = [("moonshot", MOE, False, ("1x2", "2x2")),
         ("jamba", JAMBA, False, ("1x2",)),
         ("rwkv", RWKV, False, ("1x2",)),
         ("moonshot/ep", MOE, True, ("2x1", "2x2"))]
#: fleet cases: (name, prefill replicas, kv_dtype)
FLEET = [("colocated/fp32", 0, "bf16"), ("disaggregated/fp32", 1, "bf16"),
         ("colocated/int8", 0, "int8"), ("disaggregated/int8", 1, "int8")]


# ---------------------------------------------------------------------------
# JAX's weights, configs and references
# ---------------------------------------------------------------------------

def _jax_cfg(arch, overrides=()):
    from repro.configs import get_config as jget
    from repro.configs.base import MoEConfig as JMoE
    over = dict(overrides)
    if "moe" in over:
        over["moe"] = JMoE(**dataclasses.asdict(over["moe"]))
    return dataclasses.replace(jget(arch).smoke(), **over)


def _teacher_inputs(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    return rng.integers(0, V, 12).tolist(), rng.integers(0, V, 4).tolist()


def _jax_teacher(jp, arch, overrides, prompt, feed):
    """JAX's prefill, then one ``decode_step_slots`` a fed token (both
    jitted): (5, V)."""
    import functools

    import jax
    import jax.numpy as jnp
    from repro.models import ModelOptions as JOpts
    from repro.models import decode_step_slots, prefill
    from repro.serve.cache import slotify
    jcfg = _jax_cfg(arch, overrides)
    jopts = JOpts(attn_impl="ref", scan_impl="ref", dtype=jnp.float32)
    lg, cache = jax.jit(functools.partial(
        prefill, cfg=jcfg, opts=jopts, max_len=MAX_LEN))(
            jp, jnp.asarray([prompt], jnp.int32))
    step = jax.jit(functools.partial(decode_step_slots, cfg=jcfg,
                                     opts=jopts))
    cache, out = slotify(cache), [np.asarray(lg)]
    for t in feed:
        lg, cache = step(jp, cache, jnp.asarray([t], jnp.int32))
        out.append(np.asarray(lg))
    return np.concatenate(out)


def _jax_state(arch):
    """JAX's ``TrainState`` (key 3; its parameters are every case's
    weights) and the port's of it, on the host."""
    import jax
    from repro.core.step import init_train_state as jinit
    from repro.optim import AdamWConfig as JAdam
    from repro_torch.convert import train_state_from_jax
    jcfg = _jax_cfg(arch)
    jo = JAdam(lr=LR, warmup_steps=2, total_steps=50, weight_decay=0.0)
    js = jinit(jax.random.PRNGKey(3), jcfg, jo)
    return jcfg, jo, js, train_state_from_jax(jax.tree.map(np.asarray, js),
                                              "cpu")


def _jax_grads(jcfg, jo, js, batch, step):
    import jax
    import jax.numpy as jnp
    from repro.core.step import make_train_step as jmake
    from repro.models import ModelOptions as JOpts
    from repro.models import loss_fn as jloss
    jopts = JOpts(attn_impl="ref", scan_impl="ref", dtype=jnp.float32)
    batch = jax.tree.map(jnp.asarray, batch)
    (loss, m), g = jax.jit(jax.value_and_grad(
        lambda p, b: jloss(p, b, jcfg, jopts), has_aux=True))(js.params,
                                                              batch)
    out = {"metrics": {k: float(v) for k, v in m.items()},
           "grads": params_from_jax(jax.tree.map(np.asarray, g), "cpu")}
    if step:
        _, jm = jax.jit(jmake(jcfg, jopts, jo))(js, batch)
        out["step"] = {k: float(v) for k, v in jm.items()}
    return out


def _port_grads(cfg, state, batch):
    from repro_torch.models import loss_fn
    live = [p.detach().requires_grad_(True)
            for p in tree.leaves(state.params)]
    _, m = loss_fn(tree.unflatten(state.params, live), stage(batch, "cpu"),
                   cfg, KOPTS)
    g = torch.autograd.grad(m["loss"], live, allow_unused=True)
    g = [torch.zeros_like(p) if x is None else x for x, p in zip(g, live)]
    return ({k: float(v.detach()) for k, v in m.items()},
            tree.unflatten(state.params, g))


def _batch(cfg):
    return Pipeline(cfg, DataConfig(global_batch=B, seq_len=S)).batch_at(0)


# ---------------------------------------------------------------------------
# the cases each rank runs
# ---------------------------------------------------------------------------

def _train_case(mesh, c):
    """Step 1's gradient pieces and metrics, then one step; under
    ``save`` a checkpoint of the stepped pieces too."""
    cfg = get_config(c["arch"]).smoke()
    st = c["state"]
    fn, sspecs, bspecs = build_sharded_train_step(
        cfg, KOPTS, OCFG, LinkageConfig(level=L1_BASE), mesh, st, B,
        ep_resident=c["ep"])
    pieces = shard(st, sspecs, mesh)
    batch = stage(_batch(cfg), "cpu", bspecs, mesh)
    comm.reset_traffic()
    g, m = fn.grads(pieces.params, batch)
    traffic = comm.traffic()
    new, sm = fn(pieces, batch)
    out = {"grads": g, "metrics": {k: float(v) for k, v in m.items()},
           "step": {k: float(v) for k, v in sm.items()}, "traffic": traffic,
           "resident": fn.layout.resident}
    if "dir" in c:
        ckpt.save(c["dir"], 1, new, specs=sspecs, mesh=mesh)
        mesh.world.barrier()
        out["stepped"] = gather(new, sspecs, mesh)
    return out


def _gradcheck_case(mesh, c):
    """The all-to-all over every rank inside a function of a replicated
    input with a replicated output (each rank's input scaled by its index
    + 1, its output placed into the whole): a global function, so
    ``gradcheck``'s perturbations, made on every rank at once, are of one
    input, and a wrong backward shows."""
    world = mesh.world
    x = torch.arange(24, dtype=torch.float64).reshape(8, 3) / 7
    x.requires_grad_(True)

    def f(x):
        y = comm._Enter.apply(x, world) * (world.index + 1)
        y = comm._AllToAll.apply(y.contiguous(), world)
        return comm._Place.apply(y, world, 8 * world.size, 0)
    ok = torch.autograd.gradcheck(f, (x,), eps=1e-6, atol=1e-8)
    return {"ok": ok, "value": f(x).detach()}


def _rank(mesh, cases):
    local = {"train": _train_case, "gradcheck": _gradcheck_case}
    return {c["name"]: (local[c["kind"]](mesh, c) if c["kind"] in local
                        else mesh_cases.run_case(c, mesh))
            for c in cases}


def _serve_case(arch, weights):
    reqs = synthetic_requests(4, prompt_len=10, max_new_tokens=6,
                              vocab_size=V, seed=7)
    return dict(name=f"serve/{arch}", kind="serve", preset="nss_shortcut",
                arch=arch, weights=weights, requests=reqs, decode_steps=4,
                engine=dict(n_slots=2, max_len=MAX_LEN))


def _fleet_case(name, prefill, kv_dtype):
    reqs = synthetic_requests(4, prompt_len=12, max_new_tokens=5,
                              vocab_size=V, seed=3, shared_prefix_len=8)
    return dict(name=f"fleet/{name}", kind="fleet", preset="nss_shortcut",
                requests=reqs, decode_steps=2,
                engine=dict(replicas=2, prefill_replicas=prefill, n_slots=2,
                            max_len=MAX_LEN, kv="paged", block_size=4,
                            kv_dtype=kv_dtype))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{mesh: every rank's results} and the references: the three meshes
    spawned at once while this process computes JAX's and the port's
    unsharded results."""
    pytest.importorskip("jax")
    tmp = tmp_path_factory.mktemp("mesh_zoo")
    jstates = {a: _jax_state(a) for a in ZOO}
    weights = {a: (s[2].params, s[3].params) for a, s in jstates.items()}
    teacher = {}
    for name, arch, over, backend in TEACHER:
        prompt, feed = _teacher_inputs(name)
        teacher[name] = dict(name=f"teacher/{name}", kind="teacher",
                             preset="base", arch=arch, overrides=over,
                             weights=weights[arch][1], backend=backend,
                             prompt=prompt, feed=feed, max_len=MAX_LEN,
                             block_size=4)
    ckdir = str(tmp / "ep")
    cases = {m: [_serve_case(a, weights[a][1]) for a in ZOO] for m in MESHES}
    for m in ("1x2", "2x2"):
        cases[m] += list(teacher.values())
    cases["1x2"] += [_fleet_case(*f) for f in FLEET]
    for name, arch, ep, meshes in TRAIN:
        for m in meshes:
            c = dict(name=f"train/{name}", kind="train", arch=arch, ep=ep,
                     state=jstates[arch][3])
            if ep and m == "2x1":
                c["dir"] = ckdir
            cases[m].append(c)
    cases["2x1"].append(dict(name="gradcheck", kind="gradcheck"))

    out, errors = {}, []

    def spawn_one(m):
        try:
            out[m] = spawn(_rank, "{},{}".format(*MESHES[m]), "cpu",
                           (cases[m],), deadline_s=420)
        except Exception as e:       # re-raised in the test thread below
            errors.append(e)

    threads = [threading.Thread(target=spawn_one, args=(m,))
               for m in MESHES]
    for t in threads:
        t.start()
    ref = {"port": {}, "jax": {}, "train": {}}
    unique = {c["name"]: c for cs in cases.values() for c in cs
              if c["kind"] in ("serve", "teacher", "fleet")}
    for c in unique.values():
        record = dict(c, routes="record") if c["kind"] == "teacher" else c
        ref["port"][c["name"]] = mesh_cases.run_case(record, None)
    for name, arch, over, _ in TEACHER:
        prompt, feed = _teacher_inputs(name)
        ref["jax"][name] = _jax_teacher(weights[arch][0], arch, over, prompt,
                                        feed)
    by_arch = {}
    for name, arch, ep, _ in TRAIN:
        jcfg, jo, js, st = jstates[arch]
        if arch not in by_arch:        # ep_resident: the same references
            batch = _batch(get_config(arch).smoke())
            by_arch[arch] = dict(_jax_grads(jcfg, jo, js, batch,
                                            step=arch == MOE),
                                 port=_port_grads(get_config(arch).smoke(),
                                                  st, batch),
                                 state=st)
        ref["train"][name] = by_arch[arch]
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out, ref, ckdir


def _specs(mesh_name, arch, state, ep):
    return build_sharded_train_step(
        get_config(arch).smoke(), KOPTS, OCFG, LinkageConfig(level=L1_BASE),
        mesh_shape(*MESHES[mesh_name]), state, B, ep_resident=ep)[1]


def _piece_errors(got, want):
    """{path: max |dgrad| / max |grad|} of every piece."""
    from repro_torch.sharding.rules import _map_with_path
    paths = []
    _map_with_path(lambda p, leaf: paths.append("/".join(p)), want)
    out = {}
    for path, g, w in zip(paths, tree.leaves(got), tree.leaves(want)):
        w = w.detach()
        scale = float(w.abs().max())
        out[path] = float((g - w).abs().max()) / scale if scale else float(
            g.abs().max())
    return out


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_name", ["1x2", "2x2"])
@pytest.mark.parametrize("name", [t[0] for t in TEACHER])
def test_teacher_forced_logits(runs, name, mesh_name):
    """Prefill and 4 slotted decode steps (paged: 4 paged decode steps and
    a chunk pass) on every rank: within 1e-4 of JAX's unsharded
    prefill/``decode_step_slots`` and within 1e-5 of max(1, |logit|) of
    the port's unsharded path."""
    out, ref, _ = runs
    key = f"teacher/{name}"
    want = ref["port"][key]["logits"]
    jax_rows = ref["jax"][name]
    for r in out[mesh_name]:
        got = r[key]["logits"]
        assert got.shape == want.shape
        err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
        assert err.max() <= REL_TOL, (name, float(err.max()))
        # the paged case's first 5 rows are the slotted decode's logits
        np.testing.assert_allclose(got[:len(jax_rows)], jax_rows,
                                   atol=JAX_ATOL, rtol=0)


def test_moe_drop_case_drops_tokens(runs):
    """At capacity factor 0.5 the smoke moonshot's prefill routes more
    tokens to some expert of a group than its capacity holds: the drop
    case holds the global capacity, not a rank's."""
    _, ref, _ = runs
    routes = ref["port"]["teacher/moonshot/drop"]["routes"]
    m = get_config(MOE).smoke().moe
    _, idx = routes[0]                                 # the prefill's first
    G, gs, K = idx.shape
    C = min(max(int(gs * K * DROP / m.num_experts), 1), gs)
    counts = torch.nn.functional.one_hot(idx.long(), m.num_experts).sum(
        (1, 2))
    assert int(counts.max()) > C


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ZOO)
def test_streams_equal_unsharded(runs, arch, mesh_name):
    """The engine (``nss_shortcut``, L3 programs of 4) serves the unsharded
    port's streams on every rank."""
    out, ref, _ = runs
    key = f"serve/{arch}"
    want = ref["port"][key]["streams"]
    assert len(want) == 4
    for r in out[mesh_name]:
        assert r[key]["streams"] == want
        assert r[key]["util"]["mesh"] == mesh_name


@pytest.mark.parametrize("arch", ZOO)
def test_bytes_per_shard_at_model_2(runs, arch):
    """At 1x2 every Mamba conv and scan state and RWKV state leaf holds
    half the unsharded bytes (the RWKV shifts stay whole), and a rank's
    expert weights are E/tp of the whole."""
    out, ref, _ = runs
    key = f"serve/{arch}"
    want = ref["port"][key]
    for r in out["1x2"]:
        got = r[key]
        assert got["state_bytes"] == {k: v // 2 for k, v in
                                      want["state_bytes"].items()}
        assert got["expert_bytes"] * 2 == want["expert_bytes"]
        assert got["kv_bytes_per_shard"] < want["kv_bytes_per_shard"]
    if arch in (JAMBA, RWKV):
        assert want["state_bytes"]
    if arch != RWKV:
        assert want["expert_bytes"] > 0


@pytest.mark.parametrize("name,prefill,kv_dtype", FLEET)
def test_fleet_over_mesh(runs, name, prefill, kv_dtype):
    """``FleetEngine`` with every replica over the 1x2 mesh (one shard of
    the weights, a shared host tier a rank over its KV heads): the
    unsharded fleet's streams on every rank, the handoffs when
    disaggregated, the mesh in the report."""
    out, ref, _ = runs
    key = f"fleet/{name}"
    want = ref["port"][key]
    assert len(want["streams"]) == 4
    for r in out["1x2"]:
        assert r[key]["streams"] == want["streams"]
        assert r[key]["handoffs"] == want["handoffs"] == (4 if prefill
                                                          else 0)
        assert r[key]["util"]["mesh"] == "1x2"
        assert r[key]["util"]["kv_dtype"] == kv_dtype


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

TRAIN_CELLS = [(n, a, ep, m) for n, a, ep, ms in TRAIN for m in ms]


@pytest.mark.parametrize("name,arch,ep,mesh_name", TRAIN_CELLS)
def test_sharded_grads_match_jax(runs, name, arch, ep, mesh_name):
    """Step 1 on every rank: the loss and aux loss against JAX's, and the
    gradient reassembled from every rank's pieces, piece by piece (max
    |dgrad| / max |grad|), against JAX's jitted unsharded ``loss_fn``
    gradient and the unsharded port's."""
    out, ref, _ = runs
    j = ref["train"][name]
    ranks = out[mesh_name]
    key = f"train/{name}"
    specs = _specs(mesh_name, arch, j["state"], ep).params
    full = unshard([r[key]["grads"] for r in ranks], specs,
                   mesh_shape(*MESHES[mesh_name]))
    for r in ranks:
        m = r[key]["metrics"]
        assert m == ranks[0][key]["metrics"]
        for k in ("loss", "moe_aux"):
            np.testing.assert_allclose(m[k], j["metrics"][k],
                                       rtol=LOSS_RTOL)
    errs = _piece_errors(full, j["grads"])
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_JAX, (worst, errs[worst])
    errs = _piece_errors(full, j["port"][1])
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_PORT, (worst, errs[worst])
    named = {MOE: "mlp/router", JAMBA: "mixer/x_proj", RWKV: "mixer/mix_r"}
    pieces = [p for p in errs if p.endswith(named[arch])]
    if arch == JAMBA:
        pieces += [p for p in errs if p.endswith("mixer/conv_w")]
    assert pieces
    if arch == MOE:
        assert j["metrics"]["moe_aux"] > 0
    grads = dict(zip(errs, tree.leaves(full)))
    assert all(float(grads[p].abs().max()) > 0 for p in pieces)


@pytest.mark.parametrize("name,mesh_name", [("moonshot", "1x2"),
                                            ("moonshot", "2x2")])
def test_sharded_step_matches_make_train_step(runs, name, mesh_name):
    """One ``ShardedTrainStep``: its loss, gradient norm and learning rate
    are JAX's ``make_train_step``'s."""
    out, ref, _ = runs
    want = ref["train"][name]["step"]
    for r in out[mesh_name]:
        got = r[f"train/{name}"]["step"]
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL)


@pytest.mark.parametrize("mesh_name", ["2x1", "2x2"])
def test_ep_resident_experts_stay_resident(runs, mesh_name):
    """Under ``ep_resident`` the expert pieces are cut over every rank
    (E / 4 a rank at 2x2), never gathered over "data" and kept out of the
    data reduce; the tokens move by the all-to-all, whose bytes the
    traffic counts."""
    out, ref, _ = runs
    st = ref["train"]["moonshot/ep"]["state"]
    specs = _specs(mesh_name, MOE, st, True).params
    mlp = specs["layers"][0]["mlp"]
    assert mlp["wi"][0] == ("data", "model") and mlp["router"][1] is None
    E = get_config(MOE).smoke().moe.num_experts
    d, m = MESHES[mesh_name]
    for r in out[mesh_name]:
        got = r["train/moonshot/ep"]
        assert got["grads"]["layers"][0]["mlp"]["wi"].shape[0] == E // (d * m)
        assert sum(got["resident"]) == 3 * get_config(MOE).smoke().num_layers
        assert got["traffic"]["all_to_all"] > 0


def test_ep_checkpoint_restores_on_one_device(runs):
    """The state after one ``ep_resident`` step at 2x1, saved from the
    pieces (gathered, rank 0 writing), restores onto one device bit for
    bit: equal to the pieces put back together."""
    out, ref, ckdir = runs
    like = ref["train"]["moonshot/ep"]["state"]
    restored = ckpt.restore(ckdir, 1, tree.tree_map(torch.empty_like, like))
    for r in out["2x1"]:
        stepped = r["train/moonshot/ep"]["stepped"]
        for a, b in zip(tree.leaves(stepped), tree.leaves(restored)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(restored.step) == 1


def test_all_to_all_gradcheck(runs):
    """``_AllToAll`` (its backward the reverse exchange) passes
    ``gradcheck`` in float64 on both ranks, and its forward sends chunk j
    of each rank to rank j."""
    out, _, _ = runs
    x = torch.arange(24, dtype=torch.float64).reshape(8, 3) / 7
    want = torch.cat([torch.cat([x[4 * j:4 * j + 4] * (s + 1)
                                 for s in range(2)]) for j in range(2)])
    for r in out["2x1"]:
        assert r["gradcheck"]["ok"]
        assert torch.equal(r["gradcheck"]["value"], want)
