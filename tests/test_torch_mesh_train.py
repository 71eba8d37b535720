"""Training over a (data, model) mesh: the port's ``build_sharded_train_step``
held against JAX's unsharded ``make_train_step`` and the port's unsharded
step, on gloo ranks on the CPU (JAX's own mesh tests fail under jax 0.9.0,
ROADMAP R1, so JAX's unsharded step is the oracle).

Each mesh (2x1, 1x2, 2x2) is spawned once for the module, all three at
once (``repro_torch.launch.mesh.spawn``: a process a rank, one intra-op
thread each), and its ranks run a list of cases (``_rank``); 1x2 and 2x2
restore, last, the checkpoint that 2x1 writes. Meanwhile this process
computes the references. Each parametrised test asserts over one case's
results. The model is the smoke tinyllama-1.1b in fp32 (4 query heads, 2
KV heads: at model 2 a rank holds 2 and 1), through the flash and
rmsnorm autograd ``Function``s (their plain versions on the CPU).

- Step 1 against JAX: the loss (``rtol`` 1e-4, as
  ``test_torch_train.py``) and the gradient reassembled from every rank's
  pieces (``rules.unshard``) within atol 1e-5 / rtol 1e-4; against the
  unsharded port within atol 1e-6 / rtol 1e-5.
- One KV head (HKV does not divide by the model axis: each rank holds
  ``wk``/``wv`` whole and their gradients are summed over "model"), and a
  data-only MoE config (the aux loss and its gradient), against JAX.
- The sharded ``global_norm`` against the unsharded one with the clip
  binding; L1 == L2 == L3 and ``ret_async`` over the mesh.
- ``compress`` against JAX's ``quantize``/``dequantize`` bit for bit, and
  ``compressed_psum_mean`` equal to JAX's arithmetic on the same payloads
  and within JAX's bound (1/254 + 1e-3 of a leaf's max |entry| over the
  ranks), handing the collectives 2 bytes an element at 2 ranks where the
  fp32 mean hands them 4.
- ``stage`` with specs; the checkpoint saved at 2x1 restored onto 1x2,
  2x2 and one device bit for bit; the driver's recovery at 2x1 bit for
  bit; the launcher at ``--data-mesh 2 --device cpu``.
"""
import dataclasses
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (L1_BASE, L2_BYP, L3_NSS,  # noqa: E402
                              LinkageConfig, LinkedStep,
                              build_sharded_train_step, init_train_state)
from repro_torch.data import DataConfig, Pipeline, stage  # noqa: E402
from repro_torch.launch.mesh import mesh_shape, spawn  # noqa: E402
from repro_torch.models import ModelOptions  # noqa: E402
from repro_torch.optim import AdamWConfig, compress  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import (DriverConfig, FailureInjector,  # noqa: E402
                                 train)
from repro_torch.sharding import comm  # noqa: E402
from repro_torch.sharding.rules import gather, shard, unshard  # noqa: E402
from torch_threads import cap_threads  # noqa: E402

cap_threads()

ARCH, MOE = "tinyllama-1.1b", "moonshot-v1-16b-a3b"
MQA = (("n_kv_heads", 1),)
B, S = 4, 16
MESHES = {"2x1": (2, 1), "1x2": (1, 2), "2x2": (2, 2)}
#: the flash and rmsnorm Functions (plain on the CPU), plain scans
KOPTS = ModelOptions(attn_impl="kernel", scan_impl="ref", dtype=torch.float32,
                     fused_norm=True)
LR = 1e-3
OCFG = AdamWConfig(lr=LR, warmup_steps=2, total_steps=50, weight_decay=0.0)
#: a clip that binds (the smoke model's step-1 norm is about 1.3)
CLIP = dataclasses.replace(OCFG, grad_clip=0.25)
#: against JAX (``test_torch_train.py``'s loss tolerance), and against
#: the unsharded port (row-parallel and data-mean sums reorder fp32
#: additions; observed ~1.2e-7)
JAX_LOSS_RTOL, JAX_ATOL, JAX_RTOL = 1e-4, 1e-5, 1e-4
PORT_ATOL, PORT_RTOL = 1e-6, 1e-5
SAVE_STEP = 2


def _cfg(arch=ARCH, overrides=()):
    return dataclasses.replace(get_config(arch).smoke(), **dict(overrides))


def _batch(cfg, step=0, gb=B):
    return Pipeline(cfg, DataConfig(global_batch=gb, seq_len=S)).batch_at(step)


def _state(cfg, seed=0):
    return init_train_state(cfg, OCFG, torch.Generator().manual_seed(seed),
                            "cpu")


# ---------------------------------------------------------------------------
# the cases, run in every rank of a mesh (spawn's entry)
# ---------------------------------------------------------------------------

def _pieces(mesh, cfg, state, ocfg=OCFG, lk=LinkageConfig(level=L1_BASE)):
    fn, sspecs, bspecs = build_sharded_train_step(cfg, KOPTS, ocfg, lk, mesh,
                                                  state, B)
    return fn, shard(state, sspecs, mesh), sspecs, bspecs


def _case_grads(mesh, c):
    """Step 1's gradient pieces and metrics, then the step's metrics."""
    cfg = _cfg(c["arch"], c.get("overrides", ()))
    fn, st, _, bspecs = _pieces(mesh, cfg, c["state"])
    batch = stage(_batch(cfg), "cpu", bspecs, mesh)
    g, m = fn.grads(st.params, batch)
    _, sm = fn(st, batch)
    return {"grads": g, "metrics": {k: float(v) for k, v in m.items()},
            "step": {k: float(v) for k, v in sm.items()}}


def _case_norm(mesh, c):
    """The sharded global norm of step 1's gradient, and one step under a
    binding clip (its grad_norm and the update's pieces)."""
    cfg = _cfg()
    fn, st, sspecs, bspecs = _pieces(mesh, cfg, c["state"], CLIP)
    batch = stage(_batch(cfg), "cpu", bspecs, mesh)
    g, _ = fn.grads(st.params, batch)
    norm = float(adamw.global_norm(g, sspecs.params, mesh))
    new, m = fn(st, batch)
    return {"norm": norm, "grad_norm": float(m["grad_norm"]),
            "params": new.params}


def _run_steps(fn, st, cfg, bspecs, mesh, lk, steps=4):
    k = lk.steps_per_call
    pipe = Pipeline(cfg, DataConfig(global_batch=B, seq_len=S))
    losses = []
    for s in range(0, steps, k):
        raw = pipe.stacked_at(s, k) if lk.level == L3_NSS else pipe.batch_at(s)
        st, m = fn(st, stage(raw, "cpu", bspecs, mesh))
        losses += (m["loss_steps"].tolist() if "loss_steps" in m
                   else [float(m["loss"])])
    return st, losses


def _case_levels(mesh, c):
    """4 steps at L1, L2 and L3 (2 a call); ret_async through LinkedStep."""
    cfg = _cfg()
    out = {}
    for name, lk in (("L1", LinkageConfig(level=L1_BASE)),
                     ("L2", LinkageConfig(level=L2_BYP)),
                     ("L3", LinkageConfig(level=L3_NSS, nss_steps=2))):
        fn, st, _, bspecs = _pieces(mesh, cfg, c["state"], lk=lk)
        st, losses = _run_steps(fn, st, cfg, bspecs, mesh, lk)
        out[name] = {"losses": losses, "params": st.params}
    lk = LinkageConfig(level=L2_BYP, ret_async=True)
    fn, st, _, bspecs = _pieces(mesh, cfg, c["state"], lk=lk)
    linked = LinkedStep(fn=fn, linkage=lk)
    _, m = linked(st, stage(_batch(cfg), "cpu", bspecs, mesh))
    out["ret_async"] = (m, linked.sync(), linked.sync())
    return out


def _case_compress(mesh, c):
    """Each rank's seeded tree through both data-axis means."""
    data = mesh.comm("data")
    rng = np.random.default_rng(100 + data.index)
    grads = {"w": torch.from_numpy(rng.standard_normal((33, 17))
                                   .astype(np.float32)),
             "b": torch.from_numpy((rng.standard_normal(5) * 1e-3)
                                   .astype(np.float32))}
    comm.reset_traffic()
    comp = compress.compressed_psum_mean(grads, data)
    int8 = comm.traffic()
    comm.reset_traffic()
    plain = compress.psum_mean(grads, data)
    return {"local": grads, "compressed": comp, "plain": plain,
            "bytes_int8": int8, "bytes_fp32": comm.traffic()}


def _case_stage(mesh, c):
    out = {}
    for gb in (B, 3):
        cfg = _cfg()
        _, _, _, bspecs = _pieces(mesh, cfg, c["state"])
        if gb != B:
            bspecs = build_sharded_train_step(
                cfg, KOPTS, OCFG, LinkageConfig(level=L1_BASE), mesh,
                c["state"], gb)[2]
        out[gb] = (bspecs, stage(_batch(cfg, 0, gb), "cpu", bspecs, mesh))
    return out


def _case_save(mesh, c):
    """SAVE_STEP steps at L2, then a checkpoint of the pieces (rank 0
    writes the gathered arrays): returns whether the gathered state
    equals the file, bit for bit, and the losses."""
    cfg = _cfg()
    lk = LinkageConfig(level=L2_BYP)
    fn, st, sspecs, bspecs = _pieces(mesh, cfg, c["state"], lk=lk)
    st, losses = _run_steps(fn, st, cfg, bspecs, mesh, lk, SAVE_STEP)
    ckpt.save(c["dir"], SAVE_STEP, st, specs=sspecs, mesh=mesh)
    mesh.world.barrier()
    return {"equal": _equal_to_file(gather(st, sspecs, mesh), c["dir"]),
            "losses": losses}


def _equal_to_file(full, d):
    like = tree.tree_map(torch.empty_like, full)
    got = ckpt.restore(d, SAVE_STEP, like)
    return all(torch.equal(a, b) and a.dtype == b.dtype
               for a, b in zip(tree.leaves(full), tree.leaves(got)))


def _case_restore(mesh, c):
    """The 2x1 checkpoint restored onto this mesh: the gathered pieces
    equal the file bit for bit; then two more steps."""
    cfg = _cfg()
    lk = LinkageConfig(level=L2_BYP)
    fn, st, sspecs, bspecs = _pieces(mesh, cfg, _state(cfg, 9), lk=lk)
    deadline = time.monotonic() + 120
    while ckpt.latest_step(c["dir"]) != SAVE_STEP:     # 2x1 writes it
        assert time.monotonic() < deadline, "no checkpoint from 2x1"
        time.sleep(0.1)
    st = ckpt.restore(c["dir"], SAVE_STEP, st, sspecs, mesh)
    equal = _equal_to_file(gather(st, sspecs, mesh), c["dir"])
    pipe = Pipeline(cfg, DataConfig(global_batch=B, seq_len=S))
    losses = []
    for s in (SAVE_STEP, SAVE_STEP + 1):
        st, m = fn(st, stage(pipe.batch_at(s), "cpu", bspecs, mesh))
        losses.append(float(m["loss"]))
    return {"equal": equal, "step": int(st.step), "losses": losses}


def _case_recovery(mesh, c):
    """The driver at L2 over the mesh, clean and with a failure injected
    at step 3 on every rank (a checkpoint every 2 steps): the final pieces
    equal bit for bit."""
    cfg = _cfg()
    lk = LinkageConfig(level=L2_BYP)
    out = {}
    for name, fail in (("clean", ()), ("failed", (3,))):
        fn, st, sspecs, bspecs = _pieces(mesh, cfg, c["state"], lk=lk)
        d = f"{c['dir']}/{name}"
        rep = train(fn, st, Pipeline(cfg, DataConfig(B, S)), lk,
                    DriverConfig(total_steps=6, ckpt_every=2, ckpt_dir=d),
                    FailureInjector(fail) if fail else None,
                    batch_specs=bspecs, state_specs=sspecs, mesh=mesh)
        out[name] = rep
    a, b = out["clean"], out["failed"]
    return {"equal": all(torch.equal(x, y) for x, y in zip(
        tree.leaves(a.state), tree.leaves(b.state))),
        "restarts": b.restarts, "clean": a.losses, "failed": b.losses,
        "steps": int(b.state.step)}


CASES = {"grads": _case_grads, "norm": _case_norm, "levels": _case_levels,
         "compress": _case_compress, "stage": _case_stage,
         "save": _case_save, "restore": _case_restore,
         "recovery": _case_recovery}


def _rank(mesh, cases):
    return {c["name"]: CASES[c["kind"]](mesh, c) for c in cases}


# ---------------------------------------------------------------------------
# the references and the spawns
# ---------------------------------------------------------------------------

def _jax_state(arch, overrides=()):
    """JAX's init (key 3) and config, and the port's ``TrainState`` of it
    (``train_state_from_jax``)."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as jget
    from repro.core.step import init_train_state as jinit
    from repro.optim import AdamWConfig as JAdam
    from repro_torch.convert import train_state_from_jax
    jcfg = dataclasses.replace(jget(arch).smoke(), **dict(overrides))
    jo = JAdam(lr=LR, warmup_steps=2, total_steps=50, weight_decay=0.0)
    js = jinit(jax.random.PRNGKey(3), jcfg, jo)
    return jcfg, jo, js, train_state_from_jax(jax.tree.map(np.asarray, js),
                                              "cpu")


def _jax_reference(jcfg, jo, js, batch, step=False):
    """JAX's step-1 loss, metrics and gradient (port layout), jitted; with
    ``step``, also the metrics of JAX's ``make_train_step``."""
    import jax
    import jax.numpy as jnp
    from repro.core.step import make_train_step as jmake
    from repro.models import ModelOptions as JOpts
    from repro.models import loss_fn as jloss
    from repro_torch.convert import params_from_jax
    jopts = JOpts(attn_impl="ref", scan_impl="ref", dtype=jnp.float32)
    batch = jax.tree.map(jnp.asarray, batch)
    (loss, m), g = jax.jit(jax.value_and_grad(
        lambda p, b: jloss(p, b, jcfg, jopts), has_aux=True))(js.params,
                                                              batch)
    out = {"loss": float(loss),
           "metrics": {k: float(v) for k, v in m.items()},
           "grads": params_from_jax(jax.tree.map(np.asarray, g), "cpu")}
    if step:
        _, jm = jax.jit(jmake(jcfg, jopts, jo))(js, batch)
        out["step"] = {k: float(v) for k, v in jm.items()}
    return out


def _port_grads(cfg, state, batch):
    from repro_torch.models import loss_fn
    live = [p.detach().requires_grad_(True)
            for p in tree.leaves(state.params)]
    loss, m = loss_fn(tree.unflatten(state.params, live),
                      stage(batch, "cpu"), cfg, KOPTS)
    g = torch.autograd.grad(loss, live, allow_unused=True)
    g = [torch.zeros_like(p) if x is None else x for x, p in zip(g, live)]
    return float(loss.detach()), tree.unflatten(state.params, g)


GRAD_CASES = {"tiny": (ARCH, ()), "mqa": (ARCH, MQA), "moe": (MOE, ())}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{mesh: every rank's results}, and the references: the three meshes
    spawned at once (1x2 and 2x2 restore last, once 2x1 has committed its
    checkpoint), while this process computes JAX's and the port's
    unsharded steps."""
    tmp = tmp_path_factory.mktemp("mesh_train")
    jstates = {k: _jax_state(*v) for k, v in GRAD_CASES.items()}
    base = jstates["tiny"][3]

    def grads(key):
        return dict(name=f"grads/{key}", kind="grads", arch=GRAD_CASES[key][0],
                    overrides=GRAD_CASES[key][1], state=jstates[key][3])
    common = [grads("tiny"), grads("mqa"),
              dict(name="norm", kind="norm", state=base),
              dict(name="levels", kind="levels", state=base)]
    ckdir = str(tmp / "elastic")
    cases = {
        "2x1": common + [
            grads("moe"),
            dict(name="compress", kind="compress"),
            dict(name="stage", kind="stage", state=base),
            dict(name="save", kind="save", state=base, dir=ckdir),
            dict(name="recovery", kind="recovery", state=base,
                 dir=str(tmp / "recovery"))],
        "1x2": common + [dict(name="restore", kind="restore", dir=ckdir)],
        "2x2": common + [dict(name="restore", kind="restore", dir=ckdir),
                         dict(name="stage", kind="stage", state=base)]}
    out, errors = {}, []

    def spawn_one(m):
        try:
            out[m] = spawn(_rank, "{},{}".format(*MESHES[m]), "cpu",
                           (cases[m],), deadline_s=300)
        except Exception as e:       # re-raised in the test thread below
            errors.append(e)

    threads = [threading.Thread(target=spawn_one, args=(m,))
               for m in MESHES]
    for t in threads:
        t.start()
    ref, port = {}, {}
    for key, (arch, over) in GRAD_CASES.items():
        cfg = _cfg(arch, over)
        ref[key] = _jax_reference(*jstates[key][:3], _batch(cfg),
                                  step=key == "tiny")
        port[key] = _port_grads(cfg, jstates[key][3], _batch(cfg))
        ref[key]["state"] = jstates[key][3]
    cfg = _cfg()
    clipped, cm = build_unsharded(cfg, CLIP)(tree.tree_map(torch.clone, base),
                                             stage(_batch(cfg), "cpu"))
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out, {"jax": ref, "port": port, "clipped": (clipped, cm),
                 "dir": ckdir}


def build_unsharded(cfg, ocfg, lk=LinkageConfig(level=L1_BASE)):
    from repro_torch.core import build_train_step
    return build_train_step(cfg, KOPTS, ocfg, lk).fn


def _specs(mesh_name, cfg, state):
    return build_sharded_train_step(
        cfg, KOPTS, OCFG, LinkageConfig(level=L1_BASE),
        mesh_shape(*MESHES[mesh_name]), state, B)[1]


def _assert_close(got, want, atol, rtol, what):
    gl, wl = tree.leaves(got), tree.leaves(want)
    assert len(gl) == len(wl), what
    for i, (g, w) in enumerate(zip(gl, wl)):
        np.testing.assert_allclose(g.numpy(), w.detach().numpy(), atol=atol,
                                   rtol=rtol, err_msg=f"{what} leaf {i}")


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("key", ["tiny", "mqa"])
def test_sharded_step_matches_jax(runs, key, mesh_name):
    """Step 1: the loss on every rank and the reassembled gradient against
    JAX's unsharded step, and against the unsharded port (tighter)."""
    out, ref = runs
    j = ref["jax"][key]
    ranks = out[mesh_name]
    name = f"grads/{key}"
    cfg = _cfg(*GRAD_CASES[key])
    specs = _specs(mesh_name, cfg, j["state"])
    full = unshard([r[name]["grads"] for r in ranks], specs.params,
                   mesh_shape(*MESHES[mesh_name]))
    for r in ranks:
        np.testing.assert_allclose(r[name]["metrics"]["loss"], j["loss"],
                                   rtol=JAX_LOSS_RTOL)
        assert r[name]["metrics"] == ranks[0][name]["metrics"]
        if "step" in j:           # JAX's make_train_step: loss, grad_norm
            for k in ("loss", "grad_norm", "lr"):
                np.testing.assert_allclose(r[name]["step"][k], j["step"][k],
                                           rtol=JAX_RTOL)
    _assert_close(full, j["grads"], JAX_ATOL, JAX_RTOL, f"{name} vs JAX")
    loss, grads = ref["port"][key]
    np.testing.assert_allclose(ranks[0][name]["metrics"]["loss"], loss,
                               rtol=PORT_RTOL)
    _assert_close(full, grads, PORT_ATOL, PORT_RTOL, f"{name} vs port")


def test_unsplit_kv_heads_hold_wk_whole(runs):
    """One KV head at model 2: every rank holds ``wk``/``wv`` whole over
    "model" (FSDP-cut over "data" at 2x2), where JAX's spec
    column-shards them."""
    out, ref = runs
    cfg = _cfg(ARCH, MQA)
    for m in ("1x2", "2x2"):
        specs = _specs(m, cfg, ref["jax"]["mqa"]["state"]).params
        mixer = specs["layers"][0]["mixer"]
        assert "model" not in mixer["wk"] and "model" not in mixer["wv"]
        assert mixer["wq"][1] == "model"
        for r in out[m]:
            g = r["grads/mqa"]["grads"]["layers"][0]["mixer"]
            assert g["wk"].shape[1] == cfg.head_dim


def test_data_only_moe_matches_jax(runs):
    """moonshot's smoke MoE at 2x1: the aux loss (a mean over routing
    groups, as many on each data rank) and the gradient against JAX's."""
    out, ref = runs
    j = ref["jax"]["moe"]
    ranks = out["2x1"]
    cfg = _cfg(MOE)
    full = unshard([r["grads/moe"]["grads"] for r in ranks],
                   _specs("2x1", cfg, j["state"]).params, mesh_shape(2, 1))
    for r in ranks:
        m = r["grads/moe"]["metrics"]
        assert m["moe_aux"] > 0
        np.testing.assert_allclose(m["moe_aux"], j["metrics"]["moe_aux"],
                                   rtol=JAX_LOSS_RTOL)
        np.testing.assert_allclose(m["loss"], j["loss"], rtol=JAX_LOSS_RTOL)
    _assert_close(full, j["grads"], JAX_ATOL, JAX_RTOL, "moe vs JAX")


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_sharded_global_norm_with_binding_clip(runs, mesh_name):
    """The norm of the whole gradient from the pieces (each counted once)
    equals the unsharded norm; under a binding clip the step's grad_norm
    does too, and the clipped update's pieces reassemble to the
    unsharded update within rounding."""
    out, ref = runs
    clipped, cm = ref["clipped"]
    want = float(cm["grad_norm"])
    assert want > CLIP.grad_clip
    cfg = _cfg()
    specs = _specs(mesh_name, cfg, ref["jax"]["tiny"]["state"]).params
    for r in out[mesh_name]:
        np.testing.assert_allclose(r["norm"]["norm"], want, rtol=PORT_RTOL)
        np.testing.assert_allclose(r["norm"]["grad_norm"], want,
                                   rtol=PORT_RTOL)
    full = unshard([r["norm"]["params"] for r in out[mesh_name]], specs,
                   mesh_shape(*MESHES[mesh_name]))
    _assert_close(full, clipped.params, 2 * LR, 0, "clipped update")


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_levels_agree_over_the_mesh(runs, mesh_name):
    """L1 == L2 == L3 (2 microsteps a call) over 4 sharded steps, bit for
    bit; ``LinkedStep``'s ret_async returns None, then the metrics once."""
    out, _ = runs
    for r in out[mesh_name]:
        lv = r["levels"]
        assert lv["L1"]["losses"] == lv["L2"]["losses"] == lv["L3"]["losses"]
        for a, b in zip(tree.leaves(lv["L1"]["params"]),
                        tree.leaves(lv["L3"]["params"])):
            assert torch.equal(a, b)
        m, got, again = lv["ret_async"]
        assert m is None and isinstance(got["loss"], float) and again is None


def test_compress_matches_jax():
    """``quantize`` and ``dequantize`` bit for bit against JAX's,
    including ties (x.5 steps) and the clip."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.optim import compress as jcompress
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal(997).astype(np.float32) * 3,
                        np.float32([0.5, 1.5, -2.5, 200.0, -300.0])])
    scale = np.float32(np.abs(x[:997]).max() / 127.0)
    q = compress.quantize(torch.from_numpy(x), torch.tensor(scale))
    jq = np.asarray(jcompress.quantize(jnp.asarray(x), jnp.float32(scale)))
    assert q.dtype == torch.int8 and np.array_equal(q.numpy(), jq)
    d = compress.dequantize(q, torch.tensor(scale))
    jd = np.asarray(jcompress.dequantize(jnp.asarray(jq), jnp.float32(scale)))
    assert np.array_equal(d.numpy(), jd)
    one = compress.quantize(torch.tensor([0.5, 1.5, 2.5]), torch.tensor(1.0))
    assert one.tolist() == [0, 2, 2]


def test_compressed_psum_mean_within_jax_bound(runs):
    """Over 2 data ranks: the fp32 mean exact, the int8 mean equal to
    JAX's arithmetic on the same payloads (scale from the ranks' max,
    codes summed in fp32) and within JAX's bound; the int8 path hands the
    collectives 2 bytes an element (its codes out, the other rank's in)
    and a scalar max a leaf, the fp32 mean 4 bytes an element."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.optim import compress as jcompress
    out, _ = runs
    ranks = out["2x1"]
    for k in ("w", "b"):
        xs = [r["compress"]["local"][k].numpy() for r in ranks]
        exact = (xs[0] + xs[1]) / np.float32(2)
        gmax = max(np.abs(x).max() for x in xs)
        scale = jnp.maximum(jnp.float32(gmax) / 127.0, 1e-30)
        codes = jnp.stack([jcompress.quantize(jnp.asarray(x), scale)
                           for x in xs])
        want = np.asarray(codes.astype(jnp.float32).sum(axis=0) * scale
                          / 2.0)
        for r in ranks:
            got = r["compress"]["compressed"][k].numpy()
            assert np.array_equal(r["compress"]["plain"][k].numpy(), exact)
            assert np.array_equal(got, want)
            # JAX's bound, against the ranks' max |entry| (the scale's)
            assert np.abs(got - exact).max() <= (1 / 254 + 1e-3) * gmax
    for r in ranks:
        i8, f32 = r["compress"]["bytes_int8"], r["compress"]["bytes_fp32"]
        n = 33 * 17 + 5
        assert f32 == {"all_reduce": 4 * n}
        # each rank's codes once from every rank, and a scalar max a leaf
        assert i8 == {"broadcast": 2 * n, "all_reduce": 2 * 4}


@pytest.mark.parametrize("mesh_name", ["2x1", "2x2"])
def test_stage_with_specs(runs, mesh_name):
    """``stage`` with the step's batch specs: each data rank its rows
    (model ranks the same ones); a batch of 3 over 2 data ranks whole on
    every rank (``batch_spec``'s fallback)."""
    out, _ = runs
    full = _batch(_cfg())
    for rank, r in enumerate(out[mesh_name]):
        specs, got = r["stage"][B]
        assert specs["inputs"][0] == "data"
        di = mesh_shape(*MESHES[mesh_name]).coords_of(rank)["data"]
        for k in ("inputs", "labels"):
            assert np.array_equal(got[k].numpy(), full[k][2 * di:2 * di + 2])
        specs3, got3 = r["stage"][3]
        assert specs3["inputs"][0] is None
        assert np.array_equal(got3["inputs"].numpy(),
                              _batch(_cfg(), 0, 3)["inputs"])


@pytest.mark.parametrize("target", ["1x2", "2x2", "1x1"])
def test_elastic_restore(runs, target):
    """The checkpoint saved at 2x1 after 2 steps (the full arrays, rank 0
    writing) restored onto 1x2, 2x2 and one device: the state gathered
    from the pieces equals the file bit for bit, and training goes on
    (step 2 onwards, finite losses, below step 1's)."""
    out, ref = runs
    saved = out["2x1"][0]["save"]
    assert all(r["save"]["equal"] for r in out["2x1"])
    if target == "1x1":
        cfg = _cfg()
        like = _state(cfg, 9)
        st = ckpt.restore(ref["dir"], SAVE_STEP, like)
        full = ckpt.restore(ref["dir"], SAVE_STEP,
                            tree.tree_map(torch.empty_like, like))
        for a, b in zip(tree.leaves(st), tree.leaves(full)):
            assert torch.equal(a, b)
        assert int(st.step) == SAVE_STEP
        return
    for r in out[target]:
        got = r["restore"]
        assert got["equal"] and got["step"] == SAVE_STEP + 2
        assert all(np.isfinite(got["losses"]))
        assert got["losses"][-1] < saved["losses"][0]


def test_recovery_on_the_mesh_is_exact(runs):
    """The driver at 2x1: a failure at step 3 on every rank restores the
    step-2 checkpoint (rank 0's latest, agreed) and replays; the final
    pieces equal the clean run's bit for bit, and so do the losses."""
    out, _ = runs
    for r in out["2x1"]:
        rec = r["recovery"]
        assert rec["restarts"] == 1 and rec["equal"] and rec["steps"] == 6
        assert rec["failed"] == rec["clean"][:3] + rec["clean"][2:]


def test_launch_train_data_mesh_cpu(tmp_path):
    """``python -m repro_torch.launch.train --data-mesh 2 --device cpu``:
    rank 0's report with the mesh and both ranks, the losses those of the
    one-device launch within fp32 rounding."""
    import json
    from repro_torch.launch import train as launch_train
    reports = {}
    for mesh in ("2", "0"):
        path = str(tmp_path / f"r{mesh}.json")
        assert launch_train.main([
            "--smoke", "--device", "cpu", "--steps", "4", "--global-batch",
            "4", "--seq-len", "16", "--ckpt-every", "2", "--ckpt-dir",
            str(tmp_path / f"ck{mesh}"), "--data-mesh", mesh,
            "--report-json", path]) == 0
        with open(path) as f:
            reports[mesh] = json.load(f)
    rep = reports["2"]
    assert rep["mesh"] == "2x1" and rep["steps"] == 4
    assert [r["rank"] for r in rep["ranks"]] == [0, 1]
    assert all(r["traffic"]["broadcast"] > 0 for r in rep["ranks"])
    np.testing.assert_allclose(rep["losses"], reports["0"]["losses"],
                               rtol=PORT_RTOL)
    assert ckpt.list_steps(str(tmp_path / "ck2")) == [2]
