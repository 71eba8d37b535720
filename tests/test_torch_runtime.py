"""The port's fault tolerance, checkpoints, co-processes, data pipeline and
training launcher on the CPU, modelled on ``tests/test_runtime.py``; the
pipeline and the checkpoint layout are also held against the JAX
package's, bit for bit."""
import json
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (L2_BYP, L3_NSS, AsyncCheckpointer,  # noqa: E402
                              LinkageConfig, PrefetchWorker,
                              build_train_step, init_train_state)
from repro_torch.data import DataConfig, Pipeline, stage  # noqa: E402
from repro_torch.models import ModelOptions  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.runtime import (DriverConfig, FailureInjector,  # noqa: E402
                                 train)
from torch_threads import cap_threads  # noqa: E402

cap_threads()

CFG = get_config("tinyllama-1.1b").smoke()
OPTS = ModelOptions(attn_impl="ref", scan_impl="ref", dtype=torch.float32)
OCFG = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=100)


@pytest.fixture
def ckpt_dir(tmp_path):
    return str(tmp_path / "ckpt")


def _train(ckpt_dir, linkage, injector=None, total=24, opts=OPTS):
    state = init_train_state(CFG, OCFG, torch.Generator().manual_seed(5),
                             "cpu")
    step = build_train_step(CFG, opts, OCFG, linkage)
    pipe = Pipeline(CFG, DataConfig(global_batch=4, seq_len=32))
    dcfg = DriverConfig(total_steps=total, ckpt_every=6, ckpt_dir=ckpt_dir)
    return train(step.fn, state, pipe, linkage, dcfg, injector=injector)


def test_loss_decreases(ckpt_dir):
    rep = _train(ckpt_dir, LinkageConfig(level=L2_BYP), total=30)
    assert rep.steps_run == 30 and len(rep.losses) == 30
    assert rep.losses[-1] < rep.losses[0]


@pytest.mark.parametrize("shortcut", [False, True])
def test_injected_failure_recovers_exactly(ckpt_dir, shortcut):
    """Checkpoint/restart + deterministic stream replay == the run that
    never failed, bit for bit: the failed run's losses are the clean
    run's through step 12, then the replay from the step-12 checkpoint
    (steps 12-23), equal as floats. With the shortcut (the flash and
    rmsnorm autograd Functions) too."""
    lk = LinkageConfig(level=L2_BYP, shortcut=shortcut)
    opts = lk.model_options(OPTS) if shortcut else OPTS
    opts = ModelOptions(**{**opts.__dict__, "scan_impl": "ref"})
    clean = _train(ckpt_dir + "_clean", lk, opts=opts)
    failed = _train(ckpt_dir, lk, injector=FailureInjector(fail_at=(13,)),
                    opts=opts)
    assert failed.restarts == 1 and clean.restarts == 0
    assert failed.losses == clean.losses[:13] + clean.losses[12:]
    # steps 6 and 12, 12 again in the replay, then 18 (keep_ckpts 3)
    assert ckpt.list_steps(ckpt_dir) == [6, 12, 18]


def test_exhausted_restart_budget_raises(ckpt_dir):
    class AlwaysFail(FailureInjector):
        def maybe_fail(self, step):
            if step >= 7:
                raise RuntimeError("persistent failure")

    with pytest.raises(RuntimeError, match="persistent"):
        _train(ckpt_dir, LinkageConfig(level=L2_BYP), injector=AlwaysFail())


def test_failure_before_any_checkpoint_raises(ckpt_dir):
    with pytest.raises(RuntimeError, match="injected"):
        _train(ckpt_dir, LinkageConfig(level=L2_BYP),
               injector=FailureInjector(fail_at=(3,)))


def test_nss_driver(ckpt_dir):
    """L3: 4 steps a call over stacked batches; the losses match L2's at
    the calls' last steps, and the microsteps' losses every step's (within
    1e-6)."""
    rep = _train(ckpt_dir, LinkageConfig(level=L3_NSS, nss_steps=4), total=24)
    assert rep.steps_run == 24 and len(rep.losses) == 6
    assert rep.losses[-1] < rep.losses[0]
    l2 = _train(ckpt_dir + "_l2", LinkageConfig(level=L2_BYP), total=24)
    np.testing.assert_allclose(rep.losses, l2.losses[3::4], rtol=1e-6)
    # every microstep's loss, read with its call's ("loss_steps")
    np.testing.assert_allclose(rep.step_losses, l2.losses, rtol=1e-6)


def test_ret_async_driver_syncs_every_n_calls(ckpt_dir):
    """ret_async: the driver reads the metrics every ``sync_every`` calls
    and, at the end, the last call's if unread; the losses it read are
    L2's (equal as floats)."""
    lk = LinkageConfig(level=L2_BYP, ret_async=True, sync_every=4)
    rep = _train(ckpt_dir, lk, total=14)
    l2 = _train(ckpt_dir + "_l2", LinkageConfig(level=L2_BYP), total=14)
    assert rep.losses == [l2.losses[3], l2.losses[7], l2.losses[11],
                          l2.losses[13]]
    assert rep.step_losses == rep.losses
    assert rep.final_metrics["loss"] == l2.losses[13]
    rep = _train(ckpt_dir + "_12", lk, total=12)
    assert rep.losses == [l2.losses[3], l2.losses[7], l2.losses[11]]


# ---------------------------------------------------------------------------
# checkpoint module
# ---------------------------------------------------------------------------

def _state():
    return {"a": torch.ones(3, 4, dtype=torch.bfloat16) * 1.5,
            "b": (torch.arange(5, dtype=torch.int32),
                  {"c": torch.zeros(2),
                   "d": torch.tensor(7, dtype=torch.int32)})}


def test_checkpoint_roundtrip_bf16(tmp_path):
    state = _state()
    d = str(tmp_path)
    ckpt.save(d, 7, state, extra={"note": "x"})
    assert ckpt.latest_step(d) == 7
    like = tree.tree_map(torch.empty_like, state)
    restored = ckpt.restore(d, 7, like)
    for a, b in zip(tree.leaves(state), tree.leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with open(os.path.join(d, "step_00000007", "meta.json")) as f:
        meta = json.load(f)
    assert meta["dtypes"]["leaf_0"] == "bfloat16" and meta["extra"] == {
        "note": "x"}


def test_checkpoint_layout_matches_jax(tmp_path):
    """The on-disk layout is JAX's: a checkpoint saved by the JAX package
    restores in the port (bf16 as uint16 bits, dicts in sorted key
    order) and one saved by the port restores in JAX, bit for bit."""
    from repro import checkpoint as jckpt
    jstate = {"a": jnp.ones((3, 4), jnp.bfloat16) * 1.5,
              "b": (jnp.arange(5, dtype=jnp.int32),
                    {"c": jnp.zeros((2,), jnp.float32),
                     "d": jnp.asarray(7, jnp.int32)})}
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.save(jd, 3, jstate)
    got = ckpt.restore(jd, 3, tree.tree_map(torch.empty_like, _state()))
    for a, b in zip(tree.leaves(got), tree.leaves(_state())):
        assert torch.equal(a, b)
    ckpt.save(td, 4, _state())
    like = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                        jstate)
    back = jckpt.restore(td, 4, like)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


def test_uncommitted_checkpoint_ignored(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 3, {"x": torch.ones(2)})
    # a crash mid-save: a directory without COMMIT
    os.makedirs(os.path.join(d, "step_00000009"))
    assert ckpt.latest_step(d) == 3
    with pytest.raises(FileNotFoundError):
        ckpt.restore(d, 9, {"x": torch.ones(2)})


def test_prune_keeps_latest(tmp_path):
    d = str(tmp_path)
    for s in (1, 2, 3, 4, 5):
        ckpt.save(d, s, {"x": torch.ones(1) * s})
    ckpt.prune(d, keep=2)
    assert ckpt.list_steps(d) == [4, 5]
    assert float(ckpt.restore(d, 4, {"x": torch.zeros(1)})["x"]) == 4.0


def test_restore_refuses_another_structure(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 1, {"x": torch.ones(2)})
    with pytest.raises(ValueError):
        ckpt.restore(d, 1, {"x": torch.ones(2), "y": torch.ones(1)})


# ---------------------------------------------------------------------------
# co-processes
# ---------------------------------------------------------------------------

def test_async_checkpointer_runs_off_thread():
    seen = []
    ev = threading.Event()

    def save_fn(state, step):
        seen.append((threading.current_thread().name, step,
                     state["x"].device.type))
        ev.set()

    ac = AsyncCheckpointer(save_fn)
    ac.submit({"x": torch.ones(3)}, 5)
    assert ev.wait(5.0)
    ac.wait()
    ac.close()
    assert seen and seen[0][1] == 5 and seen[0][2] == "cpu"
    assert seen[0][0] != threading.main_thread().name


def test_async_checkpointer_surfaces_errors():
    def bad(state, step):
        raise IOError("disk full")

    ac = AsyncCheckpointer(bad)
    ac.submit({"x": torch.ones(1)}, 1)
    with pytest.raises(IOError):
        ac.close()


def test_prefetch_worker_order_and_close():
    it = iter(range(10))
    w = PrefetchWorker(it, put_fn=lambda x: x * 2, depth=3)
    got = [next(w) for _ in range(5)]
    assert got == [0, 2, 4, 6, 8]
    w.close()
    assert list(PrefetchWorker(iter(range(3)), put_fn=lambda x: x)) == [0, 1,
                                                                        2]


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["tinyllama-1.1b", "musicgen-medium",
                                  "llama-3.2-vision-11b"])
def test_pipeline_matches_jax_bit_for_bit(name):
    """``batch_at`` and ``stacked_at`` equal JAX's for one seed, array for
    array (tokens, labels, the musicgen frames, the vision context)."""
    from repro.configs import get_config as jget
    from repro.data import DataConfig as JData, Pipeline as JPipe
    d = dict(global_batch=3, seq_len=16, seed=99)
    tp = Pipeline(get_config(name).smoke(), DataConfig(**d))
    jp = JPipe(jget(name).smoke(), JData(**d))
    for got, want in ((tp.batch_at(12), jp.batch_at(12)),
                      (tp.stacked_at(4, 3), jp.stacked_at(4, 3))):
        assert sorted(got) == sorted(want)
        for k in got:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_pipeline_deterministic_per_step_and_stages():
    d = DataConfig(global_batch=4, seq_len=16, seed=99)
    p1, p2 = Pipeline(CFG, d), Pipeline(CFG, d)
    np.testing.assert_array_equal(p1.batch_at(12)["inputs"],
                                  p2.batch_at(12)["inputs"])
    assert not np.array_equal(p1.batch_at(12)["inputs"],
                              p1.batch_at(13)["inputs"])
    st = p1.stacked_at(4, 3)
    for i in range(3):
        np.testing.assert_array_equal(st["inputs"][i],
                                      p1.batch_at(4 + i)["inputs"])
    b = stage(p1.batch_at(0), "cpu")
    assert b["inputs"].dtype == torch.int32 and b["labels"].shape == (4, 16)
    assert int(b["inputs"].max()) < p1.vocab
    it = p1.iter_from(5)
    np.testing.assert_array_equal(next(it)["labels"],
                                  p1.batch_at(5)["labels"])


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launch_train_main_end_to_end(tmp_path):
    """``launch/train.main`` at smoke size on the CPU: nss_shortcut (4
    steps a call, the metrics read every call), a checkpoint inside the
    run; the report's keys and a falling loss."""
    from repro_torch.launch import train as launch_train
    report = str(tmp_path / "r.json")
    rc = launch_train.main([
        "--smoke", "--device", "cpu", "--preset", "nss_shortcut",
        "--steps", "8", "--global-batch", "4", "--seq-len", "32",
        "--lr", "3e-3", "--sync-every", "1", "--ckpt-every", "4",
        "--ckpt-dir", str(tmp_path / "ck"), "--report-json", report])
    assert rc == 0
    with open(report) as f:
        rep = json.load(f)
    assert rep["steps"] == 8 and rep["restarts"] == 0
    assert rep["device"] == "cpu" and rep["peak_mem_gb"] is None
    assert rep["losses"][-1] < rep["losses"][0]
    assert ckpt.list_steps(str(tmp_path / "ck")) == [4]


def test_launch_train_refuses_mesh_and_missing_gpu(tmp_path):
    """``--data-mesh 3`` on the CPU over a global batch of 4, which does
    not divide: every rank trains the whole batch (``batch_spec``'s
    fallback), and the losses are the one-device launch's. Without a GPU
    the default device raises, with a mesh before any rank starts."""
    from repro_torch.launch import train as launch_train
    reports = {}
    for mesh in ("3", "0"):
        path = str(tmp_path / f"r{mesh}.json")
        launch_train.main(["--smoke", "--device", "cpu", "--data-mesh", mesh,
                           "--steps", "2", "--global-batch", "4",
                           "--seq-len", "16", "--ckpt-dir",
                           str(tmp_path / f"ck{mesh}"), "--report-json",
                           path])
        with open(path) as f:
            reports[mesh] = json.load(f)
    assert reports["3"]["mesh"] == "3x1" and len(reports["3"]["ranks"]) == 3
    np.testing.assert_allclose(reports["3"]["losses"],
                               reports["0"]["losses"], rtol=1e-5)
    if not torch.cuda.is_available():
        for mesh in ("0", "2"):
            with pytest.raises(RuntimeError, match="cuda"):
                launch_train.main(["--smoke", "--steps", "1", "--data-mesh",
                                   mesh, "--ckpt-dir", str(tmp_path)])
