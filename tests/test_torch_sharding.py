"""The port's partition rules (``repro_torch.sharding.rules``) against
JAX's (``repro.sharding.rules``), and the placement helpers.

For every registered config (the eleven of ``list_archs(include_extras=
True)``) on meshes 1x2, 2x1, 2x2 and 1x4 (JAX's over the 4 virtual host
devices ``tests/conftest.py`` forces; the port's a shape), the decisions
(``tp_report``) and every spec tree agree: the parameters' (training and
serving), the slot, paged, swap-block and swap-chain caches', the batch's.
The port keeps one dict per layer where JAX stacks the layers of a block
pattern position, so JAX's spec of ``blocks[g]`` less its leading
(stacked) dimension is the spec of port layer ``i`` with ``i % G == g``.
Also ``unshard(shard(p)) == p`` for every config's smoke parameters over
every rank, the mesh-spec parsing, the launcher's ``--scale`` widths
against JAX's ``_setup``, the local widths of the MoE, Mamba and RWKV
layers at model 2 (the pieces each rank holds of them), and the refusal
that needs no rank process (L0 with a mesh). Parameters
and caches are shapes only (``jax.eval_shape``, the port on the CPU at
smoke size): the rules read names and shapes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import list_archs
from repro.launch.mesh import make_host_mesh
from repro.models import init_params as jinit_params
from repro.serve.cache import init_slot_cache as jinit_slot_cache
from repro.serve.paging import init_paged_cache as jinit_paged_cache
from repro.sharding.rules import ArchSharding as JArchSharding

from repro_torch.configs import get_config
from repro_torch.configs.base import ATTN
from repro_torch.launch.mesh import (make_production_mesh, mesh_device_count,
                                     mesh_shape, parse_mesh_spec)
from repro_torch.models import init_params
from repro_torch.serve import init_paged_cache, init_slot_cache
from repro_torch.sharding.comm import AxisComm
from repro_torch.sharding.placement import (_port_specs, check_mesh,
                                            local_config, tensor_parallel)
from repro_torch.sharding.rules import (ArchSharding, host_to_mesh, shard,
                                        unshard)
from torch_threads import cap_threads  # noqa: E402

cap_threads()

ARCHS = list_archs(include_extras=True)
MESHES = {"1x2": (1, 2), "2x1": (2, 1), "2x2": (2, 2), "1x4": (1, 4)}
N_SLOTS, MAX_LEN, NUM_BLOCKS, BS = 4, 24, 6, 8


def _pageable(cfg) -> bool:
    return all(s.mixer == ATTN for s in cfg.block_pattern)


def _spec(p) -> tuple:
    return tuple(p)


def _leaves_with_path(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)) and not (
            isinstance(tree, tuple) and all(
                d is None or isinstance(d, (str, tuple)) for d in tree)):
        for i, x in enumerate(tree):
            yield from _leaves_with_path(x, path + (i,))
    else:
        yield path, tree


def _port_layer_specs(port_layers, jax_blocks, n_groups):
    """JAX's stacked block specs as the port's per-layer specs."""
    want = [jax.tree.map(lambda s: _spec(s)[1:], jax_blocks[i % n_groups],
                         is_leaf=lambda x: isinstance(x, jax.sharding
                                                      .PartitionSpec))
            for i in range(len(port_layers))]
    return want


def _jspecs(tree):
    return jax.tree.map(_spec, tree, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))


@pytest.fixture(scope="module")
def shapes():
    """Per arch: (jax param shapes, port params (CPU smoke), jax and port
    slot caches, jax and port paged caches (pageable configs))."""
    out = {}
    for arch in ARCHS:
        jcfg = jget_config(arch).smoke()
        tcfg = get_config(arch).smoke()
        jp = jax.eval_shape(lambda: jinit_params(jax.random.PRNGKey(0),
                                                 jcfg))
        tp = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
        js = jax.eval_shape(lambda: jinit_slot_cache(jcfg, N_SLOTS, MAX_LEN,
                                                     jnp.float32))
        ts = init_slot_cache(tcfg, N_SLOTS, MAX_LEN, torch.float32, "cpu")
        paged = {}
        if _pageable(tcfg):
            for kvd in ("bf16", "int8"):
                paged[kvd] = (
                    jax.eval_shape(lambda: jinit_paged_cache(
                        jcfg, NUM_BLOCKS, BS, N_SLOTS, jnp.float32, kvd)),
                    init_paged_cache(tcfg, NUM_BLOCKS, BS, N_SLOTS,
                                     torch.float32, "cpu", kv_dtype=kvd))
        out[arch] = (jp, tp, js, ts, paged)
    return out


def _shardings(arch, mesh_name):
    d, m = MESHES[mesh_name]
    return (JArchSharding(jget_config(arch), make_host_mesh(d, m)),
            ArchSharding(get_config(arch), mesh_shape(d, m)))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_report_matches_jax(arch, mesh_name):
    jsh, tsh = _shardings(arch, mesh_name)
    assert tsh.tp_report() == jsh.tp_report()
    assert tsh.tp_proj == jsh.tp_proj and tsh.tp_dmodel == jsh.tp_dmodel
    for b in (1, 2, 3, 4, 8, 16):
        assert tsh.batch_spec(b) == _spec(jsh.batch_spec(b)), b
        assert ({k: v for k, v in tsh.train_batch_specs(b).items()}
                == {k: _spec(v) for k, v in jsh.train_batch_specs(b).items()})
    fits = (10 * 2 ** 30, 2 ** 30)
    assert ([tsh.serving_replication_fits(f) for f in fits]
            == [jsh.serving_replication_fits(f) for f in fits])
    assert ([_spec(s) for s in jsh.serve_chunk_operand_specs(True)]
            == list(tsh.serve_chunk_operand_specs(True)))
    assert len(tsh.serve_verify_operand_specs(False)) == 5


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("serving", [False, True], ids=["train", "serve"])
def test_param_specs_match_jax(arch, mesh_name, serving, shapes):
    jp, tp, *_ = shapes[arch]
    jsh, tsh = _shardings(arch, mesh_name)
    if serving:
        js, ts = jsh.serve_param_specs(jp), tsh.serve_param_specs(tp)
    else:
        js, ts = jsh.param_specs(jp), tsh.param_specs(tp)
    G = len(get_config(arch).block_pattern)
    want = _jspecs(js)
    want["layers"] = _port_layer_specs(ts["layers"], js["blocks"], G)
    del want["blocks"]
    assert ts == want


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_jax(arch, mesh_name, shapes):
    """Slot, paged (bf16 and int8 pools), swap-block and swap-chain."""
    _, _, js, ts, paged = shapes[arch]
    jsh, tsh = _shardings(arch, mesh_name)
    G = len(get_config(arch).block_pattern)
    want = _port_layer_specs(ts, jsh.serve_slot_cache_specs(js, N_SLOTS), G)
    assert tsh.serve_slot_cache_specs(ts, N_SLOTS) == want
    for kvd, (jpc, tpc) in paged.items():
        want = _port_layer_specs(tpc, jsh.serve_paged_cache_specs(jpc), G)
        assert tsh.serve_paged_cache_specs(tpc) == want, kvd
        # the host tier keeps JAX's per-group (L, ...) layout: equal as is
        assert (tsh.serve_swap_block_specs(tpc)
                == _jspecs(jsh.serve_swap_block_specs(jpc))), kvd
        assert (tsh.serve_swap_chain_specs(tpc)
                == _jspecs(jsh.serve_swap_chain_specs(jpc))), kvd


@pytest.mark.parametrize("batch", [1, 2, 4])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "h2o-danube-1.8b",
                                  "jamba-v0.1-52b", "rwkv6-7b",
                                  "llama-3.2-vision-11b"])
def test_decode_cache_specs_match_jax(arch, batch):
    """``cache_specs`` (the uniform decode cache, time axis sharded where
    the batch or the KV heads leave an axis idle) on the 2x2 mesh."""
    from repro.models import cache_spec
    from repro_torch.models.transformer import init_cache
    jcfg, tcfg = jget_config(arch).smoke(), get_config(arch).smoke()
    jsh, tsh = _shardings(arch, "2x2")
    jc = cache_spec(jcfg, batch, MAX_LEN, jnp.float32)
    tc = init_cache(tcfg, batch, MAX_LEN, torch.float32, "cpu")
    want = _port_layer_specs(tc, jsh.cache_specs(jc, batch),
                             len(tcfg.block_pattern))
    assert tsh.cache_specs(tc, batch) == want


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_unshard_of_shard_is_identity(arch, mesh_name, shapes):
    """Every rank's pieces (serving and FSDP specs) put back together are
    the parameters, bit for bit, and each piece has the local shape."""
    _, params, *_ = shapes[arch]
    d, m = MESHES[mesh_name]
    mesh = mesh_shape(d, m)
    tsh = ArchSharding(get_config(arch), mesh)
    for specs in (tsh.serve_param_specs(params), tsh.param_specs(params)):
        pieces = [shard(params, specs, mesh.at(r)) for r in range(d * m)]
        back = unshard(pieces, specs, mesh)
        flat = list(_leaves_with_path(params))
        got = dict(_leaves_with_path(back))
        assert len(got) == len(flat)
        for path, leaf in flat:
            assert torch.equal(got[path], leaf), path
    # host_to_mesh without specs places whole; with them, this rank's piece
    specs = tsh.serve_param_specs(params)
    name = "lm_head" if "lm_head" in params else "embed"
    host = {name: params[name].numpy()}
    assert torch.equal(host_to_mesh(host)[name], params[name])
    last = mesh.at(d * m - 1)
    assert torch.equal(host_to_mesh(host, {name: specs[name]}, last)[name],
                       shard(params, specs, last)[name])


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen2-7b",
                                  "mistral-large-123b"])
@pytest.mark.parametrize("model", [2, 4])
def test_local_config_widths(arch, model):
    """The local widths each model shard computes at: heads and d_ff
    divided where the rules split them, the head dim unchanged."""
    cfg = get_config(arch)
    tsh = ArchSharding(cfg, mesh_shape(1, model))
    loc = local_config(cfg, tsh)
    assert loc.head_dim == cfg.head_dim
    assert loc.n_heads * (model if tsh.tp_heads else 1) == cfg.n_heads
    assert loc.d_ff * (model if tsh.tp_ff else 1) == cfg.d_ff
    kv_split = tsh.tp_heads and tsh.tp_kv
    assert loc.n_kv_heads * (model if kv_split else 1) == cfg.n_kv_heads
    if arch == "tinyllama-1.1b" and model == 2:   # the H100 check's shapes
        assert (loc.n_heads, loc.n_kv_heads, loc.d_ff) == (16, 2, 2816)


def test_mesh_spec_parsing_and_shapes():
    assert parse_mesh_spec("") is None and parse_mesh_spec("1,1") is None
    assert parse_mesh_spec(" 2, 1") == (2, 1)
    assert mesh_device_count("2,2") == 4 and mesh_device_count(None) == 1
    for bad in ("2", "0,2", "1,2,3"):
        with pytest.raises(ValueError):
            parse_mesh_spec(bad)
    prod = make_production_mesh(multi_pod=True)
    assert prod.axis_names == ("pod", "data", "model")
    assert prod.shape == {"pod": 2, "data": 16, "model": 16}
    mesh = mesh_shape(2, 2)
    assert [mesh.coords_of(r) for r in range(4)] == [
        {"data": 0, "model": 0}, {"data": 0, "model": 1},
        {"data": 1, "model": 0}, {"data": 1, "model": 1}]
    assert mesh.at(3).rank == 3 and mesh.describe() == "2x2"
    assert mesh.agree([5, 7]) == [5, 7]        # no live world: the identity


@pytest.mark.parametrize("scale", [0.5, 1.5, 2.0])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "rwkv6-7b",
                                  "jamba-v0.1-52b"])
def test_launcher_scale_widths_match_jax(arch, scale, monkeypatch):
    """``--scale`` widens the smoke model exactly as JAX's ``_setup`` (its
    parameter init stubbed out: the widths are the point)."""
    import repro.models
    from repro.launch.serve import _setup as jsetup
    from repro_torch.launch.serve import _setup
    monkeypatch.setattr(repro.models, "init_params", lambda *a, **k: None)
    jcfg = jsetup(arch, "base", scale=scale)[0]
    tcfg = _setup(arch, "base", scale=scale, device="cpu")[0]
    for field in ("d_model", "d_ff", "head_dim", "n_heads", "n_kv_heads",
                  "vocab_size", "num_blocks"):
        assert getattr(tcfg, field) == getattr(jcfg, field), field


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "jamba-v0.1-52b",
                                  "rwkv6-7b", "mixtral-8x7b"])
def test_unported_layers_at_model_axis_raise(arch):
    """MoE, Mamba and RWKV layers at a model axis > 1: ``check_mesh``
    accepts 1x2 (and 2x1), and each rank's local widths are its half of
    the experts, of Mamba's inner width and of the RWKV heads, which the
    serving pieces hold (``in_proj`` its channels of both halves)."""
    cfg = get_config(arch).smoke()
    check_mesh(cfg, mesh_shape(1, 2))
    check_mesh(cfg, mesh_shape(2, 1))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    mesh = mesh_shape(1, 2)
    sh = ArchSharding(cfg, mesh)
    specs = _port_specs(sh.serve_param_specs(params), sh)
    for m in range(2):
        tp = tensor_parallel(cfg, sh, AxisComm(size=2, index=m))
        local = shard(params, specs, mesh.at(m))
        for full, mine in zip(params["layers"], local["layers"]):
            mixer, mlp = mine["mixer"], mine["mlp"]
            if "router" in mlp:
                E = cfg.moe.num_experts
                assert tuple(tp.experts) == (m * E // 2, (m + 1) * E // 2)
                assert torch.equal(mlp["wi"], full["mlp"]["wi"][
                    tp.experts[0]:tp.experts[1]])
                assert torch.equal(mlp["router"], full["mlp"]["router"])
            if "in_proj" in mixer:
                di = cfg.mamba.expand * cfg.d_model
                lo, hi = tp.di
                assert (lo, hi) == (m * di // 2, (m + 1) * di // 2)
                w = full["mixer"]["in_proj"]
                assert torch.equal(mixer["in_proj"], torch.cat(
                    [w[:, lo:hi], w[:, di + lo:di + hi]], 1))
                assert mixer["conv_w"].shape[1] == hi - lo
            if "u" in mixer:
                nh = cfg.d_model // cfg.rwkv_head_dim
                lo, hi = tp.rwkv
                assert (lo, hi) == (m * nh // 2, (m + 1) * nh // 2)
                assert torch.equal(mixer["u"], full["mixer"]["u"][lo:hi])
                hd = cfg.rwkv_head_dim
                assert mixer["w_bias"].shape[0] == (hi - lo) * hd
                assert torch.equal(mlp["wr"], full["mlp"]["wr"])


def test_mesh_requires_jitted_linkage():
    """L0 with a mesh raises JAX's ``ValueError``, before any collective."""
    from repro_torch.core import preset
    from repro_torch.models import ModelOptions
    from repro_torch.serve import ServeEngine
    cfg = get_config("tinyllama-1.1b").smoke()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="jitted linkage"):
        ServeEngine(cfg, params, ModelOptions(attn_impl="ref",
                                              dtype=torch.float32),
                    preset("linux"), n_slots=1, max_len=16,
                    mesh=mesh_shape(1, 2))
