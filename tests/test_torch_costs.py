"""The port's configuration counts, analytic cost model, sharding plans, head
padding and dry runs against the JAX package's, on the CPU.

Counts, FLOPs and spec trees are compared exactly (pure-Python and
spec-level references: no reference program is lowered); head-padded
prefill and decode against the unpadded model within 1e-4, as the
reference's own test holds them.  The reference's dry-run modules are not
imported here: they set ``XLA_FLAGS`` at import, which would change JAX's
device count for the rest of the process.
"""
import dataclasses
import json
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import base as jbase
from repro.configs import registry as jregistry
from repro.launch import costs as jcosts
from repro.launch import steps as jsteps
from repro.launch.train import client_arch_pool as jax_arch_pool
from repro.sharding import hints as jhints
from repro.sharding import padding as jpadding
from repro.sharding import specs as jspecs
from repro_torch import configs
from repro_torch.configs import ARCHS, ASSIGNED, INPUT_SHAPES, get_arch
from repro_torch.core.flat import FlatIndex
from repro_torch.launch import costs, dryrun, dryrun_fedfa, steps
from repro_torch.launch.train import client_arch_pool
from repro_torch.models import model as model_mod
from repro_torch.models.transformer import abstract_params, param_shapes
from repro_torch.sharding import cohort as csh
from repro_torch.sharding import hints, padding, specs
from repro_torch.sharding.specs import P
from repro_torch.tree import leaves, leaves_with_path, tree_map

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
ARCH_MODULES = ("arctic_480b", "codeqwen1_5_7b", "fedfa_paper",
                "internvl2_76b", "mamba2_130m", "minicpm_2b", "phi35_moe",
                "recurrentgemma_2b", "smollm_135m", "tinyllama_1_1b",
                "whisper_base")
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def _cuts(name):
    return {"full": get_arch(name), "reduced": get_arch(name).reduced()}, \
        {"full": jregistry.get_arch(name),
         "reduced": jregistry.get_arch(name).reduced()}


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cut", ["full", "reduced"])
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_param_counts_match_reference(name, cut):
    port, ref = (c[cut] for c in _cuts(name))
    assert port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()
    assert port.n_repeats_total_layers() == ref.n_repeats_total_layers()


def test_input_shapes_and_assigned_match_reference():
    assert ASSIGNED == jregistry.ASSIGNED
    assert list(INPUT_SHAPES) == list(jbase.INPUT_SHAPES)
    for name, s in INPUT_SHAPES.items():
        assert dataclasses.asdict(s) == dataclasses.asdict(
            jbase.INPUT_SHAPES[name])
    for k in ("TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K"):
        assert dataclasses.asdict(getattr(configs, k)) == \
            dataclasses.asdict(getattr(jbase, k))


@pytest.mark.parametrize("module", ARCH_MODULES)
def test_arch_modules_match_reference(module):
    import importlib
    port = importlib.import_module(f"repro_torch.configs.{module}").CONFIG
    ref = importlib.import_module(f"repro.configs.{module}").CONFIG
    assert port is get_arch(port.name)
    assert port.name == ref.name
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


# ---------------------------------------------------------------------------
# the analytic cost model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ASSIGNED)
def test_flops_match_reference(name):
    """step_flops and forward_flops, with and without a window, for every
    input shape: exactly the reference's."""
    port, ref = get_arch(name), jregistry.get_arch(name)
    for shape_name, shape in INPUT_SHAPES.items():
        jshape = jbase.INPUT_SHAPES[shape_name]
        for window in (None, 4096, 100):
            assert costs.step_flops(port, shape, window=window) == \
                jcosts.step_flops(ref, jshape, window=window)
            assert costs.forward_flops(port, shape, window=window) == \
                jcosts.forward_flops(ref, jshape, window=window)
    assert costs.step_flops(port, configs.TRAIN_4K) > 0


@pytest.mark.parametrize("name", ASSIGNED)
def test_macs_per_client_match_reference(name):
    """The table-2 width / depth pools of every regime at B 4, S 32 (the
    reference's table script) and at one larger batch."""
    port, ref = get_arch(name), jregistry.get_arch(name)
    for mode in ("depth", "width", "both"):
        pool, jpool = client_arch_pool(port, mode), jax_arch_pool(ref, mode)
        for a, ja in zip(pool, jpool):
            assert (a.width_mult, a.section_depths) == \
                (ja.width_mult, ja.section_depths)
            for B, S in ((4, 32), (16, 512)):
                assert costs.macs_per_client(
                    port, a.width_mult, a.section_depths, B=B, S=S) == \
                    jcosts.macs_per_client(ref, ja.width_mult,
                                           ja.section_depths, B=B, S=S)


# ---------------------------------------------------------------------------
# shapes without allocation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(ARCHS))
def test_abstract_params_match_init_params(name):
    """The meta tree's shapes and dtypes are init_params' (at reduced()),
    and its shapes param_shapes' at full size."""
    cfg = get_arch(name).reduced()
    if name == "fedfa-paper-transformer":      # its cut does not run
        cfg = get_arch(name)
    real = model_mod.init_params(cfg, torch.Generator().manual_seed(0),
                                 torch.bfloat16)
    meta = abstract_params(cfg)
    got = [(p, t.shape, t.dtype, t.device.type)
           for p, t in leaves_with_path(meta)]
    want = [(p, t.shape, t.dtype, "meta") for p, t in leaves_with_path(real)]
    assert got == want
    full = get_arch(name)
    shapes = dict(leaves_with_path(param_shapes(full),
                                   is_leaf=lambda x: isinstance(x, tuple)
                                   and all(isinstance(d, int) for d in x)))
    assert {p: tuple(t.shape) for p, t in
            leaves_with_path(abstract_params(full))} == shapes


@pytest.mark.parametrize("name", ASSIGNED)
def test_input_and_cache_specs_match_reference(name):
    port, ref = get_arch(name), jregistry.get_arch(name)
    for shape_name, shape in INPUT_SHAPES.items():
        jshape = jbase.INPUT_SHAPES[shape_name]
        got = steps.input_specs(port, shape)
        want = jsteps.input_specs(ref, jshape)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == want[k].shape
            assert str(got[k].dtype).split(".")[1] == str(want[k].dtype)
        if shape.kind != "decode":
            continue
        for window in (None, 4096):
            caches = steps.decode_cache_specs(port, shape, window=window)
            jcaches = jsteps.decode_cache_specs(ref, jshape, window=window)
            got = list(leaves_with_path(caches))
            want = jax.tree_util.tree_leaves(jcaches)
            assert len(got) == len(want)
            for (path, t), w in zip(got, want):
                assert t.device.type == "meta"
                assert tuple(t.shape) == w.shape, path
                if w.ndim > 1:         # pos: int64 in the port
                    assert str(t.dtype).split(".")[1] == str(w.dtype), path


# ---------------------------------------------------------------------------
# sharding specs
# ---------------------------------------------------------------------------

def _same_specs(port, ref, path=()):
    """Equal leaf for leaf: the same dict keys, tuple lengths and cache
    records, each port P equal to the reference's PartitionSpec as a
    tuple."""
    if isinstance(ref, JP):
        assert isinstance(port, P) and tuple(port) == tuple(ref), path
    elif isinstance(ref, dict):
        assert isinstance(port, dict) and sorted(port) == sorted(ref), path
        for k in ref:
            _same_specs(port[k], ref[k], path + (k,))
    elif isinstance(ref, tuple):
        assert isinstance(port, tuple) and not isinstance(port, P), path
        assert len(port) == len(ref), path
        if hasattr(ref, "_fields"):
            assert type(port).__name__ == type(ref).__name__, path
            assert port._fields == ref._fields, path
        for i, (a, b) in enumerate(zip(port, ref)):
            _same_specs(a, b, path + (i,))
    else:
        assert port == ref, path


def _sds(tree):
    """A tree of shapes (tuples of ints) or tensors as the reference's
    ShapeDtypeStruct tree."""
    if isinstance(tree, dict):
        return {k: _sds(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return jax.ShapeDtypeStruct(tuple(tree.shape), jnp.float32)
    if all(isinstance(d, int) for d in tree):
        return jax.ShapeDtypeStruct(tree, jnp.float32)
    return tuple(_sds(v) for v in tree)


def _fake_mesh(sizes):
    """What the reference's sanitize_specs reads of a mesh."""
    return types.SimpleNamespace(axis_names=tuple(sizes),
                                 devices=np.empty(tuple(sizes.values())))


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_spec_trees_match_reference(name):
    """param_specs at fsdp on / off / the config's, one pod and two;
    opt_state_specs with and without v; cache_specs and batch_specs; each
    port tree also covers its parameter / cache tree leaf for leaf."""
    port, ref = get_arch(name), jregistry.get_arch(name)
    n_leaves = len(leaves(abstract_params(port)))
    for multi_pod in (False, True):
        for fsdp in (None, False, True):
            ps = specs.param_specs(port, fsdp=fsdp, multi_pod=multi_pod)
            jps = jspecs.param_specs(ref, fsdp=fsdp, multi_pod=multi_pod)
            _same_specs(ps, jps)
            count = []
            specs.map_specs(lambda s, n: count.append(n), ps,
                            abstract_params(port))
            assert len(count) == n_leaves
            for has_v in (False, True):
                _same_specs(specs.opt_state_specs(port, ps, has_v),
                            jspecs.opt_state_specs(ref, jps, has_v))
        _same_specs(specs.cache_specs(port, multi_pod),
                    jspecs.cache_specs(ref, multi_pod))
        if name != "fedfa-paper-transformer":
            caches = steps.decode_cache_specs(port, configs.DECODE_32K)
            count = []
            specs.map_specs(lambda s, n: count.append(n),
                            specs.cache_specs(port, multi_pod), caches)
            assert len(count) == len(leaves(caches))
        for kind in ("train", "prefill", "decode"):
            _same_specs(specs.batch_specs(port, multi_pod, kind),
                        jspecs.batch_specs(ref, multi_pod, kind))
        assert specs.batch_axes(multi_pod) == jspecs.batch_axes(multi_pod)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_sanitize_specs_match_reference(name, mesh):
    """Sanitized against each production mesh: the parameters (both FSDP
    layouts, both pods' specs: a two-pod spec on the one-pod mesh names an
    absent axis) and the decode caches."""
    sizes = MESHES[mesh]
    port, ref = get_arch(name), jregistry.get_arch(name)
    shapes = param_shapes(port)
    for multi_pod in (False, True):
        for fsdp in (False, True):
            got = specs.sanitize_specs(
                specs.param_specs(port, fsdp=fsdp, multi_pod=multi_pod),
                shapes, sizes)
            want = jspecs.sanitize_specs(
                jspecs.param_specs(ref, fsdp=fsdp, multi_pod=multi_pod),
                _sds(shapes), _fake_mesh(sizes))
            _same_specs(got, want)
        if name == "fedfa-paper-transformer":
            continue
        got = specs.sanitize_specs(
            specs.cache_specs(port, multi_pod),
            steps.decode_cache_specs(port, configs.DECODE_32K), sizes)
        want = jspecs.sanitize_specs(
            jspecs.cache_specs(ref, multi_pod),
            jsteps.decode_cache_specs(ref, jbase.DECODE_32K),
            _fake_mesh(sizes))
        _same_specs(got, want)


def test_sanitize_specs_missing_axis_falls_back_to_replication():
    """The reference's own case, on a 1 x 1 map: an axis the mesh lacks
    replicates the dimension; known axes stay."""
    sizes = {"data": 1, "model": 1}
    spec = {"fsdp": P(("pod", "data"), None), "tp": P(None, "model"),
            "pod_only": P("pod")}
    shapes = {"fsdp": (4, 4), "tp": (4, 4), "pod_only": (4,)}
    out = specs.sanitize_specs(spec, shapes, sizes)
    assert out == {"fsdp": P(None, None), "tp": P(None, "model"),
                   "pod_only": P(None)}
    jout = jspecs.sanitize_specs(
        {k: JP(*v) for k, v in spec.items()}, _sds(shapes),
        _fake_mesh(sizes))
    _same_specs(out, jout)
    assert specs.shard_count(P(("pod", "data"), "model"),
                             MESHES["2x16x16"]) == 512


def test_hints_policy_matches_reference():
    for axes in (("data",), ("pod", "data")):
        _same_specs(hints.megatron_policy(axes),
                    jhints.megatron_policy(axes))
    assert hints.current_policy() is None
    pol = hints.megatron_policy()
    with hints.policy(pol):
        assert hints.current_policy() is pol
        x = torch.ones(2, 3)
        assert hints.constrain(x, "residual") is x
    assert hints.current_policy() is None


# ---------------------------------------------------------------------------
# head padding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(ARCHS))
def test_pad_heads_match_reference(name):
    for cut in ("full", "reduced"):
        port, ref = (c[cut] for c in _cuts(name))
        for axis in (16, 8):
            cfg2, m = padding.pad_heads_for_serving(port, axis)
            jcfg2, jm = jpadding.pad_heads_for_serving(ref, axis)
            assert dataclasses.asdict(cfg2) == dataclasses.asdict(jcfg2)
            assert (m is None) == (jm is None)
            if m is None:
                assert cfg2 is port
                continue
            for f in dataclasses.fields(m):
                a, b = getattr(m, f.name), getattr(jm, f.name)
                assert (a is None) == (b is None), f.name
                if a is not None:
                    np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _place(small, big):
    """The small tree's values at the front of the zero-padded big tree."""
    def put(s, b):
        z = torch.zeros_like(b)
        z[tuple(slice(0, d) for d in s.shape)] = s
        return z
    return tree_map(put, small, big)


def test_head_padding_preserves_decode():
    """Padded prefill and 4 decode steps give the unpadded logits within
    1e-4 (smollm-135m at reduced(): 4 heads over 2, padded to 8 kv)."""
    cfg = get_arch("smollm-135m").reduced()
    p = model_mod.init_params(cfg, torch.Generator().manual_seed(0))
    cfg2, masks = padding.pad_heads_for_serving(cfg, axis=8)
    assert cfg2.n_kv_heads == 8 and masks is not None
    p2 = _place(p, model_mod.init_params(cfg2,
                                         torch.Generator().manual_seed(1)))
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 12)))
    lg1, c1, _ = model_mod.prefill(p, cfg, {"tokens": toks[:, :8]},
                                   capacity=16, cache_dtype=torch.float32)
    lg2, c2, _ = model_mod.prefill(p2, cfg2, {"tokens": toks[:, :8]},
                                   capacity=16, masks=masks,
                                   cache_dtype=torch.float32)
    assert float((lg1 - lg2).abs().max()) < 1e-4
    for i in range(8, 12):
        lg1, c1 = model_mod.decode_step(p, cfg, toks[:, i:i + 1], c1)
        lg2, c2 = model_mod.decode_step(p2, cfg2, toks[:, i:i + 1], c2,
                                        masks=masks)
        assert float((lg1 - lg2).abs().max()) < 1e-4


def test_head_padding_noop_when_divisible():
    cfg = get_arch("whisper-base").reduced()          # K = 2
    cfg2, masks = padding.pad_heads_for_serving(cfg, axis=cfg.n_kv_heads)
    assert masks is None and cfg2 is cfg
    full = get_arch("codeqwen1.5-7b")                 # K = 32
    cfg3, masks3 = padding.pad_heads_for_serving(full, axis=16)
    assert masks3 is None and cfg3 is full


# ---------------------------------------------------------------------------
# the dry runs
# ---------------------------------------------------------------------------

def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(tree))


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("name", ["minicpm-2b", "whisper-base",
                                  "internvl2-76b"])
def test_lower_combo_bytes_on_one_rank(name, shape):
    """On a 1 x 1 map every spec shards over one rank: the argument bytes
    are the parameters' (of the head-padded model while serving), the
    optimizer state's and the step number's (train), the caches'
    (decode), the batch's and the encoder output's."""
    rec = dryrun.lower_combo(name, shape, axis_sizes={"data": 1,
                                                      "model": 1})
    cfg, s = get_arch(name), INPUT_SHAPES[shape]
    if s.name == "long_500k" and cfg.long_context_mode == "skip":
        assert rec["status"] == "skipped"
        return
    assert rec["status"] == "ok" and rec["mesh"] == "1x1"
    window = 4096 if s.name == "long_500k" else None
    params = abstract_params(cfg)
    want = _nbytes(params) + _nbytes(steps.input_specs(cfg, s))
    if s.kind == "train":
        n = sum(t.numel() for t in leaves(params))
        mdt = 2 if cfg.momentum_dtype == "bfloat16" else 4
        want += n * mdt + (4 * n if cfg.optimizer == "adamw" else 0) + 4 + 4
    elif s.kind == "decode":
        want += _nbytes(steps.decode_cache_specs(cfg, s, window=window))
        if cfg.encoder is not None:
            want += s.global_batch * cfg.encoder.n_frames * cfg.d_model * 2
    assert rec["memory"]["argument_bytes"] == want
    assert rec["roofline"]["chips"] == 1
    assert rec["cost"]["flops"] == costs.step_flops(cfg, s, window=window)


def test_dryrun_cli_writes_reference_keys(tmp_path):
    """One combo through the CLI on the production mesh: the reference's
    keys, every XLA-only field null with its reason, the H100's
    constants, the plan smaller per rank than on one rank, and no XLA
    environment touched."""
    dryrun.main(["--arch", "smollm-135m", "--shape", "train_4k", "--out",
                 str(tmp_path)])
    rec = json.loads((tmp_path / "smollm-135m_train_4k_16x16.json")
                     .read_text())
    assert set(rec) >= {"arch", "shape", "variant", "mesh", "lower_compile_s",
                        "memory", "cost", "collectives", "hlo_bytes",
                        "roofline", "status"}
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "peak_bytes"}
    assert set(rec["roofline"]) == {"chips", "compute_s", "memory_s",
                                    "collective_s", "model_flops",
                                    "hlo_flops_global", "useful_flops_ratio",
                                    "bottleneck"}
    for key, reason in rec["null_reasons"].items():
        node = rec
        for part in key.split("."):
            node = node[part]
        assert node is None and reason, key
    for key in ("lower_compile_s", "collectives", "hlo_bytes"):
        assert key in rec["null_reasons"]
    assert rec["hardware"]["card"].startswith("NVIDIA H100")
    assert rec["hardware"]["peak_flops"] == 989e12
    assert rec["roofline"]["chips"] == 256 and rec["mesh"] == "16x16"
    one = dryrun.lower_combo("smollm-135m", "train_4k",
                             axis_sizes={"data": 1, "model": 1})
    assert 0 < rec["memory"]["argument_bytes"] \
        < one["memory"]["argument_bytes"] / 10
    assert rec["cost"]["flops"] * 256 == one["cost"]["flops"]
    cfg = get_arch("smollm-135m")
    mf = dryrun.model_flops(cfg, configs.TRAIN_4K)
    assert rec["roofline"]["useful_flops_ratio"] == \
        mf / costs.step_flops(cfg, configs.TRAIN_4K)
    assert rec["policy"]["heads"] == ["data", None, "model", None]
    text = (REPO / "src" / "repro_torch" / "launch" / "dryrun.py").read_text()
    assert "XLA_FLAGS" not in text and "environ" not in text
    serve = dryrun.lower_combo("smollm-135m", "decode_32k")
    assert serve["head_padding"] is True
    skip = dryrun.lower_combo("whisper-base", "long_500k")
    assert skip["status"] == "skipped"


@pytest.mark.parametrize("mesh_shape,clients", [((2, 2), 3), ((4, 1), 16)])
def test_dryrun_fedfa_bytes_match_cohort_layout(mesh_shape, clients):
    """A rank's bytes are its sharding.cohort slices of the padded cohort
    (FlatIndex's n_padded), the whole bf16 global and its token rows; the
    FLOPs the reference's macs_per_client over the clients."""
    cfg = get_arch("smollm-135m").reduced()
    L, B, S = 2, 4, 32
    plan = dryrun_fedfa.plan_round(cfg, clients, L, B, S, mesh_shape)
    mesh = dryrun_fedfa.PlanMesh(mesh_shape)
    real = model_mod.init_params(cfg, torch.Generator().manual_seed(0),
                                 torch.bfloat16)
    index = FlatIndex(real, pad_to=csh.pad_unit(mesh))
    m = clients + csh.pad_rows(clients, mesh)
    rows = csh.data_rows(mesh, m)
    cols = csh.model_cols(mesh, index.n_padded)
    assert (plan["n"], plan["n_padded"]) == (index.n, index.n_padded)
    assert plan["cohort_bytes"] == \
        (rows.stop - rows.start) * (cols.stop - cols.start) * 4
    assert plan["global_bytes"] == _nbytes(real)
    assert plan["token_bytes"] == (rows.stop - rows.start) * L * B * S * 4
    ref = jregistry.get_arch("smollm-135m").reduced()
    pool = dryrun_fedfa.client_pool(cfg)
    want = sum(L * 2 * jcosts.macs_per_client(
        ref, pool[i % 4].width_mult, pool[i % 4].section_depths, B=B, S=S)
        for i in range(clients))
    assert plan["flops_global"] == want


def test_dryrun_fedfa_cli(tmp_path):
    rec = dryrun_fedfa.main(["--out", str(tmp_path)])
    assert json.loads((tmp_path / "fedfa_round_smollm-135m_16x16.json")
                      .read_text()) == rec
    assert set(rec) >= {"arch", "workload", "mesh", "clients", "agg_engine",
                        "lower_compile_s", "memory", "cost", "collectives",
                        "status"}
    assert rec["lower_compile_s"] is None and rec["collectives"] is None
    assert rec["memory"]["temp_bytes"] is None
    assert set(rec["null_reasons"]) >= {"lower_compile_s", "collectives",
                                        "memory.temp_bytes"}
    # 16 clients over 16 data shards: one row a rank, N/16 columns
    assert rec["layout"]["rows"] == 1
    assert rec["layout"]["cols"] * 16 == rec["layout"]["n_padded"]
    assert rec["memory"]["bytes_per_rank"] == (
        rec["memory"]["argument_bytes"] + rec["memory"]["cohort_bytes"])
