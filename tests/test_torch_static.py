"""The PyTorch port (``repro_torch``) against the JAX reference (``repro``):
its own copies of the numpy-only modules, the client runtimes (masks,
gates, graft maps), the flat layout, the optimizer and the import rule."""
import ast
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import fl_round_fixture

from repro.configs import get_arch as jax_get_arch
from repro.core import flat as jflat
from repro.core import masking as jmasking
from repro.data import partition as jpartition
from repro.data import pipeline as jpipeline
from repro.data import synthetic as jsynthetic
from repro.launch.train import client_arch_pool as jax_arch_pool
from repro.models import masks as jmasks
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro.configs.base import RGLRUConfig as JRGLRUConfig
from repro_torch.configs import (ARCHS, ArchConfig, MAMBA2_130M, RGLRUConfig,
                                 SMOLLM_135M, get_arch)
from repro_torch.core import flat, masking
from repro_torch.data import partition, pipeline, synthetic
from repro_torch.launch.train import client_arch_pool, fl_config
from repro_torch.models import masks
from repro_torch.models.model import _to_torch, params_from_numpy
from repro_torch.optim import make_schedule, sgd_momentum
from repro_torch.tree import leaves_with_path

torch.set_num_threads(2)

JCFG, JPARAMS = fl_round_fixture()
CFG = fl_config("smollm-135m", "cls", 10, full_size=False)
REPO = pathlib.Path(__file__).resolve().parents[1]


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


# the dense, moe, hybrid, audio and vlm registry entries copied besides
# smollm-135m
_DENSE_COPIES = ("minicpm-2b", "tinyllama-1.1b", "codeqwen1.5-7b",
                 "fedfa-paper-transformer", "phi3.5-moe-42b-a6.6b",
                 "arctic-480b", "recurrentgemma-2b", "whisper-base",
                 "internvl2-76b")


def _rglru_equal(a: RGLRUConfig, b, d_model: int) -> None:
    """The port's own RGLRUConfig against the reference's."""
    assert [x.name for x in dataclasses.fields(a)] == \
        [x.name for x in dataclasses.fields(b)]
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.d_rnn(d_model) == b.d_rnn(d_model)


def _cfg_fields_equal(port: ArchConfig, ref) -> None:
    for f in dataclasses.fields(port):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if f.name == "ssm" and a is not None:     # the port's own SSMConfig
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
            assert a.d_inner(port.d_model) == b.d_inner(ref.d_model)
            assert a.n_heads(port.d_model) == b.n_heads(ref.d_model)
        elif f.name == "moe" and a is not None:   # the port's own MoEConfig
            assert [x.name for x in dataclasses.fields(a)] == \
                [x.name for x in dataclasses.fields(b)]
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
        elif f.name == "rglru" and a is not None:
            _rglru_equal(a, b, port.d_model)
        elif f.name in ("encoder", "vision") and a is not None:  # own copies
            assert [x.name for x in dataclasses.fields(a)] == \
                [x.name for x in dataclasses.fields(b)]
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
        else:
            assert a == b, f.name
    assert port.padded_vocab == ref.padded_vocab
    assert port.head_dim == ref.head_dim
    assert port.stages() == ref.stages()
    assert port.n_repeats == ref.n_repeats
    assert port.section_bounds() == ref.section_bounds()


@pytest.mark.parametrize("which", ["full", "reduced", "fixture",
                                   "mamba2-full", "mamba2-reduced",
                                   "rglru-defaults"]
                         + [f"{a}-{cut}" for a in _DENSE_COPIES
                            for cut in ("full", "reduced")])
def test_config_copy_matches_reference(which):
    if which == "rglru-defaults":
        _rglru_equal(RGLRUConfig(), JRGLRUConfig(), 2560)
        return
    if which.rsplit("-", 1)[0] in _DENSE_COPIES:
        arch, cut = which.rsplit("-", 1)
        port, ref = get_arch(arch), jax_get_arch(arch)
        if cut == "reduced":
            port, ref = port.reduced(), ref.reduced()
        _cfg_fields_equal(port, ref)
        return
    ref = jax_get_arch("smollm-135m")
    mref = jax_get_arch("mamba2-130m")
    port = {"full": SMOLLM_135M, "reduced": SMOLLM_135M.reduced(),
            "fixture": CFG, "mamba2-full": MAMBA2_130M,
            "mamba2-reduced": MAMBA2_130M.reduced()}[which]
    ref = {"full": ref, "reduced": ref.reduced(), "fixture": JCFG,
           "mamba2-full": mref, "mamba2-reduced": mref.reduced()}[which]
    _cfg_fields_equal(port, ref)


def test_every_registry_arch_resolves():
    from repro.configs.registry import ARCHS as JARCHS
    assert sorted(ARCHS) == sorted(JARCHS) and len(ARCHS) == 11
    for name in JARCHS:
        assert get_arch(name).family == jax_get_arch(name).family
    assert get_arch("smollm-135m") is SMOLLM_135M
    assert get_arch("mamba2-130m") is MAMBA2_130M
    assert get_arch("internvl2-76b").family == "vlm"
    with pytest.raises(NotImplementedError, match="not in the registry"):
        get_arch("no-such-arch")


def test_population_copy_matches_reference():
    assert (REPO / "src" / "repro_torch" / "sim" / "population.py").read_text() \
        == (REPO / "src" / "repro" / "sim" / "population.py").read_text()


def test_synthetic_copy_matches_reference():
    for port, ref in [(synthetic, jsynthetic)]:
        np.testing.assert_array_equal(port.make_class_profiles(5, 40, seed=3),
                                      ref.make_class_profiles(5, 40, seed=3))
        a, b = port.classification(5, 40, 7, 9, seed=2), \
            ref.classification(5, 40, 7, 9, seed=2)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(port.lm_stream(30, 3, 6, seed=1),
                                      ref.lm_stream(30, 3, 6, seed=1))
        for x, y in zip(port.make_bigram_lm(20, 2, seed=4),
                        ref.make_bigram_lm(20, 2, seed=4)):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("noniid", [False, True])
def test_partition_and_pipeline_copies_match_reference(noniid):
    fn = "noniid_partition" if noniid else "iid_partition"
    parts = getattr(partition, fn)(6, 10, seed=5)
    jparts = getattr(jpartition, fn)(6, 10, seed=5)
    for p, q in zip(parts, jparts):
        np.testing.assert_array_equal(p["classes"], q["classes"])
        assert p["n_data"] == q["n_data"]
        np.testing.assert_array_equal(partition.client_class_mask(p, 64),
                                      jpartition.client_class_mask(q, 64))
    prof = synthetic.make_class_profiles(10, 64, seed=0)
    a = pipeline.round_batches_cls(parts, [1, 4], 10, 64, local_steps=2,
                                   batch=3, seq_len=5, profiles=prof, seed=7)
    b = jpipeline.round_batches_cls(jparts, [1, 4], 10, 64, local_steps=2,
                                    batch=3, seq_len=5, profiles=prof, seed=7)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    T = synthetic.make_bigram_lm(32, 2, seed=1)
    np.testing.assert_array_equal(
        pipeline.round_batches_lm([0, 1], 32, local_steps=2, batch=2,
                                  seq_len=4, domain_T=T, client_domains=[0, 1],
                                  seed=3)["tokens"],
        jpipeline.round_batches_lm([0, 1], 32, local_steps=2, batch=2,
                                   seq_len=4, domain_T=T,
                                   client_domains=[0, 1], seed=3)["tokens"])
    for k, v in pipeline.eval_batch_cls(10, 64, 6, 5, prof, seed=2).items():
        np.testing.assert_array_equal(
            v, jpipeline.eval_batch_cls(10, 64, 6, 5, prof, seed=2)[k])


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


# the modules of the configuration counts, the cost model, the sharding
# plans and the dry runs, every one held to the import rule below
NEW_MODULES = (
    [f"configs/{m}.py" for m in (
        "arctic_480b", "codeqwen1_5_7b", "fedfa_paper", "internvl2_76b",
        "mamba2_130m", "minicpm_2b", "phi35_moe", "recurrentgemma_2b",
        "smollm_135m", "tinyllama_1_1b", "whisper_base")]
    + ["launch/costs.py", "launch/dryrun.py", "launch/dryrun_fedfa.py",
       "sharding/specs.py", "sharding/hints.py", "sharding/padding.py"]
    + [f"analysis/{m}.py" for m in (
        "__init__", "__main__", "blame", "comms", "contracts", "dispatch",
        "lint", "memory", "passes", "programs")])


def test_cost_model_imports_no_torch():
    """launch/costs.py is pure Python: it imports only the configs at
    module level (macs_per_client takes masks.width_spec when called)."""
    tree = ast.parse((REPO / "src" / "repro_torch" / "launch" / "costs.py")
                     .read_text())
    top = [m for node in tree.body if isinstance(node, (ast.Import,
                                                        ast.ImportFrom))
           for m in _imports(node)]
    assert top == ["__future__", "typing", "repro_torch.configs.base"]


def test_port_imports_neither_jax_nor_reference():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    for pkg in ("sim", "checkpoint", "examples", "sharding"):
        assert REPO / "src" / "repro_torch" / pkg / "__init__.py" in files
    port = REPO / "src" / "repro_torch"
    for mod in NEW_MODULES:
        assert port / mod in files, mod
    for path in files:
        text = path.read_text()
        for mod in _imports(ast.parse(text)):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)
        assert "import_module" not in text and "__import__" not in text, path


@pytest.mark.parametrize("mode", ["width", "depth", "both"])
def test_client_runtimes_match_reference(mode):
    archs, jarchs = client_arch_pool(CFG, mode), jax_arch_pool(JCFG, mode)
    assert [(a.width_mult, a.section_depths) for a in archs] == \
        [(a.width_mult, a.section_depths) for a in jarchs]
    for a, ja in zip(archs, jarchs):
        mk, jmk = a.masks(CFG), ja.masks(JCFG)
        for f in ("d_model", "heads", "kv_heads", "d_ff"):
            np.testing.assert_array_equal(_np(getattr(mk, f)),
                                          _np(getattr(jmk, f)))
        np.testing.assert_array_equal(_np(a.gates(CFG)), _np(ja.gates(JCFG)))
        np.testing.assert_array_equal(_np(a.graft(CFG)), _np(ja.graft(JCFG)))
        assert masks.width_spec(CFG, a.width_mult).__dict__ == {
            k: v for k, v in jmasks.width_spec(JCFG, a.width_mult).__dict__
            .items() if k in ("d_model", "n_heads", "n_kv_heads", "d_ff",
                              "n_experts", "ssm_heads", "d_rnn")}
    st = masks.stack_masks([a.masks(CFG) for a in archs])
    jst = jmasks.stack_masks([a.masks(JCFG) for a in jarchs])
    np.testing.assert_array_equal(_np(st.d_ff), _np(jst.d_ff))
    np.testing.assert_array_equal(_np(st.client(1).heads), _np(jst.heads[1]))


def test_runtime_validation_matches_reference():
    for bad in (0.0, 1.5):
        with pytest.raises(ValueError):
            masks.width_spec(CFG, bad)
    with pytest.raises(ValueError):
        masks.depth_gates(CFG, (1,))
    with pytest.raises(ValueError):
        masks.depth_gates(CFG, (0, 1))


def _port_params(dtype=np.float32):
    return params_from_numpy(
        jax.tree.map(lambda x: np.asarray(x).astype(dtype), JPARAMS), CFG,
        "cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flatten_is_bitwise_equal(dtype):
    jparams = jax.tree.map(lambda x: x.astype(dtype), JPARAMS)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), CFG, "cpu")
    index, jindex = flat.FlatIndex(params), jflat.get_index(jparams)
    assert (index.n, index.n_segments) == (jindex.n, jindex.n_segments)
    assert [(s.path, s.shape, s.offset, s.lead, s.rest, s.seg0)
            for s in index.leaves] == \
        [(tuple(getattr(k, "key", getattr(k, "idx", None)) for k in s.path),
          s.shape, s.offset, s.lead, s.rest, s.seg0) for s in jindex.leaves]
    np.testing.assert_array_equal(index.row_of, jindex.row_of)
    np.testing.assert_array_equal(index.seg_row, jindex.seg_row)
    np.testing.assert_array_equal(index.seg_stage0, jindex.seg_stage0)
    buf = flat.flatten(index, params)
    jbuf = np.asarray(jflat.flatten(jindex, jparams))
    np.testing.assert_array_equal(buf.numpy().view(np.uint32),
                                  jbuf.view(np.uint32))
    back = flat.unflatten(index, buf)
    for (p, x), (_, y) in zip(leaves_with_path(back),
                              leaves_with_path(params)):
        assert x.dtype == y.dtype and torch.equal(x, y), p
    stacked = jax.tree.map(lambda x: jnp.stack([x, 2 * x]), jparams)
    port_stacked = jax.tree.map(lambda x: _to_torch(np.asarray(x)), stacked)
    np.testing.assert_array_equal(
        flat.flatten_stacked(index, port_stacked).numpy(),
        np.asarray(jflat.flatten_stacked(jindex, stacked)))


def test_segment_maps_match_reference():
    index = flat.FlatIndex(_port_params())
    for a, b in zip(flat._segment_maps(index),
                    jflat._segment_maps(jflat.get_index(JPARAMS))):
        np.testing.assert_array_equal(a, b)


def test_params_loader_rejects_wrong_trees():
    tree = jax.tree.map(np.asarray, JPARAMS)
    bad = dict(tree, embed=tree["embed"][:, :8])
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(bad, CFG, "cpu")
    with pytest.raises(ValueError, match="mismatch"):
        params_from_numpy({k: v for k, v in tree.items() if k != "lm_head"},
                          CFG, "cpu")


@pytest.mark.parametrize("mode", ["width", "both"])
def test_density_fraction_and_mask_apply_match_reference(mode):
    params = _port_params()
    index, jindex = flat.FlatIndex(params), jflat.get_index(JPARAMS)
    for a, ja in zip(client_arch_pool(CFG, mode), jax_arch_pool(JCFG, mode)):
        d, f = flat._density_and_fraction(CFG, index, a.masks(CFG))
        jd, jf = jflat._density_and_fraction(JCFG, jindex, ja.masks(JCFG))
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
        out = masking.apply_mask_tree(
            params, masking.axis_mask_tree(CFG, a.masks(CFG)))
        jout = jmasking.apply_mask_tree(
            JPARAMS, jmasking.axis_mask_tree(JCFG, ja.masks(JCFG)))
        np.testing.assert_array_equal(
            flat.flatten(index, out).numpy(),
            np.asarray(jflat.flatten(jindex, jout)))


def test_sgd_step_matches_reference():
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 4), "b": ((5,), (2, 2))}
    mk = lambda: jax.tree.map(
        lambda s: rng.normal(size=s).astype(np.float32), shapes,
        is_leaf=lambda s: isinstance(s, tuple) and isinstance(s[0], int))
    p, g, m = mk(), mk(), mk()
    tt = lambda tr: jax.tree.map(torch.from_numpy, tr)
    new_p, st = sgd_momentum(tt(p), tt(g), {"step": 0, "m": tt(m)}, 0.05,
                             momentum=0.9, weight_decay=1e-4)
    jp, jst = jopt.sgd_momentum(p, g, {"step": jnp.zeros((), jnp.int32),
                                       "m": m}, 0.05, momentum=0.9,
                                weight_decay=1e-4)
    for x, y in zip(jax.tree.leaves(jax.tree.map(np.asarray, (jp, jst["m"]))),
                    [t.numpy() for _, t in leaves_with_path((new_p, st["m"]))]):
        np.testing.assert_allclose(y, x, rtol=1e-6, atol=1e-7)
    assert st["step"] == 1


@pytest.mark.parametrize("name", ["constant", "step", "cosine", "wsd"])
def test_schedules_match_reference(name):
    port = make_schedule(name, 0.1, 100, warmup=10)
    ref = jsched.make_schedule(name, 0.1, 100, warmup=10)
    for step in (0, 5, 10, 50, 80, 99):
        np.testing.assert_allclose(float(port(step)), float(ref(step)),
                                   rtol=1e-6)
