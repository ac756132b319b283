"""Block families found by name: a family the benchmark does not have joins
as new files alone (here a toy sparse-expert block written to a directory
of its own), nothing outside ``bench/reference/blocks/`` branches on a
kind or family, and the program's configuration is built with every
nested sub-configuration."""
import ast
import dataclasses
import importlib
import json
import math
import sys

import numpy as np
import pytest
import torch

from bench import traffic as tr
from bench import yardstick as ys
from bench.entries import common
from bench.reference import blocks
from bench.reference import fl as ref_fl
from bench.reference import masks as mk
from bench.reference import model as md
from bench.reference.config import ModelConfig
from conftest import ROOT
from repro_torch.configs.registry import ARCHS

# Norm, then a top-k FFN over a prefix of the experts: a toy of the
# port's ``models/moe.py`` without capacity, with its load-balance loss
TOY = '''
import torch
import torch.nn.functional as F

from bench.reference import model as md


def _moe(cfg):
    return cfg.extra["moe"]


def flex(cfg, w):
    E, k = _moe(cfg)["n_experts"], _moe(cfg)["top_k"]
    return {"experts": (E, max(k, int(round(w * E))))}


def shapes(cfg, r):
    D, E, Fe = cfg.d_model, _moe(cfg)["n_experts"], _moe(cfg)["d_ff_expert"]
    return {("ln", "scale"): (r, D), ("moe", "router"): (r, D, E),
            ("moe", "w_in"): (r, E, D, Fe), ("moe", "w_out"): (r, E, Fe, D)}


def init_rule(leaf, shape):
    if leaf[-1] == "scale":
        return "fill", 0.0
    return "normal", md.fan_in_std(shape)


def axes(cfg, m):
    dm, ex = m["d_model"], m["experts"]
    return {("ln", "scale"): (dm,), ("moe", "router"): (dm, ex),
            ("moe", "w_in"): (ex, dm, None), ("moe", "w_out"): (ex, None, dm)}


def forward(p, x, cfg, m, gate):
    E, k = _moe(cfg)["n_experts"], _moe(cfg)["top_k"]
    h = md.rms_norm(x, p[("ln", "scale")], m["d_model"], cfg.norm_eps)
    logits = torch.where(m["experts"] > 0, h @ p[("moe", "router")],
                         torch.full((), -1e30))
    probs = torch.softmax(logits, dim=-1)
    top = torch.topk(probs, k, dim=-1)
    chosen = torch.zeros_like(probs).scatter(-1, top.indices, top.values)
    hidden = F.silu(torch.einsum("bsd,edf->bsef", h, p[("moe", "w_in")]))
    y = torch.einsum("bse,bsef,efd->bsd", chosen, hidden,
                     p[("moe", "w_out")])
    share = torch.mean((chosen > 0).to(torch.float32), dim=(0, 1))
    aux = _moe(cfg)["aux"] * E * torch.sum(torch.mean(probs, dim=(0, 1))
                                           * share)
    return x + gate * y * m["d_model"], gate * aux


def flops(cfg, sizes, B, S):
    D, E = sizes["d_model"], sizes["experts"]
    k, Fe = _moe(cfg)["top_k"], _moe(cfg)["d_ff_expert"]
    return 2 * B * S * D * E + k * 2 * 2 * B * S * D * Fe
'''

MODEL = {"name": "toy-moe", "family": "toy-moe", "n_layers": 8,
         "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "d_head": 16,
         "d_ff": 128, "vocab_size": 256, "n_sections": 2,
         "layer_pattern": ["attn", "moe"], "blocks": {"moe": "toy_moe"},
         "moe": {"n_experts": 2, "top_k": 1, "d_ff_expert": 32,
                 "aux": 0.01}}
POOL = [[0.25, 0.5], [0.5, 1.0], [1.0, 1.0]]


@pytest.fixture
def toy(tmp_path, monkeypatch):
    """The toy's block module on the blocks' search path, from a
    directory outside the repository; its configuration."""
    (tmp_path / "toy_moe.py").write_text(TOY)
    monkeypatch.setattr(blocks, "__path__",
                        list(blocks.__path__) + [str(tmp_path)])
    importlib.invalidate_caches()
    yield ModelConfig.from_json(MODEL)
    sys.modules.pop(f"{blocks.__name__}.toy_moe", None)


def _members(cfg, seed=5):
    return tr.population(cfg, {"clients": 6, "arch_pool": POOL,
                               "n_data": [100, 250]}, seed)


def test_toy_family_runs_the_reference(toy):
    cfg = toy
    assert not (ROOT / "bench" / "reference" / "blocks" / "toy_moe.py").exists()
    shapes = md.param_shapes(cfg)
    assert shapes[("stages", 0, 1, "moe", "w_in")] == (4, 2, 64, 32)
    assert shapes[("stages", 0, 0, "attn", "wq")] == (4, 64, 64)
    g = md.init_flat(cfg, 11, "cpu")
    params = md.unflatten(cfg, g)
    assert torch.all(params[("stages", 0, 1, "ln", "scale")] == 0)
    assert float(params[("stages", 0, 1, "moe", "router")].std()) == \
        pytest.approx(1 / 8, rel=0.1)

    # both experts (the full width), the second repeat gated off
    client = ref_fl.Client(cfg, 1.0, (1, 2), 100, "cpu")
    tokens = torch.as_tensor(tr.lm_tokens(cfg.vocab_size, np.zeros((1, 1),
                                                                   int),
                                          2, 2, 16, 3)[0, 0])
    p = mk.apply_masks(params, client.axes)
    logits, aux = md.forward(p, cfg, tokens[0], client.masks, client.gates)
    assert logits.shape == (2, 16, cfg.padded_vocab)
    assert float(aux) > 0
    loss, grads = md.loss_and_grad(p, cfg, tokens[0], client.masks,
                                   client.gates)
    assert float(loss) == pytest.approx(float(md.lm_loss(logits, tokens[0])
                                              + aux), rel=1e-6)
    assert all(torch.isfinite(v).all() for v in grads.values())
    router = grads[("stages", 0, 1, "moe", "router")]
    assert float(router[0].abs().sum()) > 0          # an active repeat
    assert float(router[1].abs().sum()) == 0         # gated off (depth 1)

    # local SGD keeps a narrow client's sub-model inside its width
    client = ref_fl.Client(cfg, 0.5, (1, 2), 100, "cpu")
    new, losses = ref_fl.local_update(params, cfg, client, tokens, 0.05)
    assert torch.isfinite(losses).all()
    for path, v in new.items():
        dens = torch.broadcast_to(mk.density(tuple(v.shape),
                                             client.axes[path]), v.shape)
        assert torch.all(v[dens == 0] == 0), path


@pytest.mark.parametrize("w,experts,heads", [(0.25, 1, 2), (0.5, 1, 2),
                                             (1.0, 2, 4)])
def test_toy_family_masks(toy, w, experts, heads):
    cfg = toy
    m = mk.width_masks(cfg, w, "cpu")
    assert set(m) == {"d_model", "heads", "kv_heads", "d_ff", "experts"}
    assert float(m["experts"].sum()) == experts
    assert float(m["heads"].sum()) == heads
    axes = mk.axis_masks(cfg, m)
    shapes = md.param_shapes(cfg)
    assert set(axes) == set(shapes)
    for path, shape in shapes.items():
        assert torch.broadcast_to(mk.density(shape, axes[path]),
                                  shape).shape == shape


def test_toy_family_uploads_are_masked(toy):
    cfg = toy
    g = md.init_flat(cfg, 2**31 + 9, "cpu")
    members = _members(cfg, 2**31 + 9)[:3]
    x = tr.uploads(cfg, g, members, 1e-3, 2**31 + 9, 10)
    for c, mem in enumerate(members):
        for off, size, shape, d in tr.client_mask_rows(cfg, mem, "cpu"):
            row = x[c, off:off + size].view(shape)
            dd = torch.broadcast_to(d, shape)
            assert torch.all(row[dd == 0] == 0)
            assert bool(torch.any(row[dd > 0] != 0))


@pytest.mark.parametrize("w,frac", POOL)
def test_toy_family_flops_match_hand_count(toy, w, frac):
    cfg = toy
    B, S = 4, 64
    depths = tuple(max(1, math.ceil(frac * d))
                   for d in cfg.max_section_depths())
    D = 64 if w == 1.0 else max(16, int(w * 64) // 8 * 8)
    K = max(1, round(w * 2))
    H, F = 2 * K, 128 if w == 1.0 else int(w * 128) // 8 * 8
    E = max(1, round(w * 2))
    bs = B * S
    block_attn = (2 * bs * D * (H + 2 * K) * 16 + 2 * bs * H * 16 * D
                  + 2 * 2 * bs * (S / 2) * H * 16 + 2 * 3 * bs * D * F)
    block_moe = 2 * bs * D * E + 2 * 2 * bs * D * 32
    want = 3 * (sum(depths) * (block_attn + block_moe)
                + 2 * bs * D * 256)
    assert ys.client_step_flops(cfg, w, depths, B, S) == pytest.approx(
        want, rel=1e-12)


def test_an_unknown_block_is_named():
    cfg = ModelConfig.from_json(dict(MODEL, blocks={"moe": "no_such"}))
    with pytest.raises(ValueError,
                       match="bench/reference/blocks/no_such.py"):
        md.param_shapes(cfg)


def _labels():
    """Every layer kind, block module and family label the benchmark
    knows."""
    out = {p.stem for p in (ROOT / "bench" / "reference" / "blocks")
           .glob("*.py")} - {"__init__"}
    for path in (ROOT / "bench" / "configs").glob("*.json"):
        model = json.loads(path.read_text())["model"]
        out |= {model["family"], *model.get("layer_pattern", ())}
    return out


def _strings(node):
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return {node.value}
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        return set().union(*map(_strings, node.elts))
    return set()


def _name(node):
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Subscript):
        return next(iter(_strings(node.slice)), None)
    return None


def test_no_branch_on_a_kind_or_family_outside_the_blocks():
    labels = _labels()
    found = []
    for path in sorted((ROOT / "bench").rglob("*.py")):
        if (ROOT / "bench" / "reference" / "blocks") in path.parents:
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Compare):
                ops = [node.left] + node.comparators
                lits = set().union(*map(_strings, ops))
                names = {_name(o) for o in ops}
                if lits & labels or (lits and names & {"kind", "family"}):
                    found.append((path.name, node.lineno))
            elif isinstance(node, ast.Dict):
                if set().union(*(_strings(k) for k in node.keys if k)) \
                        & labels:
                    found.append((path.name, node.lineno))
    assert not found, found


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_program_config_round_trips_the_registry(name):
    arch = ARCHS[name]
    model = json.loads(json.dumps(dataclasses.asdict(arch)))
    assert common.program_config(model) == arch

