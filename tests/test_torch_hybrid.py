"""The hybrid family in the port (``repro_torch``) against the JAX package,
on the CPU, with the reference's weights carried across as numpy:
recurrentgemma-2b's RG-LRU block (the conv, the log-depth scan, decode,
its masks and gradients), ring KV caches and sliding windows on the
serving path, the logit softcap, and the model at the JAX CLI's 4-layer cut
(``reduced()``: d_model 256, d_rnn 256, 4 query heads and 1 kv head of 64,
window 128; stages ((rglru, rglru, attn) × 1, (rglru,) × 1)) — forward,
loss and gradients, serving, FL rounds through both engines, dense
training and the CLIs.

Tolerances: rtol 1e-4 / atol 1e-5 at f32 (the frameworks sum products in
other orders), the atol scaled by the largest magnitude of the tensor
compared, vocabulary padding aside (``_close``): the recurrence sums up to
S terms of that magnitude (|h| up to about 10 at the cut), and where they
cancel to a small element the f32 error of the terms remains, so the
plain atol fails on one element in several hundred (1.4e-5 on a state of
largest magnitude 6.8); gradients the same way; cache writes bit-equal;
with a bf16 KV cache the logits within one bf16 step (2^-8) of the
largest real logit (ROADMAP queue 3 item 8); int8 rounds within queue 3
item 6's allowance (one admission step an element free-running).  Each
reference program runs once per module: the jitted functions below, and
the reference's ``run_fl`` at f32 and int8 (shared by the flat and tree
cases: the reference's engines are parity-locked, and
``test_torch_tree.py`` holds the port's tree engine against the
reference's flat engine too).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.launch import train as jtrain
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro.models import rglru as jrglru
from repro.models.masks import width_masks as jwidth_masks
from repro_torch.configs import get_arch
from repro_torch.core import round as round_mod
from repro_torch.launch import serve, train
from repro_torch.models import attention, model, rglru
from repro_torch.models.masks import width_masks
from repro_torch.models.model import _to_torch, params_from_numpy
from repro_torch.tree import leaves, leaves_with_path, tree_map
from test_torch_quant import _steps, assert_round_close

torch.set_num_threads(2)

ARCH = "recurrentgemma-2b"
TOL = dict(rtol=1e-4, atol=1e-5)
BF16_STEP = 2.0 ** -8
CFG = train.fl_config(ARCH, "cls", 10, full_size=False)
JCFG = jget_arch(ARCH).reduced().replace(n_layers=4, n_sections=2,
                                         vocab_size=64, tie_embeddings=False)
JPARAMS = jmodel.init_params(JCFG, jax.random.PRNGKey(0))
RUN = dict(rounds=2, n_clients=4, batch=2, seq_len=16, eval_every=0)


def _port(tree, cfg=CFG):
    return params_from_numpy(jax.tree.map(np.asarray, tree), cfg, "cpu")


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _close(got, want, what=""):
    """rtol 1e-4, atol 1e-5 of the largest magnitude (at least 1) of
    ``want``, its -1e30 vocabulary padding aside."""
    want = np.asarray(want, np.float32)
    real = np.abs(want)[np.abs(want) < 1e29]
    np.testing.assert_allclose(
        _np(got), want, rtol=1e-4,
        atol=1e-5 * max(1.0, float(real.max()) if real.size else 1.0),
        err_msg=what)


def test_cut_matches_reference():
    assert CFG.stages() == JCFG.stages() == (
        (("rglru", "rglru", "attn"), 1), (("rglru",), 1))
    assert CFG.attn_window == 128 and CFG.logit_softcap == 30.0
    assert CFG.rglru.d_rnn(CFG.d_model) == 256 and CFG.head_dim == 64
    assert (CFG.n_heads, CFG.n_kv_heads, CFG.act) == (4, 1, "gelu")


# ---------------------------------------------------------------------------
# The RG-LRU block
# ---------------------------------------------------------------------------

# stage 0's first block, repeat 0
JBLOCK = {k: v[0] for k, v in JPARAMS["stages"][0][0]["rg"].items()}
BLOCK = {k: _to_torch(np.asarray(v)) for k, v in JBLOCK.items()}
D, DR = CFG.d_model, CFG.rglru.d_rnn(CFG.d_model)


def _masks(w):
    return width_masks(CFG, w), jwidth_masks(JCFG, w)


def _cache(seed, B=2):
    """A cache with a random conv window and state, at position 9."""
    rng = np.random.default_rng(seed)
    conv = rng.normal(size=(B, CFG.rglru.d_conv - 1, DR)).astype(np.float32)
    h = rng.normal(size=(B, DR)).astype(np.float32)
    return (rglru.RGLRUCache(torch.from_numpy(conv), torch.from_numpy(h),
                             torch.tensor(9)),
            jrglru.RGLRUCache(jnp.asarray(conv), jnp.asarray(h),
                              jnp.asarray(9, jnp.int32)))


def _cache_close(got, want):
    for a, b in zip(got[:2], want[:2]):
        _close(a, b)
    assert int(got.pos) == int(want.pos)


@pytest.mark.parametrize("case", ["plain", "masked", "cached"])
def test_rglru_block_matches_reference(case):
    """The block over an odd S = 37: without masks, with the d_rnn and
    d_model masks of width 0.5, and from a cache (conv window and state):
    output and new cache."""
    u = np.random.default_rng(1).normal(size=(2, 37, D)).astype(np.float32)
    kw, jkw = {}, {}
    if case == "masked":
        m, jm = _masks(0.5)
        kw = dict(mask_dr=m.d_rnn, d_model_mask=m.d_model)
        jkw = dict(mask_dr=jm.d_rnn, d_model_mask=jm.d_model)
    if case == "cached":
        kw["cache"], jkw["cache"] = _cache(2)
    with torch.no_grad():
        out, c = rglru.rglru_block(BLOCK, torch.from_numpy(u), CFG.rglru, D,
                                   **kw)
    jout, jc = jrglru.rglru_block(JBLOCK, jnp.asarray(u), JCFG.rglru, D,
                                  **jkw)
    _close(out, jout)
    if case == "masked":
        assert (out.numpy()[..., m.d_model.numpy() == 0] == 0).all()
    if case == "cached":
        _cache_close(c, jc)
        assert c.conv.shape == (2, 3, DR) and c.h.dtype == torch.float32


def test_associative_scan_is_the_recurrence():
    """The log-depth scan against the loop h_t = a_t h_{t-1} + v_t, at
    lengths that exercise both parities of the recursion."""
    rng = np.random.default_rng(3)
    for S in (1, 2, 5, 16, 37):
        a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, S, 3))
                             .astype(np.float32))
        v = torch.from_numpy(rng.normal(size=(2, S, 3)).astype(np.float32))
        h, want = torch.zeros(2, 3), []
        for t in range(S):
            h = a[:, t] * h + v[:, t]
            want.append(h)
        np.testing.assert_allclose(rglru.associative_scan(a, v)[1].numpy(),
                                   torch.stack(want, 1).numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_rglru_gradients_match_reference():
    """Gradients of a weighted sum of the masked block's output, from a
    cache, with respect to the input and every leaf (autograd through the
    scan) against ``jax.grad``."""
    rng = np.random.default_rng(4)
    u = rng.normal(size=(2, 37, D)).astype(np.float32)
    w = rng.normal(size=(2, 37, D)).astype(np.float32)
    m, jm = _masks(0.5)
    cache, jcache = _cache(5)

    def jloss(p, uu):
        y, _ = jrglru.rglru_block(p, uu, JCFG.rglru, D, mask_dr=jm.d_rnn,
                                  d_model_mask=jm.d_model, cache=jcache)
        return jnp.sum(y * w)
    jgu, jgp = jax.jit(jax.grad(jloss, argnums=(1, 0)))(JBLOCK,
                                                        jnp.asarray(u))
    leaves_ = {k: v.clone().requires_grad_(True) for k, v in BLOCK.items()}
    ut = torch.from_numpy(u).requires_grad_(True)
    y, _ = rglru.rglru_block(leaves_, ut, CFG.rglru, D, mask_dr=m.d_rnn,
                             d_model_mask=m.d_model, cache=cache)
    grads = torch.autograd.grad((y * torch.from_numpy(w)).sum(),
                                [ut] + list(leaves_.values()))
    _close(grads[0], jgu, "u")
    for k, g in zip(leaves_, grads[1:]):
        _close(g, jgp[k], k)


def test_rglru_decode_matches_reference_and_the_block():
    """Five decode steps from a cache against the reference's, step by
    step (output and cache); and the block over 12 tokens then 5 decode
    steps equal to one block over all 17."""
    rng = np.random.default_rng(6)
    u = rng.normal(size=(2, 17, D)).astype(np.float32)
    m, jm = _masks(0.75)
    kw = dict(mask_dr=m.d_rnn, d_model_mask=m.d_model)
    jkw = dict(mask_dr=jm.d_rnn, d_model_mask=jm.d_model)
    c, jc = _cache(7)
    with torch.no_grad():
        for t in range(5):
            out, c = rglru.rglru_decode(BLOCK, torch.from_numpy(u[:, t:t + 1]),
                                        CFG.rglru, D, c, **kw)
            jout, jc = jrglru.rglru_decode(JBLOCK, jnp.asarray(u[:, t:t + 1]),
                                           JCFG.rglru, D, jc, **jkw)
            _close(out, jout)
            _cache_close(c, jc)
        zero = rglru.init_rglru_cache(2, D, CFG.rglru, torch.float32, "cpu")
        whole, _ = rglru.rglru_block(BLOCK, torch.from_numpy(u), CFG.rglru, D,
                                     cache=zero, **kw)
        head, c = rglru.rglru_block(BLOCK, torch.from_numpy(u[:, :12]),
                                    CFG.rglru, D, cache=zero, **kw)
        steps = [head]
        for t in range(12, 17):
            out, c = rglru.rglru_decode(BLOCK, torch.from_numpy(u[:, t:t + 1]),
                                        CFG.rglru, D, c, **kw)
            steps.append(out)
    _close(torch.cat(steps, 1), whole)
    assert int(c.pos) == 17


# ---------------------------------------------------------------------------
# Ring KV caches
# ---------------------------------------------------------------------------

def _kv(rng, B, S, K=2, hd=8):
    return [rng.normal(size=(B, S, K, hd)).astype(np.float32)
            for _ in range(2)]


@pytest.mark.parametrize("pos,S,ring", [(3, 4, True), (5, 9, True),
                                        (6, 13, True), (2, 4, False)])
def test_cache_extend_matches_reference(pos, S, ring):
    """A cache of 8 slots at position ``pos`` extended by S entries: on a
    ring a write that wraps (S < 8), one that fills it (S ≥ 8, its tail
    kept), and without a ring: the slots bit-equal."""
    rng = np.random.default_rng(pos)
    k0, v0 = _kv(rng, 2, 8)
    k, v = _kv(rng, 2, S)
    c = attention.cache_extend(attention.KVCache(
        torch.from_numpy(k0), torch.from_numpy(v0), torch.tensor(pos)),
        torch.from_numpy(k), torch.from_numpy(v), ring=ring)
    jc = jattn.cache_extend(jattn.KVCache(jnp.asarray(k0), jnp.asarray(v0),
                                          jnp.asarray(pos, jnp.int32)),
                            jnp.asarray(k), jnp.asarray(v), ring=ring)
    np.testing.assert_array_equal(c.k.numpy(), np.asarray(jc.k))
    np.testing.assert_array_equal(c.v.numpy(), np.asarray(jc.v))
    assert int(c.pos) == int(jc.pos) == pos + S


@pytest.mark.parametrize("pos,ring,window", [
    (13, True, 5), (13, True, 8), (3, True, 5), (6, False, 4),
    (6, False, None)])
def test_attend_decode_matches_reference(pos, ring, window):
    """One query against a cache of 8 at position ``pos``: a ring under a
    window shorter than it (the ``last_abs`` rule) and as long as it, a
    ring not yet full, and no ring with and without a window."""
    rng = np.random.default_rng(pos + 1)
    k, v = _kv(rng, 2, 8)
    q = rng.normal(size=(2, 1, 4, 8)).astype(np.float32)
    hm = np.array([1, 1, 0, 1], np.float32)
    got = attention.attend_decode(
        torch.from_numpy(q), attention.KVCache(torch.from_numpy(k),
                                               torch.from_numpy(v),
                                               torch.tensor(pos)),
        ring=ring, window=window, head_mask=torch.from_numpy(hm))
    want = jattn.attend_decode(
        jnp.asarray(q), jattn.KVCache(jnp.asarray(k), jnp.asarray(v),
                                      jnp.asarray(pos, jnp.int32)),
        ring=ring, window=window, head_mask=jnp.asarray(hm))
    _close(got, want)


# ---------------------------------------------------------------------------
# The model: forward, loss and gradients
# ---------------------------------------------------------------------------

# 7 layers in 2 sections: stages ((rglru, rglru, attn) × 2, (rglru,) × 1)
JCFG7 = JCFG.replace(n_layers=7)
CFG7 = CFG.replace(n_layers=7)
MODELS = {"cut": (JCFG, CFG, jnp.ones((1,), jnp.float32)),
          "7-layers": (JCFG7, CFG7, jnp.asarray([1.0, 0.0], jnp.float32))}
_JAX_FNS = {}


def _jax_fns(name):
    """The reference's forward and value_and_grad of ``loss_fn`` for one
    config, jitted once."""
    if name not in _JAX_FNS:
        jcfg = MODELS[name][0]
        _JAX_FNS[name] = (
            jmodel.init_params(jcfg, jax.random.PRNGKey(1)),
            jax.jit(lambda p, b, m, g: jmodel.forward(
                p, jcfg, b, masks=m, gates=g, remat=False)[0]),
            jax.jit(lambda p, b, m, g: jax.value_and_grad(
                jmodel.loss_fn, has_aux=True)(p, jcfg, b, masks=m, gates=g,
                                              task="lm")))
    return _JAX_FNS[name]


@pytest.mark.parametrize("w", [0.5, 1.0])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_forward_loss_and_grad_match_reference(name, w):
    """Logits (softcapped at 30, vocabulary padding at -1e30), the loss and
    its gradients at width ``w``; at 7 layers the depth gate zeroes stage
    0's second repeat while stage 1 stays full."""
    jcfg, cfg, jgates = MODELS[name]
    jp, jfwd, jvg = _jax_fns(name)
    params = _port(jp, cfg)
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 24))
    jm = jwidth_masks(jcfg, w)
    m = width_masks(cfg, w)
    gates = torch.from_numpy(np.asarray(jgates))
    batch, jbatch = {"tokens": torch.as_tensor(toks)}, \
        {"tokens": jnp.asarray(toks)}
    with torch.no_grad():
        logits, _ = model.forward(params, cfg, batch, masks=m, gates=gates)
    want = np.asarray(jfwd(jp, jbatch, jm, jgates))
    _close(logits, want)
    real = logits[..., :cfg.vocab_size]
    assert float(real.abs().max()) < 30.0 and \
        (logits[..., cfg.vocab_size:] == -1e30).all()
    (total, _), grads = model.loss_and_grad(params, cfg, batch, masks=m,
                                            gates=gates, task="lm")
    (jtotal, _), jgrads = jvg(jp, jbatch, jm, jgates)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-4)
    for (path, g), jg in zip(leaves_with_path(grads),
                             jax.tree.leaves(jgrads)):
        _close(g, jg, str(path))
    if name == "7-layers":   # the gated repeat takes no gradient
        for g in leaves(grads["stages"][0]):
            assert not g[1].any()


# ---------------------------------------------------------------------------
# Serving: prefill and decode through ring caches
# ---------------------------------------------------------------------------

def _tinyllama():
    jcfg = jget_arch("tinyllama-1.1b").reduced()
    return jcfg, get_arch("tinyllama-1.1b").reduced(), \
        jmodel.init_params(jcfg, jax.random.PRNGKey(2))


# (prompt, decoded, capacity, window): the cut's window 128 with a
# 150-token prompt (the ring of 128 wraps in prefill and again in decode);
# tinyllama at window 64, capacity 128 (a ring of 64), a 100-token prompt
SERVE = {"recurrentgemma-2b": (150, 12, 232, None),
         "tinyllama-1.1b": (100, 12, 128, 64)}
SERVE_CASES = [("recurrentgemma-2b", "float32"),
               ("recurrentgemma-2b", "bfloat16"),
               ("tinyllama-1.1b", "float32")]


@pytest.mark.parametrize("arch,cache", SERVE_CASES)
def test_windowed_serving_matches_reference(arch, cache):
    """Prefill of a prompt longer than the window, then teacher-forced
    decode steps, against the reference's ``prefill`` / ``decode_step``:
    logits at the f32 tolerance with an f32 cache, within one bf16 step of
    the largest real logit with a bf16 one."""
    if arch == ARCH:
        jcfg, cfg, jp = JCFG, CFG, JPARAMS
    else:
        jcfg, cfg, jp = _tinyllama()
    params = _port(jp, cfg)
    P, n, cap, window = SERVE[arch]
    jdt, dt = {"float32": (jnp.float32, torch.float32),
               "bfloat16": (jnp.bfloat16, torch.bfloat16)}[cache]
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, P + n))
    jlg, jc, _ = jmodel.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :P])},
                                capacity=cap, window=window, cache_dtype=jdt)
    jdec = jax.jit(lambda p, t, c: jmodel.decode_step(p, jcfg, t, c,
                                                      window=window))
    with torch.no_grad():
        lg, c, _ = model.prefill(params, cfg, {"tokens": torch.as_tensor(
            toks[:, :P])}, capacity=cap, window=window, cache_dtype=dt)
        got, want = [lg], [np.asarray(jlg)]
        for i in range(P, P + n):
            tok = toks[:, i:i + 1]
            lg, c = model.decode_step(params, cfg, torch.as_tensor(tok), c,
                                      window=window)
            jlg, jc = jdec(jp, jnp.asarray(tok), jc)
            got.append(lg)
            want.append(np.asarray(jlg))
    got, want = torch.cat(got, 1).float().numpy(), np.concatenate(want, 1)
    win = window or cfg.attn_window
    kv = [x for x in leaves(c) if x.dim() == 5]   # (R, B, C, K, hd)
    assert kv and all(x.shape[2] == min(cap, win) < P for x in kv)
    assert int(model._cache_pos(c)) == P + n
    if cache == "float32":
        _close(got, want)
    else:
        real = float(np.abs(want[..., :cfg.vocab_size]).max())
        np.testing.assert_allclose(got, want, rtol=0, atol=BF16_STEP * real)


# ---------------------------------------------------------------------------
# FL rounds, dense training and the CLIs
# ---------------------------------------------------------------------------

def _ckpt_buffer(prefix, r: int) -> tuple:
    """(round r's checkpoint as one flat f32 buffer, its json)."""
    with np.load(f"{prefix}_r{r:05d}.npz") as z:
        buf = np.concatenate([z[f"a{i}"].astype(np.float32).ravel()
                              for i in range(len(z.files))])
    with open(f"{prefix}_r{r:05d}.json") as f:
        return buf, json.load(f)


_JAX_RUNS = {}


def _jax_run(dt, tmp_path_factory):
    """The reference's ``run_fl`` at the cut (the resident driver, flat
    engine) at ``dt``, once per module: (history, last checkpoint)."""
    if dt not in _JAX_RUNS:
        prefix = tmp_path_factory.mktemp("jax") / "run"
        hist = jtrain.run_fl(ARCH, update_dtype=dt, ckpt=str(prefix),
                             quiet=True, **RUN)
        _JAX_RUNS[dt] = hist, _ckpt_buffer(prefix, 1)
    return _JAX_RUNS[dt]


@pytest.mark.parametrize("driver,engine,dt", [
    ("resident", "flat", "f32"), ("per-round", "tree", "f32"),
    ("resident", "flat", "int8")])
def test_run_fl_matches_reference(driver, engine, dt, tmp_path,
                                  tmp_path_factory, monkeypatch):
    """Two rounds of the CLI at the cut from the same weights (stage 1's
    rglru block aggregated beside stage 0's), the port's flat and tree
    engines against the reference's flat run: the final loss and the last
    round's checkpoint (the int8 global free-running, within one admission
    step an element)."""
    want, (want_buf, want_json) = _jax_run(dt, tmp_path_factory)
    seen = {}
    flat_round = round_mod.flat_round

    def keep_state(*a, **kw):     # the int8 scales, for the step sizes
        out = flat_round(*a, **kw)
        seen["qstate"], seen["index"] = a[-1], a[4]
        return out
    monkeypatch.setattr(round_mod, "flat_round", keep_state)
    got = train.run_fl(ARCH, agg_engine=engine, driver=driver,
                       update_dtype=dt, ckpt=str(tmp_path / "port"),
                       device="cpu", params=_port(JPARAMS), quiet=True,
                       **RUN)
    assert got["round"] == want["round"] == [1]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    got_buf, got_json = _ckpt_buffer(tmp_path / "port", 1)
    assert got_json["names"] == want_json["names"]
    # the flat drivers also record the flat buffer's length
    assert got_json["meta"] == (want_json["meta"] if engine == "flat" else {
        k: v for k, v in want_json["meta"].items() if k != "flat_n"})
    assert any("[1][0]['rg']" in name for name in got_json["names"])
    if dt == "f32":
        np.testing.assert_allclose(got_buf, want_buf, **TOL)
    else:
        assert_round_close(got_buf, want_buf,
                           _steps(seen["index"], want_buf, dt,
                                  seen["qstate"][1]),
                           "hybrid int8 global after round 1",
                           flips_alone=False)


def test_run_dense_matches_reference():
    """``run_dense`` at ``reduced()`` (two (rglru, rglru, attn) repeats)
    from the reference's weights: the same 3-step history."""
    want = jtrain.run_dense(ARCH, 3, 2, 16)
    jcfg = jget_arch(ARCH).reduced().replace(grad_accum=1)
    cfg = get_arch(ARCH).reduced().replace(grad_accum=1)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    got = train.run_dense(ARCH, 3, 2, 16, device="cpu", params=_port(jp, cfg))
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)


def test_clis_run_the_hybrid_on_cpu():
    res = train.main(["--arch", ARCH, "--rounds", "1", "--clients", "4",
                      "--batch", "2", "--seq-len", "16", "--device", "cpu"])
    assert res["round"] == [0] and np.isfinite(res["round_loss"][0])
    res = train.main(["--mode", "dense", "--arch", ARCH, "--steps", "2",
                      "--batch", "2", "--seq-len", "16", "--device", "cpu"])
    assert len(res["losses"]) == 2 and np.all(np.isfinite(res["losses"]))
    out = serve.main(["--arch", ARCH, "--batch", "2", "--prompt-len", "40",
                      "--max-new", "3", "--device", "cpu"])
    assert out["tokens"].shape == (2, 3)
    assert ((0 <= out["tokens"]) & (out["tokens"] < 512)).all()


def test_init_draws_the_reference_distributions():
    """The port's own init at the cut: the f32 leaves stay f32 under a bf16
    model, Λ puts a = sigmoid(Λ)^c in (0.9, 0.999), the conv at scale 3
    (std 3/2 over d_conv 4 taps), zero biases."""
    params = model.init_params(CFG, torch.Generator().manual_seed(0),
                               dtype=torch.bfloat16)
    rg = params["stages"][0][0]["rg"]
    for k in ("w_r", "b_r", "w_i", "b_i", "lam"):
        assert rg[k].dtype == torch.float32, k
    assert rg["in_x"].dtype == torch.bfloat16
    a = torch.sigmoid(rg["lam"]) ** CFG.rglru.c
    assert ((a > 0.9 - 1e-6) & (a < 0.999 + 1e-6)).all()
    assert abs(float(rg["conv_w"].float().std()) - 1.5) < 0.05
    for k in ("conv_b", "b_r", "b_i"):
        assert not rg[k].any()
    assert tree_map(lambda t: t.shape, params) == tree_map(
        lambda t: t.shape, _port(JPARAMS))
