"""The port's sharded FL server (``--mesh``): the mesh and layout helpers
against the JAX package's, the grouped segmented quantile against its
interpret-mode kernel, and 2 x 2 and 2 x 1 meshes of gloo ranks on the CPU
against the reference's unsharded functions and the port's unsharded path.

The reference's own mesh paths do not run here (ROADMAP queue 3 items 3
and 29), so the sharded port is held against unsharded results.  Each mesh
shape is one spawn of ``torch.multiprocessing`` ranks that run every check
and save what they found; the parent computes the references meanwhile
and the tests compare.  The ranks import this module, so JAX and the
shared fixture are imported inside the functions that run in the parent
only.

Tolerances: thresholds bit-equal (they follow from exact histogram
counts); each Σw² bit-equal to the unsharded run of the same search (its
histogram planes are exact integers) and at rtol 1e-5 against the per-leaf
path; the merged global within 8 ulp of
Σ_c n_c·α_c·|x_c[n]|·dens / Γ[n], the sums' magnitude, against the port's
unsharded aggregation (the shards add the same terms in another order),
and at the flat tests' rtol 1e-4 / atol 1e-5 against the reference's;
rounds at rtol 1e-4 / atol 1e-5 against the reference's ``run_rounds``.
"""
import datetime
import functools
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.checkpoint import checkpoint as ckpt_mod
from repro_torch.core import flat
from repro_torch.core.async_round import AsyncConfig, AsyncEngine, run_async
from repro_torch.core.fedfa import STRATEGIES
from repro_torch.core.round import (ResidentDriver, fresh_quant_state,
                                    run_rounds)
from repro_torch.core.server import FLConfig, make_client_specs, stack_runtimes
from repro_torch.data import partition, pipeline, synthetic
from repro_torch.kernels.fedfa_quantile import multilevel
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import train
from repro_torch.sharding import cohort as csh
from repro_torch.sim import ParitySource

torch.set_num_threads(2)

CFG = train.fl_config("smollm-135m", "cls", 10, full_size=False)
E, M, ROUNDS = 2, 3, 2
SHAPES = ("2x2", "2x1")
EPS = 2.0 ** -23
CLI = ["--rounds", "2", "--clients", "6", "--batch", "2", "--seq-len", "8",
       "--malicious-frac", "0.2", "--eval-every", "1", "--device", "cpu"]


def _cohort(m, malicious_frac=0.0, seed=0):
    """The twin of ``conftest.make_cohort`` (same numpy draws), as in
    ``test_torch_round``."""
    specs = make_client_specs(CFG, m, archs=train.client_arch_pool(CFG,
                                                                   "width"),
                              malicious_frac=malicious_frac, seed=seed)
    parts = partition.iid_partition(m, 10, seed=seed)
    profiles = synthetic.make_class_profiles(10, CFG.vocab_size, seed=seed)

    def data_fn(r):
        b = pipeline.round_batches_cls(
            parts, list(range(m)), 10, CFG.vocab_size, local_steps=E,
            batch=2, seq_len=8, profiles=profiles, seed=100 + r)
        return specs, {k: torch.as_tensor(v, dtype=torch.int64)
                       for k, v in b.items()}
    return specs, data_fn


def _agg_case(index):
    """An m = 3 cohort with an attacker: specs, rows x (3, n_padded) and a
    global (n_padded,), both zero on the inert tail."""
    specs, _ = _cohort(M, malicious_frac=0.34)
    rng = np.random.default_rng(7)
    x = np.zeros((M, index.n_padded), np.float32)
    x[:, :index.n] = 0.02 * rng.normal(size=(M, index.n))
    g = np.zeros(index.n_padded, np.float32)
    g[:index.n] = 0.02 * rng.normal(size=index.n)
    return specs, torch.from_numpy(x), torch.from_numpy(g)


def _counts(mesh) -> dict:
    return {f"{k}|{a}|{n}": c for (k, a, n), c in mesh.counts.items()}


# ---------------------------------------------------------------------------
# what each rank runs
# ---------------------------------------------------------------------------

def _rank_aggregation(mesh, params, out):
    """f32, int8 (pregrafted) and use_kernel=False aggregations of the
    m = 3 cohort, with each one's collectives; thresholds and Σw² of the
    norms pass; the quantized admission."""
    index = flat.FlatIndex(params, pad_to=csh.pad_unit(mesh))
    specs, x, g = _agg_case(index)
    runtimes, _ = csh.pad_cohort(stack_runtimes(CFG, specs, "cpu"), {}, 1)
    rows = csh.data_rows(mesh, M + 1)
    masks, gates, gmaps, nd, _, _ = (csh.rows_of(t, rows) for t in runtimes)
    xl = csh.pad_leading(x, 1)[rows]
    gl = g[csh.model_cols(mesh, index.n_padded)].clone()
    cols = flat.pool_cols(index, mesh, None)
    kw = dict(STRATEGIES["fedfa"], mesh=mesh)
    dens, fracs = flat._density_rows(CFG, index, masks, cols, "cpu")
    xm = flat._graft_flat(index, xl, gmaps)[:, cols] * dens
    two_d = flat.two_d(index, mesh, None)
    t, ss = flat._cohort_stats(index, xm.contiguous(), fracs, 0.95, None,
                               None, mesh, cols if two_d else None)
    out.update(t=t, ss=ss)
    mesh.counts.clear()
    out["g_f32"] = flat.aggregate_buffers(index, gl, xl, CFG, masks, gates,
                                          gmaps, nd, **kw)
    out["counts_f32"] = _counts(mesh)
    mesh.counts.clear()
    out["g_off"] = flat.aggregate_buffers(index, gl, xl, CFG, masks, gates,
                                          gmaps, nd, use_kernel=False, **kw)
    out["counts_off"] = _counts(mesh)
    state = fresh_quant_state(index, rows.stop - rows.start, "int8", "cpu",
                              cols.stop - cols.start)
    flat.admit_quantized(index, CFG, xl, masks, gmaps, True, state, "int8",
                         mesh, cols)
    out.update(x_q=state[0], scales=state[1])
    tq, ssq = flat._cohort_stats(index, state[0], fracs, 0.95, state[1],
                                 None, mesh, cols if two_d else None)
    out.update(tq=tq, ssq=ssq)
    mesh.counts.clear()
    out["g_int8"] = flat.aggregate_buffers(
        index, gl, state[0], CFG, masks, gates, gmaps, nd, scales=state[1],
        pregrafted=True, **kw)
    out["counts_int8"] = _counts(mesh)


def _rank_rounds(mesh, params, perms, workdir, shape, out):
    """Resident rounds (fedfa, heterofl at f32; fedfa at int8), a parity
    merge of the async engine (f32, int8) and a checkpoint round trip."""
    _, data = _cohort(M, malicious_frac=0.34)
    perm_fn = lambda r, m, n: perms[r]
    for strategy, dt in (("fedfa", "f32"), ("heterofl", "f32"),
                         ("fedfa", "int8")):
        fl = FLConfig(local_steps=E, lr=0.05, strategy=strategy, task="cls",
                      update_dtype=dt)
        mesh.counts.clear()
        p, losses = run_rounds(params, CFG, fl, ROUNDS, data,
                               perm_fn=perm_fn, mesh=mesh)
        index = flat.FlatIndex(p)
        out[f"rounds_{strategy}_{dt}"] = (flat.flatten(index, p), losses,
                                          _counts(mesh))
        if strategy == "fedfa" and dt == "f32":
            pm = flat.FlatIndex(p, pad_to=csh.pad_unit(mesh))
            gl = flat.flatten(pm, p)[csh.model_cols(mesh, pm.n_padded)]
            path = f"{workdir}/ckpt_{shape}"
            ckpt_mod.save_from_buffer(path, pm, gl.clone(), meta={"round": 1},
                                      mesh=mesh)
            _, back, meta = ckpt_mod.restore_to_buffer(path, p, mesh=mesh)
            out["ckpt"] = (torch.equal(back, gl), meta)
    for dt in ("f32", "int8"):
        fl = FLConfig(local_steps=E, lr=0.05, strategy="fedfa", task="cls",
                      update_dtype=dt)
        p, losses = run_async(params, CFG, fl, 1, ParitySource(data),
                              acfg=AsyncConfig.parity(M), eval_every=0,
                              perm_fn=perm_fn, mesh=mesh)
        out[f"async_{dt}"] = (flat.flatten(flat.FlatIndex(p), p), losses)


def _rank(rank, shape, workdir):
    torch.set_num_threads(1)
    D, Mm = csh_shape = mesh_mod.parse_mesh_shape(shape)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store",
                            rank=rank, world_size=D * Mm,
                            timeout=datetime.timedelta(seconds=240))
    try:
        mesh = mesh_mod.get_mesh(shape, "cpu")
        assert mesh.shape == csh_shape and mesh.coord == divmod(rank, Mm)
        inputs = torch.load(f"{workdir}/inputs.pt")
        out = {"coord": mesh.coord}
        _rank_aggregation(mesh, inputs["params"], out)
        _rank_rounds(mesh, inputs["params"], inputs["perms"], workdir, shape,
                     out)
        out["cli"] = train.main(CLI + ["--mesh-shape", shape, "--out",
                                       f"{workdir}/cli_{shape}_{rank}.json"])
        torch.save(out, f"{workdir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the parent: references, and the spawns
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _fixture():
    """(reference cfg, reference params, the port's params from them)."""
    import jax
    from conftest import fl_round_fixture
    from repro_torch.models.model import params_from_numpy
    jcfg, jparams = fl_round_fixture()
    return jcfg, jparams, params_from_numpy(
        jax.tree.map(np.asarray, jparams), CFG, "cpu")


def _jax_perms():
    from test_torch_round import _jax_perms as perms
    _, data = _cohort(M, malicious_frac=0.34)
    n = data(0)[1]["labels"][0].numel()
    return [perms(r, M, n) for r in range(ROUNDS)]


def _unsharded(params, perms, workdir):
    """The port's unsharded results of what the ranks run."""
    index = flat.FlatIndex(params)
    specs, x, g = _agg_case(index)
    masks, gates, gmaps, nd, _, _ = stack_runtimes(CFG, specs, "cpu")
    dens, fracs = flat._density_rows(CFG, index, masks,
                                     slice(0, index.n_padded), "cpu")
    xm = flat._graft_flat(index, x, gmaps) * dens
    ref = {"x": x, "g": g}
    ref["t"], ref["ss"] = flat._cohort_stats(index, xm, fracs, 0.95)
    # the 2-D pass's segmented search on whole rows, without a mesh
    whole = slice(0, index.n_padded)
    ref["ss_seg"] = flat._cohort_stats(index, xm, fracs, 0.95, cols=whole)[1]
    kw = STRATEGIES["fedfa"]
    ref["g_f32"] = flat.aggregate_buffers(index, g, x, CFG, masks, gates,
                                          gmaps, nd, **kw)
    ref["scale_f32"] = flat.aggregate_buffers(
        index, torch.zeros_like(g), x.abs(), CFG, masks, gates, gmaps, nd,
        **kw)
    state = fresh_quant_state(index, M, "int8", "cpu")
    flat.admit_quantized(index, CFG, x, masks, gmaps, True, state, "int8")
    ref.update(x_q=state[0], scales=state[1])
    ref["tq"], ref["ssq"] = flat._cohort_stats(index, state[0], fracs, 0.95,
                                               state[1])
    ref["ssq_seg"] = flat._cohort_stats(index, state[0], fracs, 0.95,
                                        state[1], cols=whole)[1]
    ref["g_int8"] = flat.aggregate_buffers(
        index, g, state[0], CFG, masks, gates, gmaps, nd, scales=state[1],
        pregrafted=True, **kw)
    ref["scale_int8"] = flat.aggregate_buffers(
        index, torch.zeros_like(g), state[0].abs(), CFG, masks, gates,
        gmaps, nd, scales=state[1], pregrafted=True, **kw)
    _, data = _cohort(M, malicious_frac=0.34)
    perm_fn = lambda r, m, n: perms[r]
    for strategy in ("fedfa", "heterofl"):
        fl = FLConfig(local_steps=E, lr=0.05, strategy=strategy, task="cls")
        p, losses = run_rounds(params, CFG, fl, ROUNDS, data,
                               perm_fn=perm_fn)
        ref[f"rounds_{strategy}_f32"] = (flat.flatten(flat.FlatIndex(p), p),
                                         losses)
    # run_rounds' steps, keeping the last admission's scales
    fl = FLConfig(local_steps=E, lr=0.05, strategy="fedfa", task="cls",
                  update_dtype="int8")
    driver = ResidentDriver(CFG, fl, index, "cpu")
    g_buf, losses = flat.flatten(index, params), []
    for r in range(ROUNDS):
        specs, batches = data(r)
        losses.append(float(driver.round(g_buf, specs, batches, perms[r])))
    ref["rounds_fedfa_int8"] = (g_buf, losses, driver.pool(M)[1][1])
    for dt in ("f32", "int8"):
        fl = FLConfig(local_steps=E, lr=0.05, strategy="fedfa", task="cls",
                      update_dtype=dt)
        p, losses = run_async(params, CFG, fl, 1, ParitySource(data),
                              acfg=AsyncConfig.parity(M), eval_every=0,
                              perm_fn=perm_fn)
        ref[f"async_{dt}"] = (flat.flatten(flat.FlatIndex(p), p), losses)
    ref["cli"] = train.main(CLI)
    ckpt_mod.save(f"{workdir}/ckpt_unsharded", params)
    return ref


def _jax_refs(x, g, x_q, scales):
    """The reference's unsharded aggregations and resident rounds."""
    import jax
    import jax.numpy as jnp
    from conftest import make_cohort
    from repro.core import flat as jflat
    from repro.core import round as jround
    from repro.core.server import FLConfig as JFLConfig
    from repro.core.server import stack_runtimes as jstack_runtimes
    jcfg, jparams, _ = _fixture()
    jspecs, jdata = make_cohort(jcfg, M, local_steps=E, malicious_frac=0.34)
    jmasks, jgates, jgmaps, jnd, _, _ = jstack_runtimes(jcfg, jspecs)
    jindex = jflat.get_index(jparams)
    n = jindex.n
    agg = functools.partial(jflat.aggregate_buffers, jindex,
                            jnp.asarray(g[:n].numpy()), cfg=jcfg,
                            masks=jmasks, gates=jgates, gmaps=jgmaps,
                            n_data=jnd, **STRATEGIES["fedfa"])
    out = {"g_f32": np.asarray(agg(x=jnp.asarray(x[:, :n].numpy()))),
           "g_int8": np.asarray(agg(
               x=jnp.asarray(x_q[:, :n].numpy()),
               scales=jnp.asarray(scales.numpy()), pregrafted=True))}
    for strategy in ("fedfa", "heterofl"):
        jfl = JFLConfig(local_steps=E, lr=0.05, strategy=strategy,
                        task="cls")
        jp, jl = jround.run_rounds(jparams, jcfg, jfl, ROUNDS, jdata,
                                   jax.random.PRNGKey(0))
        out[f"rounds_{strategy}"] = (
            np.asarray(jflat.flatten(jflat.get_index(jp), jp)), jl)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both meshes' ranks (spawned at once, run while the parent computes
    the references) -> {"2x2": [rank outputs], "2x1": [...], "ref": port
    unsharded, "jax": reference, "dir": {shape: workdir}}."""
    _, _, params = _fixture()
    perms = _jax_perms()
    dirs, procs = {}, {}
    for shape in SHAPES:
        dirs[shape] = tmp_path_factory.mktemp(f"mesh{shape}")
        torch.save({"params": params, "perms": perms},
                   dirs[shape] / "inputs.pt")
        D, Mm = mesh_mod.parse_mesh_shape(shape)
        procs[shape] = mp.start_processes(
            _rank, args=(shape, str(dirs[shape])), nprocs=D * Mm,
            join=False, start_method="spawn")
    try:
        ref = _unsharded(params, perms, dirs["2x2"])
        jref = _jax_refs(ref["x"], ref["g"], ref["x_q"], ref["scales"])
    finally:
        for shape, ctx in procs.items():
            while not ctx.join(timeout=600):
                pass
    out = {"ref": ref, "jax": jref, "dir": dirs}
    for shape in SHAPES:
        D, Mm = mesh_mod.parse_mesh_shape(shape)
        out[shape] = [torch.load(dirs[shape] / f"rank{r}.pt")
                      for r in range(D * Mm)]
    return out


def _rows_cols(shape, coord, index_n_padded):
    """The rows of the padded cohort and the pool columns rank ``coord``
    of the mesh ``shape`` holds."""
    D, Mm = mesh_mod.parse_mesh_shape(shape)
    r = (M + 1) // D
    rows = slice(coord[0] * r, (coord[0] + 1) * r)
    if Mm == 1:
        return rows, slice(0, index_n_padded)
    w = index_n_padded // Mm
    return rows, slice(coord[1] * w, (coord[1] + 1) * w)


def _global(ranks, key):
    """The whole global of a mesh from its ranks' P("model") slices; every
    data peer must hold the same bits."""
    by_k = {}
    for o in ranks:
        k = o["coord"][1]
        if k in by_k:
            assert torch.equal(by_k[k], o[key]), f"{key}: data peers differ"
        by_k[k] = o[key]
    return torch.cat([by_k[k] for k in sorted(by_k)])


# ---------------------------------------------------------------------------
# in-process: mesh construction and layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bad", ["2y2", "0x2", "x", "2x"])
def test_parse_mesh_shape_rejects_like_reference(bad):
    from repro.launch import mesh as jmesh
    for mod in (mesh_mod, jmesh):
        with pytest.raises(ValueError, match="not of the form DxM"):
            mod.parse_mesh_shape(bad)
    assert mesh_mod.parse_mesh_shape(" 2X4 ") == jmesh.parse_mesh_shape(
        " 2X4 ") == (2, 4)


@pytest.mark.parametrize("name,need", [("2x2", 4), ("production", 256),
                                       ("bogus", None), ("none", 0)])
def test_get_mesh_validation_like_reference(name, need):
    """Too few ranks (one runs here, as one device is visible to JAX) is a
    ValueError naming both counts in each package; an unknown name too."""
    from repro.launch import mesh as jmesh
    if need == 0:
        assert mesh_mod.get_mesh(name) is None and jmesh.get_mesh(name) is None
        return
    match = "unknown mesh" if need is None else f"needs {need} "
    with pytest.raises(ValueError, match=match) as got:
        mesh_mod.get_mesh(name, "cpu")
    with pytest.raises(ValueError, match=match):
        jmesh.get_mesh(name)
    if need is not None:
        assert "but 1 is running" in str(got.value)
    assert not dist.is_initialized()


def test_padded_index_matches_reference():
    """FlatIndex(pad_to=1024): n_padded, the −1 segment tail, densities and
    flatten / unflatten against the reference's padded index."""
    import jax
    from repro.core import flat as jflat
    from repro.launch.train import client_arch_pool as jarch_pool
    jcfg, jparams, params = _fixture()
    index = flat.FlatIndex(params, pad_to=1024)
    jindex = jflat.get_index(jparams, pad_to=1024)
    assert (index.n, index.n_padded, index.n_segments) == \
        (jindex.n, jindex.n_padded, jindex.n_segments) == \
        (2427136, 2427904, 39)
    np.testing.assert_array_equal(index.row_of, jindex.row_of)
    for a, b in zip(flat._segment_maps(index), jflat._segment_maps(jindex)):
        np.testing.assert_array_equal(a, b)
    assert (flat._segment_maps(index)[0][index.n:] == -1).all()
    buf = flat.flatten(index, params)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(
        jflat.flatten(jindex, jparams)))
    assert not buf[index.n:].any()
    back = flat.unflatten(index, buf)
    assert torch.equal(flat.flatten(index, back), buf)
    stacked = jax.tree.map(lambda a: np.stack([a, -a]), jparams)
    np.testing.assert_array_equal(
        flat.flatten_stacked(index, jax.tree.map(torch.from_numpy, stacked))
        .numpy(), np.asarray(jflat.flatten_stacked(jindex, stacked)))
    arch, jarch = train.client_arch_pool(CFG, "width")[0], \
        jarch_pool(jcfg, "width")[0]
    d, f = flat._density_and_fraction(CFG, index, arch.masks(CFG))
    jd, jf = jflat._density_and_fraction(jcfg, jindex, jarch.masks(jcfg))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    # a column range cut inside a leaf's rows gives the same densities
    cols = slice(1_000_003, 1_713_951)
    part, _ = flat._density_and_fraction(CFG, index, arch.masks(CFG),
                                         cols=cols)
    assert torch.equal(part, d[cols])


def test_pieces_cover_columns_once():
    """The pieces of any column range cover it exactly once, inert tail
    aside, each inside one segment row."""
    _, _, params = _fixture()
    index = flat.FlatIndex(params, pad_to=1024)
    seg_id = flat._segment_maps(index)[0]
    for lo, hi in [(0, index.n_padded), (0, 1213952), (1213952, 2427904),
                   (17, 40_000), (2427000, 2427904)]:
        hit = np.zeros(hi - lo, np.int64)
        for s0, k, rest, a, b in flat._pieces(index, slice(lo, hi)):
            assert b - a == k * rest
            hit[a:b] += 1
            np.testing.assert_array_equal(
                seg_id[lo + a:lo + b], np.repeat(np.arange(s0, s0 + k), rest))
        np.testing.assert_array_equal(hit, seg_id[lo:hi] >= 0)


def test_pad_rows_and_cohort_match_reference():
    from conftest import make_cohort
    from repro.core.server import stack_runtimes as jstack_runtimes
    from repro.sharding import cohort as jcsh
    jcfg, _, _ = _fixture()
    assert [csh.pad_rows(m, None) for m in (1, 3)] == [0, 0]
    specs, data = _cohort(M, malicious_frac=0.34)
    jspecs, jdata = make_cohort(jcfg, M, local_steps=E, malicious_frac=0.34)
    got, gb = csh.pad_cohort(stack_runtimes(CFG, specs, "cpu"), data(0)[1], 1)
    want, wb = jcsh.pad_cohort(jstack_runtimes(jcfg, jspecs), jdata(0)[1], 1)
    gm, wm = got[0], want[0]
    for f in ("d_model", "heads", "kv_heads", "d_ff"):
        np.testing.assert_array_equal(getattr(gm, f).numpy(),
                                      np.asarray(getattr(wm, f)))
    for a, b in zip(got[1:], want[1:]):
        if a is None:
            assert b is None
            continue
        np.testing.assert_array_equal(a.numpy().astype(np.float32),
                                      np.asarray(b).astype(np.float32))
    assert got[3].tolist()[-1] == 0 and not bool(got[5][-1])
    for k in gb:
        np.testing.assert_array_equal(gb[k].numpy(), np.asarray(wb[k]))


def _fake_mesh(shape, coord=(0, 0)):
    """A ``Mesh`` of ``shape`` seen from ``coord``, with no process groups:
    for the helpers that read only its shape."""
    return mesh_mod.Mesh(shape, coord, {}, torch.device("cpu"), "gloo",
                         False)


@pytest.mark.parametrize("shape", [(1, 1), (2, 1), (2, 2), (4, 2)])
def test_cohort_helpers_match_reference(shape):
    """Shard counts, ``pad_unit``, ``shardable`` and ``pad_rows`` against the
    reference's on an abstract mesh of the same shape; the rank's rows and
    columns tile the axes."""
    from jax.sharding import AbstractMesh
    from repro.sharding import cohort as jcsh
    jm = AbstractMesh(shape, ("data", "model"))
    m = _fake_mesh(shape)
    for f in ("data_shards", "model_shards", "pad_unit"):
        assert getattr(csh, f)(m) == getattr(jcsh, f)(jm), f
    for rows in range(1, 9):
        assert csh.shardable(m, rows) == jcsh.shardable(jm, rows)
        assert csh.pad_rows(rows, m) == jcsh.pad_rows(rows, jm)
    assert csh.pad_unit(None) == jcsh.pad_unit(None) == 1
    D, Mm = shape
    n = 1024 * Mm
    cols = [csh.model_cols(_fake_mesh(shape, (0, k)), n) for k in range(Mm)]
    rows = [csh.data_rows(_fake_mesh(shape, (d, 0)), 2 * D) for d in range(D)]
    assert [c.start for c in cols] == [k * n // Mm for k in range(Mm)]
    assert [r.start for r in rows] == [2 * d for d in range(D)]
    assert csh.model_cols(m, n + 1) == slice(0, n + 1)   # M does not divide


def test_async_snapshots_refused_with_a_mesh():
    """No rank of a mesh holds the whole pool, so ``on_merge`` raises."""
    _, _, params = _fixture()
    index = flat.FlatIndex(params)
    with pytest.raises(ValueError, match="on_merge"):
        AsyncEngine(flat.flatten(index, params), CFG, FLConfig(task="cls"),
                    index, ParitySource(lambda r: ([], {})),
                    acfg=AsyncConfig.parity(M), on_merge=print,
                    mesh=_fake_mesh((2, 1)))


def _grouped_case(dt, seed=3):
    """39 segments of 40..160 columns, monotone ids, a −1 tail to a
    multiple of 512: 2 groups of the multilevel search."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(40, 161, size=39)
    C = -(-int(lens.sum()) // 512) * 512
    seg = np.full(C, -1, np.int32)
    seg[:lens.sum()] = np.repeat(np.arange(39), lens)
    m = 3
    x = (rng.standard_normal((m, C)) * rng.uniform(0.1, 3, (m, 1))).astype(
        np.float32)
    x[:, seg < 0] = 0.0
    x[1, :50] = 0.0                                 # a tie-heavy segment
    q = rng.uniform(0.9, 1.0, (m, 39)).astype(np.float32)
    sc = None
    if dt == "int8":
        sc = rng.uniform(0.001, 0.02, (m, 39)).astype(np.float32)
        x = np.clip(np.round(x * 40), -127, 127).astype(np.int8)
    return x, seg, lens.astype(np.int32), q, sc


@pytest.mark.parametrize("dt", ["f32", "int8"])
def test_grouped_segmented_stats_match_reference(dt):
    """The plain path over 39 segments in 2 groups of the search against the
    reference's kernel in interpret mode: t bit-equal, ss at rtol 1e-5."""
    import jax
    import jax.numpy as jnp
    from repro.kernels.fedfa_quantile import multilevel as jml
    x, seg, lens, q, sc = _grouped_case(dt)
    assert len(multilevel.segment_groups(torch.from_numpy(seg), 39)) == 2
    t, ss = multilevel.segmented_trimmed_stats(
        torch.from_numpy(x), torch.from_numpy(seg),
        torch.from_numpy(lens).long(), torch.from_numpy(q),
        None if sc is None else torch.from_numpy(sc))
    jt, jss = jax.jit(functools.partial(jml.segmented_trimmed_stats,
                                        interpret=True))(
        jnp.asarray(x), jnp.asarray(seg), jnp.asarray(lens), jnp.asarray(q),
        scales=None if sc is None else jnp.asarray(sc))
    np.testing.assert_array_equal(t.numpy().view(np.uint32),
                                  np.asarray(jt).view(np.uint32))
    np.testing.assert_allclose(ss.numpy(), np.asarray(jss), rtol=1e-5)


def test_segment_groups_refuse_unordered_ids():
    seg = torch.tensor([0, 1, 38, 2] + [-1] * 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="must not decrease"):
        multilevel.segment_groups(seg, 39)
    assert multilevel.segment_groups(seg, 37) == [(0, 37, 0, 8)]


# ---------------------------------------------------------------------------
# spawned meshes
# ---------------------------------------------------------------------------

def _n_padded(shape):
    return 2427904 if shape == "2x2" else 2427136


def _expected_counts(shape, kind):
    """The aggregation's collectives, as ``accumulate_contract`` bounds
    them: no all-gather; with model shards and the kernel route, 4
    histogram all-reduces over ``model`` (one a level), no reduce-scatter
    and 2 N/M all-reduces over ``data``; ``use_kernel=False`` reduce-
    scatters whole rows over ``model`` instead; and one (S + 1,) all-reduce
    of the α mean's sums."""
    D, Mm = mesh_mod.parse_mesh_shape(shape)
    n, S, r = _n_padded(shape), 39, (M + 1) // D
    want = {f"all_reduce|data|{S + 1}": 1,
            f"all_reduce|data|{n // Mm}": 2}
    if Mm > 1 and kind != "off":
        want[f"all_reduce|model|{2 * r * 2 * S * 256}"] = 4
    elif Mm > 1:
        want[f"reduce_scatter|model|{n}"] = 2
    return want


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", ["f32", "int8", "off"])
def test_mesh_aggregation_collectives(runs, shape, kind):
    hist_cap = 2 * 2 * 2 * 39 * 256
    for o in runs[shape]:
        got = o[f"counts_{kind}"]
        assert got == _expected_counts(shape, kind)
        assert not any(k.startswith("all_gather") for k in got)
        n_m = _n_padded(shape) // mesh_mod.parse_mesh_shape(shape)[1]
        assert all(int(k.split("|")[2]) in (n_m,) or
                   int(k.split("|")[2]) <= hist_cap
                   for k in got if k.startswith("all_reduce"))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dt", ["f32", "int8"])
def test_mesh_thresholds_bit_equal(runs, shape, dt):
    """Every (real client, segment) threshold of the norms pass equals the
    unsharded path's bit for bit; Σw² too, against the unsharded run of the
    same search (the 2-D pass's segmented multilevel quantile on whole rows,
    whose exact integer planes the model shards' all-reduce sums to; the
    per-leaf path where the pass is not 2-D), and at rtol 1e-5 against the
    per-leaf path; the quantized rows and scales admitted on the mesh are
    the unsharded admission's bits."""
    ref = runs["ref"]
    t, ss = ("t", "ss") if dt == "f32" else ("tq", "ssq")
    same = f"{ss}_seg" if mesh_mod.parse_mesh_shape(shape)[1] > 1 else ss
    for o in runs[shape]:
        rows, cols = _rows_cols(shape, o["coord"], _n_padded(shape))
        real = slice(rows.start, min(rows.stop, M))
        k = real.stop - real.start
        np.testing.assert_array_equal(o[t][:k].numpy().view(np.uint32),
                                      ref[t][real].numpy().view(np.uint32))
        np.testing.assert_allclose(o[ss][:k].numpy(), ref[ss][real].numpy(),
                                   rtol=1e-5)
        np.testing.assert_array_equal(o[ss][:k].numpy().view(np.uint32),
                                      ref[same][real].numpy().view(np.uint32))
        if dt == "int8":
            n = ref["x_q"].shape[1]
            assert torch.equal(o["scales"][:k], ref["scales"][real])
            want = torch.zeros((k, cols.stop - cols.start), dtype=torch.int8)
            hi = min(cols.stop, n)
            want[:, :hi - cols.start] = ref["x_q"][real, cols.start:hi]
            assert torch.equal(o["x_q"][:k], want)
            assert not o["x_q"][:, max(n - cols.start, 0):].any()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", ["f32", "int8", "off"])
def test_mesh_aggregation_matches_unsharded(runs, shape, kind):
    """The merged global against the port's unsharded aggregation within 8
    ulp of the sums' magnitude, against the reference's at rtol 1e-4 /
    atol 1e-5; pad rows and the inert tail leave no trace."""
    ref, jref = runs["ref"], runs["jax"]
    base = "int8" if kind == "int8" else "f32"
    got = _global(runs[shape], f"g_{kind}")
    n = ref["g_f32"].shape[0]
    assert not got[n:].any()
    got = got[:n].numpy()
    want = ref[f"g_{base}"].numpy()
    tol = 8 * EPS * ref[f"scale_{base}"].numpy()
    err = np.abs(got - want)
    assert (err <= tol).all(), float((err / np.maximum(tol, 1e-30)).max())
    np.testing.assert_allclose(got, jref[f"g_{base}"], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("strategy", ["fedfa", "heterofl"])
def test_mesh_rounds_match_reference(runs, shape, strategy):
    """Two resident rounds of an m = 3 cohort with an attacker (one pad row
    on 2 data shards) against the reference's unsharded ``run_rounds``, and
    against the port's; the round's collectives: one all-gather of the
    global into training a round plus one at each eval boundary (none
    without model shards)."""
    jp, jl = runs["jax"][f"rounds_{strategy}"]
    mp_, ml = runs["ref"][f"rounds_{strategy}_f32"]
    D, Mm = mesh_mod.parse_mesh_shape(shape)
    for o in runs[shape]:
        p, losses, counts = o[f"rounds_{strategy}_f32"]
        np.testing.assert_allclose(losses, jl, rtol=1e-4)
        np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(p.numpy(), mp_.numpy(), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(losses, ml, rtol=1e-5)
        gathers = sum(c for k, c in counts.items()
                      if k.startswith("all_gather"))
        assert gathers == (2 * ROUNDS if Mm > 1 else 0)
        assert counts.get(f"all_reduce|data|{_n_padded(shape) // Mm}") == \
            2 * ROUNDS
        assert counts.get("all_reduce|data|2") == ROUNDS       # the loss


@pytest.mark.parametrize("shape", SHAPES)
def test_mesh_quantized_rounds_match_unsharded(runs, shape):
    """Two int8 resident rounds against the port's unsharded ones, at the
    quantized round test's flip allowance (round 1's last-bit differences
    may move a round-2 element across an admission step)."""
    from test_torch_quant import _steps, assert_round_close
    mp_, ml, scales = runs["ref"]["rounds_fedfa_int8"]
    steps = _steps(flat.FlatIndex(_fixture()[2]), mp_.numpy(), "int8",
                   scales)
    for o in runs[shape]:
        p, losses, _ = o["rounds_fedfa_int8"]
        np.testing.assert_allclose(losses, ml, rtol=1e-4)
        assert_round_close(p.numpy(), mp_.numpy(), steps,
                           f"{shape} int8 rounds")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dt", ["f32", "int8"])
def test_mesh_async_parity_merge_matches_unsharded(runs, shape, dt):
    """One parity-mode merge of the async engine (a padded pool of 4 rows
    for 3 slots) against the port's unsharded ``run_async``."""
    want, wl = runs["ref"][f"async_{dt}"]
    for o in runs[shape]:
        got, losses = o[f"async_{dt}"]
        np.testing.assert_allclose(losses, wl, rtol=1e-5)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_mesh_checkpoint_round_trip(runs, shape):
    """Written once, by rank 0, from the model-sharded global; restored onto
    every rank's slice bit for bit; the files are the unsharded format's,
    with no pad tail."""
    d = runs["dir"][shape]
    for o in runs[shape]:
        same, meta = o["ckpt"]
        assert same and meta["round"] == 1 and meta["flat_n"] == 2427136
    _, _, params = _fixture()
    tree, meta = ckpt_mod.restore(str(d / f"ckpt_{shape}"), params)
    index = flat.FlatIndex(tree)
    assert torch.equal(flat.flatten(index, tree),
                       runs[shape][0]["rounds_fedfa_f32"][0])
    spec = json.loads((d / f"ckpt_{shape}.json").read_text())
    want = json.loads((runs["dir"]["2x2"] / "ckpt_unsharded.json")
                      .read_text())
    assert spec["names"] == want["names"]
    with np.load(d / f"ckpt_{shape}.npz") as a, \
            np.load(runs["dir"]["2x2"] / "ckpt_unsharded.npz") as b:
        assert [(k, a[k].shape, a[k].dtype) for k in a.files] == \
            [(k, b[k].shape, b[k].dtype) for k in b.files]


@pytest.mark.parametrize("shape", SHAPES)
def test_mesh_cli_history_matches_unsharded(runs, shape):
    """``main(["--mesh-shape", shape, ...])``: every rank returns the
    unsharded run's history; only rank 0 writes ``--out``."""
    want = runs["ref"]["cli"]
    d = runs["dir"][shape]
    for r, o in enumerate(runs[shape]):
        got = o["cli"]
        assert got["round"] == want["round"]
        for k in ("loss", "round_loss"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4)
        assert got["global_acc"] == want["global_acc"]
        assert got["local_acc"] == want["local_acc"]
        assert (d / f"cli_{shape}_{r}.json").exists() == (r == 0)
