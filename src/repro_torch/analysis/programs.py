"""The canonical program set for ``python -m repro_torch.analysis check``.

Runs the programs whose structure the port's invariants live on — the
resident round (``core.round.flat_round``, on a 4 x 1 data mesh and a
2 x 2 (data, model) mesh), its quantized form, the standalone
aggregation (``core.flat.aggregate_buffers``), the async engine's
admission (``AsyncEngine._materialize``/``_admit``, f32 and int8) and
merge (``AsyncEngine._merge``), the fused and multilevel trimmed-quantile
passes and the distributed one (``core.flat._cohort_stats(mesh=)``) —
each recorded as it runs (``analysis.dispatch``), and evaluates each
against the contract its OWN module declares, under the reference's
names.

The meshes are groups of 4 ``torch.distributed`` ranks over gloo, spawned
by ``spawn_meshes`` through ``launch.mesh``; on the card every
rank runs on ``cuda:0``.  ``canonical_reports(meshes=False)`` runs the
same programs in one process without a mesh (the contracts' one-device
forms), as ``chip_smoke.py`` does on the card.

The fixture is the reference's (``repro.analysis.programs._fixture``): the
reduced smollm-135m with 4 layers, 2 sections, vocab 64 and untied
embeddings, m = 3 clients or a pool of capacity 3, one local step of
batch 2 and sequence 8.  Contracts are about program STRUCTURE, which
does not depend on the shapes beyond the mesh's divisibility.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import tempfile
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.analysis.contracts import Report
from repro_torch.analysis.dispatch import Recorder, Run
from repro_torch.analysis.passes import run_in_place

TRIM = 0.95
MESHES = ("4x1", "2x2")


def _fixture(m: int, local_steps: int = 1, batch: int = 2,
             seq_len: int = 8, seed: int = 0, device="cpu"):
    """(cfg, fl, params, specs, batches) of the reference's fixture, the
    tensors on ``device``."""
    from repro_torch.configs import get_arch
    from repro_torch.core.server import FLConfig, make_client_specs
    from repro_torch.data import partition, pipeline, synthetic
    from repro_torch.launch.train import client_arch_pool
    from repro_torch.models.model import init_params
    from repro_torch.tree import tree_map

    n_classes = 10
    cfg = get_arch("smollm-135m").reduced().replace(
        n_layers=4, n_sections=2, vocab_size=64, tie_embeddings=False)
    params = tree_map(lambda a: a.to(device), init_params(
        cfg, torch.Generator().manual_seed(seed)))
    specs = make_client_specs(cfg, m, archs=client_arch_pool(cfg, "width"),
                              seed=seed)
    parts = partition.iid_partition(m, n_classes, seed=seed)
    profiles = synthetic.make_class_profiles(n_classes, cfg.vocab_size,
                                             seed=seed)
    b = pipeline.round_batches_cls(
        parts, list(range(m)), n_classes, cfg.vocab_size,
        local_steps=local_steps, batch=batch, seq_len=seq_len,
        profiles=profiles, seed=100)
    batches = {k: torch.as_tensor(v, dtype=torch.int64, device=device)
               for k, v in b.items()}
    # use_kernel None: the kernels on the card, their plain versions on
    # the CPU (the port's interpret mode), the structure the contracts pin
    fl = FLConfig(local_steps=local_steps, lr=0.05, strategy="fedfa",
                  task="cls", agg_engine="flat")
    return cfg, fl, params, specs, batches


def _index(params, mesh):
    from repro_torch.core import flat
    from repro_torch.sharding import cohort as csh
    return flat.FlatIndex(params, pad_to=csh.pad_unit(mesh))


def _global(index, params, mesh):
    """This rank's slice of the flat global (all of it without a mesh)."""
    from repro_torch.core import flat
    from repro_torch.sharding import cohort as csh
    return flat.flatten(index, params)[
        csh.model_cols(mesh, index.n_padded)].clone()


def _rows(index, rows: int, device, seed: int = 1) -> torch.Tensor:
    """(rows, n_padded) seeded normal rows, zero on the inert tail."""
    rng = np.random.default_rng(seed)
    x = np.zeros((rows, index.n_padded), np.float32)
    x[:, :index.n] = rng.standard_normal((rows, index.n), np.float32)
    return torch.as_tensor(x, device=device)


def _ops(mesh):
    return [] if mesh is None else list(mesh.ops)


def _clear(mesh) -> None:
    if mesh is not None:
        mesh.ops.clear()
        mesh.counts.clear()


def _checked(contract, run: Run, rec: Recorder) -> Report:
    """``contract.check(run)``, with the kernel calls ``rec`` saw (each a
    launch on the card) beside the measured values."""
    rep = contract.check(run)
    rep.measured["kernel_calls"] = dict(sorted(rec.counts.kernels.items()))
    return rep


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


# -- the programs ------------------------------------------------------------

def round_report(mesh=None, m: int = 3, device="cpu") -> Report:
    """One resident round (``flat_round``) on this rank: checks its
    declared contract (buffers held in place, no full-cohort gather,
    data-only mesh: zero all-gathers and >= 1 N-sized all-reduce)."""
    from repro_torch.core import round as round_mod
    from repro_torch.core.server import stack_runtimes
    from repro_torch.sharding import cohort as csh

    cfg, fl, params, specs, batches = _fixture(m, device=device)
    index = _index(params, mesh)
    rows = m + csh.pad_rows(m, mesh)
    g = _global(index, params, mesh)
    c = torch.zeros((rows // csh.data_shards(mesh), index.n_padded),
                    device=device)
    runtimes = stack_runtimes(cfg, specs, device)
    _clear(mesh)
    args = (g, c, cfg, fl, index, runtimes, batches, None, None, mesh)
    _, rec, held = run_in_place(round_mod.flat_round, args)
    return _checked(round_mod.round_contract(index, mesh, rows=rows),
                    rec.run(ops=_ops(mesh), in_place=held), rec)


def quant_round_report(mesh=None, m: int = 3, device="cpu") -> Report:
    """One QUANTIZED resident round (int8 admission with per-segment
    scales and server-side error feedback) and ``quantized_round_contract``:
    every resident buffer held in place, zero all-gathers, the peak
    budget — plus the read-once, sort-free structure of the fused
    dequantize-accumulate, measured on ``accumulate_quant`` alone over
    (rows, N) int8 rows (the whole round touches row-sized f32 buffers in
    training, so the kernel's invariant is pinned where it lives, as the
    reference pins it)."""
    from repro_torch.core import flat
    from repro_torch.core import round as round_mod
    from repro_torch.core.server import stack_runtimes
    from repro_torch.kernels.fedfa_agg import ops as agg_ops
    from repro_torch.sharding import cohort as csh

    cfg, fl, params, specs, batches = _fixture(m, device=device)
    fl = dataclasses.replace(fl, update_dtype="int8")
    index = _index(params, mesh)
    rows = m + csh.pad_rows(m, mesh)
    r = rows // csh.data_shards(mesh)
    cols = flat.pool_cols(index, mesh, fl.use_kernel)
    g = _global(index, params, mesh)
    c = torch.zeros((r, index.n_padded), device=device)
    state = round_mod.fresh_quant_state(index, r, "int8", device,
                                        cols.stop - cols.start)
    runtimes = stack_runtimes(cfg, specs, device)
    _clear(mesh)
    args = (g, c, cfg, fl, index, runtimes, batches, None, state, mesh)
    _, rec, held = run_in_place(round_mod.flat_round, args)

    x_q = torch.zeros((rows, index.n_padded), dtype=torch.int8,
                      device=device)
    seg = flat._device_seg_id(index, device)
    with Recorder(row_elems=x_q.numel(), inputs=(x_q,), sweep=False) as acc:
        agg_ops.accumulate_quant(
            x_q, torch.ones(rows, device=device),
            torch.ones((rows, index.n_segments), device=device), seg,
            torch.ones(index.n_padded, device=device))
    run = Run(counts=acc.counts, row_elems=acc.row_elems, ops=_ops(mesh),
              memory=rec.memory, in_place=held)
    rep = _checked(round_mod.quantized_round_contract(index, mesh, rows=rows),
                   run, rec)
    rep.measured["reads_kernel_calls"] = dict(acc.counts.kernels)
    return rep


def agg_report(mesh=None, m: int = 3, device="cpu") -> Report:
    """The aggregation path alone (``aggregate_buffers``) on this rank's
    rows and global slice, and the ``accumulate`` contract: zero
    all-gathers, partial sums capped at N/n_model per all-reduce with
    model shards, no reduce-scatter."""
    from repro_torch.core import flat
    from repro_torch.core.fedfa import STRATEGIES
    from repro_torch.core.server import stack_runtimes
    from repro_torch.kernels.fedfa_agg import ops as agg_ops
    from repro_torch.sharding import cohort as csh

    cfg, fl, params, specs, _ = _fixture(m, device=device)
    index = _index(params, mesh)
    rows = m + csh.pad_rows(m, mesh)
    runtimes, _ = csh.pad_cohort(stack_runtimes(cfg, specs, device), {},
                                 rows - m)
    here = csh.data_rows(mesh, rows)
    masks, gates, gmaps, nd, _, _ = (csh.rows_of(t, here) for t in runtimes)
    x = _rows(index, rows, device)[here].contiguous()
    g = _global(index, params, mesh)
    _clear(mesh)
    with Recorder(inputs=(g, x, masks, gates, gmaps, nd)) as rec:
        flat.aggregate_buffers(index, g, x, cfg, masks, gates, gmaps, nd,
                               trim=TRIM, use_kernel=fl.use_kernel,
                               mesh=mesh, **STRATEGIES["fedfa"])
    return _checked(agg_ops.accumulate_contract(
        index.n_padded, mesh, rows=rows, segs=index.n_segments),
        rec.run(ops=_ops(mesh)), rec)


def _engine(mesh, capacity: int, update_dtype: str, device):
    """(engine, index, specs, batches) of a pool of ``capacity`` slots
    (padded to the data shards), every slot dispatched — the pad slots
    with the engine's weightless pad spec, as the reference's admit writes
    every row — and not yet trained."""
    from repro_torch.core.async_round import AsyncConfig, AsyncEngine
    from repro_torch.sharding import cohort as csh

    cfg, fl, params, specs, batches = _fixture(capacity, device=device)
    fl = dataclasses.replace(fl, update_dtype=update_dtype)
    index = _index(params, mesh)
    eng = AsyncEngine(_global(index, params, mesh), cfg, fl, index,
                      source=None, acfg=AsyncConfig(capacity=capacity,
                                                    merge_k=capacity),
                      mesh=mesh)
    pad = eng.rows - capacity
    slots = np.arange(eng.rows)
    eng.pool.admit(slots[:capacity], specs, np.zeros(capacity), 0.0, 0)
    eng._ensure_cbuf()
    eng._pending = (slots, list(specs) + [eng._pad_spec] * pad,
                    csh.pad_leading(batches, pad), 0)
    return eng, index


def resident_buffers(eng) -> tuple:
    """An async engine's resident buffers in the reference's parameter
    order: (g_buf, pool) or (g_buf, x_q, scales, e, e_scales) — the
    positions its contracts' ``donated`` name."""
    pool = eng._c_buf if isinstance(eng._c_buf, tuple) else (eng._c_buf,)
    return (eng.g_buf,) + tuple(pool)


def record_admission(eng, mesh=None, sweep: bool = True):
    """Record the admission of the engine's pending dispatch group
    (``_materialize``); returns (recorder, in-place positions of
    ``resident_buffers``)."""
    _clear(mesh)
    _, rec, held = run_in_place(lambda *res: eng._materialize(),
                                resident_buffers(eng), sweep=sweep)
    return rec, held


def record_merge(eng, mesh=None, sweep: bool = True):
    """Record one merge of the rows ready now (``_merge``); returns
    (recorder, in-place positions of ``resident_buffers``)."""
    _clear(mesh)
    _, rec, held = run_in_place(
        lambda *res: eng._merge(eng.pool.ready(eng.now)),
        resident_buffers(eng), sweep=sweep)
    return rec, held


def admit_report(mesh=None, capacity: int = 3, device="cpu") -> Report:
    """One admission into the pool (``AsyncEngine._materialize`` over
    ``_admit``) and its contract: the pool never gathered, the pool held
    in place."""
    from repro_torch.core import async_round
    eng, index = _engine(mesh, capacity, "f32", device)
    rec, held = record_admission(eng, mesh)
    return _checked(async_round.admit_contract(index, mesh, rows=eng.rows),
                    rec.run(ops=_ops(mesh), in_place=held), rec)


def quant_admit_report(mesh=None, capacity: int = 3,
                       device="cpu") -> Report:
    """One QUANTIZED admission (train, error feedback, quantize, write the
    slots' four pieces back) and ``quantized_admit_contract``: all four
    pool pieces held in place, zero all-gathers, no sort anywhere in the
    run."""
    from repro_torch.core import async_round
    eng, index = _engine(mesh, capacity, "int8", device)
    rec, held = record_admission(eng, mesh)
    return _checked(async_round.quantized_admit_contract(
        index, mesh, rows=eng.rows),
        rec.run(ops=_ops(mesh), in_place=held), rec)


def merge_report(mesh=None, capacity: int = 3, device="cpu") -> Report:
    """One bounded-staleness merge (``AsyncEngine._merge``) over a pool
    the admission filled, and its contract: zero all-gathers, g_buf held
    in place."""
    from repro_torch.core import async_round
    eng, index = _engine(mesh, capacity, "f32", device)
    eng._materialize()
    rec, held = record_merge(eng, mesh)
    return _checked(async_round.merge_contract(index, mesh, rows=eng.rows),
                    rec.run(ops=_ops(mesh), in_place=held), rec)


def _quantile_report(contract, fn, rows, q) -> Report:
    with Recorder(row_elems=rows.numel(), inputs=(rows, q)) as rec:
        fn(rows, q)
    return _checked(contract, rec.run(ops=[]), rec)


def quantile_reports(m: int = 4, r: int = 8, length: int = 512,
                     trim: float = TRIM, device="cpu") -> List[Report]:
    """Run the trimmed-norm paths and check their contracts.  Three
    fixtures, the reference's: the (m, r, length) row block (fused = 1 row
    read / 0 sorts, the plain sort-based version = its pinned reads and
    1 sort), a non-dividing (3, 7, 500) block (``quantile/fused-pad`` /
    ``quantile/topk-pad``), and a row of 2^18 + 512 elements, past the
    single-pass limit, that must take the multilevel kernel
    (``quantile/multilevel``: still 1 read site / 0 sorts)."""
    from repro_torch.core import flat
    from repro_torch.kernels.fedfa_quantile import multilevel as q_ml
    from repro_torch.kernels.fedfa_quantile import ops as q_ops
    from repro_torch.kernels.fedfa_quantile import ref as q_ref

    def sorted_path(rows, q):
        mm, R, L = rows.shape
        _, ss = q_ref.row_trimmed_stats_ref(rows.reshape(mm * R, L),
                                            torch.repeat_interleave(q, R))
        return torch.sqrt(ss)

    def fused(rows, q):
        _, sq = flat._rows_trimmed_stats(rows, q)
        return torch.sqrt(sq)

    out = []
    rng = np.random.default_rng(0)
    for shape, padded in (((m, r, length), False), ((3, 7, 500), True)):
        rows = torch.as_tensor(rng.standard_normal(shape, np.float32),
                               device=device)
        q = torch.full((shape[0],), 1.0 - (1.0 - trim) * 0.5,
                       device=device)
        block_bytes = rows.numel() * rows.element_size()
        for contract, fn in (
                (q_ops.fused_quantile_contract(block_bytes, padded=padded),
                 fused),
                (q_ops.topk_tail_contract(block_bytes, padded=padded),
                 sorted_path)):
            out.append(_quantile_report(contract, fn, rows, q))

    long_rows = torch.as_tensor(
        rng.standard_normal((2, (1 << 18) + 512), np.float32), device=device)
    ql = torch.full((2,), 1.0 - (1.0 - trim) * 0.5, device=device)
    out.append(_quantile_report(q_ml.multilevel_quantile_contract(
        long_rows.numel() * long_rows.element_size()),
        q_ops.row_trimmed_stats, long_rows, ql))
    return out


def dist_quantile_report(mesh, m: int = 4, trim: float = TRIM,
                         device="cpu") -> Report:
    """The distributed trimmed-norm pass on this rank's (m/D, N/M) slice
    (``_cohort_stats`` with ``cols``) and
    ``distributed_quantile_contract``: the local slice read at one site,
    0 sorts, ZERO gathers or re-layout collectives, and every all-reduce
    within the histogram planes — never O(N)."""
    from repro_torch.core import flat
    from repro_torch.kernels.fedfa_quantile import multilevel as q_ml
    from repro_torch.sharding import cohort as csh

    _, _, params, _, _ = _fixture(m, device=device)
    index = _index(params, mesh)
    rows = m + csh.pad_rows(m, mesh)
    cols = csh.model_cols(mesh, index.n_padded)
    xm = _rows(index, rows, device)[csh.data_rows(mesh, rows), cols] \
        .contiguous()
    fracs = torch.full((xm.shape[0], len(index.leaves)), 0.75,
                       device=device)
    _clear(mesh)
    with Recorder(row_elems=xm.numel(), inputs=(xm, fracs)) as rec:
        flat._cohort_stats(index, xm, fracs, trim, mesh=mesh, cols=cols)
    return _checked(q_ml.distributed_quantile_contract(
        xm.shape[0], index.n_segments, xm.numel() * xm.element_size()),
        rec.run(ops=_ops(mesh)), rec)


# -- the canonical set -------------------------------------------------------

# (mesh, label, contract-table position, build) of the mesh programs
_MESH_PROGRAMS: Tuple[Tuple[str, str, int, Callable], ...] = (
    ("4x1", "round (data mesh)", 0, round_report),
    ("2x2", "round (2x2 mesh)", 1, round_report),
    ("4x1", "quantized round (data mesh)", 2, quant_round_report),
    ("4x1", "aggregation (data mesh)", 3, agg_report),
    ("2x2", "aggregation (2x2 mesh)", 4, agg_report),
    ("4x1", "async admit (data mesh)", 5, admit_report),
    ("4x1", "quantized admit (data mesh)", 6, quant_admit_report),
    ("4x1", "async merge (data mesh)", 7, merge_report),
    ("2x2", "async merge (2x2 mesh)", 8, merge_report),
    ("2x2", "distributed quantile (2x2 mesh)", 14, dist_quantile_report))

# the programs that run in one process without a mesh
_SINGLE_PROGRAMS = (("round", round_report),
                    ("quantized round", quant_round_report),
                    ("aggregation", agg_report),
                    ("async admit", admit_report),
                    ("quantized admit", quant_admit_report),
                    ("async merge", merge_report))


def mesh_reports(mesh, device="cpu",
                 progress: Callable[[str], None] = lambda s: None
                 ) -> Dict[int, Report]:
    """{table position: Report} of every mesh program of ``mesh``'s shape,
    run on this rank."""
    shape = "x".join(str(s) for s in mesh.shape)
    out = {}
    for where, label, pos, build in _MESH_PROGRAMS:
        if where == shape:
            progress(f"running {label} ...")
            out[pos] = build(mesh, device=device)
            _sync(device)
    return out


def _mesh_rank(rank: int, shape: str, workdir: str, device: str) -> None:
    """One rank of a spawned mesh: its reports, pickled under
    ``workdir``."""
    import datetime
    import torch.distributed as dist
    from repro_torch.launch.mesh import get_mesh, parse_mesh_shape
    torch.set_num_threads(1)
    D, M = parse_mesh_shape(shape)
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/{shape}",
                            rank=rank, world_size=D * M,
                            timeout=datetime.timedelta(seconds=300))
    try:
        reports = mesh_reports(get_mesh(shape, device), device)
        with open(os.path.join(workdir, f"{shape}_{rank}.pkl"), "wb") as fh:
            pickle.dump(reports, fh)
    finally:
        dist.destroy_process_group()


def merge_ranks(per_rank: List[Report]) -> Report:
    """One report of a program from its ranks': rank 0's measurements,
    and every rank's violations (other ranks' named)."""
    first = per_rank[0]
    violations = list(first.violations) + [
        f"rank {r}: {v}" for r, rep in enumerate(per_rank[1:], start=1)
        for v in rep.violations]
    return Report(contract=first.contract, measured=first.measured,
                  violations=violations, blame=first.blame)


def spawn_meshes(device="cpu", shapes=MESHES):
    """Start the 4-rank meshes (all at once); returns (workdir, contexts)
    for ``collect_meshes``."""
    import torch.multiprocessing as mp
    from repro_torch.launch.mesh import parse_mesh_shape
    workdir = tempfile.mkdtemp(prefix="repro_analysis_")
    ctxs = {}
    for shape in shapes:
        D, M = parse_mesh_shape(shape)
        ctxs[shape] = mp.start_processes(
            _mesh_rank, args=(shape, workdir, str(device)), nprocs=D * M,
            join=False, start_method="spawn")
    return workdir, ctxs


def collect_meshes(workdir: str, ctxs) -> Dict[int, Report]:
    """Wait for the spawned meshes; {table position: Report}, each the
    merge of its ranks'.  Any rank's failure raises."""
    import shutil
    from repro_torch.launch.mesh import parse_mesh_shape
    try:
        for ctx in ctxs.values():
            while not ctx.join(timeout=600):
                pass
        out: Dict[int, Report] = {}
        for shape in ctxs:
            D, M = parse_mesh_shape(shape)
            ranks = []
            for r in range(D * M):
                with open(os.path.join(workdir, f"{shape}_{r}.pkl"),
                          "rb") as fh:
                    ranks.append(pickle.load(fh))
            for pos in ranks[0]:
                out[pos] = merge_ranks([rk[pos] for rk in ranks])
        return out
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def canonical_reports(progress: Callable[[str], None] = lambda s: None,
                      device="cpu", meshes: bool = True) -> List[Report]:
    """Every contract of the canonical program set, in table order.  With
    ``meshes`` the 10 mesh programs run on two spawned 4-rank meshes
    (4 x 1 and 2 x 2) while this process runs the 5 quantile programs:
    the reference's 15 contracts.  Without, the 6 mesh programs that have
    a one-device form run here without a mesh, then the 5 quantile
    programs (11 contracts)."""
    if not meshes:
        out = []
        for label, build in _SINGLE_PROGRAMS:
            progress(f"running {label} ...")
            out.append(build(None, device=device))
            _sync(device)
        progress("running the quantile paths ...")
        return out + quantile_reports(device=device)
    progress(f"spawning the {' and '.join(MESHES)} meshes ...")
    workdir, ctxs = spawn_meshes(device)
    progress("running the quantile paths ...")
    quantile = quantile_reports(device=device)
    by_pos = collect_meshes(workdir, ctxs)
    for pos, rep in zip(range(9, 14), quantile):
        by_pos[pos] = rep
    return [by_pos[pos] for pos in sorted(by_pos)]


def cache_checks(device="cpu") -> List[Tuple[str, List[str]]]:
    """The run-time pass results for the check CLI: (pass name, violation
    messages) pairs — empty messages means PASS."""
    from repro_torch.analysis import passes
    from repro_torch.core import round as round_mod
    from repro_torch.launch.mesh import Mesh

    cfg, fl, params, _, _ = _fixture(3, device=device)
    index = _index(params, None)

    def stand_in(shape):
        """A mesh's shape without a process group: what pool keys read."""
        return Mesh(shape, (0, 0), {}, torch.device(device), "gloo", False)

    # key discrimination: within one driver every cohort size that pads
    # differently and every admission dtype must key a DISTINCT pool; on
    # a data mesh m = 3 and m = 4 pad alike and share one by design
    variants = []
    for mesh_name, mesh in (("no mesh", None),
                            ("data mesh", stand_in((4, 1))),
                            ("2x2 mesh", stand_in((2, 2)))):
        for dt in ("f32", "bf16", "int8"):
            drv = round_mod.ResidentDriver(
                cfg, dataclasses.replace(fl, update_dtype=dt), index,
                device, mesh)
            for m in (3, 4, 5):
                rows, _ = drv.pool_key(m)
                variants.append((f"{mesh_name}: {rows} rows, {dt}",
                                 (mesh_name,) + drv.pool_key(m)))
    collisions = passes.check_cache_keys(variants)

    # pool audit: a rebuilt, equal configuration must HIT the pool; an
    # int8 cohort of the same size must NOT
    drv = round_mod.ResidentDriver(cfg, fl, index, device)
    audit = []
    with passes.PoolAuditor(drv) as aud:
        drv.pool(3)
        drv.fl = dataclasses.replace(fl)
        drv.pool(3)
        drv.fl = dataclasses.replace(fl, update_dtype="int8")
        drv.pool(3)
    if aud.allocs != 2:
        audit.append(f"expected 2 pool allocations (f32, int8), got "
                     f"{aud.report()}: a key over- or under-discriminates")
    if aud.hits != 1:
        audit.append(f"expected 1 pool hit (the rebuilt f32 config), got "
                     f"{aud.report()}")
    audit += passes.audit_pools(drv)
    return [("pool-key discrimination", collisions),
            ("pool audit (rebuilt config, int8 vs f32)", audit)]
