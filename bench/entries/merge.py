"""The server's merge of a cohort of client models already on the device:
``repro_torch.core.flat.aggregate_buffers`` on the (m, N) f32 cohort, or
with a quantized ``update_dtype`` ``flat.admit_quantized`` (graft,
densities, quantization with server-side error feedback kept across
merges) and then ``aggregate_buffers`` on the admitted rows.

Set-up draws the population, two cohorts and their uploads (the global
plus a perturbation, zero outside each client's width and depth), and
runs the first ``checked_merges`` merges, the cohorts in turn, keeping
what each produced.  The window merges back to back, the global chained
from merge to merge; a merge is timed from its start to the new global on
the device.  One merge of the window, drawn from the seed, also keeps its
input state and its result.  After the window, with the program's state
freed, the plain reference redoes the checked merges from the seed's
weights and the drawn merge from its input state, and the run compares
the new global (and, quantized, the admitted rows and the residual)."""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

from bench import traffic as tr
from bench import yardstick as ys
from bench.entries import common
from bench.reference import fl as ref_fl
from bench.reference import model as md
from bench.reference.config import ModelConfig

UPLOAD_STREAM = 10
SAMPLE_STREAM = 11
INT_QMAX = {"int8": 127, "int4": 7}


def inputs(h, cfg: ModelConfig, g: torch.Tensor) -> Dict[str, object]:
    t = h.traffic
    members = tr.population(cfg, t["population"], h.seed)
    ids = tr.cohorts(len(members), t["cohort"], 2, h.seed)
    cohorts = [[members[i] for i in row] for row in ids]
    return {"members": members, "ids": ids, "cohorts": cohorts,
            "uploads": [tr.uploads(cfg, g, c, t["sigma"], h.seed,
                                   UPLOAD_STREAM + k)
                        for k, c in enumerate(cohorts)]}


def run(h) -> None:
    from repro_torch.core import flat
    from repro_torch.core import round as rnd
    from repro_torch.core import server
    from repro_torch.core.fedfa import STRATEGIES

    t, dev = h.traffic, h.device
    dtype = t["update_dtype"]
    cfg = ModelConfig.from_json(h.config["model"])
    arch = common.program_config(h.config["model"])
    g_seed = common.weights(cfg, h.seed, dev)
    data = inputs(h, cfg, g_seed)
    index, g_buf = common.program_weights(cfg, g_seed)
    del g_seed
    xs = data["uploads"]
    runtimes = [server.stack_runtimes(arch, common.program_specs(c), dev)
                for c in data["cohorts"]]
    kw = dict(STRATEGIES[t["strategy"]], trim=t["trim"])
    qstate = (None if dtype == "f32" else
              rnd.fresh_quant_state(index, t["cohort"], dtype, dev))

    def merge(k: int) -> None:
        masks, gates, gmaps, nd = runtimes[k][:4]
        if qstate is None:
            g_new = flat.aggregate_buffers(index, g_buf, xs[k], arch, masks,
                                           gates, gmaps, nd, **kw)
        else:
            flat.admit_quantized(index, arch, xs[k], masks, gmaps,
                                 bool(kw.get("graft", False)), qstate, dtype)
            g_new = flat.aggregate_buffers(index, g_buf, qstate[0], arch,
                                           masks, gates, gmaps, nd,
                                           scales=qstate[1], pregrafted=True,
                                           **kw)
        g_buf.copy_(g_new)
        h.sync()

    def snapshot():
        return (g_buf.clone(), None if qstate is None
                else tuple(s.clone() for s in qstate))

    # set-up: the checked merges, through the window's own call
    K = t["checked_merges"]
    checked = []
    for j in range(K):
        merge(j % 2)
        checked.append(snapshot())
    sample = int(tr.rng(h.seed, SAMPLE_STREAM).integers(t["sample_before"]))
    sampled: List[tuple] = []

    def step(i: int) -> float:
        if i == sample:
            sampled.append(snapshot())
        h.sync()
        ts = time.perf_counter()
        merge((K + i) % 2)
        own = time.perf_counter() - ts
        if i == sample:
            sampled.append(snapshot())
        return own

    if h.trace:
        h.spans.wrap(flat, "aggregate_buffers", "aggregate")
        h.spans.wrap(flat, "admit_quantized", "admit")
    lat = h.window(step, stretch_at=t["sample_before"],
                   stretch_len=t["traced_merges"], min_units=sample + 1)
    h.spans.unwrap()
    h.memory_peak = common.peak(dev)
    h.e2e["merge_rate"] = t["cohort"] * h.attempted / h.window_s
    h.e2e["merge_p95_ms"] = common.p95(lat) * 1e3
    h.work.update(unit_bytes=ys.merge_bytes(index.n, t["cohort"], dtype,
                                            index.n_segments),
                  unit_flops=4.0 * t["cohort"] * index.n, update_dtype=dtype)

    del xs, qstate, runtimes, g_buf
    data["uploads"] = None
    common.free(dev)
    (g_in, st_in), (g_out, st_out) = sampled
    del sampled
    t0 = time.perf_counter()
    compare(h, cfg, data, checked, (g_in, st_in, (K + sample) % 2,
                                    g_out, st_out))
    h.diag["check_s"] = time.perf_counter() - t0


def fresh_state(cfg: ModelConfig, m: int, n: int, dev) -> List[torch.Tensor]:
    """Zero quantized state [q, scales, e, e_scales] of the reference: the
    quantized values as int8, their scales f32."""
    S = sum(lead for *_, lead, _, _ in md.leaf_layout(cfg))
    return [torch.zeros((m, n), dtype=torch.int8, device=dev),
            torch.zeros((m, S), device=dev),
            torch.zeros((m, n), dtype=torch.int8, device=dev),
            torch.zeros((m, S), device=dev)]


def reference_merge(cfg: ModelConfig, t: dict, g: torch.Tensor,
                    x: torch.Tensor, clients, state: Optional[list], *,
                    variant: str = "") -> torch.Tensor:
    """One merge in the plain reference: the new (N,) global from g (N,)
    and the uploads x (m, N); quantized, admits into ``state`` in place
    first.  ``variant`` plants the control: "bf16" merges in bfloat16,
    "int4" admits at 4 bits."""
    if state is not None:
        ref_fl.admit(cfg, x, clients, state,
                     INT_QMAX["int4" if variant == "int4" else "int8"])
        x = ref_fl.dequantize(cfg, state[0], state[1])
    dt = torch.bfloat16 if variant == "bf16" else torch.float32
    gd = md.unflatten(cfg, g.to(dt))
    xd = x.to(dt)
    ups = [md.unflatten(cfg, xd[c]) for c in range(x.shape[0])]
    new = ref_fl.aggregate(gd, ups, clients, t["trim"],
                           pregrafted=state is not None)
    del ups, xd, x
    return md.flatten(cfg, {k: v.float() for k, v in new.items()},
                      torch.empty_like(g))


def quant_gap(cfg: ModelConfig, prog, ref, qi: int, si: int) -> float:
    """Worst per-(client, leaf) ‖prog − ref‖ / max(‖ref‖, the median's) of
    the dequantized values ``state[qi]`` with scales ``state[si]``,
    dequantized a leaf at a time."""
    err, size_of = [], []
    seg = 0
    for _, _, off, size, lead, rest, _ in md.leaf_layout(cfg):
        def deq(st):
            m = st[qi].shape[0]
            return st[qi][:, off:off + size].view(m, lead, rest).float() \
                * st[si][:, seg:seg + lead, None]
        dp, dr = deq(prog), deq(ref)
        err.append(torch.linalg.vector_norm((dp - dr).flatten(1), dim=1))
        size_of.append(torch.linalg.vector_norm(dr.flatten(1), dim=1))
        seg += lead
    err, size_of = torch.stack(err, 1), torch.stack(size_of, 1)
    if not torch.isfinite(err).all():
        return float("inf")
    med = float(torch.median(size_of))
    return float(torch.max(err / torch.clamp_min(size_of, max(med, 1e-30))))


def compare(h, cfg: ModelConfig, data, checked, sampled) -> None:
    """The numbers: per-leaf error of the new global as a share of the
    change the reference makes; quantized, also of the dequantized
    admitted rows and residual as a share of their own size."""
    t, dev, seed = h.traffic, h.device, h.seed
    quant = t["update_dtype"] != "f32"
    clients = [[ref_fl.Client(cfg, w, d, n, dev) for w, d, n in c]
               for c in data["cohorts"]]
    g0 = common.weights(cfg, seed, dev)

    def uploads(k):
        return tr.uploads(cfg, g0, data["cohorts"][k], t["sigma"], seed,
                          UPLOAD_STREAM + k)

    state = (fresh_state(cfg, t["cohort"], g0.shape[0], dev) if quant
             else None)
    gaps = {"global": 0.0, "rows": 0.0, "residual": 0.0}

    def judge(g_in, g_ref, st_ref, g_prog, st_prog):
        gaps["global"] = max(gaps["global"],
                             common.diff_gap(cfg, g_prog, g_ref, g_in))
        if quant:
            gaps["rows"] = max(gaps["rows"],
                               quant_gap(cfg, st_prog, st_ref, 0, 1))
            gaps["residual"] = max(gaps["residual"],
                                   quant_gap(cfg, st_prog, st_ref, 2, 3))

    g = g0
    for j in range(len(checked)):
        g_prog, st_prog = checked[j]
        checked[j] = None
        g_new = reference_merge(cfg, t, g, uploads(j % 2), clients[j % 2],
                                state)
        judge(g, g_new, state, g_prog, st_prog)
        del g_prog, st_prog
        g = g_new
    del state
    g_in, st_in, k, g_out, st_out = sampled
    state = [s.clone() for s in st_in] if quant else None
    g_new = reference_merge(cfg, t, g_in, uploads(k), clients[k], state)
    judge(g_in, g_new, state, g_out, st_out)
    h.checks["global"] = gaps["global"]
    if quant:
        h.checks["rows"] = gaps["rows"]
        h.checks["residual"] = gaps["residual"]
