"""Resident FedFA rounds: ``repro_torch.core.round.ResidentDriver.round``,
the CLI's main path, on the LM task.

Set-up draws the population, every round's cohort and local batches, and
the global weights from the seed, and drives the first ``checked_rounds``
rounds through the driver the window then goes on with.  The window runs
rounds back to back; ``round_ms`` is its time over the rounds it holds.
After it, with the program's state freed, the plain reference follows the
checked rounds from the same inputs and the run compares each round's
loss, the first round's client updates as the server receives them
(per client and leaf, the norm of the model's change within the client's
width), the global's change after the first round (per leaf, the worst)
and after the checked rounds (the median leaf: a leaf whose values lie
close together, as Mamba-2's D does, passes a rounding-level difference
through the trimmed norm's selection into α, and later rounds carry it
to every leaf of small change).

The checked rounds are as many as the numbers the cell's limits name
reach: ``loss1``, ``update`` and ``change1`` are read at round 1, ``loss``
and ``change`` at the traffic's ``checked_rounds``."""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from bench import traffic as tr
from bench import yardstick as ys
from bench.entries import common
from bench.reference import fl as ref_fl
from bench.reference import model as md
from bench.reference.config import ModelConfig


def inputs(h, cfg: ModelConfig) -> Dict[str, object]:
    t = h.traffic
    members = tr.population(cfg, t["population"], h.seed)
    ids = tr.cohorts(len(members), t["cohort"], t["pool_rounds"], h.seed)
    toks = tr.lm_tokens(cfg.vocab_size, ids, t["local_steps"], t["batch"],
                        t["seq_len"], h.seed)
    return {"members": members, "ids": ids,
            "tokens": torch.as_tensor(toks, device=h.device)}


# the round at which each number is read; the others at the last checked
ROUND_OF = {"loss1": 1, "update": 1, "change1": 1}


def checked_rounds(h) -> int:
    """The rounds set-up drives and the reference follows: up to the last
    one that a number the cell's limits name is read at."""
    last = h.traffic["checked_rounds"]
    return max(ROUND_OF.get(k, last) for k in h.limits)


def round_flops(cfg: ModelConfig, t: dict, members, sel) -> float:
    """FLOPs the round's clients' sub-models require: local steps of each
    client at its own width and depth."""
    return sum(t["local_steps"] * ys.client_step_flops(
        cfg, members[c][0], members[c][1], t["batch"], t["seq_len"])
        for c in sel)


def run(h) -> None:
    from repro_torch.core import flat
    from repro_torch.core import round as rnd
    from repro_torch.core import server

    t, dev = h.traffic, h.device
    cfg = ModelConfig.from_json(h.config["model"])
    arch = common.program_config(h.config["model"])
    data = inputs(h, cfg)
    members, ids, toks = data["members"], data["ids"], data["tokens"]
    index, g_buf = common.program_weights(cfg, common.weights(cfg, h.seed,
                                                              dev))
    fl = server.FLConfig(participation=t["cohort"] / len(members),
                         local_steps=t["local_steps"], lr=t["lr"],
                         strategy=t["strategy"], task="lm", trim=t["trim"],
                         update_dtype=t.get("update_dtype", "f32"))
    driver = rnd.ResidentDriver(arch, fl, index, dev)
    specs = common.program_specs(members)
    P, K = len(ids), checked_rounds(h)
    losses: List[float] = []

    def one(r: int) -> None:
        sel = ids[r % P]
        loss = driver.round(g_buf, [specs[i] for i in sel],
                            {"tokens": toks[r % P]})
        losses.append(float(loss))          # waits for the round's end

    # set-up: the checked rounds, through the window's own call and feed
    g0 = g_buf.clone()
    one(0)
    start = common.width_masked(cfg, g0, [members[i] for i in ids[0]])
    upd_prog = common.leaf_norms(cfg, driver.pool(t["cohort"])[0] - start)
    del start
    change1_prog = common.leaf_norms(cfg, g_buf - g0)
    for r in range(1, K):
        one(r)
    change_prog = common.leaf_norms(cfg, g_buf - g0)
    del g0

    if h.trace:
        h.spans.wrap(rnd, "cohort_update", "train")
        h.spans.wrap(flat, "aggregate_buffers", "aggregate")
        h.spans.wrap(flat, "admit_quantized", "admit")
    # the profiler starts at round 1 and profiles round 2: round 0 stays
    # untraced, so a traced run has spans to read however slow its rounds
    h.window(lambda i: one(K + i), stretch_at=2,
             stretch_len=t["traced_rounds"])
    h.spans.unwrap()
    h.memory_peak = common.peak(dev)
    window_losses = losses[K:]
    h.failed = sum(not np.isfinite(v) for v in window_losses)
    h.e2e["round_ms"] = h.window_s / h.attempted * 1e3
    h.work.update(
        unit_flops=[round_flops(cfg, t, members, ids[(K + i) % P])
                    for i in range(h.attempted)],
        client_steps=t["cohort"] * t["local_steps"])

    del driver, g_buf, toks
    common.free(dev)
    t0 = time.perf_counter()
    ref = reference(cfg, t, data, h.seed, dev, K)
    h.diag["check_s"] = time.perf_counter() - t0
    h.checks.update(numbers(ref, losses[:K], upd_prog, change1_prog,
                            change_prog))


def numbers(ref: dict, losses, update, change1, change) -> Dict[str, float]:
    """The numbers a round cell may compare (its ``limits`` name those it
    does), the program's (or a planted variant's) readings against the
    reference's: ``loss`` the worst round's loss, ``loss1`` the first
    round's."""
    gaps = [abs(p - r) / abs(r) for p, r in zip(losses, ref["losses"])]
    return {"loss": max(gaps), "loss1": gaps[0],
            "update": common.norm_gap(update, ref["update"]),
            "change1": common.norm_gap(change1, ref["change1"]),
            "change": common.median_gap(change, ref["change"])}


def reference(cfg: ModelConfig, t: dict, data, seed: int, dev, rounds: int,
              *, tf32: bool = False, half_batch: bool = False,
              order: str = "clients") -> dict:
    """``rounds`` rounds in the plain reference, from the seed's weights:
    round losses, the first round's per-(client, leaf) update norms and
    the global's per-leaf change after the first and the last round.
    ``tf32`` and ``half_batch`` plant the lower-precision control and the
    half-batch fault; ``order`` is the order of the merge's sums
    (``fl.aggregate``)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        members, ids = data["members"], data["ids"]
        toks = torch.as_tensor(data["tokens"][:rounds], device=dev)
        if half_batch:
            toks = toks[:, :, :, :toks.shape[3] // 2]
        g0 = common.weights(cfg, seed, dev)
        g = md.unflatten(cfg, g0.clone())
        clients = [ref_fl.Client(cfg, w, d, n, dev) for w, d, n in members]
        losses, update = [], None
        for r in range(rounds):
            sel = ids[r]
            ups, ls = [], []
            for slot, c in enumerate(sel):
                p, lo = ref_fl.local_update(g, cfg, clients[c],
                                            toks[r, slot], t["lr"])
                ups.append(p)
                ls.append(torch.mean(lo))
            losses.append(float(torch.mean(torch.stack(ls))))
            if r == 0:
                x = torch.empty((len(sel), g0.shape[0]), device=dev)
                for slot, p in enumerate(ups):
                    md.flatten(cfg, p, x[slot])
                update = common.leaf_norms(cfg, x - common.width_masked(
                    cfg, g0, [members[i] for i in sel]))
                del x
            g = ref_fl.aggregate(g, ups, [clients[c] for c in sel],
                                 t["trim"], order=order)
            del ups
            if r == 0:
                change1 = common.leaf_norms(
                    cfg, md.flatten(cfg, g, torch.empty_like(g0)) - g0)
        gK = md.flatten(cfg, g, torch.empty_like(g0))
        return {"losses": losses, "update": update, "change1": change1,
                "change": common.leaf_norms(cfg, gK - g0)}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
