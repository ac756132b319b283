"""The port's tracer (``repro_torch.tracing``) over resident rounds of the
4-layer fixture on the CPU: nothing is recorded without a recording, a
recording leaves the round's bits alone, and the span tree, units, client
slots, host clocks and the ``host_syncs`` counter are what the round and
the merge do."""
import contextlib

import jax
import numpy as np
import pytest
import torch

from conftest import fl_round_fixture
from repro_torch import tracing
from repro_torch.core import flat
from repro_torch.core.round import ResidentDriver
from repro_torch.core.server import FLConfig, make_client_specs
from repro_torch.data import partition, pipeline, synthetic
from repro_torch.kernels.fedfa_quantile import multilevel
from repro_torch.launch import train
from repro_torch.models.model import params_from_numpy

torch.set_num_threads(2)

JCFG, JPARAMS = fl_round_fixture()
CFG = train.fl_config("smollm-135m", "cls", 10, full_size=False)
E, M = 2, 3


def _round(update_dtype="f32", malicious_frac=0.0, unit=None):
    """(loss, new global) of one resident round from the fixture's
    parameters; with ``unit``, inside a recording whose unit it is."""
    params = params_from_numpy(jax.tree.map(np.asarray, JPARAMS), CFG, "cpu")
    specs = make_client_specs(CFG, M,
                              archs=train.client_arch_pool(CFG, "width"),
                              malicious_frac=malicious_frac, seed=0)
    parts = partition.iid_partition(M, 10, seed=0)
    b = pipeline.round_batches_cls(
        parts, list(range(M)), 10, CFG.vocab_size, local_steps=E, batch=2,
        seq_len=8, profiles=synthetic.make_class_profiles(10, CFG.vocab_size,
                                                          seed=0), seed=100)
    batches = {k: torch.as_tensor(v, dtype=torch.int64) for k, v in b.items()}
    perms = (torch.stack([torch.randperm(batches["labels"][0].numel(),
                                         generator=torch.Generator()
                                         .manual_seed(i)) for i in range(M)])
             if malicious_frac else None)
    fl = FLConfig(local_steps=E, lr=0.05, strategy="fedfa", task="cls",
                  update_dtype=update_dtype)
    index = flat.FlatIndex(params)
    g = flat.flatten(index, params)
    driver = ResidentDriver(CFG, fl, index, "cpu")
    if unit is None:
        return driver.round(g, specs, batches, perms), g
    rec = tracing.start("cpu")
    try:
        rec.unit = unit
        loss = driver.round(g, specs, batches, perms)
    finally:
        tracing.stop()
    return loss, g, rec


@contextlib.contextmanager
def _recording():
    rec = tracing.start("cpu")
    try:
        yield rec
    finally:
        tracing.stop()


def test_no_recording_records_nothing(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("recorded with no recording on")
    monkeypatch.setattr(tracing, "Span", refuse)
    monkeypatch.setattr(tracing.Recording, "add", refuse)
    assert tracing.active() is None
    assert tracing.span("round") is tracing.span("aggregate")
    loss, _ = _round()
    assert torch.isfinite(loss)


def test_recording_leaves_the_round_bit_equal():
    loss0, g0 = _round()
    loss1, g1, rec = _round(unit=5)
    assert rec.spans
    assert torch.equal(loss0, loss1) and torch.equal(g0, g1)


def _by_name(rec):
    out = {}
    for s in rec.spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_span_tree_of_an_f32_round():
    _, _, rec = _round(unit=7)
    spans = _by_name(rec)
    parent = {"round": None, "round/runtimes": "round", "train": "round",
              "train/client": "train", "train/client/start": "train/client",
              "train/step/fwd_bwd": "train/client",
              "train/step/update": "train/client",
              "train/client/pack": "train/client", "aggregate": "round",
              "aggregate/densities": "aggregate",
              "aggregate/graft": "aggregate", "aggregate/norms": "aggregate",
              "aggregate/accumulate": "aggregate"}
    calls = {"train/client": M, "train/client/start": M,
             "train/client/pack": M, "train/step/fwd_bwd": M * E,
             "train/step/update": M * E}
    assert set(spans) <= set(parent) | {"aggregate/norms/multilevel"}
    assert set(parent) <= set(spans)
    assert "admit" not in spans
    for name, ss in spans.items():
        assert len(ss) == calls.get(name, len(ss))
        if name not in calls and name != "aggregate/norms/multilevel":
            assert len(ss) == 1, name
        for s in ss:
            assert s.unit == 7
            want = parent.get(name, "aggregate/norms")
            assert (s.parent.name if s.parent else None) == want, name
            assert s.t0 <= s.t1
            if s.parent is not None:
                assert s.parent.t0 <= s.t0 and s.t1 <= s.parent.t1, name
            assert s.stream_ms() >= 0
    clients = [s.client for s in spans["train/client"]]
    assert clients == list(range(M))
    for name in ("train/client/start", "train/step/fwd_bwd",
                 "train/step/update", "train/client/pack"):
        assert [s.client for s in spans[name]] == sorted(
            c for c in range(M) for _ in range(calls[name] // M))
    assert spans["round"][0].client is None
    tree = rec.tree()
    assert tree["train/step/fwd_bwd"]["calls"] == M * E
    assert tree["train/client"]["parent"] == "train"


@pytest.mark.parametrize("malicious_frac", [0.0, 0.34])
def test_host_syncs_one_per_client(malicious_frac):
    _, _, rec = _round(malicious_frac=malicious_frac, unit=2)
    assert rec.per_unit_count(tracing.HOST_SYNCS) == {2: M}
    assert rec.tree()["train/client/pack"]["counts"] == {
        tracing.HOST_SYNCS: M}


def test_int8_round_admits_and_does_not_graft():
    _, _, rec = _round(update_dtype="int8", unit=0)
    spans = _by_name(rec)
    assert [s.parent.name for s in spans["admit"]] == ["round"]
    assert "aggregate/graft" not in spans
    assert {"aggregate/densities", "aggregate/norms",
            "aggregate/accumulate"} <= set(spans)


@pytest.mark.parametrize("S,reads", [(multilevel.MAX_SEGMENTS, 0),
                                     (multilevel.MAX_SEGMENTS + 3, 2)])
def test_segment_groups_reads_count(S, reads):
    g = torch.Generator().manual_seed(0)
    seg_len = torch.full((S,), 5, dtype=torch.int64)
    seg_id = torch.repeat_interleave(torch.arange(S, dtype=torch.int32), 5)
    x = torch.randn((2, 5 * S), generator=g)
    q = torch.full((2, S), 0.9)
    with _recording() as rec:
        rec.unit = 1
        t, ss = multilevel.segmented_trimmed_stats(x, seg_id, seg_len, q,
                                                   use_kernel=False)
    assert rec.per_unit_count(tracing.HOST_SYNCS) == ({1: reads} if reads
                                                      else {})
    (s,) = rec.spans
    assert s.name == "aggregate/norms/multilevel" and s.parent is None
    want = multilevel.segmented_trimmed_stats(x, seg_id, seg_len, q,
                                              use_kernel=False)
    assert torch.equal(t, want[0]) and torch.equal(ss, want[1])


def test_counts_outside_spans_and_one_recording_at_a_time():
    with _recording() as rec:
        rec.unit = 3
        tracing.count("x", 2)
        with tracing.span("a"):
            tracing.count("x")
        with pytest.raises(RuntimeError):
            tracing.start("cpu")
    assert rec.per_unit_count("x") == {3: 3}
    assert tracing.active() is None
    with pytest.raises(RuntimeError):
        tracing.stop()


def test_profile_busy_is_the_union_of_kernel_intervals():
    from repro_torch.launch.profile import _busy_us
    assert _busy_us([(0, 10), (5, 12), (20, 25), (21, 22)]) == 17
    assert _busy_us([]) == 0
