"""The yardstick's arithmetic against hand counts."""
import math

import pytest

from bench import harness
from bench import traffic as tr
from bench import yardstick as ys
from bench.reference.config import ModelConfig

SMOLLM = ModelConfig.from_json(harness.load("configs", "smollm-135m")["model"])
MAMBA2 = ModelConfig.from_json(harness.load("configs", "mamba2-130m")["model"])
POOL = harness.load("traffic", "round")["population"]["arch_pool"]
B, S = 16, 512


def _smollm_by_hand(w, frac):
    """A smollm-135m client's local step, counted block by block."""
    D = 576 if w == 1.0 else int(w * 576) // 8 * 8
    K = max(1, round(w * 3))
    H, hd = 3 * K, 64
    F = 1536 if w == 1.0 else int(w * 1536) // 8 * 8
    layers = sum(math.ceil(frac * d) for d in (8, 8, 7, 7))
    bs = B * S
    qkvo = 2 * bs * D * (H + 2 * K) * hd + 2 * bs * H * hd * D
    scores = 2 * 2 * bs * (S / 2) * H * hd
    ffn = 3 * 2 * bs * D * F
    head = 2 * bs * D * 49152
    return 3 * (layers * (qkvo + scores + ffn) + head)


def _mamba2_by_hand(w, frac):
    D = 768 if w == 1.0 else int(w * 768) // 8 * 8
    di, nh, N, Q, hp = 2 * D, 2 * D // 64, 128, 256, 64
    layers = sum(math.ceil(frac * d) for d in (6, 6, 6, 6))
    bs, nc = B * S, S // Q
    block = (2 * bs * D * (2 * di + 2 * N + nh) + 2 * bs * (di + 2 * N) * 4
             + B * nc * nh * (2 * Q * Q * N + 2 * Q * Q * hp + 2 * Q * N * hp)
             + B * nc * nh * 2 * Q * N * hp + 2 * bs * di * D)
    return 3 * (layers * block + 2 * bs * D * 50304)


@pytest.mark.parametrize("w,frac", POOL)
@pytest.mark.parametrize("cfg,hand", [(SMOLLM, _smollm_by_hand),
                                      (MAMBA2, _mamba2_by_hand)],
                         ids=["smollm-135m", "mamba2-130m"])
def test_client_flops_match_hand_count(cfg, hand, w, frac):
    depths = tuple(max(1, math.ceil(frac * d))
                   for d in cfg.max_section_depths())
    assert ys.client_step_flops(cfg, w, depths, B, S) == \
        pytest.approx(hand(w, frac), rel=1e-12)


def test_smallest_smollm_client_in_numbers():
    # d_model 144, 3 q heads over 1 kv head, d_ff 384, 16 of 30 blocks
    assert ys.client_step_flops(SMOLLM, 0.25, (4, 4, 4, 4), B, S) == \
        3 * (16 * (1_207_959_552 + 1_610_612_736 + 2_717_908_992)
             + 115_964_116_992)


def test_population_depths_are_the_pools():
    pop = tr.population(SMOLLM, harness.load("traffic", "round")["population"],
                        7)
    assert {d for _, d, _ in pop} <= {
        tuple(max(1, math.ceil(f * d)) for d in (8, 8, 7, 7))
        for _, f in POOL}


@pytest.mark.parametrize("kernel,shape,dtype,work,want", [
    ("hist_level", (16, 1000, 24), "f32", "bytes",
     16 * 1000 * 4 + 16 * 2 * 256 * 12),
    ("hist_level", (16, 1000, 16), "f32", "bytes", 16 * 2 * 256 * 12),
    ("hist_level", (16, 1000, 24), "int8", "bytes",
     16 * 1000 + 16 * 2 * 256 * 12),
    ("quantile_fused", (10, 100), "f32", "bytes", 4000 + 10 * 4 * 3),
    ("quantile_fused", (10, 100), "int8", "bytes", 1000 + 10 * 4 * 4),
    ("scaled_accum", (16, 1000), "f32", "bytes", 64_000 + 4_000 + 64),
    ("quant_accum", (16, 1000), "int8", "bytes", 16_000 + 4_000),
    ("scaled_accum", (16, 1000), "f32", "flops", 32_000),
    ("quant_accum", (16, 1000), "int8", "flops", 32_000),
    ("hist_level", (16, 1000, 24), "f32", "flops", 0),
])
def test_kernel_work_matches_hand_count(kernel, shape, dtype, work, want):
    nbytes, flops = ys.kernel_spec(kernel).required(shape, dtype)
    assert {"bytes": nbytes, "flops": flops}[work] == want


def test_every_kernel_yardstick_names_its_device_functions():
    shapes = {"hist_level": (2, 8, 24)}
    for path in (ys.BENCH / "kernels").glob("*.py"):
        spec = ys.kernel_spec(path.stem)
        assert spec.DEVICE_NAMES and all(spec.DEVICE_NAMES)
        assert ys.kernel_least_ms(path.stem, shapes.get(path.stem, (2, 8)),
                                  "f32") > 0


def test_a_kernel_without_a_yardstick_is_named():
    with pytest.raises(ValueError, match="bench/kernels/flash_attention.py"):
        ys.kernel_spec("flash_attention")


def test_merge_bytes_and_least_time():
    assert ys.merge_bytes(1000, 16, "f32", 10) == 72_000
    assert ys.merge_bytes(1000, 16, "int8", 10) == 72_000 + 2 * (16_000 + 640)
    # bytes bound: 3.35e9 bytes take 1 ms; 67e9 flops take 1 ms
    assert ys.least_ms(3.35e9, 1.0, 67e12) == pytest.approx(1.0)
    assert ys.least_ms(1.0, 67e9, 67e12) == pytest.approx(1.0)


def test_spread_uses_statistics_quartiles():
    vals = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    # statistics.quantiles (exclusive): Q1 10.75, Q3 14.25, median 12.5
    assert ys.spread(vals) == pytest.approx(3.5 / 12.5)
