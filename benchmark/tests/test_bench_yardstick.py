"""The yardstick's counts against hand-worked values."""

import json

import pytest

from benchmark import yardstick as y
from conftest import ROOT

DEC = json.loads((ROOT / "benchmark/configs/config3_chairs_joint.json")
                 .read_text())["ad"]["decoder"]
DEN = json.loads((ROOT / "benchmark/configs/config4_conditional.json")
                 .read_text())["diff"]["denoiser"]


def test_decoder_plan():
    assert y.decoder_layers(DEC) == [
        (259, 512, False), (512, 512, False), (512, 512, False),
        (512, 253, False), (512, 512, True), (512, 512, False),
        (512, 512, False), (512, 512, False), (512, 1, False)]


def test_forward_macs_a_point():
    # 259*512 + 2*512*512 + 512*253 + 4*512*512 + 512
    assert y.decoder_macs_per_point(DEC) == 1_835_520


def test_train_step_flops():
    fwd, hid = y.decoder_point_macs(DEC)
    assert 2 * fwd + hid == 4_717_056
    flops = y.train_step_flops(DEC, 64, 16_384)
    assert flops == 2 * (64 * 16_384 * 4_717_056 + 3 * 64 * 2 * 256 * 512)
    assert flops == pytest.approx(9.892e12, rel=1e-3)
    assert flops / y.PEAK_BF16_FLOPS * 1e3 == pytest.approx(10.00, abs=0.01)


def test_eval_counts():
    assert y.eval_macs_per_point(DEC) == 1_835_520 - 2 * 256 * 512
    assert y.hier3_points(0, 0, 0, 256) == 16 ** 3
    assert y.hier3_points(10, 20, 30, 256) == 4096 + 640 + 160 + 240


def test_bounds():
    # operations bound: 2^20 points of the 8x512 eval at 989 TFLOP/s
    ms, kind = y.bound(1 << 20, y.eval_macs_per_point(DEC), 0)
    assert kind == "operations"
    assert ms == pytest.approx(2 * 1_573_376 * 2 ** 20 / 989e12 * 1e3)
    ms, kind = y.gemm_bound(1 << 20, 512, 512, 4 << 20 << 9, 2 << 20 << 9)
    assert kind == "bytes"
    # #3 and #3b at 2^20 rows: 7 layers 512 wide and one 253 wide, 12 B an
    # element
    rows = 1 << 20
    want = (12 * rows * (7 * 512 + 253) + 8 * (7 * 512 + 253)) / 3.35e12
    assert y.relu_dropout_bound_ms(DEC, rows) == pytest.approx(want * 1e3)


def test_denoiser_flops():
    H, T, L, P = 1024, 128, 256, 512
    first = T * H + L * H + 4 * 64 * P
    rest = H * H + H * L + 6 * 2 * H * H + 256 * H + (64 * 128 + 128 * 256) * P
    assert y.denoiser_step_flops(DEN, 128) == 2 * 128 * (2 * first + 3 * rest)
