"""The copied arithmetic: the ResNet-34 step's FLOPs and the flash head's
work."""

import pytest

from portbench.arith import flash_aam, peaks, resnet


def test_resnet34_train_step_flops():
    f = resnet.train_flops("resnet34", 40, 200, 256, 7325, 256)
    assert f == pytest.approx(3.48030959616e12, rel=1e-12)
    assert resnet.train_flops("resnet34", 40, 200, 256, 500000, 256) == pytest.approx(
        f + 3 * 2.0 * 256 * 256 * (500000 - 7325), rel=1e-12)


def test_conv_geometry_resnet34():
    convs = resnet.conv_geometry("resnet34", 40, 200)
    assert len(convs) == 1 + 2 * (3 + 4 + 6 + 3) + 3
    assert convs[-1].c_out == 256 and (convs[-1].h_out, convs[-1].w_out) == (5, 25)
    assert resnet.fc1_in("resnet34", 40) == 2560


def test_flash_work():
    B, C, D = 256, 500000, 256
    f, b = flash_aam.fwd_work(B, C, D)
    assert f == 2.0 * B * C * D
    assert b == 4.0 * (B * D + C * D) + 8 * B + 4 * B + 16 * B
    f2, b2 = flash_aam.bwd_work(B, C, D)
    assert f2 == 3 * f
    assert b2 == 8.0 * (B * D + C * D) + 8 * B + 8 * B
    # forward bound by W's bytes, backward by operations, at 256 x 500,000 x 256
    assert flash_aam.fwd_least_s(B, C, D) == pytest.approx(b / peaks.HBM_BYTES)
    assert flash_aam.bwd_least_s(B, C, D) == pytest.approx(f2 / peaks.TF32_FLOPS)
    assert flash_aam.fwd_least_s(B, C, D) * 1e3 == pytest.approx(0.1529, abs=1e-4)
    assert flash_aam.bwd_least_s(B, C, D) * 1e3 == pytest.approx(0.3972, abs=1e-4)
