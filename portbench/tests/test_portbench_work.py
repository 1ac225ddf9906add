"""The work counts of portbench/work against counts made by hand."""

import pytest

from portbench.work import common, deeplabv3plus, resnet, unet


def test_resnet50_encoder_macs_at_224():
    # torchvision's ResNet-50 (stride in the 3x3 conv): 4.09 GMAC with its
    # 2048 x 1000 classifier. Taps in the zero padding are not counted here:
    # ~2 of 3 taps an axis at each border, ~18% of layer4's 3x3 at 7 x 7,
    # about 4% of the whole.
    enc = [resnet.stem(1, 224)] + resnet.blocks(1, 224)[0]
    macs = sum(s.ops for s in enc) / 2
    full = 4.09e9 - 2048 * 1000
    assert 0.95 * full < macs < full


@pytest.mark.parametrize("rate,share", [(6, 0.790), (12, 0.605), (18, 0.444)])
def test_aspp_taps_inside_the_36_grid(rate, share):
    assert common.axis_taps(36, 3, 1, rate) ** 2 / (9 * 36 * 36) == pytest.approx(share, abs=5e-4)


def test_up_block_counts_two_coarse_taps_per_axis_and_parity():
    # 2 x 2 input: each output parity reads 2 coarse rows, one of them
    # outside the grid at the border: 2 * (2 * 2 - 1) per axis.
    assert common.up_macs(1, 2, 2, 1, 1) == 6 * 6
    assert common.axis_taps(4, 3) == 3 * 4 - 2  # a 3x3 SAME conv loses one tap at each end


@pytest.mark.parametrize("site,side,bound_ms", [("center", 9, 0.0055), ("dec3", 144, 0.1099)])
def test_k5_bounds_of_the_kernel_table(site, side, bound_ms):
    # PERF.md's kernel table at batch 8 of 576-px tiles counts all 16 taps
    # of a coarse pixel; in the grid there are (4h - 2) / 4h of them an axis.
    s = next(s for s in unet.sites(8, 576, 32) if s.name == site)
    inside = ((4 * side - 2) / (4 * side)) ** 2
    assert s.bound_s() * 1e3 == pytest.approx(bound_ms * inside, rel=0.01)


def test_k6_bound_of_the_kernel_table():
    s = next(s for s in unet.sites(8, 576, 32) if s.name == "dec4+dec5")
    assert s.bound_s() * 1e3 == pytest.approx(0.0687, rel=0.01)


def test_deeplab_aspp_bounds_of_the_kernel_table():
    sites = {s.name: s for s in deeplabv3plus.sites(8, 576, 32)}
    for name, bound_ms in (("aspp_d0", 0.0391), ("aspp_d1", 0.0299), ("aspp_d2", 0.0220)):
        assert sites[name].bound_s() * 1e3 == pytest.approx(bound_ms, rel=0.01)


def test_every_site_is_counted_once_per_tile():
    one, eight = unet.sites(1, 576, 32), unet.sites(8, 576, 32)
    assert sum(s.ops for s in eight) == 8 * sum(s.ops for s in one)
    assert [s.unit for s in one].count("K3") == 13 and [s.unit for s in one].count("K4") == 3
    assert [s.unit for s in one].count("K5") == 5
    assert sum(s.unit == "rs_int8_conv" for s in deeplabv3plus.sites(1, 576)) == 7
