"""Work of DeepLabv3+ (ResNet-50, output stride 16) from its published shapes.

`sites(n, side)`: the stem (bf16), the 16 bottleneck blocks (int8; layer4
at stride 1 and dilation 2, its 3x3 taps counted inside the grid), ASPP's
1x1 and its three 3x3 convs at rates 6, 12 and 18 (int8, only the taps
inside the 1/16 grid: at 36 x 36, 79.0%, 60.5% and 44.4% of the nine),
the pool branch and the low-level projection (bf16), ASPP's projection and
the decoder's two 3x3 convs (int8), and the binary head's margin at 1/4
resolution (bf16). The bilinear resizes are not counted.
"""

from portbench.work import resnet
from portbench.work.common import Site, conv_macs

RATES = (6, 12, 18)
CH, LOW = 256, 48


def sites(n, side, overlap=0):
    out = [resnet.stem(n, side)]
    enc, grids = resnet.blocks(n, side, dilate_last_stage=True)
    out += enc
    (h1, c1), _, _, (h4, c4) = grids

    def int8(name, h, k, cin, cout, d=1):
        nbytes = 2 * n * h * h * (cin + cout) + k * k * cin * cout
        return Site(name, "int8", 2 * conv_macs(n, h, h, k, cin, cout, dilation=d), nbytes, "rs_int8_conv")

    out.append(int8("aspp1", h4, 1, c4, CH))
    out += [int8("aspp_d{}".format(i), h4, 3, c4, CH, r) for i, r in enumerate(RATES)]
    out.append(Site("aspp_pool", "bf16", 2 * n * c4 * CH, 0, "torch"))
    out.append(int8("aspp_proj", h4, 1, 5 * CH, CH))
    out.append(Site("lowlevel", "bf16", 2 * conv_macs(n, h1, h1, 1, c1, LOW), 0, "torch"))
    out.append(int8("dec1", h1, 3, CH + LOW, CH))
    out.append(int8("dec2", h1, 3, CH, CH))
    out.append(Site("head", "bf16", 2 * n * h1 * h1 * CH, 0, "torch"))
    return out


def train_flops(side):
    """Forward float operations of one training image of side x side: every
    site above, the head as the 1x1 classifier to two classes."""
    h1 = side // 4
    return sum(s.ops for s in sites(1, side) if s.name != "head") + 2 * h1 * h1 * CH * 2
