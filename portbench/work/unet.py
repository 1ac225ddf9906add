"""Work of the U-Net (ResNet-50 encoder) from its published shapes.

`sites(n, side)`: the stem (bf16), 16 bottleneck blocks (int8, one unit
each), the five up-blocks center..dec3 (int8), dec4 + dec5 (int8, one
unit, as the fused tail runs them) and the binary head's margin on the
output (bf16), for n buffered tiles of side x side. An up-block is a
nearest-2x upsample then a 3x3 conv: it counts two coarse taps per axis and
output parity (`up_macs`), what that function needs. The head's crop
(`overlap`) counts the margins of the output pixels only; the convs count
the whole buffered tile, which the model computes.
"""

from portbench.work import resnet
from portbench.work.common import Site, conv_macs, up_macs

NF = 32


def sites(n, side, overlap=0):
    out = [resnet.stem(n, side)]
    enc, grids = resnet.blocks(n, side)
    out += enc
    (h1, c1), (h2, c2), (h3, c3), (h4, c4) = grids
    ups = (("center", h4 // 2, c4, NF * 8), ("dec0", h4, c4 + NF * 8, NF * 8), ("dec1", h3, c3 + NF * 8, NF * 8),
           ("dec2", h2, c2 + NF * 8, NF * 2), ("dec3", h1, c1 + NF * 2, NF * 4))
    for name, h, cin, cout in ups:
        nbytes = 2 * n * (h * h * cin + 4 * h * h * cout) + 9 * cin * cout
        out.append(Site(name, "int8", 2 * up_macs(n, h, h, cin, cout), nbytes, "K5"))
    h = 2 * h1  # dec3's output grid, half the tile's side
    macs = up_macs(n, h, h, NF * 4, NF) + conv_macs(n, 2 * h, 2 * h, 3, NF, NF)
    crop = side - 2 * overlap
    nbytes = 2 * n * h * h * NF * 4 + n * crop * crop + 9 * (NF * 4 * NF + NF * NF)
    out.append(Site("dec4+dec5", "int8", 2 * macs, nbytes, "K6"))
    out.append(Site("head", "bf16", 2 * n * crop * crop * NF, 0, "K6"))
    return out


def train_flops(side):
    """Forward float operations of one training image of side x side: every
    site above at overlap 0, plus the 1x1 classifier to two classes."""
    return sum(s.ops for s in sites(1, side) if s.name != "head") + 2 * side * side * NF * 2
