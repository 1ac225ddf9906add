"""Work of the ResNet-50 encoder, per block, from its published shapes."""

from portbench.work.common import Site, conv_macs, out_hw

STAGES = ((3, 64), (4, 128), (6, 256), (3, 512))


def stem(n, side):
    """The 7x7/2 stem conv (3 -> 64) on side x side input, bf16."""
    return Site("stem", "bf16", 2 * conv_macs(n, side, side, 7, 3, 64, stride=2), n * side * side * 3, "stem")


def blocks(n, side, dilate_last_stage=False):
    """One int8 Site per bottleneck block (conv1, conv2, conv3 and the
    projection), bf16 input and output activations, int8 kernels; the
    encoder's input grid is side / 4. Returns (sites, grid and channels of
    each stage's output)."""
    h, cin = side // 4, 64
    sites, outs = [], []
    for si, (count, mid) in enumerate(STAGES):
        cout = mid * 4
        for bi in range(count):
            dilated = dilate_last_stage and si == 3
            stride = 2 if (bi == 0 and si > 0 and not dilated) else 1
            d = 2 if dilated else 1
            ho = out_hw(h, stride)
            macs = conv_macs(n, h, h, 1, cin, mid) + conv_macs(n, h, h, 3, mid, mid, stride, d)
            macs += conv_macs(n, ho, ho, 1, mid, cout)
            weights = cin * mid + 9 * mid * mid + mid * cout
            if bi == 0:
                macs += conv_macs(n, h, h, 1, cin, cout, stride)
                weights += cin * cout
            nbytes = 2 * n * (h * h * cin + ho * ho * cout) + weights
            sites.append(Site("layer{}.{}".format(si + 1, bi), "int8", 2 * macs, nbytes, "K4" if stride == 2 else "K3"))
            h, cin = ho, cout
        outs.append((h, cout))
    return sites, outs
