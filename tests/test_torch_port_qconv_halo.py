"""The host side of rs_int8_conv's halo route (models/qconv.py), on the CPU.

csrc/qconv.cu runs a stride-1 3x3 conv of dilation 1 or 2 on
int8_conv_sm90.cuh's halo_conv_kernel and every other conv on conv_kernel.
The kernel itself runs only on the card (tests/test_torch_port_cuda.py
holds it bit-equal to `int8_conv_plain`); here:

- `packed_tap_slabs` unpacks to `wq` exactly, its padding zero, at the
  fast family's twelve (Cin, Cout) and at ragged widths;
- `route` sends the nine stride-1 sites to the halo kernel and down2, down3
  and down4 to conv_kernel, `fastnet.DENSE_SITES` is the walk's own
  (stride, dilation) per site, and `prepare_int8` packs each site for its
  route;
- `halo_plan` and `halo_origin` agree with a brute-force enumeration of
  the input pixels each output tile reads: the tiles cover every output
  pixel once, and each tile's reads lie in its halo and reach all four of
  its sides (with "SAME" padding, with (2, 2) at dilation 2, on ragged,
  1 x W and H x 1 grids).
"""

import itertools

import numpy as np
import pytest
import torch

from robosat_tpu_torch.models import fastnet, qconv, qenc
from robosat_tpu_torch.models import int8 as q8

# (Cin, Cout) of the fast family's twelve dense sites, in walk order.
FAST_WIDTHS = {"stem": (48, 128), "b1": (128, 128), "down2": (128, 128), "b2": (128, 128), "down3": (128, 256),
               "b3": (256, 256), "down4": (256, 256), "b4a": (256, 256), "b4b": (256, 256), "d3": (384, 128),
               "d2": (256, 128), "d1": (256, 128)}


def _node(cin, cout, seed=0):
    rng = np.random.default_rng(seed)
    return {"wq": torch.from_numpy(rng.integers(-127, 128, (3, 3, cin, cout), dtype=np.int8))}


def _unpack(wpt, cin, cout, bn):
    """packed_tap_slabs' rows back to the padded (3, 3, Cin_pad, Cout_pad) kernel."""
    chunks, tiles_n = -(-cin // 64), -(-cout // bn)
    slabs = wpt.reshape(tiles_n, chunks, 2, 9, bn // 8, 2, 8, 16)
    # (tile_n, chunk, half, tap, row // 8, k // 16, row % 8, k % 16)
    # -> (tap, chunk, half, k // 16, k % 16, tile_n, row // 8, row % 8)
    return slabs.permute(3, 1, 2, 5, 7, 0, 4, 6).reshape(3, 3, chunks * 64, tiles_n * bn)


@pytest.mark.parametrize("cin,cout", sorted(set(FAST_WIDTHS.values())) + [(48, 80), (96, 16), (80, 48), (16, 96)])
def test_packed_tap_slabs_unpack_to_wq(cin, cout):
    node = _node(cin, cout)
    wpt = qconv.packed_tap_slabs(node)
    bn = qconv.halo_bn(cout)
    assert bn == (64 if cout <= 64 else 128)
    assert wpt.dtype == torch.int8 and wpt.is_contiguous()
    assert tuple(wpt.shape) == (-(-cout // bn) * -(-cin // 64) * 18, bn * 32)
    full = _unpack(wpt, cin, cout, bn)
    assert torch.equal(full[:, :, :cin, :cout], node["wq"])
    assert int(full[:, :, cin:].abs().sum()) == 0 and int(full[:, :, :, cout:].abs().sum()) == 0
    assert qconv.packed_tap_slabs(node) is wpt  # cached on the node


def test_packed_tap_slab_is_one_tap_in_core_matrix_order():
    """One slab byte by byte: (row, k) at ((row // 8) * 2 + k // 16) * 128 + (row % 8) * 16 + k % 16."""
    cin, cout = 96, 80
    node = _node(cin, cout, seed=3)
    wpt = qconv.packed_tap_slabs(node)
    chunks = 2
    tile_n, chunk, half, tap = 0, 1, 0, 5
    slab = wpt[((tile_n * chunks + chunk) * 2 + half) * 9 + tap]
    for row, k in itertools.product((0, 7, 9, 79, 100), (0, 15, 16, 31)):
        c_in, c_out = 64 * chunk + 32 * half + k, 128 * tile_n + row
        want = int(node["wq"][tap // 3, tap % 3, c_in, c_out]) if c_in < cin and c_out < cout else 0
        assert int(slab[((row // 8) * 2 + k // 16) * 128 + (row % 8) * 16 + k % 16]) == want


def _walk_calls():
    """(name, stride, dilation) of every dense site in `_walk48`'s order, from a stub walk."""
    calls = []

    def block(name, x, stride=1, dilation=1, residual=False):
        calls.append((name, stride, dilation))
        return x[:, ::stride, ::stride]

    def up(name, x):
        return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)

    fastnet._walk48(torch.zeros(1, 16, 16, 4), block, up)
    return calls


def test_route_of_the_fast_sites():
    calls = _walk_calls()
    assert {name: (stride, dilation) for name, stride, dilation in calls} == fastnet.DENSE_SITES
    routes = {name: qconv.route(3, stride, dilation) for name, stride, dilation in calls}
    assert sorted(n for n, r in routes.items() if r == "conv_kernel") == ["down2", "down3", "down4"]
    assert sorted(n for n, r in routes.items() if r == "halo") == sorted(
        ["stem", "b1", "b2", "b3", "b4a", "b4b", "d3", "d2", "d1"])
    # Everything else the wrapper accepts keeps conv_kernel.
    for k, stride, dilation in [(1, 1, 1), (5, 1, 1), (3, 1, 3), (3, 2, 2)]:
        assert qconv.route(k, stride, dilation) == "conv_kernel"


def test_prepare_int8_packs_each_site_for_its_route():
    rng = np.random.default_rng(5)
    qtree = {}
    for name in fastnet._ENC + fastnet._DEC:
        if name.startswith("u"):
            qtree[name] = q8._qkernel(torch.from_numpy(rng.standard_normal((4, 4, 128, 128), np.float32)))
        else:
            cin, cout = FAST_WIDTHS[name]
            qtree[name] = q8._qconv({"w": torch.from_numpy(rng.standard_normal((3, 3, cin, cout), np.float32))})
    fastnet.prepare_int8(qtree, [0.02] * 15)
    for name, (stride, dilation) in fastnet.DENSE_SITES.items():
        node = qtree[name]
        halo = qconv.route(3, stride, dilation) == "halo"
        assert ("wpt" in node) == halo and ("wp" in node) == (not halo)
        wp, e, inv = qconv.site_operands(node, 0.02, stride, dilation)
        assert wp is (node["wpt"] if halo else qenc.packed_weights(node))
        assert torch.equal(e, q8.scaled_ws(node, 0.02)) and inv == q8._act_inv(0.02)


@pytest.mark.parametrize("n,h,w,dilation,padding", [
    (2, 16, 16, 1, "SAME"),
    (1, 18, 18, 1, "SAME"),
    (1, 18, 18, 2, ((2, 2), (2, 2))),   # b4b
    (1, 2, 2, 2, ((2, 2), (2, 2))),     # b4b on a 2 x 2 grid
    (2, 13, 9, 2, ((2, 2), (2, 2))),
    (1, 37, 29, 1, "SAME"),
    (1, 1, 21, 1, "SAME"),              # 1 x W
    (1, 19, 1, 1, "SAME"),              # H x 1
    (1, 10, 12, 1, ((0, 2), (2, 0))),   # padding off the center
])
def test_halo_geometry_matches_brute_force(n, h, w, dilation, padding):
    node = {"wq": torch.zeros(3, 3, 16, 16, dtype=torch.int8)}
    (pt, pl), (ho, wo) = qconv.conv_geometry((n, h, w, 16), node, 1, dilation, padding)
    plan = qconv.halo_plan((n, h, w, 16), 16, dilation, (ho, wo))
    assert plan.side == 8 + 2 * dilation
    assert plan.n_tiles == n * plan.tiles_y * plan.tiles_x and plan.items == -(-plan.n_tiles // 2)
    covered = np.zeros((n, ho, wo), np.int32)
    for t in range(plan.n_tiles):
        img, y0, x0 = qconv.halo_origin(plan, t, (pt, pl))
        rem = t % (plan.tiles_y * plan.tiles_x)
        ty, tx = 8 * (rem // plan.tiles_x), 8 * (rem % plan.tiles_x)
        outs = [(oy, ox) for oy in range(ty, min(ty + 8, ho)) for ox in range(tx, min(tx + 8, wo))]
        assert outs, "a tile with no output pixel"
        for oy, ox in outs:
            covered[img, oy, ox] += 1
        # Every input pixel (inside the image or in its zero padding) that
        # the tile's full 8 x 8 block of output positions reads.
        reads = {(oy - pt + a * dilation, ox - pl + b * dilation)
                 for oy in range(ty, ty + 8) for ox in range(tx, tx + 8) for a in range(3) for b in range(3)}
        rows = sorted({r for r, _ in reads})
        cols = sorted({c for _, c in reads})
        assert (rows[0], cols[0]) == (y0, x0)
        assert (rows[-1] - y0 + 1, cols[-1] - x0 + 1) == (plan.side, plan.side)
        # The halo window of tap (a, b) at (a dil, b dil) is the tap's reads.
        for a, b in itertools.product(range(3), range(3)):
            for oy, ox in outs:
                hy, hx = oy - ty + a * dilation, ox - tx + b * dilation
                assert 0 <= hy < plan.side and 0 <= hx < plan.side
                assert (y0 + hy, x0 + hx) == (oy - pt + a * dilation, ox - pl + b * dilation)
    assert (covered == 1).all()


def test_halo_plan_at_the_walk_grids():
    """The items of the nine stride-1 sites of a batch of 8 576-px tiles."""
    grids = {"stem": 144, "b1": 144, "b2": 72, "b3": 36, "b4a": 18, "b4b": 18, "d3": 36, "d2": 72, "d1": 144}
    items = {}
    for name, side in grids.items():
        cin, cout = FAST_WIDTHS[name]
        plan = qconv.halo_plan((8, side, side, cin), cout, fastnet.DENSE_SITES[name][1], (side, side))
        items[name] = plan.items
    assert items == {"stem": 1296, "b1": 1296, "b2": 324, "b3": 200, "b4a": 72, "b4b": 72, "d3": 100, "d2": 324,
                     "d1": 1296}
