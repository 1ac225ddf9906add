"""Peaks of the card and the arithmetic of work counted from shapes.

The peaks are NVIDIA's data sheet for one H100 SXM (dense, 700 W): HBM at
3.35 TB/s, int8 tensor cores at 1,979 TOP/s, bf16 tensor cores at 989
TFLOP/s, float32 outside the tensor cores at 67 TFLOP/s.

A conv's multiply-accumulates count only the (output pixel, tap) pairs
whose input pixel lies inside the grid (a tap in the zero padding adds
nothing), two operations each. Bytes count each input and output
activation once and each kernel once.
"""

PEAK = {"bytes": 3.35e12, "int8": 1979e12, "bf16": 989e12, "f32": 67e12}


class Site:
    """One unit of work: `ops` operations of `kind` ("int8" or "bf16"),
    `bytes` moved at least, `unit` the kernel call it runs in."""

    def __init__(self, name, kind, ops, nbytes, unit):
        self.name, self.kind, self.ops, self.bytes, self.unit = name, kind, ops, nbytes, unit

    def bound_s(self):
        """The least seconds the card could take: max(ops / peak, bytes / bandwidth)."""
        return max(self.ops / PEAK[self.kind], self.bytes / PEAK["bytes"])

    def peak_s(self):
        """Seconds of the operations alone at the peak of their kind."""
        return self.ops / PEAK[self.kind]


def axis_taps(size, k, stride=1, dilation=1, pad=None):
    """(output position, tap) pairs along one axis of a k-tap conv whose
    input position falls inside [0, size); `pad` the zeros before the grid
    (default: torch-style symmetric (k - 1) * dilation // 2)."""
    pad = (k - 1) * dilation // 2 if pad is None else pad
    out = (size + 2 * pad - (k - 1) * dilation - 1) // stride + 1
    return sum(1 for o in range(out) for t in range(k) if 0 <= o * stride + t * dilation - pad < size)


def conv_macs(n, h, w, k, cin, cout, stride=1, dilation=1):
    """Multiply-accumulates of a k x k conv over an n x h x w x cin input."""
    return n * axis_taps(h, k, stride, dilation) * axis_taps(w, k, stride, dilation) * cin * cout


def up_macs(n, h, w, cin, cout):
    """A nearest-2x upsample then 3x3 conv of an h x w input: per axis and
    output parity two taps of the coarse grid (offsets -1, 0 and 0, +1),
    the in-grid pairs of its 2h x 2w output."""
    axis = lambda size: (2 * size - 1) * 2  # noqa: E731
    return n * axis(h) * axis(w) * cin * cout


def out_hw(h, stride):
    return -(-h // stride)
