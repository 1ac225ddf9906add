// int8 nearest-2x upsample + 3x3 conv on Hopper (kernels K5 and K8).
//
// Replaces the Pallas kernels robosat_tpu/models/qdec.py:parity_up_conv
// (_dec_kernel) and :parity_up_conv_separated (_dec_kernel_sep): the
// decoder's up-blocks as the four 2x2-tap parity sub-convs of the 4x4
// parity-combined kernel (qdec.parity_tap_weights), each on the coarse grid,
// with the epilogue relu(bf16(acc * (ws * s) + b)). K5 interleaves the four
// parities into the fine NHWC output (N, 2H, 2W, Cout) in its store; K8
// writes parity p = 2 di + dj to channels [p Cout, (p + 1) Cout) of an
// (N, H, W, 4 Cout) tensor, the space_to_depth2 layout of the same fine
// output (int8_conv.cuh's LAYOUT_PLANES). Only the store differs.
//
// What bounds it on the H100: at batch 8, 576 px the five sites run
// 5.4 G (center: 8 x 9^2 coarse pixels x 4 parities x 4 taps x 2048 x 256)
// to 109 G (dec3) int8 MACs against 12-280 MB of bf16 in and out and int8
// weights: 770-2300 ops per byte, above the ~590 ops per byte ridge of the
// int8 peak, so the up-blocks are compute bound. One launch covers all four
// parities (gridDim.z), and the quantization of the input happens on load.
// K8's store writes 4 Cout contiguous channels per coarse pixel instead of
// Cout-wide rows of every other fine pixel.

#include "int8_conv.cuh"

namespace {

rs::ConvParams parity_params(const void* x, const void* wp, const float* e, const float* b, float inv, void* out,
                             int n, int h, int w, int cin, int cout) {
  rs::ConvParams p = rs::conv_params(x, wp, e, b, out, inv, n, h, w, cin, cout, 2, 1, 1);
  // 2x2 taps with padding 1 would give (h + 1) rows; each parity computes h.
  p.ho = h;
  p.wo = w;
  p.out_h = 2 * h;
  p.out_w = 2 * w;
  p.out_mul = 2;
  return p;
}

}  // namespace

extern "C" int rs_parity_up_conv(const void* x, const void* wp, const float* e, const float* b, float inv, void* out,
                                 int n, int h, int w, int cin, int cout, void* stream_ptr) {
  const rs::ConvParams p = parity_params(x, wp, e, b, inv, out, n, h, w, cin, cout);
  return rs::launch_int8_conv(p, rs::EPI_RELU, static_cast<cudaStream_t>(stream_ptr));
}

extern "C" int rs_parity_up_conv_separated(const void* x, const void* wp, const float* e, const float* b, float inv,
                                           void* out, int n, int h, int w, int cin, int cout, void* stream_ptr) {
  rs::ConvParams p = parity_params(x, wp, e, b, inv, out, n, h, w, cin, cout);
  p.out_layout = rs::LAYOUT_PLANES;
  return rs::launch_int8_conv(p, rs::EPI_RELU, static_cast<cudaStream_t>(stream_ptr));
}
