// int8 nearest-2x upsample + 3x3 conv on Hopper (kernels K5 and K8).
//
// Replaces the Pallas kernels robosat_tpu/models/qdec.py:273
// (parity_up_conv, _dec_kernel) and robosat_tpu/models/qdec.py:222
// (parity_up_conv_separated, _dec_kernel_sep): the decoder's up-blocks as
// the four 2x2-tap parity sub-convs of the 4x4 parity-combined kernel
// (qdec.parity_tap_weights), each on the coarse grid, with the epilogue
// relu(bf16(acc * (ws * s) + b)). K5 interleaves the four parities into the
// fine NHWC output (N, 2H, 2W, Cout); K8 writes parity p = 2 di + dj to
// channels [p Cout, (p + 1) Cout) of an (N, H, W, 4 Cout) tensor, the
// space_to_depth2 layout of the same fine output (rs::LAYOUT_PLANES).
//
// What bounds it on the H100 (SXM, 700 W: 1979 TOP/s int8, 3.35 TB/s): at
// batch 8, 576 px the five sites run 5.4 G (center: 8 x 9^2 coarse pixels
// x 4 parities x 4 taps x 2048 x 256) to 109 G (dec3) int8 MACs against
// 12-280 MB of bf16 in and out and int8 weights: 770-2300 ops per byte,
// above the ~590 ops per byte ridge of the int8 peak, so every site is
// bound by operations. center and dec0 have 648 and 2,592 coarse pixels
// for 8.4 and 9.4 MB of weights: there the time is the latency of
// streaming the weights through the few CTAs the grid fills.
//
// Both run int8_conv_sm90.cuh's up_kernel, one kernel with the output
// layout as a template parameter: per 8 x 8-pixel coarse tile and 64 input
// channels one 10 x 10 halo, loaded and quantized once, serves the 16
// (parity, tap) products as windows of it (as four independent 2x2-tap
// convs every input element was fetched and quantized 16 x Cout / 64
// times); the weights (qdec.packed_parity_weights) stream per half K step
// as 16 host-packed slabs that two consumer warpgroups multiply against two
// different tiles. Every site, the small grids too, takes this kernel:
// their halos are mostly padding (center's 9 x 9 grid fills 81 of the 256
// rows of its four tiles), but their time is the weight stream's, which
// this form reads once per pair of tiles. K5 and K8 differ only in the
// store address (tail_pixel of the fine pixel in the output's layout), so
// K8 writes its planes once, at K5's cost, with no permute after it.

#include "int8_conv_sm90.cuh"

namespace {

template <int OUT_LAYOUT, bool PC = false>
int up_conv(const void* x, const void* wp, const float* e, const float* b, float inv, const float* inv_v, void* out,
            int n, int h, int w, int cin, int cout, void* stream_ptr) {
  namespace s9 = rs::sm90;
  s9::Params p = s9::conv_params(x, wp, e, b, out, inv, 0.0f, n, h, w, cin, cout, 1);
  p.inv_in_v = inv_v;
  return s9::launch_up<64, OUT_LAYOUT, PC>(p, static_cast<cudaStream_t>(stream_ptr));
}

}  // namespace

// wp: qdec.packed_parity_weights (16 slabs of 64 x 32 per output tile, chunk and half) for both.
// inv_v: null (per-tensor: inv) or the per-channel reciprocal vector, zero-padded to a multiple of 128 (K5 only:
// the parity-separated K8 runs only with per-tensor scales).
extern "C" int rs_parity_up_conv(const void* x, const void* wp, const float* e, const float* b, float inv,
                                 const float* inv_v, void* out, int n, int h, int w, int cin, int cout,
                                 void* stream_ptr) {
  if (inv_v != nullptr) {
    return up_conv<rs::LAYOUT_NHWC, true>(x, wp, e, b, inv, inv_v, out, n, h, w, cin, cout, stream_ptr);
  }
  return up_conv<rs::LAYOUT_NHWC>(x, wp, e, b, inv, nullptr, out, n, h, w, cin, cout, stream_ptr);
}

extern "C" int rs_parity_up_conv_separated(const void* x, const void* wp, const float* e, const float* b, float inv,
                                           void* out, int n, int h, int w, int cin, int cout, void* stream_ptr) {
  return up_conv<rs::LAYOUT_PLANES>(x, wp, e, b, inv, nullptr, out, n, h, w, cin, cout, stream_ptr);
}
