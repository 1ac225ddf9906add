// int8 dec4 + dec5 on Hopper, with and without the head (kernels K6, K7, K9).
//
// Replaces three Pallas kernels of robosat_tpu/models/qtail.py, each built
// from dec4 and dec5, two 128 -> 128 int8 3x3 SAME convs on the 2x2
// space-to-depth grid (no bias; epilogue relu(bf16(acc * (ws * s)))):
//
// - K6 fused_tail (_tail_kernel): the two convs, then the blocked margin
//   head of head.cuh (G = 4, crop on the blocked grid). The 4 output bytes
//   per pixel are written directly: the TPU kernel's 128-lane padding was a
//   Mosaic workaround.
// - K7 fused_tail_features (_tail_features_kernel): the two convs, writing
//   dec5's bf16 activations for the head (K1).
// - K9 fused_tail_features_sep (_tail_features_sep_kernel): the two convs
//   on parity planes, (N, Hc, Wc, 512) in and out, the space_to_depth2
//   layout of the (N, 2Hc, 2Wc, 128) grid. Both convs run on that fine grid
//   with loads and stores addressing the planes (int8_conv.cuh's LAYOUT_PLANES),
//   so each conv zero-pads its own input: that is the fine grid's SAME
//   padding, which the TPU kernel rebuilt from strip halos and re-zeroed rows.
//
// What bounds it on the H100: each conv is 98 G int8 MACs at batch 8, 576 px
// (288^2 x 9 x 128 x 128 x 8) against 170 MB of bf16 in and out, ~1150 ops
// per byte, above the ridge: compute bound. The head reads 170 MB for 2.1 M
// outputs and is bandwidth bound. This first design runs one launch per
// conv (and one for the head) and passes dec4's and dec5's bf16 activations
// through device memory.

#include "head.cuh"
#include "int8_conv.cuh"

namespace {

// dec4 then dec5 over the (n, h, w, 128) grid, both tensors in `layout`.
int tail_convs(const void* x, const void* w4, const float* e4, const void* w5, const float* e5, float inv4, float inv5,
               void* y4, void* y5, int n, int h, int w, int layout, cudaStream_t stream) {
  int rc;
  rs::ConvParams p = rs::conv_params(x, w4, e4, nullptr, y4, inv4, n, h, w, 128, 128, 3, 1, 1);
  p.in_layout = p.out_layout = layout;
  if ((rc = rs::launch_int8_conv(p, rs::EPI_RELU, stream)) != 0) return rc;
  p = rs::conv_params(y4, w5, e5, nullptr, y5, inv5, n, h, w, 128, 128, 3, 1, 1);
  p.in_layout = p.out_layout = layout;
  return rs::launch_int8_conv(p, rs::EPI_RELU, stream);
}

}  // namespace

extern "C" int rs_fused_tail(const void* x, const void* w4, const float* e4, const void* w5, const float* e5,
                             const float* wmb, float inv4, float inv5, void* y4, void* y5, void* out, int n,
                             int h, int w, int o, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  int rc = tail_convs(x, w4, e4, w5, e5, inv4, inv5, y4, y5, n, h, w, rs::LAYOUT_NHWC, stream);
  if (rc != 0) return rc;
  return rs::launch_margin_head(static_cast<const __nv_bfloat16*>(y5), wmb, static_cast<unsigned char*>(out), n, h,
                                w, 4, o, stream);
}

extern "C" int rs_fused_tail_features(const void* x, const void* w4, const float* e4, const void* w5, const float* e5,
                                      float inv4, float inv5, void* y4, void* y5, int n, int h, int w,
                                      void* stream_ptr) {
  return tail_convs(x, w4, e4, w5, e5, inv4, inv5, y4, y5, n, h, w, rs::LAYOUT_NHWC,
                    static_cast<cudaStream_t>(stream_ptr));
}

// x, y4, y5: (n, hc, wc, 512) parity planes of the (n, 2 hc, 2 wc, 128) grid.
extern "C" int rs_fused_tail_features_sep(const void* x, const void* w4, const float* e4, const void* w5,
                                          const float* e5, float inv4, float inv5, void* y4, void* y5, int n, int hc,
                                          int wc, void* stream_ptr) {
  return tail_convs(x, w4, e4, w5, e5, inv4, inv5, y4, y5, n, 2 * hc, 2 * wc, rs::LAYOUT_PLANES,
                    static_cast<cudaStream_t>(stream_ptr));
}
