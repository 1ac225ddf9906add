// int8 dec4 + dec5 on Hopper, with and without the head (kernels K6, K7, K9).
//
// Replaces three Pallas kernels of robosat_tpu/models/qtail.py, each built
// from dec4 and dec5, two 128 -> 128 int8 3x3 SAME convs on the 2x2
// space-to-depth grid (no bias; epilogue relu(bf16(acc * (ws * s)))):
//
// - K6 fused_tail (_tail_kernel, qtail.py:426): the two convs, then the
//   blocked margin head of head.cuh (G = 4, crop on the blocked grid);
// - K7 fused_tail_features (_tail_features_kernel, qtail.py:204): the two
//   convs, writing dec5's bf16 activations (for K1, or the unfused head);
// - K9 fused_tail_features_sep (_tail_features_sep_kernel, qtail.py:358):
//   the two convs on parity planes, (N, Hc, Wc, 512) in and out, the
//   space_to_depth2 layout of the (N, 2Hc, 2Wc, 128) grid. Both convs run
//   on that fine grid with the halo copy reading and the store writing the
//   planes (int8_conv_sm90.cuh's tail_pixel), so each conv zero-pads its
//   own input: that is the fine grid's SAME padding, which the TPU kernel
//   rebuilt from strip halos and re-zeroed rows.
//
// All three are two launches of int8_conv_sm90.cuh's tail_kernel (wgmma
// over halo tiles of 8 x 8 pixels). dec4 stores its output as int8
// (quantized with dec5's scale: the bytes dec5's on-load quantize would
// compute), NHWC scratch in all three. dec5's epilogue is K6's head (its
// activations never reach device memory; the 4 output bytes per pixel are
// written directly, where the TPU kernel padded to 128 lanes for Mosaic) or
// K7's and K9's relu'd bf16 store. Both convs issue MMAs only over the
// host's list of nonzero 32 x 32 weight blocks (qtail.block_operands),
// which each CTA holds in shared memory: on the s2d weights dec4 keeps 4 of
// 9 taps per output parity and dec5 9 of 36 (tap, input parity) blocks,
// 68 G MACs per batch of 8 x 576 px instead of 196 G.
//
// What bounds it on the H100: 68 G int8 MACs (136 G ops) are 0.069 ms at
// 1979 TOP/s. K6 moves ~255 MB (bf16 in, int8 y4 out and in, uint8 out;
// 0.076 ms at 3.35 TB/s): balanced near the ridge. K7 and K9 write dec5's
// 170 MB of bf16 instead of 2.6 MB of uint8: ~510 MB, 0.152 ms, bound by
// bytes (the function alone, without y4, 0.1015 ms).

#include "head.cuh"
#include "int8_conv_sm90.cuh"

namespace {

namespace s9 = rs::sm90;

// One conv's parameters: `table` (host) holds the MMAs per output slice,
// then that many MMA entries per slice (qtail.block_operands).
int tail_params(s9::TailParams& tp, const void* x, const void* blocks, const int* table, int nb, const float* scale,
                void* y, float inv_in, float inv_out, int n, int h, int w) {
  const int per_slice = table[0];
  if (nb < 1 || nb > s9::kMaxBlocks + 1 || per_slice < 1 || 4 * per_slice > s9::kMaxBlocks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  tp.conv = s9::conv_params(x, nullptr, scale, nullptr, y, inv_in, inv_out, n, h, w, 128, 128, 3);
  tp.blocks = static_cast<const int8_t*>(blocks);
  tp.nb = nb;
  tp.per_slice = per_slice;
  for (int i = 0; i < 4 * per_slice; ++i) tp.mma[i] = table[1 + i];
  return 0;
}

// dec4 (bf16 x in LAYOUT -> int8 y4, NHWC) then dec5 (y4 -> out: EPI5 = the
// head, uint8 NHWC, or relu'd bf16 in LAYOUT) over the (n, h, w) grid.
// v4, v5: null (per-tensor: inv4, inv5) or dec4's and dec5's per-channel
// reciprocal vectors (128 each), dec4's quantize on load and its epilogue's.
template <int EPI5, int LAYOUT>
int tail_convs(const void* x, const void* b4, const int* t4, int n4, const float* e4, const void* b5, const int* t5,
               int n5, const float* e5, const float* wmb, int crop, float inv4, float inv5, const float* v4,
               const float* v5, void* y4, void* out, int n, int h, int w, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if ((v4 == nullptr) != (v5 == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  s9::TailParams tp;
  int rc = tail_params(tp, x, b4, t4, n4, e4, y4, inv4, inv5, n, h, w);
  tp.conv.inv_in_v = v4;
  tp.conv.inv_out_v = v5;
  if (rc == 0) {
    rc = v4 != nullptr ? s9::launch_tail<true, s9::EPI_RELU_Q8, LAYOUT, rs::LAYOUT_NHWC, true>(tp, stream)
                       : s9::launch_tail<true, s9::EPI_RELU_Q8, LAYOUT, rs::LAYOUT_NHWC>(tp, stream);
  }
  if (rc == 0) rc = tail_params(tp, y4, b5, t5, n5, e5, out, 0.0f, 0.0f, n, h, w);
  if (rc != 0) return rc;
  tp.conv.wmb = wmb;
  tp.conv.crop = crop;
  return s9::launch_tail<false, EPI5, rs::LAYOUT_NHWC, LAYOUT>(tp, stream);
}

}  // namespace

// b4 / b5: the listed weight blocks of dec4 / dec5 and a zero block
// (device, packed), t4 / t5 their MMA tables (host), n4 / n5 packed
// blocks; v4 / v5: null or the per-channel reciprocal vectors; y4:
// (n, h, w, 128) int8 scratch.
extern "C" int rs_fused_tail(const void* x, const void* b4, const int* t4, int n4, const float* e4, const void* b5,
                             const int* t5, int n5, const float* e5, const float* wmb, float inv4, float inv5,
                             const float* v4, const float* v5, void* y4, void* out, int n, int h, int w, int o,
                             void* stream_ptr) {
  return tail_convs<s9::EPI_HEAD, rs::LAYOUT_NHWC>(x, b4, t4, n4, e4, b5, t5, n5, e5, wmb, o, inv4, inv5, v4, v5, y4,
                                                   out, n, h, w, stream_ptr);
}

// y5: (n, h, w, 128) bf16.
extern "C" int rs_fused_tail_features(const void* x, const void* b4, const int* t4, int n4, const float* e4,
                                      const void* b5, const int* t5, int n5, const float* e5, float inv4, float inv5,
                                      const float* v4, const float* v5, void* y4, void* y5, int n, int h, int w,
                                      void* stream_ptr) {
  return tail_convs<rs::EPI_RELU, rs::LAYOUT_NHWC>(x, b4, t4, n4, e4, b5, t5, n5, e5, nullptr, 0, inv4, inv5, v4, v5,
                                                   y4, y5, n, h, w, stream_ptr);
}

// x, y5: (n, hc, wc, 512) parity planes of the (n, 2 hc, 2 wc, 128) grid;
// y4: (n, 2 hc, 2 wc, 128) int8 scratch.
extern "C" int rs_fused_tail_features_sep(const void* x, const void* b4, const int* t4, int n4, const float* e4,
                                          const void* b5, const int* t5, int n5, const float* e5, float inv4,
                                          float inv5, void* y4, void* y5, int n, int hc, int wc, void* stream_ptr) {
  return tail_convs<rs::EPI_RELU, rs::LAYOUT_PLANES>(x, b4, t4, n4, e4, b5, t5, n5, e5, nullptr, 0, inv4, inv5, nullptr,
                                                     nullptr, y4, y5, n, 2 * hc, 2 * wc, stream_ptr);
}
