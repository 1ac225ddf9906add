// int8 nearest-2x upsample + 3x3 conv on Hopper (kernel K5).
//
// Replaces the Pallas kernel robosat_tpu/models/qdec.py:parity_up_conv
// (_dec_kernel): the decoder's up-blocks (center, dec0-dec3) as the four
// 2x2-tap parity sub-convs of the 4x4 parity-combined kernel
// (qdec.parity_tap_weights), each on the coarse grid, with the epilogue
// relu(bf16(acc * (ws * s) + b)) and the parity interleave fused into the
// store.
//
// What bounds it on the H100: at batch 8, 576 px the five sites run
// 5.4 G (center: 8 x 9^2 coarse pixels x 4 parities x 4 taps x 2048 x 256)
// to 109 G (dec3) int8 MACs against 12-280 MB of bf16 in and out and int8
// weights: 770-2300 ops per byte, above the ~590 ops per byte ridge of the
// int8 peak, so the up-blocks are compute bound. One launch covers all four
// parities (gridDim.z), and the quantization of the input happens on load.

#include "int8_conv.cuh"

extern "C" int rs_parity_up_conv(const void* x, const void* wp, const float* e, const float* b, float inv, void* out,
                                 int n, int h, int w, int cin, int cout, void* stream_ptr) {
  rs::ConvParams p = rs::conv_params(x, wp, e, b, out, inv, n, h, w, cin, cout, 2, 1, 1);
  // 2x2 taps with padding 1 would give (h + 1) rows; each parity computes h.
  p.ho = h;
  p.wo = w;
  p.out_h = 2 * h;
  p.out_w = 2 * w;
  p.out_mul = 2;
  return rs::launch_int8_conv(p, rs::EPI_RELU, static_cast<cudaStream_t>(stream_ptr));
}
