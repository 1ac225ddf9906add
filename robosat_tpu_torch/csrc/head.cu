// Margin head on Hopper (kernel K1).
//
// Replaces the Pallas kernel robosat_tpu/ops/head.py:pallas_prediction_head
// (_head_kernel): on fine-grid features (N, H, W, 32) the final 1x1 conv to
// two classes, sigmoid(l1 - l0), the exact 256-bin digitize and the overlap
// crop. The same kernel takes the layouts the JAX package runs through XLA,
// as G groups of 32 channels per pixel: G = 1 the fine grid
// (ops/head.py:fused_prediction_head), G = 4 the parity-blocked s2d grid
// (fused_prediction_head_s2d_blocked), G = 16 the doubly-blocked grid of the
// separated tail (fused_prediction_head_s2d_blocked_sep). The arithmetic is
// head.cuh's, shared with K6's head pass.
//
// What bounds it on the H100: at batch 8, 576 px the head reads the
// features once (G = 1: 340 MB of f32 or 170 MB of bf16 for 2.1 M output
// bytes; G = 4 and 16: 170 MB of bf16 for 2.1 M bytes) and does 64 flops
// per 32 features: ~0.4 flops per byte, far below the ridge. It is
// bandwidth bound, ~0.05-0.1 ms at 3.35 TB/s. One thread per output byte
// reads its 32 contiguous features with 16-byte loads; the margin weights
// sit in shared memory.

#include "head.cuh"

extern "C" int rs_margin_head(const void* features, const float* wmb, void* out, int n, int h, int w, int groups,
                              int o, int bf16, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  unsigned char* q = static_cast<unsigned char*>(out);
  if (bf16) {
    return rs::launch_margin_head(static_cast<const __nv_bfloat16*>(features), wmb, q, n, h, w, groups, o, stream);
  }
  return rs::launch_margin_head(static_cast<const float*>(features), wmb, q, n, h, w, groups, o, stream);
}
