// int8 dec4 + dec5 + margin head on Hopper (kernel K6).
//
// Replaces the Pallas kernel robosat_tpu/models/qtail.py:fused_tail
// (_tail_kernel): dec4 and dec5, two 128 -> 128 int8 3x3 SAME convs on the
// 2x2 space-to-depth grid (no bias, relu), then the blocked margin head:
// per parity p, margin = sum_c y5[p * 32 + c] * (w1 - w0)[c] + (b1 - b0),
// sigmoid, the exact 256-bin digitize (ops/head.py:_digitize_exact, with the
// p == 1.0 -> 0 wrap of the uint8 cast) and the overlap crop on the blocked
// grid. The 4 output bytes per pixel are written directly: the TPU kernel's
// 128-lane padding was a Mosaic workaround.
//
// What bounds it on the H100: each conv is 98 G int8 MACs at batch 8, 576 px
// (288^2 x 9 x 128 x 128 x 8) against 170 MB of bf16 in and out, ~1150 ops
// per byte, above the ridge: compute bound. The head reads 170 MB for 5 M
// outputs and is bandwidth bound. This first design runs three launches and
// passes dec4's and dec5's bf16 activations through device memory.

#include "int8_conv.cuh"

namespace {

// ops/head.py:_digitize_exact with IEEE division, as np.digitize against the
// 256 float32 anchors k / 255.
__device__ __forceinline__ unsigned char digitize(float prob) {
  const float kf = rintf(__fmul_rn(prob, 255.0f));
  const int k = static_cast<int>(kf);
  const int q = (k - 1) + (__fdiv_rn(__fadd_rn(kf, -1.0f), 255.0f) <= prob) + (__fdiv_rn(kf, 255.0f) <= prob) +
                (__fdiv_rn(__fadd_rn(kf, 1.0f), 255.0f) <= prob);
  return static_cast<unsigned char>(q & 0xff);
}

// One thread per (output pixel, parity): (n, h - 2o, w - 2o, 4) uint8.
// wmb holds the 32 margin weights (w1 - w0) followed by the margin bias b1 - b0.
__global__ void margin_head_kernel(const __nv_bfloat16* y5, const float* wmb, unsigned char* out, int n, int h, int w,
                                   int o) {
  const int hc = h - 2 * o;
  const int wc = w - 2 * o;
  const long long total = static_cast<long long>(n) * hc * wc * 4;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int parity = static_cast<int>(idx & 3);
  const long long pix = idx >> 2;
  const int ox = static_cast<int>(pix % wc);
  const int oy = static_cast<int>((pix / wc) % hc);
  const int img = static_cast<int>(pix / (static_cast<long long>(wc) * hc));
  const __nv_bfloat16* f = y5 + ((static_cast<size_t>(img) * h + oy + o) * w + ox + o) * 128 + parity * 32;
  float margin = 0.0f;
#pragma unroll
  for (int c = 0; c < 32; ++c) margin = __fadd_rn(margin, __fmul_rn(__bfloat162float(f[c]), wmb[c]));
  margin = __fadd_rn(margin, wmb[32]);
  const float prob = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-margin)));
  out[idx] = digitize(prob);
}

}  // namespace

extern "C" int rs_fused_tail(const void* x, const void* w4, const float* e4, const void* w5, const float* e5,
                             const float* wmb, float inv4, float inv5, void* y4, void* y5, void* out, int n,
                             int h, int w, int o, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  int rc;
  rs::ConvParams p = rs::conv_params(x, w4, e4, nullptr, y4, inv4, n, h, w, 128, 128, 3, 1, 1);
  if ((rc = rs::launch_int8_conv(p, rs::EPI_RELU, stream)) != 0) return rc;
  p = rs::conv_params(y4, w5, e5, nullptr, y5, inv5, n, h, w, 128, 128, 3, 1, 1);
  if ((rc = rs::launch_int8_conv(p, rs::EPI_RELU, stream)) != 0) return rc;

  const long long total = static_cast<long long>(n) * (h - 2 * o) * (w - 2 * o) * 4;
  const int threads = 256;
  margin_head_kernel<<<static_cast<unsigned>((total + threads - 1) / threads), threads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(y5), wmb, static_cast<unsigned char*>(out), n, h, w, o);
  return static_cast<int>(cudaGetLastError());
}
