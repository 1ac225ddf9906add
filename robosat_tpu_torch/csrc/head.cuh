// The margin head shared by K1 (head.cu) and K6's head pass (qtail.cu).
//
// For a binary model the softmax foreground probability is sigmoid(l1 - l0),
// so the final 1x1 conv collapses to a 32-wide margin dot with w1 - w0.
// `wmb` holds the 32 margin weights (w[:, 1] - w[:, 0]) followed by the
// margin bias b1 - b0, all f32. Features of G groups of 32 channels, the
// group g reading channels [32 g, 32 g + 32) of its pixel, give G output
// bytes per pixel:
//
//   margin = sum of f[c] * wm[c], then + bm                      (f32)
//   p      = 1 / (1 + expf(-margin))                               (IEEE division)
//   q      = np.digitize(p, 256 anchors k / 255) & 0xff            (p == 1.0 wraps to 0)
//
// The sum runs in the order XLA:CPU compiles the JAX package's heads to,
// so the margins equal the plain versions' (robosat_tpu_torch/ops/head.py,
// _margin) bit for bit: for G = 1 sequentially in channel order with every
// product and sum rounded (no FMA); for G = 4 and 16 (a block-diagonal dot
// there) in four fused multiply-add accumulators, channel c into c % 4,
// combined as (a0 + a1) + (a2 + a3).
//
// The overlap crop `o` (in pixels of the features' grid) is applied on load:
// the output is (n, h - 2 o, w - 2 o, G) uint8.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rs {

// ops/head.py:_digitize_exact with IEEE division, as np.digitize against the
// 256 float32 anchors k / 255.
__device__ __forceinline__ unsigned char digitize(float prob) {
  const float kf = rintf(__fmul_rn(prob, 255.0f));
  const int k = static_cast<int>(kf);
  const int q = (k - 1) + (__fdiv_rn(__fadd_rn(kf, -1.0f), 255.0f) <= prob) + (__fdiv_rn(kf, 255.0f) <= prob) +
                (__fdiv_rn(__fadd_rn(kf, 1.0f), 255.0f) <= prob);
  return static_cast<unsigned char>(q & 0xff);
}

__device__ __forceinline__ unsigned char margin_to_u8(float margin) {
  return digitize(__fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-margin))));
}

// Eight features from f + 8 k (16-byte aligned) as f32, one or two 16-byte loads.
__device__ __forceinline__ void load8(const float* f, int k, float* v) {
  const float4 a = reinterpret_cast<const float4*>(f)[2 * k];
  const float4 b = reinterpret_cast<const float4*>(f)[2 * k + 1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* f, int k, float* v) {
  const uint4 u = reinterpret_cast<const uint4*>(f)[k];
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[2 * j] = __uint_as_float(w[j] << 16);
    v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

// The margin of the 32 features at f, in the order of `groups` (see above).
template <typename T>
__device__ __forceinline__ float margin32(const T* f, const float* wmb, int groups) {
  float m;
  if (groups == 1) {
    m = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float v[8];
      load8(f, k, v);
#pragma unroll
      for (int c = 0; c < 8; ++c) m = __fadd_rn(m, __fmul_rn(v[c], wmb[8 * k + c]));
    }
  } else {
    float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float v[8];
      load8(f, k, v);
#pragma unroll
      for (int c = 0; c < 8; ++c) a[c & 3] = __fmaf_rn(v[c], wmb[8 * k + c], a[c & 3]);
    }
    m = __fadd_rn(__fadd_rn(a[0], a[1]), __fadd_rn(a[2], a[3]));
  }
  return __fadd_rn(m, wmb[32]);
}

// One thread per output byte: (n, h - 2 o, w - 2 o, groups) uint8 from
// features (n, h, w, 32 groups) of type T (float or __nv_bfloat16).
template <typename T>
__global__ void margin_head_kernel(const T* f, const float* wmb, unsigned char* out, int n, int h, int w, int groups,
                                   int o) {
  __shared__ float s_wmb[33];
  if (threadIdx.x < 33) s_wmb[threadIdx.x] = wmb[threadIdx.x];
  __syncthreads();
  const int hc = h - 2 * o;
  const int wc = w - 2 * o;
  const long long total = static_cast<long long>(n) * hc * wc * groups;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int g = static_cast<int>(idx % groups);
  const long long pix = idx / groups;
  const int ox = static_cast<int>(pix % wc);
  const int oy = static_cast<int>((pix / wc) % hc);
  const int img = static_cast<int>(pix / (static_cast<long long>(wc) * hc));
  const T* src = f + ((static_cast<size_t>(img) * h + oy + o) * w + ox + o) * (32 * static_cast<size_t>(groups)) + g * 32;
  out[idx] = margin_to_u8(margin32(src, s_wmb, groups));
}

// Launch the head; returns the launch's CUDA error code (0 on success).
template <typename T>
inline int launch_margin_head(const T* f, const float* wmb, unsigned char* out, int n, int h, int w, int groups, int o,
                              cudaStream_t stream) {
  const long long total = static_cast<long long>(n) * (h - 2 * o) * (w - 2 * o) * groups;
  if (total <= 0) return 0;
  const int threads = 256;
  margin_head_kernel<T><<<static_cast<unsigned>((total + threads - 1) / threads), threads, 0, stream>>>(
      f, wmb, out, n, h, w, groups, o);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rs
