// Prefixes of K6's head stage on dec5 activations (kernel K10).
//
// Replaces the Pallas rung kernels of benchmarks/bisect_mosaic_head.py
// (RUNG_SRC, the pallas_call at :108): on bf16 activations (N, H, W, 128)
// with per-channel margin weights wm (128) and per-parity biases bm (4),
// each rung computes one more construct of the fused tail's head:
//
//   copy      y = x                                           (bf16, 128 channels)
//   mul       y = bf16_rne(f32(x) * wm)                       (bf16, 128 channels)
//   margin    m[g] = sum of the 32 products of group g, + bm[g]  (f32, 4 per pixel)
//   sigmoid   p = 1 / (1 + expf(-m))                          (f32, 4 per pixel)
//   digitize  q = np.digitize(p, 256 anchors) & 0xff          (uint8, 4 per pixel)
//
// The "merge" rungs store the digitize bytes, whose (N, H, W, 4) row-major
// layout is already the (N, H, 4W) of the merge. The TPU rungs padded the
// 4-wide outputs to 128 (or 8) lanes, a Mosaic workaround; these write only
// the meaningful lanes.
//
// The margin sums in the order XLA:CPU compiles the two TPU forms to,
// found by fitting candidate orders to the interpreted rungs
// (tests/test_torch_port_head_rungs.py), so it equals the plain version
// (robosat_tpu_torch/ops/head_rungs.py) bit for bit:
//   reshape-sum (MM = false): the multiply fused into the reduction,
//     sequentially in channel order, one FMA per channel from 0;
//   one-hot matmul (MM = true, the rungs whose names end in "_mm", as
//     the TPU script decides; digitize_mm_pad8/_pad4 sum as the
//     reshape-sum): each product rounded, then four accumulators,
//     channel c into c % 4, combined (a0 + a1) + (a2 + a3).
// The sigmoid and digitize are head.cuh's, shared with K1 and K6.
//
// What bounds it on the H100: every rung reads the 256 bytes of a pixel's
// activations once and does at most ~3 flops per byte read: bound by
// device memory (a full dec5 batch, 8 x 288 x 288 x 128 bf16, is 170 MB:
// 0.051 ms at 3.35 TB/s, twice that for the rungs that write bf16). One
// thread per 8 channels (copy, mul) or per group of 32 channels (the rest)
// with 16-byte loads, in one kernel templated on the stage and the order;
// wm and bm sit in shared memory.

#include "head.cuh"

namespace {

enum Stage { STAGE_COPY = 0, STAGE_MUL = 1, STAGE_MARGIN = 2, STAGE_SIGMOID = 3, STAGE_DIGITIZE = 4 };

constexpr int kChannels = 128;
constexpr int kRungThreads = 256;

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// One thread per item: for copy / mul, item i is the 8 channels
// 8 (i % 16) .. + 7 of pixel i / 16; for the rest, group i % 4 of pixel
// i / 4 (32 contiguous channels, one output).
template <int STAGE, bool MM>
__global__ void head_rung_kernel(const __nv_bfloat16* x, const float* wm, const float* bm, void* out, long long items) {
  __shared__ float s_w[kChannels + 4];  // wm, then bm
  if (threadIdx.x < kChannels + 4) s_w[threadIdx.x] = threadIdx.x < kChannels ? wm[threadIdx.x] : bm[threadIdx.x - kChannels];
  __syncthreads();
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= items) return;
  if constexpr (STAGE == STAGE_COPY || STAGE == STAGE_MUL) {
    uint4* y = static_cast<uint4*>(out);
    if constexpr (STAGE == STAGE_COPY) {
      y[i] = reinterpret_cast<const uint4*>(x)[i];
    } else {
      float f[8];
      rs::load8(x + i * 8, 0, f);
      const float* w = s_w + (i % (kChannels / 8)) * 8;
      uint4 o;
      o.x = pack_bf16x2(__fmul_rn(f[0], w[0]), __fmul_rn(f[1], w[1]));
      o.y = pack_bf16x2(__fmul_rn(f[2], w[2]), __fmul_rn(f[3], w[3]));
      o.z = pack_bf16x2(__fmul_rn(f[4], w[4]), __fmul_rn(f[5], w[5]));
      o.w = pack_bf16x2(__fmul_rn(f[6], w[6]), __fmul_rn(f[7], w[7]));
      y[i] = o;
    }
  } else {
    const int grp = static_cast<int>(i & 3);
    const __nv_bfloat16* f = x + i * 32;
    const float* w = s_w + grp * 32;
    float m;
    if constexpr (MM) {
      float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float v[8];
        rs::load8(f, k, v);
#pragma unroll
        for (int c = 0; c < 8; ++c) a[c & 3] = __fadd_rn(a[c & 3], __fmul_rn(v[c], w[8 * k + c]));
      }
      m = __fadd_rn(__fadd_rn(a[0], a[1]), __fadd_rn(a[2], a[3]));
    } else {
      m = 0.0f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float v[8];
        rs::load8(f, k, v);
#pragma unroll
        for (int c = 0; c < 8; ++c) m = __fmaf_rn(v[c], w[8 * k + c], m);
      }
    }
    m = __fadd_rn(m, s_w[kChannels + grp]);
    if constexpr (STAGE == STAGE_MARGIN) {
      static_cast<float*>(out)[i] = m;
    } else if constexpr (STAGE == STAGE_SIGMOID) {
      static_cast<float*>(out)[i] = rs::sigmoid(m);
    } else {
      static_cast<unsigned char*>(out)[i] = rs::margin_to_u8(m);
    }
  }
}

template <int STAGE, bool MM>
int launch_rung(const __nv_bfloat16* x, const float* wm, const float* bm, void* out, long long pixels,
                cudaStream_t stream) {
  const long long items = pixels * (STAGE == STAGE_COPY || STAGE == STAGE_MUL ? kChannels / 8 : 4);
  head_rung_kernel<STAGE, MM><<<static_cast<unsigned>((items + kRungThreads - 1) / kRungThreads), kRungThreads, 0,
                                stream>>>(x, wm, bm, out, items);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (n, h, w, 128) bf16; wm (128,) and bm (4,) f32; out per `stage` (see
// above); mm picks the one-hot matmul's summation order. Returns the
// launch's CUDA error code (0 on success).
extern "C" int rs_head_rung(const void* x, const float* wm, const float* bm, void* out, int n, int h, int w, int stage,
                            int mm, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const long long pixels = static_cast<long long>(n) * h * w;
  if (pixels <= 0) return 0;
  switch (stage) {
    case STAGE_COPY:
      return launch_rung<STAGE_COPY, false>(xb, wm, bm, out, pixels, stream);
    case STAGE_MUL:
      return launch_rung<STAGE_MUL, false>(xb, wm, bm, out, pixels, stream);
    case STAGE_MARGIN:
      return mm ? launch_rung<STAGE_MARGIN, true>(xb, wm, bm, out, pixels, stream)
                : launch_rung<STAGE_MARGIN, false>(xb, wm, bm, out, pixels, stream);
    case STAGE_SIGMOID:
      return mm ? launch_rung<STAGE_SIGMOID, true>(xb, wm, bm, out, pixels, stream)
                : launch_rung<STAGE_SIGMOID, false>(xb, wm, bm, out, pixels, stream);
    case STAGE_DIGITIZE:
      return mm ? launch_rung<STAGE_DIGITIZE, true>(xb, wm, bm, out, pixels, stream)
                : launch_rung<STAGE_DIGITIZE, false>(xb, wm, bm, out, pixels, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
