// Shared int8 implicit-GEMM convolution: the first, simple routine of the
// hybrid-int8 U-Net walk.
//
// It serves one kernel: K8 (the parity sub-convs of dec3 with
// parity-separated output, qdec.cu). K3-K7 and K9 run int8_conv_sm90.cuh,
// which takes this file's quantize, dequant and layouts; K2 (int8_mm.cu)
// its mma_s8. It reproduces robosat_tpu/models/int8.py:_int8_conv bit for
// bit:
//
//   xq  = clip(rint(x_f32 * inv), -127, 127)          (int8._quantize_act)
//   acc = sum over taps and channels of xq * wq        (exact, int32)
//   y   = acc_f32 * ws_scaled (+ b)                    (two roundings, no FMA)
//   out = relu(bf16_rne(y))
//
// GEMM view: M = output pixels (n, oh, ow), N = Cout, K = taps x Cin. A tile
// of the input is gathered per tap (zero outside the image: the int8
// padding of XLA's conv), quantized on load from bf16 into shared memory,
// and multiplied with `mma.sync.m16n8k32` (s8 x s8 -> s32) on the tensor
// cores. Weights arrive pre-arranged as (P, Cout, taps, Cin) int8 so both
// operands are K-contiguous in shared memory.
//
// Parity mode (out_mul == 2, gridDim.z == 4): block z computes output
// parity (di, dj) = (z >> 1, z & 1) of a nearest-2x upsample + 3x3 conv as
// a 2x2-tap conv on the coarse grid with weights w[z] and top/left padding
// pad - di / pad - dj, storing to fine pixel (2 oh + di, 2 ow + dj).
//
// Layouts: an activation grid (N, H, W, C) lies in memory either as NHWC or
// as parity planes, the space_to_depth2 layout (N, H/2, W/2, 4C) in which
// pixel (y, x) channel c sits at plane pixel (y/2, x/2), channel
// (2 (y % 2) + x % 2) C + c. The input and the output each have their own
// layout field: the conv always runs on the (fine) grid, and only the
// addresses of its loads and stores change.
//
// Simple by design: one tile per block, no cp.async pipeline, no wgmma/TMA.
// Each operand byte is staged once per tap, so the 3x3 sites read their
// input nine times from L2.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rs {

// Epilogues of int8_conv_sm90.cuh's store_tile (it adds two more); the conv
// of this file always ends in relu.
enum Epilogue { EPI_LINEAR = 0, EPI_RELU = 1, EPI_RESIDUAL_RELU = 2 };
enum Layout { LAYOUT_NHWC = 0, LAYOUT_PLANES = 1 };

struct ConvParams {
  const __nv_bfloat16* x;         // (N, H, W, Cin) bf16 grid in layout in_layout
  const int8_t* wk;               // (P, Cout, KH * KW, Cin) int8
  const float* scale;             // (Cout,) ws * s, f32
  const float* bias;              // (Cout,) f32, or nullptr
  __nv_bfloat16* y;               // (N, out_h, out_w, Cout) bf16 grid in layout out_layout
  float inv;                      // host-f32 reciprocal of the input's scale
  int n, h, w, cin;
  int ho, wo, cout;               // conv output grid (per parity in parity mode)
  int kh, kw, stride, pad_h, pad_w;
  int out_h, out_w, out_mul;      // output grid extent; 2 = parity mode
  int in_layout, out_layout;      // Layout of x and of y
};

constexpr int kBM = 128;          // output pixels per block
constexpr int kBN = 64;           // output channels per block
constexpr int kBK = 64;           // int8 channels per staged chunk
constexpr int kLds = kBK + 16;    // shared row stride in bytes (bank-conflict free)
constexpr int kThreads = 128;     // 4 warps as 2 (M) x 2 (N), 64 x 32 each

__device__ __forceinline__ int quantize1(float v, float inv) {
  float q = rintf(__fmul_rn(v, inv));
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return static_cast<int>(q);
}

// Two packed bf16 pairs (little-endian) -> four int8 in one word.
__device__ __forceinline__ uint32_t quantize4(uint32_t lo, uint32_t hi, float inv) {
  const int q0 = quantize1(__uint_as_float(lo << 16), inv);
  const int q1 = quantize1(__uint_as_float(lo & 0xffff0000u), inv);
  const int q2 = quantize1(__uint_as_float(hi << 16), inv);
  const int q3 = quantize1(__uint_as_float(hi & 0xffff0000u), inv);
  return (static_cast<uint32_t>(q0) & 0xffu) | ((static_cast<uint32_t>(q1) & 0xffu) << 8) |
         ((static_cast<uint32_t>(q2) & 0xffu) << 16) | ((static_cast<uint32_t>(q3) & 0xffu) << 24);
}

// Element offset of pixel (y, x) of image img in an (n, h, w, c) grid laid
// out as LAYOUT (a template parameter: the address arithmetic is fixed at
// compile time, off the inner loops' critical path).
template <int LAYOUT>
__device__ __forceinline__ size_t pixel_offset(int img, int y, int x, int h, int w, int c) {
  if (LAYOUT == LAYOUT_PLANES) {
    return ((static_cast<size_t>(img) * (h >> 1) + (y >> 1)) * (w >> 1) + (x >> 1)) * 4 * c +
           static_cast<size_t>(((y & 1) << 1) | (x & 1)) * c;
  }
  return ((static_cast<size_t>(img) * h + y) * w + x) * c;
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Dequant + relu epilogue of one accumulator; returns the f32 value whose
// bf16 rounding is stored. Explicit _rn intrinsics keep nvcc from
// contracting the multiply-add into an FMA (the reference rounds twice).
__device__ __forceinline__ float epilogue(int acc, float scale, const float* bias, int col) {
  float v = __fmul_rn(__int2float_rn(acc), scale);
  if (bias != nullptr) v = __fadd_rn(v, bias[col]);
  return fmaxf(__bfloat162float(__float2bfloat16_rn(v)), 0.0f);
}

template <int IN, int OUT>
__global__ void __launch_bounds__(kThreads) int8_conv_kernel(const ConvParams p) {
  __shared__ __align__(16) int8_t a_s[kBM * kLds];
  __shared__ __align__(16) int8_t b_s[kBN * kLds];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_m = warp >> 1;
  const int warp_n = warp & 1;
  const int g = lane >> 2;   // mma groupID
  const int tq = lane & 3;   // mma threadID_in_group

  const int par = blockIdx.z;
  const int di = p.out_mul == 2 ? (par >> 1) : 0;
  const int dj = p.out_mul == 2 ? (par & 1) : 0;
  const int pad_h = p.pad_h - di;
  const int pad_w = p.pad_w - dj;
  const int taps = p.kh * p.kw;
  const int8_t* wk = p.wk + static_cast<size_t>(par) * p.cout * taps * p.cin;

  const long long hw_out = static_cast<long long>(p.ho) * p.wo;
  const long long m_total = static_cast<long long>(p.n) * hw_out;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;

  // A staging: this thread owns rows (tid >> 3) + 16 i and the 8-channel
  // chunk (tid & 7) of every K chunk.
  const int a_col = (tid & 7) * 8;
  int a_img[8], a_h0[8], a_w0[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long m = m0 + (tid >> 3) + 16 * i;
    if (m < m_total) {
      const int img = static_cast<int>(m / hw_out);
      const int rem = static_cast<int>(m - img * hw_out);
      const int oh = rem / p.wo;
      const int ow = rem - oh * p.wo;
      a_img[i] = img;
      a_h0[i] = oh * p.stride - pad_h;
      a_w0[i] = ow * p.stride - pad_w;
    } else {
      a_img[i] = -1;
      a_h0[i] = 0;
      a_w0[i] = 0;
    }
  }
  // B staging: rows (tid >> 2) + 32 i, 16-byte chunk (tid & 3).
  const int b_col = (tid & 3) * 16;

  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  const int k_chunks = (p.cin + kBK - 1) / kBK;
  for (int t = 0; t < taps; ++t) {
    const int r = t / p.kw;
    const int s = t - r * p.kw;
    for (int kc = 0; kc < k_chunks; ++kc) {
      const int c0 = kc * kBK;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = (tid >> 3) + 16 * i;
        const int c = c0 + a_col;
        const int hi = a_h0[i] + r;
        const int wi = a_w0[i] + s;
        uint2 packed = make_uint2(0u, 0u);
        if (a_img[i] >= 0 && c < p.cin && hi >= 0 && hi < p.h && wi >= 0 && wi < p.w) {
          const uint4 v = *reinterpret_cast<const uint4*>(
              p.x + pixel_offset<IN>(a_img[i], hi, wi, p.h, p.w, p.cin) + c);
          packed.x = quantize4(v.x, v.y, p.inv);
          packed.y = quantize4(v.z, v.w, p.inv);
        }
        *reinterpret_cast<uint2*>(a_s + row * kLds + a_col) = packed;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = (tid >> 2) + 32 * i;
        const int co = n0 + row;
        const int c = c0 + b_col;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (co < p.cout && c < p.cin) {
          v = *reinterpret_cast<const uint4*>(wk + (static_cast<size_t>(co) * taps + t) * p.cin + c);
        }
        *reinterpret_cast<uint4*>(b_s + row * kLds + b_col) = v;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 32) {
        uint32_t a[4][4];
        uint32_t b[4][2];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          const int8_t* base = a_s + (warp_m * 64 + mi * 16 + g) * kLds + kk + tq * 4;
          a[mi][0] = *reinterpret_cast<const uint32_t*>(base);
          a[mi][1] = *reinterpret_cast<const uint32_t*>(base + 8 * kLds);
          a[mi][2] = *reinterpret_cast<const uint32_t*>(base + 16);
          a[mi][3] = *reinterpret_cast<const uint32_t*>(base + 8 * kLds + 16);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int8_t* base = b_s + (warp_n * 32 + ni * 8 + g) * kLds + kk + tq * 4;
          b[ni][0] = *reinterpret_cast<const uint32_t*>(base);
          b[ni][1] = *reinterpret_cast<const uint32_t*>(base + 16);
        }
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
      }
      __syncthreads();
    }
  }

  // Epilogue: accumulator e of tile (mi, ni) sits at row g + 8 (e >> 1),
  // column 2 tq + (e & 1); the two columns store as one bf16 pair.
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long m = m0 + warp_m * 64 + mi * 16 + g + 8 * half;
      if (m >= m_total) continue;
      const int img = static_cast<int>(m / hw_out);
      const int rem = static_cast<int>(m - img * hw_out);
      const int oh = rem / p.wo;
      const int ow = rem - oh * p.wo;
      const size_t base = pixel_offset<OUT>(img, oh * p.out_mul + di, ow * p.out_mul + dj, p.out_h, p.out_w, p.cout);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + warp_n * 32 + ni * 8 + tq * 2;
        if (col >= p.cout) continue;
        const float v0 = epilogue(acc[mi][ni][2 * half], p.scale[col], p.bias, col);
        const float v1 = epilogue(acc[mi][ni][2 * half + 1], p.scale[col + 1], p.bias, col + 1);
        *reinterpret_cast<__nv_bfloat162*>(p.y + base + col) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// Launch one conv with the relu epilogue; returns the launch's CUDA error
// code (0 on success). The layouts are template parameters; the
// combinations instantiated are NHWC -> NHWC (K7), NHWC -> planes (K8) and
// planes -> planes (K9).
inline int launch_int8_conv(const ConvParams& p, cudaStream_t stream) {
  const long long m_total = static_cast<long long>(p.n) * p.ho * p.wo;
  const dim3 grid(static_cast<unsigned>((m_total + kBM - 1) / kBM), static_cast<unsigned>((p.cout + kBN - 1) / kBN),
                  static_cast<unsigned>(p.out_mul * p.out_mul));
  // K8's layouts, the only ones instantiated.
  if (p.in_layout != LAYOUT_NHWC || p.out_layout != LAYOUT_PLANES) return static_cast<int>(cudaErrorInvalidValue);
  int8_conv_kernel<LAYOUT_NHWC, LAYOUT_PLANES><<<grid, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// A conv over NHWC x with NHWC output (n, ho, wo, cout), no parity mode.
inline ConvParams conv_params(const void* x, const void* wk, const float* scale, const float* bias, void* y, float inv,
                              int n, int h, int w_in, int cin, int cout, int k, int stride, int pad) {
  ConvParams p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.wk = static_cast<const int8_t*>(wk);
  p.scale = scale;
  p.bias = bias;
  p.y = static_cast<__nv_bfloat16*>(y);
  p.inv = inv;
  p.n = n;
  p.h = h;
  p.w = w_in;
  p.cin = cin;
  p.ho = (h + 2 * pad - k) / stride + 1;
  p.wo = (w_in + 2 * pad - k) / stride + 1;
  p.cout = cout;
  p.kh = k;
  p.kw = k;
  p.stride = stride;
  p.pad_h = pad;
  p.pad_w = pad;
  p.out_h = p.ho;
  p.out_w = p.wo;
  p.out_mul = 1;
  p.in_layout = LAYOUT_NHWC;
  p.out_layout = LAYOUT_NHWC;
  return p;
}

}  // namespace rs
