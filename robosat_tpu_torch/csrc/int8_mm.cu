// int8 matmul with a fused requantize epilogue on Hopper (kernel K2).
//
// Replaces the Pallas kernels benchmarks/bench_pallas_mm.py:make_mm_a and
// make_mm_b, the probe of the U-Net's 1x1 and per-tap int8 contractions:
//
//   acc = A(M, K) @ B(K, N)                      (int8 x int8 -> int32, exact)
//   out = clip(rint(f32(acc) * s), -127, 127)    (int8, half to even)
//
// in two orientations, each a template instantiation (the address and
// scale arithmetic is fixed at compile time, not read from a field):
//
//   A, channels-major: out(cout, P) = w(cout, cin) @ x(cin, P), s (cout, 1)
//   B, NHWC-flat:      out(P, cout) = x(P, cin) @ w(cin, cout), s (1, cout)
//
// In both, the left operand is K-contiguous and the right one N-contiguous.
// `mma.sync.m16n8k32` (int8_conv.cuh) takes both K-contiguous, so the right
// operand's tile is transposed while it is staged into shared memory: each
// thread loads four K rows of 16 bytes and transposes them as 4 x 4 byte
// blocks with __byte_perm.
//
// What bounds it on the H100: at the probe's shapes (cout 64-256, cin
// 64-1280, P = 165,888 or 41,472) it does 2 cout cin ops per (cin + cout)
// bytes of x and out, 64-256 ops per byte, below the ~590 int8 ops per byte
// where the tensor cores would become the limit: every shape is bound by
// device memory. Each block keeps one (BM, BN) output tile and streams K in
// chunks of 64; the tiles along the small dimension run next to each other,
// so the large operand's tile is read from device memory once and from L2
// by the rest. Simple by design: no cp.async pipeline, no wgmma/TMA.

#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_conv.cuh"

namespace {

enum Orientation { ORIENT_A = 0, ORIENT_B = 1 };

constexpr int kChunk = 64;           // K bytes per staged chunk
constexpr int kLd = kChunk + 16;     // shared row stride in bytes (fragment loads bank-conflict free)
constexpr int kMmThreads = 128;      // 4 warps as 2 (M) x 2 (N)

// Block tile: the small dimension (cout) gets 64, the long one (P) 128.
template <int ORIENT>
struct Tile {
  static constexpr int BM = ORIENT == ORIENT_A ? 64 : 128;
  static constexpr int BN = ORIENT == ORIENT_A ? 128 : 64;
};

// Four words x0..x3 of four bytes each (row r, byte j) -> word j holds
// byte j of x0, x1, x2, x3 (a 4 x 4 byte transpose).
__device__ __forceinline__ void transpose4x4(uint32_t x0, uint32_t x1, uint32_t x2, uint32_t x3, uint32_t* o) {
  const uint32_t t0 = __byte_perm(x0, x1, 0x5140);  // x0.b0 x1.b0 x0.b1 x1.b1
  const uint32_t t1 = __byte_perm(x2, x3, 0x5140);  // x2.b0 x3.b0 x2.b1 x3.b1
  const uint32_t t2 = __byte_perm(x0, x1, 0x7362);  // x0.b2 x1.b2 x0.b3 x1.b3
  const uint32_t t3 = __byte_perm(x2, x3, 0x7362);  // x2.b2 x3.b2 x2.b3 x3.b3
  o[0] = __byte_perm(t0, t1, 0x5410);
  o[1] = __byte_perm(t0, t1, 0x7632);
  o[2] = __byte_perm(t2, t3, 0x5410);
  o[3] = __byte_perm(t2, t3, 0x7632);
}

// The reference epilogue: f32(acc) * s rounded once, rint (half to even),
// clip to +-127.
__device__ __forceinline__ uint32_t requant(int acc, float s) {
  const float y = rintf(__fmul_rn(__int2float_rn(acc), s));
  return static_cast<uint32_t>(static_cast<int>(fminf(fmaxf(y, -127.0f), 127.0f))) & 0xffu;
}

// out(m, n) int8 = requant(a(m, k) @ b(k, n)); a K-contiguous, b and out
// N-contiguous; k and n multiples of 16.
template <int ORIENT>
__global__ void __launch_bounds__(kMmThreads) int8_mm_kernel(const int8_t* a, const int8_t* b, const float* scale,
                                                             int8_t* out, int m, int n, int k) {
  constexpr int BM = Tile<ORIENT>::BM;
  constexpr int BN = Tile<ORIENT>::BN;
  constexpr int MI = BM / 2 / 16;  // m16 tiles per warp
  constexpr int NI = BN / 2 / 8;   // n8 tiles per warp
  __shared__ __align__(16) int8_t a_s[BM * kLd];
  __shared__ __align__(16) int8_t b_s[BN * kLd];  // b's tile transposed: row n holds K contiguous

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_m = warp >> 1;
  const int warp_n = warp & 1;
  const int g = lane >> 2;
  const int tq = lane & 3;

  // The small dimension's tiles are the fastest-varying block index.
  int m0, n0;
  if (ORIENT == ORIENT_A) {
    const int tiles_m = (m + BM - 1) / BM;
    m0 = static_cast<int>(blockIdx.x % tiles_m) * BM;
    n0 = static_cast<int>(blockIdx.x / tiles_m) * BN;
  } else {
    const int tiles_n = (n + BN - 1) / BN;
    n0 = static_cast<int>(blockIdx.x % tiles_n) * BN;
    m0 = static_cast<int>(blockIdx.x / tiles_n) * BM;
  }

  int acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  for (int k0 = 0; k0 < k; k0 += kChunk) {
    // a: BM rows of 64 bytes, one 16-byte chunk (tid & 3) of rows (tid >> 2) + 32 i.
#pragma unroll
    for (int i = 0; i < BM / 32; ++i) {
      const int row = (tid >> 2) + 32 * i;
      const int col = (tid & 3) * 16;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + row < m && k0 + col < k) {
        v = *reinterpret_cast<const uint4*>(a + static_cast<size_t>(m0 + row) * k + k0 + col);
      }
      *reinterpret_cast<uint4*>(a_s + row * kLd + col) = v;
    }
    // b: 16 quads of K rows x BN / 16 chunks of 16 bytes; task t reads K
    // rows 4 (t % 16) .. + 3 of chunk t / 16 and stores 16 transposed words.
    for (int t = tid; t < 16 * (BN / 16); t += kMmThreads) {
      const int kq = t & 15;
      const int col = (t >> 4) * 16;
      uint4 r[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kr = k0 + 4 * kq + j;
        r[j] = make_uint4(0u, 0u, 0u, 0u);
        if (kr < k && n0 + col < n) {
          r[j] = *reinterpret_cast<const uint4*>(b + static_cast<size_t>(kr) * n + n0 + col);
        }
      }
      const uint32_t w0[4] = {r[0].x, r[0].y, r[0].z, r[0].w};
      const uint32_t w1[4] = {r[1].x, r[1].y, r[1].z, r[1].w};
      const uint32_t w2[4] = {r[2].x, r[2].y, r[2].z, r[2].w};
      const uint32_t w3[4] = {r[3].x, r[3].y, r[3].z, r[3].w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t o[4];
        transpose4x4(w0[q], w1[q], w2[q], w3[q], o);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          *reinterpret_cast<uint32_t*>(b_s + (col + 4 * q + j) * kLd + 4 * kq) = o[j];
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kChunk; kk += 32) {
      uint32_t af[MI][4];
      uint32_t bf[NI][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int8_t* base = a_s + (warp_m * (BM / 2) + mi * 16 + g) * kLd + kk + tq * 4;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(base);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(base + 8 * kLd);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(base + 16);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(base + 8 * kLd + 16);
      }
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int8_t* base = b_s + (warp_n * (BN / 2) + ni * 8 + g) * kLd + kk + tq * 4;
        bf[ni][0] = *reinterpret_cast<const uint32_t*>(base);
        bf[ni][1] = *reinterpret_cast<const uint32_t*>(base + 16);
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) rs::mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
    __syncthreads();
  }

  // Accumulator e of tile (mi, ni) sits at row g + 8 (e >> 1), column
  // 2 tq + (e & 1); the two columns store as one 16-bit word.
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + warp_m * (BM / 2) + mi * 16 + g + 8 * half;
      if (row >= m) continue;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int col = n0 + warp_n * (BN / 2) + ni * 8 + 2 * tq;
        if (col >= n) continue;
        const float s0 = ORIENT == ORIENT_A ? scale[row] : scale[col];
        const float s1 = ORIENT == ORIENT_A ? s0 : scale[col + 1];
        const uint32_t pair = requant(acc[mi][ni][2 * half], s0) | (requant(acc[mi][ni][2 * half + 1], s1) << 8);
        *reinterpret_cast<uint16_t*>(out + static_cast<size_t>(row) * n + col) = static_cast<uint16_t>(pair);
      }
    }
  }
}

template <int ORIENT>
int launch_int8_mm(const int8_t* a, const int8_t* b, const float* scale, int8_t* out, int m, int n, int k,
                   cudaStream_t stream) {
  const long long blocks = static_cast<long long>((m + Tile<ORIENT>::BM - 1) / Tile<ORIENT>::BM) *
                           ((n + Tile<ORIENT>::BN - 1) / Tile<ORIENT>::BN);
  if (blocks == 0) return 0;
  int8_mm_kernel<ORIENT><<<static_cast<unsigned>(blocks), kMmThreads, 0, stream>>>(a, b, scale, out, m, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// orient 0: A (scale per row of out), 1: B (scale per column). Returns the
// launch's CUDA error code (0 on success).
extern "C" int rs_int8_mm(const void* a, const void* b, const float* scale, void* out, int m, int n, int k, int orient,
                          void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int8_t* pa = static_cast<const int8_t*>(a);
  const int8_t* pb = static_cast<const int8_t*>(b);
  int8_t* po = static_cast<int8_t*>(out);
  if (orient == ORIENT_A) return launch_int8_mm<ORIENT_A>(pa, pb, scale, po, m, n, k, stream);
  if (orient == ORIENT_B) return launch_int8_mm<ORIENT_B>(pa, pb, scale, po, m, n, k, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
