// The Hopper int8 convolutions of kernels K3, K4, K5, K6, K7, K8 and K9,
// and of rs_int8_conv (qconv.cu, the fast family's dense convs): every
// int8 conv of the port.
//
// The TPU kernels it stands in for are robosat_tpu/models/qenc.py:203
// (bottleneck_block, stride 1) and :340 (bottleneck_block_s2), both on
// conv_kernel; robosat_tpu/models/qdec.py:273 (parity_up_conv) and :222
// (parity_up_conv_separated) on up_kernel; robosat_tpu/models/qtail.py:426
// (fused_tail), :204 (fused_tail_features) and :358
// (fused_tail_features_sep) on tail_kernel.
//
// The arithmetic of robosat_tpu/models/int8.py's _int8_conv, bit for bit:
// an implicit GEMM over NHWC activations (M = output pixels, N = Cout,
// K = taps x Cin) of bf16 inputs quantized as clip(rintf(__fmul_rn(v, inv)),
// -127, 127), exact int32 accumulators, and the dequant epilogue
// bf16_rne(__fadd_rn(__fmul_rn(f32(acc), ws * s), b)), then relu or
// residual-relu. With per-channel scales (the "pc" calibrations) the
// quantize multiplies channel c by its own reciprocal inv[c] and the
// epilogue's scale is ws alone (the scales are folded into the weights):
// the kernels' PC template parameter, off in the per-tensor instantiations,
// which compile to the same code as without it.
//
// What bounds it on the H100: at the main-path shapes the 1x1 convs of
// layers 1-2 move more bytes than the tensor cores need time for (64-256
// channels against ~590 int8 ops per byte at the ridge); the 3x3 convs and
// layers 3-4 are closer to the 1979 TOP/s int8 peak. A simple form
// (synchronous loads, a quantize and two barriers per 64 channels,
// mma.sync, an A tile staged once per 64 output channels) reaches 1-5% of
// that peak. The design here:
//
// - wgmma.mma_async m64nNk32 s32.s8.s8 with both operands in shared memory
//   (K-major, the 16-byte core-matrix layout without swizzle: core matrix
//   (row / 8, k / 16) at ((row / 8) * 4 + k / 16) * 128 bytes, row % 8 at
//   16 bytes each), output tiles of 64 pixels (one consumer warpgroup, two
//   CTAs to an SM; 128-pixel tiles with two consumer warpgroups and one CTA
//   to an SM measured no faster) by BN = 64 or 128 channels.
// - Persistent CTAs walk their output tiles; a producer warpgroup runs
//   ahead through the (tile, K step) items into a ring of shared-memory
//   stages under mbarriers (full: one arrival per producer warp + the
//   weight copy's bytes; empty: one arrival per consumer warp), so loads
//   overlap the MMAs and the previous tile's epilogue. A stage holds one
//   tap's 64 input channels of 64 pixels and BN output channels of weights.
//   - int8 activations: cp.async 16 B with zero-fill (src-size 0) for
//     pixels outside the image or the grid and channels past Cin: the
//     implicit-GEMM gather with the conv's zero padding. Each thread keeps
//     two items of copies in flight; its warp arrives for the oldest once
//     the thread's own group for it has landed (cp.async.wait_group).
//   - bf16 activations (a block's input, dec3's output): cp.async into a
//     ring of raw bf16 tiles several items ahead, quantized once per tile
//     by the thread that copied them (quantize8, below), stored
//     into the stage, then fence.proxy.async before the arrival.
//   - weights: one cp.async.bulk per stage from a copy packed on the host in
//     the stage's core-matrix order (qenc.packed_weights).
// - Epilogues stage the tile in shared memory, then store 16 bytes a thread
//   along rows. They can store int8 for the next conv (the quantize of the
//   bf16 value with the consumer's reciprocal scale: the bytes the
//   consumer's on-load quantize computed), so h1, h2 and dec4's output
//   move 1 byte per channel and reach the next conv by plain async copies.
// - K6 (tail_kernel, below): its two convs keep every nonzero 32 x 32
//   weight block in shared memory and multiply 8 x 8-pixel output tiles
//   against a 10 x 10-pixel halo staged once per tile, each tap a window of
//   it; MMAs run only over the host's list of nonzero blocks. A zero block
//   adds nothing to an int32 sum, so this is exact for any weights; on the
//   s2d weights it does the 68 G MACs per batch the function needs instead
//   of the dense form's 196 G. K6's dec5 epilogue is the head: the staged
//   bf16 relu activations go through head.cuh's margin in its order
//   (margin32, four FMA accumulators), then the sigmoid and the exact
//   digitize; dec5's activations never reach device memory. K7's and K9's
//   dec5 store them as bf16 (EPI_RELU); K9's tensors are parity planes,
//   which the halo copy and the store address (input and output layouts
//   are template parameters; the conv runs on the fine grid).
// - K5 and K8 (up_kernel, at the end): the four parity convs of an
//   up-block from one 10 x 10 halo per 8 x 8-pixel coarse tile and
//   64-channel chunk, against weight slabs streamed per K step and shared
//   by two consumer warpgroups on two tiles; the output layout (K5: the
//   fine NHWC grid, K8: its parity planes) is a template parameter that
//   only the store address reads.
// - K4: conv_kernel with STRIDE = 2 for conv2 and the projection; only the
//   producer's gather differs.
// - rs_int8_conv's stride-1 3x3 convs (halo_conv_kernel, at the end):
//   up_kernel's loop with one accumulator, nine taps as windows of a halo
//   of side 8 + 2 dil; its stride-2 convs run conv_kernel with a bf16
//   input.
//
// Where conv_kernel stands (PERF.md): the MMAs are not the limit; a K step
// is bound by the pipeline's handshakes and by the bytes each stage pulls
// from L2 (the weight tile re-read per 64-row tile, a 3x3 conv's input once
// per tap), and the 1x1 convs by their epilogues' device-memory traffic.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "head.cuh"

namespace rs {

// Epilogues of store_tile with a bf16 output; sm90 adds two more.
enum Epilogue { EPI_LINEAR = 0, EPI_RELU = 1, EPI_RESIDUAL_RELU = 2 };
// How an activation grid (N, H, W, C) lies in memory: NHWC, or as parity
// planes, the space_to_depth2 layout (N, H / 2, W / 2, 4 C) in which pixel
// (y, x) channel c sits at plane pixel (y / 2, x / 2), channel
// (2 (y % 2) + x % 2) C + c.
enum Layout { LAYOUT_NHWC = 0, LAYOUT_PLANES = 1 };

namespace sm90 {

// Epilogues beyond EPI_LINEAR / EPI_RELU / EPI_RESIDUAL_RELU (bf16 out).
constexpr int EPI_RELU_Q8 = 3;  // relu, then int8 with the next conv's reciprocal scale
constexpr int EPI_HEAD = 4;     // relu, then the blocked margin head to uint8 (Cout = 128)

constexpr int kBM = 64;             // output pixels per tile: one consumer warpgroup, two CTAs to an SM
constexpr int kBK = 64;             // int8 channels per stage
constexpr int kCoreBytes = 128;     // one 8 x 16-byte core matrix
constexpr int kLbo = kCoreBytes;    // next core matrix along K
constexpr int kSbo = kCoreBytes * (kBK / 16);  // next 8-row group along M or N

struct Params {
  const void* x;           // (n, h, w, cin): bf16 (IN_BF16) or int8
  const int8_t* wp;        // packed weights: (steps, cout_pad * 64) core-matrix slabs
  int n_steps;             // K steps: taps * ceil(cin / 64)
  const float* scale;      // (cout,) ws * s
  const float* bias;       // (cout,) or nullptr
  const __nv_bfloat16* residual;  // (n, h, w, cout) bf16 for EPI_RESIDUAL_RELU
  void* y;                 // bf16 (linear, residual), int8 (EPI_RELU_Q8) or uint8 (EPI_HEAD) output
  const float* wmb;        // EPI_HEAD: 32 margin weights and the margin bias
  float inv_in;            // reciprocal scale of a bf16 input
  float inv_out;           // EPI_RELU_Q8: reciprocal scale of the next conv's input
  const float* inv_in_v;   // PC: per-channel reciprocals of a bf16 input (cin, zero-padded to a multiple of 64)
  const float* inv_out_v;  // PC, EPI_RELU_Q8: per-channel reciprocals of the next conv's input (cout)
  int n, h, w, cin, cout, cout_pad;
  int ho, wo;              // output grid of conv_kernel (conv_params: ((h - 1) / stride + 1, (w - 1) / stride + 1))
  int k, pad;              // k x k taps, `pad` zero rows before the first row (conv_kernel's stride is a template parameter)
  int pad_w, dil;          // conv_kernel: zero columns before the first column, the taps' dilation
  int crop;                // EPI_HEAD: overlap crop o on each side of the grid
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the phase after `parity`. A wait of 2^35 cycles (over 15 s)
// means a lost arrival: trap (a launch failure at the next synchronize)
// rather than hang the card. The SM's cycle counter is cheap to read
// (%globaltimer is not).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > (1LL << 35)) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

// 16 bytes global -> shared; src_bytes = 0 writes zeros without reading.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
               "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Wait until at most N of this thread's cp.async groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }

__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Shared-memory matrix descriptor: K-major, no swizzle (layout type 0):
// 8 x 16-byte core matrices whose rows lie 16 bytes apart, the next core
// matrix along K `lbo` bytes on, the next 8 rows `sbo` bytes on.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo = kLbo, uint32_t sbo = kSbo) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// The activation quantize, clip(rintf(__fmul_rn(v, inv)), -127, 127), of
// 8 bf16 (4 packed pairs) into 8 int8: the clip of the product, then one
// round-to-nearest-even conversion (the same values, NaN included), bytes
// packed with byte_perm. A pair's low half is the lower channel.
__device__ __forceinline__ uint32_t quantize_pair(uint32_t bf16x2, float inv_lo, float inv_hi) {
  const int lo = __float2int_rn(fminf(fmaxf(__fmul_rn(__uint_as_float(bf16x2 << 16), inv_lo), -127.0f), 127.0f));
  const int hi =
      __float2int_rn(fminf(fmaxf(__fmul_rn(__uint_as_float(bf16x2 & 0xffff0000u), inv_hi), -127.0f), 127.0f));
  return __byte_perm(lo, hi, 0x0040);  // bytes 0, 1: lo, hi
}

__device__ __forceinline__ uint2 quantize8(uint4 v, float inv) {
  return make_uint2(__byte_perm(quantize_pair(v.x, inv, inv), quantize_pair(v.y, inv, inv), 0x5410),
                    __byte_perm(quantize_pair(v.z, inv, inv), quantize_pair(v.w, inv, inv), 0x5410));
}

// Per channel: channel j of the 8 by inv[j] (read-only, 32-byte aligned:
// two 16-byte loads).
__device__ __forceinline__ uint2 quantize8(uint4 v, const float* inv) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(inv));
  const float4 b = __ldg(reinterpret_cast<const float4*>(inv) + 1);
  return make_uint2(__byte_perm(quantize_pair(v.x, a.x, a.y), quantize_pair(v.y, a.z, a.w), 0x5410),
                    __byte_perm(quantize_pair(v.z, b.x, b.y), quantize_pair(v.w, b.z, b.w), 0x5410));
}

// The quantize of the 8 channels from channel c: per tensor by `inv`, or
// (PC) per channel by inv_v[c], ..., inv_v[c + 7].
template <bool PC>
__device__ __forceinline__ uint2 quantize8_at(uint4 v, float inv, const float* inv_v, int c) {
  if constexpr (PC) {
    return quantize8(v, inv_v + c);
  } else {
    return quantize8(v, inv);
  }
}

// Byte offset of (row, k) in a tile of 64-byte K rows in core-matrix order.
__device__ __forceinline__ int tile_offset(int row, int k) {
  return ((row >> 3) * (kBK / 16) + (k >> 4)) * kCoreBytes + (row & 7) * 16 + (k & 15);
}

// wgmma.mma_async m64nNk32, s8 x s8 -> s32, d += a * b, both operands from
// shared memory. Accumulator d[4 j + e] of thread t of the warpgroup is row
// 16 (t / 32) + (t % 32) / 4 + 8 (e / 2), column 8 j + 2 (t % 4) + e % 2.
template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(int* d, uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(int* d, uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(int* d, uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};

inline int sm_count() {
  static int count = 0;
  if (count == 0) {
    int device = 0;
    if (cudaGetDevice(&device) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) {
      count = 132;
    }
  }
  return count;
}

// The f32 value of the dequant epilogue before its bf16 rounding:
// f32(acc) * scale (+ bias), two roundings, no FMA (the explicit _rn
// intrinsics keep nvcc from contracting them). store_tile rounds two at a
// time to bf16 (RNE) and applies relu to the rounded pair (the bf16 values
// of relu before the rounding; a -0 may come out +0, which no consumer of
// the staged tile tells apart).
__device__ __forceinline__ float dequant(int acc, float scale, float bias, bool has_bias) {
  const float v = __fmul_rn(__int2float_rn(acc), scale);
  return has_bias ? __fadd_rn(v, bias) : v;
}

// Two bf16 pairs -> bf16(relu(a + b)) per lane, the f32 add rounded once.
__device__ __forceinline__ uint32_t residual_relu2(uint32_t a, uint32_t b) {
  const float lo = fmaxf(__fadd_rn(__uint_as_float(a << 16), __uint_as_float(b << 16)), 0.0f);
  const float hi = fmaxf(__fadd_rn(__uint_as_float(a & 0xffff0000u), __uint_as_float(b & 0xffff0000u)), 0.0f);
  const __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&r);
}

// Bytes of the epilogue's staged tile: kBM rows of BN bf16, padded so the
// stores from the accumulator layout do not conflict in shared-memory banks.
template <int BN>
__host__ __device__ constexpr int out_bytes() {
  return kBM * (BN + 8) * 2;
}

// The epilogue of a kBM x BN output tile, run by a consumer warpgroup
// (`tid` its thread 0-127, `bar` its named barrier): stage
// bf16(acc * scale (+ b)) (relu'd where the epilogue has it) in `out_s`,
// then finish 16 bytes a thread with row-contiguous global loads and
// stores (EPI_HEAD: the margin head, two threads a pixel). `pixel(r)` is
// tile row r's output pixel, -1 past the grid; acc is in wgmma's
// accumulator layout for output channels n0...
// head.cuh's digitize with the anchors read from a table: anchors[i] is
// fl((i - 1) / 255) for i in [0, 258), the values digitize divides out.
__device__ __forceinline__ unsigned char digitize_table(float prob, const float* anchors) {
  const float kf = rintf(__fmul_rn(prob, 255.0f));
  const int k = static_cast<int>(kf);
  const int q = (k - 1) + (anchors[k] <= prob) + (anchors[k + 1] <= prob) + (anchors[k + 2] <= prob);
  return static_cast<unsigned char>(q & 0xff);
}

// Fill the anchors of digitize_table (258 floats) with `threads` threads.
__device__ __forceinline__ void fill_anchors(float* anchors, int tid, int threads) {
  for (int i = tid; i < 258; i += threads) anchors[i] = __fdiv_rn(static_cast<float>(i - 1), 255.0f);
}

template <int BN, int EPI, bool PC = false, typename PixelOf>
__device__ __forceinline__ void store_tile(const Params& p, const int* acc, __nv_bfloat16* out_s, int n0, int tid,
                                           int bar, PixelOf pixel, const float* anchors = nullptr) {
  constexpr int kOutStride = BN + 8;
  constexpr int kPre = EPI == EPI_LINEAR || EPI == EPI_RESIDUAL_RELU ? EPI_LINEAR : EPI_RELU;
  const int lane = tid & 31;
  const int row0 = (tid >> 5) * 16 + (lane >> 2);  // tile row of acc[4 j], +8 for acc[4 j + 2]
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + 2 * (lane & 3);
    const int gcol = n0 + col;
    const bool in = gcol < p.cout;
    // Read-only loads (ld.global.nc), so they need not wait for the
    // staging stores.
    const float s0 = in ? __ldg(p.scale + gcol) : 0.0f;
    const float s1 = in ? __ldg(p.scale + gcol + 1) : 0.0f;
    const float b0 = in && p.bias != nullptr ? __ldg(p.bias + gcol) : 0.0f;
    const float b1 = in && p.bias != nullptr ? __ldg(p.bias + gcol + 1) : 0.0f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      __nv_bfloat162 v = __floats2bfloat162_rn(dequant(acc[4 * j + 2 * half], s0, b0, p.bias != nullptr),
                                               dequant(acc[4 * j + 2 * half + 1], s1, b1, p.bias != nullptr));
      if (kPre == EPI_RELU) v = __hmax2(v, __float2bfloat162_rn(0.0f));
      *reinterpret_cast<__nv_bfloat162*>(out_s + (row0 + 8 * half) * kOutStride + col) = v;
    }
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(bar) : "memory");
  if (EPI == EPI_HEAD) {
    // Two threads per pixel, each taking two of its four 32-channel groups
    // through the margin head (Cout = BN = 128), cropped by p.crop.
    const int row = tid >> 1;
    const int m = pixel(row);
    if (m >= 0) {
      const int hw = p.h * p.w;
      const int img = m / hw;
      const int rem = m - img * hw;
      const int y = rem / p.w;
      const int x = rem - y * p.w;
      const int o = p.crop;
      if (y >= o && y < p.h - o && x >= o && x < p.w - o) {
        unsigned char* out = static_cast<unsigned char*>(p.y) +
                             ((static_cast<size_t>(img) * (p.h - 2 * o) + (y - o)) * (p.w - 2 * o) + (x - o)) * 4;
#pragma unroll
        for (int gg = 0; gg < 2; ++gg) {
          const int g = 2 * (tid & 1) + gg;
          out[g] = digitize_table(sigmoid(margin32(out_s + row * kOutStride + 32 * g, p.wmb, 4)), anchors);
        }
      }
    }
  } else {
    constexpr int kChunks = BN / 8;               // 16-byte chunks of a staged row
    constexpr int kPasses = kBM * kChunks / 128;  // chunks per thread
    uint4 v[kPasses], r[kPasses];
    bool live[kPasses];
    size_t off[kPasses];
    // All loads first (the residual's may not be reordered after the stores).
#pragma unroll
    for (int i = 0; i < kPasses; ++i) {
      const int q = tid + 128 * i;
      const int row = q / kChunks;
      const int col = n0 + 8 * (q % kChunks);
      const int m = pixel(row);
      live[i] = m >= 0 && col < p.cout;
      off[i] = static_cast<size_t>(m) * p.cout + col;
      v[i] = *reinterpret_cast<const uint4*>(out_s + row * kOutStride + 8 * (q % kChunks));
      if (EPI == EPI_RESIDUAL_RELU && live[i]) r[i] = *reinterpret_cast<const uint4*>(p.residual + off[i]);
    }
#pragma unroll
    for (int i = 0; i < kPasses; ++i) {
      if (!live[i]) continue;
      if (EPI == EPI_RELU_Q8) {
        const int col = n0 + 8 * ((tid + 128 * i) % kChunks);
        *reinterpret_cast<uint2*>(static_cast<int8_t*>(p.y) + off[i]) =
            quantize8_at<PC>(v[i], p.inv_out, p.inv_out_v, col);
      } else if (EPI == EPI_RESIDUAL_RELU) {
        *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(p.y) + off[i]) =
            make_uint4(residual_relu2(v[i].x, r[i].x), residual_relu2(v[i].y, r[i].y), residual_relu2(v[i].z, r[i].z),
                       residual_relu2(v[i].w, r[i].w));
      } else {
        *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(p.y) + off[i]) = v[i];
      }
    }
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(bar) : "memory");  // the staged rows are read: the next tile may stage
}

// Shared-memory plan of conv_kernel: kRing x (A tile kBM x 64, B tile
// BN x 64), (IN_BF16) the producer's ring of kRawTiles raw bf16 A tiles
// (kBM rows of 128 bytes), the staged output tile, then the full and empty
// barriers. Sized so that two CTAs fit an SM.
template <int BN, bool IN_BF16>
struct Smem {
  static constexpr int kRing = IN_BF16 ? 4 : 6;
  static constexpr int kRawBytes = 32768;
  static constexpr int kA = kBM * kBK;
  static constexpr int kB = BN * kBK;
  static constexpr int kStage = kA + kB;
  static constexpr int kRawTile = kBM * kBK * 2;
  static constexpr int kRawTiles = kRawBytes / kRawTile;
  static constexpr int kRaw = kStage * kRing;
  static constexpr int kOut = kRaw + (IN_BF16 ? kRawBytes : 0);
  static constexpr int kBars = kOut + out_bytes<BN>();
  static constexpr int kBytes = kBars + 2 * 8 * kRing;
};

// A dense conv of stride STRIDE (1: K3 and K4's 1x1 convs; 2: K4's conv2
// and projection) and dilation p.dil, which gathers input pixel
// (STRIDE oh + dil tap row - pad, STRIDE ow + dil tap column - pad_w) for
// output pixel (oh, ow) and reads zeros outside the input: `pad` rows and
// `pad_w` columns of zero padding before the grid, and after it as far as
// the output grid (ho, wo) reaches. K4's stride-2 convs take torch's
// (1, 1) padding (a zero row above and a zero column to the left of an
// even grid); rs_int8_conv (qconv.cu) takes any, e.g. XLA's "SAME" at
// stride 2, (0, 1) on an even grid, or (2, 2) at dilation 2.
// Persistent: CTA b computes output tiles b,
// b + gridDim.x, ... (tile t is rows [kBM (t / tiles_n), +kBM) and channels
// [BN (t % tiles_n), +BN), so the CTAs running side by side share their A
// tiles through L2). Threads [0, 128): the consumer warpgroup, which
// multiplies and runs the epilogue. Threads [128, 256): the producer
// warpgroup, which runs through this CTA's (tile, K step) items without
// waiting for epilogues, so the next tile's loads overlap this tile's
// epilogue. PC: per-channel reciprocals on load (p.inv_in_v) and in
// EPI_RELU_Q8 (p.inv_out_v).
template <int BN, bool IN_BF16, int EPI, int STRIDE, bool PC = false>
__global__ void __launch_bounds__(256, 2) conv_kernel(const __grid_constant__ Params p) {
  using S = Smem<BN, IN_BF16>;
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x;
  const uint32_t base = smem_u32(smem);
  const uint32_t full0 = base + S::kBars;  // full[s] at full0 + 8 s
  const uint32_t empty0 = full0 + 8 * S::kRing;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < S::kRing; ++s) {
      mbar_init(full0 + 8 * s, 4 + 1);  // one arrival per producer warp, one with the weight copy's bytes
      mbar_init(empty0 + 8 * s, 4);     // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int m_total = p.n * p.ho * p.wo;  // output pixels; launch checks it fits
  const int hw = p.ho * p.wo;
  const int tiles_n = (p.cout + BN - 1) / BN;
  const int n_tiles = (m_total + kBM - 1) / kBM * tiles_n;
  const int chunks = (p.cin + kBK - 1) / kBK;

  if (tid >= 128) {
    // ---- producer: item it = (this CTA's tile it / n_steps, K step it % n_steps) -> stage it % kRing ----
    const int pt = tid - 128;
    const int lane = pt & 31;
    // int8 input: a thread keeps kLag items of copies in flight before its
    // warp arrives for the oldest (the ring must hold kLag + 2 items).
    constexpr int kLag = 2;
    static_assert(S::kRing >= kLag + 2, "the ring is too short for the arrival lag");
    constexpr int kPieces = 4 * (IN_BF16 ? 2 : 1);  // 16-byte pieces per 64-channel row
    constexpr int kRowsPerPass = 128 / kPieces;
    constexpr int kItems = kBM / kRowsPerPass;
    const int piece = pt % kPieces;
    const int n_items = (static_cast<int>(blockIdx.x) < n_tiles
                             ? (n_tiles - 1 - static_cast<int>(blockIdx.x)) / static_cast<int>(gridDim.x) + 1
                             : 0) * p.n_steps;
    // The A copies walk the items in order, one step ahead of (int8) or
    // kRawTiles ahead of (bf16) the weight copies: each keeps its own
    // cursor, and the A cursor the coordinates of its tile's rows: the
    // image and the input pixel under the output pixel (STRIDE oh, STRIDE ow).
    int a_tile = blockIdx.x, a_ks = 0;
    int img[kItems], oh[kItems], ow[kItems];
    auto locate = [&]() {
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const int m = a_tile / tiles_n * kBM + pt / kPieces + kRowsPerPass * i;
        img[i] = m < m_total ? m / hw : -1;
        const int rem = m - img[i] * hw;
        const int r = rem / p.wo;
        oh[i] = STRIDE * r;
        ow[i] = STRIDE * (rem - r * p.wo);
      }
    };
    locate();
    // This thread's 16-byte copies of the A cursor's item: into a raw bf16
    // tile at `dst` (row r at 128 r), or into an int8 stage (core-matrix
    // order); then the cursor moves on.
    auto copy_a = [&](uint32_t dst) {
      const int tap = a_ks / chunks;
      const int c = (a_ks - tap * chunks) * kBK + piece * (16 / (IN_BF16 ? 2 : 1));
      const int dr = tap / p.k * p.dil - p.pad;
      const int dc = tap % p.k * p.dil - p.pad_w;
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const int row = pt / kPieces + kRowsPerPass * i;
        const int hi = oh[i] + dr;
        const int wi = ow[i] + dc;
        const bool valid = img[i] >= 0 && c < p.cin && hi >= 0 && hi < p.h && wi >= 0 && wi < p.w;
        const size_t off = valid ? (((static_cast<size_t>(img[i]) * p.h + hi) * p.w + wi) * p.cin + c) * (IN_BF16 ? 2 : 1) : 0;
        const uint32_t at = IN_BF16 ? dst + row * (2 * kBK) + piece * 16 : dst + tile_offset(row, piece * 16);
        cp_async16(at, static_cast<const uint8_t*>(p.x) + off, valid ? 16 : 0);
      }
      if (++a_ks == p.n_steps) {
        a_ks = 0;
        a_tile += gridDim.x;
        if (a_tile < n_tiles) locate();
      }
    };
    // The weight tile of the B cursor's item into stage s, counted on full[s].
    int b_tile = blockIdx.x, b_ks = 0;
    auto copy_b = [&](int s) {
      if (pt == 0) {
        mbar_arrive_expect_tx(full0 + 8 * s, S::kB);
        bulk_copy(base + s * S::kStage + S::kA,
                  p.wp + (static_cast<size_t>(b_ks) * p.cout_pad + b_tile % tiles_n * BN) * kBK, S::kB, full0 + 8 * s);
      }
      if (++b_ks == p.n_steps) {
        b_ks = 0;
        b_tile += gridDim.x;
      }
    };
    const uint32_t raw0 = base + S::kRaw;
    if (IN_BF16) {
      // bf16 input: cp.async into a ring of raw tiles kRawTiles items
      // ahead; each thread quantizes the 16-byte pieces it copied itself
      // (no barrier), stores the int8 into the stage, then fences the
      // generic-proxy stores for wgmma before it arrives.
#pragma unroll
      for (int r = 0; r < S::kRawTiles; ++r) {
        if (r < n_items) copy_a(raw0 + r * S::kRawTile);
        cp_async_commit();
      }
    }
    for (int it = 0; it < n_items; ++it) {
      const int s = it % S::kRing;
      if (it >= S::kRing) mbar_wait(empty0 + 8 * s, ((it / S::kRing) - 1) & 1);
      copy_b(s);
      if (IN_BF16) {
        cp_async_wait_group<S::kRawTiles - 1>();
        const int slot = it % S::kRawTiles;
        // Item it is K step it % n_steps of its tile: this thread's 8 channels of its chunk start at c.
        const int c = PC ? it % p.n_steps % chunks * kBK + piece * 8 : 0;
#pragma unroll
        for (int i = 0; i < kItems; ++i) {
          const int row = pt / kPieces + kRowsPerPass * i;
          const uint4 v = *reinterpret_cast<const uint4*>(smem + S::kRaw + slot * S::kRawTile + row * (2 * kBK) + piece * 16);
          *reinterpret_cast<uint2*>(smem + s * S::kStage + tile_offset(row, piece * 8)) =
              quantize8_at<PC>(v, p.inv_in, p.inv_in_v, c);
        }
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) mbar_arrive(full0 + 8 * s);
        if (it + S::kRawTiles < n_items) copy_a(raw0 + slot * S::kRawTile);
        cp_async_commit();
      } else {
        // int8 input: cp.async straight into the stage; the warp arrives
        // for item it - kLag once its own copies of that item have landed.
        copy_a(base + s * S::kStage);
        cp_async_commit();
        if (it >= kLag) {
          cp_async_wait_group<kLag>();
          __syncwarp();
          if (lane == 0) mbar_arrive(full0 + 8 * ((it - kLag) % S::kRing));
        }
      }
    }
    if (!IN_BF16) {
      cp_async_wait_group<0>();
      __syncwarp();
      for (int it = n_items > kLag ? n_items - kLag : 0; it < n_items; ++it) {
        if (lane == 0) mbar_arrive(full0 + 8 * (it % S::kRing));
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // ---- consumer warpgroup ----
  const int lane = tid & 31;
  int it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int m0 = tile / tiles_n * kBM;
    const int n0 = (tile % tiles_n) * BN;
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    for (int ks = 0; ks < p.n_steps; ++ks) {
      const int s = it % S::kRing;
      mbar_wait(full0 + 8 * s, (it / S::kRing) & 1);
      fence_proxy_async();  // the producer's cp.async bytes, for the async proxy
      const uint32_t a_addr = base + s * S::kStage;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk) {
        Wgmma<BN>::mma(acc, desc(a_addr + kk * 2 * kCoreBytes), desc(a_addr + S::kA + kk * 2 * kCoreBytes));
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (ks > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((it - 1) % S::kRing));  // the previous stage is read
      ++it;
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(empty0 + 8 * ((it - 1) % S::kRing));
    store_tile<BN, EPI, PC>(p, acc, reinterpret_cast<__nv_bfloat16*>(smem + S::kOut), n0, tid, 1,
                            [&](int r) { return m0 + r < m_total ? m0 + r : -1; });
  }
}

// Launch one dense conv, as many CTAs as fit on the card at once (at most
// one per tile); returns the CUDA error code (0 on success).
template <int BN, bool IN_BF16, int EPI, int STRIDE, bool PC = false>
int launch(const Params& p, cudaStream_t stream) {
  using S = Smem<BN, IN_BF16>;
  const long long m_total = static_cast<long long>(p.n) * p.ho * p.wo;
  // The last output row's and column's windows start inside the padded input.
  if (p.ho < 1 || p.wo < 1 || p.dil < 1 || p.pad < 0 || p.pad_w < 0 || (p.ho - 1) * STRIDE - p.pad >= p.h ||
      (p.wo - 1) * STRIDE - p.pad_w >= p.w) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m_total + kBM >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const long long n_tiles = (m_total + kBM - 1) / kBM * ((p.cout + BN - 1) / BN);
  if (n_tiles == 0) return 0;
  if (PC && ((IN_BF16 && p.inv_in_v == nullptr) || (EPI == EPI_RELU_Q8 && p.inv_out_v == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = conv_kernel<BN, IN_BF16, EPI, STRIDE, PC>;
  static long long resident = 0;  // CTAs of this instantiation the card holds at once, found at first launch
  if (resident == 0) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kBytes);
    int per_sm = 0;
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 256, S::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    resident = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sm_count();
  }
  kernel<<<static_cast<unsigned>(n_tiles < resident ? n_tiles : resident), 256, S::kBytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// A dense conv: BN = 64 up to 64 output channels, else 128.
template <bool IN_BF16, int EPI, int STRIDE = 1, bool PC = false>
int launch_dense(const Params& p, cudaStream_t stream) {
  return p.cout <= 64 ? launch<64, IN_BF16, EPI, STRIDE, PC>(p, stream)
                      : launch<128, IN_BF16, EPI, STRIDE, PC>(p, stream);
}

// A k x k conv (k odd) of stride `stride` with k / 2 rows and columns of
// zero padding before the grid over NHWC x (stride 1: SAME), dilation 1;
// `wp` packed by qenc.packed_weights as (k * k * ceil(cin / 64),
// cout_pad * 64). rs_int8_conv sets pad, pad_w, dil, ho and wo after it.
inline Params conv_params(const void* x, const void* wp, const float* scale, const float* bias, void* y, float inv_in,
                          float inv_out, int n, int h, int w, int cin, int cout, int k, int stride = 1) {
  Params p;
  p.x = x;
  p.wp = static_cast<const int8_t*>(wp);
  p.n_steps = k * k * ((cin + kBK - 1) / kBK);
  p.scale = scale;
  p.bias = bias;
  p.residual = nullptr;
  p.y = y;
  p.wmb = nullptr;
  p.inv_in = inv_in;
  p.inv_out = inv_out;
  p.inv_in_v = nullptr;
  p.inv_out_v = nullptr;
  p.n = n;
  p.h = h;
  p.w = w;
  p.ho = (h - 1) / stride + 1;
  p.wo = (w - 1) / stride + 1;
  p.cin = cin;
  p.cout = cout;
  p.cout_pad = (cout + 127) / 128 * 128;
  p.k = k;
  p.pad = k / 2;
  p.pad_w = k / 2;
  p.dil = 1;
  p.crop = 0;
  return p;
}

// ---- K6's, K7's and K9's convs: dec4 and dec5 over the listed nonzero weight blocks ----
//
// A 3x3 SAME conv of 128 -> 128 channels whose int8 weights are cut into
// (tap, 32-channel input block kb, 32-wide output slice ns) blocks of
// 32 x 32; the host lists the blocks that are not all zero
// (qtail.block_operands) and packs them in wgmma's core-matrix order. A
// CTA keeps all listed blocks in shared memory (one bulk copy per CTA:
// 64 KB for dec4's s2d weights, 36 KB for dec5's), and computes 8 x 8-pixel
// output tiles: the producer stages each tile's 10 x 10-pixel halo once
// (int8; a bf16 input is quantized on the way) in a layout whose rows are
// single pixels 16 bytes apart, so every tap is a window of it at an
// offset and every listed block is one m64n32k32 MMA on that window. The
// MMAs of a tile are one straight run of NB per output slice (NB a
// template parameter: 9, 16 or 36), so ptxas keeps them asynchronous; a
// slice with fewer listed blocks is padded with an all-zero block, which
// only the odd weights whose slices differ in count ever need. The input
// and the output each lie as NHWC or as parity planes (K9: the
// space_to_depth2 layout of the fine grid), template parameters of the
// kernel: only the addresses of the halo copy and of the store change.
constexpr int kMaxBlocks = 144;       // 9 taps x 4 input blocks x 4 output slices (+1 zero block)
constexpr int kBlockBytes = 32 * 32;  // one packed weight block
constexpr int kHalo = 10;             // halo side of an 8 x 8 output tile
constexpr int kPlane = kHalo * kHalo * 16;  // one 16-channel plane of an int8 halo: its core matrices' K stride
constexpr int kHaloBytes = 8 * kPlane;      // 128 channels
__host__ __device__ constexpr int tail_ring(bool in_bf16) { return in_bf16 ? 3 : 4; }  // int8 halo slots
constexpr int kSmemMax = 232448;            // shared memory a block may use

// Index of pixel (y, x) of image img among the C-channel pixels of an
// (n, h, w, C) grid laid out as LAYOUT: NHWC, or parity planes
// (n, h / 2, w / 2, 4 C), where plane pixel (y / 2, x / 2) holds the pixels
// of its 2 x 2 block in the order 2 (y % 2) + x % 2, each pixel's C channels
// together: in units of whole pixels, so for any C. The launch checks that
// the count fits an int.
template <int LAYOUT>
__device__ __forceinline__ int tail_pixel(int img, int y, int x, int h, int w) {
  if (LAYOUT == LAYOUT_PLANES) {
    return (((img * (h >> 1) + (y >> 1)) * (w >> 1) + (x >> 1)) << 2) | ((y & 1) << 1) | (x & 1);
  }
  return (img * h + y) * w + x;
}

struct TailParams {
  Params conv;           // x, scale, y, inv_in, inv_out, wmb, crop, n, h, w (cin = cout = 128, 3x3)
  const int8_t* blocks;  // the listed blocks, packed, then one zero block: nb x kBlockBytes
  int nb;                // packed blocks
  int per_slice;         // MMAs per output slice (the launched kernel's NB)
  int raw_tiles;         // bf16 input: raw halo tiles in flight (1-3, as shared memory allows)
  int mma[kMaxBlocks];   // the MMA b of slice ns at ns * per_slice + b: tap | kb << 4 | packed block << 8
};

// Shared-memory plan of tail_kernel: the blocks, `ring` int8 halos,
// (bf16 input) raw_tiles raw halos, a staged output tile per consumer
// warpgroup (wgs of them), the barriers.
struct TailSmem {
  int halos, raw, out, anchors, bars, bytes;
  __host__ __device__ TailSmem(int nb, int ring, int raw_tiles, int wgs) {
    halos = nb * kBlockBytes;
    raw = halos + ring * kHaloBytes;
    out = raw + raw_tiles * 2 * kHaloBytes;
    anchors = out + wgs * out_bytes<128>();
    bars = anchors + 258 * 4 + 8;
    bytes = bars + 8 * (2 * ring + 1);
  }
};

// Threads [0, 128 WGS): WGS consumer warpgroups, taking this CTA's tiles
// in turn, so one's MMAs overlap another's epilogue (WGS = 1 only where
// shared memory holds no second staged tile). Threads [128 WGS,
// 128 WGS + 128): the producer warpgroup. x lies in IN_LAYOUT, y in
// OUT_LAYOUT (NHWC for the head, which crops on the grid). PC: per-channel
// reciprocals on load and in EPI_RELU_Q8.
template <bool IN_BF16, int EPI, int NB, int WGS, int IN_LAYOUT, int OUT_LAYOUT, bool PC = false>
__global__ void __launch_bounds__(384, 1) tail_kernel(const __grid_constant__ TailParams tp) {
  static_assert(EPI != EPI_HEAD || OUT_LAYOUT == LAYOUT_NHWC, "the head stores NHWC");
  const Params& p = tp.conv;
  extern __shared__ __align__(128) uint8_t smem[];
  constexpr int kRing = tail_ring(IN_BF16);
  const TailSmem L(tp.nb, kRing, IN_BF16 ? tp.raw_tiles : 0, WGS);
  const int tid = threadIdx.x;
  const uint32_t base = smem_u32(smem);
  const uint32_t full0 = base + L.bars;  // full[s] at full0 + 8 s
  const uint32_t empty0 = full0 + 8 * kRing;
  const uint32_t wbar = empty0 + 8 * kRing;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kRing; ++s) {
      mbar_init(full0 + 8 * s, 4);   // one arrival per producer warp
      mbar_init(empty0 + 8 * s, 4);  // one arrival per consumer warp
    }
    mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  float* anchors = reinterpret_cast<float*>(smem + L.anchors);
  if (EPI == EPI_HEAD) fill_anchors(anchors, tid, blockDim.x);
  __syncthreads();

  const int tiles_x = (p.w + 7) / 8;
  const int tiles_img = (p.h + 7) / 8 * tiles_x;
  const int n_tiles = p.n * tiles_img;

  if (tid >= 128 * WGS) {
    // ---- producer: this CTA's tiles in order, halo of tile it -> slot it % kRing ----
    const int pt = tid - 128 * WGS;
    const int lane = pt & 31;
    if (pt == 0) {
      const uint32_t bytes = tp.nb * kBlockBytes;
      mbar_arrive_expect_tx(wbar, bytes);
      for (uint32_t off = 0; off < bytes; off += 16384) {
        bulk_copy(base + off, tp.blocks + off, bytes - off < 16384 ? bytes - off : 16384, wbar);
      }
    }
    const int my_tiles = static_cast<int>(blockIdx.x) < n_tiles
                             ? (n_tiles - 1 - static_cast<int>(blockIdx.x)) / static_cast<int>(gridDim.x) + 1
                             : 0;
    // This thread's 16-byte pieces of local tile `local`'s halo, zero
    // outside the grid: bf16 into a raw halo at `dst` (piece q at 16 q),
    // int8 into a halo slot (channel plane c at c * kPlane, pixel hp at 16 hp).
    constexpr int kPieces = IN_BF16 ? 16 : 8;  // per halo pixel of 128 channels
    auto copy_halo = [&](int local, uint32_t dst) {
      const int t = static_cast<int>(blockIdx.x) + local * static_cast<int>(gridDim.x);
      const int img = t / tiles_img;
      const int rem = t - img * tiles_img;
      const int y0 = rem / tiles_x * 8 - 1;
      const int x0 = rem % tiles_x * 8 - 1;
#pragma unroll
      for (int i = 0; i < (kHalo * kHalo * kPieces + 127) / 128; ++i) {
        const int q = pt + 128 * i;
        if (q >= kHalo * kHalo * kPieces) break;
        const int hp = q / kPieces;
        const int c = q % kPieces;
        const int y = y0 + hp / kHalo;
        const int x = x0 + hp % kHalo;
        const bool valid = y >= 0 && y < p.h && x >= 0 && x < p.w;
        const size_t off =
            valid ? static_cast<size_t>(tail_pixel<IN_LAYOUT>(img, y, x, p.h, p.w)) * (128 * (IN_BF16 ? 2 : 1)) + c * 16
                  : 0;
        cp_async16(IN_BF16 ? dst + q * 16 : dst + c * kPlane + hp * 16, static_cast<const uint8_t*>(p.x) + off,
                   valid ? 16 : 0);
      }
    };
    const uint32_t raw0 = base + L.raw;
    if (IN_BF16) {
      for (int r = 0; r < tp.raw_tiles; ++r) {
        if (r < my_tiles) copy_halo(r, raw0 + r * 2 * kHaloBytes);
        cp_async_commit();
      }
    }
    for (int it = 0; it < my_tiles; ++it) {
      const int s = it % kRing;
      if (it >= kRing) mbar_wait(empty0 + 8 * s, ((it / kRing) - 1) & 1);
      if (IN_BF16) {
        // Each thread quantizes the pieces it copied itself, then fences
        // its generic-proxy stores for wgmma before its warp arrives.
        if (tp.raw_tiles == 3) {
          cp_async_wait_group<2>();
        } else if (tp.raw_tiles == 2) {
          cp_async_wait_group<1>();
        } else {
          cp_async_wait_group<0>();
        }
        const int slot = it % tp.raw_tiles;
        for (int q = pt; q < kHalo * kHalo * kPieces; q += 128) {
          const uint4 v = *reinterpret_cast<const uint4*>(smem + L.raw + slot * 2 * kHaloBytes + q * 16);
          *reinterpret_cast<uint2*>(smem + L.halos + s * kHaloBytes + (q % 16 >> 1) * kPlane + q / 16 * 16 +
                                    (q & 1) * 8) = quantize8_at<PC>(v, p.inv_in, p.inv_in_v, (q & 15) * 8);
        }
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) mbar_arrive(full0 + 8 * s);
        if (it + tp.raw_tiles < my_tiles) copy_halo(it + tp.raw_tiles, raw0 + slot * 2 * kHaloBytes);
        cp_async_commit();
      } else {
        // The warp arrives for tile it - 1 once its own copies of it landed.
        copy_halo(it, base + L.halos + s * kHaloBytes);
        cp_async_commit();
        if (it >= 1) {
          cp_async_wait_group<1>();
          __syncwarp();
          if (lane == 0) mbar_arrive(full0 + 8 * ((it - 1) % kRing));
        }
      }
    }
    if (!IN_BF16 && my_tiles > 0) {
      cp_async_wait_group<0>();
      __syncwarp();
      if (lane == 0) mbar_arrive(full0 + 8 * ((my_tiles - 1) % kRing));
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // ---- consumer warpgroup wg: local tiles wg, wg + WGS, ...; a tile's listed blocks as MMAs, then the epilogue ----
  const int wg = tid >> 7;
  const int lane = tid & 31;
  mbar_wait(wbar, 0);
  for (int it = wg, t = blockIdx.x + wg * gridDim.x; t < n_tiles; it += WGS, t += WGS * gridDim.x) {
    const int s = it % kRing;
    mbar_wait(full0 + 8 * s, (it / kRing) & 1);
    fence_proxy_async();  // the producer's cp.async bytes, for the async proxy
    const uint32_t halo = base + L.halos + s * kHaloBytes;
    int acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0;
    wgmma_fence();
    // The slices take turns, so consecutive MMAs add into different
    // accumulators and pipeline.
#pragma unroll
    for (int b = 0; b < NB; ++b) {
#pragma unroll
      for (int ns = 0; ns < 4; ++ns) {
        // Tap (r, c) reads the halo window at pixel (r, c): output row g of
        // the tile is halo row g + r, 10 pixels (160 bytes) on per row.
        const int e = tp.mma[ns * NB + b];
        const int tap = e & 15;
        const uint32_t a = halo + ((tap / 3) * kHalo + tap % 3) * 16 + (e >> 4 & 15) * 2 * kPlane;
        Wgmma<32>::mma(acc + 16 * ns, desc(a, kPlane, kHalo * 16), desc(base + (e >> 8) * kBlockBytes, 128, 256));
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
    const int img = t / tiles_img;
    const int rem = t - img * tiles_img;
    const int ty = rem / tiles_x * 8;
    const int tx = rem % tiles_x * 8;
    store_tile<128, EPI, PC>(p, acc, reinterpret_cast<__nv_bfloat16*>(smem + L.out + wg * out_bytes<128>()), 0,
                             tid & 127, 1 + wg, [&](int r) {
      const int y = ty + (r >> 3);
      const int x = tx + (r & 7);
      return y < p.h && x < p.w ? tail_pixel<OUT_LAYOUT>(img, y, x, p.h, p.w) : -1;
    }, anchors);
  }
}

// Launch a dec4 (IN_BF16, EPI_RELU_Q8) or a dec5 (int8; EPI_HEAD for K6,
// EPI_RELU for K7 and K9) with tp.per_slice MMAs per slice (9, 16 or 36),
// one CTA per SM; shared memory decides two consumer warpgroups or one
// (only dense weights, 36 blocks a slice, need one) and, for bf16 input,
// how many raw halos are in flight (up to 3). Parity planes need an even grid.
template <bool IN_BF16, int EPI, int IN_LAYOUT = LAYOUT_NHWC, int OUT_LAYOUT = LAYOUT_NHWC, bool PC = false>
int launch_tail(TailParams tp, cudaStream_t stream) {
  const Params& p = tp.conv;
  const bool planes = IN_LAYOUT == LAYOUT_PLANES || OUT_LAYOUT == LAYOUT_PLANES;
  if (tp.nb < 1 || tp.nb > kMaxBlocks + 1 || p.cin != 128 || p.cout != 128 ||
      static_cast<long long>(p.n) * p.h * p.w >= (1LL << 31) || (planes && (p.h % 2 || p.w % 2)) ||
      (PC && ((IN_BF16 && p.inv_in_v == nullptr) || (EPI == EPI_RELU_Q8 && p.inv_out_v == nullptr)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int kRing = tail_ring(IN_BF16);
  const int wgs = TailSmem(tp.nb, kRing, IN_BF16 ? 1 : 0, 2).bytes <= kSmemMax ? 2 : 1;
  tp.raw_tiles = 0;
  while (IN_BF16 && tp.raw_tiles < 3 && TailSmem(tp.nb, kRing, tp.raw_tiles + 1, wgs).bytes <= kSmemMax) ++tp.raw_tiles;
  const int bytes = TailSmem(tp.nb, kRing, tp.raw_tiles, wgs).bytes;
  if (bytes > kSmemMax || (IN_BF16 && tp.raw_tiles == 0)) return static_cast<int>(cudaErrorInvalidValue);
  const long long n_tiles = static_cast<long long>(p.n) * ((p.h + 7) / 8) * ((p.w + 7) / 8);
  if (n_tiles == 0) return 0;
  void (*kernel)(TailParams) = nullptr;
  if (wgs == 2) {
    kernel = tp.per_slice == 9 ? tail_kernel<IN_BF16, EPI, 9, 2, IN_LAYOUT, OUT_LAYOUT, PC>
             : tp.per_slice == 16 ? tail_kernel<IN_BF16, EPI, 16, 2, IN_LAYOUT, OUT_LAYOUT, PC>
             : tp.per_slice == 36 ? tail_kernel<IN_BF16, EPI, 36, 2, IN_LAYOUT, OUT_LAYOUT, PC> : nullptr;
  } else if (tp.per_slice == 36) {
    kernel = tail_kernel<IN_BF16, EPI, 36, 1, IN_LAYOUT, OUT_LAYOUT, PC>;
  }
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(n_tiles < sm_count() ? n_tiles : sm_count()), 128 * (wgs + 1), bytes, stream>>>(tp);
  return static_cast<int>(cudaGetLastError());
}

// ---- K5 and K8: nearest-2x upsample + 3x3 conv, the four parity convs from one halo ----
//
// Output parity (di, dj) of the up-block is a 2x2-tap conv on the coarse
// grid whose tap (a, b) reads coarse pixel (oh + di - 1 + a, ow + dj - 1 + b)
// (qdec._PARITY_TAPS): the 16 (parity, tap) pairs use each entry of the 4x4
// parity-combined kernel once, but read only the nine shifted windows
// (di + a, dj + b) of a 3x3 neighbourhood. So a K step (64 input channels)
// of an 8 x 8-pixel coarse tile stages the tile's 10 x 10 halo once, in
// tail_kernel's layout (one 16-channel plane after another, a pixel's 16
// channels 16 bytes from the next pixel's), and all 16 products read it as
// windows at a descriptor offset. The weights do not fit in shared memory
// (0.65-9.4 MB a site), so they stream in stages of 16 slabs of BN output
// channels x 32 input channels, half a K step (qdec.packed_parity_weights:
// one contiguous 32 KB piece per (output tile, chunk, half) at BN = 64;
// a ring of 5, since a stage takes longer to arrive from L2 than its MMAs
// run), and two consumer warpgroups multiply two different spatial tiles
// against the same slabs, so every weight byte brought in feeds 128 output
// rows. Each warpgroup holds the four parities' accumulators (4 x BN / 2
// registers a thread) and stores them through store_tile at fine pixel
// (2 oh + di, 2 ow + dj) of the output, which lies as OUT_LAYOUT: the fine
// NHWC grid (K5) or its parity planes (K8: tail_pixel puts parity
// p = 2 di + dj of coarse pixel (oh, ow) at pixel 4 (coarse index) + p, so
// store_tile's m * cout + col is channel p cout + col of the coarse pixel).
// Either way a tile row stores BN channels, 128 contiguous bytes.
//
// Who does what. Each consumer warpgroup loads its own tile's raw bf16
// halo from device memory into registers one K step ahead (16 bytes a
// piece, seven pieces a thread; zeros outside the grid, past cin and past
// the last tile), quantizes it (quantize8) into one of its
// two int8 halo slots, fences the stores for wgmma and syncs, asks for the
// next step's pieces, then starts the step's 2 x 16 MMAs as the two weight
// stages arrive: the loads of step i + 1 and its quantize run while the
// MMAs of step i execute. The two warpgroups take turns at the tensor
// cores (named barriers 3 and 4), so one quantizes while the other's MMAs
// run. A third warpgroup streams the weight stages (one thread,
// cp.async.bulk) and hands its registers to the consumers (setmaxnreg: 168
// a thread at launch, then 40 there and 232 here), enough for the 128
// accumulators and the 28 of the pieces in flight.
// Why the consumers and why registers: one producer warpgroup quantizing
// both halos cannot keep up with the MMAs it feeds (four warps do not hide
// the latency of 12,800 load-convert-store chains a step), and raw halos
// staged in shared memory by cp.async hold a K step to the copy's round
// trip, since only two such slots fit beside the weights.
//
// Shared-memory plan (UpSmem): kRing weight stages (16 slabs each), two
// int8 halo slots of two tiles, a staged output tile per consumer
// warpgroup, the weights' full and empty barriers: at BN = 64 207,952 of
// the 232,448 bytes a block may use, one CTA to an SM.
constexpr int kUpHalo = (kBK / 16) * kPlane;  // int8 halo of one tile and K step
constexpr int kUpPieces = kHalo * kHalo * 8;  // 16-byte pieces of a raw bf16 halo (64 channels a pixel)
constexpr int kUpPasses = (kUpPieces + 127) / 128;  // pieces a consumer thread loads per K step

template <int BN>
struct UpSmem {
  static constexpr int kRing = 5;
  static constexpr int kSlab = BN * 32;        // one (parity, tap) weight slab of half a K step: BN x 32 input channels
  static constexpr int kWeights = 16 * kSlab;  // a stage: the slabs of half a K step, slab 4 parity + tap
  static constexpr int kHalos = kRing * kWeights;  // int8 halo slot h of tile g at kHalos + (2 h + g) * kUpHalo
  static constexpr int kOut = kHalos + 2 * 2 * kUpHalo;
  static constexpr int kBars = kOut + 2 * out_bytes<BN>();
  static constexpr int kBytes = kBars + 8 * 2 * kRing;
  static_assert(kBytes <= kSmemMax, "up_kernel's shared memory does not fit a block");
};

// p: x (n, h, w, cin) bf16, wp from qdec.packed_parity_weights, n_steps the
// 64-channel chunks of cin, y the bf16 (n, 2 h, 2 w, cout) grid in
// OUT_LAYOUT (planes: (n, h, w, 4 cout)). Item i of the grid
// is (pair of spatial tiles i / tiles_n, output tile i % tiles_n), CTA b
// taking items b, b + gridDim.x, ...: the CTAs running side by side share
// their halos through L2. Threads [0, 256): the two consumer warpgroups,
// warpgroup g on tile 2 pair + g (past the last tile: zeros in, nothing
// stored). Threads [256, 384): the weights' warpgroup, one thread of it
// running ahead through the (item, chunk, half) stages. PC: per-channel
// reciprocals on load.
template <int BN, int OUT_LAYOUT, bool PC = false>
__global__ void __launch_bounds__(384, 1) up_kernel(const __grid_constant__ Params p) {
  using S = UpSmem<BN>;
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x;
  const uint32_t base = smem_u32(smem);
  const uint32_t w_full0 = base + S::kBars;  // barrier [s] at ...0 + 8 s
  const uint32_t w_empty0 = w_full0 + 8 * S::kRing;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < S::kRing; ++s) {
      mbar_init(w_full0 + 8 * s, 1);   // the arrival that announces the weight copy's bytes
      mbar_init(w_empty0 + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int tiles_x = (p.w + 7) / 8;
  const int tiles_img = (p.h + 7) / 8 * tiles_x;
  const int n_tiles = p.n * tiles_img;
  const int tiles_n = (p.cout + BN - 1) / BN;
  const int n_items = (n_tiles + 1) / 2 * tiles_n;
  const int chunks = p.n_steps;

  if (tid >= 256) {
    // ---- the weights: stage wi = (this CTA's item, chunk, half) in order -> ring slot wi % kRing ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid != 256) return;
    constexpr int kPiece = S::kWeights < 16384 ? S::kWeights : 16384;
    const int n_mine = (static_cast<int>(blockIdx.x) < n_items
                            ? (n_items - 1 - static_cast<int>(blockIdx.x)) / static_cast<int>(gridDim.x) + 1
                            : 0) * chunks;
    int item = blockIdx.x, kc = 0;
    for (int wi = 0; wi < 2 * n_mine; ++wi) {
      const int s = wi % S::kRing;
      if (wi >= S::kRing) mbar_wait(w_empty0 + 8 * s, ((wi / S::kRing) - 1) & 1);
      mbar_arrive_expect_tx(w_full0 + 8 * s, S::kWeights);
      const int8_t* src = p.wp + ((static_cast<size_t>(item % tiles_n) * chunks + kc) * 2 + (wi & 1)) * S::kWeights;
#pragma unroll
      for (int off = 0; off < S::kWeights; off += kPiece) {
        bulk_copy(base + s * S::kWeights + off, src + off, kPiece, w_full0 + 8 * s);
      }
      if ((wi & 1) && ++kc == chunks) {
        kc = 0;
        item += gridDim.x;
      }
    }
    return;
  }

  // ---- consumer warpgroup g: tile 2 pair + g of every item; per K step quantize, 2 x 16 MMAs; then four parity stores ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int g = tid >> 7;
  const int wt = tid & 127;
  const int lane = tid & 31;
  // The two warpgroups take turns at the tensor cores: a warpgroup starts a
  // step's MMAs only when the other has started its own (named barrier 3 + g:
  // this warpgroup's turn), so one quantizes while the other's MMAs run.
  if (g == 1) asm volatile("bar.arrive 3, 256;\n" ::: "memory");
  // This thread's pieces of its tile's raw halo are q = wt + 128 i: halo
  // pixel q / 8 (row dy, column dx), 8-channel group q % 8 = wt % 8. Per
  // piece it keeps the byte offset from the halo's first pixel and (dy, dx);
  // per item the halo's first pixel and the pieces that lie in the grid.
  const int piece = wt & 7;
  int rel[kUpPasses], dyx[kUpPasses];
#pragma unroll
  for (int i = 0; i < kUpPasses; ++i) {
    const int hp = (wt + 128 * i) >> 3;
    const int dy = hp / kHalo;
    const int dx = hp - dy * kHalo;
    rel[i] = (dy * p.w + dx) * p.cin * 2;
    dyx[i] = dy | dx << 8;
  }
  long long origin = 0;  // byte offset of the halo's pixel (0, 0), channel group `piece` (may lie before x)
  uint32_t inside = 0;   // bit i: piece i of this thread lies in the grid
  auto locate = [&](int item) {
    const int t = 2 * (item / tiles_n) + g;
    const int img = t / tiles_img;
    const int rem = t - img * tiles_img;
    const int y0 = rem / tiles_x * 8 - 1;
    const int x0 = rem % tiles_x * 8 - 1;
    origin = ((static_cast<long long>(img) * p.h + y0) * p.w + x0) * p.cin * 2 + piece * 16;
    inside = 0;
#pragma unroll
    for (int i = 0; i < kUpPasses; ++i) {
      const int y = y0 + (dyx[i] & 0xff);
      const int x = x0 + (dyx[i] >> 8);
      const bool in = t < n_tiles && wt + 128 * i < kUpPieces && y >= 0 && y < p.h && x >= 0 && x < p.w;
      inside |= static_cast<uint32_t>(in) << i;
    }
  };
  uint4 raw[kUpPasses];  // the located tile's pieces of one chunk
  auto load = [&](int kc) {
    const bool c_in = kc * kBK + piece * 8 < p.cin;
    const uint8_t* src = static_cast<const uint8_t*>(p.x) + origin + kc * (2 * kBK);
#pragma unroll
    for (int i = 0; i < kUpPasses; ++i) {
      raw[i] = make_uint4(0u, 0u, 0u, 0u);
      if (c_in && (inside >> i & 1)) raw[i] = __ldg(reinterpret_cast<const uint4*>(src + rel[i]));
    }
  };
  __nv_bfloat16* out_s = reinterpret_cast<__nv_bfloat16*>(smem + S::kOut + g * out_bytes<BN>());
  int it = 0;  // K steps done; the weight stages done are wi
  int wi = 0;
  if (static_cast<int>(blockIdx.x) < n_items) {
    locate(blockIdx.x);
    load(0);
  }
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int t = 2 * (item / tiles_n) + g;
    const int n0 = (item % tiles_n) * BN;
    int acc[4][BN / 2];
#pragma unroll
    for (int par = 0; par < 4; ++par) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[par][i] = 0;
    }
    for (int kc = 0; kc < chunks; ++kc) {
      const int hs = it & 1;
      // Quantize this step's pieces into halo slot hs, which the MMAs of
      // step it - 2 read last (complete: the last wait of step it - 1 left
      // at most the two groups of that step pending). Piece q = 8 halo
      // pixel + 8-channel group goes to channel plane q % 8 / 2.
      uint8_t* halo_s = smem + S::kHalos + (2 * hs + g) * kUpHalo;
#pragma unroll
      for (int i = 0; i < kUpPasses; ++i) {
        const int q = wt + 128 * i;
        if (q < kUpPieces) {
          *reinterpret_cast<uint2*>(halo_s + (piece >> 1) * kPlane + (q >> 3) * 16 + (q & 1) * 8) =
              quantize8_at<PC>(raw[i], p.inv_in, p.inv_in_v, kc * kBK + piece * 8);
        }
      }
      fence_proxy_async();  // this thread's generic-proxy stores, for wgmma
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + g) : "memory");  // the whole halo is quantized
      // Ask for the next step's pieces (the next item's first, past the last chunk).
      if (kc + 1 < chunks) {
        load(kc + 1);
      } else if (item + static_cast<int>(gridDim.x) < n_items) {
        locate(item + gridDim.x);
        load(0);
      }
      const uint32_t halo = base + S::kHalos + (2 * hs + g) * kUpHalo;
      asm volatile("bar.sync %0, 256;\n" ::"r"(3 + g) : "memory");
      // Parity (di, dj), tap (a, b) reads the halo window at pixel
      // (di + a, dj + b): output row r of the tile is halo row r / 8 + di + a,
      // 10 pixels (160 bytes) on per row. The parities take turns, so
      // consecutive MMAs add into different accumulators.
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk) {
        const int s = wi % S::kRing;
        mbar_wait(w_full0 + 8 * s, (wi / S::kRing) & 1);
        const uint32_t slabs = base + s * S::kWeights;
        wgmma_fence();
#pragma unroll
        for (int tap = 0; tap < 4; ++tap) {
#pragma unroll
          for (int par = 0; par < 4; ++par) {
            const int wr = (par >> 1) + (tap >> 1);
            const int wc = (par & 1) + (tap & 1);
            Wgmma<BN>::mma(acc[par], desc(halo + (wr * kHalo + wc) * 16 + kk * 2 * kPlane, kPlane, kHalo * 16),
                           desc(slabs + (4 * par + tap) * S::kSlab, kCoreBytes, 2 * kCoreBytes));
          }
        }
        wgmma_commit();
        // Two groups stay in flight, so the next step's quantize runs beside
        // this step's MMAs; the stage two back is read.
        wgmma_wait<2>();
        if (kc > 0 && lane == 0) mbar_arrive(w_empty0 + 8 * ((wi - 2) % S::kRing));
        ++wi;
      }
      asm volatile("bar.arrive %0, 256;\n" ::"r"(4 - g) : "memory");
      ++it;
    }
    wgmma_wait<0>();
    if (lane == 0) {
      mbar_arrive(w_empty0 + 8 * ((wi - 2) % S::kRing));
      mbar_arrive(w_empty0 + 8 * ((wi - 1) % S::kRing));
    }
    const int img = t / tiles_img;
    const int rem = t - img * tiles_img;
    const int ty = rem / tiles_x * 8;
    const int tx = rem % tiles_x * 8;
#pragma unroll
    for (int par = 0; par < 4; ++par) {
      store_tile<BN, EPI_RELU>(p, acc[par], out_s, n0, wt, 1 + g, [&](int row) {
        const int y = ty + (row >> 3);
        const int x = tx + (row & 7);
        return t < n_tiles && y < p.h && x < p.w
                   ? tail_pixel<OUT_LAYOUT>(img, 2 * y + (par >> 1), 2 * x + (par & 1), 2 * p.h, 2 * p.w)
                   : -1;
      });
    }
  }
}

// Launch an up-block (K5: OUT_LAYOUT NHWC, K8: parity planes), one CTA per
// SM (at most one per item).
template <int BN, int OUT_LAYOUT = LAYOUT_NHWC, bool PC = false>
int launch_up(const Params& p, cudaStream_t stream) {
  using S = UpSmem<BN>;
  if (PC && p.inv_in_v == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  // Fine pixel indices (either layout) and a halo's byte offsets are 32-bit in the kernel.
  if (4LL * p.n * p.h * p.w >= (1LL << 31) || (kHalo * (p.w + 1LL)) * p.cin * 2 >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n_tiles = static_cast<long long>(p.n) * ((p.h + 7) / 8) * ((p.w + 7) / 8);
  const long long n_items = (n_tiles + 1) / 2 * ((p.cout + BN - 1) / BN);
  if (n_items == 0) return 0;
  auto kernel = up_kernel<BN, OUT_LAYOUT, PC>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(n_items < sm_count() ? n_items : sm_count()), 384, S::kBytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ---- rs_int8_conv's stride-1 3x3 convs: nine taps as windows of one halo per tile and chunk ----
//
// The fast family's stem, residual blocks (b1, b2, b3, b4a, the dilated
// b4b) and decoder convs (d3, d2, d1) are dense 3x3 convs of stride 1 with
// a bf16 input. On conv_kernel each (tap, 64-channel chunk) K step of a
// 64-pixel tile copies and quantizes its own 8 KB A tile and pulls its own
// weight tile for two MMAs: every input value is read through L2 and
// quantized nine times, and every weight byte feeds 64 output rows. Here,
// as in up_kernel, a consumer warpgroup takes an 8 x 8-pixel output tile,
// loads the tile's raw bf16 halo of side 8 + 2 dil (10 at dilation 1, 12 at
// b4b's 2; origin (ty - pad, tx - pad_w), zeros outside the input and past
// cin) into registers one chunk ahead, quantizes it once (quantize8) into
// the plane layout (one 16-channel plane after another, a pixel's 16
// channels 16 bytes from the next pixel's: 8 consecutive halo pixels of a
// plane are one 128-byte core matrix), fences the stores for wgmma and
// syncs; tap (a, b) is then the halo window at pixel (a dil, b dil), a
// descriptor offset: core matrices 16 * side bytes apart along M, one
// plane apart along K. The nine taps x two 32-channel halves add into one
// accumulator of BN / 2 int32 a thread. The weights (qconv.packed_tap_slabs)
// stream per half chunk as nine slabs of BN output x 32 input channels,
// which the two consumer warpgroups multiply against two different tiles
// (taking turns at the tensor cores, named barriers 3 and 4, as up_kernel's
// do), so every weight byte brought in feeds 128 output rows; a third
// warpgroup's one thread streams them (setmaxnreg: 40 registers there, 232
// for the consumers). The epilogue is store_tile's at the NHWC output pixel
// (EPI_RESIDUAL_RELU: the conv's own input at that pixel).
//
// Shared-memory plan (HaloSmem): kRing weight stages of nine slabs, two
// int8 halo slots of two tiles, a staged output tile per consumer
// warpgroup, the weights' full and empty barriers. At BN = 128: stages of
// 36,864 bytes, a ring of 4 (147,456), halos 4 x 6,400 (side 10) or
// 4 x 9,216 (side 12), two staged tiles of 17,408, 64 bytes of barriers:
// 207,936 or 219,200 of the 232,448 bytes a block may use, one CTA to an
// SM. BN = 256 would leave room for one stage only, so Cout 256 runs as
// two output tiles of 128, each loading its own halo (the items of one
// spatial pair are neighbours, so the second finds the halo in L2).
template <int DIL>
struct HaloGeom {
  static constexpr int kSide = 8 + 2 * DIL;                 // halo side of an 8 x 8 output tile
  static constexpr int kPlane = kSide * kSide * 16;         // one 16-channel plane: the core matrices' K stride
  static constexpr int kBytes = (kBK / 16) * kPlane;        // int8 halo of one tile and chunk
  static constexpr int kPieces = kSide * kSide * 8;         // 16-byte pieces of a raw bf16 halo (64 channels a pixel)
  static constexpr int kPasses = (kPieces + 127) / 128;     // pieces a consumer thread loads per chunk
};

template <int BN, int DIL>
struct HaloSmem {
  static constexpr int kRing = 4;
  static constexpr int kSlab = BN * 32;           // one tap's weight slab of half a chunk: BN x 32 input channels
  static constexpr int kWeights = 9 * kSlab;      // a stage: the nine taps' slabs of half a chunk
  static constexpr int kHalos = kRing * kWeights;  // int8 halo slot h of tile g at kHalos + (2 h + g) * kBytes
  static constexpr int kOut = kHalos + 2 * 2 * HaloGeom<DIL>::kBytes;
  static constexpr int kBars = kOut + 2 * out_bytes<BN>();
  static constexpr int kBytes = kBars + 8 * 2 * kRing;
  static_assert(kBytes <= kSmemMax, "halo_conv_kernel's shared memory does not fit a block");
};

// p: x (n, h, w, cin) bf16, wp from qconv.packed_tap_slabs, y the bf16
// (n, ho, wo, cout) output; 3x3 taps of dilation DIL, p.pad rows and
// p.pad_w columns of zeros before the grid. Item i of the grid is (pair of
// 8 x 8 output tiles i / tiles_n, output-channel tile i % tiles_n), CTA b
// taking items b, b + gridDim.x, ...: the CTAs running side by side share
// their halos through L2. Threads [0, 256): the two consumer warpgroups,
// warpgroup g on tile 2 pair + g (past the last tile: zeros in, nothing
// stored). Threads [256, 384): the weights' warpgroup, one thread of it
// running ahead through the (item, chunk, half) stages. PC: per-channel
// reciprocals on load.
template <int BN, int EPI, int DIL, bool PC = false>
__global__ void __launch_bounds__(384, 1) halo_conv_kernel(const __grid_constant__ Params p) {
  using S = HaloSmem<BN, DIL>;
  using G = HaloGeom<DIL>;
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x;
  const uint32_t base = smem_u32(smem);
  const uint32_t w_full0 = base + S::kBars;  // barrier [s] at ...0 + 8 s
  const uint32_t w_empty0 = w_full0 + 8 * S::kRing;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < S::kRing; ++s) {
      mbar_init(w_full0 + 8 * s, 1);   // the arrival that announces the weight copy's bytes
      mbar_init(w_empty0 + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int tiles_x = (p.wo + 7) / 8;
  const int tiles_img = (p.ho + 7) / 8 * tiles_x;
  const int n_tiles = p.n * tiles_img;
  const int tiles_n = (p.cout + BN - 1) / BN;
  const int n_items = (n_tiles + 1) / 2 * tiles_n;
  const int chunks = (p.cin + kBK - 1) / kBK;

  if (tid >= 256) {
    // ---- the weights: stage wi = (this CTA's item, chunk, half) in order -> ring slot wi % kRing ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid != 256) return;
    const int n_mine = (static_cast<int>(blockIdx.x) < n_items
                            ? (n_items - 1 - static_cast<int>(blockIdx.x)) / static_cast<int>(gridDim.x) + 1
                            : 0) * chunks;
    int item = blockIdx.x, kc = 0;
    for (int wi = 0; wi < 2 * n_mine; ++wi) {
      const int s = wi % S::kRing;
      if (wi >= S::kRing) mbar_wait(w_empty0 + 8 * s, ((wi / S::kRing) - 1) & 1);
      mbar_arrive_expect_tx(w_full0 + 8 * s, S::kWeights);
      const int8_t* src = p.wp + ((static_cast<size_t>(item % tiles_n) * chunks + kc) * 2 + (wi & 1)) * S::kWeights;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        bulk_copy(base + s * S::kWeights + tap * S::kSlab, src + tap * S::kSlab, S::kSlab, w_full0 + 8 * s);
      }
      if ((wi & 1) && ++kc == chunks) {
        kc = 0;
        item += gridDim.x;
      }
    }
    return;
  }

  // ---- consumer warpgroup g: tile 2 pair + g of every item; per chunk quantize, 2 x 9 MMAs; then the store ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int g = tid >> 7;
  const int wt = tid & 127;
  const int lane = tid & 31;
  // The two warpgroups take turns at the tensor cores (named barrier 3 + g:
  // this warpgroup's turn), so one quantizes while the other's MMAs run.
  if (g == 1) asm volatile("bar.arrive 3, 256;\n" ::: "memory");
  // This thread's pieces of its tile's raw halo are q = wt + 128 i: halo
  // pixel q / 8 (row dy, column dx), 8-channel group q % 8 = wt % 8. Per
  // piece it keeps the byte offset from the halo's first pixel and (dy, dx);
  // per item the halo's first pixel and the pieces that lie in the input.
  const int piece = wt & 7;
  int rel[G::kPasses], dyx[G::kPasses];
#pragma unroll
  for (int i = 0; i < G::kPasses; ++i) {
    const int hp = (wt + 128 * i) >> 3;
    const int dy = hp / G::kSide;
    const int dx = hp - dy * G::kSide;
    rel[i] = (dy * p.w + dx) * p.cin * 2;
    dyx[i] = dy | dx << 8;
  }
  long long origin = 0;  // byte offset of the halo's pixel (0, 0), channel group `piece` (may lie before x)
  uint32_t inside = 0;   // bit i: piece i of this thread lies in the input
  auto locate = [&](int item) {
    const int t = 2 * (item / tiles_n) + g;
    const int img = t / tiles_img;
    const int rem = t - img * tiles_img;
    const int y0 = rem / tiles_x * 8 - p.pad;
    const int x0 = rem % tiles_x * 8 - p.pad_w;
    origin = ((static_cast<long long>(img) * p.h + y0) * p.w + x0) * p.cin * 2 + piece * 16;
    inside = 0;
#pragma unroll
    for (int i = 0; i < G::kPasses; ++i) {
      const int y = y0 + (dyx[i] & 0xff);
      const int x = x0 + (dyx[i] >> 8);
      const bool in = t < n_tiles && wt + 128 * i < G::kPieces && y >= 0 && y < p.h && x >= 0 && x < p.w;
      inside |= static_cast<uint32_t>(in) << i;
    }
  };
  uint4 raw[G::kPasses];  // the located tile's pieces of one chunk
  auto load = [&](int kc) {
    const bool c_in = kc * kBK + piece * 8 < p.cin;
    const uint8_t* src = static_cast<const uint8_t*>(p.x) + origin + kc * (2 * kBK);
#pragma unroll
    for (int i = 0; i < G::kPasses; ++i) {
      raw[i] = make_uint4(0u, 0u, 0u, 0u);
      if (c_in && (inside >> i & 1)) raw[i] = __ldg(reinterpret_cast<const uint4*>(src + rel[i]));
    }
  };
  __nv_bfloat16* out_s = reinterpret_cast<__nv_bfloat16*>(smem + S::kOut + g * out_bytes<BN>());
  int it = 0;  // chunks done; the weight stages done are wi
  int wi = 0;
  if (static_cast<int>(blockIdx.x) < n_items) {
    locate(blockIdx.x);
    load(0);
  }
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int t = 2 * (item / tiles_n) + g;
    const int n0 = (item % tiles_n) * BN;
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    for (int kc = 0; kc < chunks; ++kc) {
      const int hs = it & 1;
      // Quantize this chunk's pieces into halo slot hs, which the MMAs of
      // chunk it - 2 read last (complete: the last wait of chunk it - 1 left
      // at most the two groups of that chunk pending). Piece q = 8 halo
      // pixel + 8-channel group goes to channel plane q % 8 / 2.
      uint8_t* halo_s = smem + S::kHalos + (2 * hs + g) * G::kBytes;
#pragma unroll
      for (int i = 0; i < G::kPasses; ++i) {
        const int q = wt + 128 * i;
        if (q < G::kPieces) {
          *reinterpret_cast<uint2*>(halo_s + (piece >> 1) * G::kPlane + (q >> 3) * 16 + (q & 1) * 8) =
              quantize8_at<PC>(raw[i], p.inv_in, p.inv_in_v, kc * kBK + piece * 8);
        }
      }
      fence_proxy_async();  // this thread's generic-proxy stores, for wgmma
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + g) : "memory");  // the whole halo is quantized
      // Ask for the next chunk's pieces (the next item's first, past the last chunk).
      if (kc + 1 < chunks) {
        load(kc + 1);
      } else if (item + static_cast<int>(gridDim.x) < n_items) {
        locate(item + gridDim.x);
        load(0);
      }
      const uint32_t halo = base + S::kHalos + (2 * hs + g) * G::kBytes;
      asm volatile("bar.sync %0, 256;\n" ::"r"(3 + g) : "memory");
      // Tap (a, b) reads the halo window at pixel (a DIL, b DIL): output row
      // r of the tile is halo row r / 8 + a DIL, kSide pixels (16 kSide
      // bytes) on per row.
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk) {
        const int s = wi % S::kRing;
        mbar_wait(w_full0 + 8 * s, (wi / S::kRing) & 1);
        const uint32_t slabs = base + s * S::kWeights;
        wgmma_fence();
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const int a = tap / 3;
          const int b = tap % 3;
          Wgmma<BN>::mma(acc, desc(halo + (a * DIL * G::kSide + b * DIL) * 16 + kk * 2 * G::kPlane, G::kPlane,
                                   G::kSide * 16),
                         desc(slabs + tap * S::kSlab, kCoreBytes, 2 * kCoreBytes));
        }
        wgmma_commit();
        // Two groups stay in flight, so the next chunk's quantize runs
        // beside this chunk's MMAs; the stage two back is read.
        wgmma_wait<2>();
        if (kc > 0 && lane == 0) mbar_arrive(w_empty0 + 8 * ((wi - 2) % S::kRing));
        ++wi;
      }
      asm volatile("bar.arrive %0, 256;\n" ::"r"(4 - g) : "memory");
      ++it;
    }
    wgmma_wait<0>();
    if (lane == 0) {
      mbar_arrive(w_empty0 + 8 * ((wi - 2) % S::kRing));
      mbar_arrive(w_empty0 + 8 * ((wi - 1) % S::kRing));
    }
    const int img = t / tiles_img;
    const int rem = t - img * tiles_img;
    const int ty = rem / tiles_x * 8;
    const int tx = rem % tiles_x * 8;
    store_tile<BN, EPI>(p, acc, out_s, n0, wt, 1 + g, [&](int row) {
      const int y = ty + (row >> 3);
      const int x = tx + (row & 7);
      return t < n_tiles && y < p.ho && x < p.wo ? (img * p.ho + y) * p.wo + x : -1;
    });
  }
}

// Launch a stride-1 3x3 conv of dilation DIL (p.k = 3, p.dil = DIL), one
// CTA per SM (at most one per item); returns the CUDA error code.
template <int BN, int EPI, int DIL, bool PC = false>
int launch_halo(const Params& p, cudaStream_t stream) {
  using S = HaloSmem<BN, DIL>;
  if (PC && p.inv_in_v == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  // The last output row's and column's windows start inside the padded input.
  if (p.k != 3 || p.dil != DIL || p.ho < 1 || p.wo < 1 || p.pad < 0 || p.pad_w < 0 || p.ho - 1 - p.pad >= p.h ||
      p.wo - 1 - p.pad_w >= p.w) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // Output pixel indices and a halo's byte offsets are 32-bit in the kernel.
  if (static_cast<long long>(p.n) * p.ho * p.wo >= (1LL << 31) ||
      HaloGeom<DIL>::kSide * (p.w + 1LL) * p.cin * 2 >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n_tiles = static_cast<long long>(p.n) * ((p.ho + 7) / 8) * ((p.wo + 7) / 8);
  const long long n_items = (n_tiles + 1) / 2 * ((p.cout + BN - 1) / BN);
  if (n_items == 0) return 0;
  auto kernel = halo_conv_kernel<BN, EPI, DIL, PC>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(n_items < sm_count() ? n_items : sm_count()), 384, S::kBytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90
}  // namespace rs
