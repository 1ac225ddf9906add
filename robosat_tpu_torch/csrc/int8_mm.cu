// int8 matmul with a fused requantize epilogue on Hopper (kernel K2).
//
// Replaces the Pallas kernels benchmarks/bench_pallas_mm.py:make_mm_a and
// make_mm_b, the probe of the U-Net's 1x1 and per-tap int8 contractions:
//
//   acc = A(M, K) @ B(K, N)                      (int8 x int8 -> int32, exact)
//   out = clip(rint(f32(acc) * s), -127, 127)    (int8, half to even)
//
// in two orientations, each a template instantiation:
//
//   a, channels-major: out(cout, P) = w(cout, cin) @ x(cin, P), s (cout, 1)
//   b, NHWC-flat:      out(P, cout) = x(P, cin) @ w(cin, cout), s (1, cout)
//
// What bounds it on the H100: at the probe's shapes (cout 64-256, cin
// 64-1280, P = 165,888 or 41,472) it does 2 cout cin ops per (cin + cout)
// bytes of x and out, 64-256 ops per byte, below the ~590 int8 ops per byte
// where the tensor cores would become the limit: every shape is bound by
// device memory, so the design moves each byte of x and out once and keeps
// copies in flight all the time:
//
// - The weights stay in shared memory. The weight (w) is the small
//   operand; a block owns one slab of SLAB = 64, 128 or 256 of its output
//   channels (the wrapper, ops/int8_mm.py:plan, picks the slab and the ring
//   depth so that everything fits in the 227 KB a block may have) and loads
//   it once, K-contiguous as mma.sync reads it, rows padded to Kp + 16 bytes
//   (bank-conflict-free ldmatrix). Orientation b's weight is N-contiguous:
//   it is byte-transposed (4 x 4 blocks, __byte_perm) once per block, into
//   a row order that puts each thread's accumulators on 8 neighbouring
//   output channels (below).
// - A persistent grid over the streamed dimension P: the wrapper launches
//   about one block per SM in all, slabs x walkers, and walker w of a slab
//   takes the P tiles w, w + walkers, ...; with one slab (cout <= 256) every
//   byte of x is read from device memory by exactly one block.
// - A ring of `stages` x tiles of 64 K bytes each under mbarriers, about
//   64 KB deep, filled by a producer warpgroup with cp.async 16-byte copies
//   (zero-fill past K and P), so the copies land while the consumer warps
//   (8, or 16 at 256-channel slabs: Cfg, below) run mma.sync.m16n8k32.s8 on
//   the stages that have arrived; each consumer warp frees a stage on its
//   empty barrier. In orientation b the four producer warps copy and signal
//   each stage with cp.async.mbarrier.arrive.noinc; its tiles are permuted
//   by 16-byte piece for conflict-free ldmatrix.
// - Orientation a's x tile is P-contiguous, but mma.sync takes its B operand
//   K-contiguous: this is the one transposition left on the streamed
//   operand, and one pass over each stage in shared memory does it. Producer
//   warps 0-1 copy the stage (landed[s]); warps 2-3 then transpose it in
//   place into 4 x 4-byte blocks (transpose4x4, 8 byte_perms per 16 bytes)
//   and arrive on full[s]. A consumer loads the B fragments of four n8 tiles
//   as one 16-byte word; the price is that fragment column g of n8 tile j is
//   output column 4 g + j of its 32-column group, which leaves each thread 8
//   neighbouring output columns (8 tq .. 8 tq + 7) per row: the epilogue
//   writes them as one 8-byte word. The alternatives, tried on the card:
//   transposing in the consumers' fragment loads (4 shared loads and 8
//   byte_perms per four fragments, repeated by every warp that shares the
//   columns) was no faster at slabs of 64 and 128 and slower at 256
//   channels; the same pass done by copying warps that wait for their own
//   copies, or by all consumer warps behind a block barrier, was slower.
// - A staged epilogue per warp: each warp requantizes its 32 x 64 (or
//   32 x 32) outputs (requant, below) into its own shared-memory tile and
//   writes them out as whole rows, 16 bytes a thread, neighbouring threads
//   on neighbouring addresses. No barrier joins the warps, and the producers
//   already fill the ring with the next tiles' copies.
//
// tensor-core instruction: mma.sync, not wgmma. For 8-bit types wgmma reads
// only K-contiguous operands, and in each orientation one operand (x in a,
// w in b) is N-contiguous, so a wgmma K2 would rewrite a streamed operand
// into the core-matrix layout first.

#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_conv_sm90.cuh"

namespace {

using rs::sm90::cp_async16;
using rs::sm90::mbar_arrive;
using rs::sm90::mbar_init;
using rs::sm90::mbar_wait;
using rs::sm90::smem_u32;

enum Orientation { ORIENT_A = 0, ORIENT_B = 1 };

constexpr int kKc = 64;           // K bytes per ring stage
constexpr int kProducers = 128;   // one copy warpgroup, after the consumer warps
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may have (227 KB)

// P (the streamed dimension) per tile for a slab of weights: 16384 outputs
// a tile, 8 warps of 32 x 64.
__host__ __device__ constexpr int tile_p(int slab) { return slab == 64 ? 256 : slab == 128 ? 128 : 64; }

__host__ __device__ constexpr int align128(int x) { return (x + 127) & ~127; }

// The block tile in GEMM terms (TM x TN, the output's own layout) and its
// split over the consumer warps, WM x WN, each warp MW x NW: MI m16 tiles by
// NG groups of 32 columns (four n8 tiles each). Slabs of 64 and 128 take 8
// warps of 32 x 64; slabs of 256 take 16 warps of 32 x 32, twice the warps
// to hide the epilogue's latencies behind each other's MMAs (faster there,
// slower at the narrower slabs' deeper K). A warp stages its part of the
// output in rows of LDW bytes (8-byte stores of rows g = 0..3 on disjoint
// banks).
template <int ORIENT, int SLAB>
struct Cfg {
  static constexpr int BP = tile_p(SLAB);
  static constexpr int TM = ORIENT == ORIENT_A ? SLAB : BP;
  static constexpr int TN = ORIENT == ORIENT_A ? BP : SLAB;
  static constexpr int WARPS = SLAB == 256 ? 16 : 8;
  static constexpr int CONSUMERS = 32 * WARPS;
  static constexpr int THREADS = CONSUMERS + kProducers;
  static constexpr int MW = 32, NW = SLAB == 256 ? 32 : 64, LDW = NW == 32 ? 32 : NW + 32;
  static constexpr int WN = TN / NW;
  static constexpr int WM = WARPS / WN;
  static constexpr int MI = MW / 16;
  static constexpr int NG = NW / 32;
  static_assert(WM * MW == TM && WN * NW == TN, "tile split");
};

// Byte offsets of the dynamic shared memory: 3 x `stages` mbarriers, the
// slab's scales (f32), its weights (SLAB rows of `row_w` bytes), the
// consumer warps' staged output tiles, the ring. ops/int8_mm.py:smem_bytes
// computes the same total.
struct Plan {
  int scale, w, out, ring, bytes, row_w;
};

template <int ORIENT, int SLAB>
__host__ __device__ inline Plan plan(int k, int stages) {
  using C = Cfg<ORIENT, SLAB>;
  Plan p;
  p.row_w = (k + kKc - 1) / kKc * kKc + 16;
  p.scale = align128(24 * stages);
  p.w = align128(p.scale + 4 * SLAB);
  p.out = align128(p.w + SLAB * p.row_w);
  p.ring = align128(p.out + C::WARPS * C::MW * C::LDW);
  p.bytes = p.ring + stages * kKc * C::BP;
  return p;
}

// c += a (16 x 32, row) @ b (32 x 8, col), s8 x s8 -> s32, in mma.sync's
// fragment layout.
__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8 x 16-byte matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8, and r[j] gets word (lane % 4) of row lane / 4
// of matrix j: for int8 rows, mma.sync's A fragment (matrices: rows 0-7 and
// 8-15 at K bytes 0-15, then at 16-31) or two n8 tiles' B fragments.
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

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
// clip to +-127, returned in the low byte. The clip runs before the
// rounding: +-127 are integers, so the two commute (and NaN clips to -127).
// The rounding is an add of 1.5 * 2^23, whose result has the ulp 1 and
// holds rint(y) in the low bits of its representation (two's complement
// in the low byte): an add instead of a float -> int conversion, which
// runs at a quarter of the add's rate.
__device__ __forceinline__ uint32_t requant(int acc, float s) {
  const float y = fminf(fmaxf(__fmul_rn(__int2float_rn(acc), s), -127.0f), 127.0f);
  return __float_as_uint(__fadd_rn(y, 12582912.0f));
}

// Four bytes (the low bytes of v0..v3) in one word, v0 lowest.
__device__ __forceinline__ uint32_t pack4(uint32_t v0, uint32_t v1, uint32_t v2, uint32_t v3) {
  return __byte_perm(__byte_perm(v0, v1, 0x0040), __byte_perm(v2, v3, 0x0040), 0x5410);
}

// Ring tiles. Orientation b: BP rows of 64 K bytes, the 16-byte piece c of
// row r at piece c ^ ((r / 2) % 4) (conflict-free ldmatrix). Orientation a:
// the copies land as 64 K rows of BP bytes (P-contiguous), then the
// producers transpose the stage in place into 4 x 4-byte blocks: block
// (q, w), K rows 4 q .. 4 q + 3 by P columns 4 w .. 4 w + 3, is 16 bytes
// whose word j holds column 4 w + j's four K bytes, at block_off(q, w) in
// the same 4 K rows; a consumer's B fragments of four n8 tiles are one
// 16-byte load, and a quarter warp's loads hit 8 distinct bank groups.
__device__ __forceinline__ int stage_b_off(int r, int c) { return r * kKc + ((c ^ ((r >> 1) & 3)) << 4); }

template <int BP>
__device__ __forceinline__ int block_off(int q, int w) {
  return (q * (BP / 4) + (w ^ ((q & 3) << 1))) << 4;
}

// Arrive on `bar` once all of this thread's earlier cp.async have landed
// (the barrier counts the arrival against its expected count).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// Orientation a: a = w (M = cout, K), b = x (K, N = P), out (cout, P).
// Orientation b: a = x (M = P, K), b = w (K, N = cout), out (P, cout).
// K and N are multiples of 16; gridDim.x is slabs x walkers.
template <int ORIENT, int SLAB>
__global__ void __launch_bounds__(Cfg<ORIENT, SLAB>::THREADS, 1)
    int8_mm_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b, const float* __restrict__ scale,
                   int8_t* __restrict__ out, int m, int n, int k, int stages) {
  using C = Cfg<ORIENT, SLAB>;
  constexpr int BP = C::BP;
  extern __shared__ __align__(128) uint8_t smem[];
  const Plan L = plan<ORIENT, SLAB>(k, stages);
  const uint32_t base = smem_u32(smem);
  const uint32_t full0 = base;                 // full[s] at full0 + 8 s: the stage is ready for the MMAs
  const uint32_t empty0 = base + 8 * stages;   // empty[s]: one arrival per consumer warp
  const uint32_t landed0 = base + 16 * stages; // a: landed[s], the copies of the stage have landed
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      // full: a, one arrival per transposing warp; b, one per copying thread
      mbar_init(full0 + 8 * s, ORIENT == ORIENT_A ? 2 : kProducers);
      mbar_init(empty0 + 8 * s, C::WARPS);
      mbar_init(landed0 + 8 * s, kProducers / 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int cout = ORIENT == ORIENT_A ? m : n;
  const int p_total = ORIENT == ORIENT_A ? n : m;
  const int slabs = (cout + SLAB - 1) / SLAB;
  const int c0 = static_cast<int>(blockIdx.x) % slabs * SLAB;
  const int walkers = static_cast<int>(gridDim.x) / slabs;
  const int walker = static_cast<int>(blockIdx.x) / slabs;
  const int tiles = (p_total + BP - 1) / BP;
  const int chunks = (k + kKc - 1) / kKc;
  const int8_t* x = ORIENT == ORIENT_A ? b : a;
  const int8_t* w = ORIENT == ORIENT_A ? a : b;

  if (tid >= C::CONSUMERS) {
    // ---- producers: item it = (this block's tile it / chunks, K chunk it % chunks) -> stage it % stages ----
    const int pt = tid - C::CONSUMERS;
    const int n_items = (walker < tiles ? (tiles - 1 - walker) / walkers + 1 : 0) * chunks;
    int t = walker, kc = 0;  // the item whose copies are issued next
    if (ORIENT == ORIENT_A && pt < kProducers / 2) {
      // Warps 0-1 copy each item's 64 K rows, counted on landed[s].
      for (int it = 0; it < n_items; ++it) {
        const int s = it % stages;
        if (it >= stages) mbar_wait(empty0 + 8 * s, ((it / stages) - 1) & 1);
        const uint32_t dst = base + L.ring + s * (kKc * BP);
        const int k0 = kc * kKc, p0 = t * BP;
        constexpr int kPieces = BP / 16;
#pragma unroll
        for (int i = pt; i < kKc * kPieces; i += kProducers / 2) {
          const int r = i / kPieces, c = i % kPieces;
          const bool ok = k0 + r < k && p0 + 16 * c < p_total;
          const int8_t* src = ok ? x + static_cast<size_t>(k0 + r) * p_total + p0 + 16 * c : x;
          cp_async16(dst + r * BP + 16 * c, src, ok ? 16 : 0);
        }
        cp_async_arrive(landed0 + 8 * s);
        if (++kc == chunks) {
          kc = 0;
          t += walkers;
        }
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
    } else if (ORIENT == ORIENT_A) {
      // Warps 2-3 transpose bands 8 (warp - 2) .. + 7 of each landed item in
      // place into 4 x 4-byte blocks, a pass of bands at a time (all of a
      // pass's reads before its writes), then arrive on full[s].
      const int lane = pt & 31;
      const int band0 = 8 * ((pt >> 5) - 2);
      constexpr int kPerBand = BP / 4;                                  // blocks in a band
      constexpr int kBandsPerPass = kPerBand >= 32 ? 1 : 32 / kPerBand;
      constexpr int kPerLane = kPerBand >= 32 ? kPerBand / 32 : 1;
      for (int it = 0; it < n_items; ++it) {
        const int s = it % stages;
        mbar_wait(landed0 + 8 * s, (it / stages) & 1);
        uint8_t* st = smem + L.ring + s * (kKc * BP);
#pragma unroll
        for (int pass = 0; pass < 8 / kBandsPerPass; ++pass) {
          uint4 blk[kPerLane];
#pragma unroll
          for (int jb = 0; jb < kPerLane; ++jb) {
            const int i = lane + 32 * jb;
            const int q = band0 + pass * kBandsPerPass + i / kPerBand, w4 = 4 * (i % kPerBand);
            uint32_t v[4];
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) v[jj] = *reinterpret_cast<const uint32_t*>(st + (4 * q + jj) * BP + w4);
            uint32_t o[4];
            transpose4x4(v[0], v[1], v[2], v[3], o);
            blk[jb] = make_uint4(o[0], o[1], o[2], o[3]);
          }
          __syncwarp();
#pragma unroll
          for (int jb = 0; jb < kPerLane; ++jb) {
            const int i = lane + 32 * jb;
            *reinterpret_cast<uint4*>(st + block_off<BP>(band0 + pass * kBandsPerPass + i / kPerBand, i % kPerBand)) =
                blk[jb];
          }
          __syncwarp();
        }
        if (lane == 0) mbar_arrive(full0 + 8 * s);
      }
    } else {
      for (int it = 0; it < n_items; ++it) {
        const int s = it % stages;
        if (it >= stages) mbar_wait(empty0 + 8 * s, ((it / stages) - 1) & 1);
        const uint32_t dst = base + L.ring + s * (kKc * BP);
        const int k0 = kc * kKc, p0 = t * BP;
#pragma unroll
        for (int i = pt; i < BP * 4; i += kProducers) {
          const int r = i >> 2, c = i & 3;
          const bool ok = p0 + r < p_total && k0 + 16 * c < k;
          const int8_t* src = ok ? x + static_cast<size_t>(p0 + r) * k + k0 + 16 * c : x;
          cp_async16(dst + stage_b_off(r, c), src, ok ? 16 : 0);
        }
        cp_async_arrive(full0 + 8 * s);
        if (++kc == chunks) {
          kc = 0;
          t += walkers;
        }
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
    }
    return;
  }

  // ---- consumers: the slab's scales and weights into shared memory, once ----
  float* ss = reinterpret_cast<float*>(smem + L.scale);
  int8_t* ws = reinterpret_cast<int8_t*>(smem + L.w);
  const int row_w = L.row_w;
  const int kp = row_w - 16;
  for (int i = tid; i < SLAB; i += C::CONSUMERS) ss[i] = c0 + i < cout ? scale[c0 + i] : 0.0f;
  if (ORIENT == ORIENT_A) {
    // w (cout, K): slab row r at r * row_w, zeros past K and cout.
    const int pieces = kp / 16;
    for (int i = tid; i < SLAB * pieces; i += C::CONSUMERS) {
      const int r = i / pieces, c = i % pieces;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (c0 + r < cout && 16 * c < k) {
        v = *reinterpret_cast<const uint4*>(w + static_cast<size_t>(c0 + r) * k + 16 * c);
      }
      *reinterpret_cast<uint4*>(ws + r * row_w + 16 * c) = v;
    }
  } else {
    // w (K, cout), N-contiguous: task (K quad kq, 16 channels cc) loads 4
    // rows of 16 bytes and stores 16 transposed words. Channel 32 G + 4 g + j
    // of the slab goes to row 32 G + 8 j + g: n8 tile j's fragment column g.
    const int quads = kp / 4;
    for (int i = tid; i < quads * (SLAB / 16); i += C::CONSUMERS) {
      const int kq = i % quads, cc = i / quads;
      uint4 r[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kr = 4 * kq + j;
        r[j] = make_uint4(0u, 0u, 0u, 0u);
        if (kr < k && c0 + 16 * cc < cout) {
          r[j] = *reinterpret_cast<const uint4*>(w + static_cast<size_t>(kr) * cout + c0 + 16 * cc);
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
          const int nl = 16 * cc + 4 * q + j;
          const int row = (nl & ~31) | ((nl & 3) << 3) | ((nl >> 2) & 7);
          *reinterpret_cast<uint32_t*>(ws + row * row_w + 4 * kq) = o[j];
        }
      }
    }
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(C::CONSUMERS) : "memory");

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp / C::WN;
  const int wn = warp % C::WN;
  const int g = lane >> 2;
  const int tq = lane & 3;
  // This thread's scales, for all tiles: a per output row (MI x 2 rows),
  // b per output column (NG x 8 columns).
  constexpr int kScales = ORIENT == ORIENT_A ? 2 * C::MI : 8 * C::NG;
  float sc[kScales];
#pragma unroll
  for (int i = 0; i < kScales; ++i) {
    sc[i] = ORIENT == ORIENT_A ? ss[wm * C::MW + (i >> 1) * 16 + g + 8 * (i & 1)]
                               : ss[wn * C::NW + (i >> 3) * 32 + 8 * tq + (i & 7)];
  }
  // ldmatrix row addresses of this lane in the resident weights (the
  // A operand's rows in a, the B operand's n8 rows in b) and, in b, the
  // streamed A operand's row in a stage.
  const int w_row = ORIENT == ORIENT_A ? wm * C::MW + (lane & 7) + 8 * ((lane >> 3) & 1)
                                       : wn * C::NW + 8 * (lane >> 4) + (lane & 7);
  const uint32_t w_lane = smem_u32(ws + w_row * row_w + 16 * (ORIENT == ORIENT_A ? lane >> 4 : (lane >> 3) & 1));
  const int a_row = wm * C::MW + (lane & 7) + 8 * ((lane >> 3) & 1);  // b: + 16 mi
  uint8_t* stg = smem + L.out + warp * (C::MW * C::LDW);
  for (int t = walker, it = 0; t < tiles; t += walkers, it += chunks) {
    int acc[C::MI][C::NG * 4][4];
#pragma unroll
    for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < C::NG * 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

    for (int kc = 0; kc < chunks; ++kc) {
      const int s = (it + kc) % stages;
      mbar_wait(full0 + 8 * s, ((it + kc) / stages) & 1);
      const uint8_t* xs = smem + L.ring + s * (kKc * BP);
#pragma unroll
      for (int ks = 0; ks < kKc / 32; ++ks) {
        const int kw = kc * kKc + ks * 32;  // K offset in the resident weights
        uint32_t af[C::MI][4];
        uint32_t bf[C::NG * 4][2];
        if (ORIENT == ORIENT_A) {
#pragma unroll
          for (int mi = 0; mi < C::MI; ++mi) ldsm_x4(w_lane + mi * 16 * row_w + kw, af[mi]);
#pragma unroll
          for (int gr = 0; gr < C::NG; ++gr) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              // Block (K quad 8 ks + 4 half + tq, P quad g of the group):
              // word j is n8 tile j's fragment column g (P column 4 g + j).
              const uint4 v = *reinterpret_cast<const uint4*>(
                  xs + block_off<BP>(8 * ks + 4 * half + tq, (wn * C::NW + gr * 32) / 4 + g));
              bf[gr * 4 + 0][half] = v.x;
              bf[gr * 4 + 1][half] = v.y;
              bf[gr * 4 + 2][half] = v.z;
              bf[gr * 4 + 3][half] = v.w;
            }
          }
        } else {
#pragma unroll
          for (int mi = 0; mi < C::MI; ++mi) {
            const int r = a_row + 16 * mi;
            ldsm_x4(smem_u32(xs + stage_b_off(r, 2 * ks + (lane >> 4))), af[mi]);
          }
#pragma unroll
          for (int np = 0; np < C::NG * 2; ++np) {
            uint32_t r[4];
            ldsm_x4(w_lane + np * 16 * row_w + kw, r);
            bf[2 * np][0] = r[0];
            bf[2 * np][1] = r[1];
            bf[2 * np + 1][0] = r[2];
            bf[2 * np + 1][1] = r[3];
          }
        }
#pragma unroll
        for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
          for (int ni = 0; ni < C::NG * 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
    }

    // ---- epilogue: requantize into this warp's staged tile, then whole rows out ----
    // Accumulator e of n8 tile 4 G + j sits at row g + 8 (e >> 1), column
    // 32 G + 4 (2 tq + (e & 1)) + j: byte q of the thread's 8 columns
    // 32 G + 8 tq + q is acc[..][4 G + (q & 3)][2 half + (q >> 2)].
#pragma unroll
    for (int mi = 0; mi < C::MI; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int gr = 0; gr < C::NG; ++gr) {
          uint32_t v[8];
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            v[q] = requant(acc[mi][gr * 4 + (q & 3)][2 * half + (q >> 2)],
                           ORIENT == ORIENT_A ? sc[2 * mi + half] : sc[8 * gr + q]);
          }
          *reinterpret_cast<uint2*>(stg + (mi * 16 + g + 8 * half) * C::LDW + gr * 32 + 8 * tq) =
              make_uint2(pack4(v[0], v[1], v[2], v[3]), pack4(v[4], v[5], v[6], v[7]));
        }
      }
    }
    __syncwarp();
    // The warp's MW rows of NW bytes, 16 bytes a lane, a row's pieces on
    // neighbouring lanes.
    const int p0 = t * BP;
    const int rows = ORIENT == ORIENT_A ? cout : p_total;
    const int cols = ORIENT == ORIENT_A ? p_total : cout;
    constexpr int kRowPieces = C::NW / 16;
#pragma unroll
    for (int i = lane; i < C::MW * kRowPieces; i += 32) {
      const int r = i / kRowPieces, c = i % kRowPieces;
      const int grow = (ORIENT == ORIENT_A ? c0 : p0) + wm * C::MW + r;
      const int gcol = (ORIENT == ORIENT_A ? p0 : c0) + wn * C::NW + 16 * c;
      const uint4 v = *reinterpret_cast<const uint4*>(stg + r * C::LDW + 16 * c);
      if (grow < rows && gcol < cols) *reinterpret_cast<uint4*>(out + static_cast<size_t>(grow) * cols + gcol) = v;
    }
    __syncwarp();
  }
}

template <int ORIENT, int SLAB>
int launch_int8_mm(const int8_t* a, const int8_t* b, const float* scale, int8_t* out, int m, int n, int k,
                   int stages, int grid, cudaStream_t stream) {
  const Plan L = plan<ORIENT, SLAB>(k, stages);
  const int cout = ORIENT == ORIENT_A ? m : n;
  if (stages < 2 || grid <= 0 || L.bytes > kMaxSmem || grid % ((cout + SLAB - 1) / SLAB) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = int8_mm_kernel<ORIENT, SLAB>;
  static bool sized = false;  // the dynamic shared-memory limit raised for this instantiation
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  kernel<<<grid, Cfg<ORIENT, SLAB>::THREADS, L.bytes, stream>>>(a, b, scale, out, m, n, k, stages);
  return static_cast<int>(cudaGetLastError());
}

template <int ORIENT>
int launch_slab(const int8_t* a, const int8_t* b, const float* scale, int8_t* out, int m, int n, int k, int slab,
                int stages, int grid, cudaStream_t stream) {
  if (slab == 64) return launch_int8_mm<ORIENT, 64>(a, b, scale, out, m, n, k, stages, grid, stream);
  if (slab == 128) return launch_int8_mm<ORIENT, 128>(a, b, scale, out, m, n, k, stages, grid, stream);
  if (slab == 256) return launch_int8_mm<ORIENT, 256>(a, b, scale, out, m, n, k, stages, grid, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// orient 0: a (scale per row of out), 1: b (scale per column); slab, ring
// stages and grid from ops/int8_mm.py:plan. Returns the launch's CUDA error
// code (0 on success).
extern "C" int rs_int8_mm(const void* a, const void* b, const float* scale, void* out, int m, int n, int k, int orient,
                          int slab, int stages, int grid, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int8_t* pa = static_cast<const int8_t*>(a);
  const int8_t* pb = static_cast<const int8_t*>(b);
  int8_t* po = static_cast<int8_t*>(out);
  if (orient == ORIENT_A) return launch_slab<ORIENT_A>(pa, pb, scale, po, m, n, k, slab, stages, grid, stream);
  if (orient == ORIENT_B) return launch_slab<ORIENT_B>(pa, pb, scale, po, m, n, k, slab, stages, grid, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
