// One dense k x k int8 conv on Hopper with the dequant epilogue and a
// linear, relu or residual-relu output: the fast family's twelve dense convs.
//
// It replaces no Pallas kernel. The JAX package runs these convs as XLA's
// int8 convolution, robosat_tpu/models/int8.py:228 _int8_conv, called from
// the fast family's walk (robosat_tpu/models/fastnet.py:297 _walk48_sites),
// and PyTorch has no int8 convolution on CUDA, so the port needs its own.
// It computes, bit for bit,
//
//   y = bf16_rne(f32(conv(q(x), wq)) * (ws * s) + b)    q(v) = clip(rintf(__fmul_rn(v, 1 / s)), -127, 127)
//   out = y, relu(y) or bf16(relu(f32(y) + f32(x)))     (EPI_LINEAR, EPI_RELU, EPI_RESIDUAL_RELU)
//
// with exact int32 accumulators, any stride (1 or 2), dilation and zero
// padding before the grid: the family's stride-2 convs pad XLA's "SAME"
// way, (0, 1) on an even grid, and its b4b conv dilates by 2 with (2, 2).
//
// What bounds it on the H100 (SXM, 700 W: 1979 TOP/s int8, 3.35 TB/s): at
// batch 8 and 576-px tiles the twelve sites do 1.5-49 G MACs each (125 G
// in all) against 3-128 MB of bf16 in and out: 230-420 operations per byte
// for the stem and the stride-2 convs, which are bound by bytes, 570-1090
// for the others, around and above the ~590 ridge. Their bounds sum to
// ~0.15 ms a batch, d1 (0.049 ms) and b1 (0.025 ms) the largest.
//
// Two kernels, by a fixed route (rs_int8_conv, below): a stride-1 3x3
// conv of dilation 1 or 2 (the stem, b1, b2, b3, b4a, b4b, d3, d2 and d1:
// 9 of the 12 sites, 91% of their MACs) runs int8_conv_sm90.cuh's
// halo_conv_kernel, which stages one halo per 8 x 8-pixel output tile and
// 64-channel chunk, quantizes each input value once per chunk and reads the
// nine taps as windows of it, against weight slabs (qconv.packed_tap_slabs)
// that two tiles share; BN = 64 output channels up to Cout 64, else 128.
// Every other conv (down2, down3 and down4, stride 2; any other k or
// dilation) runs conv_kernel with a bf16 input (each 64-channel K step of a
// tap copied as raw bf16 and quantized once by the thread that copied it;
// weights from qenc.packed_weights), the tap offsets dilated and the
// padding before the grid given per axis. The residual of
// EPI_RESIDUAL_RELU is the conv's own input x (Cin = Cout, stride 1, an
// output grid the size of the input).

#include "int8_conv_sm90.cuh"

namespace {

template <int STRIDE, int EPI, bool PC>
int conv(const rs::sm90::Params& p, cudaStream_t stream) {
  return rs::sm90::launch_dense<true, EPI, STRIDE, PC>(p, stream);
}

template <int BN, int DIL, bool PC>
int halo_epi(const rs::sm90::Params& p, int epi, cudaStream_t stream) {
  namespace s9 = rs::sm90;
  switch (epi) {
    case rs::EPI_LINEAR:
      return s9::launch_halo<BN, rs::EPI_LINEAR, DIL, PC>(p, stream);
    case rs::EPI_RELU:
      return s9::launch_halo<BN, rs::EPI_RELU, DIL, PC>(p, stream);
    case rs::EPI_RESIDUAL_RELU:
      return s9::launch_halo<BN, rs::EPI_RESIDUAL_RELU, DIL, PC>(p, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int DIL, bool PC>
int halo(const rs::sm90::Params& p, int epi, cudaStream_t stream) {
  return p.cout <= 64 ? halo_epi<64, DIL, PC>(p, epi, stream) : halo_epi<128, DIL, PC>(p, epi, stream);
}

template <int STRIDE, bool PC>
int conv_epi(const rs::sm90::Params& p, int epi, cudaStream_t stream) {
  switch (epi) {
    case rs::EPI_LINEAR:
      return conv<STRIDE, rs::EPI_LINEAR, PC>(p, stream);
    case rs::EPI_RELU:
      return conv<STRIDE, rs::EPI_RELU, PC>(p, stream);
    case rs::EPI_RESIDUAL_RELU:
      return conv<STRIDE, rs::EPI_RESIDUAL_RELU, PC>(p, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The route (qconv.route): stride 1, k = 3 and dilation 1 or 2 take the
// halo kernel; every other conv takes conv_kernel.
template <bool PC>
int routed(const rs::sm90::Params& p, int k, int stride, int dil, int epi, cudaStream_t stream) {
  if (stride == 1 && k == 3 && dil == 1) return halo<1, PC>(p, epi, stream);
  if (stride == 1 && k == 3 && dil == 2) return halo<2, PC>(p, epi, stream);
  if (stride == 1) return conv_epi<1, PC>(p, epi, stream);
  if (stride == 2) return conv_epi<2, PC>(p, epi, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x bf16 (n, h, w, cin); wp: the (k, k, cin, cout) kernel packed for the
// route's kernel (qconv.packed_tap_slabs for the halo route, else
// qenc.packed_weights); e = ws * s and b (or null) f32 (cout,); inv = 1 / s,
// or with per-channel scales inv_v (else null) the reciprocal vector,
// zero-padded to a multiple of 128, and e = ws; out bf16 (n, ho, wo, cout);
// pad_top, pad_left: zero rows and columns before the grid.
extern "C" int rs_int8_conv(const void* x, const void* wp, const float* e, const float* b, float inv,
                            const float* inv_v, void* out, int n, int h, int w, int cin, int cout, int k, int stride,
                            int dil, int pad_top, int pad_left, int ho, int wo, int epi, void* stream_ptr) {
  namespace s9 = rs::sm90;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  s9::Params p = s9::conv_params(x, wp, e, b, out, inv, 0.0f, n, h, w, cin, cout, k, stride);
  p.inv_in_v = inv_v;
  p.pad = pad_top;
  p.pad_w = pad_left;
  p.dil = dil;
  p.ho = ho;
  p.wo = wo;
  if (epi == rs::EPI_RESIDUAL_RELU) {
    if (cin != cout || stride != 1 || ho != h || wo != w) return static_cast<int>(cudaErrorInvalidValue);
    p.residual = static_cast<const __nv_bfloat16*>(x);
  }
  return inv_v != nullptr ? routed<true>(p, k, stride, dil, epi, stream) : routed<false>(p, k, stride, dil, epi, stream);
}
