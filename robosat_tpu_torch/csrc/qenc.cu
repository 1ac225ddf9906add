// int8 ResNet-50 bottleneck blocks on Hopper (kernels K3, stride 1, and K4, stride 2).
//
// Replaces the Pallas kernels robosat_tpu/models/qenc.py:203
// (bottleneck_block, _block_kernel) and robosat_tpu/models/qenc.py:340
// (bottleneck_block_s2, _block_s2_kernel: stride 2 with torch-style (1, 1)
// padding on conv2 and a stride-2 projection). A stride-1 block takes a
// run-time dilation of its 3x3 conv (padding = dilation): DeepLab's layer4
// at output stride 16 runs its three blocks at dilation 2, the first with a
// stride-1 projection. The JAX package computes those blocks as XLA convs
// (robosat_tpu/models/int8.py walk_encoder, dilate_last_stage).
//
// What bounds it on the H100 (SXM, 700 W: 1979 TOP/s int8, 3.35 TB/s): at
// the main-path shapes (batch 8, 576 px) a stride-1 block is 11.5-12.2 G
// int8 MACs and a stride-2 block 19.7 G, against the bf16 input and output
// and the int8 weights: ~140 ops per byte in layer1, ~1100 in layer4, the
// ridge at ~590. The blocks of layers 1-2 are bandwidth bound (K4's
// layer2.0 too: it reads 85 MB of bf16 and writes 42 MB), those of layer 4
// compute bound, layer3.0 level.
//
// The design runs a block as 3-4 launches of int8_conv_sm90.cuh's
// pipelined wgmma conv and passes h1 and h2 through device memory as int8
// (the bytes conv2's and conv3's on-load quantize computed before), so
// they move one byte per channel and load with plain async copies; only
// the projection `sc` stays bf16. The stride-2 block differs in its
// gathers alone: conv2 and the projection run on the half-resolution
// output grid and read input pixel (2 oh + tap row - pad, 2 ow + tap
// column - pad), so the projection reads a quarter of x and conv2 of h1
// only the pixels its taps touch. Fusing conv3 and the projection into one
// launch (two accumulators) is not done: at BN = 128 two s32 accumulator
// sets take 128 of a consumer thread's registers, and the 64-row tiles run
// two CTAs to an SM within 128.
//
//   h1  = q2(relu(bf16(conv1_1x1(q1(x)))))              -> h1 int8 (N, H, W, Cmid)
//   h2  = q3(relu(bf16(conv2_3x3/stride,dil(h1))))       -> h2 int8 (N, Ho, Wo, Cmid)
//   sc  = bf16(down_1x1/stride(qd(x)))  or  x            -> sc bf16 (N, Ho, Wo, Cout)
//   out = bf16(relu(bf16(conv3_1x1(h2)) + sc))           -> out
//
// qk(v) = clip(rintf(__fmul_rn(v, invk)), -127, 127): the activation quantize.
// With per-channel scales (the "pc" calibrations: v1, v2, v3 and vd, the
// sites' reciprocal vectors, all given) channel c is multiplied by vk[c]:
// conv1 and the projection quantize the same x with v1 and vd, conv1's
// and conv2's epilogues requantize with v2 and v3 (the PC instantiations).

#include "int8_conv_sm90.cuh"

namespace {

template <int STRIDE, bool PC>
int block(const void* x, const void* w1, const float* e1, const float* b1, const void* w2, const float* e2,
          const float* b2, const void* w3, const float* e3, const float* b3, const void* wd, const float* ed,
          const float* bd, float inv1, float inv2, float inv3, float invd, const float* v1, const float* v2,
          const float* v3, const float* vd, void* h1, void* h2, void* sc, void* out, int n, int h, int w, int cin,
          int cmid, int cout, int dilation, cudaStream_t stream) {
  namespace s9 = rs::sm90;
  int rc;
  s9::Params p = s9::conv_params(x, w1, e1, b1, h1, inv1, inv2, n, h, w, cin, cmid, 1);
  p.inv_in_v = v1;
  p.inv_out_v = v2;
  if ((rc = s9::launch_dense<true, s9::EPI_RELU_Q8, 1, PC>(p, stream)) != 0) return rc;

  p = s9::conv_params(h1, w2, e2, b2, h2, 0.0f, inv3, n, h, w, cmid, cmid, 3, STRIDE);
  p.inv_out_v = v3;
  p.dil = p.pad = p.pad_w = dilation;  // torch-style (d, d) padding: the output grid stays (h - 1) / STRIDE + 1
  if ((rc = s9::launch_dense<false, s9::EPI_RELU_Q8, STRIDE, PC>(p, stream)) != 0) return rc;
  const int ho = p.ho, wo = p.wo;

  const void* shortcut = x;
  if (wd != nullptr) {
    p = s9::conv_params(x, wd, ed, bd, sc, invd, 0.0f, n, h, w, cin, cout, 1, STRIDE);
    p.inv_in_v = vd;
    if ((rc = s9::launch_dense<true, rs::EPI_LINEAR, STRIDE, PC>(p, stream)) != 0) return rc;
    shortcut = sc;
  }

  p = s9::conv_params(h2, w3, e3, b3, out, 0.0f, 0.0f, n, ho, wo, cmid, cout, 1);
  p.residual = static_cast<const __nv_bfloat16*>(shortcut);
  return s9::launch_dense<false, rs::EPI_RESIDUAL_RELU>(p, stream);
}

template <bool PC>
int any_stride(const void* x, const void* w1, const float* e1, const float* b1, const void* w2, const float* e2,
               const float* b2, const void* w3, const float* e3, const float* b3, const void* wd, const float* ed,
               const float* bd, float inv1, float inv2, float inv3, float invd, const float* v1, const float* v2,
               const float* v3, const float* vd, void* h1, void* h2, void* sc, void* out, int n, int h, int w,
               int cin, int cmid, int cout, int stride, int dilation, cudaStream_t stream) {
  if (stride == 1 && dilation >= 1) {
    return block<1, PC>(x, w1, e1, b1, w2, e2, b2, w3, e3, b3, wd, ed, bd, inv1, inv2, inv3, invd, v1, v2, v3, vd, h1,
                        h2, sc, out, n, h, w, cin, cmid, cout, dilation, stream);
  }
  if (stride == 2 && dilation == 1 && wd != nullptr) {
    return block<2, PC>(x, w1, e1, b1, w2, e2, b2, w3, e3, b3, wd, ed, bd, inv1, inv2, inv3, invd, v1, v2, v3, vd, h1,
                        h2, sc, out, n, h, w, cin, cmid, cout, 1, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// stride 1 (K3; wd may be null: the identity residual; conv2 at any dilation >= 1) or 2
// (K4; even h and w, dilation 1). v1, v2, v3, vd: null (per-tensor: inv1..invd) or the
// sites' per-channel reciprocal vectors (vd with wd), padded with zeros to a multiple of 128.
extern "C" int rs_bottleneck_block(const void* x, const void* w1, const float* e1, const float* b1, const void* w2,
                                   const float* e2, const float* b2, const void* w3, const float* e3, const float* b3,
                                   const void* wd, const float* ed, const float* bd, float inv1, float inv2,
                                   float inv3, float invd, const float* v1, const float* v2, const float* v3,
                                   const float* vd, void* h1, void* h2, void* sc, void* out, int n, int h, int w,
                                   int cin, int cmid, int cout, int stride, int dilation, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (v1 == nullptr) {
    if (v2 != nullptr || v3 != nullptr || vd != nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return any_stride<false>(x, w1, e1, b1, w2, e2, b2, w3, e3, b3, wd, ed, bd, inv1, inv2, inv3, invd, v1, v2, v3,
                             vd, h1, h2, sc, out, n, h, w, cin, cmid, cout, stride, dilation, stream);
  }
  if (v2 == nullptr || v3 == nullptr || (wd == nullptr) != (vd == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return any_stride<true>(x, w1, e1, b1, w2, e2, b2, w3, e3, b3, wd, ed, bd, inv1, inv2, inv3, invd, v1, v2, v3, vd,
                          h1, h2, sc, out, n, h, w, cin, cmid, cout, stride, dilation, stream);
}
