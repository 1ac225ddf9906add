// int8 ResNet-50 bottleneck block on Hopper (kernel K4; any stride).
//
// Replaces the Pallas kernel robosat_tpu/models/qenc.py:bottleneck_block_s2
// (_block_s2_kernel, stride 2 with torch-style (1, 1) padding and a
// stride-2 projection). The stride-1 block (K3, qenc.py:bottleneck_block)
// runs qenc_s1.cu on the pipelined wgmma conv instead.
//
// What bounds it on the H100: at the main-path shapes (batch 8, 576 px) a
// block is 11.5-12.2 G int8 MACs (stride 1) or 19.7 G (stride 2). A fused block
// would move only its bf16 input and output: ~140 ops per byte in layer1
// (144^2 x 256 channels in and out), ~550 in layer3, ~1100 in layer4,
// against the ~590 ops per byte of the 1979 TOP/s int8 peak over 3.35 TB/s.
// Layers 1-2 are bandwidth bound, layer 4 compute bound. This first design
// keeps the TPU kernel's arithmetic but not its VMEM residency: it runs the
// block as 3-4 launches of the shared implicit-GEMM conv and passes the bf16
// intermediates through device memory (2-4x the fused block's bytes).
// Quantization happens on load, so no int8 copy is written.
//
//   h1  = relu(bf16(conv1_1x1(q(x))))                   -> h1 (N, H, W, Cmid)
//   h2  = relu(bf16(conv2_3x3/stride(q(h1))))           -> h2 (N, Ho, Wo, Cmid)
//   sc  = bf16(down_1x1/stride(q(x)))  or  x            -> sc (N, Ho, Wo, Cout)
//   out = bf16(relu(bf16(conv3_1x1(q(h2))) + sc))       -> out

#include "int8_conv.cuh"

extern "C" int rs_bottleneck_block(const void* x, const void* w1, const float* e1, const float* b1, const void* w2,
                                   const float* e2, const float* b2, const void* w3, const float* e3, const float* b3,
                                   const void* wd, const float* ed, const float* bd, float inv1, float inv2,
                                   float inv3, float invd, void* h1, void* h2, void* sc, void* out, int n, int h,
                                   int w, int cin, int cmid, int cout, int stride, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  int rc;
  rs::ConvParams p = rs::conv_params(x, w1, e1, b1, h1, inv1, n, h, w, cin, cmid, 1, 1, 0);
  if ((rc = rs::launch_int8_conv(p, rs::EPI_RELU, stream)) != 0) return rc;

  p = rs::conv_params(h1, w2, e2, b2, h2, inv2, n, h, w, cmid, cmid, 3, stride, 1);
  if ((rc = rs::launch_int8_conv(p, rs::EPI_RELU, stream)) != 0) return rc;

  const void* shortcut = x;
  if (wd != nullptr) {
    p = rs::conv_params(x, wd, ed, bd, sc, invd, n, h, w, cin, cout, 1, stride, 0);
    if ((rc = rs::launch_int8_conv(p, rs::EPI_LINEAR, stream)) != 0) return rc;
    shortcut = sc;
  }

  const int ho = (h - 1) / stride + 1;
  const int wo = (w - 1) / stride + 1;
  p = rs::conv_params(h2, w3, e3, b3, out, inv3, n, ho, wo, cmid, cout, 1, 1, 0);
  p.residual = static_cast<const __nv_bfloat16*>(shortcut);
  return rs::launch_int8_conv(p, rs::EPI_RESIDUAL_RELU, stream);
}
