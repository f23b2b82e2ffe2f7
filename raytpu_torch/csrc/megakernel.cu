// Forward render megakernel for Hopper (sm_90a): one thread per pixel.
//
// Replaces the TPU kernel raytpu/kernels/megakernel.py::_render_pallas_fwd_impl
// (kernel body from _make_kernel: make_gen_ray, make_bounce_body with the
// brute-force sphere sweep, the sequential / persistent-refill sample loop and
// the gamma epilogue).  It computes the same thing, not the same schedule:
// the (8, 128) tiles, SMEM scalar packs, block_w scramble and one-hot MXU
// extraction are TPU mechanisms and have no counterpart here.  A thread owns
// one pixel and runs its spp samples in order, each for at most `depth`
// bounces, stopping at the first miss, absorption or the depth cap.  That is
// the reference's own shape (one thread per pixel, ShaderCompute.hlsl CSMain)
// and it gives both of the JAX kernel's loop forms, which are bit-identical.
//
// What bounds it on this card: FP32 ALU work in the closest-hit sweep (about
// 20 flops per ray and sphere, every sphere tested for every ray), and warp
// divergence, because paths end at different depths and the material
// branches differ per lane.  This first design answers the ALU bound only
// by doing no more than the sweep needs (the winner's attributes are read
// once, after the sweep, by index) and keeps the rest simple: sphere j is
// read from global memory at a warp-uniform address (a broadcast from L1),
// and divergence is left to the SIMT scheduler.  Staging the scene in
// shared memory and regrouping rays against divergence are later work.
//
// Numerics and the device functions (RNG, raygen, sweep, materials, sky,
// gamma) live in render_common.cuh, which the fused VJP kernel K3
// (gradkernel.cu) shares, so that its PASS 1 reproduces this image bit for
// bit.

#include <cstdint>
#include <cuda_runtime.h>

#include "render_common.cuh"

namespace {

using namespace rt;

struct Params {
  const CamPack* cam;
  const float* scene;  // (9, n) rows: cx cy cz rad mat_type ar ag ab mat_param
  float* out;          // (height, width, 3)
  int n, width, height, spp, depth;
  float t_min, inv_w, inv_h, inv_spp, gamma;
  int parallel, v1;
};

__global__ void __launch_bounds__(256)
render_fwd_kernel(Params p) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= p.width || y >= p.height) return;

  const CamPack cam = *p.cam;
  const SceneView s = scene_view(p.scene, p.n);
  const float fx = static_cast<float>(x);
  const float fy = static_cast<float>(y);
  const uint32_t seed0 = base_hash(static_cast<uint32_t>(x),
                                   static_cast<uint32_t>(y));

  uint32_t chain = seed0;  // the sequential mode's carried seed
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  for (int smp = 0; smp < p.spp; ++smp) {
    uint32_t sd = p.parallel ? fold_in(seed0, static_cast<uint32_t>(smp))
                             : chain;
    RayGen g;
    Ray r = gen_ray(cam, fx, fy, p.inv_w, p.inv_h, sd, g);
    float rr, rg, rb;
    trace_path<false>(s, r, sd, p.depth, p.t_min, p.v1 != 0, rr, rg, rb,
                      nullptr);
    acc_r = acc_r + rr;
    acc_g = acc_g + rg;
    acc_b = acc_b + rb;
    if (!p.parallel) chain = sd;
  }

  float* o = p.out + (static_cast<size_t>(y) * p.width + x) * 3;
  o[0] = to_gamma(acc_r * p.inv_spp, p.gamma);
  o[1] = to_gamma(acc_g * p.inv_spp, p.gamma);
  o[2] = to_gamma(acc_b * p.inv_spp, p.gamma);
}

}  // namespace

// C entry point (loaded with ctypes).  Launches on `stream` and does not
// synchronise; returns cudaGetLastError() so a refused launch is reported.
extern "C" int raytpu_render_fwd(const void* cam, const void* scene, int n,
                                 void* out, int width, int height, int spp,
                                 int depth, float t_min, float inv_w,
                                 float inv_h, float inv_spp, float gamma,
                                 int parallel, int v1, void* stream) {
  Params p;
  p.cam = static_cast<const CamPack*>(cam);
  p.scene = static_cast<const float*>(scene);
  p.out = static_cast<float*>(out);
  p.n = n;
  p.width = width;
  p.height = height;
  p.spp = spp;
  p.depth = depth;
  p.t_min = t_min;
  p.inv_w = inv_w;
  p.inv_h = inv_h;
  p.inv_spp = inv_spp;
  p.gamma = gamma;
  p.parallel = parallel;
  p.v1 = v1;
  dim3 block(32, 8);
  dim3 grid((width + block.x - 1) / block.x, (height + block.y - 1) / block.y);
  render_fwd_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
