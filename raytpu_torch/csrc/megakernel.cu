// Forward render megakernels for Hopper (sm_90a): one thread per pixel.
//
// One kernel template, six TPU kernels:
//   K1a  brute sweep           raytpu/kernels/megakernel.py
//                              ::_render_pallas_fwd_impl (no BVH)
//   K1b  row slab              the same function with row0 / rows
//   K1c  flat BVH sweep        the same function with nodes / perm / flat
//                              (_flat_sweep_ti, _seed_outlier_tests, the
//                              octant pick)
//   K1d  skip-pointer walk     the same function past 64 leaves a copy or
//                              unpadded (megakernel.py:531-696)
//   K1e  dense stage           the same function's dense branch
//                              (megakernel.py:1497-1506, body :462-527):
//                              no BVH, 96 <= n <= 4096 spheres
//   K1'  census                the same function with count_leaves=True
//                              (brute, flat or walk)
//   K2   carry-state batch     raytpu/kernels/megakernel.py
//                              ::accumulate_pallas (brute, flat or walk,
//                              slab)
//   K4   taping forward        raytpu/kernels/gradkernel.py::render_tape_fwd
//        (write side)          (brute, flat or walk, slab)
// (kernel body from _make_kernel: make_gen_ray, make_bounce_body, the
// sequential / persistent-refill sample loop and the gamma epilogue.)  It
// computes the same thing, not the same schedule: the (8, 128) tiles, SMEM
// scalar packs, block_w scramble, "enter a leaf if any lane hits it", the
// one-hot MXU winner extraction and the windowed refill schedule of the TPU
// tape are TPU mechanisms with no counterpart here.  A thread owns one pixel
// and runs its spp samples in order, each for at most `depth` bounces,
// stopping at the first miss, absorption or the depth cap.  That is the
// reference's own shape (one thread per pixel, ShaderCompute.hlsl CSMain)
// and it gives both of the JAX kernel's loop forms, which are bit-identical.
//
// What bounds it on this card: FP32 ALU work in the closest-hit sweep (about
// 24 flops per ray and sphere test), and warp divergence, because paths end
// at different depths and the material branches differ per lane.  K1a tests
// every sphere for every ray.  K1c tests the outliers, then walks the L leaf
// boxes of the ray's own octant copy front to back (about 30 flops each) and
// enters a leaf, leaf_size sphere tests, only if the ray's own slab test
// passes within its best t so far: a thread enters what its ray needs, not
// what its warp needs (divergent, but a skipped leaf costs a lane nothing
// it would have used).  K1d walks the octant copy's nodes instead (see
// render_common.cuh): box tests for the subtrees the ray enters rather than
// for all L leaves.  The winner's attributes are read once, by index,
// after the sweep.  Scene rows and leaf rows are read from global memory at
// warp-uniform (K1a) or octant-uniform (K1c) addresses, broadcasts from L1;
// K1d's node rows at per-lane addresses once the lanes' walks part.
// K4 adds one 2- or 4-byte store per bounce step, tape[k][pix]: threads of a
// warp are neighbouring pixels and write neighbouring addresses at the same
// k, so the stores coalesce whenever the warp's lanes are at the same step.
// The census (K1') keeps three per-thread counters in registers (four for
// the walk: the nodes visited) and adds them once per warp at the end (a
// warp reduction, then one 64-bit atomic per counter); without it the
// counting code is not compiled.  K1e is the brute sweep over the scene's
// rows (cx, cy, cz, r^2) staged in shared memory once per block (see
// stage_dense in render_common.cuh): the same tests in the same order, so
// its image is K1a's bit for bit; what it changes is where the sweep's
// loads come from (a shared-memory broadcast instead of four L1 reads a
// sphere).  It is a plain forward only, full frame or slab: K2, K4, K1'
// and K3 keep the brute sweep, as raytpu's do.  Regrouping rays against
// divergence is later work.
//
// Slab mode (K1b, and every variant): the launch covers rows [row0, row0 +
// rows) of the cfg-sized frame and its buffers (image, tape, carried state)
// hold those rows only.  A thread's RNG key, fy and octant come from its
// absolute row, so stitched slabs give the full frame bit for bit.  Rows
// past the frame's last one (the last slab of an uneven split) trace
// nothing and write 0.  K2 (kCarry) is the progressive batch: it reads the
// pixel's linear sums and seed, adds spp samples (sequential RNG resumes the
// seed chain; parallel RNG draws sample s from fold_in(base_hash, s0 + s)
// and writes the base seed back) and writes linear sums, no gamma.  One
// thread owns one pixel, so the state may be updated in place.
//
// Numerics and the device functions (RNG, raygen, the closest-hit policies,
// materials, sky, gamma) live in render_common.cuh, which the fused VJP
// kernel K3 (gradkernel.cu) shares, so that its passes reproduce this image
// bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

#include "render_common.cuh"

namespace {

using namespace rt;

constexpr unsigned kFull = 0xFFFFFFFFu;
// leaves entered, bounce steps, samples, nodes visited (the walk's only)
constexpr int kCensus = 4;
// the dense stage's largest scene: 64 KB of staged rows (raytpu's
// _DENSE_MAX; raytpu_torch.kernels.megakernel.DENSE_MAX)
constexpr int kDenseMax = 4096;

struct Params {
  const CamPack* cam;
  const float* scene;  // (9, n) rows: cx cy cz rad mat_type ar ag ab mat_param
  FlatBvh bvh;         // kFlat's leaf list
  NodeBvh walk;        // kWalk's node list
  void* tape;          // (g_cap, rows * width) int16 / int32, or null
  unsigned long long* census;  // (kCensus,) counters, or null
  const float* acc_in;      // K2: (rows, width, 3) linear sums carried in
  const uint32_t* seed_in;  // K2: (rows, width) seeds carried in
  float* out;          // (rows, width, 3): the image, or K2's linear sums
  uint32_t* seed_out;  // K2: (rows, width) seeds carried out
  int n, width, height, row0, rows, spp, depth, g_cap, tape_wide;
  uint32_t s0;         // index of the batch's first sample (0 but for K2)
  float t_min, inv_w, inv_h, inv_spp, gamma;
  int parallel, v1;
};

template <int kHit, int kTape, bool kCount, bool kCarry>
__global__ void __launch_bounds__(256)
render_fwd_kernel(Params p) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int ly = blockIdx.y * blockDim.y + threadIdx.y;  // row in the slab
  const int y = p.row0 + ly;                              // row in the frame
  // valid: a pixel of the slab's buffers; live: one the frame holds.
  // Lanes outside the buffers stay to the end when counting: the census
  // adds per warp, with all 32 lanes
  const bool valid = x < p.width && ly < p.rows;
  const bool live = valid && y < p.height;
  // K1e stages the scene before any thread of the block returns
  if (kHit == kDense) stage_dense(p.scene, p.n);
  if (!kCount && !valid) return;

  const CamPack cam = *p.cam;
  const SceneView s = scene_view(p.scene, p.n);
  const float fx = static_cast<float>(x);
  const float fy = static_cast<float>(y);
  const uint32_t seed0 = base_hash(static_cast<uint32_t>(x),
                                   static_cast<uint32_t>(y));
  const size_t pix = static_cast<size_t>(ly) * p.width + x;
  TapeCursor tc{p.tape, static_cast<size_t>(p.width) * p.rows, pix,
                p.g_cap, 0, p.tape_wide};
  Census cn{0u, 0u, 0u, 0u};

  uint32_t chain = seed0;  // the sequential mode's carried seed
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  if (kCarry && live) {
    if (!p.parallel) chain = p.seed_in[pix];
    acc_r = p.acc_in[pix * 3];
    acc_g = p.acc_in[pix * 3 + 1];
    acc_b = p.acc_in[pix * 3 + 2];
  }
  const int spp = live ? p.spp : 0;
  for (int smp = 0; smp < spp; ++smp) {
    uint32_t sd = p.parallel
                      ? fold_in(seed0, p.s0 + static_cast<uint32_t>(smp))
                      : chain;
    RayGen g;
    Ray r = gen_ray(cam, fx, fy, p.inv_w, p.inv_h, sd, g);
    float rr, rg, rb;
    trace_path<false, kHit, kTape, kCount>(s, p.bvh, p.walk, r, sd,
                                           p.depth, p.t_min, p.v1 != 0, rr,
                                           rg, rb, nullptr, tc, cn);
    acc_r = acc_r + rr;
    acc_g = acc_g + rg;
    acc_b = acc_b + rb;
    if (!p.parallel) chain = sd;
  }

  if (valid) {
    // a row past the frame traced nothing: its sums are 0, and so is the
    // gamma image of 0
    float* o = p.out + pix * 3;
    if (kCarry) {
      o[0] = acc_r;
      o[1] = acc_g;
      o[2] = acc_b;
      p.seed_out[pix] = live ? (p.parallel ? seed0 : chain) : 0u;
    } else {
      o[0] = to_gamma(acc_r * p.inv_spp, p.gamma);
      o[1] = to_gamma(acc_g * p.inv_spp, p.gamma);
      o[2] = to_gamma(acc_b * p.inv_spp, p.gamma);
    }
  }
  if (kCount) {
    const unsigned v[kCensus] = {cn.leaves, cn.steps, cn.samples,
                                 cn.nodes};
    constexpr int kCounted = kHit == kWalk ? kCensus : kCensus - 1;
#pragma unroll
    for (int i = 0; i < kCounted; ++i) {
      const unsigned sum = __reduce_add_sync(kFull, v[i]);
      if ((threadIdx.x & 31) == 0 && sum)
        atomicAdd(p.census + i, static_cast<unsigned long long>(sum));
    }
  }
}

template <int kHit, int kTape, bool kCount, bool kCarry>
int launch(const Params& p, cudaStream_t stream) {
  dim3 block(32, 8);
  dim3 grid((p.width + block.x - 1) / block.x,
            (p.rows + block.y - 1) / block.y);
  // the dense stage's rows; past 48 KB only after the kernel opts in
  const size_t shmem = kHit == kDense ? sizeof(float4) * p.n : 0;
  if (shmem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        render_fwd_kernel<kHit, kTape, kCount, kCarry>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shmem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  render_fwd_kernel<kHit, kTape, kCount, kCarry>
      <<<grid, block, shmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation of the closest-hit policy `hit` for one variant.
template <int kTape, bool kCount, bool kCarry>
int launch_hit(int hit, const Params& p, cudaStream_t stream) {
  if (hit == kFlat) return launch<kFlat, kTape, kCount, kCarry>(p, stream);
  if (hit == kWalk) return launch<kWalk, kTape, kCount, kCarry>(p, stream);
  return launch<kBrute, kTape, kCount, kCarry>(p, stream);
}

}  // namespace

// C entry point (loaded with ctypes).  Launches on `stream` and does not
// synchronise; returns cudaGetLastError() so a refused launch is reported.
// It renders rows [row0, row0 + rows) of the width x height frame into
// buffers of `rows` rows.  The variant follows the operands: `flat`
// non-null -> the flat BVH sweep (scene in leaf order), `nodes` non-null ->
// the skip-pointer walk of its `copies` copies of n_trav nodes (scene in
// leaf order), neither -> the brute sweep, both -> refused; `taping` ->
// the taping forward into `tape` (g_cap steps a pixel, int32 when
// tape_wide; null only when g_cap is 0); `census` non-null -> the counting
// variant (kCensus counters); `carry` -> K2, which reads acc_in / seed_in and
// writes `out` / seed_out (either pair may alias: a thread reads its own
// pixel before it writes it) from sample index s0 on.  A tape, the census
// and the carry exclude one another.  The block's x extent is one warp, so
// threadIdx.x is the lane.
extern "C" int raytpu_render_fwd(const void* cam, const void* scene, int n,
                                 int dense, const void* flat, int n_leaves,
                                 int leaf_size, const void* nodes,
                                 int n_trav, int copies, int out_base,
                                 int out_cnt, int taping, void* tape,
                                 int g_cap, int tape_wide, void* census,
                                 int carry,
                                 const void* acc_in, const void* seed_in,
                                 void* seed_out, unsigned s0, void* out,
                                 int width, int height, int row0, int rows,
                                 int spp, int depth, float t_min,
                                 float inv_w, float inv_h, float inv_spp,
                                 float gamma, int parallel, int v1,
                                 void* stream) {
  if ((taping != 0) + (census != nullptr) + (carry != 0) > 1 || rows < 1 ||
      row0 < 0 || (flat != nullptr && nodes != nullptr) ||
      (nodes != nullptr && (n_trav < 1 || (copies != 1 && copies != 8))) ||
      (carry && (acc_in == nullptr || seed_in == nullptr ||
                 seed_out == nullptr)) ||
      (dense && (flat != nullptr || nodes != nullptr || taping ||
                 census != nullptr || carry || n > kDenseMax)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.cam = static_cast<const CamPack*>(cam);
  p.scene = static_cast<const float*>(scene);
  p.bvh = FlatBvh{static_cast<const float*>(flat), n_leaves, leaf_size,
                  out_base, out_cnt};
  p.walk = NodeBvh{static_cast<const float*>(nodes), n_trav, copies,
                   out_base, out_cnt};
  p.tape = tape;
  p.census = static_cast<unsigned long long*>(census);
  p.acc_in = static_cast<const float*>(acc_in);
  p.seed_in = static_cast<const uint32_t*>(seed_in);
  p.out = static_cast<float*>(out);
  p.seed_out = static_cast<uint32_t*>(seed_out);
  p.s0 = s0;
  p.n = n;
  p.width = width;
  p.height = height;
  p.row0 = row0;
  p.rows = rows;
  p.spp = spp;
  p.depth = depth;
  p.g_cap = g_cap;
  p.tape_wide = tape_wide;
  p.t_min = t_min;
  p.inv_w = inv_w;
  p.inv_h = inv_h;
  p.inv_spp = inv_spp;
  p.gamma = gamma;
  p.parallel = parallel;
  p.v1 = v1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int hit = flat != nullptr ? kFlat : (nodes != nullptr ? kWalk : kBrute);
  if (dense) return launch<kDense, kNoTape, false, false>(p, st);
  if (taping) return launch_hit<kTapeWrite, false, false>(hit, p, st);
  if (census != nullptr) return launch_hit<kNoTape, true, false>(hit, p, st);
  if (carry) return launch_hit<kNoTape, false, true>(hit, p, st);
  return launch_hit<kNoTape, false, false>(hit, p, st);
}
