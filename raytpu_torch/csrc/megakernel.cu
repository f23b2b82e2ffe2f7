// Forward render megakernels for Hopper (sm_90a): raytpu's persistent
// sample refill, a thread taking one pixel after another.
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
//                              no BVH, 96 <= n <= 4096 spheres; here the
//                              brute sweep's kernel (K1a's) under another
//                              name
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
// tape are TPU mechanisms with no counterpart here.  Each pixel runs its
// spp samples in order, each for at most `depth` bounces, stopping at the
// first miss, absorption or the depth cap: the reference's per-pixel loop
// (ShaderCompute.hlsl CSMain), which gives both of the JAX kernel's loop
// forms bit for bit, on the persistent sample refill (render_refill).
//
// What bounds it on this card: FP32 ALU work in the closest-hit sweep (18
// operations for a missed sphere test), and warp divergence, because
// paths end at different depths, rays enter different leaves and the
// material branches differ per lane.  K1a tests every sphere for every ray.
// The flat BVH sweep (K1c and the flat K1b, K1', K2 and K4) tests the
// outliers, then walks the L leaf boxes of the ray's own octant copy front
// to back (about 24 operations each) and sweeps a leaf, leaf_size sphere
// tests, only where the ray's own slab test passes within its best t so
// far.  Its design is for SIMT (render_refill below): raytpu's persistent
// sample refill with its multi-tile tail grouping (a persistent grid whose
// lanes take their next pixel from a counter), so that a warp pays its
// busiest lane's bounce steps once a launch rather than each sample's
// longest path; a sweep that lets each lane advance to
// its own next leaf and sweeps the warp's leaves together
// (closest_hit_staged), so that a warp pays its busiest lane's leaves
// rather than every leaf position any lane enters; and the sweep's rows
// and boxes staged in shared memory once per block (stage_flat, as much
// of them as a block may hold), since after one bounce a warp's lanes read
// up to 32 different rows a load.
// K1d (and the walk's K1b, K1', K2 and K4) walks the octant copy's nodes
// instead (see render_common.cuh): box tests for the subtrees the ray
// enters rather than for all L leaves.  Its design is the flat sweep's:
// render_refill's persistent sample refill, a sweep that lets each lane
// advance to its own next entered leaf and sweeps the warp's leaves together
// (closest_hit_walk), each missed sphere test ended before sqrtf, the
// spheres read as 16-byte rows (cx, cy, cz, rad * rad), one load a test,
// and the node rows in a 16-byte layout read through L1 (after one bounce
// a warp's lanes walk up to 32 different nodes, each row's address the
// last row's skip).
// The winner's attributes are read once, by index, after the sweep.
// K4 adds one 2- or 4-byte store per bounce step, tape[k][pix]: threads of a
// warp are neighbouring pixels and write neighbouring addresses at the same
// k, so the stores coalesce whenever the warp's lanes are at the same step
// (under the refill, lanes part after their first sample and their first
// pixel).  The census (K1') keeps three per-thread counters in registers
// (four for the walk: the nodes visited; four more: the warp's
// bounce-loop, sphere-test and node-loop iterations, counted by one of the
// lanes that run them, and the lane's sphere tests) and adds them once per
// warp at the end (a warp reduction, then one 64-bit atomic per counter);
// without it the counting code is not compiled.
// The brute sweep (K1a, and K1b, K1', K2 and K4 without a BVH; K1e is the
// same kernel, which raytpu_torch.kernels.megakernel counts as K1e where
// raytpu's dense stage would run) tests every sphere in index order over
// the scene's rows (cx, cy, cz, r^2) staged in shared memory once per block
// (kDense, up to kDenseMax spheres; see stage_dense in render_common.cuh),
// past that over the scene pack (kBrute), each missed test ended at the
// sign of its discriminant, before sqrtf's slow path (sweep_rows).  Its
// design for SIMT is the flat sweep's: render_refill's persistent sample
// refill (at REFERENCE_V2's depth 50 through glass and metal a warp's
// lanes end their samples far apart) and the rows read from shared memory
// (a broadcast instead of four L1 reads a sphere).  The same tests in the
// same order as the pack's sweep, so every output is the per-sample
// loop's it replaced bit for bit.
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

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "render_common.cuh"

namespace {

using namespace rt;

constexpr unsigned kFull = 0xFFFFFFFFu;
// leaves entered, bounce steps, samples, nodes visited (the walk's only)
constexpr int kCensus = 4;
// the refill's warp counters after them: the warp's bounce-loop,
// sphere-test and node-loop iterations, the lanes' sphere tests
constexpr int kWarpCensus = 4;

struct Params {
  const CamPack* cam;
  const float* scene;  // (9, n) rows: cx cy cz rad mat_type ar ag ab mat_param
  FlatBvh bvh;         // kFlat's leaf list
  FlatStage stage;     // what of it kFlat stages in shared memory
  NodeBvh walk;        // kWalk's node rows (walk.rows)
  void* tape;          // (g_cap, rows * width) int16 / int32, or null
  unsigned long long* census;  // (kCensus + kWarpCensus,) counters, or null
  const float* acc_in;      // K2: (rows, width, 3) linear sums carried in
  const uint32_t* seed_in;  // K2: (rows, width) seeds carried in
  float* out;          // (rows, width, 3): the image, or K2's linear sums
  uint32_t* seed_out;  // K2: (rows, width) seeds carried out
  unsigned* pixel_next;  // the refill's pixel counter, 0 at launch
  int n, width, height, row0, rows, spp, depth, g_cap, tape_wide;
  uint32_t s0;         // index of the batch's first sample (0 but for K2)
  float t_min, inv_w, inv_h, inv_spp, gamma;
  int parallel, v1;
};

// Adds the census counts v[0, kN) of the block's threads into
// counters[0, kN): a warp reduction, then one 64-bit atomic a counter.
// Every lane of the warp calls it.
template <int kN>
__device__ __forceinline__ void add_census(const unsigned (&v)[kN],
                                           unsigned long long* counters) {
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const unsigned sum = __reduce_add_sync(kFull, v[i]);
    if ((threadIdx.x & 31) == 0 && sum)
      atomicAdd(counters + i, static_cast<unsigned long long>(sum));
  }
}

// Every forward: the brute sweep's (K1a, K1e, K1b/brute, K1b/dense,
// K1'/brute, K1'/dense, K2/brute, K4/brute and their slabs), the flat
// sweep's (K1c, K1b/bvh, K1'/bvh, K2/bvh, K4/bvh and their slabs) and the
// walk's (K1d, K1b/walk, K1'/walk, K2/walk, K4/walk and their slabs):
// raytpu's persistent sample refill (make_refill_step,
// raytpu/kernels/megakernel.py:881-1000) on SIMT, with its multi-tile tail
// grouping.  A persistent grid (as many blocks as the card holds at once)
// runs one loop of bounce steps a thread.  When a lane's sample ends (a
// miss, an absorption or the depth cap) it folds the sample's radiance into
// its pixel's sums, in sample order, and generates the pixel's next sample
// in place; when its pixel's spp samples are done it writes the pixel and
// takes the next one from the launch's counter.  Each pixel keeps the
// sequential loop's draws, tests and sums, so every output is the
// per-sample loop's bit for bit; what changes is the warp's schedule: a
// warp waits for its busiest lane once a launch, where the nested loops
// waited for the longest path of each sample.  The closest hit is
// closest_hit()'s: closest_hit_staged() over what stage_flat() puts in
// shared memory (kFlat), closest_hit_walk() over the node rows in device
// memory (kWalk), or the brute sweep over the rows stage_dense() puts
// there (kDense) or over the scene pack (kBrute).  The tape cursor runs
// across a pixel's samples in order; K2's carry is read when a pixel
// starts and written when it is done.
template <int kHit, int kTape, bool kCount, bool kCarry>
__device__ __forceinline__ void render_refill(const Params& p) {
  if constexpr (kHit == kFlat)
    stage_flat(p.scene, p.n, p.bvh, p.stage);
  else if constexpr (kHit == kDense)
    stage_dense(p.scene, p.n);
  const CamPack& cam = *p.cam;  // read where a sample starts, not held
  const SceneView s = scene_view(p.scene, p.n);
  const bool v1 = p.v1 != 0;
  const int pixels = p.rows * p.width;  // the slab's buffers
  const int threads = gridDim.x * blockDim.x * blockDim.y;
  Census cn{};
  TapeCursor tc{p.tape, static_cast<size_t>(pixels), 0, p.g_cap, 0,
                p.tape_wide};

  // the pixel's place, seeds and sums; its sample's ray, throughput,
  // radiance, index and bounce
  float fx = 0.0f, fy = 0.0f;
  uint32_t seed0 = 0u, chain = 0u, sd = 0u;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  Ray r{};
  float cr = 1.0f, cg = 1.0f, cb = 1.0f;
  float rr = 0.0f, rg = 0.0f, rb = 0.0f;
  int smp = 0, d = 0;

  // Sets up pixel px and its first sample's seed; a row past the frame
  // traces nothing and is written 0 at once (false).
  auto begin = [&](int px) -> bool {
    const int x = px % p.width;
    const int y = p.row0 + px / p.width;
    if (y >= p.height) {
      float* o = p.out + static_cast<size_t>(px) * 3;
      o[0] = o[1] = o[2] = 0.0f;
      if (kCarry) p.seed_out[px] = 0u;
      return false;
    }
    fx = static_cast<float>(x);
    fy = static_cast<float>(y);
    seed0 = base_hash(static_cast<uint32_t>(x), static_cast<uint32_t>(y));
    chain = kCarry && !p.parallel ? p.seed_in[px] : seed0;
    acc_r = acc_g = acc_b = 0.0f;
    if (kCarry) {
      const float* a = p.acc_in + static_cast<size_t>(px) * 3;
      acc_r = a[0];
      acc_g = a[1];
      acc_b = a[2];
    }
    tc.pix = static_cast<size_t>(px);
    tc.k = 0;
    smp = 0;
    sd = p.parallel ? fold_in(seed0, p.s0) : chain;
    return true;
  };
  // The sample's ray from seed sd (gen_ray advances it), throughput 1.
  auto sample = [&]() {
    RayGen g;
    r = gen_ray(cam, fx, fy, p.inv_w, p.inv_h, sd, g);
    cr = cg = cb = 1.0f;
    rr = rg = rb = 0.0f;
    d = 0;
    if (kCount) ++cn.samples;
  };

  int pixel = blockIdx.x * blockDim.x * blockDim.y + threadIdx.x +
              blockDim.x * threadIdx.y;
  while (pixel < pixels && !begin(pixel))
    pixel = next_item(p.pixel_next, threads);
  if (pixel < pixels) sample();
  while (pixel < pixels) {
    if (d < p.depth) {  // one bounce step: closest_hit(), then shade()
      if (kCount) warp_tick(cn.warp_steps, 1u);
      float tb;
      const int win = closest_hit<kHit, kCount>(s, p.bvh, p.stage, p.walk, r,
                                                p.t_min, tb, cn);
      if (kTape == kTapeWrite && tc.k < tc.g_cap) tc.put(win);
      if (kTape != kNoTape) ++tc.k;
      if (kCount) ++cn.steps;
      const bool scattered = shade(s, win, tb, v1, sd, r, cr, cg, cb, rr,
                                   rg, rb);
      if (scattered && ++d < p.depth) continue;
    }
    // the sample ended (at the depth cap its radiance is still 0: black)
    acc_r = acc_r + rr;
    acc_g = acc_g + rg;
    acc_b = acc_b + rb;
    if (!p.parallel) chain = sd;
    if (++smp < p.spp) {
      sd = p.parallel ? fold_in(seed0, p.s0 + static_cast<uint32_t>(smp))
                      : chain;
    } else {  // the pixel is done: write it, take the next one
      float* o = p.out + tc.pix * 3;
      if (kCarry) {
        o[0] = acc_r;
        o[1] = acc_g;
        o[2] = acc_b;
        p.seed_out[tc.pix] = p.parallel ? seed0 : chain;
      } else {
        o[0] = to_gamma(acc_r * p.inv_spp, p.gamma);
        o[1] = to_gamma(acc_g * p.inv_spp, p.gamma);
        o[2] = to_gamma(acc_b * p.inv_spp, p.gamma);
      }
      do {
        pixel = next_item(p.pixel_next, threads);
      } while (pixel < pixels && !begin(pixel));
      if (pixel >= pixels) break;
    }
    sample();
  }
  if (kCount) {  // the census; the warp counters after kCensus
    const unsigned counts[kCensus] = {cn.leaves, cn.steps, cn.samples,
                                      cn.nodes};
    const unsigned warps[kWarpCensus] = {cn.warp_steps, cn.warp_tests,
                                         cn.warp_nodes, cn.tests};
    add_census(counts, p.census);
    add_census(warps, p.census + kCensus);
  }
}

template <int kHit, int kTape, bool kCount, bool kCarry>
__global__ void __launch_bounds__(256)
render_fwd_kernel(Params p) {
  render_refill<kHit, kTape, kCount, kCarry>(p);
}

template <int kHit, int kTape, bool kCount, bool kCarry>
int launch(const Params& p, cudaStream_t stream) {
  auto kernel = render_fwd_kernel<kHit, kTape, kCount, kCarry>;
  const dim3 block(32, 8);
  // the brute sweep's staged rows or the flat sweep's; past 48 KB only
  // after the kernel opts in
  const size_t shmem =
      kHit == kDense ? sizeof(float4) * p.n
      : kHit == kFlat ? sizeof(float4) * flat_stage_rows(p.stage,
                                                         p.bvh.leaf_size)
                      : 0;
  if (shmem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shmem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // a persistent grid: the blocks the card holds at once, no more than
  // the pixels fill
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, block.x * block.y, shmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long pixels = static_cast<long long>(p.width) * p.rows;
  const long long need = (pixels + block.x * block.y - 1) /
                         (block.x * block.y);
  const dim3 grid(static_cast<unsigned>(
      std::max(1LL, std::min(need, static_cast<long long>(sms) * per_sm))));
  kernel<<<grid, block, shmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation of the closest-hit policy `hit` for one variant.
template <int kTape, bool kCount, bool kCarry>
int launch_hit(int hit, const Params& p, cudaStream_t stream) {
  if (hit == kFlat) return launch<kFlat, kTape, kCount, kCarry>(p, stream);
  if (hit == kWalk) return launch<kWalk, kTape, kCount, kCarry>(p, stream);
  if (hit == kDense) return launch<kDense, kTape, kCount, kCarry>(p, stream);
  return launch<kBrute, kTape, kCount, kCarry>(p, stream);
}

}  // namespace

// C entry point (loaded with ctypes).  Launches on `stream` and does not
// synchronise; returns cudaGetLastError() so a refused launch is reported.
// It renders rows [row0, row0 + rows) of the width x height frame into
// buffers of `rows` rows.  The variant follows the operands: `flat`
// non-null -> the flat BVH sweep (scene in leaf order), `nodes` non-null ->
// the skip-pointer walk of its `copies` copies of n_trav node rows in the
// 16-byte layout (WalkRow, render_common.cuh) over the permuted scene's
// rows (cx, cy, cz, rad * rad) in `spheres` (scene in leaf order),
// neither -> the brute sweep, over the rows it stages in shared memory
// up to kDenseMax spheres (kDense) or else over the scene pack (kBrute),
// both -> refused; the flat sweep stages
// stage_leaves leaves, stage_outliers outlier rows (0 or out_cnt) and
// stage_boxes box rows (0 or 16 n_leaves) in shared memory (FlatStage: the
// wrapper plans it within raytpu_flat_device's opt-in limit); `taping` ->
// the taping forward into `tape` (g_cap steps a pixel, int32 when
// tape_wide; null only when g_cap is 0); `census` non-null -> the counting
// variant (kCensus + kWarpCensus counters: the refill adds its warp
// counters); `carry` -> K2, which reads acc_in / seed_in and writes `out` /
// seed_out (either pair may alias: a thread reads its own pixel before it
// writes it) from sample index s0 on.  A tape, the census and the carry
// exclude one another.  The refill hands out the pixels past its
// persistent grid's first ones from `pixel_next`, one u32 of the caller's
// that this entry zeroes on `stream` before the launch.  spp >= 1.  The
// block's x extent is one warp, so threadIdx.x is the lane.
extern "C" int raytpu_render_fwd(const void* cam, const void* scene, int n,
                                 const void* flat, int n_leaves,
                                 int leaf_size, const void* nodes,
                                 int n_trav, int copies, int out_base,
                                 int out_cnt, int stage_leaves,
                                 int stage_outliers, int stage_boxes,
                                 int taping, void* tape,
                                 int g_cap, int tape_wide, void* census,
                                 int carry,
                                 const void* acc_in, const void* seed_in,
                                 void* seed_out, void* pixel_next,
                                 unsigned s0, void* out,
                                 int width, int height, int row0, int rows,
                                 int spp, int depth, float t_min,
                                 float inv_w, float inv_h, float inv_spp,
                                 float gamma, int parallel, int v1,
                                 const void* spheres, void* stream) {
  if ((taping != 0) + (census != nullptr) + (carry != 0) > 1 || rows < 1 ||
      row0 < 0 || pixel_next == nullptr ||
      (flat != nullptr && nodes != nullptr) ||
      (nodes != nullptr &&
       (n_trav < 1 || (copies != 1 && copies != 8) || spheres == nullptr)) ||
      (carry && (acc_in == nullptr || seed_in == nullptr ||
                 seed_out == nullptr)) ||
      (flat != nullptr &&
       (stage_leaves < 0 || stage_leaves > n_leaves ||
        (stage_outliers != 0 && stage_outliers != out_cnt) ||
        (stage_boxes != 0 && stage_boxes != 16 * n_leaves))) ||
      spp < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.cam = static_cast<const CamPack*>(cam);
  p.scene = static_cast<const float*>(scene);
  p.bvh = FlatBvh{static_cast<const float*>(flat), n_leaves, leaf_size,
                  out_base, out_cnt};
  p.stage = FlatStage{stage_leaves, stage_outliers, stage_boxes};
  p.walk = NodeBvh{n_trav, copies, out_base, out_cnt,
                   static_cast<const float4*>(nodes),
                   static_cast<const float4*>(spheres)};
  p.tape = tape;
  p.census = static_cast<unsigned long long*>(census);
  p.acc_in = static_cast<const float*>(acc_in);
  p.seed_in = static_cast<const uint32_t*>(seed_in);
  p.out = static_cast<float*>(out);
  p.seed_out = static_cast<uint32_t*>(seed_out);
  p.pixel_next = static_cast<unsigned*>(pixel_next);
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
  const cudaError_t zeroed = cudaMemsetAsync(pixel_next, 0, sizeof(unsigned),
                                             st);
  if (zeroed != cudaSuccess) return static_cast<int>(zeroed);
  const int hit = flat != nullptr    ? kFlat
                  : nodes != nullptr ? kWalk
                  : n <= kDenseMax   ? kDense
                                     : kBrute;
  if (taping) return launch_hit<kTapeWrite, false, false>(hit, p, st);
  if (census != nullptr) return launch_hit<kNoTape, true, false>(hit, p, st);
  if (carry) return launch_hit<kNoTape, false, true>(hit, p, st);
  return launch_hit<kNoTape, false, false>(hit, p, st);
}

// The current device's opt-in shared memory a block (the flat sweep's
// staging limit) into *optin, and into *blocks how many blocks of K1c's
// instantiation an SM holds with `shmem` bytes of it staged (launch()'s
// block of 256 threads; the persistent grid's blocks per SM).
extern "C" int raytpu_flat_device(int shmem, int* optin, int* blocks) {
  auto kernel = render_fwd_kernel<kFlat, kNoTape, false, false>;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(
        optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess && shmem > 48 * 1024)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shmem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, 32 * 8,
                                                      shmem);
  return static_cast<int>(e);
}
