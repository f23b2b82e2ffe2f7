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
// Numerics: the op order is raytpu/golden.py's (and the plain PyTorch
// version's, raytpu_torch/golden.py), and the file is built with
// -fmad=false, so no multiply-add contracts.  Contraction at the ground
// sphere's discriminant half_b^2 - a*c moves t by ~19 ulp (catastrophic
// cancellation at r = 1000).  No fast math: the root test relies on
// sqrtf(negative) = NaN and on NaN comparing false.  Where raytpu uses
// exp(log(c)/3) for a cube root, sin/cos of 2*pi*u, exp(log(x)/gamma) for
// gamma and rsqrt for normalization, so does this file.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kK = 1103515245u;
constexpr uint32_t kWeyl = 0x9E3779B9u;
constexpr uint32_t kM1 = 0x85EBCA6Bu;
constexpr uint32_t kM2 = 0xC2B2AE35u;
constexpr uint32_t kFold = 0xBB67AE85u;
constexpr float kInvU24 = 1.0f / 16777216.0f;
constexpr float kInvI31 = 1.0f / 2147483648.0f;
constexpr float kTwoPi = 6.28318530718f;
constexpr float kSafeEps = 1e-20f;
constexpr float kInf = 3.0e38f;  // "no hit yet"; the golden's +inf

// Camera pack (raytpu_torch.kernels.megakernel.pack_camera, 19 floats):
// origin, horizontal, vertical, lower_left, the lens basis u and v, lens_r.
// The lens basis v is named w here, since v is the vertical span.
struct CamPack {
  float o[3], h[3], v[3], ll[3], u[3], w[3], lens_r;
};

__device__ __forceinline__ uint32_t base_hash(uint32_t px, uint32_t py) {
  uint32_t hx = kK * ((px >> 1) ^ py);
  uint32_t hy = kK * ((py >> 1) ^ px);
  uint32_t h32 = kK * (hx ^ (hy >> 3));
  return h32 ^ (h32 >> 16);
}

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= kM1;
  h ^= h >> 13;
  h *= kM2;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t fold_in(uint32_t state, uint32_t k) {
  return fmix32(state + (k + 1u) * kFold);
}

// One state advance (Weyl step + finalize): returns the draw, advances state.
__device__ __forceinline__ uint32_t draw(uint32_t& state) {
  state += kWeyl;
  return fmix32(state);
}

__device__ __forceinline__ float u31(uint32_t n) {
  return static_cast<float>(static_cast<int>(n & 0x7FFFFFFFu)) * kInvI31;
}

__device__ __forceinline__ float hash1_of(uint32_t n) {
  return static_cast<float>(static_cast<int>(n >> 8)) * kInvU24;
}

__device__ __forceinline__ float dot3(float ax, float ay, float az,
                                      float bx, float by, float bz) {
  return ax * bx + ay * by + az * bz;
}

__device__ __forceinline__ void normalize3(float& x, float& y, float& z) {
  float inv = rsqrtf(fmaxf(dot3(x, y, z, x, y, z), kSafeEps));
  x = x * inv;
  y = y * inv;
  z = z * inv;
}

__device__ __forceinline__ void reflect(float vx, float vy, float vz,
                                        float nx, float ny, float nz,
                                        float& ox, float& oy, float& oz) {
  float d = dot3(vx, vy, vz, nx, ny, nz);
  ox = vx - 2.0f * d * nx;
  oy = vy - 2.0f * d * ny;
  oz = vz - 2.0f * d * nz;
}

// Unit-sphere sample from the draw n (hash3 lanes): cbrt radius as
// exp(log(c)/3) with the c == 0 guard, angles as sin/cos of b * 2pi.
__device__ __forceinline__ void unit_sphere(uint32_t n, float& sx, float& sy,
                                            float& sz) {
  float a = u31(n);
  float b = u31(n * 16807u);
  float c = u31(n * 48271u);
  float h = a * 2.0f - 1.0f;
  float phi = b * kTwoPi;
  float r = c > 0.0f ? expf(logf(fmaxf(c, 1e-30f)) / 3.0f) : 0.0f;
  float s = sqrtf(fmaxf(1.0f - h * h, 0.0f));
  float rs = r * s;
  sx = rs * sinf(phi);
  sy = rs * cosf(phi);
  sz = r * h;
}

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
  const float* __restrict__ s_cx = p.scene;
  const float* __restrict__ s_cy = p.scene + p.n;
  const float* __restrict__ s_cz = p.scene + 2 * p.n;
  const float* __restrict__ s_rad = p.scene + 3 * p.n;
  const float* __restrict__ s_mt = p.scene + 4 * p.n;
  const float* __restrict__ s_ar = p.scene + 5 * p.n;
  const float* __restrict__ s_ag = p.scene + 6 * p.n;
  const float* __restrict__ s_ab = p.scene + 7 * p.n;
  const float* __restrict__ s_mp = p.scene + 8 * p.n;
  const bool defocus = cam.lens_r > 0.0f;
  const float fx = static_cast<float>(x);
  const float fy = static_cast<float>(y);
  const uint32_t seed0 = base_hash(static_cast<uint32_t>(x),
                                   static_cast<uint32_t>(y));

  uint32_t chain = seed0;  // the sequential mode's carried seed
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  for (int smp = 0; smp < p.spp; ++smp) {
    uint32_t sd = p.parallel ? fold_in(seed0, static_cast<uint32_t>(smp))
                             : chain;
    // -- jittered camera ray (golden accumulate_pixels + camera.get_ray)
    float j1a = u31(draw(sd));
    float j2b = u31(draw(sd) * 48271u);
    float u = (fx + j1a * 1.1f) * p.inv_w;
    float v = (fy + j2b * 1.1f) * p.inv_h;
    float offx = 0.0f, offy = 0.0f, offz = 0.0f;
    if (defocus) {  // a pinhole camera consumes no draw
      uint32_t n = draw(sd);
      float a = u31(n);
      float b = u31(n * 48271u);
      float phi = b * kTwoPi;
      float r = sqrtf(a);
      float rdx = cam.lens_r * (r * sinf(phi));
      float rdy = cam.lens_r * (r * cosf(phi));
      offx = cam.u[0] * rdx + cam.w[0] * rdy;
      offy = cam.u[1] * rdx + cam.w[1] * rdy;
      offz = cam.u[2] * rdx + cam.w[2] * rdy;
    }
    float ox = cam.o[0] + offx;
    float oy = cam.o[1] + offy;
    float oz = cam.o[2] + offz;
    float dx = cam.ll[0] + u * cam.h[0] + v * cam.v[0] - ox;
    float dy = cam.ll[1] + u * cam.h[1] + v * cam.v[1] - oy;
    float dz = cam.ll[2] + u * cam.h[2] + v * cam.v[2] - oz;

    float cr = 1.0f, cg = 1.0f, cb = 1.0f;
    float rr = 0.0f, rg = 0.0f, rb = 0.0f;
    for (int d = 0; d < p.depth; ++d) {
      // -- closest hit over all spheres (golden.hit_world); the strict <
      // keeps the lowest index on ties, like argmin
      float a = dot3(dx, dy, dz, dx, dy, dz);
      float inv_a = 1.0f / a;
      float tb = kInf;
      int win = -1;
      for (int j = 0; j < p.n; ++j) {
        float ocx = ox - s_cx[j];
        float ocy = oy - s_cy[j];
        float ocz = oz - s_cz[j];
        float rad = s_rad[j];
        float half_b = ocx * dx + ocy * dy + ocz * dz;
        float c = dot3(ocx, ocy, ocz, ocx, ocy, ocz) - rad * rad;
        float disc = half_b * half_b - a * c;
        // NaN form of the root test: disc < 0 -> NaN -> compares false
        float sqrtd = sqrtf(disc);
        float root1 = (-half_b - sqrtd) * inv_a;
        float root2 = (-half_b + sqrtd) * inv_a;
        float root = root1 >= p.t_min ? root1 : root2;
        if (root >= p.t_min && root < tb) {
          tb = root;
          win = j;
        }
      }
      if (win < 0) {  // miss: sky of the pre-scatter direction
        float ux = dx, uy = dy, uz = dz;
        normalize3(ux, uy, uz);
        float t = 0.5f * (uy + 1.0f);
        rr = cr * (1.0f - 0.5f * t);
        rg = cg * (1.0f - 0.3f * t);
        rb = cb * 1.0f;
        break;
      }
      float mt = s_mt[win];
      bool is_d = mt == 0.0f, is_m = mt == 1.0f, is_g = mt == 2.0f;
      if (!(is_d || is_m || is_g)) break;  // absorbed: black, seed kept

      // -- hit point and outward normal
      float hpx = ox + tb * dx;
      float hpy = oy + tb * dy;
      float hpz = oz + tb * dz;
      float h_rad = s_rad[win];
      float inv_r = 1.0f / (h_rad == 0.0f ? 1.0f : h_rad);
      float nx = (hpx - s_cx[win]) * inv_r;
      float ny = (hpy - s_cy[win]) * inv_r;
      float nz = (hpz - s_cz[win]) * inv_r;
      bool front = dot3(dx, dy, dz, nx, ny, nz) < 0.0f;
      float sgn = front ? 1.0f : -1.0f;
      nx = nx * sgn;
      ny = ny * sgn;
      nz = nz * sgn;

      // -- scatter (golden.scatter): one draw feeds the sphere sample
      // (hash3 lanes) and the Schlick coin (hash1) alike
      uint32_t sd_new = sd;
      uint32_t n = draw(sd_new);
      float mp = s_mp[win];
      float odx, ody, odz;
      float atr = 1.0f, atg = 1.0f, atb = 1.0f;
      if (is_g) {
        float h1 = hash1_of(n);
        float ior = fmaxf(mp, 1e-3f);
        float ux = dx, uy = dy, uz = dz;
        normalize3(ux, uy, uz);
        float ratio = front ? 1.0f / ior : ior;
        float cosine = fminf(dot3(-ux, -uy, -uz, nx, ny, nz), 1.0f);
        float sine = sqrtf(fmaxf(1.0f - cosine * cosine, 0.0f));
        bool cannot = ratio * sine > 1.0f;
        float r0 = (1.0f - ratio) / (1.0f + ratio);
        r0 = r0 * r0;
        float m = 1.0f - cosine;
        float schlick = r0 + (1.0f - r0) * (m * m * m * m * m);
        if (cannot || schlick > h1) {
          reflect(ux, uy, uz, nx, ny, nz, odx, ody, odz);
        } else {  // refract (golden._refract)
          float cos_t = fminf(dot3(-ux, -uy, -uz, nx, ny, nz), 1.0f);
          float px = ratio * (ux + cos_t * nx);
          float py = ratio * (uy + cos_t * ny);
          float pz = ratio * (uz + cos_t * nz);
          float par = -sqrtf(fmaxf(fabsf(1.0f - dot3(px, py, pz, px, py, pz)),
                                   kSafeEps));
          odx = px + par * nx;
          ody = py + par * ny;
          odz = pz + par * nz;
        }
      } else {
        float sx, sy, sz;
        unit_sphere(n, sx, sy, sz);
        atr = s_ar[win];
        atg = s_ag[win];
        atb = s_ab[win];
        if (p.v1) {
          // hemisphere flip (Shader_RT.fx:151-163)
          bool flip = dot3(sx, sy, sz, nx, ny, nz) > 0.0f;
          float hx = flip ? sx : -sx;
          float hy = flip ? sy : -sy;
          float hz = flip ? sz : -sz;
          if (is_d) {  // n + hemisphere, near-zero guard, unnormalized
            float lx = nx + hx, ly = ny + hy, lz = nz + hz;
            bool near0 = fabsf(lx) < 1e-8f && fabsf(ly) < 1e-8f &&
                         fabsf(lz) < 1e-8f;
            odx = near0 ? nx : lx;
            ody = near0 ? ny : ly;
            odz = near0 ? nz : lz;
          } else {  // reflect(normalize(rd)) + saturate(fuzz) * hemisphere
            float ux = dx, uy = dy, uz = dz;
            normalize3(ux, uy, uz);
            float rx, ry, rz;
            reflect(ux, uy, uz, nx, ny, nz, rx, ry, rz);
            float fz = fminf(fmaxf(mp, 0.0f), 1.0f);
            odx = rx + fz * hx;
            ody = ry + fz * hy;
            odz = rz + fz * hz;
          }
        } else if (is_d) {  // normalize(normal + sphere sample)
          odx = nx + sx;
          ody = ny + sy;
          odz = nz + sz;
          normalize3(odx, ody, odz);
        } else {  // normalize(reflect(rd, n) + fuzz * sphere sample)
          float rx, ry, rz;
          reflect(dx, dy, dz, nx, ny, nz, rx, ry, rz);
          odx = rx + mp * sx;
          ody = ry + mp * sy;
          odz = rz + mp * sz;
          normalize3(odx, ody, odz);
        }
      }
      cr = cr * atr;
      cg = cg * atg;
      cb = cb * atb;
      ox = hpx;
      oy = hpy;
      oz = hpz;
      dx = odx;
      dy = ody;
      dz = odz;
      sd = sd_new;
    }
    // depth cap or absorption: rr, rg, rb are still 0 (black)
    acc_r = acc_r + rr;
    acc_g = acc_g + rg;
    acc_b = acc_b + rb;
    if (!p.parallel) chain = sd;
  }

  float lin[3] = {acc_r * p.inv_spp, acc_g * p.inv_spp, acc_b * p.inv_spp};
  float* o = p.out + (static_cast<size_t>(y) * p.width + x) * 3;
  for (int k = 0; k < 3; ++k) {
    o[k] = lin[k] > 0.0f ? expf(logf(lin[k]) / p.gamma) : 0.0f;
  }
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
