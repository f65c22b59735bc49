// Camera render kernel for NVIDIA Hopper (sm_90a): one 180x320 grayscale
// frame per world from the operands ops/raster.py: _pallas_inputs builds.
//
// Replaces the TPU kernel gabril_carla_tpu/ops/pallas_raster.py:
// _render_kernel (launched by render_frame_pallas through pl.pallas_call).
// It computes the same function and keeps none of its TPU layout: no
// bottom-row-first [512, 128] lane tiles, no block_rows, no SMEM BlockSpecs.
//
// Per pixel: (1) the ground-plane hit of the pixel's ray, camera-relative;
// (2) a streaming argmin of t = gx*c1 + gy*c2 + c3 over the distance-sorted
// route and flow rows, strict '<' so the first minimum wins; (3) the signed
// lateral distance to the winning row, solved after the loop; (4) terrain
// shading: road or grass, dashed centre line with a 4 m period, solid edges,
// wet asphalt, fog and haze; (5) the sky gradient; (6) the min-depth box
// composite with depth shade and actor fog; (7) rain contrast, sun
// brightness, clamp to [0, 1].
//
// What bounds it on this card: the argmin. Every ground pixel (about 27,800
// of the 57,600) visits every row (160), at two FMAs, a compare and two
// selects per row, all f32 outside the tensor cores; the 230 KB frame write
// per world is small beside it. So the bound is operations over the f32
// non-tensor rate, not bytes.
// What the design does about it: one thread per pixel, blocks of 256
// pixels, grid (pixel tiles, worlds). Each block first stages its world's
// operands (cam 72 B, rows 5 KB, boxes 1 KB) in shared memory, so every
// loop iteration is one broadcast shared load that all lanes of a warp
// share. The loop carries only (best t, best row); the row's direction,
// offset and index are read back once after the loop. Sky pixels skip the
// row loop, and blocks that hold only sky rows finish at once.
// Left for later work: depth-class row prefixes and box-count gating
// (pallas_raster.py NEAR_PREFIX and the n_vis conds), a bf16 store fused
// for the policy, wgmma/TMA.
//
// Arithmetic follows the Pallas kernel and the port's plain version
// (ops/render_kernel.py: render_from_operands_plain) operation by
// operation. nvcc contracts a*b + c into FMAs, which moves t by a few ulps
// and can flip near-tie pixels at dash and edge boundaries; build without
// --use_fast_math.

#include <cuda_runtime.h>

namespace {

constexpr int H = 180;
constexpr int W = 320;
constexpr int N_PIX = H * W;
constexpr int N_CAM = 18;   // cam_scalars slots
constexpr int MAX_ROWS = 160;  // ROUTE_VIEW + FLOW_VIEW
constexpr int MAX_BOXES = 32;  // K_BOX
constexpr int THREADS = 256;

// Python doubles rounded once to f32, as JAX folds its weak-typed constants.
constexpr float FX = (float)277.1281292110204;      // (W/2) / tan(30 deg)
constexpr float CZ_FX = (float)443.4050067376327;   // CAM_Z * FX
constexpr float CX = 159.5f;
constexpr float CY = 89.5f;
constexpr float MAX_DEPTH = 120.0f;
constexpr float SKY = 0.62f, GRASS = 0.42f, ROAD = 0.24f, MARK = 0.85f;
constexpr float LANE_W = 3.5f;
constexpr float ROAD_LO = (float)(-0.5 * 3.5 - 0.3);
constexpr float HI_ROUTE = (float)(1.5 * 3.5 + 0.3);
constexpr float HI_FLOW = (float)(0.5 * 3.5 + 0.3);

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// jnp.mod: the remainder takes the divisor's sign (a floor mod)
__device__ __forceinline__ float floor_mod(float x, float y) {
  float r = fmodf(x, y);
  if (r != 0.0f && ((r < 0.0f) != (y < 0.0f))) r += y;
  return r;
}

__global__ void __launch_bounds__(THREADS)
render_kernel(const float* __restrict__ cam, const float* __restrict__ rows,
              const float* __restrict__ boxes, float* __restrict__ out,
              int n_rows, int n_boxes, float view_route) {
  // row k = (c1 c2 c3 dx) (dy e3 j hi); box a = (u0 u1 v0 v1) (depth color ok pad)
  __shared__ float4 s_rows[2 * MAX_ROWS];
  __shared__ float4 s_box[2 * MAX_BOXES];
  __shared__ float s_cam[N_CAM];

  const int world = blockIdx.y;
  const float4* rows_w = reinterpret_cast<const float4*>(rows) + (size_t)world * n_rows * 2;
  const float4* box_w = reinterpret_cast<const float4*>(boxes) + (size_t)world * n_boxes * 2;
  for (int i = threadIdx.x; i < 2 * n_rows; i += THREADS) s_rows[i] = rows_w[i];
  for (int i = threadIdx.x; i < 2 * n_boxes; i += THREADS) s_box[i] = box_w[i];
  if (threadIdx.x < N_CAM) s_cam[threadIdx.x] = cam[(size_t)world * N_CAM + threadIdx.x];
  __syncthreads();

  const int p = blockIdx.x * THREADS + threadIdx.x;
  if (p >= N_PIX) return;
  const float v = (float)(p / W);
  const float u = (float)(p % W);

  const float fwd_x = s_cam[0], fwd_y = s_cam[1];
  const float rgt_x = s_cam[2], rgt_y = s_cam[3];
  const float cloud = s_cam[4], start_s = s_cam[5];
  const float precip = s_cam[6], fog = s_cam[7], bright = s_cam[8], wet = s_cam[9];

  const float dv = fmaxf(v - CY, 1e-3f);
  const float z = clampf(CZ_FX / dv, 0.0f, MAX_DEPTH);
  const bool on_ground = (v - CY > 0.5f) && (z < MAX_DEPTH);
  const float vis = MAX_DEPTH * (1.0f - 0.85f * fog);
  const float sky_col = SKY - 0.15f * cloud;

  float img;
  if (on_ground) {
    // camera-relative ground hit: world-absolute coordinates (~1e3 m) would
    // cancel the ~m^2 contrasts of t out of f32
    const float x = (u - CX) / FX * z;
    const float gx = z * fwd_x + x * rgt_x;
    const float gy = z * fwd_y + x * rgt_y;
    float best_t = 1e30f;
    int best = -1;
#pragma unroll 8
    for (int k = 0; k < n_rows; ++k) {
      const float4 r = s_rows[2 * k];
      const float t = gx * r.x + gy * r.y + r.z;
      if (t < best_t) {
        best_t = t;
        best = k;
      }
    }
    float bdx = 0.0f, bdy = 0.0f, be3 = 0.0f, bj = 0.0f;
    if (best >= 0) {
      const float4 r0 = s_rows[2 * best];
      const float4 r1 = s_rows[2 * best + 1];
      bdx = r0.w;
      bdy = r1.x;
      be3 = r1.y;
      bj = r1.z;
    }
    // lateral solve after the loop: positive = the vehicle's left
    const float lat = bdy * gx - bdx * gy + be3;
    const float near_s = start_s + bj;
    // rows past view_route are scenario-flow points: road, no markings
    const bool is_route = bj < view_route;
    const float hi = is_route ? HI_ROUTE : HI_FLOW;
    const bool on_road = (lat > ROAD_LO) && (lat < hi);
    const bool dash = floor_mod(near_s, 4.0f) < 2.0f;
    const bool centre = (fabsf(lat - 0.5f * LANE_W) < 0.12f) && dash && is_route;
    const bool edge = ((fabsf(lat + 0.5f * LANE_W) < 0.15f) ||
                       (fabsf(lat - 1.5f * LANE_W) < 0.15f)) && is_route;
    const float road_col = ROAD * (1.0f - 0.30f * wet);
    float terrain = on_road ? road_col : GRASS;
    if (centre || edge) terrain = MARK;
    const float fade_coef = 0.25f + 0.75f * fog;
    const float fade = clampf(z / vis, 0.0f, 1.0f) * fade_coef;
    img = terrain * (1.0f - fade) + sky_col * fade;
  } else {
    img = sky_col + 0.12f * (v / (float)H);
  }

  // min-depth composite: strict '<' keeps the first of equal depths
  float best_d = 1e30f, best_c = 0.0f;
  for (int a = 0; a < n_boxes; ++a) {
    const float4 b0 = s_box[2 * a];
    const float4 b1 = s_box[2 * a + 1];
    const bool inside = (u >= b0.x) && (u <= b0.y) && (v >= b0.z) && (v <= b0.w) &&
                        (b1.z > 0.5f) && (b1.x < best_d);
    if (inside) {
      best_d = b1.x;
      best_c = b1.y;
    }
  }
  if (best_d < 1e29f) {
    const float shade = 1.0f - clampf(best_d / MAX_DEPTH, 0.0f, 0.6f);
    const float afog = clampf(best_d / vis, 0.0f, 1.0f) * (0.8f * fog);
    img = best_c * shade * (1.0f - afog) + sky_col * afog;
  }
  // rain flattens contrast; sun altitude scales global illumination
  img = img * (1.0f - 0.2f * precip) + 0.5f * (0.2f * precip);
  img = img * bright;
  out[(size_t)world * N_PIX + p] = clampf(img, 0.0f, 1.0f);
}

}  // namespace

// cam [B, 18], rows [B, n_rows, 8], boxes [B, n_boxes, 8] -> out [B, 180, 320],
// all f32, contiguous, 16-byte aligned, on the current device. Launches on
// `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int render_frames(const float* cam, const float* rows, const float* boxes,
                             float* out, int n_worlds, int n_rows, int n_boxes,
                             int view_route, void* stream) {
  if (n_worlds < 1 || n_worlds > 65535 || n_rows < 1 || n_rows > MAX_ROWS ||
      n_boxes < 0 || n_boxes > MAX_BOXES)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N_PIX + THREADS - 1) / THREADS, n_worlds);
  render_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      cam, rows, boxes, out, n_rows, n_boxes, (float)view_route);
  return (int)cudaGetLastError();
}

extern "C" const char* render_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
