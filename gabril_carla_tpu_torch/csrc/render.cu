// Camera render kernel for NVIDIA Hopper (sm_90a): one 180x320 grayscale
// frame per world from the operands ops/raster.py: _pallas_inputs builds.
//
// Replaces the TPU kernel gabril_carla_tpu/ops/pallas_raster.py:
// _render_kernel (launched by render_frame_pallas through pl.pallas_call)
// and computes its function pixel for pixel, row sets included. It keeps
// none of its TPU layout: no bottom-row-first [512, 128] lane tiles, no
// block_rows, no SMEM BlockSpecs.
//
// Per pixel: (1) the ground-plane hit of the pixel's ray, camera-relative;
// (2) a streaming argmin of t = gx*c1 + gy*c2 + c3 over the pixel's set of
// distance-sorted route and flow rows, strict '<' in ascending row order so
// the first minimum wins; (3) the signed lateral distance to the winning
// row, solved after the loop; (4) terrain shading: road or grass, dashed
// centre line with a 4 m period, solid edges, wet asphalt, fog and haze;
// (5) the sky gradient; (6) the min-depth box composite with depth shade
// and actor fog; (7) rain contrast, sun brightness, clamp to [0, 1].
//
// Row sets, as the TPU kernel assigns them (pallas_raster.py:179-229). A
// ground pixel's depth class comes from its bottom-first flat index
// flat = (179 - v) * 320 + u: class 0 below 8192, 1 below 16384, 2 below
// 24576, else 3 (the TPU's 4096-pixel tiles 0-1, 2-3, 4-5, 6+). Each class
// runs a prefix of the distance-sorted rows when the row count in camera
// slot 11-14 fits it, and every row otherwise: prefixes (56, 72, 120, 128),
// or (56, 72, 88, 96) with far_decimate. With lower_window, classes 2 and 3
// run rows [0, 4) then [12, n) or [44, n) when the lower count in slot 16
// or 17 reaches 12 or 44. Sky pixels skip the loop.
//
// Boxes: only the first cam[15] (the visible count) are composited; the
// valid boxes lead the compacted list, so that is exact. Each block bins
// them once against its own pixel rectangle: one warp tests a box per lane
// and the overlapping ones go to a list in shared memory in their original
// order (ballot, then popcount of the lower lanes), so ties on equal depth
// resolve as the full loop does. Pixels walk only that list.
//
// What bounds it on this card: the argmin's issue slots. A ground pixel
// visits 56-128 rows (about 2.4 M pixel-rows a frame), each two FMAs, a
// compare and two selects, all f32 outside the tensor cores; the 230 KB
// frame write per world is small beside it. Tensor cores do not fit: the
// product is depth 3, and the argmin needs f32 contrasts of ~1 m^2 against
// |q|^2 up to 1e4 m^2, which TF32 loses. TMA does not either: the
// operands are 6 KB per world.
// What the design does about it: each thread carries P = 4 pixels,
// neighbours along u in one image row, so one broadcast shared-memory load
// of a row feeds 4 pairs of FMAs; the loop carries only (best t, best row)
// per pixel, and the row's direction, offset and index are read back once
// after it. A block is a 64 x 8 pixel tile (16 x 8 threads: 115 blocks a
// world; the fastest of ten shapes timed on an H100, PERF.md). A block makes
// one round trip to memory: camera slots, boxes and, in the 55 tiles that
// show ground, the world's rows, all loaded at once; sky tiles load no
// rows. The class boundaries fall at u = 192, 64 and 256 of rows v = 154,
// 128 and 103, so a thread's pixels never straddle one; a warp that does
// diverges on that image row only.
//
// Arithmetic follows the port's plain version (ops/render_kernel.py:
// render_from_operands_plain) operation by operation. nvcc contracts
// a*b + c into FMAs, which moves t by a few ulps and can flip near-tie
// pixels at dash and edge boundaries; build without --use_fast_math.

#include <cuda_runtime.h>

namespace {

constexpr int H = 180;
constexpr int W = 320;
constexpr int N_PIX = H * W;
constexpr int N_CAM = 18;      // cam_scalars slots
constexpr int MAX_ROWS = 160;  // ROUTE_VIEW + FLOW_VIEW
constexpr int MAX_BOXES = 32;  // K_BOX
constexpr int P = 4;           // pixels per thread, along u
constexpr int TX = 16;         // threads along u
constexpr int TY = 8;          // image rows per block
constexpr int THREADS = TX * TY;
constexpr int TILE_U = TX * P;
constexpr int TILES_U = (W + TILE_U - 1) / TILE_U;
constexpr int TILES_V = (H + TY - 1) / TY;
static_assert(64 % P == 0, "a thread's pixels must not straddle a class boundary");
static_assert(P == 4, "a thread stores its pixels as one float4");
static_assert(THREADS % 32 == 0, "whole warps");
static_assert(MAX_BOXES <= 32, "one warp bins the boxes, one lane each");

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

// jnp.mod(x, 4): a floor mod. x * 0.25 and the product 4 * floor are
// exact, and so is the difference (below 4, a multiple of x's ulp), so this
// equals the fmod-based remainder for every finite x without fmodf's loop.
__device__ __forceinline__ float floor_mod4(float x) {
  return x - 4.0f * floorf(x * 0.25f);
}

// Ground-plane depth of image row v, and whether the row shows ground.
__device__ __forceinline__ float ground_depth(float v) {
  return clampf(CZ_FX / fmaxf(v - CY, 1e-3f), 0.0f, MAX_DEPTH);
}

__device__ __forceinline__ bool shows_ground(float v, float z) {
  return (v - CY > 0.5f) && (z < MAX_DEPTH);
}

// The rows a ground pixel visits: [0, e1), then [s2, e2).
struct RowSet {
  int e1, s2, e2;
};

// pallas_raster.py:188-229: the count gate of the pixel's class picks its
// static prefix (or lower window); a count that overflows it falls back to
// every row.
__device__ __forceinline__ RowSet row_set(int cls, const float* cam, int n_rows,
                                          bool far_decimate, bool lower_window) {
  const int n2 = far_decimate ? 88 : 120;
  const int cap3 = far_decimate ? 96 : 128;
  RowSet s{n_rows, 0, 0};
  if (cls == 0) {
    if (cam[11] <= 56.0f) s.e1 = min(56, n_rows);
  } else if (cls == 1) {
    if (cam[12] <= 72.0f) s.e1 = min(72, n_rows);
  } else if (cls == 2) {
    if (cam[13] <= (float)n2) {
      if (lower_window && cam[16] >= 12.0f) s = {min(4, n_rows), min(12, n_rows), min(n2, n_rows)};
      else s.e1 = min(n2, n_rows);
    }
  } else {
    if (cam[14] <= (float)cap3 + 0.5f) {
      if (lower_window && cam[17] >= 44.0f) s = {min(4, n_rows), min(44, n_rows), min(cap3, n_rows)};
      else s.e1 = min(cap3, n_rows);
    }
  }
  return s;
}

// argmin over rows [k0, k1) for the thread's P pixels; row k = (c1 c2 c3 dx)
// at s_rows[2k]
__device__ __forceinline__ void scan_rows(const float4* s_rows, int k0, int k1,
                                          const float (&gx)[P], const float (&gy)[P],
                                          float (&best_t)[P], int (&best)[P]) {
#pragma unroll 4
  for (int k = k0; k < k1; ++k) {
    const float4 r = s_rows[2 * k];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float t = gx[p] * r.x + gy[p] * r.y + r.z;
      if (t < best_t[p]) {
        best_t[p] = t;
        best[p] = k;
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
render_kernel(const float* __restrict__ cam, const float* __restrict__ rows,
              const float* __restrict__ boxes, float* __restrict__ out,
              int n_rows, int n_boxes, float view_route, bool far_decimate,
              bool lower_window) {
  // row k = (c1 c2 c3 dx) (dy e3 j hi); box a = (u0 u1 v0 v1) (depth color ok pad)
  __shared__ float4 s_rows[2 * MAX_ROWS];
  __shared__ float4 s_box[2 * MAX_BOXES];
  __shared__ float s_cam[N_CAM];
  __shared__ int s_nbox;

  const int world = blockIdx.y;
  const int tile_u = blockIdx.x % TILES_U;
  const int tile_v = blockIdx.x / TILES_U;  // counted from the bottom of the frame
  const int u0 = tile_u * TILE_U + (threadIdx.x % TX) * P;  // first of the thread's pixels
  const int r = tile_v * TY + threadIdx.x / TX;             // image row from the bottom
  const int vi = H - 1 - r;
  const bool live = vi >= 0 && u0 < W;  // W % P == 0: all P pixels then lie in the frame

  // one round trip to memory: the camera slots, the boxes (warp 0, one a
  // lane) and, in tiles that show ground, every row, all issued together
  if (threadIdx.x < N_CAM) s_cam[threadIdx.x] = cam[(size_t)world * N_CAM + threadIdx.x];
  const float v_bottom = (float)(H - 1 - tile_v * TY);  // ground rows are the frame's lowest
  if (shows_ground(v_bottom, ground_depth(v_bottom))) {
    const float4* rows_w = reinterpret_cast<const float4*>(rows) + (size_t)world * n_rows * 2;
    for (int i = threadIdx.x; i < 2 * n_rows; i += THREADS) s_rows[i] = rows_w[i];
  }
  const int a = threadIdx.x;
  float4 b0 = {}, b1 = {};
  if (a < n_boxes) {
    const float4* box_w = reinterpret_cast<const float4*>(boxes) + (size_t)world * n_boxes * 2;
    b0 = box_w[2 * a];
    b1 = box_w[2 * a + 1];
  }
  __syncthreads();

  // bin the visible boxes against the block's pixel rectangle, in order
  if (a < 32) {
    const float u_lo = (float)(tile_u * TILE_U), u_hi = (float)(min(W, (tile_u + 1) * TILE_U) - 1);
    const float v_lo = (float)max(0, H - (tile_v + 1) * TY);
    const bool hit = a < n_boxes && (float)a < s_cam[15] && b0.x <= u_hi && b0.y >= u_lo &&
                     b0.z <= v_bottom && b0.w >= v_lo && b1.z > 0.5f;
    const unsigned mask = __ballot_sync(0xffffffffu, hit);
    if (hit) {
      const int at = __popc(mask & ((1u << a) - 1u));
      s_box[2 * at] = b0;
      s_box[2 * at + 1] = b1;
    }
    if (a == 0) s_nbox = __popc(mask);
  }
  __syncthreads();
  if (!live) return;

  const float fwd_x = s_cam[0], fwd_y = s_cam[1];
  const float rgt_x = s_cam[2], rgt_y = s_cam[3];
  const float cloud = s_cam[4], start_s = s_cam[5];
  const float precip = s_cam[6], fog = s_cam[7], bright = s_cam[8], wet = s_cam[9];
  const float vis = MAX_DEPTH * (1.0f - 0.85f * fog);
  const float sky_col = SKY - 0.15f * cloud;
  const float v = (float)vi;
  const float z = ground_depth(v);

  float img[P];
  if (shows_ground(v, z)) {
    const int flat = r * W + u0;
    const int cls = (flat >= 8192) + (flat >= 16384) + (flat >= 24576);
    const RowSet set = row_set(cls, s_cam, n_rows, far_decimate, lower_window);
    // camera-relative ground hits: world-absolute coordinates (~1e3 m)
    // would cancel the ~m^2 contrasts of t out of f32
    float gx[P], gy[P], best_t[P];
    int best[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float x = ((float)(u0 + p) - CX) / FX * z;
      gx[p] = z * fwd_x + x * rgt_x;
      gy[p] = z * fwd_y + x * rgt_y;
      best_t[p] = 1e30f;
      best[p] = -1;
    }
    scan_rows(s_rows, 0, set.e1, gx, gy, best_t, best);
    scan_rows(s_rows, set.s2, set.e2, gx, gy, best_t, best);

    const float road_col = ROAD * (1.0f - 0.30f * wet);
    const float fade_coef = 0.25f + 0.75f * fog;
    const float fade = clampf(z / vis, 0.0f, 1.0f) * fade_coef;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      float bdx = 0.0f, bdy = 0.0f, be3 = 0.0f, bj = 0.0f;
      if (best[p] >= 0) {
        const float4 r0 = s_rows[2 * best[p]];
        const float4 r1 = s_rows[2 * best[p] + 1];
        bdx = r0.w;
        bdy = r1.x;
        be3 = r1.y;
        bj = r1.z;
      }
      // lateral solve after the loop: positive = the vehicle's left
      const float lat = bdy * gx[p] - bdx * gy[p] + be3;
      const float near_s = start_s + bj;
      // rows past view_route are scenario-flow points: road, no markings
      const bool is_route = bj < view_route;
      const float hi = is_route ? HI_ROUTE : HI_FLOW;
      const bool on_road = (lat > ROAD_LO) && (lat < hi);
      const bool dash = floor_mod4(near_s) < 2.0f;
      const bool centre = (fabsf(lat - 0.5f * LANE_W) < 0.12f) && dash && is_route;
      const bool edge = ((fabsf(lat + 0.5f * LANE_W) < 0.15f) ||
                         (fabsf(lat - 1.5f * LANE_W) < 0.15f)) && is_route;
      float terrain = on_road ? road_col : GRASS;
      if (centre || edge) terrain = MARK;
      img[p] = terrain * (1.0f - fade) + sky_col * fade;
    }
  } else {
    const float sky = sky_col + 0.12f * (v / (float)H);
#pragma unroll
    for (int p = 0; p < P; ++p) img[p] = sky;
  }

  // min-depth composite over the block's list: strict '<' keeps the first
  // of equal depths
  float best_d[P], best_c[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    best_d[p] = 1e30f;
    best_c[p] = 0.0f;
  }
  const int n_list = s_nbox;
  for (int i = 0; i < n_list; ++i) {
    const float4 b0 = s_box[2 * i];
    if (!(v >= b0.z && v <= b0.w)) continue;
    const float4 b1 = s_box[2 * i + 1];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float u = (float)(u0 + p);
      if (u >= b0.x && u <= b0.y && b1.x < best_d[p]) {
        best_d[p] = b1.x;
        best_c[p] = b1.y;
      }
    }
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    float px = img[p];
    if (best_d[p] < 1e29f) {
      const float shade = 1.0f - clampf(best_d[p] / MAX_DEPTH, 0.0f, 0.6f);
      const float afog = clampf(best_d[p] / vis, 0.0f, 1.0f) * (0.8f * fog);
      px = best_c[p] * shade * (1.0f - afog) + sky_col * afog;
    }
    // rain flattens contrast; sun altitude scales global illumination
    px = px * (1.0f - 0.2f * precip) + 0.5f * (0.2f * precip);
    img[p] = clampf(px * bright, 0.0f, 1.0f);
  }

  *reinterpret_cast<float4*>(out + (size_t)world * N_PIX + vi * W + u0) =
      make_float4(img[0], img[1], img[2], img[3]);
}

}  // namespace

// cam [B, 18], rows [B, n_rows, 8], boxes [B, n_boxes, 8] -> out [B, 180, 320],
// all f32, contiguous, 16-byte aligned, on the current device. far_decimate
// and lower_window (0 or 1) pick the TPU kernel's two variants. Launches on
// `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int render_frames(const float* cam, const float* rows, const float* boxes,
                             float* out, int n_worlds, int n_rows, int n_boxes,
                             int view_route, int far_decimate, int lower_window,
                             void* stream) {
  if (n_worlds < 1 || n_worlds > 65535 || n_rows < 1 || n_rows > MAX_ROWS ||
      n_boxes < 0 || n_boxes > MAX_BOXES)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(TILES_U * TILES_V, n_worlds);
  render_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      cam, rows, boxes, out, n_rows, n_boxes, (float)view_route, far_decimate != 0,
      lower_window != 0);
  return (int)cudaGetLastError();
}

extern "C" const char* render_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
