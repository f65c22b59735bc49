// The frozen gaze UNet's forward at eval (models/unet.py, bf16 convs and
// float32 GroupNorm) as a chain of kernels for NVIDIA Hopper (sm_90a) that
// keep activations NHWC in bf16 and fold each GroupNorm into the convs on
// either side of it.
//
// Replaces no TPU kernel: the JAX package's UNet (gabril_carla_tpu/models/
// unet.py) left its convolutions and norms to XLA. It was added because
// the module's cuDNN forward moves about 20 bytes for each byte a fused
// forward needs: every 3x3 conv casts its float32 input to bf16, cuDNN
// transposes it to NHWC and back, and GroupNorm and relu read and write its
// output in float32 three more times.
//
// What bounds it on this card: bytes. The 23 products are 773 MFLOP a
// 180x320 sample against about 17.8 MB read and written once each (43 FLOP
// a byte, far below the H100's 295), so each kernel reads its inputs once
// and writes bf16 once:
//
// 1. conv3x3 (templated on the tile, its sources and its pipeline). A
//    persistent block loads the weights once, then walks its tiles: cp.async
//    copies the next tile's input with its one-pixel halo (and the sample's
//    scale and shift) into shared memory while the block computes the
//    current one. A transform pass applies the producer's GroupNorm as
//    per-(sample, channel) scale and shift, then relu, then rounds to bf16,
//    as the module's next conv casts its float32 input. kPool takes the 2x2
//    max pool (floored) there; kRing casts the float32 frame ring and
//    zero-pads its channels to 8; a decoder block concatenates the
//    transposed conv's bf16 output (no norm) and the encoder's stored
//    pre-norm skip (its norm and relu). The 9 taps run as mma.sync bf16
//    products with float32 sums (m16n8k8 at 8 input channels, k16 above), A
//    and B by ldmatrix from rows swizzled across the banks. The epilogue
//    adds the bf16-rounded bias and stages the tile in shared memory; one
//    pass stores it (bf16 NHWC, the pre-norm output that goes to memory)
//    and sums its channels, a second sums the squares about each group's
//    mean, each reduced across the block in a fixed order into the tile's
//    per-group (count, mean, M2) in a scratch buffer: no atomics, so
//    results are bitwise repeatable. What limits it on the card is the
//    shared memory's and the issue slots' work a tile (the taps' ldmatrix
//    reads are 9 times the tile), not the copies (PERF.md).
// 2. gn_finalize merges each sample's tile partials in tile order (Chan's
//    formula) into per-(sample, channel) scale = gamma * rstd and
//    shift = beta - mean * scale.
// 3. conv_t (2x2, stride 2): the same on-load norm and relu, one product of
//    K = C_in by N = 4 C_out per input pixel, scattered to its 2x2 outputs
//    through shared memory; with an output padding row, that row is the
//    bias alone, as F.conv_transpose2d gives it.
// 4. out1x1: d1's norm and relu on load, bf16 inputs and weights, float32
//    sum, bf16 [B, H, W, C_out].
//
// Every entry launches on the caller's stream and returns
// cudaGetLastError() as an int (0: launched); -1 means no kernel was built
// for the layer's shape.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kGroups = 8;  // GroupNorm(min(8, C)): every norm of the UNet has C >= 8
constexpr int kNoShape = -1;

enum : int { kRing = 0, kNorm = 1, kPool = 2, kRaw = 3 };

// The 16-byte unit c of a row of NCH units (a pixel's channels, a weight
// row's inputs), XOR-swizzled so that the 8 consecutive rows an ldmatrix
// phase reads fall on distinct banks.
template <int NCH>
__device__ __forceinline__ int swz(int row, int c) {
  static_assert(NCH == 1 || NCH == 2 || NCH == 4 || NCH == 8, "1 to 8 units a row");
  constexpr int sh = NCH == 2 ? 2 : NCH == 4 ? 1 : 0;
  return NCH == 1 ? c : c ^ ((row >> sh) & (NCH - 1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x1(uint32_t addr, uint32_t& r0) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x1.shared.b16 {%0}, [%1];\n" : "=r"(r0) : "r"(addr));
}

// d += a (16 x 16, rows) * b (16 x 8, columns), bf16 in, float32 sums
__device__ __forceinline__ void mma_k16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16 x 8) * b (8 x 8)
__device__ __forceinline__ void mma_k8(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]), pack2(f[6], f[7]));
}

__device__ __forceinline__ void unpack8(const uint4 u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

// relu(x * scale + shift) of 8 bf16 channels, in float32
__device__ __forceinline__ void norm_relu8(const uint4 u, const float2* ss, float (&f)[8]) {
  unpack8(u, f);
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = fmaxf(fmaf(f[i], ss[i].x, ss[i].y), 0.0f);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// ---- 1. conv3x3 ---------------------------------------------------------------

struct ConvArgs {
  const void* a;         // source A: the float32 ring [B, H, W, ring] (kRing), or bf16
                         // [B, H, W, CA] (kNorm, kRaw) or [B, src_h, src_w, CA] (kPool)
  const float2* ss_a;    // [B, CA] (scale, shift) of source A's norm (kNorm, kPool)
  const uint16_t* b;     // source B, the skip: bf16 [B, H, W, CB], normed on load
  const float2* ss_b;    // [B, CB]
  const float* weight;   // [CO, cin, 3, 3] float32
  const float* bias;     // [CO] float32
  uint16_t* out;         // [B, H, W, CO] bf16, before the norm
  float* part;           // [B, tiles, 8, 3]: each tile's (count, mean, M2) by group
  int batch, h, w;       // output (and source B) size
  int src_h, src_w;      // source A's size (kPool: at least 2h x 2w)
  int cin;               // the weight's input channels (kRing: the ring's channels)
  int tiles_y, tiles_x;
};

// CA: source A's channels in shared memory (the ring's, at most 8, padded to 8), CB:
// source B's (0: none), CO: outputs, MODE: source A's load, TH x TW: the
// output tile, UNROLL: the taps unrolled together, MINB: the blocks an SM
// must hold (a register cap for the compiler).
template <int CA_, int CB_, int CO_, int MODE_, int TH_, int TW_, int UNROLL_, int MINB_>
struct Conv {
  static constexpr int CA = CA_, CB = CB_, CO = CO_, MODE = MODE_, TH = TH_, TW = TW_;
  static constexpr int UNROLL = UNROLL_, MINB = MINB_;
  static constexpr int CIN = CA + CB;
  static constexpr int NCH = CIN / 8, NCA = CA / 8, NCO = CO / 8, NT = CO / 8;
  static constexpr int IH = TH + 2, IW = TW + 2;
  static constexpr int PIX = TH * TW;
  static constexpr int MTILES = (PIX + 15) / 16;
  static constexpr int MT = (MTILES + kWarps - 1) / kWarps;
  static constexpr int IN_UNITS = IH * IW * NCH;
  static constexpr int OUT_UNITS = PIX * NCO;
  static constexpr int ACT_UNITS = IN_UNITS > OUT_UNITS ? IN_UNITS : OUT_UNITS;
  static constexpr int W_UNITS = 9 * CO * NCH;
  static constexpr int P = MODE == kPool ? 4 : 1;  // raw units a unit of the tile (kPool: its 2x2 window)
  static constexpr int RAW_UNITS = P * IN_UNITS;
  // the tile's copies as they arrive: 16-byte units, or the ring's floats
  static constexpr int RAW_BYTES = MODE == kRing ? IH * IW * CA * 4 : RAW_UNITS * 16;
  static constexpr int SMEM =
      (ACT_UNITS + W_UNITS) * 16 + RAW_BYTES + CIN * 8 + (CO + kWarps * CO + kGroups) * 4;
  static_assert(CA % 8 == 0 && CB % 8 == 0 && CO % 8 == 0 && CO <= 32, "channel counts");
  static_assert(MODE != kRaw || CB > 0, "a raw source is the decoder's upsampled half");
  static_assert(kThreads % NCH == 0, "a thread's units share their channels");
};

// Asynchronous copies to shared memory; ``bytes`` 0 fills zeros and reads
// nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// Starts the copies of a tile's input with its halo into ``raw``: per unit
// of the tile (pixel pix of the (TH + 2) x (TW + 2) window, channels
// [8c, 8c + 8)) the skip's or source A's 16 bytes, or source A's 2x2 window
// (kPool, raw unit (k * IH * IW + pix) * NCH + c), or the ring's floats
// (kRing, float pix * cin + ch); and the sample's (scale, shift) pairs of
// the normed channels into ``ss``. Outside the image nothing is read.
template <class K>
__device__ __forceinline__ void issue_tile(const ConvArgs& p, uint32_t raw_s, uint32_t ss_s, int bb,
                                           int ty0, int tx0) {
  const int tid = threadIdx.x;
  if ((K::MODE == kNorm || K::MODE == kPool) && tid < K::CA / 2)
    cp_async16(ss_s + tid * 16, p.ss_a + (size_t)bb * K::CA + 2 * tid, 16);
  if (K::CB > 0 && tid >= K::CA / 2 && tid < K::CIN / 2)
    cp_async16(ss_s + tid * 16, p.ss_b + (size_t)bb * K::CB + 2 * tid - K::CA, 16);
  if constexpr (K::MODE == kRing) {
    const float* ring = static_cast<const float*>(p.a);
    for (int pix = tid; pix < K::IH * K::IW; pix += kThreads) {
      const int y = ty0 - 1 + pix / K::IW, x = tx0 - 1 + pix % K::IW;
      const bool in = y >= 0 && y < p.h && x >= 0 && x < p.w;
      const float* src = in ? ring + (((size_t)bb * p.h + y) * p.w + x) * p.cin : ring;
      const uint32_t dst = raw_s + pix * p.cin * 4;
      if (p.cin % 2 == 0) {
        for (int ch = 0; ch < p.cin; ch += 2) cp_async8(dst + ch * 4, src + (in ? ch : 0), in ? 8 : 0);
      } else {
        for (int ch = 0; ch < p.cin; ++ch) cp_async4(dst + ch * 4, src + (in ? ch : 0), in ? 4 : 0);
      }
    }
  } else {
    for (int i = threadIdx.x; i < K::RAW_UNITS; i += kThreads) {
      const int c = i % K::NCH, rest = i / K::NCH, pix = rest % (K::IH * K::IW), k = rest / (K::IH * K::IW);
      const int y = ty0 - 1 + pix / K::IW, x = tx0 - 1 + pix % K::IW;
      const bool in = y >= 0 && y < p.h && x >= 0 && x < p.w;
      const uint16_t* src = p.b;
      if (!in) {
        src = p.out;
      } else if (c >= K::NCA) {
        src = p.b + (((size_t)bb * p.h + y) * p.w + x) * K::CB + (c - K::NCA) * 8;
      } else if (K::MODE == kPool) {
        src = static_cast<const uint16_t*>(p.a) +
              (((size_t)bb * p.src_h + 2 * y + (k >> 1)) * p.src_w + 2 * x + (k & 1)) * K::CA + c * 8;
      } else {
        src = static_cast<const uint16_t*>(p.a) + (((size_t)bb * p.h + y) * p.w + x) * K::CA + c * 8;
      }
      cp_async16(raw_s + i * 16, src, in ? 16 : 0);
    }
  }
}

// A thread's 8 channel sums a[j] (of its units' channels [8 cu, 8 cu + 8),
// cu = tid % NCO) summed over the warp's lanes of equal cu, into
// red[warp][8 cu + j].
template <class K>
__device__ __forceinline__ void reduce_channels(float (&a)[8], float* red, int lane, int warp) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int o = K::NCO; o < 32; o <<= 1) a[j] += __shfl_xor_sync(0xFFFFFFFFu, a[j], o);
  if (lane < K::NCO)
#pragma unroll
    for (int j = 0; j < 8; ++j) red[warp * K::CO + lane * 8 + j] = a[j];
}

template <class K>
__global__ void __launch_bounds__(kThreads, K::MINB) conv3x3_kernel(const ConvArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* act = reinterpret_cast<uint4*>(smem);  // the input tile, then the output's staging
  uint4* wsm = act + K::ACT_UNITS;              // [tap][co] rows of NCH units
  uint4* raw = wsm + K::W_UNITS;                // the next tile's copies
  float2* ssm = reinterpret_cast<float2*>(reinterpret_cast<unsigned char*>(raw) + K::RAW_BYTES);
  float* bias = reinterpret_cast<float*>(ssm + K::CIN);
  float* red = bias + K::CO;       // [warp][channel] partial sums of the statistics
  float* gmean = red + kWarps * K::CO;  // [group]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < K::W_UNITS; i += kThreads) {
    const int c = i % K::NCH, row = i / K::NCH, tap = row / K::CO, co = row % K::CO;
    float f[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int ci = c * 8 + j;
      f[j] = ci < p.cin ? p.weight[(co * p.cin + ci) * 9 + tap] : 0.0f;
    }
    wsm[row * K::NCH + swz<K::NCH>(row, c)] = pack8(f);
  }
  for (int i = tid; i < K::CO; i += kThreads) bias[i] = round_bf16(p.bias[i]);

  const uint32_t act_s = smem_addr(act), w_s = smem_addr(wsm), raw_s = smem_addr(raw), ss_s = smem_addr(ssm);
  const int per_sample = p.tiles_y * p.tiles_x;
  const int n_tiles = p.batch * per_sample;
  // the lane's A rows: pixel m * 16 + (lane & 15) of the tile, as the input
  // tile's pixel under tap (0, 0)
  int base[K::MT];
#pragma unroll
  for (int j = 0; j < K::MT; ++j) {
    int q = (warp + j * kWarps) * 16 + (lane & 15);
    q = q < K::PIX ? q : K::PIX - 1;
    base[j] = (q / K::TW) * K::IW + q % K::TW;
  }
  // the thread's units of the input tile all have channels [8c, 8c + 8)
  const int c = tid % K::NCH;
  const bool normed = c >= K::NCA || K::MODE == kNorm || K::MODE == kPool;

  // One tile's copies are in flight while the block computes the last one
  // (a second tile in flight was timed and gained nothing: PERF.md).
  auto issue = [&](int tile) {
    if (tile < n_tiles) {
      const int t = tile % per_sample;
      issue_tile<K>(p, raw_s, ss_s, tile / per_sample, (t / p.tiles_x) * K::TH, (t % p.tiles_x) * K::TW);
    }
    cp_async_commit();
  };
  issue(blockIdx.x);

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int bb = tile / per_sample, t = tile % per_sample;
    const int ty0 = (t / p.tiles_x) * K::TH, tx0 = (t % p.tiles_x) * K::TW;
    const int vh = min(K::TH, p.h - ty0), vw = min(K::TW, p.w - tx0);
    cp_async_wait_all();
    __syncthreads();  // this tile's copies are in; the last tile's staging is read
    float2 s8[8];
    if (normed) {
#pragma unroll
      for (int j = 0; j < 8; ++j) s8[j] = ssm[c * 8 + j];
    }

    // the input tile: norm, relu, pool or the ring's cast on its copies;
    // outside the image the conv's zero padding
    for (int i = tid; i < K::IN_UNITS; i += kThreads) {
      const int pix = i / K::NCH;
      const int y = ty0 - 1 + pix / K::IW, x = tx0 - 1 + pix % K::IW;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (y >= 0 && y < p.h && x >= 0 && x < p.w) {
        float f[8];
        if constexpr (K::MODE == kRing) {
          const float* r = reinterpret_cast<const float*>(raw) + pix * p.cin;
#pragma unroll
          for (int j = 0; j < 8; ++j) f[j] = c * 8 + j < p.cin ? r[c * 8 + j] : 0.0f;
          v = pack8(f);
        } else if (!normed) {
          v = raw[i];
        } else {
          norm_relu8(raw[i], s8, f);
#pragma unroll
          for (int k = 1; k < K::P; ++k) {
            float g[8];
            norm_relu8(raw[k * K::IN_UNITS + i], s8, g);
#pragma unroll
            for (int j = 0; j < 8; ++j) f[j] = fmaxf(f[j], g[j]);
          }
          v = pack8(f);
        }
      }
      act[pix * K::NCH + swz<K::NCH>(pix, c)] = v;
    }
    __syncthreads();  // the tile is in place; its copies' buffer takes the next tile's
    issue(tile + gridDim.x);

    float acc[K::MT][K::NT][4];
#pragma unroll
    for (int j = 0; j < K::MT; ++j)
#pragma unroll
      for (int n = 0; n < K::NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][n][e] = 0.0f;

#pragma unroll K::UNROLL
    for (int tap = 0; tap < 9; ++tap) {
      const int off = (tap / 3) * K::IW + tap % 3;
      if constexpr (K::NCH == 1) {
        uint32_t bw[K::NT];
#pragma unroll
        for (int n = 0; n < K::NT; ++n) {
          const int row = tap * K::CO + n * 8 + (lane & 7);
          ldsm_x1(w_s + row * 16, bw[n]);
        }
#pragma unroll
        for (int j = 0; j < K::MT; ++j) {
          if (warp + j * kWarps < K::MTILES) {
            uint32_t a0, a1;
            ldsm_x2(act_s + (base[j] + off) * 16, a0, a1);
#pragma unroll
            for (int n = 0; n < K::NT; ++n) mma_k8(acc[j][n], a0, a1, bw[n]);
          }
        }
      } else {
#pragma unroll
        for (int kc = 0; kc < K::NCH / 2; ++kc) {
          uint32_t bw[K::NT][2];
#pragma unroll
          for (int n = 0; n < K::NT; ++n) {
            const int row = tap * K::CO + n * 8 + (lane & 7);
            const int c = kc * 2 + ((lane >> 3) & 1);
            ldsm_x2(w_s + (row * K::NCH + swz<K::NCH>(row, c)) * 16, bw[n][0], bw[n][1]);
          }
#pragma unroll
          for (int j = 0; j < K::MT; ++j) {
            if (warp + j * kWarps < K::MTILES) {
              const int pix = base[j] + off, c = kc * 2 + (lane >> 4);
              uint32_t a[4];
              ldsm_x4(act_s + (pix * K::NCH + swz<K::NCH>(pix, c)) * 16, a);
#pragma unroll
              for (int n = 0; n < K::NT; ++n) mma_k16(acc[j][n], a, bw[n][0], bw[n][1]);
            }
          }
        }
      }
    }
    __syncthreads();  // every warp has read the input tile: it becomes the staging

    const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int j = 0; j < K::MT; ++j) {
      const int m = warp + j * kWarps;
      if (m >= K::MTILES) continue;
#pragma unroll
      for (int n = 0; n < K::NT; ++n) {
        const int co = n * 8 + t4 * 2;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int q = m * 16 + g + half * 8;
          if (q < K::PIX)
            reinterpret_cast<uint32_t*>(act + q * K::NCO + swz<K::NCO>(q, n))[t4] =
                pack2(acc[j][n][2 * half] + bias[co], acc[j][n][2 * half + 1] + bias[co + 1]);
        }
      }
    }
    __syncthreads();

    // the store, and the tile's statistics of the stored values in two
    // passes: each thread sums the channels of its units, the block reduces
    // the sums in a fixed order, then the same for the squares about each
    // group's mean
    constexpr int CPG = K::CO / kGroups;
    const int cu = tid % K::NCO;  // the thread's units all hold channels [8 cu, 8 cu + 8)
    float a[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) a[j] = 0.0f;
    for (int i = tid; i < K::OUT_UNITS; i += kThreads) {
      const int q = i / K::NCO, oy = q / K::TW, ox = q % K::TW;
      if (oy < vh && ox < vw) {
        const uint4 u = act[q * K::NCO + swz<K::NCO>(q, cu)];
        *reinterpret_cast<uint4*>(p.out + (((size_t)bb * p.h + ty0 + oy) * p.w + tx0 + ox) * K::CO +
                                  cu * 8) = u;
        float f[8];
        unpack8(u, f);
#pragma unroll
        for (int j = 0; j < 8; ++j) a[j] += f[j];
      }
    }
    reduce_channels<K>(a, red, lane, warp);
    __syncthreads();
    const float n = (float)(vh * vw * CPG);
    if (tid < kGroups) {
      float sum = 0.0f;
      for (int w = 0; w < kWarps; ++w)
#pragma unroll
        for (int k = 0; k < CPG; ++k) sum += red[w * K::CO + tid * CPG + k];
      gmean[tid] = sum / n;
    }
    __syncthreads();
    float mean[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mean[j] = gmean[(cu * 8 + j) / CPG];
      a[j] = 0.0f;
    }
    for (int i = tid; i < K::OUT_UNITS; i += kThreads) {
      const int q = i / K::NCO;
      if (q / K::TW < vh && q % K::TW < vw) {
        float f[8];
        unpack8(act[q * K::NCO + swz<K::NCO>(q, cu)], f);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float d = f[j] - mean[j];
          a[j] = fmaf(d, d, a[j]);
        }
      }
    }
    reduce_channels<K>(a, red, lane, warp);
    __syncthreads();
    if (tid < kGroups) {
      float m2 = 0.0f;
      for (int w = 0; w < kWarps; ++w)
#pragma unroll
        for (int k = 0; k < CPG; ++k) m2 += red[w * K::CO + tid * CPG + k];
      float* o = p.part + (((size_t)bb * per_sample + t) * kGroups + tid) * 3;
      o[0] = n;
      o[1] = gmean[tid];
      o[2] = m2;
    }
  }
}

// ---- 2. GroupNorm statistics -> (scale, shift) --------------------------------

// A warp a sample: lane g < 8 merges group g's partials over the tiles in
// order; every lane then writes its channel's (scale, shift).
__global__ void __launch_bounds__(kThreads)
    gn_finalize_kernel(const float* __restrict__ part, int tiles, int channels,
                       const float* __restrict__ gamma, const float* __restrict__ beta, float eps,
                       float2* __restrict__ ss, int batch) {
  const int lane = threadIdx.x & 31, bb = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (bb >= batch) return;
  const float* q = part + (size_t)bb * tiles * kGroups * 3 + (lane & 7) * 3;
  float n = q[0], mean = q[1], m2 = q[2];
  for (int t = 1; t < tiles; ++t) {
    const float* r = q + (size_t)t * kGroups * 3;
    const float nb = r[0], d = r[1] - mean, nab = n + nb;
    mean += d * (nb / nab);
    m2 += r[2] + d * d * (n * nb / nab);
    n = nab;
  }
  const float rstd = rsqrtf(fmaxf(m2 / n, 0.0f) + eps);
  const int cpg = channels / kGroups;
  const int src = (lane < channels ? lane : channels - 1) / cpg;
  const float gm = __shfl_sync(0xFFFFFFFFu, mean, src), gr = __shfl_sync(0xFFFFFFFFu, rstd, src);
  if (lane < channels) {
    const float sc = gamma[lane] * gr;
    ss[(size_t)bb * channels + lane] = make_float2(sc, fmaf(-gm, sc, beta[lane]));
  }
}

// ---- 3. transposed conv 2x2, stride 2 -----------------------------------------

struct ConvTArgs {
  const uint16_t* src;  // [B, h, w, CI] bf16, before its norm
  const float2* ss;     // [B, CI]
  const float* weight;  // [CI, CO, 2, 2] float32
  const float* bias;    // [CO]
  uint16_t* out;        // [B, 2h + pad_h, 2w, CO] bf16
  int batch, h, w, pad_h;
  int tiles_y, tiles_x;
};

template <int CI_, int CO_, int TH_, int TW_>
struct ConvT {
  static constexpr int CI = CI_, CO = CO_, TH = TH_, TW = TW_;
  static constexpr int NCI = CI / 8, NCO = CO / 8;
  static constexpr int PIX = TH * TW, MTILES = (PIX + 15) / 16;
  static constexpr int NT = 4 * CO / 8, NB = 4, NBLK = NT / NB;  // n-tiles, 4 a work item
  static constexpr int IN_UNITS = PIX * NCI, OUT_UNITS = 4 * PIX * NCO, W_UNITS = 4 * CO * NCI;
  static constexpr int SMEM = (IN_UNITS + OUT_UNITS + W_UNITS) * 16 + CI * 8 + CO * 4;
  static_assert(CI % 16 == 0 && CO % 8 == 0 && NT % NB == 0, "channel counts");
};

template <class K>
__global__ void __launch_bounds__(kThreads) conv_t_kernel(const ConvTArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* in = reinterpret_cast<uint4*>(smem);
  uint4* out = in + K::IN_UNITS;  // [2 TH][2 TW] pixels of NCO units
  uint4* wsm = out + K::OUT_UNITS;  // rows n = (2a + b) * CO + co of NCI units
  float2* ss = reinterpret_cast<float2*>(wsm + K::W_UNITS);
  float* bias = reinterpret_cast<float*>(ss + K::CI);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < K::W_UNITS; i += kThreads) {
    const int c = i % K::NCI, row = i / K::NCI, ab = row / K::CO, co = row % K::CO;
    float f[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) f[j] = p.weight[((c * 8 + j) * K::CO + co) * 4 + ab];
    wsm[row * K::NCI + swz<K::NCI>(row, c)] = pack8(f);
  }
  for (int i = tid; i < K::CO; i += kThreads) bias[i] = round_bf16(p.bias[i]);

  const uint32_t in_s = smem_addr(in), w_s = smem_addr(wsm);
  const int per_sample = p.tiles_y * p.tiles_x, n_tiles = p.batch * per_sample;
  const int ho = 2 * p.h + p.pad_h, wo = 2 * p.w;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int bb = tile / per_sample, t = tile % per_sample;
    const int ty0 = (t / p.tiles_x) * K::TH, tx0 = (t % p.tiles_x) * K::TW;
    const int vh = min(K::TH, p.h - ty0), vw = min(K::TW, p.w - tx0);
    // the tile's loads and the sample's (scale, shift) in one round trip
    constexpr int UT = (K::IN_UNITS + kThreads - 1) / kThreads;
    uint4 raw[UT];
    const float2 ssv = tid < K::CI ? p.ss[(size_t)bb * K::CI + tid] : make_float2(0.0f, 0.0f);
#pragma unroll
    for (int u = 0; u < UT; ++u) {
      const int i = tid + u * kThreads, pix = i / K::NCI, c = i % K::NCI;
      const int y = pix / K::TW, x = pix % K::TW;
      if (i < K::IN_UNITS && y < vh && x < vw)
        raw[u] = *reinterpret_cast<const uint4*>(
            p.src + (((size_t)bb * p.h + ty0 + y) * p.w + tx0 + x) * K::CI + c * 8);
    }
    __syncthreads();  // the last tile's staging is stored
    if (tid < K::CI) ss[tid] = ssv;
    __syncthreads();
#pragma unroll
    for (int u = 0; u < UT; ++u) {
      const int i = tid + u * kThreads, pix = i / K::NCI, c = i % K::NCI;
      const int y = pix / K::TW, x = pix % K::TW;
      if (i < K::IN_UNITS) {
        uint4 v = make_uint4(0, 0, 0, 0);
        if (y < vh && x < vw) {
          float f[8];
          norm_relu8(raw[u], ss + c * 8, f);
          v = pack8(f);
        }
        in[pix * K::NCI + swz<K::NCI>(pix, c)] = v;
      }
    }
    __syncthreads();

    const int g = lane >> 2, t4 = lane & 3;
    for (int item = warp; item < K::MTILES * K::NBLK; item += kWarps) {
      const int m = item / K::NBLK, nb = item % K::NBLK;
      int q = m * 16 + (lane & 15);
      q = q < K::PIX ? q : K::PIX - 1;
      uint32_t a[K::NCI / 2][4];
#pragma unroll
      for (int kc = 0; kc < K::NCI / 2; ++kc)
        ldsm_x4(in_s + (q * K::NCI + swz<K::NCI>(q, kc * 2 + (lane >> 4))) * 16, a[kc]);
      float acc[K::NB][4];
#pragma unroll
      for (int n = 0; n < K::NB; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
        const int row = (nb * K::NB + n) * 8 + (lane & 7);
#pragma unroll
        for (int kc = 0; kc < K::NCI / 2; ++kc) {
          uint32_t b0, b1;
          const int c = kc * 2 + ((lane >> 3) & 1);
          ldsm_x2(w_s + (row * K::NCI + swz<K::NCI>(row, c)) * 16, b0, b1);
          mma_k16(acc[n], a[kc], b0, b1);
        }
      }
#pragma unroll
      for (int n = 0; n < K::NB; ++n) {
        const int col = (nb * K::NB + n) * 8 + t4 * 2, ab = col / K::CO, co = col % K::CO;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int qp = m * 16 + g + half * 8;
          if (qp < K::PIX) {
            const int oq = (2 * (qp / K::TW) + (ab >> 1)) * (2 * K::TW) + 2 * (qp % K::TW) + (ab & 1);
            reinterpret_cast<uint32_t*>(out + oq * K::NCO + swz<K::NCO>(oq, co / 8))[(co % 8) / 2] =
                pack2(acc[n][2 * half] + bias[co], acc[n][2 * half + 1] + bias[co + 1]);
          }
        }
      }
    }
    __syncthreads();

    for (int i = tid; i < K::OUT_UNITS; i += kThreads) {
      const int oq = i / K::NCO, c = i % K::NCO, oy = oq / (2 * K::TW), ox = oq % (2 * K::TW);
      if (oy < 2 * vh && ox < 2 * vw)
        *reinterpret_cast<uint4*>(p.out + (((size_t)bb * ho + 2 * ty0 + oy) * wo + 2 * tx0 + ox) * K::CO +
                                  c * 8) = out[oq * K::NCO + swz<K::NCO>(oq, c)];
    }
    if (p.pad_h && ty0 + vh == p.h) {  // the output padding row: the bias alone
      for (int i = tid; i < 2 * vw * K::NCO; i += kThreads) {
        const int ox = i / K::NCO, c = i % K::NCO;
        float f[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) f[j] = bias[c * 8 + j];
        *reinterpret_cast<uint4*>(p.out + (((size_t)bb * ho + ho - 1) * wo + 2 * tx0 + ox) * K::CO +
                                  c * 8) = pack8(f);
      }
    }
  }
}

// ---- 4. output 1x1 conv ---------------------------------------------------------

constexpr int kOutMaxIn = 64, kOutMaxOut = 8;

// A thread a pixel; grid (pixel blocks, batch).
__global__ void __launch_bounds__(kThreads)
    out1x1_kernel(const uint16_t* __restrict__ src, const float2* __restrict__ ss_g,
                  const float* __restrict__ weight, const float* __restrict__ bias_g,
                  uint16_t* __restrict__ out, int hw, int ci, int co) {
  __shared__ float2 ss[kOutMaxIn];
  __shared__ float wsm[kOutMaxOut * kOutMaxIn];
  __shared__ float bias[kOutMaxOut];
  const int bb = blockIdx.y, tid = threadIdx.x;
  for (int i = tid; i < ci; i += kThreads) ss[i] = ss_g[(size_t)bb * ci + i];
  for (int i = tid; i < ci * co; i += kThreads) wsm[i] = round_bf16(weight[i]);
  for (int i = tid; i < co; i += kThreads) bias[i] = round_bf16(bias_g[i]);
  __syncthreads();
  const int px = blockIdx.x * kThreads + tid;
  if (px >= hw) return;
  float acc[kOutMaxOut];
#pragma unroll
  for (int o = 0; o < kOutMaxOut; ++o) acc[o] = 0.0f;
  const uint16_t* s = src + ((size_t)bb * hw + px) * ci;
  for (int c = 0; c < ci / 8; ++c) {
    float f[8];
    norm_relu8(*reinterpret_cast<const uint4*>(s + c * 8), ss + c * 8, f);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float x = round_bf16(f[j]);
#pragma unroll
      for (int o = 0; o < kOutMaxOut; ++o)
        if (o < co) acc[o] = fmaf(x, wsm[o * ci + c * 8 + j], acc[o]);
    }
  }
  __nv_bfloat16* o16 = reinterpret_cast<__nv_bfloat16*>(out) + ((size_t)bb * hw + px) * co;
#pragma unroll
  for (int o = 0; o < kOutMaxOut; ++o)
    if (o < co) o16[o] = __float2bfloat16_rn(acc[o] + bias[o]);
}

// ---- launches ---------------------------------------------------------------------

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

// Persistent blocks: as many as fit on the card at once (``per_sm``, found
// at a kernel's first launch), at most one a tile.
template <class Kernel>
int resident_blocks(Kernel kernel, int smem, int tiles, int& per_sm) {
  if (per_sm < 0) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  }
  const long long most = (long long)(per_sm > 0 ? per_sm : 1) * sm_count();
  return (int)(tiles < most ? tiles : most);
}

template <class K>
int tiles_of(int h, int w) {
  return ((h + K::TH - 1) / K::TH) * ((w + K::TW - 1) / K::TW);
}

template <class K>
int launch_conv(ConvArgs p, cudaStream_t stream) {
  static int per_sm = -1;
  p.tiles_y = (p.h + K::TH - 1) / K::TH;
  p.tiles_x = (p.w + K::TW - 1) / K::TW;
  const int tiles = p.batch * p.tiles_y * p.tiles_x;
  if (tiles == 0) return 0;
  const int grid = resident_blocks(conv3x3_kernel<K>, K::SMEM, tiles, per_sm);
  conv3x3_kernel<K><<<grid, kThreads, K::SMEM, stream>>>(p);
  return (int)cudaGetLastError();
}

template <class K>
int launch_conv_t(ConvTArgs p, cudaStream_t stream) {
  static int per_sm = -1;
  p.tiles_y = (p.h + K::TH - 1) / K::TH;
  p.tiles_x = (p.w + K::TW - 1) / K::TW;
  const int tiles = p.batch * p.tiles_y * p.tiles_x;
  if (tiles == 0) return 0;
  const int grid = resident_blocks(conv_t_kernel<K>, K::SMEM, tiles, per_sm);
  conv_t_kernel<K><<<grid, kThreads, K::SMEM, stream>>>(p);
  return (int)cudaGetLastError();
}

// The one kernel built for a layer: source A's load and channels (the
// ring's, at most 8), the skip's channels, the outputs; the tile by
// the output width where one layout runs at two sizes. Unrolling and
// blocks an SM are the fastest of those timed on an H100 at 2,048 180x320
// rings (PERF.md).
template <class F>
int with_conv(int mode, int ca, int cb, int co, int w, F&& f) {
  const bool wide = w >= 120, mid = w >= 30;
  if (mode == kRing && cb == 0 && co == 8) {
    if (ca <= 8) return f(Conv<8, 0, 8, kRing, 16, 64, 9, 3>{});
  }
  if (mode == kNorm && cb == 0) {
    if (ca == 8 && co == 8) return f(Conv<8, 0, 8, kNorm, 16, 64, 9, 3>{});
    if (ca == 16 && co == 16)
      return wide ? f(Conv<16, 0, 16, kNorm, 16, 32, 9, 2>{}) : f(Conv<16, 0, 16, kNorm, 15, 40, 3, 1>{});
    if (ca == 32 && co == 32)
      return mid ? f(Conv<32, 0, 32, kNorm, 11, 40, 1, 1>{}) : f(Conv<32, 0, 32, kNorm, 11, 20, 3, 1>{});
  }
  if (mode == kPool && cb == 0) {
    if (ca == 8 && co == 16) return f(Conv<8, 0, 16, kPool, 16, 32, 9, 1>{});
    if (ca == 16 && co == 16) return f(Conv<16, 0, 16, kPool, 8, 40, 3, 1>{});
    if (ca == 16 && co == 32) return f(Conv<16, 0, 32, kPool, 11, 40, 1, 1>{});
    if (ca == 32 && co == 32) return f(Conv<32, 0, 32, kPool, 11, 20, 3, 1>{});
  }
  if (mode == kRaw) {
    if (ca == 32 && cb == 32 && co == 32) return f(Conv<32, 32, 32, kRaw, 11, 40, 9, 1>{});
    if (ca == 16 && cb == 16 && co == 16)
      return wide ? f(Conv<16, 16, 16, kRaw, 12, 32, 9, 2>{}) : f(Conv<16, 16, 16, kRaw, 15, 40, 3, 1>{});
    if (ca == 8 && cb == 8 && co == 8) return f(Conv<8, 8, 8, kRaw, 16, 32, 9, 1>{});
  }
  return kNoShape;
}

template <class F>
int with_conv_t(int ci, int co, F&& f) {
  if (ci == 32 && co == 32) return f(ConvT<32, 32, 11, 20>{});
  if (ci == 32 && co == 16) return f(ConvT<32, 16, 8, 40>{});
  if (ci == 16 && co == 16) return f(ConvT<16, 16, 8, 40>{});
  if (ci == 16 && co == 8) return f(ConvT<16, 8, 8, 64>{});
  return kNoShape;
}

}  // namespace

// Tiles a sample of a conv3x3 layer (the partials' second axis), or -1 when
// no kernel was built for it. ``ca`` is source A's channels (kRing: the
// ring's), ``h`` x ``w`` the output size.
extern "C" int unet_conv3x3_tiles(int mode, int ca, int cb, int co, int h, int w) {
  return with_conv(mode, ca, cb, co, w, [&](auto k) { return tiles_of<decltype(k)>(h, w); });
}

extern "C" int unet_conv3x3(int mode, int ca, int cb, int co, const void* a, const void* ss_a,
                            const void* b, const void* ss_b, const void* weight, const void* bias,
                            void* out, void* part, int batch, int h, int w, int src_h, int src_w,
                            int cin, void* stream) {
  ConvArgs p{a,
             static_cast<const float2*>(ss_a),
             static_cast<const uint16_t*>(b),
             static_cast<const float2*>(ss_b),
             static_cast<const float*>(weight),
             static_cast<const float*>(bias),
             static_cast<uint16_t*>(out),
             static_cast<float*>(part),
             batch, h, w, src_h, src_w, cin, 0, 0};
  return with_conv(mode, ca, cb, co, w, [&](auto k) {
    return launch_conv<decltype(k)>(p, static_cast<cudaStream_t>(stream));
  });
}

extern "C" int unet_gn_finalize(const void* part, int tiles, int channels, const void* gamma,
                                const void* beta, float eps, void* ss, int batch, void* stream) {
  if (channels % kGroups != 0 || channels > 32) return kNoShape;
  if (batch == 0) return 0;
  gn_finalize_kernel<<<(batch + kWarps - 1) / kWarps, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), tiles, channels, static_cast<const float*>(gamma),
      static_cast<const float*>(beta), eps, static_cast<float2*>(ss), batch);
  return (int)cudaGetLastError();
}

extern "C" int unet_conv_t(int ci, int co, const void* src, const void* ss, const void* weight,
                           const void* bias, void* out, int batch, int h, int w, int pad_h,
                           void* stream) {
  const ConvTArgs p{static_cast<const uint16_t*>(src), static_cast<const float2*>(ss),
                    static_cast<const float*>(weight), static_cast<const float*>(bias),
                    static_cast<uint16_t*>(out), batch, h, w, pad_h, 0, 0};
  return with_conv_t(ci, co, [&](auto k) {
    return launch_conv_t<decltype(k)>(p, static_cast<cudaStream_t>(stream));
  });
}

extern "C" int unet_out1x1(const void* src, const void* ss, const void* weight, const void* bias,
                           void* out, int batch, int hw, int ci, int co, void* stream) {
  if (ci % 8 != 0 || ci > kOutMaxIn || co < 1 || co > kOutMaxOut) return kNoShape;
  if (batch == 0 || hw == 0) return 0;
  const dim3 grid((hw + kThreads - 1) / kThreads, batch);
  out1x1_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(src), static_cast<const float2*>(ss),
      static_cast<const float*>(weight), static_cast<const float*>(bias),
      static_cast<uint16_t*>(out), hw, ci, co);
  return (int)cudaGetLastError();
}

extern "C" const char* unet_error_string(int code) {
  return code == kNoShape ? "no kernel built for this layer's shape"
                          : cudaGetErrorString((cudaError_t)code);
}
