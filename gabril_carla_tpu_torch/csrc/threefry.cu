// JAX's threefry random bits on the card: uniform floats or Bernoulli masks.
//
// The JAX package draws its training dropout with jax.random on the device
// (train/bc.py: the GMD and IGMD uniforms, Oreo's code mask); XLA generated
// that code, so this kernel replaces no Pallas kernel. It computes what
// jax.random.uniform and jax.random.bernoulli compute under jax 0.9's
// partitionable threefry: element i of a draw of n elements from key
// (k0, k1) hashes the 64-bit counter offset + i, split into its high and
// low 32-bit words, with Threefry-2x32 (20 rounds), and xors the two output
// words (utils/prng.py random_bits32). The uniform is the top 23 bits under
// the exponent of 1.0, minus 1; a Bernoulli element is 1.0 where that
// uniform is below p, else 0.0.
//
// Bound: operations. At least 71 instructions an element (20 rounds of add,
// rotate and xor; the key injections; the uniform's bit moves) against 4
// bytes stored, so instruction issue and not the memory limits it. One
// thread an element, in a grid-stride loop; rotations are __funnelshift_l
// (one SHF each); the key comes by value, so a launch needs no copy to the
// card and no synchronisation.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void mix(uint32_t& x0, uint32_t& x1, int r) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, r);
  x1 ^= x0;
}

__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1, uint32_t x0,
                                                  uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
  x0 += k1; x1 += k2 + 1u;
  mix(x0, x1, 17); mix(x0, x1, 29); mix(x0, x1, 16); mix(x0, x1, 24);
  x0 += k2; x1 += k0 + 2u;
  mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
  x0 += k0; x1 += k1 + 3u;
  mix(x0, x1, 17); mix(x0, x1, 29); mix(x0, x1, 16); mix(x0, x1, 24);
  x0 += k1; x1 += k2 + 4u;
  mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
  x0 += k2; x1 += k0 + 5u;
  return x0 ^ x1;
}

template <bool kBernoulli>
__global__ void threefry_floats(uint32_t k0, uint32_t k1, unsigned long long offset,
                                long long n, float p, float* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const unsigned long long c = offset + (unsigned long long)i;
    const uint32_t bits = threefry_bits(k0, k1, (uint32_t)(c >> 32), (uint32_t)c);
    const float u = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
    out[i] = kBernoulli ? (u < p ? 1.0f : 0.0f) : u;
  }
}

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;  // 16 blocks of 256 threads on each of 132 SMs

}  // namespace

// out[i] for i in [0, n): the uniform (bernoulli == 0) or the Bernoulli(p)
// element (bernoulli != 0) at counter offset + i of key (k0, k1). Launches on
// ``stream`` and returns cudaGetLastError() as an int (0: launched).
extern "C" int threefry_floats_launch(uint32_t k0, uint32_t k1, unsigned long long offset,
                                      long long n, float p, int bernoulli, void* out,
                                      void* stream) {
  if (n <= 0) return 0;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (bernoulli) {
    threefry_floats<true><<<(unsigned)blocks, kThreads, 0, s>>>(k0, k1, offset, n, p, o);
  } else {
    threefry_floats<false><<<(unsigned)blocks, kThreads, 0, s>>>(k0, k1, offset, n, p, o);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* threefry_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
