// Row gathers out[r] = table[idx[r]] from an (G, 8) f32 table (probe P1).
//
// Replaces the three Pallas TPU kernels of tools/probe_vmem_gather.py, which
// asked whether a kernel can gather rows of a table by a traced index vector:
//   gaussreg_probe_gather_global  <- `kernel`  (table left in HBM, pltpu.ANY)
//   gaussreg_probe_gather_shared  <- `kernel2` (jnp.take from a table staged
//                                               whole in VMEM)
//   gaussreg_probe_gather_onehot  <- `kernel3` (one-hot (K, G) x (G, C) on
//                                               the matrix unit)
// VMEM is shared memory here. All three give table[idx] bit for bit.
// Precondition: every idx lies in [0, G) (unchecked, as in the probe).
//
// Bound on the card: the K selected rows (32 B each), the K indices and the
// K output rows; at the probe's shape (G = 4096, K = 128) about 8 KB, ~2 ns
// at 3.35 TB/s, out of reach of any launch: every variant is bound by launch
// latency, and variant (2) also by the work its form adds (it copies the
// whole 128 KB table into one block's shared memory first).
//
// (1) global: one thread per output row, two 16-byte loads.
// (2) shared: each block stages the table in dynamic shared memory with
//     16-byte cp.async copies (above the 48 KB default, so the launcher
//     raises the block's limit with cudaFuncSetAttribute), then one thread
//     per row gathers from it.
// (3) onehot: the TPU kernel's one-hot product exists only because Mosaic
//     could not gather by a traced index; on this card the matrix unit has
//     no place in a gather (a one-hot product reads the whole table for
//     every 16 output rows). So it is a direct row gather laid out for
//     whole sectors: two lanes per 32-byte row, one 16-byte __ldg each, so
//     a warp reads 16 whole rows and writes 512 contiguous bytes; both
//     lanes of a row read its index (one broadcast load). One
//     block of up to 1024 threads covers K <= 1024 (a thread takes a second
//     half-row past 512 rows); larger K takes more blocks.
// The plain version of (3) stays the one-hot product (exact: each output
// sums one 1 x value and exact zeros).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 8;                       // row width C (two float4)
constexpr int kMaxSmem = 227 * 1024;           // a block's shared memory on H100
constexpr int kGatherThreads = 1024;           // variant (3): one block up to K = 1024

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}

__global__ void gather_global_kernel(const float4* __restrict__ table,
                                     const int* __restrict__ idx, float4* __restrict__ out,
                                     int k) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= k) return;
  const float4* src = table + (size_t)idx[r] * 2;
  const float4 a = __ldg(src), b = __ldg(src + 1);
  out[2 * r] = a;
  out[2 * r + 1] = b;
}

__global__ void gather_shared_kernel(const float4* __restrict__ table,
                                     const int* __restrict__ idx, float4* __restrict__ out,
                                     int g, int k) {
  extern __shared__ float4 stab[];
  for (int i = threadIdx.x; i < g * 2; i += blockDim.x) cp_async16(stab + i, table + i);
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= k) return;
  const int i = idx[r];
  out[2 * r] = stab[2 * i];
  out[2 * r + 1] = stab[2 * i + 1];
}

__global__ void gather_rows_kernel(const float4* __restrict__ table,
                                   const int* __restrict__ idx, float4* __restrict__ out,
                                   int k) {
  const int halves = 2 * k;  // 16-byte half-rows of the output
  for (int t = blockIdx.x * blockDim.x + threadIdx.x; t < halves; t += gridDim.x * blockDim.x)
    out[t] = __ldg(table + (size_t)__ldg(idx + (t >> 1)) * 2 + (t & 1));
}

}  // namespace

extern "C" {

int gaussreg_probe_gather_global(const float* table, const int* idx, float* out, int g, int k,
                                 cudaStream_t stream) {
  (void)g;
  if (k > 0)
    gather_global_kernel<<<(k + 127) / 128, 128, 0, stream>>>(
        reinterpret_cast<const float4*>(table), idx, reinterpret_cast<float4*>(out), k);
  return (int)cudaGetLastError();
}

int gaussreg_probe_gather_shared(const float* table, const int* idx, float* out, int g, int k,
                                 cudaStream_t stream) {
  const int smem = g * kCols * (int)sizeof(float);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  static int attr_bytes = 0;  // the limit already set (raised only, once per size)
  if (smem > attr_bytes) {
    const cudaError_t e = cudaFuncSetAttribute(
        gather_shared_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr_bytes = smem;
  }
  if (k > 0)
    gather_shared_kernel<<<(k + 255) / 256, 256, smem, stream>>>(
        reinterpret_cast<const float4*>(table), idx, reinterpret_cast<float4*>(out), g, k);
  return (int)cudaGetLastError();
}

int gaussreg_probe_gather_onehot(const float* table, const int* idx, float* out, int g, int k,
                                 cudaStream_t stream) {
  (void)g;
  if (k > 0) {
    const int threads = k >= kGatherThreads / 2 ? kGatherThreads : (2 * k + 31) / 32 * 32;
    const int blocks = (k + kGatherThreads - 1) / kGatherThreads;
    gather_rows_kernel<<<blocks, threads, 0, stream>>>(reinterpret_cast<const float4*>(table),
                                                       idx, reinterpret_cast<float4*>(out), k);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
