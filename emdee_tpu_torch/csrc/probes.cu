// The two TPU probes of tools/, as Hopper (sm_90a) kernels: measurement
// kernels on no simulation path.  Wrappers and plain versions:
// emdee_tpu_torch/tools/probes.py.
//
// P1, `probe_fma` — replaces tools/perf_probe3.py `run` (its pallas_call's
// kernel): the force kernel's dispatch shape with the pair math replaced by
// a chain of K multiply-adds.  Program i (of M², (z, y) = divmod(i, M)) owns
// a (C, M·C) centre tile; for each of its 14 tiles t it subtracts the ghost
// row (z + t mod 3)·G + (y + ⌊t/3⌋ mod 3) at lane offset (t mod 3)·C
// (G = M + 2), runs x ← x·a + b K times, and adds x into its accumulator.
// One thread per output lane, every operation rounded on its own
// (__fmul_rn, __fadd_rn), so the kernel equals its plain version bit for
// bit.  Bound: operations, M²·14·C·M·C lanes × (2K + 2) float32 operations
// at 67 TFLOP/s; the inputs are read once (the ghost rows from cache).
//
// P2, `probe_cen_layout` — replaces tools/perf_probe_cen_layout.py `run`
// (kernels `_std3` and `_dgt3`): per program p, the centre-expansion product
// (NC, K) @ (K, NCOL) in float32, the centres stored (NC, K) ("std") or
// (K, NC) ("dgt", the lhs-transposed layout whose lowering the TPU probe
// asked about).  fmaf over k in order from 0, no TF32 and no tensor cores
// (the reference asks for HIGHEST precision).  Bound: bytes, the (P, NC,
// NCOL) output written once (60 MB at the probe's shape) at 3.35 TB/s.
// Design (redesigned for this card; one thread an output with its 2K loads
// ran at ~0.51 TB/s of output): one block a program.  The block stages the
// program's centre tile in shared memory k-major, whatever its storage (a
// coalesced copy in both layouts), and the expansion beside it (37 KB at
// the probe's shape, from L2 after the first blocks); each thread then
// computes register tiles of kRows rows × 4 columns, reading a k's four
// columns and kRows centres as 128-bit shared loads, and stores each row's
// four as one 128-bit streaming store, a warp's 32 stores covering 512
// consecutive bytes.  NC and NCOL must be multiples of 4 and the two tiles
// must fit a block's shared memory (the C entry refuses the rest).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void probe_fma_kernel(const float* __restrict__ ghost, const float* __restrict__ centers,
                                 float* __restrict__ out, int m, int c, int tiles, int k_ops,
                                 float a, float b) {
  const int mc = m * c, g = m + 2;
  const long lane = static_cast<long>(blockIdx.y) * kThreads + threadIdx.x;
  if (lane >= static_cast<long>(c) * mc) return;
  const int i = blockIdx.x;
  const int cz = i / m, cy = i - cz * m;
  const int col = static_cast<int>(lane % mc);
  const long at = static_cast<long>(i) * c * mc + lane;
  const float cen = centers[at];
  float acc = 0.f;
  for (int t = 0; t < tiles; ++t) {
    const int row = (cz + t % 3) * g + (cy + (t / 3) % 3);
    const float nb = ghost[static_cast<long>(row) * g * c + (t % 3) * c + col];
    float x = __fsub_rn(cen, nb);
    for (int q = 0; q < k_ops; ++q) x = __fadd_rn(__fmul_rn(x, a), b);
    acc = __fadd_rn(acc, x);
  }
  out[at] = acc;
}

constexpr int kRows = 8;  // P2: rows of a thread's register tile

template <bool TRANSPOSED>
__global__ void __launch_bounds__(kThreads)
    probe_cen_kernel(const float* __restrict__ cen, const float* __restrict__ expand, float* __restrict__ out,
                     int nc, int kd, int ncol) {
  extern __shared__ float4 smem4[];
  float* s_exp = reinterpret_cast<float*>(smem4);  // (K, NCOL)
  float* s_cen = s_exp + kd * ncol;                // (K, NC), k-major, and kRows floats of padding
  const long p = blockIdx.x;
  const float* a = cen + p * nc * kd;
  for (int i = threadIdx.x; i < kd * ncol / 4; i += kThreads)
    smem4[i] = reinterpret_cast<const float4*>(expand)[i];
  for (int i = threadIdx.x; i < nc * kd; i += kThreads) {
    if (TRANSPOSED)
      s_cen[i] = a[i];
    else
      s_cen[(i % kd) * nc + i / kd] = a[i];
  }
  __syncthreads();
  const int quads = ncol / 4;
  const int row_blocks = (nc + kRows - 1) / kRows;
  float* o = out + p * nc * ncol;
  for (int item = threadIdx.x; item < quads * row_blocks; item += kThreads) {
    const int q = item % quads, r0 = (item / quads) * kRows;
    float4 acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < kd; ++k) {
      const float4 b = reinterpret_cast<const float4*>(s_exp + k * ncol)[q];
      const float4* ak4 = reinterpret_cast<const float4*>(s_cen + k * nc + r0);
      float ak[kRows];
#pragma unroll
      for (int h = 0; h < kRows / 4; ++h) {
        const float4 a4 = ak4[h];
        ak[4 * h] = a4.x;
        ak[4 * h + 1] = a4.y;
        ak[4 * h + 2] = a4.z;
        ak[4 * h + 3] = a4.w;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float av = r0 + r < nc ? ak[r] : 0.f;
        acc[r].x = fmaf(av, b.x, acc[r].x);
        acc[r].y = fmaf(av, b.y, acc[r].y);
        acc[r].z = fmaf(av, b.z, acc[r].z);
        acc[r].w = fmaf(av, b.w, acc[r].w);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (r0 + r < nc) __stcs(reinterpret_cast<float4*>(o + static_cast<long>(r0 + r) * ncol) + q, acc[r]);
  }
}

}  // namespace

// ghost (G², G·C), centers and out (M², C, M·C), float32.
extern "C" int emdee_probe_fma(const float* ghost, const float* centers, float* out, int m, int c,
                               int tiles, int k_ops, float a, float b, void* stream) {
  if (m < 1 || c < 1 || tiles < 0 || k_ops < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long lanes = static_cast<long>(c) * m * c;
  const dim3 grid(m * m, static_cast<unsigned>((lanes + kThreads - 1) / kThreads));
  probe_fma_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ghost, centers, out, m, c, tiles, k_ops, a, b);
  return static_cast<int>(cudaGetLastError());
}

// cen (P, NC, K) or, transposed, (P, K, NC); expand (K, NCOL); out (P, NC,
// NCOL); NC and NCOL multiples of 4, the two tiles within a block's shared
// memory.
extern "C" int emdee_probe_cen(const float* cen, const float* expand, float* out, int progs, int nc,
                               int kd, int ncol, int transposed, void* stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(kd) * (ncol + nc) + kRows);
  if (progs < 1 || nc < 4 || nc % 4 != 0 || kd < 1 || ncol < 4 || ncol % 4 != 0 || smem > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = transposed ? probe_cen_kernel<true> : probe_cen_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<progs, kThreads, smem, s>>>(cen, expand, out, nc, kd, ncol);
  return static_cast<int>(cudaGetLastError());
}
