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
// asked about).  A plain float32 FMA tile: one thread per output element,
// fmaf over k in order, no TF32 and no tensor cores (the reference asks for
// HIGHEST precision).  Bound: bytes, the (P, NC, NCOL) output written once
// (60 MB at the probe's shape) at 3.35 TB/s.

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

template <bool TRANSPOSED>
__global__ void probe_cen_kernel(const float* __restrict__ cen, const float* __restrict__ expand,
                                 float* __restrict__ out, int nc, int kd, int ncol) {
  const long e = static_cast<long>(blockIdx.y) * kThreads + threadIdx.x;
  if (e >= static_cast<long>(nc) * ncol) return;
  const long p = blockIdx.x;
  const int r = static_cast<int>(e / ncol), col = static_cast<int>(e % ncol);
  const float* a = cen + p * nc * kd;
  float acc = 0.f;
  for (int k = 0; k < kd; ++k) {
    const float ak = TRANSPOSED ? a[static_cast<long>(k) * nc + r] : a[static_cast<long>(r) * kd + k];
    acc = fmaf(ak, expand[static_cast<long>(k) * ncol + col], acc);
  }
  out[p * nc * ncol + e] = acc;
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

// cen (P, NC, K) or, transposed, (P, K, NC); expand (K, NCOL); out (P, NC, NCOL).
extern "C" int emdee_probe_cen(const float* cen, const float* expand, float* out, int progs, int nc,
                               int kd, int ncol, int transposed, void* stream) {
  if (progs < 1 || nc < 1 || kd < 1 || ncol < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long n = static_cast<long>(nc) * ncol;
  const dim3 grid(progs, static_cast<unsigned>((n + kThreads - 1) / kThreads));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (transposed)
    probe_cen_kernel<true><<<grid, kThreads, 0, s>>>(cen, expand, out, nc, kd, ncol);
  else
    probe_cen_kernel<false><<<grid, kThreads, 0, s>>>(cen, expand, out, nc, kd, ncol);
  return static_cast<int>(cudaGetLastError());
}
