// K5 schur_gather: assemble the border system of a BBD Schur solve.
//
// Replaces the padded scatter-adds of the JAX package's BBD solves:
// s_pad.at[bsel[:, :, None], bsel[:, None, :]].add(-contrib) and
// r_red.at[bsel].add(rhs_part) in juliagrid_tpu/powerflow/newton_bbd.py
// (:340-348), ops/bbd.py::bbd_solve_local (:302-308) and
// estimation/acse_bbd.py::_gn_increment_bbd (:331-336). There each block's
// (L x L) Schur contribution and L-long right-hand side part scatter into a
// (nb + 1)^2 buffer through the block's local-to-global border map `bsel`,
// whose pad slots point at the extra row and column nb.
//
// Mapping: a gather instead of a scatter. The host turns `bsel` into a CSR
// once (schur_gather.py::schur_route): for each destination of the border
// matrix that any block reaches, the flat indices of its sources in the
// [k, L, L] contributions, in ascending block order; the same for the
// border right-hand side from the [k, L] parts. Pad slots are left out, so
// nothing reads or writes a sentinel. One thread per destination sums its
// sources in that fixed order and writes base + scale * sum, where base is
// the masked border block (a_bb) or zero; destinations with no source keep
// the base, copied first. Every element has one writer: no atomics, and
// the result does not depend on scheduling, unlike an atomic scatter.
//
// Bound: bytes. Each launch reads the contributions, the tables and the
// base, and writes the nb^2 border matrix once (35 MB at nb = 2,092, the
// 25k lattice's border at k = 16); a thread does one to a few adds.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
schur_gather_kernel(const int* __restrict__ dst,
                    const int* __restrict__ ptr,
                    const int* __restrict__ src,
                    const double* __restrict__ vals,
                    const double* __restrict__ base,
                    double scale,
                    double* __restrict__ out,
                    int count) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= count) return;
  double acc = 0.0;
  const int end = ptr[t + 1];
  for (int s = ptr[t]; s < end; ++s) acc += vals[src[s]];
  const int d = dst[t];
  out[d] = (base != nullptr ? base[d] : 0.0) + scale * acc;
}

cudaError_t gather(const int* dst, const int* ptr, const int* src,
                   const double* vals, const double* base, double scale,
                   double* out, int64_t out_len, int count, cudaStream_t s) {
  const size_t bytes = static_cast<size_t>(out_len) * sizeof(double);
  cudaError_t err =
      base != nullptr
          ? cudaMemcpyAsync(out, base, bytes, cudaMemcpyDeviceToDevice, s)
          : cudaMemsetAsync(out, 0, bytes, s);
  if (err != cudaSuccess || count == 0) return err;
  const int blocks = (count + kThreads - 1) / kThreads;
  schur_gather_kernel<<<blocks, kThreads, 0, s>>>(dst, ptr, src, vals, base,
                                                  scale, out, count);
  return cudaGetLastError();
}

}  // namespace

// Launch K5 on `stream`: schur = a_bb + scale * gathered contributions
// ([nb, nb]) and rhs = r_bb + scale * gathered parts ([nb]). The matrix
// tables are mat_dst[mat_count], mat_ptr[mat_count + 1] and mat_src, with
// sources indexing `contrib`; the right-hand side's likewise index `parts`.
// a_bb and r_bb may be null for a zero base. Returns a cudaError_t code.
extern "C" int schur_gather_launch(
    const int* mat_dst, const int* mat_ptr, const int* mat_src,
    int mat_count, const int* rhs_dst, const int* rhs_ptr,
    const int* rhs_src, int rhs_count, const double* contrib,
    const double* parts, const double* a_bb, const double* r_bb,
    double scale, double* schur, double* rhs, int nb, void* stream) {
  if (nb <= 0 || mat_count < 0 || rhs_count < 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t nb64 = nb;
  cudaError_t err = gather(mat_dst, mat_ptr, mat_src, contrib, a_bb, scale,
                           schur, nb64 * nb64, mat_count, s);
  if (err != cudaSuccess) return err;
  return gather(rhs_dst, rhs_ptr, rhs_src, parts, r_bb, scale, rhs, nb64,
                rhs_count, s);
}

extern "C" const char* schur_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
