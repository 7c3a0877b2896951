// Negacyclic NTT over RNS limbs for NVIDIA Hopper (sm_90a), called from JAX
// through the XLA FFI (abc_tpu/ops/cuda_ntt.py builds and binds it).
//
// Same arithmetic and tables as abc_tpu.crypto.ntt._fwd_stages/_inv_stages,
// so outputs are bit-identical to the np64 engine:
//   polynomials  uint32 [..., L, n], one row per (batch, limb)
//   twiddles     psi^bitrev(k) per limb with Shoup companions floor(w*2^32/q)
//   forward      Cooley-Tukey, stages m = 1, 2, ..., n/2, t = n/(2m)
//   inverse      Gentleman-Sande, m = n/2, ..., 1, then a multiply by n^-1
// Every butterfly reduces fully into [0, q), like the stage loop.
//
// Schedule: a block owns E = 2^log_block consecutive elements of work in
// shared memory and runs every stage its elements close over. log_block <= 0
// picks it from the call's size (2^11, or 2^12 from 2^22 elements on), the
// fastest of 2^10..2^12 and one block per row measured on the H100 at
// n = 8192..32768 and B = 1..64 (PERF.md, "Kernel decisions"). With E = n a
// row is one block (one pass). With E < n the transform splits as
// n = n1 * n2 (n2 = E, n1 = n / E) into two passes of log2(n1) and log2(n2)
// stages:
//   column pass  stages with t >= n2; the n1 elements c + n2*r (r < n1) of a
//                column c form one sub-problem, and a block holds C = E / n1
//                adjacent columns so its loads are contiguous runs of C words;
//   row pass     stages with t < n2; each run of n2 contiguous elements is
//                one sub-problem.
// Forward runs column then row pass; inverse runs row then column pass.
// The twiddle of the butterfly whose upper element sits at global index i
// in stage m is tw[m + i / (2t)].

#include <cstdint>
#include <string>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b,
                                            uint32_t q) {
  uint32_t r = a + b;
  return r >= q ? r - q : r;
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b,
                                            uint32_t q) {
  return a >= b ? a - b : a + q - b;
}

// a*w mod q with wsh = floor(w*2^32/q): a*w - hi*q lies in [0, 2q).
__device__ __forceinline__ uint32_t mul_shoup(uint32_t a, uint32_t w,
                                              uint32_t wsh, uint32_t q) {
  uint32_t r = a * w - __umulhi(a, wsh) * q;
  return r >= q ? r - q : r;
}

struct Tables {
  const uint32_t* tw;      // [L, n]
  const uint32_t* twsh;    // [L, n]
  const uint32_t* q;       // [L]
  const uint32_t* ninv;    // [L], inverse only
  const uint32_t* ninvsh;  // [L], inverse only
};

// Butterflies of one stage over a sub-problem held in shared memory.
// 2^loglanes independent sub-problems are interleaved word by word (lane =
// b % lanes). Butterfly j = b / lanes of a stage with half-width t = 2^logt
// is (group i, offset k) = (j >> logt, j & (t-1)), twiddle tw[widx0 + i].
template <bool kInverse>
__device__ __forceinline__ void stage(uint32_t* s, int half, int loglanes,
                                      int logt, uint32_t widx0,
                                      const uint32_t* tw, const uint32_t* twsh,
                                      uint32_t q) {
  const int lane_mask = (1 << loglanes) - 1;
  const int t_mask = (1 << logt) - 1;
  for (int b = threadIdx.x; b < half; b += blockDim.x) {
    const int lane = b & lane_mask;
    const int j = b >> loglanes;
    const int i = j >> logt;
    const int k = j & t_mask;
    const int iu = ((((i << 1) << logt) + k) << loglanes) + lane;
    const int iv = iu + (1 << (logt + loglanes));
    const uint32_t widx = widx0 + (uint32_t)i;
    const uint32_t w = __ldg(tw + widx);
    const uint32_t wsh = __ldg(twsh + widx);
    const uint32_t u = s[iu];
    const uint32_t v = s[iv];
    if (!kInverse) {
      const uint32_t vw = mul_shoup(v, w, wsh, q);
      s[iu] = add_mod(u, vw, q);
      s[iv] = sub_mod(u, vw, q);
    } else {
      s[iu] = add_mod(u, v, q);
      s[iv] = mul_shoup(sub_mod(u, v, q), w, wsh, q);
    }
  }
  __syncthreads();
}

// Column pass: stages m = 1 .. n1/2. Block = (row, C adjacent columns);
// shared tile [n1][C]. Local group i is the global group, so the twiddle
// index is m + i.
template <bool kInverse>
__global__ void column_pass(const uint32_t* in, uint32_t* out, Tables tab, int L,
                            int logn, int logn1, int loge) {
  extern __shared__ uint32_t s[];
  const int logc = loge - logn1;
  const int logn2 = logn - logn1;
  const int E = 1 << loge;
  const int blocks_per_row = 1 << (logn2 - logc);
  const long long row = blockIdx.x / blocks_per_row;
  const int c0 = (blockIdx.x % blocks_per_row) << logc;
  const int limb = (int)(row % L);
  const int n = 1 << logn;
  const uint32_t q = tab.q[limb];
  const uint32_t* tw = tab.tw + (size_t)limb * n;
  const uint32_t* twsh = tab.twsh + (size_t)limb * n;
  const uint32_t* src = in + row * n;
  uint32_t* dst = out + row * n;
  const int cmask = (1 << logc) - 1;

  for (int e = threadIdx.x; e < E; e += blockDim.x)
    s[e] = src[c0 + (e & cmask) + ((e >> logc) << logn2)];
  __syncthreads();

  const int half = E >> 1;
  if (!kInverse) {
    for (int logm = 0; logm < logn1; ++logm)
      stage<false>(s, half, logc, logn1 - 1 - logm, 1u << logm, tw, twsh, q);
    for (int e = threadIdx.x; e < E; e += blockDim.x)
      dst[c0 + (e & cmask) + ((e >> logc) << logn2)] = s[e];
  } else {
    for (int logm = logn1 - 1; logm >= 0; --logm)
      stage<true>(s, half, logc, logn1 - 1 - logm, 1u << logm, tw, twsh, q);
    const uint32_t ni = tab.ninv[limb], nish = tab.ninvsh[limb];
    for (int e = threadIdx.x; e < E; e += blockDim.x)
      dst[c0 + (e & cmask) + ((e >> logc) << logn2)] =
          mul_shoup(s[e], ni, nish, q);
  }
}

// Row pass: stages m = n1 .. n/2 over contiguous chunks of n2 = E elements.
// Chunk R, local stage m_loc = m / n1: the twiddle index is
// m + R*m_loc + i = (n1 + R) * m_loc + i. kScale folds n^-1 into the store
// (inverse with n1 = 1, where this is the only pass).
template <bool kInverse, bool kScale>
__global__ void row_pass(const uint32_t* in, uint32_t* out, Tables tab, int L,
                         int logn, int logn1) {
  extern __shared__ uint32_t s[];
  const int loge = logn - logn1;
  const int E = 1 << loge;
  const int n1 = 1 << logn1;
  const long long row = blockIdx.x >> logn1;
  const int chunk = blockIdx.x & (n1 - 1);
  const int limb = (int)(row % L);
  const int n = 1 << logn;
  const uint32_t q = tab.q[limb];
  const uint32_t* tw = tab.tw + (size_t)limb * n;
  const uint32_t* twsh = tab.twsh + (size_t)limb * n;
  const size_t base = (size_t)row * n + ((size_t)chunk << loge);

  for (int e = threadIdx.x; e < E; e += blockDim.x) s[e] = in[base + e];
  __syncthreads();

  const int half = E >> 1;
  const uint32_t g = (uint32_t)(n1 + chunk);
  if (!kInverse) {
    for (int logm = 0; logm < loge; ++logm)
      stage<false>(s, half, 0, loge - 1 - logm, g << logm, tw, twsh, q);
  } else {
    for (int logm = loge - 1; logm >= 0; --logm)
      stage<true>(s, half, 0, loge - 1 - logm, g << logm, tw, twsh, q);
  }
  if (kScale) {
    const uint32_t ni = tab.ninv[limb], nish = tab.ninvsh[limb];
    for (int e = threadIdx.x; e < E; e += blockDim.x)
      out[base + e] = mul_shoup(s[e], ni, nish, q);
  } else {
    for (int e = threadIdx.x; e < E; e += blockDim.x) out[base + e] = s[e];
  }
}

int ilog2(int64_t v) {
  int r = 0;
  while ((int64_t{1} << r) < v) ++r;
  return r;
}

// The second pass of a split transform runs in place (in == out): every
// block reads its whole tile into shared memory before it writes.
template <typename K, typename... Args>
ffi::Error launch(K kernel, int64_t blocks, int threads, size_t smem,
                  cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess)
    return ffi::Error::Internal(std::string("ntt smem attribute: ") +
                                cudaGetErrorString(err));
  kernel<<<(unsigned)blocks, threads, smem, stream>>>(args...);
  err = cudaGetLastError();
  if (err != cudaSuccess)
    return ffi::Error::Internal(std::string("ntt launch: ") +
                                cudaGetErrorString(err));
  return ffi::Error::Success();
}

ffi::Error Ntt(cudaStream_t stream, bool inverse, ffi::Buffer<ffi::U32> x,
               ffi::Buffer<ffi::U32> tw, ffi::Buffer<ffi::U32> twsh,
               ffi::Buffer<ffi::U32> q, const uint32_t* ninv,
               const uint32_t* ninvsh, ffi::Result<ffi::Buffer<ffi::U32>> y,
               int64_t log_block) {
  auto dims = x.dimensions();
  if (dims.size() < 2)
    return ffi::Error::InvalidArgument("ntt: input must be [..., L, n]");
  const int64_t n = dims[dims.size() - 1];
  const int64_t L = dims[dims.size() - 2];
  if (n < 2 || (n & (n - 1)) != 0)
    return ffi::Error::InvalidArgument("ntt: n must be a power of two");
  // tables may carry leading unit dims (vmap_method="expand_dims")
  if ((int64_t)q.element_count() != L ||
      (int64_t)tw.element_count() != L * n ||
      (int64_t)twsh.element_count() != L * n)
    return ffi::Error::InvalidArgument(
        "ntt: tables must be [L, n] / [L, 1] and unbatched");
  const int64_t rows = (int64_t)x.element_count() / n;
  if (rows == 0) return ffi::Error::Success();

  const int logn = ilog2(n);
  if (log_block <= 0)  // by size: 2^11-element blocks, 2^12 from 4M elements
    log_block = rows * n >= (int64_t{1} << 22) ? 12 : 11;
  const int loge = log_block < logn ? (int)log_block : logn;
  const int logn1 = logn - loge;
  if (loge < logn1)
    return ffi::Error::InvalidArgument("ntt: block smaller than sqrt(n)");
  const int E = 1 << loge;
  const int threads = E / 2 < 512 ? E / 2 : 512;
  const size_t smem = (size_t)E * sizeof(uint32_t);
  const int64_t blocks = rows << logn1;  // n / E blocks per row
  Tables tab{tw.typed_data(), twsh.typed_data(), q.typed_data(), ninv,
             ninvsh};
  const uint32_t* in = x.typed_data();
  uint32_t* out = y->typed_data();
  const int iL = (int)L;

  if (!inverse) {
    if (logn1 == 0)
      return launch(row_pass<false, false>, blocks, threads, smem, stream,
                        in, out, tab, iL, logn, 0);
    ffi::Error e = launch(column_pass<false>, blocks, threads, smem, stream,
                          in, out, tab, iL, logn, logn1, loge);
    if (e.failure()) return e;
    return launch(row_pass<false, false>, blocks, threads, smem, stream,
                      out, out, tab, iL, logn, logn1);
  }
  if (logn1 == 0)
    return launch(row_pass<true, true>, blocks, threads, smem, stream, in,
                      out, tab, iL, logn, 0);
  ffi::Error e = launch(row_pass<true, false>, blocks, threads, smem,
                            stream, in, out, tab, iL, logn, logn1);
  if (e.failure()) return e;
  return launch(column_pass<true>, blocks, threads, smem, stream, out, out,
                tab, iL, logn, logn1, loge);
}

ffi::Error NttFwdImpl(cudaStream_t stream, ffi::Buffer<ffi::U32> x,
                      ffi::Buffer<ffi::U32> tw, ffi::Buffer<ffi::U32> twsh,
                      ffi::Buffer<ffi::U32> q,
                      ffi::Result<ffi::Buffer<ffi::U32>> y,
                      int64_t log_block) {
  return Ntt(stream, false, x, tw, twsh, q, nullptr, nullptr, y, log_block);
}

ffi::Error NttInvImpl(cudaStream_t stream, ffi::Buffer<ffi::U32> x,
                      ffi::Buffer<ffi::U32> tw, ffi::Buffer<ffi::U32> twsh,
                      ffi::Buffer<ffi::U32> q, ffi::Buffer<ffi::U32> ninv,
                      ffi::Buffer<ffi::U32> ninvsh,
                      ffi::Result<ffi::Buffer<ffi::U32>> y,
                      int64_t log_block) {
  auto dims = x.dimensions();
  const int64_t L = dims.size() >= 2 ? dims[dims.size() - 2] : 0;
  if ((int64_t)ninv.element_count() != L ||
      (int64_t)ninvsh.element_count() != L)
    return ffi::Error::InvalidArgument("ntt: n_inv tables must be [L, 1]");
  return Ntt(stream, true, x, tw, twsh, q, ninv.typed_data(),
             ninvsh.typed_data(), y, log_block);
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(AbcNttFwd, NttFwdImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()  // x
                                  .Arg<ffi::Buffer<ffi::U32>>()  // tw
                                  .Arg<ffi::Buffer<ffi::U32>>()  // twsh
                                  .Arg<ffi::Buffer<ffi::U32>>()  // q
                                  .Ret<ffi::Buffer<ffi::U32>>()  // y
                                  .Attr<int64_t>("log_block"));

XLA_FFI_DEFINE_HANDLER_SYMBOL(AbcNttInv, NttInvImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()  // x
                                  .Arg<ffi::Buffer<ffi::U32>>()  // tw
                                  .Arg<ffi::Buffer<ffi::U32>>()  // twsh
                                  .Arg<ffi::Buffer<ffi::U32>>()  // q
                                  .Arg<ffi::Buffer<ffi::U32>>()  // n_inv
                                  .Arg<ffi::Buffer<ffi::U32>>()  // n_inv_sh
                                  .Ret<ffi::Buffer<ffi::U32>>()  // y
                                  .Attr<int64_t>("log_block"));
