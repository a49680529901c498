// Dequantize-and-merge of one gsync partial-aggregate frame, for
// Hopper (sm_90a).
//
// Replaces the JAX package's jitted XLA program engine/xla.py
// `agg_merge_fn` (and the table it folds into, `agg_merge_table`): the
// cluster-wide exchange tier's quantized mode ships each process's
// per-key partial aggregates inside the gsync metadata round, and every
// process folds every peer's frame into a device-resident merge table.
// One call folds one field of one frame:
//
//   for i < n:  table[gidx[i]] = combine(table[gidx[i]], value(i))
//
// where value(i) dequantizes row i of the frame's part:
//   ENC_RAW   the value as it is, already in the table's dtype;
//   ENC_INT8  float(q[i]) * scales[i / 1024] (one f32 product), then
//             cast to the table's dtype;
//   ENC_BF16  the float whose upper 16 bits are hi[i], then cast.
// Tables are float32 or int32.  The cast from float to int32 truncates
// toward zero, saturates, and takes NaN to 0, as XLA's convert does
// (PTX cvt.rzi.s32.f32).  combine is add, min or max; float min and max
// propagate NaN as jnp's .at[].min/.max do: a NaN row replaces any
// number, a stored NaN is never replaced (segment_fold.cu's rule).
// Integer adds wrap, as XLA's do.
//
// Rows i >= n are padding: the JAX program folds the identity into
// their target (shard 0's scratch slot); here they are skipped, which
// leaves every real slot, and a scratch slot at its identity, the same.
//
// Determinism.  Every process must end a round with bit-identical
// tables, so there are no atomics on the table: within one frame the
// real rows' targets are unique (each frame is one peer's chunk,
// pre-reduced per key), so one thread a row reads, combines and writes
// its slot, and frames go one launch after another on one stream.  The
// kernel holds that invariant rather than assume it: each row sets its
// target's bit in a bitmap of the table (the workspace, cleared by the
// call), and a row that finds the bit set already, or a target outside
// the table, counts itself in the workspace's two error words and
// writes nothing.  The host wrapper (ops/merge_kernel.py) reads those
// words back and raises.
//
// What bounds it.  A frame holds at most n_shards * 4095 rows (8,192 at
// 2 shards, padded): at the card's 3.35 TB/s the bytes take well under
// a microsecond, so the call is bound by its launch.
//
// The host wrapper checks every argument, allocates the workspace,
// passes PyTorch's current stream, and raises on a non-zero return,
// which is the launch's cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum { ENC_RAW = 0, ENC_INT8 = 1, ENC_BF16 = 2 };
enum { OP_ADD = 0, OP_MIN = 1, OP_MAX = 2 };
constexpr int kQBlock = 1024;
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

__device__ __forceinline__ bool is_nan(float x) { return x != x; }
__device__ __forceinline__ bool is_nan(int) { return false; }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ int from_f32<int>(float v) {
  return __float2int_rz(v);
}

template <typename T, int ENC>
__device__ __forceinline__ T value_of(const void* p0, const void* p1, long long i) {
  if (ENC == ENC_RAW) {
    return static_cast<const T*>(p0)[i];
  } else if (ENC == ENC_INT8) {
    const float scale = static_cast<const float*>(p0)[i / kQBlock];
    const float q = static_cast<float>(static_cast<const int8_t*>(p1)[i]);
    // __fmul_rn: the product is rounded on its own, never contracted
    // into an FMA with the add below (XLA rounds it on its own too).
    return from_f32<T>(__fmul_rn(q, scale));
  } else {
    const uint32_t hi = static_cast<const uint16_t*>(p0)[i];
    return from_f32<T>(__uint_as_float(hi << 16));
  }
}

template <int OP>
__device__ __forceinline__ float combine(float old, float v) {
  if (OP == OP_ADD) return __fadd_rn(old, v);
  if (is_nan(old)) return old;
  if (is_nan(v)) return v;
  return (OP == OP_MIN ? v < old : v > old) ? v : old;
}

template <int OP>
__device__ __forceinline__ int combine(int old, int v) {
  if (OP == OP_ADD) {
    return static_cast<int>(static_cast<uint32_t>(old) + static_cast<uint32_t>(v));
  }
  return (OP == OP_MIN ? v < old : v > old) ? v : old;
}

// work: ceil(size / 32) bitmap words, then the duplicate count and the
// out-of-range count.
template <typename T, int ENC, int OP>
__global__ void __launch_bounds__(kThreads) merge_rows(T* __restrict__ table, long long size,
                                                       const int* __restrict__ gidx,
                                                       long long n, const void* p0,
                                                       const void* p1, unsigned* work,
                                                       long long words) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    const int g = gidx[i];
    if (g < 0 || g >= size) {
      atomicAdd(&work[words + 1], 1u);
      continue;
    }
    const unsigned bit = 1u << (g & 31);
    if (atomicOr(&work[g >> 5], bit) & bit) {
      atomicAdd(&work[words], 1u);
      continue;
    }
    const T v = value_of<T, ENC>(p0, p1, i);
    table[g] = combine<OP>(table[g], v);
  }
}

template <typename T, int ENC>
cudaError_t launch_op(int op, dim3 grid, cudaStream_t s, T* table, long long size,
                      const int* gidx, long long n, const void* p0, const void* p1,
                      unsigned* work, long long words) {
  if (op == OP_ADD) {
    merge_rows<T, ENC, OP_ADD><<<grid, kThreads, 0, s>>>(table, size, gidx, n, p0, p1, work, words);
  } else if (op == OP_MIN) {
    merge_rows<T, ENC, OP_MIN><<<grid, kThreads, 0, s>>>(table, size, gidx, n, p0, p1, work, words);
  } else {
    merge_rows<T, ENC, OP_MAX><<<grid, kThreads, 0, s>>>(table, size, gidx, n, p0, p1, work, words);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_enc(int enc, int op, dim3 grid, cudaStream_t s, T* table, long long size,
                       const int* gidx, long long n, const void* p0, const void* p1,
                       unsigned* work, long long words) {
  if (enc == ENC_RAW) return launch_op<T, ENC_RAW>(op, grid, s, table, size, gidx, n, p0, p1, work, words);
  if (enc == ENC_INT8) return launch_op<T, ENC_INT8>(op, grid, s, table, size, gidx, n, p0, p1, work, words);
  return launch_op<T, ENC_BF16>(op, grid, s, table, size, gidx, n, p0, p1, work, words);
}

}  // namespace

// Fold rows [0, n) of one frame's field into `table` (`size` slots,
// float32, or int32 with table_int).  `work` holds ceil(size / 32) + 2
// words; the call clears it before the kernel runs, and after it the
// last two words count the rows whose target repeated an earlier row's
// and the rows whose target lay outside the table.
extern "C" int bw_agg_merge(int table_int, int enc, int op, void* table, long long size,
                            const int* gidx, long long n, const void* p0, const void* p1,
                            unsigned* work, void* stream) {
  if (enc < ENC_RAW || enc > ENC_BF16 || op < OP_ADD || op > OP_MAX || size < 1 ||
      size > 0x7fffffffLL || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long words = (size + 31) / 32;
  cudaError_t err = cudaMemsetAsync(work, 0, static_cast<size_t>(words + 2) * 4, s);
  if (err != cudaSuccess || n == 0) return static_cast<int>(err);
  int device = 0;
  int sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long blocks = (n + kThreads - 1) / kThreads;
  const long long most = static_cast<long long>(kBlocksPerSm) * sms;
  if (blocks > most) blocks = most;
  const dim3 grid(static_cast<unsigned int>(blocks));
  if (table_int) {
    err = launch_enc<int>(enc, op, grid, s, static_cast<int*>(table), size, gidx, n, p0, p1, work, words);
  } else {
    err = launch_enc<float>(enc, op, grid, s, static_cast<float*>(table), size, gidx, n, p0, p1, work, words);
  }
  return static_cast<int>(err);
}
