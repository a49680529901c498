// Segmented per-key scan for Hopper (sm_90a).
//
// Replaces the JAX package's jitted XLA programs ops/scan.py
// `zscore_scan_body` (the Welford z-score kind) and `generic_scan_body`
// (the flagged segmented associative_scan, for the `Ema` and
// `RunningExtrema` kinds): fold a micro-batch of (slot, value) rows into
// a per-key state table and emit one output row per input row.
//
// Rows come grouped: every slot's rows are contiguous, so a segment is
// a run of equal slots.  For a row i of a segment whose key holds the
// table state C (the carry), with x the segment's lifted rows:
//   pre_i  = C ⊕ (x_head ⊕ ... ⊕ x_{i-1})   (the in-batch exclusive prefix)
//   post_i = C ⊕ (x_head ⊕ ... ⊕ x_i)       (the inclusive prefix)
// the kind emits from (pre, post, value), and the segment's tail writes
// post back to the table.  No other table entry is written.  This is the
// reference's formulation (`carry ⊕ excl`, `carry ⊕ incl`), so the
// carry enters once per row, as it does there.
//
// Three instances of one template, one per state monoid:
//   welford  count int32, mean f32, m2 f32 (Chan's parallel merge);
//            out z against the pre-update state, 0 unless n >= 2 and
//            m2 > 0.  A merge with an empty side returns the other side
//            exactly, and equal values merge with delta = 0, so m2 stays
//            exactly 0 over runs of equal values.
//   ema      count int32, s f32; merge (n1 + n2, s1 * q^n2 + s2) with
//            q^n2 = exp(n2 * log1p(-alpha)), exactly 1 when n2 = 0 (so
//            alpha = 1, log_q = -inf, never computes 0 * -inf); out the
//            debiased s / (1 - q^n) after the row.
//   extrema  mn f32, mx f32; out the post-row min and max.  NaN
//            propagates, as jnp.minimum / torch.minimum do: a NaN row
//            makes the key's extrema NaN from then on (fminf/fmaxf would
//            drop it).
// Counts are int32 end to end, cast to float only inside a merge.
//
// What bounds it.  Each row is read once (slot and value, 8 B) and each
// output written once (4 B per column), and the table is read at heads
// and written at tails: about 12-16 B a row, 4-5 us per 2^20 rows at
// 3.35 TB/s.  The arithmetic (a few merges a row, a division and a
// square root for welford) is far under the card's float32 rate.
//
// Design: a simple three-launch scan over 2048-row tiles, 256 threads
// of 8 rows each, elements (flag, in-batch state, carry) under the
// segmented operator (fa, sa, ca) . (fb, sb, cb) =
// (fa | fb, fb ? sb : sa ⊕ sb, fb ? cb : ca):
//   1. scan_reduce: each block stages its tile in shared memory, folds
//      each thread's rows, reduces the block with warp shuffles, and
//      stores the tile's aggregate with the table state of its last
//      head (read here, before any write);
//   2. scan_carry: one block scans the tile aggregates into each tile's
//      carry-in;
//   3. scan_apply: each block reads the table at its heads (the last
//      head's state comes from launch 1: that segment may end in a later
//      tile, whose block writes the entry), re-scans its tile from the
//      carry-in, emits through shared memory, and writes each tail.
// Reads of the table in launch 3 all happen before the block's first
// __syncthreads, writes after it, and a slot read by one block is
// written by the same block, so no read races a write.  A single-pass
// decoupled look-back would read the rows once instead of twice.
//
// The host wrapper (ops/scan_kernel.py) checks every argument, sizes
// the workspace with bw_segment_scan_workspace, passes PyTorch's current
// stream, and raises on a non-zero return (the first failed launch's
// cudaGetLastError()).  Nothing is allocated here.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;
constexpr int kTile = kThreads * kRows;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kTiny = 1.17549435e-38f;  // FLT_MIN, jnp.finfo(f32).tiny

enum { KIND_WELFORD = 0, KIND_EMA = 1, KIND_EXTREMA = 2 };

struct Table {
  void* f[3];
  long long capacity;
};

struct Outs {
  float* o[2];
};

struct Params {
  float alpha;
  float log_q;
};

__device__ __forceinline__ bool is_nan(float x) { return x != x; }
__device__ __forceinline__ float nan_min(float a, float b) {
  return is_nan(a) ? a : (is_nan(b) ? b : (b < a ? b : a));
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return is_nan(a) ? a : (is_nan(b) ? b : (b > a ? b : a));
}

struct WelfordK {
  struct S {
    int n;
    float mean;
    float m2;
  };
  static constexpr int kOuts = 1;
  __device__ static S identity() { return {0, 0.f, 0.f}; }
  __device__ static S lift(float v, const Params&) { return {1, v, 0.f}; }
  __device__ static S merge(const S& a, const S& b, const Params&) {
    if (a.n == 0) return b;
    if (b.n == 0) return a;
    const int n = a.n + b.n;
    const float nf = (float)n;
    const float naf = (float)a.n;
    const float nbf = (float)b.n;
    const float delta = b.mean - a.mean;
    S r;
    r.n = n;
    r.mean = a.mean + delta * nbf / nf;
    r.m2 = a.m2 + b.m2 + delta * delta * naf * nbf / nf;
    return r;
  }
  __device__ static S load(const Table& t, long long s) {
    return {static_cast<const int*>(t.f[0])[s], static_cast<const float*>(t.f[1])[s],
            static_cast<const float*>(t.f[2])[s]};
  }
  __device__ static void store(const Table& t, long long s, const S& x) {
    static_cast<int*>(t.f[0])[s] = x.n;
    static_cast<float*>(t.f[1])[s] = x.mean;
    static_cast<float*>(t.f[2])[s] = x.m2;
  }
  __device__ static void emit(float* out[kOuts], int j, const S& pre, const S&, float v,
                              const Params&) {
    float z = 0.f;
    if (pre.n >= 2 && pre.m2 > 0.f) {
      const float denom = sqrtf(pre.m2 / fmaxf((float)pre.n - 1.f, 1.f));
      z = (v - pre.mean) / denom;
    }
    out[0][j] = z;
  }
};

struct EmaK {
  struct S {
    int n;
    float s;
  };
  static constexpr int kOuts = 1;
  __device__ static S identity() { return {0, 0.f}; }
  __device__ static S lift(float v, const Params& p) { return {1, p.alpha * v}; }
  __device__ static S merge(const S& a, const S& b, const Params& p) {
    const float decay = b.n > 0 ? expf((float)b.n * p.log_q) : 1.f;
    return {a.n + b.n, a.s * decay + b.s};
  }
  __device__ static S load(const Table& t, long long s) {
    return {static_cast<const int*>(t.f[0])[s], static_cast<const float*>(t.f[1])[s]};
  }
  __device__ static void store(const Table& t, long long s, const S& x) {
    static_cast<int*>(t.f[0])[s] = x.n;
    static_cast<float*>(t.f[1])[s] = x.s;
  }
  __device__ static void emit(float* out[kOuts], int j, const S&, const S& post, float,
                              const Params& p) {
    const float bias = -expm1f((float)post.n * p.log_q);
    out[0][j] = post.s / fmaxf(bias, kTiny);
  }
};

struct ExtremaK {
  struct S {
    float mn;
    float mx;
  };
  static constexpr int kOuts = 2;
  __device__ static S identity() { return {__int_as_float(0x7f800000), __int_as_float(0xff800000)}; }
  __device__ static S lift(float v, const Params&) { return {v, v}; }
  __device__ static S merge(const S& a, const S& b, const Params&) {
    return {nan_min(a.mn, b.mn), nan_max(a.mx, b.mx)};
  }
  __device__ static S load(const Table& t, long long s) {
    return {static_cast<const float*>(t.f[0])[s], static_cast<const float*>(t.f[1])[s]};
  }
  __device__ static void store(const Table& t, long long s, const S& x) {
    static_cast<float*>(t.f[0])[s] = x.mn;
    static_cast<float*>(t.f[1])[s] = x.mx;
  }
  __device__ static void emit(float* out[kOuts], int j, const S&, const S& post, float,
                              const Params&) {
    out[0][j] = post.mn;
    out[1][j] = post.mx;
  }
};

// A scan element: whether a segment head lies in its span, the in-batch
// state since the last head (or since the span's start), and the table
// state of that head's key.
template <class K>
struct Elem {
  int flag;
  typename K::S st;
  typename K::S carry;
};

template <class K>
__device__ __forceinline__ Elem<K> ident() {
  return {0, K::identity(), K::identity()};
}

template <class K>
__device__ __forceinline__ Elem<K> combine(const Elem<K>& a, const Elem<K>& b, const Params& p) {
  if (b.flag) return b;
  return {a.flag, K::merge(a.st, b.st, p), a.carry};
}

template <class T>
__device__ __forceinline__ T shfl_up(const T& x, int d) {
  static_assert(sizeof(T) % 4 == 0, "shuffled by 32-bit words");
  constexpr int kWords = sizeof(T) / 4;
  int w[kWords];
  memcpy(w, &x, sizeof(T));
#pragma unroll
  for (int k = 0; k < kWords; ++k) w[k] = __shfl_up_sync(kFull, w[k], d);
  T r;
  memcpy(&r, w, sizeof(T));
  return r;
}

template <class K>
__device__ __forceinline__ Elem<K> warp_incl_scan(Elem<K> x, const Params& p) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Elem<K> y = shfl_up(x, d);
    if (lane >= d) x = combine<K>(y, x, p);
  }
  return x;
}

// Exclusive scan of one element per thread, in thread order, across the
// block; *total gets the block's total.  Every thread must call it.
template <class K>
__device__ Elem<K> block_excl_scan(const Elem<K>& x, const Params& p, Elem<K>* sm, Elem<K>* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const Elem<K> incl = warp_incl_scan<K>(x, p);
  const Elem<K> before = shfl_up(incl, 1);
  if (lane == 31) sm[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    Elem<K> w = lane < kWarps ? sm[lane] : ident<K>();
    w = warp_incl_scan<K>(w, p);
    if (lane < kWarps) sm[lane] = w;
  }
  __syncthreads();
  Elem<K> prefix = warp > 0 ? sm[warp - 1] : ident<K>();
  if (lane > 0) prefix = combine<K>(prefix, before, p);
  *total = sm[kWarps - 1];
  __syncthreads();
  return prefix;
}

__device__ __forceinline__ bool valid_slot(int s, long long capacity) {
  return s >= 0 && (long long)s < capacity;
}

// Stage a tile's slots and values in shared memory, coalesced.
// s_slot[0] is the slot of the row before the tile (-1 at row 0) and
// s_slot[kTile + 1] the slot of the row after it (-1 past the end), so
// heads and tails at the tile's edges are found like any other.
__device__ __forceinline__ void stage(const int* slots, const float* vals, long long n,
                                      long long base, int* s_slot, float* s_val) {
  for (int k = threadIdx.x; k < kTile; k += kThreads) {
    const long long i = base + k;
    s_slot[k + 1] = i < n ? slots[i] : -1;
    s_val[k] = i < n ? vals[i] : 0.f;
  }
  if (threadIdx.x == 0) {
    s_slot[0] = base > 0 ? slots[base - 1] : -1;
    s_slot[kTile + 1] = base + kTile < n ? slots[base + kTile] : -1;
  }
  __syncthreads();
}

template <class K>
__global__ void __launch_bounds__(kThreads)
    scan_reduce(const int* __restrict__ slots, const float* __restrict__ vals, long long n, Table t,
                Params p, Elem<K>* __restrict__ aggs, long long* __restrict__ last_head) {
  __shared__ int s_slot[kTile + 2];
  __shared__ float s_val[kTile];
  __shared__ Elem<K> sm[kWarps];
  __shared__ long long s_head[kWarps];
  const long long base = (long long)blockIdx.x * kTile;
  stage(slots, vals, n, base, s_slot, s_val);

  Elem<K> acc = ident<K>();
  long long my_head = -1;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int k = threadIdx.x * kRows + r;
    if (base + k < n) {
      const bool head = s_slot[k + 1] != s_slot[k];
      const Elem<K> e = {head ? 1 : 0, K::lift(s_val[k], p), K::identity()};
      acc = combine<K>(acc, e, p);
      if (head) my_head = base + k;
    }
  }
  Elem<K> total;
  block_excl_scan<K>(acc, p, sm, &total);

  // The tile's last head: a max over the block.
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const long long other = __shfl_down_sync(kFull, my_head, d);
    my_head = other > my_head ? other : my_head;
  }
  if ((threadIdx.x & 31) == 0) s_head[threadIdx.x >> 5] = my_head;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long lh = -1;
    for (int w = 0; w < kWarps; ++w) lh = s_head[w] > lh ? s_head[w] : lh;
    if (lh >= 0) {
      const int s = s_slot[lh - base + 1];
      total.carry = valid_slot(s, t.capacity) ? K::load(t, s) : K::identity();
    }
    aggs[blockIdx.x] = total;
    last_head[blockIdx.x] = lh;
  }
}

template <class K>
__global__ void __launch_bounds__(kThreads)
    scan_carry(const Elem<K>* __restrict__ aggs, Elem<K>* __restrict__ carry_in, long long ntiles,
               Params p) {
  __shared__ Elem<K> sm[kWarps];
  Elem<K> running = ident<K>();
  for (long long c = 0; c < ntiles; c += kThreads) {
    const long long b = c + threadIdx.x;
    const Elem<K> x = b < ntiles ? aggs[b] : ident<K>();
    Elem<K> total;
    const Elem<K> ex = block_excl_scan<K>(x, p, sm, &total);
    if (b < ntiles) carry_in[b] = combine<K>(running, ex, p);
    running = combine<K>(running, total, p);
  }
}

template <class K>
__global__ void __launch_bounds__(kThreads)
    scan_apply(const int* __restrict__ slots, const float* __restrict__ vals, long long n, Table t,
               Outs outs, Params p, const Elem<K>* __restrict__ aggs,
               const Elem<K>* __restrict__ carry_in, const long long* __restrict__ last_head) {
  __shared__ int s_slot[kTile + 2];
  __shared__ float s_val[kTile];
  __shared__ float s_out[K::kOuts][kTile];
  __shared__ Elem<K> sm[kWarps];
  const long long base = (long long)blockIdx.x * kTile;
  stage(slots, vals, n, base, s_slot, s_val);
  const long long lh = last_head[blockIdx.x];

  // Phase A: every table read of this block (the heads' carries).
  typename K::S carry[kRows];
  Elem<K> acc = ident<K>();
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int k = threadIdx.x * kRows + r;
    carry[r] = K::identity();
    if (base + k < n) {
      const int s = s_slot[k + 1];
      const bool head = s != s_slot[k];
      if (head) {
        if (base + k == lh) {
          carry[r] = aggs[blockIdx.x].carry;
        } else if (valid_slot(s, t.capacity)) {
          carry[r] = K::load(t, s);
        }
      }
      const Elem<K> e = {head ? 1 : 0, K::lift(s_val[k], p), carry[r]};
      acc = combine<K>(acc, e, p);
    }
  }
  Elem<K> total;
  const Elem<K> ex = block_excl_scan<K>(acc, p, sm, &total);  // synchronises the block

  // Phase B: outputs, and the tails' write-back.
  Elem<K> run = combine<K>(carry_in[blockIdx.x], ex, p);
  float* out[K::kOuts];
#pragma unroll
  for (int c = 0; c < K::kOuts; ++c) out[c] = s_out[c];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int k = threadIdx.x * kRows + r;
    if (base + k < n) {
      const int s = s_slot[k + 1];
      const bool head = s != s_slot[k];
      const bool tail = s != s_slot[k + 2];
      const float v = s_val[k];
      const typename K::S x = K::lift(v, p);
      const typename K::S c = head ? carry[r] : run.carry;
      const typename K::S excl = head ? K::identity() : run.st;
      const typename K::S incl = head ? x : K::merge(run.st, x, p);
      const typename K::S pre = K::merge(c, excl, p);
      const typename K::S post = K::merge(c, incl, p);
      K::emit(out, k, pre, post, v, p);
      if (tail && valid_slot(s, t.capacity)) K::store(t, s, post);
      run = {run.flag | (head ? 1 : 0), incl, c};
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < kTile && base + k < n; k += kThreads) {
#pragma unroll
    for (int c = 0; c < K::kOuts; ++c) outs.o[c][base + k] = s_out[c][k];
  }
}

long long align16(long long x) { return (x + 15) & ~15LL; }

template <class K>
long long workspace_bytes(long long n) {
  const long long ntiles = (n + kTile - 1) / kTile;
  return 2 * align16(ntiles * (long long)sizeof(Elem<K>)) + align16(ntiles * 8);
}

template <class K>
int run(long long n, const int* slots, const float* vals, Table t, Outs o, Params p, void* ws,
        cudaStream_t stream) {
  const long long ntiles = (n + kTile - 1) / kTile;
  char* w = static_cast<char*>(ws);
  Elem<K>* aggs = reinterpret_cast<Elem<K>*>(w);
  w += align16(ntiles * (long long)sizeof(Elem<K>));
  Elem<K>* carry_in = reinterpret_cast<Elem<K>*>(w);
  w += align16(ntiles * (long long)sizeof(Elem<K>));
  long long* last_head = reinterpret_cast<long long*>(w);

  scan_reduce<K><<<(unsigned)ntiles, kThreads, 0, stream>>>(slots, vals, n, t, p, aggs, last_head);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_carry<K><<<1, kThreads, 0, stream>>>(aggs, carry_in, ntiles, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_apply<K><<<(unsigned)ntiles, kThreads, 0, stream>>>(slots, vals, n, t, o, p, aggs, carry_in,
                                                           last_head);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of device workspace one call over n rows needs (-1 for an
// unknown kind).
long long bw_segment_scan_workspace(int kind, long long n) {
  switch (kind) {
    case KIND_WELFORD:
      return workspace_bytes<WelfordK>(n);
    case KIND_EMA:
      return workspace_bytes<EmaK>(n);
    case KIND_EXTREMA:
      return workspace_bytes<ExtremaK>(n);
    default:
      return -1;
  }
}

// One segmented scan of n grouped (slot, value) rows of `kind` over a
// table of `capacity` slots (fields f0..f2 in the kind's field order),
// writing the kind's output columns o0 (and o1) and each segment's tail
// state back to the table.  Returns 0 or the first failed launch's CUDA
// error.
int bw_segment_scan(int kind, long long n, long long capacity, const int* slots,
                    const float* vals, void* f0, void* f1, void* f2, float* o0, float* o1,
                    float alpha, float log_q, void* workspace, void* stream) {
  if (n <= 0) return 0;
  const Table t = {{f0, f1, f2}, capacity};
  const Outs o = {{o0, o1}};
  const Params p = {alpha, log_q};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case KIND_WELFORD:
      return run<WelfordK>(n, slots, vals, t, o, p, workspace, s);
    case KIND_EMA:
      return run<EmaK>(n, slots, vals, t, o, p, workspace, s);
    case KIND_EXTREMA:
      return run<ExtremaK>(n, slots, vals, t, o, p, workspace, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
