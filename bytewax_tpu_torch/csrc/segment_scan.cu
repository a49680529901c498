// Segmented per-key scan for Hopper (sm_90a).
//
// Replaces the JAX package's jitted XLA programs bytewax_tpu/ops/scan.py
// `zscore_scan_body` (:234, the Welford z-score kind) and
// `generic_scan_body` (:152, the flagged segmented associative_scan, for
// the `Ema` and `RunningExtrema` kinds): fold a micro-batch of
// (slot, value) rows into a per-key state table and emit one output row
// per input row.
//
// Rows come grouped: every slot's rows are contiguous, so a segment is
// a run of equal slots.  For a row i of a segment whose key holds the
// table state C (the carry), with x the segment's lifted rows:
//   pre_i  = C ⊕ (x_head ⊕ ... ⊕ x_{i-1})   (the in-batch exclusive prefix)
//   post_i = C ⊕ (x_head ⊕ ... ⊕ x_i)       (the inclusive prefix)
// the kind emits from (pre, post, value), and the segment's tail writes
// post back to the table.  No other table entry is written.  This is the
// reference's formulation (`carry ⊕ excl`, `carry ⊕ incl`), so the
// carry enters once per row, as it does there.  (pre_i is post_{i-1}
// within a segment, bit for bit, and C at a head, so each row merges
// twice: one row into the in-batch prefix, then the carry.)
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
// Counts are int32 end to end; a float copy rides beside them for the
// arithmetic (an int-to-float conversion runs at an eighth of the rate
// of a float add).
//
// What bounds it: bytes.  Each row is read once (slot and value, 8 B),
// each output written once (4 B a row per column), and the table read
// at heads and written at tails (8-12 B a key each way): 12-16 B a row,
// 3.8-5.1 us per 2^20 rows at 3.35 TB/s.  The arithmetic (two merges a
// row, a reciprocal and a reciprocal square root for welford) is under
// that on paper; in practice the time goes to the latency of the chain
// each block walks (below), with four blocks an SM in one wave.
//
// Design: one launch per call, a single-pass scan with decoupled
// look-back (Merrill and Garland, 2016) over tiles of kTile = 2048 rows,
// 256 threads of kRows = 8 consecutive rows.  Scan elements are (flag,
// in-batch state, carry) under the segmented operator
//   (fa, sa, ca) . (fb, sb, cb) = (fa | fb, fb ? sb : sa ⊕ sb, fb ? cb : ca).
// Each block:
//   (a) claims the next tile from an atomic counter, so tiles start in
//       launch order and a block only ever waits on tiles already
//       running: the look-back cannot deadlock, however many tiles.  It
//       loads its rows once, straight into registers, with 16-byte
//       vector loads (scalar loads at a ragged end or a misaligned
//       pointer);
//   (b) copies the table state at every head into shared memory with
//       cp.async, which holds no register and lands while (c) runs;
//   (c) folds each thread's rows, then scans the block with warp
//       shuffles and one barrier (every warp scans the warps' totals
//       itself).  Its elements name the row of their last head instead
//       of carrying its state; the tile's aggregate takes the state of
//       its last head from shared memory;
//   (d) publishes the aggregate: as status A, or straight away as an
//       inclusive prefix P when the tile holds a head (a head discards
//       everything before it, so such a tile's aggregate is its
//       inclusive prefix);
//   (e) looks back over its predecessors with one warp, 32 status words
//       at a time, and stops at the first P (at the first tile that
//       holds a head, at the latest); then publishes P if it has not;
//   (f) scans the rows it holds from its prefix, writes the outputs
//       with vector stores, and writes each tail to the table.  A
//       thread past the tile's first head needs no prefix from the
//       look-back and starts (f) as soon as (c) is done.
// At 10,000 keys (about 105 rows a segment) every tile holds a head,
// publishes P at once, and looks back one tile.  Only a segment spanning
// many tiles (one key) walks further.
//
// Registers over TMA: the rows are used once each, by the thread that
// loads them, so a 1-D bulk copy would only add a round trip through
// shared memory and a barrier before the first row could be used.
//
// Measured (chip_smoke.py phase 7, NVIDIA H100 80GB HBM3, 700.00 W;
// device ms a call, warm / with the L2 flushed, against the byte bound):
//   welford, 2^20 rows, 10,000 keys   0.01363 / 0.01630   bound 0.00383
//   ema,     2^20 rows, 10,000 keys   0.01170 / 0.01416   bound 0.00380
//   extrema, 2^20 rows, 10,000 keys   0.01109 / 0.01397   bound 0.00506
//   welford, 2^20 rows, 662,843 keys  0.06350 / 0.07201   bound 0.00851
//   welford, 2^20 rows, one key       0.02244 / 0.02507   bound 0.00376
// So 2.2-7.5x the bound warm: a block's chain
// of dependent round trips (claim, rows, heads' states, look-back) sets
// the time at 10,000 keys and on one key; at 662,843 keys, six random
// 4-byte table accesses a row.  ptxas: 55, 64 and 64 registers (extrema,
// ema, welford; welford spills 64 bytes) under the bound of 64 that
// four 256-thread blocks an SM impose.
//
// Memory ordering.  A payload (up to 36 B) is wider than one atomic
// word, so the publisher writes it, then the 64-bit status word with
// st.release.gpu, whose release orders the payload's writes before it
// (the fence a __threadfence() would add again); a reader polls the
// word with ld.acquire.gpu and only then reads the payload (ld.cg, from
// L2).  A status word is (tag << 2 | state), state 1 = A, 2 = P.  The
// tag is the call's sequence number, kept on the card in the workspace
// header: each block reads it when it starts, and the block that
// finishes last bumps it and resets the tile counter.  So a status word
// from an earlier call is never read as current, with no memset between
// calls, back to back on one stream or replayed in a CUDA graph.  The
// workspace is zeroed once, when it is allocated.
//
// The table is race-free.  Every slot's rows are contiguous, so a slot
// has one segment per batch: its head is read in tile A and its tail
// written in tile B >= A.  Within a tile, every head's copy completes
// before the block's barrier and every tail is written after it.  Across
// tiles only the last head of A can have its tail in B > A; A reads it
// before it publishes any status, and the rows of B before B's first
// head are written only after B's look-back has passed every tile from
// B - 1 down to A, or down to a P that was published after such a
// look-back (release and acquire are cumulative).  So no table read
// races a write.
//
// The host wrapper (ops/scan_kernel.py) checks every argument, keeps the
// workspace (sized by bw_segment_scan_workspace) with the device, passes
// PyTorch's current stream and the device index, and raises on a
// non-zero return (the launch's cudaGetLastError()).  Nothing is
// allocated here.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;  // consecutive rows a thread
constexpr int kTile = kThreads * kRows;
constexpr int kWarps = kThreads / 32;
// Four blocks an SM hold a 2^20-row call (512 tiles) in one wave.
constexpr int kMinBlocks = 4;
constexpr int kVec = kRows / 4;  // 16-byte vectors a thread, per column
constexpr unsigned kFull = 0xffffffffu;
constexpr float kTiny = 1.17549435e-38f;  // FLT_MIN, jnp.finfo(f32).tiny
static_assert(kRows % 4 == 0, "rows a thread come in 16-byte vectors");
static_assert(kThreads % 32 == 0 && kThreads <= 1024, "whole warps");

enum { KIND_WELFORD = 0, KIND_EMA = 1, KIND_EXTREMA = 2 };
enum { ST_A = 1, ST_P = 2 };

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
  float q;  // expf(log_q), the decay of one row, computed on the card
};

// The workspace: a header, then one status word and two 48-byte
// payloads (aggregate, inclusive prefix) a tile.
struct Header {
  unsigned int next_tile;  // tiles claimed in this call
  unsigned int done;       // blocks finished in this call
  unsigned long long calls;  // calls finished; the current call's tag is calls + 1
};
constexpr long long kHeaderBytes = 128;
constexpr int kPayloadWords = 3;  // 16-byte words
struct Payload {
  int4 w[kPayloadWords];
};

struct Work {
  Header* hdr;
  unsigned long long* status;
  Payload* aggs;
  Payload* incls;
};

// Copy 4 bytes from device memory to shared memory without holding a
// register (cp.async); complete with cp_async_wait().
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_all;" ::: "memory"); }

__device__ __forceinline__ bool is_nan(float x) { return x != x; }
__device__ __forceinline__ float nan_min(float a, float b) {
  return is_nan(a) ? a : (is_nan(b) ? b : (b < a ? b : a));
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return is_nan(a) ? a : (is_nan(b) ? b : (b > a ? b : a));
}

// Each kind has:
//   S         the state; counts are int32 (n, exact past 2^24, what the
//             table holds) with a float copy (nf) for the arithmetic, so
//             no merge converts an int;
//   merge     the monoid; a merge with an empty side returns the other
//             side exactly;
//   push      merge(a, lift(v)) for one row, cheaper;
//   fetch     copy a slot's table row into shared memory (cp.async),
//             and fetched() to finish what was copied;
//   store     write a state back to the table;
//   emit      the outputs from the pre- and post-row states.
// Quotients use the fast reciprocal (__fdividef, 2 ulp): the states are
// held to the plain version at 1e-5 relative, the outputs at 1e-4.
struct WelfordK {
  struct S {
    int n;
    float nf;
    float mean;
    float m2;
  };
  static constexpr int kOuts = 1;
  static constexpr bool kUsesPre = true;
  __device__ static S identity() { return {0, 0.f, 0.f, 0.f}; }
  __device__ static S lift(float v, const Params&) { return {1, 1.f, v, 0.f}; }
  // Chan's merge, branch-free: the empty-side cases are selected at the
  // end, exactly as they came in.  Equal means give delta = 0, so m2
  // stays exactly 0 over runs of equal values.
  __device__ static S merge(const S& a, const S& b, const Params&) {
    const float nf = a.nf + b.nf;
    const float share = __fdividef(b.nf, fmaxf(nf, 1.f));
    const float delta = b.mean - a.mean;
    S r = {a.n + b.n, nf, a.mean + delta * share, a.m2 + b.m2 + delta * delta * a.nf * share};
    r = b.n == 0 ? a : r;
    return a.n == 0 ? b : r;
  }
  __device__ static S push(const S& a, float v, const Params& p) {
    const float nf = a.nf + 1.f;
    const float share = __fdividef(1.f, nf);
    const float delta = v - a.mean;
    const S r = {a.n + 1, nf, a.mean + delta * share, a.m2 + delta * delta * a.nf * share};
    return a.n == 0 ? lift(v, p) : r;
  }
  __device__ static void fetch(const Table& t, long long s, S* dst) {
    cp_async4(&dst->n, static_cast<const int*>(t.f[0]) + s);
    cp_async4(&dst->mean, static_cast<const float*>(t.f[1]) + s);
    cp_async4(&dst->m2, static_cast<const float*>(t.f[2]) + s);
  }
  __device__ static S fetched(S x) {
    x.nf = (float)x.n;
    return x;
  }
  __device__ static void store(const Table& t, long long s, const S& x) {
    static_cast<int*>(t.f[0])[s] = x.n;
    static_cast<float*>(t.f[1])[s] = x.mean;
    static_cast<float*>(t.f[2])[s] = x.m2;
  }
  __device__ static void emit(float* out, const S& pre, const S&, float v, const Params&) {
    const float z = (v - pre.mean) * rsqrtf(__fdividef(pre.m2, fmaxf(pre.nf - 1.f, 1.f)));
    out[0] = pre.n >= 2 && pre.m2 > 0.f ? z : 0.f;
  }
};

struct EmaK {
  struct S {
    int n;
    float nf;
    float s;
  };
  static constexpr int kOuts = 1;
  static constexpr bool kUsesPre = false;
  __device__ static S identity() { return {0, 0.f, 0.f}; }
  __device__ static S lift(float v, const Params& p) { return {1, 1.f, p.alpha * v}; }
  // q^n2 = exp(n2 * log1p(-alpha)), 1 for an empty right side (so alpha
  // = 1, log_q = -inf, never weighs 0 * -inf in).
  __device__ static S merge(const S& a, const S& b, const Params& p) {
    const float decay = expf(b.nf * p.log_q);
    return {a.n + b.n, a.nf + b.nf, a.s * (b.n > 0 ? decay : 1.f) + b.s};
  }
  // merge(a, lift(v)) with the decay of one row, q = expf(1 * log_q).
  __device__ static S push(const S& a, float v, const Params& p) {
    return {a.n + 1, a.nf + 1.f, a.s * p.q + p.alpha * v};
  }
  __device__ static void fetch(const Table& t, long long s, S* dst) {
    cp_async4(&dst->n, static_cast<const int*>(t.f[0]) + s);
    cp_async4(&dst->s, static_cast<const float*>(t.f[1]) + s);
  }
  __device__ static S fetched(S x) {
    x.nf = (float)x.n;
    return x;
  }
  __device__ static void store(const Table& t, long long s, const S& x) {
    static_cast<int*>(t.f[0])[s] = x.n;
    static_cast<float*>(t.f[1])[s] = x.s;
  }
  __device__ static void emit(float* out, const S&, const S& post, float, const Params& p) {
    const float bias = -expm1f(post.nf * p.log_q);
    out[0] = __fdividef(post.s, fmaxf(bias, kTiny));
  }
};

struct ExtremaK {
  struct S {
    float mn;
    float mx;
  };
  static constexpr int kOuts = 2;
  static constexpr bool kUsesPre = false;
  __device__ static S identity() { return {__int_as_float(0x7f800000), __int_as_float(0xff800000)}; }
  __device__ static S lift(float v, const Params&) { return {v, v}; }
  __device__ static S merge(const S& a, const S& b, const Params&) {
    return {nan_min(a.mn, b.mn), nan_max(a.mx, b.mx)};
  }
  __device__ static S push(const S& a, float v, const Params& p) { return merge(a, lift(v, p), p); }
  __device__ static void fetch(const Table& t, long long s, S* dst) {
    cp_async4(&dst->mn, static_cast<const float*>(t.f[0]) + s);
    cp_async4(&dst->mx, static_cast<const float*>(t.f[1]) + s);
  }
  __device__ static S fetched(S x) { return x; }
  __device__ static void store(const Table& t, long long s, const S& x) {
    static_cast<float*>(t.f[0])[s] = x.mn;
    static_cast<float*>(t.f[1])[s] = x.mx;
  }
  __device__ static void emit(float* out, const S&, const S& post, float, const Params&) {
    out[0] = post.mn;
    out[1] = post.mx;
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
  const Elem<K> r = {a.flag, K::merge(a.st, b.st, p), a.carry};
  return b.flag ? b : r;
}

// The element of a block's own scan: as Elem, but naming the tile row
// of its last head, whose table state waits in shared memory.
template <class K>
struct Part {
  int flag;
  int head;
  typename K::S st;
};

template <class K>
__device__ __forceinline__ Part<K> combine(const Part<K>& a, const Part<K>& b, const Params& p) {
  const Part<K> r = {a.flag, a.head, K::merge(a.st, b.st, p)};
  return b.flag ? b : r;
}

// A struct shuffled across the warp 32 bits at a time by `shfl`.
template <class T, class F>
__device__ __forceinline__ T shuffled(const T& x, F shfl) {
  static_assert(sizeof(T) % 4 == 0, "shuffled by 32-bit words");
  constexpr int kWords = sizeof(T) / 4;
  int w[kWords];
  memcpy(w, &x, sizeof(T));
#pragma unroll
  for (int k = 0; k < kWords; ++k) w[k] = shfl(w[k]);
  T r;
  memcpy(&r, w, sizeof(T));
  return r;
}

template <class T>
__device__ __forceinline__ T shfl_up(const T& x, int d) {
  return shuffled(x, [d](int v) { return __shfl_up_sync(kFull, v, d); });
}

template <class T>
__device__ __forceinline__ T shfl_down(const T& x, int d) {
  return shuffled(x, [d](int v) { return __shfl_down_sync(kFull, v, d); });
}

template <class T>
__device__ __forceinline__ T shfl_idx(const T& x, int src) {
  return shuffled(x, [src](int v) { return __shfl_sync(kFull, v, src); });
}

// Inclusive scan over the first kWidth lanes of a warp.
template <int kWidth = 32, class E>
__device__ __forceinline__ E warp_incl_scan(E x, const Params& p) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < kWidth; d <<= 1) {
    const E y = shfl_up(x, d);
    if (lane >= d) x = combine(y, x, p);
  }
  return x;
}

// Exclusive scan of one element per thread, in thread order, across the
// block, with one barrier: every warp scans the warps' totals itself.
// *total gets the block's total.  Every thread must call it, and
// `before_barrier` runs just before the barrier.
template <class E, class F>
__device__ E block_excl_scan(const E& x, const E& id, const Params& p, E* sm, E* total,
                             F before_barrier) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const E incl = warp_incl_scan(x, p);
  const E before = shfl_up(incl, 1);
  if (lane == 31) sm[warp] = incl;
  before_barrier();
  __syncthreads();
  E w = lane < kWarps ? sm[lane] : id;
  w = warp_incl_scan<kWarps>(w, p);
  const E wprefix = shfl_idx(w, warp > 0 ? warp - 1 : 0);
  *total = shfl_idx(w, kWarps - 1);
  E prefix = warp > 0 ? wprefix : id;
  if (lane > 0) prefix = combine(prefix, before, p);
  return prefix;
}

__device__ __forceinline__ bool valid_slot(int s, long long capacity) {
  return s >= 0 && (long long)s < capacity;
}

__device__ __forceinline__ unsigned long long ld_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

template <class K>
__device__ __forceinline__ void put_payload(Payload* dst, const Elem<K>& e) {
  static_assert(sizeof(Elem<K>) <= sizeof(Payload), "a scan element fits its payload");
  Payload q = {};
  memcpy(&q, &e, sizeof(Elem<K>));
#pragma unroll
  for (int k = 0; k < kPayloadWords; ++k) __stcg(&dst->w[k], q.w[k]);
}

template <class K>
__device__ __forceinline__ Elem<K> get_payload(const Payload* src) {
  Payload q;
#pragma unroll
  for (int k = 0; k < kPayloadWords; ++k) q.w[k] = __ldcg(&src->w[k]);
  Elem<K> e;
  memcpy(&e, &q, sizeof(Elem<K>));
  return e;
}

// Publish a tile's payload, then its status word (one thread).  The
// release store is the fence: it orders the payload's writes before it.
template <class K>
__device__ __forceinline__ void publish(unsigned long long* status, Payload* slot, const Elem<K>& e,
                                        unsigned long long tag, int state) {
  put_payload<K>(slot, e);
  st_release(status, (tag << 2) | (unsigned long long)state);
}

// The exclusive prefix of `tile` (> 0), read back from its predecessors'
// statuses by one warp; valid in lane 0.  Lane j reads tile top - j of
// each window of 32; the walk ends at the first P.  A tile whose
// aggregate holds a head publishes it as P at once (its element absorbs
// everything before it), so the walk also ends at the first such tile.
template <class K>
__device__ Elem<K> look_back(const Work& w, long long tile, unsigned long long tag, const Params& p) {
  const int lane = threadIdx.x & 31;
  Elem<K> acc = ident<K>();
  for (long long top = tile - 1;; top -= 32) {
    const long long idx = top - lane;
    int state = ST_P;  // before tile 0: nothing, as if an identity prefix
    unsigned stops, need;
    for (int spins = 0;; ++spins) {
      if (idx >= 0) {
        const unsigned long long word = ld_acquire(&w.status[idx]);
        state = (word >> 2) == tag ? (int)(word & 3) : 0;
      }
      stops = __ballot_sync(kFull, state == ST_P);
      const unsigned waiting = __ballot_sync(kFull, state == 0);
      // Lanes up to the first stop (every lane if there is none).
      need = stops ? ((stops & (0u - stops)) << 1) - 1u : kFull;
      if (!(waiting & need)) break;
      if (spins > 4) __nanosleep(64);
    }
    Elem<K> e = ident<K>();
    if (((need >> lane) & 1u) && idx >= 0) {
      e = get_payload<K>(state == ST_P ? &w.incls[idx] : &w.aggs[idx]);
    }
    // Higher lanes hold older tiles: lane j folds in lane j + d from
    // the left.  Lanes past the needed ones hold the identity.  When the
    // nearest tile is the stop (every tile holds a head), lane 0 has it.
    if (need != 1u) {
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const Elem<K> older = shfl_down(e, d);
        if (lane + d < 32) e = combine<K>(older, e, p);
      }
    }
    acc = combine<K>(e, acc, p);
    if (stops) return acc;
  }
}

// A thread's kRows rows from `first`: 16-byte vector loads, or scalar
// loads at a ragged end or a misaligned pointer (-1 slots past the end).
__device__ __forceinline__ void load_rows(const int* __restrict__ slots,
                                          const float* __restrict__ vals, long long n,
                                          long long first, int vec, int* s, float* v) {
  if (vec && first + kRows <= n) {
    const int4* sp = reinterpret_cast<const int4*>(slots + first);
    const float4* vp = reinterpret_cast<const float4*>(vals + first);
#pragma unroll
    for (int q = 0; q < kVec; ++q) {
      const int4 a = __ldg(sp + q);
      const float4 b = __ldg(vp + q);
      s[4 * q] = a.x, s[4 * q + 1] = a.y, s[4 * q + 2] = a.z, s[4 * q + 3] = a.w;
      v[4 * q] = b.x, v[4 * q + 1] = b.y, v[4 * q + 2] = b.z, v[4 * q + 3] = b.w;
    }
  } else {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const long long i = first + r;
      s[r] = i < n ? __ldg(slots + i) : -1;
      v[r] = i < n ? __ldg(vals + i) : 0.f;
    }
  }
}

template <class K>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    scan_onepass(const int* __restrict__ slots, const float* __restrict__ vals, long long n,
                 unsigned int ntiles, Table t, Outs outs, Params p, Work w, int vec) {
  using S = typename K::S;
  __shared__ S s_carry[kTile];  // the table state at each head of the tile
  __shared__ Part<K> sm[kWarps];
  __shared__ Elem<K> s_prefix;
  __shared__ int s_ready;  // s_prefix holds the tile's exclusive prefix
  __shared__ unsigned int s_tile;
  __shared__ unsigned long long s_tag;
  const int lane = threadIdx.x & 31;
  p.q = expf(p.log_q);
  if (threadIdx.x == 0) {
    s_ready = 0;
    s_tile = atomicAdd(&w.hdr->next_tile, 1u);
    s_tag = __ldcg(&w.hdr->calls) + 1;
  }
  __syncthreads();
  const unsigned int tile = s_tile;
  const unsigned long long tag = s_tag;
  const int row0 = threadIdx.x * kRows;  // the thread's first row in the tile
  const long long first = (long long)tile * kTile + row0;

  // (a) The thread's rows, once, into registers.
  int s[kRows];
  float v[kRows];
  load_rows(slots, vals, n, first, vec, s, v);
  const bool whole = vec && first + kRows <= n;
  // The slots just before and after the thread's rows (-1 before row 0
  // and past the end), so heads and tails at its edges are found like
  // any other.
  int before = __shfl_up_sync(kFull, s[kRows - 1], 1);
  int after = __shfl_down_sync(kFull, s[0], 1);
  if (lane == 0) before = first > 0 && first - 1 < n ? __ldg(slots + first - 1) : -1;
  if (lane == 31) after = first + kRows < n ? __ldg(slots + first + kRows) : -1;

  // (b) Every table read of this block: the heads' states, copied into
  // shared memory while the fold and the warp scan run.
  unsigned heads = 0, tails = 0;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const bool live = first + r < n;
    const int prev = r > 0 ? s[r - 1] : before;
    const int next = r + 1 < kRows ? s[r + 1] : after;
    const bool head = live && s[r] != prev;
    if (head) {
      heads |= 1u << r;
      if (valid_slot(s[r], t.capacity)) {
        K::fetch(t, s[r], &s_carry[row0 + r]);
      } else {
        s_carry[row0 + r] = K::identity();
      }
    }
    if (live && s[r] != next) tails |= 1u << r;
  }

  // (c) The thread's fold, then the block's scan and the tile aggregate.
  Part<K> mine = {0, 0, K::identity()};
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (first + r >= n) continue;
    const bool head = (heads >> r) & 1u;
    const S pushed = K::push(mine.st, v[r], p);
    mine.st = head ? K::lift(v[r], p) : pushed;
    mine.head = head ? row0 + r : mine.head;
    mine.flag |= head;
  }
  Part<K> total;
  const Part<K> ex = block_excl_scan(mine, Part<K>{0, 0, K::identity()}, p, sm, &total,
                                     [] { cp_async_wait(); });

  // (d) and (e): publish, look back, publish the inclusive prefix.
  if (threadIdx.x < 32) {
    const Elem<K> agg = {total.flag, total.st,
                         total.flag ? K::fetched(s_carry[total.head]) : K::identity()};
    Elem<K> prefix = ident<K>();
    if (tile == 0) {
      if (lane == 0) publish<K>(&w.status[0], &w.incls[0], agg, tag, ST_P);
    } else {
      if (lane == 0) {
        if (agg.flag) {
          publish<K>(&w.status[tile], &w.incls[tile], agg, tag, ST_P);
        } else {
          publish<K>(&w.status[tile], &w.aggs[tile], agg, tag, ST_A);
        }
      }
      prefix = look_back<K>(w, tile, tag, p);
      if (lane == 0 && !agg.flag) {
        publish<K>(&w.status[tile], &w.incls[tile], combine<K>(prefix, agg, p), tag, ST_P);
      }
    }
    if (lane == 0) {
      s_prefix = prefix;
      __threadfence_block();
      *(volatile int*)&s_ready = 1;
    }
    __syncwarp();
  }

  // (f) The rows, from the thread's prefix; outputs and tails.  A thread
  // past the tile's first head needs no prefix (its segments' heads were
  // read in this tile, before the barrier) and starts at once; the
  // others wait for warp 0's look-back.
  S c, st;
  if (ex.flag) {
    c = K::fetched(s_carry[ex.head]);
    st = ex.st;
  } else {
    while (*(volatile int*)&s_ready == 0) __nanosleep(32);
    __threadfence_block();
    c = s_prefix.carry;
    st = K::merge(s_prefix.st, ex.st, p);
  }
  S last = K::kUsesPre ? K::merge(c, st, p) : K::identity();  // pre of a first row that is no head
  float o[K::kOuts][kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (first + r >= n) continue;
    const bool head = (heads >> r) & 1u;
    const S pushed = K::push(st, v[r], p);
    if (head) c = K::fetched(s_carry[row0 + r]);
    st = head ? K::lift(v[r], p) : pushed;
    const S pre = head ? c : last;
    const S post = K::merge(c, st, p);
    float e[K::kOuts];
    K::emit(e, pre, post, v[r], p);
#pragma unroll
    for (int k = 0; k < K::kOuts; ++k) o[k][r] = e[k];
    if (((tails >> r) & 1u) && valid_slot(s[r], t.capacity)) K::store(t, s[r], post);
    last = post;
  }
#pragma unroll
  for (int k = 0; k < K::kOuts; ++k) {
    if (whole) {
      float4* op = reinterpret_cast<float4*>(outs.o[k] + first);
#pragma unroll
      for (int q = 0; q < kVec; ++q) {
        op[q] = make_float4(o[k][4 * q], o[k][4 * q + 1], o[k][4 * q + 2], o[k][4 * q + 3]);
      }
    } else {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (first + r < n) outs.o[k][first + r] = o[k][r];
      }
    }
  }

  // The block that finishes last closes the call: every block has
  // claimed its tile and read the tag by then.
  if (threadIdx.x == 0 && atomicAdd(&w.hdr->done, 1u) == ntiles - 1) {
    w.hdr->next_tile = 0;
    w.hdr->done = 0;
    w.hdr->calls = tag;
  }
}

long long ntiles_of(long long n) { return (n + kTile - 1) / kTile; }

long long align128(long long x) { return (x + 127) & ~127LL; }

Work carve(void* ws, long long ntiles) {
  char* b = static_cast<char*>(ws);
  Work w;
  w.hdr = reinterpret_cast<Header*>(b);
  b += kHeaderBytes;
  w.status = reinterpret_cast<unsigned long long*>(b);
  b += align128(ntiles * 8);
  w.aggs = reinterpret_cast<Payload*>(b);
  b += align128(ntiles * (long long)sizeof(Payload));
  w.incls = reinterpret_cast<Payload*>(b);
  return w;
}

template <class K>
int run(long long n, const int* slots, const float* vals, Table t, Outs o, Params p, void* ws,
        cudaStream_t stream) {
  const long long ntiles = ntiles_of(n);
  if (ntiles >= (1LL << 32)) return (int)cudaErrorInvalidValue;
  uintptr_t bits = (uintptr_t)slots | (uintptr_t)vals | (uintptr_t)o.o[0];
  if (K::kOuts > 1) bits |= (uintptr_t)o.o[1];
  const int vec = (bits & 15) == 0;
  scan_onepass<K><<<(unsigned)ntiles, kThreads, 0, stream>>>(slots, vals, n, (unsigned)ntiles, t, o,
                                                             p, carve(ws, ntiles), vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of device workspace one call over n rows needs (the same for
// every kind; -1 for an unknown kind).  It must be zeroed once, when it
// is allocated, and may then serve any number of calls of any kind and
// size up to n, issued in order on one stream.
long long bw_segment_scan_workspace(int kind, long long n) {
  if (kind < KIND_WELFORD || kind > KIND_EXTREMA) return -1;
  const long long ntiles = ntiles_of(n > 0 ? n : 1);
  return kHeaderBytes + align128(ntiles * 8) + 2 * align128(ntiles * (long long)sizeof(Payload));
}

// One segmented scan of n grouped (slot, value) rows of `kind` over a
// table of `capacity` slots (fields f0..f2 in the kind's field order),
// writing the kind's output columns o0 (and o1) and each segment's tail
// state back to the table, launched on `stream` of CUDA device
// `device`.  Returns 0 or the launch's CUDA error.
int bw_segment_scan(int kind, long long n, long long capacity, const int* slots,
                    const float* vals, void* f0, void* f1, void* f2, float* o0, float* o1,
                    float alpha, float log_q, void* workspace, void* stream, int device) {
  if (n <= 0) return 0;
  const Table t = {{f0, f1, f2}, capacity};
  const Outs o = {{o0, o1}};
  const Params p = {alpha, log_q, 0.f};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return (int)err;
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess) return (int)err;
  int ret;
  switch (kind) {
    case KIND_WELFORD:
      ret = run<WelfordK>(n, slots, vals, t, o, p, workspace, s);
      break;
    case KIND_EMA:
      ret = run<EmaK>(n, slots, vals, t, o, p, workspace, s);
      break;
    case KIND_EXTREMA:
      ret = run<ExtremaK>(n, slots, vals, t, o, p, workspace, s);
      break;
    default:
      ret = (int)cudaErrorInvalidValue;
  }
  if (current != device) cudaSetDevice(current);
  return ret;
}

}  // extern "C"
