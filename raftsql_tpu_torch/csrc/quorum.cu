// Quorum-commit kernels for Hopper (sm_90a): the Phase-7 commit advance of
// the fused raft tick under commit_rule="pallas".
//
// quorum_commit<false, P> (K1) replaces the Pallas kernel `_kernel` behind
// raftsql_tpu/ops/pallas_quorum.py:pallas_quorum_commit_index;
// quorum_commit<true, P> (K2) replaces `_masked_kernel` behind
// pallas_masked_quorum_commit_index.
//
// What they compute, per row r (the wrapper folds the P peer rows of the
// fused tick into the row axis, so one launch covers all P x G rows):
//   cand   = max(0, max { m_i : #{j : m_j >= m_i} >= q })
//            the q-th largest match value by the O(P^2) count. K2 counts
//            voters only, with q = popcount/2 + 1 (or the flexible `size`
//            on a full mask), takes the min over the two joint masks, and
//            gives 0 for an empty mask;
//   ct     = log_term[r, (cand - 1) mod W] if 1 <= cand <= log_len, else 0;
//   out[r] = cand if the row leads, ct == term and cand > commit, else
//            commit.
//
// Bound: memory, and only a leader row needs more than its own columns. A
// follower's answer is its commit: it reads is_leader and commit and
// writes out (9 bytes). A leader also reads its match row (4P bytes; K2
// adds 2P mask bytes), log_len and term, and, only when its candidate is
// in range and above commit, one ring word: a random 32-byte sector of the
// row's 4W-byte ring. On the fused tick 1 row in P leads. The P^2 compares
// of a leader row are far below the card's integer rate.
//
// Design:
//   - A warp owns 32 consecutive rows and syncs only itself (no block-wide
//     barrier). Every lane loads its is_leader and commit (coalesced); a
//     leader issues its log_len and term loads at once, so they are in
//     flight before the dependent ring read. A warp with no leader writes
//     commit and is done: it never touches match, the masks or the ring.
//   - Otherwise the warp stages its match tile (32 x P int32, contiguous in
//     memory) and K2's two mask tiles (32 x P bytes) into shared memory
//     with 16-byte loads, all issued before the first store; a misaligned
//     base and the ragged tail of the last warp take element loads. Each
//     leader lane then reads its row from shared memory; at an odd P the
//     P-word stride is free of bank conflicts.
//   - For the peer counts that `launch` instantiates (3, 5, 15: the raft
//     sizes the repo runs) the row lives in registers and the count
//     network is fully unrolled; K2 packs each mask row into one 32-bit
//     word and counts voters with __popc. Any other P takes
//     quorum_commit<Masked, 0>, which stages with element loads at a row
//     stride rounded up to odd (an even P would put every lane's row in
//     one bank), loops over the row, and counts mask bytes: exact for
//     every P. When one warp's tile exceeds the default 48 KB of shared
//     memory (K1 from P = 384, K2 from P = 256) it reads the rows from
//     device memory instead.
//   - The ring word is read only by a leader whose candidate is in range
//     and above commit. An out-of-range candidate has term 0, and that 0 is
//     still compared with term: it decides a row whose term is 0.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;                       // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr size_t kSmemDefault = 48 * 1024;      // a block's, no opt-in
constexpr int kMaxRows = 0x7fffffff - kThreads;  // row indices stay int

struct Rows {
  const int* match;            // [R, P]
  const uint8_t* voters;       // [R, P] (K2)
  const uint8_t* voters_joint;  // [R, P] (K2)
  const int* log_term;         // [R, W]
  const int* log_len;          // [R]
  const int* commit;           // [R]
  const int* term;             // [R]
  const uint8_t* is_leader;    // [R]
  int* out;                    // [R]
  int R, P, W;
  int quorum;    // K1: the quorum; K2: the flexible write size
  int has_size;  // K2: 1 if `quorum` holds a size, 0 for a majority
  int staged;    // 1: rows are read from shared memory
};

// Bytes of shared memory per row: match, then (K2) the two mask bytes.
template <bool Masked>
__host__ __device__ constexpr int row_bytes(int P) {
  return P * (Masked ? 6 : 4);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Copy a tile of n elements, contiguous in device memory, into shared
// memory with each row of P elements at a stride of S. Element loads,
// coalesced across lanes; the loop stays rolled (ptxas, left to unroll it,
// spilled registers).
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* __restrict__ src,
                                           int n, int P, int S, int lane) {
#pragma unroll 1
  for (int k = lane; k < n; k += 32) {
    const int row = k / P;
    dst[row * S + (k - row * P)] = __ldg(src + k);
  }
}

// The fixed-P kernels' staging of a full warp's tiles with 16-byte loads,
// every load issued before the first store, so K2's match and mask loads
// are in flight together (a store waits for its load; copying tile after
// tile would put three memory round trips in a row). The ragged last warp
// and a misaligned base take stage_rows().
template <bool Masked, int kP>
__device__ __forceinline__ void stage_fixed(int* mt, uint8_t* vt, uint8_t* jt,
                                            const int* m, const uint8_t* v,
                                            const uint8_t* j, int n,
                                            int lane) {
  constexpr int kM = 8 * kP, kV = 2 * kP;  // int4 in a match / mask tile
  constexpr int TM = (kM + 31) / 32, TV = (kV + 31) / 32;
  if (n != 32 * kP || !aligned16(m) ||
      (Masked && !(aligned16(v) && aligned16(j)))) {
    stage_rows(mt, m, n, kP, kP, lane);
    if constexpr (Masked) {
      stage_rows(vt, v, n, kP, kP, lane);
      stage_rows(jt, j, n, kP, kP, lane);
    }
    return;
  }
  int4 rm[TM];
#pragma unroll
  for (int t = 0; t < TM; ++t)
    if (lane + 32 * t < kM)
      rm[t] = __ldg(reinterpret_cast<const int4*>(m) + lane + 32 * t);
  if constexpr (Masked) {
    int4 rv[TV], rj[TV];
#pragma unroll
    for (int t = 0; t < TV; ++t)
      if (lane + 32 * t < kV) {
        rv[t] = __ldg(reinterpret_cast<const int4*>(v) + lane + 32 * t);
        rj[t] = __ldg(reinterpret_cast<const int4*>(j) + lane + 32 * t);
      }
#pragma unroll
    for (int t = 0; t < TV; ++t)
      if (lane + 32 * t < kV) {
        reinterpret_cast<int4*>(vt)[lane + 32 * t] = rv[t];
        reinterpret_cast<int4*>(jt)[lane + 32 * t] = rj[t];
      }
  }
#pragma unroll
  for (int t = 0; t < TM; ++t)
    if (lane + 32 * t < kM) reinterpret_cast<int4*>(mt)[lane + 32 * t] = rm[t];
}

// K1's count, unrolled: the row in registers.
template <int P>
__device__ __forceinline__ int cand_fixed(const int* row, int quorum) {
  int m[P];
#pragma unroll
  for (int i = 0; i < P; ++i) m[i] = row[i];
  int cand = 0;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < P; ++j) cnt += m[j] >= m[i];
    if (cnt >= quorum && m[i] > cand) cand = m[i];
  }
  return cand;
}

// K2's count, unrolled: the masks packed into words, voters by __popc.
template <int P>
__device__ __forceinline__ int masked_cand_fixed(const int* row,
                                                 const uint8_t* vrow,
                                                 const uint8_t* jrow,
                                                 int size, int has_size) {
  static_assert(P <= 32, "one 32-bit word per mask");
  int m[P];
  unsigned vm = 0, jm = 0;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    m[i] = row[i];
    vm |= unsigned(vrow[i] != 0) << i;
    jm |= unsigned(jrow[i] != 0) << i;
  }
  const int nv = __popc(vm), nj = __popc(jm);
  const int need_v = has_size && nv == P ? size : nv / 2 + 1;
  const int need_j = has_size && nj == P ? size : nj / 2 + 1;
  int cv = 0, cj = 0;  // an empty mask leaves 0
#pragma unroll
  for (int i = 0; i < P; ++i) {
    unsigned ge = 0;
#pragma unroll
    for (int j = 0; j < P; ++j) ge |= unsigned(m[j] >= m[i]) << j;
    if ((vm >> i & 1) && __popc(ge & vm) >= need_v && m[i] > cv) cv = m[i];
    if ((jm >> i & 1) && __popc(ge & jm) >= need_j && m[i] > cj) cj = m[i];
  }
  return min(cv, cj);  // joint consensus: both masks must agree
}

// The generic counts, looped over the row wherever it lies.
__device__ __forceinline__ int cand_any(const int* row, int P, int quorum) {
  int cand = 0;
  for (int i = 0; i < P; ++i) {
    const int mi = row[i];
    if (mi <= cand) continue;
    int cnt = 0;
    for (int j = 0; j < P; ++j) cnt += row[j] >= mi;
    if (cnt >= quorum) cand = mi;
  }
  return cand;
}

__device__ __forceinline__ int masked_cand_any(const int* row,
                                               const uint8_t* mask, int P,
                                               int size, int has_size) {
  int nv = 0;
  for (int i = 0; i < P; ++i) nv += mask[i] != 0;
  const int need = has_size && nv == P ? size : nv / 2 + 1;
  int cand = 0;
  for (int i = 0; i < P; ++i) {
    const int mi = row[i];
    if (!mask[i] || mi <= cand) continue;
    int cnt = 0;
    for (int j = 0; j < P; ++j) cnt += (mask[j] != 0) & (row[j] >= mi);
    if (cnt >= need) cand = mi;
  }
  return cand;
}

// cand's term check against the post-append ring: the one dependent read.
__device__ __forceinline__ int advance(int cand, int commit, int log_len,
                                       int term, const int* ring, int W) {
  if (cand <= commit) return commit;
  int ct = 0;
  if (cand >= 1 && cand <= log_len)
    ct = __ldg(ring + (cand - 1) % W);  // cand - 1 >= 0: % is the floor mod
  return ct == term ? cand : commit;
}

// kP > 0: P is kP, fixed at compile time; kP == 0: P is a.P (generic).
template <bool Masked, int kP>
__global__ void __launch_bounds__(kThreads) quorum_commit(Rows a) {
  extern __shared__ int4 dyn_smem[];
  const int P = kP > 0 ? kP : a.P;
  const int warps = kP > 0 ? kWarps : blockDim.x >> 5;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = (blockIdx.x * warps + warp) * 32;  // R < kMaxRows
  if (row0 >= a.R) return;
  const int r = row0 + lane;
  const bool in = r < a.R;
  const bool lead = in && __ldg(a.is_leader + r) != 0;
  int commit = 0, log_len = 0, term = 0;
  if (in) commit = __ldg(a.commit + r);
  if (lead) {
    log_len = __ldg(a.log_len + r);
    term = __ldg(a.term + r);
  }
  int res = commit;
  if (__any_sync(kFull, lead)) {
    const int64_t off = (int64_t)row0 * P;
    const int* m = a.match + off;
    const uint8_t* v = nullptr;
    const uint8_t* j = nullptr;
    if constexpr (Masked) {
      v = a.voters + off;
      j = a.voters_joint + off;
    }
    int S = P;  // the row stride of the rows read below
    if (kP > 0 || a.staged) {
      // Layout: every warp's match tile, then the voter tiles, then the
      // joint tiles; each tile is a multiple of 16 bytes.
      uint8_t* base;
      if constexpr (kP > 0) {
        __shared__ int4 tiles[kWarps * 32 * row_bytes<Masked>(kP) / 16];
        base = reinterpret_cast<uint8_t*>(tiles);
      } else {
        base = reinterpret_cast<uint8_t*>(dyn_smem);
      }
      if (kP == 0) S = P | 1;
      const int tile = 32 * S;
      const int left = a.R - row0;
      const int n = (left < 32 ? left : 32) * P;
      int* mt = reinterpret_cast<int*>(base) + warp * tile;
      uint8_t* vt = nullptr;
      uint8_t* jt = nullptr;
      if constexpr (Masked) {
        vt = base + 4 * warps * tile + warp * tile;
        jt = vt + warps * tile;
      }
      if constexpr (kP > 0) {
        stage_fixed<Masked, kP>(mt, vt, jt, m, v, j, n, lane);
      } else {
        stage_rows(mt, m, n, P, S, lane);
        if constexpr (Masked) {
          stage_rows(vt, v, n, P, S, lane);
          stage_rows(jt, j, n, P, S, lane);
        }
      }
      m = mt;
      v = vt;
      j = jt;
      __syncwarp();
    }
    if (lead) {
      const int64_t o = (int64_t)lane * S;
      int cand;
      if constexpr (Masked && kP > 0) {
        cand = masked_cand_fixed<kP>(m + o, v + o, j + o, a.quorum,
                                     a.has_size);
      } else if constexpr (Masked) {
        cand = min(masked_cand_any(m + o, v + o, P, a.quorum, a.has_size),
                   masked_cand_any(m + o, j + o, P, a.quorum, a.has_size));
      } else if constexpr (kP > 0) {
        cand = cand_fixed<kP>(m + o, a.quorum);
      } else {
        cand = cand_any(m + o, P, a.quorum);
      }
      res = advance(cand, commit, log_len, term,
                    a.log_term + (int64_t)r * a.W, a.W);
    }
  }
  if (in) a.out[r] = res;
}

// The generic kernel's launch: as many warps a block (up to kWarps) as the
// default shared memory holds, and rows straight from device memory when
// not even one warp's tile fits.
template <bool Masked>
cudaError_t launch_any(Rows a, cudaStream_t stream) {
  const size_t per_warp = (size_t)32 * row_bytes<Masked>(a.P | 1);
  size_t warps = kSmemDefault / per_warp;
  a.staged = warps > 0;
  warps = !a.staged ? kWarps : warps > (size_t)kWarps ? kWarps : warps;
  const size_t smem = a.staged ? warps * per_warp : 0;
  const int64_t rows = 32 * (int64_t)warps;
  const unsigned blocks = (unsigned)((a.R + rows - 1) / rows);
  quorum_commit<Masked, 0>
      <<<blocks, (unsigned)(32 * warps), smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool Masked>
int launch(Rows a, cudaStream_t stream) {
  if (a.R <= 0) return 0;
  if (a.R > kMaxRows) return (int)cudaErrorInvalidValue;
  a.staged = 1;
  const unsigned blocks =
      (unsigned)(((int64_t)a.R + kThreads - 1) / kThreads);
#define RAFTSQL_CASE(N) \
  case N:               \
    quorum_commit<Masked, N><<<blocks, kThreads, 0, stream>>>(a); break;
  // The raft sizes the repo runs: 3 (the default), 5 and 15.
  switch (a.P) {
    RAFTSQL_CASE(3)
    RAFTSQL_CASE(5)
    RAFTSQL_CASE(15)
    default:
      return (int)launch_any<Masked>(a, stream);
  }
#undef RAFTSQL_CASE
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes. Each launcher returns the
// cudaGetLastError() code right after its launch (0 = cudaSuccess).
extern "C" {

int raftsql_quorum_commit(const int* match, const int* log_term,
                          const int* log_len, const int* commit,
                          const int* term, const uint8_t* is_leader,
                          int* out, int R, int P, int W, int quorum,
                          cudaStream_t stream) {
  Rows a{match, nullptr, nullptr, log_term, log_len, commit, term,
         is_leader, out, R, P, W, quorum, 0, 1};
  return launch<false>(a, stream);
}

int raftsql_masked_quorum_commit(const int* match, const uint8_t* voters,
                                 const uint8_t* voters_joint,
                                 const int* log_term, const int* log_len,
                                 const int* commit, const int* term,
                                 const uint8_t* is_leader, int* out, int R,
                                 int P, int W, int size, int has_size,
                                 cudaStream_t stream) {
  Rows a{match, voters, voters_joint, log_term, log_len, commit, term,
         is_leader, out, R, P, W, size, has_size, 1};
  return launch<true>(a, stream);
}

const char* raftsql_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
