// Native WAL fast path — the C++ runtime piece of the storage layer.
//
// The reference's durability layer is vendored etcd/wal (Go) feeding an
// fsync before peer sends (reference raft.go:227-235).  At 100k groups per
// tick the record-framing CPU cost lands on the host hot loop, so the
// framing + CRC + buffered write path lives here; Python (storage/wal.py)
// keeps the cold paths (open/replay) and its own writer, which runs only
// when asked for (native=False, an active fsio fault injector, or
// RAFTSQL_TPU_NATIVE=0).
//
// Byte format is identical to storage/wal.py:
//   u32 crc32(body) | u32 body_len | body          (little endian)
//   body := u8 type | fields
//     type 1 ENTRY:     u32 group | u64 index | u64 term | bytes data
//     type 2 HARDSTATE: u32 group | u64 term  | i64 vote | u64 commit
//     type 3 SNAPSHOT:  u32 group | u64 index | u64 term
//     type 4 COMPACT:   u32 group | u64 index | u64 term
//     type 5 RANGE:     u32 group | u64 start | u64 term | u32 count
//                       | u32 lens[count] | payload bytes
//
// Build (native/build.py, at first use): g++ -O2 -std=c++17 -shared -fPIC
//   -o build/native/libwal_<source digest>.so wal.cc
// ABI: plain C, consumed via ctypes (no pybind11 in this environment).

#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <mutex>
#include <string>
#include <unordered_map>
#include <unistd.h>
#include <vector>

namespace {

uint32_t kCrcTable[256];
struct CrcInit {
  CrcInit() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k)
        c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      kCrcTable[i] = c;
    }
  }
} crc_init;

uint32_t crc32z_update(uint32_t c, const uint8_t* p, size_t n) {
  for (size_t i = 0; i < n; ++i) c = kCrcTable[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return c;
}

uint32_t crc32z(const uint8_t* p, size_t n) {  // zlib-compatible
  return crc32z_update(0xFFFFFFFFu, p, n) ^ 0xFFFFFFFFu;
}

struct Wal {
  int fd = -1;
  std::vector<uint8_t> buf;  // framed records pending write+fsync
  std::mutex mu;
};

void put_u32(std::vector<uint8_t>& b, uint32_t v) {
  for (int i = 0; i < 4; ++i) b.push_back(uint8_t(v >> (8 * i)));
}
void put_u64(std::vector<uint8_t>& b, uint64_t v) {
  for (int i = 0; i < 8; ++i) b.push_back(uint8_t(v >> (8 * i)));
}

// Frame `body` (already assembled past the header) into w->buf.
void frame(Wal* w, const std::vector<uint8_t>& body) {
  put_u32(w->buf, crc32z(body.data(), body.size()));
  put_u32(w->buf, uint32_t(body.size()));
  w->buf.insert(w->buf.end(), body.begin(), body.end());
}

int flush_locked(Wal* w) {
  size_t off = 0;
  while (off < w->buf.size()) {
    ssize_t n = ::write(w->fd, w->buf.data() + off, w->buf.size() - off);
    if (n < 0) {
      if (errno == EINTR) continue;
      // Drop the consumed prefix so a retry/close cannot re-write bytes
      // already on disk (which would garble the tail with duplicates).
      w->buf.erase(w->buf.begin(), w->buf.begin() + off);
      return -1;
    }
    off += size_t(n);
  }
  w->buf.clear();
  return 0;
}

}  // namespace

extern "C" {

void* wal_open(const char* path) {
  int fd = ::open(path, O_WRONLY | O_CREAT | O_APPEND, 0644);
  if (fd < 0) return nullptr;
  Wal* w = new Wal();
  w->fd = fd;
  w->buf.reserve(1 << 20);
  return w;
}

int wal_append_entry(void* h, uint32_t group, uint64_t index, uint64_t term,
                     const uint8_t* data, uint32_t len) {
  Wal* w = static_cast<Wal*>(h);
  std::vector<uint8_t> body;
  body.reserve(21 + len);
  body.push_back(1);
  put_u32(body, group);
  put_u64(body, index);
  put_u64(body, term);
  if (len) body.insert(body.end(), data, data + len);
  std::lock_guard<std::mutex> lk(w->mu);
  frame(w, body);
  return 0;
}

// Batched append: n records whose data blobs are concatenated in `datas`
// with per-record lengths in `lens`.  One ctypes call per tick, not per
// record.
int wal_append_entries(void* h, uint32_t n, const uint32_t* groups,
                       const uint64_t* indexes, const uint64_t* terms,
                       const uint8_t* datas, const uint32_t* lens) {
  Wal* w = static_cast<Wal*>(h);
  std::lock_guard<std::mutex> lk(w->mu);
  size_t off = 0;
  std::vector<uint8_t> body;
  for (uint32_t i = 0; i < n; ++i) {
    body.clear();
    body.reserve(21 + lens[i]);
    body.push_back(1);
    put_u32(body, groups[i]);
    put_u64(body, indexes[i]);
    put_u64(body, terms[i]);
    if (lens[i]) body.insert(body.end(), datas + off, datas + off + lens[i]);
    off += lens[i];
    frame(w, body);
  }
  return 0;
}

// Range append: one type-5 record per (group, start, term, count) range
// of consecutive entries — the header+CRC amortizes over the whole
// range (the per-entry framing was the durable tick's byte bottleneck).
// Body: u8 5 | u32 group | u64 start | u64 term | u32 count
//       | u32 lens[count] | payload bytes (concatenated).
int wal_append_ranges(void* h, uint32_t n_ranges, const uint32_t* groups,
                      const uint64_t* starts, const uint64_t* terms,
                      const uint32_t* counts, const uint8_t* blob,
                      const uint32_t* lens) {
  Wal* w = static_cast<Wal*>(h);
  std::lock_guard<std::mutex> lk(w->mu);
  size_t blob_off = 0, len_off = 0;
  std::vector<uint8_t> body;
  for (uint32_t r = 0; r < n_ranges; ++r) {
    uint32_t cnt = counts[r];
    size_t bytes = 0;
    for (uint32_t i = 0; i < cnt; ++i) bytes += lens[len_off + i];
    body.clear();
    body.reserve(25 + 4 * size_t(cnt) + bytes);
    body.push_back(5);
    put_u32(body, groups[r]);
    put_u64(body, starts[r]);
    put_u64(body, terms[r]);
    put_u32(body, cnt);
    for (uint32_t i = 0; i < cnt; ++i) put_u32(body, lens[len_off + i]);
    if (bytes)
      body.insert(body.end(), blob + blob_off, blob + blob_off + bytes);
    blob_off += bytes;
    len_off += cnt;
    frame(w, body);
  }
  return 0;
}

int wal_set_snapshot(void* h, uint32_t group, uint64_t index,
                     uint64_t term) {
  Wal* w = static_cast<Wal*>(h);
  std::vector<uint8_t> body;
  body.reserve(21);
  body.push_back(3);
  put_u32(body, group);
  put_u64(body, index);
  put_u64(body, term);
  std::lock_guard<std::mutex> lk(w->mu);
  frame(w, body);
  return 0;
}

// Compaction floor marker (type 4): on replay, entries of `group` at or
// below `index` are dropped while the retained suffix SURVIVES — unlike
// the snapshot marker (type 3), which also clears the suffix because an
// installed state's history may conflict with it.
// Type 6 EPOCH: u8 kind (0 BEGIN / 1 END) | u64 epoch number — the
// multi-step dispatch frame marker (runtime/fused.py); replay ignores
// it, repair_epochs() truncates at an uncommitted BEGIN.
int wal_epoch(void* h, uint64_t no, uint8_t kind) {
  Wal* w = static_cast<Wal*>(h);
  std::vector<uint8_t> body;
  body.reserve(10);
  body.push_back(6);
  body.push_back(kind);
  put_u64(body, no);
  std::lock_guard<std::mutex> lk(w->mu);
  frame(w, body);
  return 0;
}

int wal_set_compact(void* h, uint32_t group, uint64_t index,
                    uint64_t term) {
  Wal* w = static_cast<Wal*>(h);
  std::vector<uint8_t> body;
  body.reserve(21);
  body.push_back(4);
  put_u32(body, group);
  put_u64(body, index);
  put_u64(body, term);
  std::lock_guard<std::mutex> lk(w->mu);
  frame(w, body);
  return 0;
}

int wal_set_hardstate(void* h, uint32_t group, uint64_t term, int64_t vote,
                      uint64_t commit) {
  Wal* w = static_cast<Wal*>(h);
  std::vector<uint8_t> body;
  body.reserve(29);
  body.push_back(2);
  put_u32(body, group);
  put_u64(body, term);
  put_u64(body, uint64_t(vote));
  put_u64(body, commit);
  std::lock_guard<std::mutex> lk(w->mu);
  frame(w, body);
  return 0;
}

// Batched hard states — one call per tick for every group whose
// (term, vote, commit) changed; under saturation that is ALL groups, so
// the per-record Python/ctypes round trip must not be per group.
int wal_set_hardstates(void* h, uint32_t n, const uint32_t* groups,
                       const uint64_t* terms, const int64_t* votes,
                       const uint64_t* commits) {
  Wal* w = static_cast<Wal*>(h);
  std::lock_guard<std::mutex> lk(w->mu);
  std::vector<uint8_t> body;
  for (uint32_t i = 0; i < n; ++i) {
    body.clear();
    body.reserve(29);
    body.push_back(2);
    put_u32(body, groups[i]);
    put_u64(body, terms[i]);
    put_u64(body, uint64_t(votes[i]));
    put_u64(body, commits[i]);
    frame(w, body);
  }
  return 0;
}

// Durable point: write all pending frames, then fdatasync.  Returns 0 on
// success, -1 on error (caller must treat as fatal — the ordering
// invariant is broken if we proceed).
int wal_sync(void* h) {
  Wal* w = static_cast<Wal*>(h);
  std::lock_guard<std::mutex> lk(w->mu);
  if (w->buf.empty()) return 0;
  if (flush_locked(w) != 0) return -1;
  return ::fdatasync(w->fd) == 0 ? 0 : -1;
}

int wal_close(void* h) {
  Wal* w = static_cast<Wal*>(h);
  int rc = 0;
  {
    std::lock_guard<std::mutex> lk(w->mu);
    if (!w->buf.empty() && flush_locked(w) == 0) ::fdatasync(w->fd);
    rc = ::close(w->fd);
  }
  delete w;
  return rc;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Native payload log — the host byte store behind the device's term
// metadata (the C++ counterpart of storage/log.py PayloadLog), plus the
// combined walplog_* entry points the fused runtime's durable tick uses:
// one ctypes call writes a whole tick's WAL records AND payload-log
// ranges for a peer, and one call performs every follower mirror for the
// whole cluster with the read-all-before-write-all ordering the
// same-tick truncation hazard requires (runtime/fused.py module doc).

namespace {

struct PlogGroup {
  std::vector<std::string> datas;
  std::vector<uint64_t> terms;
  uint64_t start = 0;
  uint64_t start_term = 0;
};

struct Plog {
  std::vector<PlogGroup> groups;
  std::mutex mu;
};

// Write [start, start+n) into g (tail-extend fast path, in-place
// overwrite otherwise); truncate to new_len if >= 0.  Returns -1 on a
// gap (callers treat as fatal — indexes must be contiguous).
int plog_put_locked(PlogGroup& pg, uint64_t start, uint32_t n,
                    const uint64_t* terms, const uint8_t* blob,
                    const uint32_t* lens, int64_t new_len) {
  int64_t rel = int64_t(start) - 1 - int64_t(pg.start);
  size_t off = 0;
  if (rel == int64_t(pg.datas.size())) {
    for (uint32_t i = 0; i < n; ++i) {
      pg.datas.emplace_back(reinterpret_cast<const char*>(blob + off),
                            lens[i]);
      pg.terms.push_back(terms[i]);
      off += lens[i];
    }
  } else {
    for (uint32_t i = 0; i < n; ++i) {
      int64_t pos = rel + int64_t(i);
      if (pos < 0) { off += lens[i]; continue; }  // below floor
      if (pos < int64_t(pg.datas.size())) {
        pg.datas[size_t(pos)].assign(
            reinterpret_cast<const char*>(blob + off), lens[i]);
        pg.terms[size_t(pos)] = terms[i];
      } else if (pos == int64_t(pg.datas.size())) {
        pg.datas.emplace_back(reinterpret_cast<const char*>(blob + off),
                              lens[i]);
        pg.terms.push_back(terms[i]);
      } else {
        return -1;
      }
      off += lens[i];
    }
  }
  if (new_len >= 0) {
    int64_t keep = new_len - int64_t(pg.start);
    if (keep < 0) keep = 0;
    if (size_t(keep) < pg.datas.size()) {
      pg.datas.resize(size_t(keep));
      pg.terms.resize(size_t(keep));
    }
  }
  return 0;
}

void wal_entry_locked(Wal* w, std::vector<uint8_t>& body, uint32_t g,
                      uint64_t idx, uint64_t term, const uint8_t* data,
                      uint32_t len) {
  body.clear();
  body.reserve(21 + len);
  body.push_back(1);
  put_u32(body, g);
  put_u64(body, idx);
  put_u64(body, term);
  if (len) body.insert(body.end(), data, data + len);
  frame(w, body);
}

// One type-5 RANGE record (same layout as wal_append_ranges): entries
// at start..start+n-1, all with `term`, lens/payloads concatenated.
void wal_range_locked(Wal* w, std::vector<uint8_t>& body, uint32_t g,
                      uint64_t start, uint64_t term, uint32_t n,
                      const uint32_t* lens, const uint8_t* blob,
                      size_t bytes) {
  body.clear();
  body.reserve(25 + 4 * size_t(n) + bytes);
  body.push_back(5);
  put_u32(body, g);
  put_u64(body, start);
  put_u64(body, term);
  put_u32(body, n);
  for (uint32_t i = 0; i < n; ++i) put_u32(body, lens[i]);
  if (bytes) body.insert(body.end(), blob, blob + bytes);
  frame(w, body);
}

// Gather-framed RANGE: one type-5 record for entries [k0, k1) of
// `datas` (all term `term`), framed DIRECTLY into w->buf — the CRC is
// computed incrementally over head + payloads, so the payload bytes
// are copied exactly once.  Byte-identical to wal_range_locked; used
// by the mirror path, which re-copies every committed byte to P-1
// peers per tick and is memcpy-bound.
void wal_range_gather_locked(Wal* w, std::vector<uint8_t>& head,
                             uint32_t g, uint64_t start, uint64_t term,
                             const std::string* datas, uint32_t k0,
                             uint32_t k1) {
  head.clear();
  head.push_back(5);
  put_u32(head, g);
  put_u64(head, start);
  put_u64(head, term);
  put_u32(head, k1 - k0);
  size_t bytes = 0;
  for (uint32_t k = k0; k < k1; ++k) {
    put_u32(head, uint32_t(datas[k].size()));
    bytes += datas[k].size();
  }
  uint32_t c = crc32z_update(0xFFFFFFFFu, head.data(), head.size());
  for (uint32_t k = k0; k < k1; ++k)
    c = crc32z_update(
        c, reinterpret_cast<const uint8_t*>(datas[k].data()),
        datas[k].size());
  put_u32(w->buf, c ^ 0xFFFFFFFFu);
  put_u32(w->buf, uint32_t(head.size() + bytes));
  w->buf.insert(w->buf.end(), head.begin(), head.end());
  for (uint32_t k = k0; k < k1; ++k)
    w->buf.insert(w->buf.end(), datas[k].begin(), datas[k].end());
}

}  // namespace

extern "C" {

void* plog_new(uint32_t num_groups) {
  Plog* p = new Plog();
  p->groups.resize(num_groups);
  return p;
}

void plog_free(void* h) { delete static_cast<Plog*>(h); }

uint64_t plog_length(void* h, uint32_t g) {
  Plog* p = static_cast<Plog*>(h);
  std::lock_guard<std::mutex> lk(p->mu);
  return p->groups[g].start + p->groups[g].datas.size();
}

uint64_t plog_start(void* h, uint32_t g) {
  Plog* p = static_cast<Plog*>(h);
  std::lock_guard<std::mutex> lk(p->mu);
  return p->groups[g].start;
}

uint64_t plog_start_term(void* h, uint32_t g) {
  Plog* p = static_cast<Plog*>(h);
  std::lock_guard<std::mutex> lk(p->mu);
  return p->groups[g].start_term;
}

int plog_set_start(void* h, uint32_t g, uint64_t start,
                   uint64_t start_term) {
  Plog* p = static_cast<Plog*>(h);
  std::lock_guard<std::mutex> lk(p->mu);
  PlogGroup& pg = p->groups[g];
  if (!pg.datas.empty()) return -1;
  pg.start = start;
  pg.start_term = start_term;
  return 0;
}

// Term of entry idx; idx == 0 -> 0, idx == start -> boundary term,
// below-floor/beyond-tail -> UINT64_MAX (caller decides retry/assert).
uint64_t plog_term_of(void* h, uint32_t g, uint64_t idx) {
  Plog* p = static_cast<Plog*>(h);
  std::lock_guard<std::mutex> lk(p->mu);
  PlogGroup& pg = p->groups[g];
  if (idx == 0) return 0;
  if (idx == pg.start) return pg.start_term;
  if (idx < pg.start || idx > pg.start + pg.terms.size())
    return ~uint64_t(0);
  return pg.terms[size_t(idx - 1 - pg.start)];
}

int plog_compact(void* h, uint32_t g, uint64_t upto,
                 uint64_t boundary_term) {
  Plog* p = static_cast<Plog*>(h);
  std::lock_guard<std::mutex> lk(p->mu);
  PlogGroup& pg = p->groups[g];
  if (upto <= pg.start) return 0;
  size_t drop = size_t(upto - pg.start);
  if (drop > pg.datas.size()) return -1;
  pg.datas.erase(pg.datas.begin(), pg.datas.begin() + drop);
  pg.terms.erase(pg.terms.begin(), pg.terms.begin() + drop);
  pg.start = upto;
  pg.start_term = boundary_term;
  return 0;
}

int plog_put_range(void* h, uint32_t g, uint64_t start, uint32_t n,
                   const uint64_t* terms, const uint8_t* blob,
                   const uint32_t* lens, int64_t new_len) {
  Plog* p = static_cast<Plog*>(h);
  std::lock_guard<std::mutex> lk(p->mu);
  return plog_put_locked(p->groups[g], start, n, terms, blob, lens,
                         new_len);
}

// Two-phase read: total byte size of [start, start+n), then fill.
// Returns UINT64_MAX if the range dips below the floor or past the tail.
uint64_t plog_range_bytes(void* h, uint32_t g, uint64_t start, uint32_t n) {
  Plog* p = static_cast<Plog*>(h);
  std::lock_guard<std::mutex> lk(p->mu);
  PlogGroup& pg = p->groups[g];
  int64_t rel = int64_t(start) - 1 - int64_t(pg.start);
  if (rel < 0 || size_t(rel) + n > pg.datas.size()) return ~uint64_t(0);
  uint64_t total = 0;
  for (uint32_t i = 0; i < n; ++i) total += pg.datas[size_t(rel) + i].size();
  return total;
}

int plog_read_range(void* h, uint32_t g, uint64_t start, uint32_t n,
                    uint8_t* blob_out, uint32_t* lens_out,
                    uint64_t* terms_out) {
  Plog* p = static_cast<Plog*>(h);
  std::lock_guard<std::mutex> lk(p->mu);
  PlogGroup& pg = p->groups[g];
  int64_t rel = int64_t(start) - 1 - int64_t(pg.start);
  if (rel < 0 || size_t(rel) + n > pg.datas.size()) return -1;
  size_t off = 0;
  for (uint32_t i = 0; i < n; ++i) {
    const std::string& d = pg.datas[size_t(rel) + i];
    if (blob_out) std::memcpy(blob_out + off, d.data(), d.size());
    if (lens_out) lens_out[i] = uint32_t(d.size());
    if (terms_out) terms_out[i] = pg.terms[size_t(rel) + i];
    off += d.size();
  }
  return 0;
}

// Batched multi-group read (the publish hot path): total bytes of all
// ranges, then one fill of concatenated payloads + per-entry lens in
// range order.  Returns UINT64_MAX / -1 if any range is unavailable.
uint64_t plog_ranges_bytes(void* h, uint32_t n_ranges,
                           const uint32_t* groups, const uint64_t* starts,
                           const uint32_t* counts) {
  Plog* p = static_cast<Plog*>(h);
  std::lock_guard<std::mutex> lk(p->mu);
  uint64_t total = 0;
  for (uint32_t r = 0; r < n_ranges; ++r) {
    PlogGroup& pg = p->groups[groups[r]];
    int64_t rel = int64_t(starts[r]) - 1 - int64_t(pg.start);
    if (rel < 0 || size_t(rel) + counts[r] > pg.datas.size())
      return ~uint64_t(0);
    for (uint32_t i = 0; i < counts[r]; ++i)
      total += pg.datas[size_t(rel) + i].size();
  }
  return total;
}

int plog_read_groups(void* h, uint32_t n_ranges, const uint32_t* groups,
                     const uint64_t* starts, const uint32_t* counts,
                     uint8_t* blob_out, uint32_t* lens_out) {
  Plog* p = static_cast<Plog*>(h);
  std::lock_guard<std::mutex> lk(p->mu);
  size_t off = 0, li = 0;
  for (uint32_t r = 0; r < n_ranges; ++r) {
    PlogGroup& pg = p->groups[groups[r]];
    int64_t rel = int64_t(starts[r]) - 1 - int64_t(pg.start);
    if (rel < 0 || size_t(rel) + counts[r] > pg.datas.size()) return -1;
    for (uint32_t i = 0; i < counts[r]; ++i) {
      const std::string& d = pg.datas[size_t(rel) + i];
      std::memcpy(blob_out + off, d.data(), d.size());
      lens_out[li++] = uint32_t(d.size());
      off += d.size();
    }
  }
  return 0;
}

// Combined leader-append path: for each range i, write WAL ENTRY records
// AND the payload-log range, all entries of range i sharing terms[i].
// Ranges are (group, start, count) with payload bytes concatenated in
// `blob` / per-entry `lens` in range order.  One call per peer per tick.
//
// `wal_group_bias` is added to the group id of every WAL record (NOT
// the payload-log index): the group-commit layout (storage/wal.py
// GroupCommitWAL) multiplexes all P peers' logical logs into one
// physical record stream by flat id peer*G + g, while each peer's
// payload log stays per-peer and unbiased.
int walplog_put_uniform(void* wal_h, void* plog_h, uint32_t n_ranges,
                        const uint32_t* groups, const uint64_t* starts,
                        const uint32_t* counts, const uint64_t* terms,
                        const uint8_t* blob, const uint32_t* lens,
                        uint32_t wal_group_bias) {
  Wal* w = static_cast<Wal*>(wal_h);
  Plog* p = static_cast<Plog*>(plog_h);
  std::lock_guard<std::mutex> lw(w->mu);
  std::lock_guard<std::mutex> lp(p->mu);
  size_t off = 0, li = 0;
  std::vector<uint64_t> tbuf;
  std::vector<uint8_t> body;
  for (uint32_t r = 0; r < n_ranges; ++r) {
    uint32_t n = counts[r];
    if (n == 0) continue;               // empty runs write nothing
    tbuf.assign(n, terms[r]);
    size_t range_bytes = 0;
    for (uint32_t i = 0; i < n; ++i) range_bytes += lens[li + i];
    wal_range_locked(w, body, groups[r] + wal_group_bias, starts[r],
                     terms[r], n, lens + li, blob + off, range_bytes);
    int rc = plog_put_locked(p->groups[groups[r]], starts[r], n,
                             tbuf.data(), blob + off, lens + li, -1);
    if (rc != 0) return rc;
    off += range_bytes;
    li += n;
  }
  return 0;
}

// Combined mirror path for the WHOLE cluster: phase A reads every
// source range into scratch (so a same-tick truncation or overwrite on
// any source cannot tear any mirror — the read-all-before-write-all
// contract); phase B writes each destination's payload-log range +
// truncation and its WAL ENTRY records.  `wals`/`plogs` are per-peer
// handle arrays; `peer`/`src` index them.
// `wal_biases` (may be null = all zero) is indexed by destination peer
// and added to the group id of that peer's WAL records only — see
// walplog_put_uniform.  Under the group-commit layout every wals[i]
// is the SAME shared handle (one buffer, one mutex, one fd) and the
// bias keeps the multiplexed records per-peer-separable on replay.
int walplog_mirror_all(void** wals, void** plogs, uint32_t n_mirrors,
                       const uint32_t* peer, const uint32_t* src,
                       const uint32_t* groups, const uint64_t* starts,
                       const uint32_t* counts, const int64_t* new_lens,
                       uint64_t* per_peer_bytes,
                       const uint32_t* wal_biases) {
  struct Scratch {
    std::vector<std::string> datas;
    std::vector<uint64_t> terms;
  };
  std::vector<Scratch> scratch(n_mirrors);
  for (uint32_t i = 0; i < n_mirrors; ++i) {
    Plog* sp = static_cast<Plog*>(plogs[src[i]]);
    std::lock_guard<std::mutex> lk(sp->mu);
    PlogGroup& pg = sp->groups[groups[i]];
    int64_t rel = int64_t(starts[i]) - 1 - int64_t(pg.start);
    uint32_t n = counts[i];
    if (n == 0) continue;
    if (rel < 0 || size_t(rel) + n > pg.datas.size()) return -1;
    scratch[i].datas.assign(pg.datas.begin() + rel,
                            pg.datas.begin() + rel + n);
    scratch[i].terms.assign(pg.terms.begin() + rel,
                            pg.terms.begin() + rel + n);
  }
  for (uint32_t i = 0; i < n_mirrors; ++i) {
    Wal* w = static_cast<Wal*>(wals[peer[i]]);
    Plog* dp = static_cast<Plog*>(plogs[peer[i]]);
    uint32_t n = counts[i];
    std::lock_guard<std::mutex> lw(w->mu);
    std::lock_guard<std::mutex> lp(dp->mu);
    PlogGroup& pg = dp->groups[groups[i]];
    int64_t rel = int64_t(starts[i]) - 1 - int64_t(pg.start);
    std::vector<uint8_t> body;
    size_t buf0 = w->buf.size();
    // WAL records as same-term RANGE runs (split at term boundaries —
    // rare: only elections change terms inside a mirrored batch),
    // gather-framed so each payload byte is copied once.
    uint32_t bias = wal_biases ? wal_biases[peer[i]] : 0;
    for (uint32_t k0 = 0; k0 < n;) {
      uint64_t t = scratch[i].terms[k0];
      uint32_t k1 = k0;
      while (k1 < n && scratch[i].terms[k1] == t) ++k1;
      wal_range_gather_locked(w, body, groups[i] + bias, starts[i] + k0,
                              t, scratch[i].datas.data(), k0, k1);
      k0 = k1;
    }
    for (uint32_t k = 0; k < n; ++k) {
      const std::string& d = scratch[i].datas[k];
      int64_t pos = rel + int64_t(k);
      if (pos < 0) continue;
      if (pos < int64_t(pg.datas.size())) {
        pg.datas[size_t(pos)] = d;
        pg.terms[size_t(pos)] = scratch[i].terms[k];
      } else if (pos == int64_t(pg.datas.size())) {
        pg.datas.push_back(d);
        pg.terms.push_back(scratch[i].terms[k]);
      } else {
        return -1;
      }
    }
    // Framed-byte accounting from actual buffer growth (no layout
    // constant to drift from the Python struct definitions).
    if (per_peer_bytes) per_peer_bytes[peer[i]] += w->buf.size() - buf0;
    int64_t nl = new_lens[i];
    if (nl >= 0) {
      int64_t keep = nl - int64_t(pg.start);
      if (keep < 0) keep = 0;
      if (size_t(keep) < pg.datas.size()) {
        pg.datas.resize(size_t(keep));
        pg.terms.resize(size_t(keep));
      }
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Native KV apply plane: the C++ counterpart of models/kv_sm.py, fed
// RANGES straight from the native payload log — committed entries are
// parsed and applied without ever materializing Python objects (the
// measured ceiling of the Python-resident durable path was per-entry
// object handling).  Command grammar matches KVStateMachine.apply:
//   "SET <key> <value>"  (value may contain spaces)
//   "DEL <key>"          (exactly one token after DEL)
// anything else counts as a bad command (reported, not fatal), and an
// entry at or below the group's applied index is skipped (exactly-once
// across replays/installs, KVStateMachine.apply's index guard).

struct Kv {
  std::vector<std::unordered_map<std::string, std::string>> groups;
  std::vector<uint64_t> applied;
  std::mutex mu;
};

void* kv_new(uint32_t num_groups) {
  Kv* kv = new Kv();
  kv->groups.resize(num_groups);
  kv->applied.assign(num_groups, 0);
  return kv;
}

void kv_free(void* h) { delete static_cast<Kv*>(h); }

// Apply plog entries [starts[r], starts[r]+counts[r]) of groups[r] for
// every range; empty payloads (no-op entries) skipped.  Returns the
// number applied, or UINT64_MAX when a committed index falls outside
// the payload-log window (the wrapper raises, matching the Python
// path's "payload log shorter than commit" RuntimeError) — work done
// before the fault IS recorded in applied[], so nothing double-applies
// on retry.  Bad commands are counted into *bad (may be null).
// Holds both locks for the batch: the caller (the fused runtime's
// publish, or its overlap window) owns the tick thread, so there is no
// producer to stall.
uint64_t kv_apply_plog(void* kv_h, void* plog_h, uint32_t n_ranges,
                       const uint32_t* groups, const uint64_t* starts,
                       const uint32_t* counts, uint64_t* bad) {
  Kv* kv = static_cast<Kv*>(kv_h);
  Plog* p = static_cast<Plog*>(plog_h);
  std::lock_guard<std::mutex> lk(kv->mu);
  std::lock_guard<std::mutex> lp(p->mu);
  uint64_t done = 0, nbad = 0;
  for (uint32_t r = 0; r < n_ranges; ++r) {
    uint32_t g = groups[r];
    PlogGroup& pg = p->groups[g];
    auto& map = kv->groups[g];
    uint64_t ap = kv->applied[g];
    for (uint32_t i = 0; i < counts[r]; ++i) {
      uint64_t idx = starts[r] + i;
      if (idx <= ap) continue;
      int64_t rel = int64_t(idx) - 1 - int64_t(pg.start);
      if (rel < 0 || size_t(rel) >= pg.datas.size()) {
        kv->applied[g] = ap;
        if (bad) *bad += nbad;
        return UINT64_MAX;
      }
      const std::string& d = pg.datas[size_t(rel)];
      ap = idx;
      if (d.empty()) continue;                   // no-op entry
      if (d.size() > 4 && !d.compare(0, 4, "SET ")) {
        size_t sp = d.find(' ', 4);
        if (sp != std::string::npos && sp + 1 <= d.size()) {
          map[d.substr(4, sp - 4)] = d.substr(sp + 1);
          ++done;
          continue;
        }
      } else if (d.size() >= 4 && !d.compare(0, 4, "DEL ")) {
        // "DEL <key>" with exactly one token after DEL; an empty key
        // is valid (split(" ", 2) parity with KVStateMachine.apply).
        if (d.find(' ', 4) == std::string::npos) {
          map.erase(d.substr(4));
          ++done;
          continue;
        }
      }
      ++nbad;
    }
    kv->applied[g] = ap;
  }
  if (bad) *bad += nbad;
  return done;
}

uint64_t kv_applied(void* h, uint32_t g) {
  Kv* kv = static_cast<Kv*>(h);
  std::lock_guard<std::mutex> lk(kv->mu);
  return kv->applied[g];
}

uint64_t kv_count(void* h, uint32_t g) {
  Kv* kv = static_cast<Kv*>(h);
  std::lock_guard<std::mutex> lk(kv->mu);
  return kv->groups[g].size();
}

// Value of `key` into out (cap bytes); returns the value length, or -1
// if absent.  A return > cap means the buffer was too small (caller
// retries with a bigger one).
int64_t kv_get(void* h, uint32_t g, const uint8_t* key, uint32_t klen,
               uint8_t* out, uint32_t cap) {
  Kv* kv = static_cast<Kv*>(h);
  std::lock_guard<std::mutex> lk(kv->mu);
  auto& map = kv->groups[g];
  auto it = map.find(std::string(reinterpret_cast<const char*>(key),
                                 klen));
  if (it == map.end()) return -1;
  const std::string& v = it->second;
  if (v.size() <= cap && cap) memcpy(out, v.data(), v.size());
  return int64_t(v.size());
}

}  // extern "C"
