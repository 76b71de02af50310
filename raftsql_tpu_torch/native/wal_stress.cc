// Sanitizer stress harness for the native WAL (native/wal.cc).
//
// Hammers one Wal handle from four threads with the same call mix the
// runtime produces concurrently: the tick thread's batched entry appends
// + hardstate + sync (runtime/node.py _wal_phase), the compactor's
// COMPACT markers (node.compact), and snapshot markers (InstallSnapshot).
// Copy of the JAX package's native/wal_stress.cc.  Built with
// -fsanitize=address, undefined or thread by native/build.py
// build_wal_stress and run by `python -m raftsql_tpu_torch.native.sanitize`;
// any memory error, undefined behaviour or data race in wal.cc aborts
// the run.
//
// Usage: wal_stress <dir> [iters]

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

extern "C" {
void* wal_open(const char* path);
int wal_append_entry(void*, uint32_t, uint64_t, uint64_t, const uint8_t*,
                     uint32_t);
int wal_append_entries(void*, uint32_t, const uint32_t*, const uint64_t*,
                       const uint64_t*, const uint8_t* const*,
                       const uint32_t*);
int wal_set_snapshot(void*, uint32_t, uint64_t, uint64_t);
int wal_set_compact(void*, uint32_t, uint64_t, uint64_t);
int wal_set_hardstate(void*, uint32_t, uint64_t, int64_t, uint64_t);
int wal_sync(void*);
int wal_close(void*);
}

int main(int argc, char** argv) {
  if (argc < 2) {
    std::fprintf(stderr, "usage: wal_stress <dir> [iters]\n");
    return 2;
  }
  std::string path = std::string(argv[1]) + "/wal-0.log";
  int iters = argc > 2 ? std::atoi(argv[2]) : 2000;
  void* w = wal_open(path.c_str());
  if (!w) {
    std::fprintf(stderr, "wal_open failed\n");
    return 1;
  }
  std::atomic<int> errs{0};
  const uint8_t payload[] = "SET k v";

  auto appender = [&](uint32_t group_base) {
    std::vector<uint32_t> groups(8);
    std::vector<uint64_t> idx(8), terms(8);
    std::vector<const uint8_t*> datas(8);
    std::vector<uint32_t> lens(8);
    for (int it = 0; it < iters; ++it) {
      for (int k = 0; k < 8; ++k) {
        groups[k] = group_base + (k % 4);
        idx[k] = uint64_t(it) * 8 + k + 1;
        terms[k] = it / 100 + 1;
        datas[k] = payload;
        lens[k] = sizeof(payload) - 1;
      }
      if (wal_append_entries(w, 8, groups.data(), idx.data(), terms.data(),
                             datas.data(), lens.data()))
        ++errs;
      if (wal_set_hardstate(w, group_base, it / 100 + 1, -1, it * 4)) ++errs;
      if (it % 16 == 0 && wal_sync(w)) ++errs;
    }
  };
  auto compactor = [&] {
    for (int it = 0; it < iters; ++it) {
      if (wal_set_compact(w, it % 8, it * 2 + 1, 1)) ++errs;
      if (it % 64 == 0 && wal_sync(w)) ++errs;
    }
  };
  auto snapshotter = [&] {
    for (int it = 0; it < iters; ++it) {
      if (wal_set_snapshot(w, it % 8, it * 4 + 1, 1)) ++errs;
    }
  };

  std::thread t1(appender, 0), t2(appender, 4), t3(compactor),
      t4(snapshotter);
  t1.join();
  t2.join();
  t3.join();
  t4.join();
  if (wal_sync(w)) ++errs;
  if (wal_close(w)) ++errs;
  if (errs.load()) {
    std::fprintf(stderr, "wal_stress: %d call failures\n", errs.load());
    return 1;
  }
  std::printf("wal_stress ok (%d iters x 4 threads)\n", iters);
  return 0;
}
