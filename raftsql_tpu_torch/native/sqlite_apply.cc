// Native SQLite apply — a drained run of committed entries applied to every
// file-backed SQLite state machine it touches in one call.
//
// models/sqlite_sm.py `apply_batch` issues three `Connection.execute`s a
// statement (SAVEPOINT, the command, RELEASE) plus a BEGIN and a COMMIT a
// group, and CPython's sqlite3 gives up the interpreter lock around every
// prepare and every step: an entry hands the lock off 4-6 times, and each
// retake queues behind the event loop and the tick thread.  Reached through
// ctypes.CDLL, this file gives the lock up once for the whole run.
//
// Semantics are apply_batch's, entry for entry:
//   - one transaction a group (BEGIN ... COMMIT), each statement isolated
//     by SAVEPOINT _apply (ROLLBACK TO + RELEASE on its error: the error is
//     the entry's outcome, the batch goes on);
//   - resume mode skips entries at or below the applied floor and writes
//     the batch's last index into _raft_meta inside the same transaction;
//   - a COMMIT failure is reported on every attempted entry that had no
//     error of its own, then the floor alone is retried;
//   - the binding's own refusals, checked the way CPython's sqlite3 checks
//     them (Modules/_sqlite/statement.c): a query longer than
//     SQLITE_LIMIT_SQL_LENGTH, a NUL inside the query, and a second
//     statement after the first (its tail, less whitespace and comments).
// Python turns each (code, message) back into the exception sqlite3 raises.
//
// The machine has no sqlite3.h: the few entry points used are declared
// here and bound with dlsym from the library the interpreter's _sqlite3
// module already loaded (sa_init), so both sides of the process share one
// SQLite and its POSIX lock bookkeeping.
//
// Build (native/build.py, at first use): g++ -O2 -std=c++17 -shared -fPIC
// ABI: plain C, consumed via ctypes.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <dlfcn.h>
#include <string>
#include <time.h>

namespace {

struct sqlite3;
struct sqlite3_stmt;

constexpr int kOk = 0;
constexpr int kRow = 100;
constexpr int kDone = 101;
constexpr int kOpenReadWrite = 0x02;
constexpr int kOpenCreate = 0x04;
constexpr int kLimitSqlLength = 1;

// The binding's own refusals (no SQLite code): ProgrammingError and
// DataError in CPython's sqlite3.
constexpr int32_t kRefuseMany = -1;   // "You can only execute one ..."
constexpr int32_t kRefuseNul = -2;    // "the query contains a null ..."
constexpr int32_t kRefuseLong = -3;   // "query string is too large"
// An entry skipped at or below the applied floor, while its group runs.
constexpr int32_t kSkipped = 1 << 30;

struct Api {
  int (*open_v2)(const char*, sqlite3**, int, const char*);
  int (*close_v2)(sqlite3*);
  int (*prepare_v2)(sqlite3*, const char*, int, sqlite3_stmt**,
                    const char**);
  int (*step)(sqlite3_stmt*);
  int (*reset)(sqlite3_stmt*);
  int (*finalize)(sqlite3_stmt*);
  int (*bind_int64)(sqlite3_stmt*, int, int64_t);
  int (*extended_errcode)(sqlite3*);
  const char* (*errmsg)(sqlite3*);
  int (*get_autocommit)(sqlite3*);
  int (*busy_timeout)(sqlite3*, int);
  int (*limit)(sqlite3*, int, int);
} api;

bool api_ready = false;

struct Handle {
  sqlite3* db = nullptr;
  bool resume = false;
  // Statements with no schema in them, prepared once.
  sqlite3_stmt* begin = nullptr;
  sqlite3_stmt* commit = nullptr;
  sqlite3_stmt* rollback = nullptr;
  sqlite3_stmt* savepoint = nullptr;
  sqlite3_stmt* release = nullptr;
  sqlite3_stmt* rollback_to = nullptr;
};

const char kMeta[] =
    "INSERT INTO _raft_meta (k, v) VALUES ('applied_index', ?) "
    "ON CONFLICT(k) DO UPDATE SET v=excluded.v";

// One failed call: its code (extended SQLite code, or a kRefuse*) and the
// message sqlite3_errmsg gave.
struct Err {
  int32_t code = 0;
  std::string msg;
};

Err db_err(sqlite3* db) {
  Err e;
  e.code = api.extended_errcode(db);
  e.msg = api.errmsg(db);
  return e;
}

// Step a statement once, as the binding's execute does, and reset it.
bool step_once(sqlite3* db, sqlite3_stmt* st, Err* err) {
  int rc = api.step(st);
  if (rc != kDone && rc != kRow) {
    api.reset(st);
    *err = db_err(db);
    return false;
  }
  api.reset(st);
  return true;
}

// A prepared statement of text with no schema in it (NULL if SQLite
// refuses it, which then fails every use the same way).
sqlite3_stmt* prepare_fixed(sqlite3* db, const char* sql) {
  sqlite3_stmt* st = nullptr;
  if (api.prepare_v2(db, sql, -1, &st, nullptr) != kOk) return nullptr;
  return st;
}

bool run_fixed(sqlite3* db, sqlite3_stmt* st, const char* sql, Err* err) {
  if (st != nullptr) return step_once(db, st, err);
  sqlite3_stmt* fresh = nullptr;     // report the refusal as the binding would
  if (api.prepare_v2(db, sql, -1, &fresh, nullptr) != kOk) {
    *err = db_err(db);
    return false;
  }
  bool ok = step_once(db, fresh, err);
  api.finalize(fresh);
  return ok;
}

// The tail check of CPython's sqlite3 (statement.c lstrip_sql): the first
// character after whitespace and -- / /* */ comments, or nullptr.
const char* lstrip_sql(const char* pos) {
  for (; *pos; pos++) {
    switch (*pos) {
      case ' ':
      case '\t':
      case '\f':
      case '\n':
      case '\r':
        break;
      case '-':
        if (pos[1] == '-') {
          pos += 2;
          while (pos[0] && pos[0] != '\n') pos++;
          if (pos[0] == '\0') return nullptr;
          continue;
        }
        return pos;
      case '/':
        if (pos[1] == '*') {
          pos += 2;
          while (pos[0] && (pos[0] != '*' || pos[1] != '/')) pos++;
          if (pos[0] == '\0') return nullptr;
          pos++;
          continue;
        }
        return pos;
      default:
        return pos;
    }
  }
  return nullptr;
}

// One command as `Connection.execute(command)`: `sql` is NUL-terminated at
// sql[len].
bool run_command(sqlite3* db, const char* sql, int64_t len, Err* err) {
  if (len > api.limit(db, kLimitSqlLength, -1)) {
    err->code = kRefuseLong;
    err->msg.clear();
    return false;
  }
  if (std::memchr(sql, '\0', static_cast<size_t>(len)) != nullptr) {
    err->code = kRefuseNul;
    err->msg.clear();
    return false;
  }
  sqlite3_stmt* st = nullptr;
  const char* tail = nullptr;
  if (api.prepare_v2(db, sql, static_cast<int>(len) + 1, &st, &tail) !=
      kOk) {
    *err = db_err(db);
    return false;
  }
  if (lstrip_sql(tail) != nullptr) {
    api.finalize(st);
    err->code = kRefuseMany;
    err->msg.clear();
    return false;
  }
  if (st == nullptr) return true;      // only whitespace or comments
  bool ok = step_once(db, st, err);
  api.finalize(st);
  return ok;
}

bool write_meta(sqlite3* db, int64_t last, Err* err) {
  sqlite3_stmt* st = nullptr;
  if (api.prepare_v2(db, kMeta, -1, &st, nullptr) != kOk) {
    *err = db_err(db);
    return false;
  }
  api.bind_int64(st, 1, last);
  bool ok = step_once(db, st, err);
  api.finalize(st);
  return ok;
}

// Connection.commit() / rollback(): nothing outside a transaction.
bool commit(Handle* h, Err* err) {
  if (api.get_autocommit(h->db)) return true;
  return run_fixed(h->db, h->commit, "COMMIT", err);
}

void rollback(Handle* h) {
  Err ignored;
  if (!api.get_autocommit(h->db))
    run_fixed(h->db, h->rollback, "ROLLBACK", &ignored);
}

void finalize_all(Handle* h) {
  for (sqlite3_stmt* st : {h->begin, h->commit, h->rollback, h->savepoint,
                           h->release, h->rollback_to})
    if (st != nullptr) api.finalize(st);
}

int64_t now_ns() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return static_cast<int64_t>(ts.tv_sec) * 1000000000 + ts.tv_nsec;
}

template <typename F>
bool bind(void* lib, const char* name, F* fn) {
  *fn = reinterpret_cast<F>(dlsym(lib, name));
  return *fn != nullptr;
}

}  // namespace

extern "C" {

// Bind the SQLite entry points from `library` (the path of the libsqlite3
// the process already loaded).  0 on success, -1 when the library or a
// symbol is missing.
int sa_init(const char* library) {
  if (api_ready) return 0;
  void* lib = dlopen(library, RTLD_NOW | RTLD_LOCAL);
  if (lib == nullptr) return -1;
  bool ok = bind(lib, "sqlite3_open_v2", &api.open_v2) &&
            bind(lib, "sqlite3_close_v2", &api.close_v2) &&
            bind(lib, "sqlite3_prepare_v2", &api.prepare_v2) &&
            bind(lib, "sqlite3_step", &api.step) &&
            bind(lib, "sqlite3_reset", &api.reset) &&
            bind(lib, "sqlite3_finalize", &api.finalize) &&
            bind(lib, "sqlite3_bind_int64", &api.bind_int64) &&
            bind(lib, "sqlite3_extended_errcode", &api.extended_errcode) &&
            bind(lib, "sqlite3_errmsg", &api.errmsg) &&
            bind(lib, "sqlite3_get_autocommit", &api.get_autocommit) &&
            bind(lib, "sqlite3_busy_timeout", &api.busy_timeout) &&
            bind(lib, "sqlite3_limit", &api.limit);
  if (!ok) return -1;
  api_ready = true;
  return 0;
}

// A write connection on `path` with the state machine's pragmas: WAL /
// synchronous=NORMAL in resume mode, MEMORY journal / synchronous=OFF
// otherwise (models/sqlite_sm.py `_connect`), and the binding's default
// 5-s busy timeout.  NULL when SQLite cannot open the file.
void* sa_open(const char* path, int resume) {
  sqlite3* db = nullptr;
  if (api.open_v2(path, &db, kOpenReadWrite | kOpenCreate, nullptr) != kOk) {
    if (db != nullptr) api.close_v2(db);
    return nullptr;
  }
  api.busy_timeout(db, 5000);
  auto* h = new Handle;
  h->db = db;
  h->resume = resume != 0;
  static const char* const kWal[] = {"PRAGMA journal_mode=WAL",
                                     "PRAGMA synchronous=NORMAL"};
  static const char* const kMemory[] = {"PRAGMA journal_mode=MEMORY",
                                        "PRAGMA synchronous=OFF"};
  Err ignored;
  for (const char* pragma : resume ? kWal : kMemory)
    run_fixed(db, nullptr, pragma, &ignored);
  h->begin = prepare_fixed(db, "BEGIN");
  h->commit = prepare_fixed(db, "COMMIT");
  h->rollback = prepare_fixed(db, "ROLLBACK");
  h->savepoint = prepare_fixed(db, "SAVEPOINT _apply");
  h->release = prepare_fixed(db, "RELEASE _apply");
  h->rollback_to = prepare_fixed(db, "ROLLBACK TO _apply");
  return h;
}

void sa_close(void* handle) {
  auto* h = static_cast<Handle*>(handle);
  if (h == nullptr) return;
  finalize_all(h);
  api.close_v2(h->db);
  delete h;
}

// Apply one drained run.  Group k (handles[k], applied floor floors[k])
// owns entries [starts[k], starts[k+1]); entry i is the command at
// sql + off[i], len[i] bytes and NUL-terminated, at log index idx[i] (0:
// none).  Out: rc[i] 0 or the entry's error (extended SQLite code, or a
// kRefuse*), its message at msg_off[i], msg_len[i] in *msgs (one malloc'd
// buffer for sa_free, NULL when no entry failed), and each group's floor
// after the call in applied[k].  Returns the nanoseconds spent.
int64_t sa_apply_run(void** handles, int32_t ngroups, const int64_t* starts,
                     const int64_t* floors, const char* sql,
                     const int64_t* off, const int64_t* len,
                     const int64_t* idx, int32_t* rc, int64_t* msg_off,
                     int64_t* msg_len, char** msgs, int64_t* applied) {
  const int64_t t0 = now_ns();
  std::string text;                    // every message, back to back
  auto note = [&](int64_t i, const Err& e) {
    rc[i] = e.code;
    msg_off[i] = static_cast<int64_t>(text.size());
    msg_len[i] = static_cast<int64_t>(e.msg.size());
    text += e.msg;
  };
  for (int32_t k = 0; k < ngroups; ++k) {
    auto* h = static_cast<Handle*>(handles[k]);
    sqlite3* db = h->db;
    const int64_t s = starts[k], e = starts[k + 1];
    applied[k] = floors[k];
    Err ignored;
    run_fixed(db, h->begin, "BEGIN", &ignored);   // already in one: fine
    int64_t last = 0;
    for (int64_t i = s; i < e; ++i) {
      rc[i] = 0;
      msg_off[i] = msg_len[i] = 0;
      if (h->resume && idx[i] && idx[i] <= floors[k]) {
        rc[i] = kSkipped;              // not attempted (see the COMMIT)
        continue;
      }
      Err err;
      bool ok = run_fixed(db, h->savepoint, "SAVEPOINT _apply", &err) &&
                run_command(db, sql + off[i], len[i], &err) &&
                run_fixed(db, h->release, "RELEASE _apply", &err);
      if (!ok) {
        if (run_fixed(db, h->rollback_to, "ROLLBACK TO _apply", &ignored))
          run_fixed(db, h->release, "RELEASE _apply", &ignored);
        note(i, err);
      }
      if (idx[i] && idx[i] > last) last = idx[i];
    }
    Err err;
    bool ok = (!h->resume || !last || write_meta(db, last, &err)) &&
              commit(h, &err);
    if (ok) {
      if (last) applied[k] = last;
    } else {
      // Nothing of the batch landed: the COMMIT's error is the outcome of
      // every attempted entry without one of its own; then the floor alone,
      // which may only move when it is durable.
      rollback(h);
      for (int64_t i = s; i < e; ++i)
        if (rc[i] == 0) note(i, err);
      if (last) {
        Err retry;
        if (!h->resume || (write_meta(db, last, &retry) && commit(h, &retry)))
          applied[k] = last;
      }
    }
    for (int64_t i = s; i < e; ++i)
      if (rc[i] == kSkipped) rc[i] = 0;
  }
  *msgs = nullptr;
  if (!text.empty()) {
    *msgs = static_cast<char*>(std::malloc(text.size()));
    if (*msgs != nullptr) std::memcpy(*msgs, text.data(), text.size());
  }
  return now_ns() - t0;
}

void sa_free(char* p) { std::free(p); }

}  // extern "C"
