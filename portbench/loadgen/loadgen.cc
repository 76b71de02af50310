// The benchmark's HTTP load generator: a frozen copy of the program's
// native/http_load.cc (a single-thread epoll client over N keep-alive
// connections), extended with the benchmark's traffic:
//
//   - a DDL phase (each statement of the ddl file once per group) and a
//     load phase (record_count rows as multi-row INSERTs, one group per
//     statement), both in set-up;
//   - a closed-loop mix of linearizable reads, one-field updates and
//     whole-record upserts over seeded key generators (YCSB's scrambled
//     zipfian or etcd's sequential keys), first for warmup_s
//     seconds, then for the measured window;
//   - X-Raft-Group routing, group = fnv1a64(key) % groups;
//   - a record of every request (op, group, key, statement, response
//     status and, for reads, the body; send and receive times).
//
// Usage: loadgen <params file>          run against a server
//        loadgen <params file> --dump N print N generated (op, key)
//                                        pairs of connection 0, no network
// The params file holds one "name value" pair a line (see portbench/run.py
// for the names).  Stdout carries "OPEN <t>" and "CLOSE <t>" lines at the
// window's edges (CLOCK_MONOTONIC seconds) and a last JSON line of counts.
//
// Record file, little-endian, one record after another:
//   u8 op | u8 phase | u16 status | u32 group | i64 t_send_ns |
//   i64 t_recv_ns (-1: no response) | u16 key_len | u32 sql_len |
//   u32 body_len | key | sql | body
// op: 0 ddl, 1 load, 2 read, 3 update, 4 upsert; phase: 0 set-up,
// 1 warm-up, 2 window (the phase the request was SENT in).

#include <algorithm>
#include <cerrno>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <fcntl.h>
#include <map>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <string>
#include <sys/epoll.h>
#include <sys/socket.h>
#include <unistd.h>
#include <vector>

namespace {

int64_t now_ns() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return int64_t(ts.tv_sec) * 1000000000LL + int64_t(ts.tv_nsec);
}

double ns_s(int64_t ns) { return double(ns) * 1e-9; }

// ---- parameters -------------------------------------------------------

std::map<std::string, std::string> g_par;

std::string par(const char* k) {
  auto it = g_par.find(k);
  if (it == g_par.end()) {
    fprintf(stderr, "loadgen: missing parameter %s\n", k);
    exit(2);
  }
  return it->second;
}
double pard(const char* k) { return atof(par(k).c_str()); }
long long parl(const char* k) { return atoll(par(k).c_str()); }

void read_params(const char* path) {
  FILE* f = fopen(path, "r");
  if (!f) {
    fprintf(stderr, "loadgen: cannot open %s\n", path);
    exit(2);
  }
  char line[65536];
  while (fgets(line, sizeof line, f)) {
    std::string s(line);
    while (!s.empty() && (s.back() == '\n' || s.back() == '\r')) s.pop_back();
    size_t sp = s.find(' ');
    if (sp == std::string::npos) continue;
    g_par[s.substr(0, sp)] = s.substr(sp + 1);
  }
  fclose(f);
}

std::vector<std::string> split(const std::string& s, char sep) {
  std::vector<std::string> out;
  size_t a = 0;
  for (;;) {
    size_t b = s.find(sep, a);
    out.push_back(s.substr(a, b == std::string::npos ? b : b - a));
    if (b == std::string::npos) break;
    a = b + 1;
  }
  return out;
}

// ---- seeded generators ------------------------------------------------

struct Rng {  // splitmix64
  uint64_t s;
  explicit Rng(uint64_t seed) : s(seed) {}
  uint64_t next() {
    uint64_t z = (s += 0x9E3779B97F4A7C15ULL);
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
    return z ^ (z >> 31);
  }
  double uniform() { return double(next() >> 11) * (1.0 / 9007199254740992.0); }
};

// YCSB's Utils.fnvhash64: FNV-1a over the 8 bytes of a long, then abs.
int64_t ycsb_fnv(int64_t val) {
  uint64_t h = 0xCBF29CE484222325ULL;
  uint64_t v = uint64_t(val);
  for (int i = 0; i < 8; ++i) {
    h ^= v & 0xff;
    v >>= 8;
    h *= 1099511628211ULL;
  }
  int64_t r = int64_t(h);
  return r < 0 ? -r : r;
}

// FNV-1a 64 over a string: the group of a key.
uint64_t fnv1a(const std::string& s) {
  uint64_t h = 0xCBF29CE484222325ULL;
  for (unsigned char c : s) {
    h ^= c;
    h *= 1099511628211ULL;
  }
  return h;
}

// YCSB's ScrambledZipfianGenerator: a zipfian rank over 10^10 items
// (zeta precomputed for the constant 0.99, as YCSB does), hashed onto
// the keyspace, so the hot keys are the same whatever the seed.
struct Zipf {
  double theta, alpha, zetan, eta, zeta2;
  int64_t items;
  Zipf(double constant, int64_t n, double zeta_n) {
    theta = constant;
    items = n;
    zetan = zeta_n;
    zeta2 = 1.0 + std::pow(0.5, theta);
    alpha = 1.0 / (1.0 - theta);
    eta = (1.0 - std::pow(2.0 / double(n), 1.0 - theta)) /
          (1.0 - zeta2 / zetan);
  }
  int64_t rank(double u) const {
    double uz = u * zetan;
    if (uz < 1.0) return 0;
    if (uz < 1.0 + std::pow(0.5, theta)) return 1;
    return int64_t(double(items) * std::pow(eta * u - eta + 1.0, alpha));
  }
};

const int64_t kZipfItems = 10000000000LL;     // YCSB ITEM_COUNT
const double kZipfZeta099 = 26.46902820178302;  // YCSB ZETAN, 0.99

struct Gen {
  std::string dist;       // zipfian | sequential
  std::string key_kind;   // ycsb | seq8
  int64_t space = 1;
  double read_p = 0, update_p = 0, upsert_p = 0;
  Zipf* zipf = nullptr;
  uint64_t seq = 0;       // sequential keys: one counter for all clients
};
Gen g_gen;

std::string key_name(int64_t keynum) {
  char buf[48];
  if (g_gen.key_kind == "ycsb") {
    snprintf(buf, sizeof buf, "user%lld", (long long)ycsb_fnv(keynum));
  } else {
    snprintf(buf, sizeof buf, "%08lld", (long long)keynum);
  }
  return buf;
}

int64_t next_keynum(Rng& r) {
  if (g_gen.dist == "sequential") return int64_t(g_gen.seq++ % uint64_t(g_gen.space));
  int64_t rk = g_gen.zipf->rank(r.uniform());
  return ycsb_fnv(rk) % g_gen.space;
}

int next_op(Rng& r) {
  double u = r.uniform();
  if (u < g_gen.read_p) return 2;
  if (u < g_gen.read_p + g_gen.update_p) return 3;
  return 4;
}

const char kAlnum[] =
    "0123456789abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ";

// A field value of `len` characters: a prefix naming the connection and
// its request (so every written value is distinct), the rest random.
std::string value(Rng& r, uint32_t conn, uint64_t k, int len) {
  char pre[40];
  int n = snprintf(pre, sizeof pre, "c%ur%llu.", conn, (unsigned long long)k);
  std::string v(pre, size_t(std::min(n, len)));
  while (int(v.size()) < len) v.push_back(kAlnum[r.next() % 62]);
  return v;
}

// ---- connections --------------------------------------------------------

struct Req {
  int op = 0;
  int phase = 0;
  uint32_t group = 0;
  std::string key, sql;
  bool linear = false;
};

struct Conn {
  int fd = -1;
  uint32_t id = 0;
  uint64_t k = 0;
  Rng rng{0};
  bool busy = false;       // a request is in flight
  bool want_out = false;
  std::string out;
  size_t off = 0;
  std::string in;
  Req req;
  int64_t t0 = 0;
};

int g_ep = -1;
int g_groups = 1;
FILE* g_rec = nullptr;
std::string g_table, g_keycol;
std::vector<std::string> g_fields;
int g_flen = 0;

void set_mask(Conn& c, bool want_out) {
  if (want_out == c.want_out) return;
  c.want_out = want_out;
  epoll_event ev{};
  ev.events = EPOLLIN | (want_out ? EPOLLOUT : 0u);
  ev.data.u32 = c.id;
  epoll_ctl(g_ep, EPOLL_CTL_MOD, c.fd, &ev);
}

void write_record(const Req& q, int status, int64_t t0, int64_t t1,
                  const std::string& body) {
  uint8_t op = uint8_t(q.op), ph = uint8_t(q.phase);
  uint16_t st = uint16_t(status);
  uint32_t grp = q.group;
  uint16_t kl = uint16_t(q.key.size());
  uint32_t sl = uint32_t(q.sql.size()), bl = uint32_t(body.size());
  fwrite(&op, 1, 1, g_rec);
  fwrite(&ph, 1, 1, g_rec);
  fwrite(&st, 2, 1, g_rec);
  fwrite(&grp, 4, 1, g_rec);
  fwrite(&t0, 8, 1, g_rec);
  fwrite(&t1, 8, 1, g_rec);
  fwrite(&kl, 2, 1, g_rec);
  fwrite(&sl, 4, 1, g_rec);
  fwrite(&bl, 4, 1, g_rec);
  fwrite(q.key.data(), 1, q.key.size(), g_rec);
  fwrite(q.sql.data(), 1, q.sql.size(), g_rec);
  fwrite(body.data(), 1, body.size(), g_rec);
}

void send_req(Conn& c, Req q) {
  char head[256];
  int hlen = snprintf(head, sizeof head,
                      "%s / HTTP/1.1\r\nHost: b\r\nX-Raft-Group: %u\r\n%s"
                      "Content-Length: %zu\r\n\r\n",
                      q.op == 2 ? "GET" : "PUT", q.group,
                      q.linear ? "X-Consistency: linear\r\n" : "",
                      q.sql.size());
  c.out.assign(head, size_t(hlen));
  c.out.append(q.sql);
  c.off = 0;
  c.in.clear();
  c.req = std::move(q);
  c.busy = true;
  c.t0 = now_ns();
}

bool pump_write(Conn& c) {
  while (c.off < c.out.size()) {
    ssize_t w = send(c.fd, c.out.data() + c.off, c.out.size() - c.off,
                     MSG_NOSIGNAL);
    if (w > 0) {
      c.off += size_t(w);
    } else if (w < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
      set_mask(c, true);
      return true;
    } else {
      return false;
    }
  }
  set_mask(c, false);
  return true;
}

// 0 incomplete, else the status; body set on completion; -1 malformed.
int response_complete(const std::string& in, std::string& body) {
  size_t hend = in.find("\r\n\r\n");
  if (hend == std::string::npos) return 0;
  if (in.size() < 12 || in.compare(0, 9, "HTTP/1.1 ") != 0) return -1;
  int status = atoi(in.c_str() + 9);
  size_t clen = 0;
  size_t p = in.find("\r\n");
  while (p < hend) {
    size_t q = in.find("\r\n", p + 2);
    if (q == std::string::npos || q > hend) q = hend;
    if (q > p + 2) {
      std::string line = in.substr(p + 2, q - p - 2);
      for (auto& ch : line) ch = char(tolower(ch));
      if (line.rfind("content-length:", 0) == 0)
        clen = size_t(atoll(line.c_str() + 15));
    }
    p = q;
  }
  if (in.size() < hend + 4 + clen) return 0;
  body = in.substr(hend + 4, clen);
  return status > 0 ? status : -1;
}

Req mix_req(Conn& c, int phase) {
  Req q;
  q.phase = phase;
  q.op = next_op(c.rng);
  q.key = key_name(next_keynum(c.rng));
  q.group = uint32_t(fnv1a(q.key) % uint64_t(g_groups));
  if (q.op == 2) {
    q.sql = "SELECT * FROM " + g_table + " WHERE " + g_keycol + "='" +
            q.key + "'";
    q.linear = true;
  } else if (q.op == 3) {
    const std::string& f = g_fields[c.rng.next() % g_fields.size()];
    q.sql = "UPDATE " + g_table + " SET " + f + "='" +
            value(c.rng, c.id, c.k, g_flen) + "' WHERE " + g_keycol + "='" +
            q.key + "'";
  } else {
    q.sql = "INSERT OR REPLACE INTO " + g_table + " (" + g_keycol;
    for (auto& f : g_fields) q.sql += ", " + f;
    q.sql += ") VALUES ('" + q.key + "'";
    for (size_t i = 0; i < g_fields.size(); ++i)
      q.sql += ", '" + value(c.rng, c.id, c.k, g_flen) + "'";
    q.sql += ")";
  }
  c.k++;
  return q;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 2) {
    fprintf(stderr, "usage: %s params [--dump N]\n", argv[0]);
    return 2;
  }
  read_params(argv[1]);
  uint64_t seed = uint64_t(strtoull(par("seed").c_str(), nullptr, 10));
  g_groups = int(parl("groups"));
  g_table = par("table");
  g_keycol = par("key_column");
  g_fields = split(par("fields"), ',');
  g_flen = int(parl("field_length"));
  g_gen.dist = par("key_dist");
  g_gen.key_kind = par("key_kind");
  g_gen.space = parl("key_space");
  g_gen.read_p = pard("read");
  g_gen.update_p = pard("update");
  g_gen.upsert_p = pard("upsert");
  if (g_gen.space < 1 || g_groups < 1 || g_fields.empty()) {
    fprintf(stderr, "loadgen: bad parameters\n");
    return 2;
  }
  if (g_gen.dist == "zipfian") {
    double c = pard("zipf_constant");
    if (std::fabs(c - 0.99) > 1e-12) {
      fprintf(stderr, "loadgen: scrambled zipfian needs the constant 0.99\n");
      return 2;
    }
    g_gen.zipf = new Zipf(c, kZipfItems, kZipfZeta099);
  } else if (g_gen.dist != "sequential") {
    fprintf(stderr, "loadgen: unknown key_dist %s\n", g_gen.dist.c_str());
    return 2;
  }
  int conns = int(parl("conns"));

  if (argc >= 4 && strcmp(argv[2], "--dump") == 0) {
    long n = atol(argv[3]);
    Conn c;
    c.id = 0;
    c.rng = Rng(seed * 1000003ULL + 0);
    for (long i = 0; i < n; ++i) {
      Req q = mix_req(c, 2);
      printf("%d %s %u\n", q.op, q.key.c_str(), q.group);
    }
    return 0;
  }

  int port = int(parl("port"));
  double warmup_s = pard("warmup_s"), seconds = pard("seconds");
  double drain_s = pard("drain_s");
  int64_t records = parl("record_count");
  int load_batch = int(parl("load_batch"));
  g_rec = fopen(par("records").c_str(), "wb");
  if (!g_rec) {
    fprintf(stderr, "loadgen: cannot open the record file\n");
    return 2;
  }
  setvbuf(g_rec, nullptr, _IOFBF, 1 << 20);

  g_ep = epoll_create1(0);
  std::vector<Conn> cs(static_cast<size_t>(conns));
  for (int i = 0; i < conns; ++i) {
    Conn& c = cs[size_t(i)];
    c.id = uint32_t(i);
    c.rng = Rng(seed * 1000003ULL + uint64_t(i));
    c.fd = socket(AF_INET, SOCK_STREAM, 0);
    if (c.fd < 0) {
      fprintf(stderr, "socket: %s\n", strerror(errno));
      return 3;
    }
    sockaddr_in a{};
    a.sin_family = AF_INET;
    a.sin_port = htons(uint16_t(port));
    a.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
    if (connect(c.fd, reinterpret_cast<sockaddr*>(&a), sizeof a) != 0) {
      fprintf(stderr, "connect: %s\n", strerror(errno));
      return 3;
    }
    int one = 1;
    setsockopt(c.fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
    fcntl(c.fd, F_SETFL, fcntl(c.fd, F_GETFL, 0) | O_NONBLOCK);
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.u32 = uint32_t(i);
    epoll_ctl(g_ep, EPOLL_CTL_ADD, c.fd, &ev);
  }

  // Set-up work: the DDL statements once per group, then the load
  // phase's INSERTs (record_count rows, load_batch rows a statement,
  // one group a statement), handed out to whichever connection is free.
  std::vector<Req> setup;
  {
    std::vector<std::string> ddl = split(par("ddl"), ';');
    for (auto& s : ddl) {
      if (s.empty()) continue;
      for (int g = 0; g < g_groups; ++g) {
        Req q;
        q.op = 0;
        q.group = uint32_t(g);
        q.sql = s;
        setup.push_back(q);
      }
    }
  }
  size_t n_ddl = setup.size();
  if (records > 0) {
    std::vector<std::vector<int64_t>> by_group(static_cast<size_t>(g_groups));
    for (int64_t k = 0; k < records; ++k)
      by_group[fnv1a(key_name(k)) % uint64_t(g_groups)].push_back(k);
    Rng lr(seed * 1000003ULL + uint64_t(conns) + 7);
    for (int g = 0; g < g_groups; ++g) {
      auto& ks = by_group[size_t(g)];
      for (size_t a = 0; a < ks.size(); a += size_t(load_batch)) {
        Req q;
        q.op = 1;
        q.group = uint32_t(g);
        q.sql = "INSERT INTO " + g_table + " (" + g_keycol;
        for (auto& f : g_fields) q.sql += ", " + f;
        q.sql += ") VALUES ";
        size_t b = std::min(ks.size(), a + size_t(load_batch));
        for (size_t i = a; i < b; ++i) {
          q.sql += (i > a ? ", ('" : "('") + key_name(ks[i]) + "'";
          for (size_t f = 0; f < g_fields.size(); ++f)
            q.sql += ", '" + value(lr, 0xFFFFFFFFu, uint64_t(ks[i]) * 16 + f,
                                   g_flen) + "'";
          q.sql += ")";
        }
        setup.push_back(q);
      }
    }
  }

  uint64_t n_ok = 0, n_err = 0, n_none = 0, attempted = 0, win_ok = 0;
  size_t next_setup = 0, setup_done = 0;
  bool setup_failed = false;
  // Phases: 0 set-up, 1 warm-up, 2 window, 3 drain.
  int phase = setup.empty() ? 1 : 0;
  int64_t t_warm = phase == 1 ? now_ns() : 0, t_open = 0, t_close = 0;
  int64_t t_drain_end = 0;
  int live = 0;

  auto start_next = [&](Conn& c) -> bool {
    if (phase == 0) {
      if (next_setup >= setup.size()) return false;
      // DDL first, wholly, before any load statement.
      if (next_setup >= n_ddl && setup_done < n_ddl) return false;
      send_req(c, setup[next_setup++]);
    } else if (phase == 1 || phase == 2) {
      send_req(c, mix_req(c, phase));
      if (phase == 2) ++attempted;
    } else {
      return false;
    }
    ++live;
    if (!pump_write(c)) {
      fprintf(stderr, "loadgen: send failed on connection %u\n", c.id);
      exit(4);
    }
    return true;
  };

  printf("PHASE connected %.9f\n", ns_s(now_ns()));
  fflush(stdout);
  for (auto& c : cs) start_next(c);
  epoll_event evs[512];
  bool said_ddl = n_ddl == 0;
  for (;;) {
    int64_t now = now_ns();
    if (phase == 0 && setup_done == setup.size()) {
      if (setup_failed) {
        fprintf(stderr, "loadgen: a set-up statement failed\n");
        return 5;
      }
      phase = 1;
      t_warm = now;
      printf("PHASE warm-up %.9f\n", ns_s(now));
      fflush(stdout);
      for (auto& c : cs)
        if (!c.busy) start_next(c);
    }
    if (phase == 1 && now >= t_warm + int64_t(warmup_s * 1e9)) {
      phase = 2;
      t_open = now;
      printf("OPEN %.9f\n", ns_s(t_open));
      fflush(stdout);
    }
    if (phase == 2 && now >= t_open + int64_t(seconds * 1e9)) {
      phase = 3;
      t_close = now;
      t_drain_end = now + int64_t(drain_s * 1e9);
      printf("CLOSE %.9f\n", ns_s(t_close));
      fflush(stdout);
    }
    if (phase == 3 && (live == 0 || now >= t_drain_end)) break;
    if (!said_ddl && setup_done >= n_ddl) {
      said_ddl = true;
      printf("PHASE ddl-done %.9f\n", ns_s(now));
      fflush(stdout);
    }
    if (phase == 0 && next_setup < setup.size() && setup_done >= n_ddl) {
      for (auto& c : cs)
        if (!c.busy && next_setup < setup.size()) start_next(c);
    }
    int n = epoll_wait(g_ep, evs, 512, 20);
    for (int e = 0; e < n; ++e) {
      Conn& c = cs[evs[e].data.u32];
      if (!c.busy) continue;
      if (c.off < c.out.size()) {
        if (!pump_write(c)) {
          fprintf(stderr, "loadgen: send failed on connection %u\n", c.id);
          return 4;
        }
        if (c.off < c.out.size()) continue;
      }
      if (!(evs[e].events & (EPOLLIN | EPOLLHUP | EPOLLERR))) continue;
      char buf[16384];
      bool closed = false;
      for (;;) {
        ssize_t r = recv(c.fd, buf, sizeof buf, 0);
        if (r > 0) {
          c.in.append(buf, size_t(r));
          continue;
        }
        if (r < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) break;
        closed = true;
        break;
      }
      std::string body;
      int st = response_complete(c.in, body);
      if (st == 0 && !closed) continue;
      int64_t t1 = now_ns();
      if (st <= 0) {
        fprintf(stderr, "loadgen: connection %u closed or answered "
                "malformed bytes\n", c.id);
        return 4;
      }
      bool ok = (c.req.op == 2) ? st == 200 : st == 204;
      if (ok) ++n_ok; else ++n_err;
      if (ok && phase >= 2 && t1 >= t_open && (t_close == 0 || t1 <= t_close))
        ++win_ok;
      if (c.req.op <= 1) {
        ++setup_done;
        if (!ok) {
          setup_failed = true;
          fprintf(stderr, "loadgen: set-up statement on group %u: %d %s\n",
                  c.req.group, st, body.substr(0, 300).c_str());
        }
      }
      std::string keep = (c.req.op == 2 || !ok) ? body : std::string();
      write_record(c.req, st, c.t0, t1, keep);
      c.busy = false;
      --live;
      start_next(c);
    }
  }
  for (auto& c : cs) {
    if (c.busy) {
      ++n_none;
      write_record(c.req, 0, c.t0, -1, std::string());
    }
    close(c.fd);
  }
  fclose(g_rec);
  printf("{\"ok\": %llu, \"errors\": %llu, \"unanswered\": %llu, "
         "\"attempted\": %llu, \"window_ok\": %llu, \"open\": %.9f, "
         "\"close\": %.9f, \"warm\": %.9f, \"setup_statements\": %zu}\n",
         (unsigned long long)n_ok, (unsigned long long)n_err,
         (unsigned long long)n_none, (unsigned long long)attempted,
         (unsigned long long)win_ok, ns_s(t_open), ns_s(t_close),
         ns_s(t_warm), setup.size());
  return 0;
}
