// HTTP load generator (the repo's `wrk`); port of
// raftsql_tpu/native/http_load.cc, the same program.
//
// The bench measures the SERVER; a Python load generator costs
// ~120-250us of interpreter time per request and, on a small host,
// competes with the server for the same cores — at 192 clients the
// Python clients alone saturate a core and the measurement reads as a
// server ceiling.  This is a single-thread epoll client: N keep-alive
// connections round-robin over the API ports, each looping
// PUT-INSERT -> 204/400, with per-request wall-clock latency recorded.
//
// Usage: http_load <seconds> <conns> <groups> <port> [port ...]
// Output: one JSON line on stdout:
//   {"n": completed, "errors": E, "p50_ms": .., "p99_ms": .., "secs": ..}
//
// Build: g++ -O2 -o http_load http_load.cc
// (native/build.py build_http_load does this, into build/native/)

#include <algorithm>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <string>
#include <sys/epoll.h>
#include <sys/socket.h>
#include <unistd.h>
#include <vector>

namespace {

double now_s() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return double(ts.tv_sec) + 1e-9 * double(ts.tv_nsec);
}

struct Conn {
  int fd = -1;
  uint32_t id = 0;
  uint64_t k = 0;          // per-conn request counter (unique bodies)
  bool writing = true;
  bool want_out = false;   // EPOLLOUT currently registered
  std::string out;         // request bytes pending write
  size_t off = 0;
  std::string in;          // response bytes so far
  double t0 = 0;
  bool done = false;
};

int g_groups = 1;
int g_ep = -1;

void set_mask(Conn& c, bool want_out) {
  if (want_out == c.want_out) return;
  c.want_out = want_out;
  epoll_event ev{};
  ev.events = EPOLLIN | (want_out ? EPOLLOUT : 0u);
  ev.data.u32 = c.id;
  epoll_ctl(g_ep, EPOLL_CTL_MOD, c.fd, &ev);
}

void build_request(Conn& c) {
  char body[96];
  int blen = snprintf(body, sizeof body,
                      "INSERT INTO t (v) VALUES ('n%u_%llu')", c.id,
                      (unsigned long long)c.k);
  uint64_t g = (c.id + c.k) % uint64_t(g_groups);
  char head[160];
  int hlen = snprintf(head, sizeof head,
                      "PUT / HTTP/1.1\r\nHost: b\r\nX-Raft-Group: %llu"
                      "\r\nContent-Length: %d\r\n\r\n",
                      (unsigned long long)g, blen);
  c.k++;
  c.out.assign(head, size_t(hlen));
  c.out.append(body, size_t(blen));
  c.off = 0;
  c.in.clear();
  c.writing = true;
  c.t0 = now_s();
}

// true = keep connection, false = caller must close (fatal send error).
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
  c.writing = false;
  set_mask(c, false);
  return true;
}

// Returns: 0 incomplete, 1 complete-success (204 — the Python client
// fallback's success criterion: a unique INSERT must commit; any other
// status is a failed request), -1 complete-failure or malformed.
int response_complete(const std::string& in) {
  size_t hend = in.find("\r\n\r\n");
  if (hend == std::string::npos) return 0;
  if (in.size() < 12 || in.compare(0, 9, "HTTP/1.1 ") != 0) return -1;
  int status = atoi(in.c_str() + 9);
  size_t clen = 0;
  size_t p = in.find("\r\n");       // minimal content-length scan
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
  return status == 204 ? 1 : -1;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 5) {
    fprintf(stderr, "usage: %s seconds conns groups port...\n", argv[0]);
    return 2;
  }
  double seconds = atof(argv[1]);
  int conns = atoi(argv[2]);
  g_groups = atoi(argv[3]);
  std::vector<int> ports;
  for (int i = 4; i < argc; ++i) ports.push_back(atoi(argv[i]));

  g_ep = epoll_create1(0);
  std::vector<Conn> cs(static_cast<size_t>(conns));
  std::vector<double> lats;
  lats.reserve(1 << 20);
  uint64_t errors = 0;
  int live = conns;

  auto drop = [&](Conn& c) {
    ++errors;
    c.done = true;
    --live;
    close(c.fd);
  };

  for (int i = 0; i < conns; ++i) {
    Conn& c = cs[size_t(i)];
    c.id = uint32_t(i);
    c.fd = socket(AF_INET, SOCK_STREAM, 0);
    sockaddr_in a{};
    a.sin_family = AF_INET;
    a.sin_port = htons(uint16_t(ports[size_t(i) % ports.size()]));
    a.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
    if (connect(c.fd, reinterpret_cast<sockaddr*>(&a), sizeof a) != 0) {
      fprintf(stderr, "connect: %s\n", strerror(errno));
      return 3;
    }
    int one = 1;
    setsockopt(c.fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
    fcntl(c.fd, F_SETFL, fcntl(c.fd, F_GETFL, 0) | O_NONBLOCK);
    epoll_event ev{};
    ev.events = EPOLLIN;       // EPOLLOUT only while a write is pending
    ev.data.u32 = uint32_t(i);
    epoll_ctl(g_ep, EPOLL_CTL_ADD, c.fd, &ev);
  }

  double start = now_s(), stop_at = start + seconds;
  for (auto& c : cs) {
    build_request(c);
    if (!pump_write(c)) drop(c);
  }

  epoll_event evs[256];
  while (live > 0) {
    int n = epoll_wait(g_ep, evs, 256, 200);
    double now = now_s();
    if (now > stop_at + 5.0) break;      // drain cap for stragglers
    if (n == 0 && now > stop_at) break;  // idle past the deadline
    for (int e = 0; e < n; ++e) {
      Conn& c = cs[evs[e].data.u32];
      if (c.done) continue;
      if (c.writing) {
        if (!pump_write(c)) {
          drop(c);
          continue;
        }
        if (c.writing) continue;         // still pending; wait EPOLLOUT
      }
      if (!(evs[e].events & EPOLLIN)) continue;
      char buf[8192];
      for (;;) {
        ssize_t r = recv(c.fd, buf, sizeof buf, 0);
        if (r > 0) {
          c.in.append(buf, size_t(r));
          int st = response_complete(c.in);
          if (st == 0) continue;
          if (st == 1) {
            lats.push_back(now_s() - c.t0);
          } else {
            ++errors;
          }
          if (now_s() < stop_at) {
            build_request(c);
            if (!pump_write(c)) drop(c);
          } else {
            c.done = true;
            --live;
            close(c.fd);
          }
          break;
        } else if (r < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
          break;
        } else {                        // closed or hard error
          drop(c);
          break;
        }
      }
    }
  }

  double secs = now_s() - start;
  std::sort(lats.begin(), lats.end());
  auto pct = [&](double p) {
    if (lats.empty()) return 0.0;
    size_t i = size_t(p * double(lats.size() - 1));
    return lats[i] * 1e3;
  };
  printf("{\"n\": %zu, \"errors\": %llu, \"p50_ms\": %.3f, "
         "\"p99_ms\": %.3f, \"secs\": %.3f}\n",
         lats.size(), (unsigned long long)errors, pct(0.5), pct(0.99),
         secs);
  return 0;
}
