// Native TCPStore: epoll daemon + blocking client, C ABI for ctypes.
//
// Parity surface: torch c10d TCPStore (TCPStore.hpp:51-105 — master daemon
// architecture, default port 29500) and its libuv-backed daemon
// (TCPStoreBackend.hpp), SURVEY.md §2.2 N5. This is the control-plane KV
// store under rendezvous, barriers, the debug wrapper and elastic restart;
// the data plane (collectives) is XLA/ICI and never touches it.
//
// Wire protocol (shared with the Python fallback in store.py):
//   request : [u8 cmd][u32 klen][key][u32 vlen][value]
//   response: [u32 len][payload]
// Commands: 1=SET 2=GET 3=ADD 4=CHECK 5=COMPARE_SET 6=DELETE 7=NUMKEYS 8=PING
//
// Build: make -C pytorch_distributed_example_tpu/csrc    (produces libtdx.so)

#include <arpa/inet.h>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <string>
#include <sys/epoll.h>
#include <fcntl.h>
#include <poll.h>
#include <algorithm>
#include <sys/socket.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

enum Cmd : uint8_t {
  CMD_SET = 1,
  CMD_GET = 2,
  CMD_ADD = 3,
  CMD_CHECK = 4,
  CMD_COMPARE_SET = 5,
  CMD_DELETE = 6,
  CMD_NUMKEYS = 7,
  CMD_PING = 8,
};

// ---------------------------------------------------------------- utils --
bool send_all(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n > 0) {
    ssize_t w = ::send(fd, p, n, MSG_NOSIGNAL);
    if (w <= 0) {
      if (w < 0 && errno == EINTR) continue;
      if (w < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
        // daemon sockets are non-blocking (accept4 SOCK_NONBLOCK): a large
        // response can overrun the send buffer — wait for writability
        struct pollfd pf{fd, POLLOUT, 0};
        if (::poll(&pf, 1, 30000) <= 0) return false;
        continue;
      }
      return false;
    }
    p += w;
    n -= static_cast<size_t>(w);
  }
  return true;
}

bool recv_all(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n > 0) {
    ssize_t r = ::recv(fd, p, n, 0);
    if (r <= 0) {
      if (r < 0 && errno == EINTR) continue;
      return false;
    }
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

// --------------------------------------------------------------- daemon --
// Per-connection framing: sockets are non-blocking; each connection owns a
// byte buffer that accumulates on EPOLLIN and is parsed for complete frames.
// A client stalled mid-frame therefore blocks only itself, never the loop
// (the Python fallback daemon gets the same isolation from its
// thread-per-client design).
struct Conn {
  std::string buf;
};

struct Daemon {
  int listen_fd = -1;
  int epoll_fd = -1;
  int port = 0;
  std::thread thr;
  std::mutex mu;
  std::map<std::string, std::string> data;
  std::map<int, Conn> conns;
  std::vector<char> readbuf;  // loop-only; daemon is single-threaded
  volatile bool stop_flag = false;

  std::string dispatch(uint8_t cmd, const std::string& key, std::string&& val) {
    std::lock_guard<std::mutex> lock(mu);
    switch (cmd) {
      case CMD_SET:
        data[key] = std::move(val);
        return "ok";
      // CMD_GET is answered by drain_frames' zero-copy fast path and
      // never reaches dispatch()
      case CMD_ADD: {
        long long cur = 0;
        auto it = data.find(key);
        if (it != data.end()) cur = atoll(it->second.c_str());
        cur += atoll(val.c_str());
        data[key] = std::to_string(cur);
        return data[key];
      }
      case CMD_CHECK: {
        size_t start = 0;
        bool ok = true;
        if (!val.empty()) {
          while (start <= val.size()) {
            size_t end = val.find('\0', start);
            if (end == std::string::npos) end = val.size();
            std::string k = val.substr(start, end - start);
            if (!k.empty() && data.find(k) == data.end()) ok = false;
            if (end >= val.size()) break;
            start = end + 1;
          }
        }
        return std::string(ok ? "\x01" : "\x00", 1);
      }
      case CMD_COMPARE_SET: {
        if (val.size() < 4) return "err";
        uint32_t elen;
        memcpy(&elen, val.data(), 4);
        if (4 + static_cast<size_t>(elen) > val.size()) return "err";
        std::string expected = val.substr(4, elen);
        std::string desired = val.substr(4 + elen);
        auto it = data.find(key);
        if ((it == data.end() && expected.empty()) ||
            (it != data.end() && it->second == expected)) {
          data[key] = desired;
          return desired;
        }
        return it != data.end() ? it->second : expected;
      }
      case CMD_DELETE: {
        size_t n = data.erase(key);
        return std::string(n ? "\x01" : "\x00", 1);
      }
      case CMD_NUMKEYS:
        return std::to_string(data.size());
      case CMD_PING:
        return "pong";
    }
    return "err";
  }

  // Parse and answer every complete frame in c.buf. Returns false on a
  // malformed frame (connection should be dropped).
  bool drain_frames(int fd, Conn& c) {
    for (;;) {
      if (c.buf.size() < 5) return true;
      uint8_t cmd = static_cast<uint8_t>(c.buf[0]);
      uint32_t klen;
      memcpy(&klen, c.buf.data() + 1, 4);
      if (klen > (64u << 20)) return false;
      if (c.buf.size() < 5 + static_cast<size_t>(klen) + 4) return true;
      uint32_t vlen;
      memcpy(&vlen, c.buf.data() + 5 + klen, 4);
      if (vlen > (256u << 20)) return false;
      size_t total = 5 + static_cast<size_t>(klen) + 4 + vlen;
      if (c.buf.size() < total) return true;
      std::string key = c.buf.substr(5, klen);
      std::string val = c.buf.substr(5 + klen + 4, vlen);
      c.buf.erase(0, total);
      if (cmd == CMD_GET) {
        // zero-copy response for the data-plane hot path: stream the
        // stored value straight out of the map instead of building a
        // [len][flag][value] string (two O(bytes) copies per GET)
        std::lock_guard<std::mutex> lock(mu);
        auto it = data.find(key);
        if (it == data.end()) {
          uint32_t rlen = 1;
          char miss[5];
          memcpy(miss, &rlen, 4);
          miss[4] = '\x00';
          if (!send_all(fd, miss, 5)) return false;
        } else {
          uint32_t rlen = static_cast<uint32_t>(1 + it->second.size());
          char hdr[5];
          memcpy(hdr, &rlen, 4);
          hdr[4] = '\x01';
          if (!send_all(fd, hdr, 5)) return false;
          if (!it->second.empty() &&
              !send_all(fd, it->second.data(), it->second.size()))
            return false;
        }
        continue;
      }
      // move the value into dispatch: SET stores it without another
      // O(bytes) copy (matters on the chunked p2p data-plane path)
      std::string resp = dispatch(cmd, key, std::move(val));
      uint32_t rlen = static_cast<uint32_t>(resp.size());
      std::string out;
      out.append(reinterpret_cast<char*>(&rlen), 4);
      out.append(resp);
      if (!send_all(fd, out.data(), out.size())) return false;
    }
  }

  void loop() {
    epoll_event evs[64];
    while (!stop_flag) {
      int n = epoll_wait(epoll_fd, evs, 64, 100);
      for (int i = 0; i < n; i++) {
        int fd = evs[i].data.fd;
        if (fd == listen_fd) {
          for (;;) {
            int c = accept4(listen_fd, nullptr, nullptr, SOCK_NONBLOCK);
            if (c < 0) break;
            int one = 1;
            setsockopt(c, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
            epoll_event ev{};
            ev.events = EPOLLIN;
            ev.data.fd = c;
            epoll_ctl(epoll_fd, EPOLL_CTL_ADD, c, &ev);
            conns[c] = Conn{};
          }
        } else {
          bool dead = false;
          // 1 MB read buffer (heap, shared across conns): with a 64 KB
          // buffer a multi-MB payload costs dozens of recv+epoll round
          // trips that each ping-pong schedulers with the sender —
          // measured 3x throughput loss on 4 MB values over loopback
          if (readbuf.empty()) readbuf.resize(1 << 20);
          char* tmp = readbuf.data();
          const size_t tmpsz = readbuf.size();
          for (;;) {
            ssize_t r = ::recv(fd, tmp, tmpsz, 0);
            if (r > 0) {
              conns[fd].buf.append(tmp, static_cast<size_t>(r));
              continue;
            }
            if (r == 0) { dead = true; }
            else if (errno == EAGAIN || errno == EWOULDBLOCK) { /* drained */ }
            else if (errno == EINTR) continue;
            else dead = true;
            break;
          }
          if (!dead && !drain_frames(fd, conns[fd])) dead = true;
          if (dead) {
            epoll_ctl(epoll_fd, EPOLL_CTL_DEL, fd, nullptr);
            close(fd);
            conns.erase(fd);
          }
        }
      }
    }
    for (auto& kv : conns) close(kv.first);
    close(epoll_fd);
    close(listen_fd);
  }
};

// --------------------------------------------------------------- client --
constexpr int kNotSent = -1;
constexpr int kNoResponse = -2;

struct Client {
  int fd = -1;
  std::mutex mu;
  std::string last;  // last response payload

  // 0: the response is in `last`; kNotSent: the request did not fully
  // leave (the daemon applies a request only once all of it has arrived,
  // so it was not applied); kNoResponse: the request was sent and its
  // response was lost (it may have been applied).
  int call(uint8_t cmd, const char* key_p, size_t key_n, const char* val_p,
           size_t val_n, double timeout_s) {
    std::lock_guard<std::mutex> lock(mu);
    // each call waits as long as its own op has left, whatever budget
    // the connection was dialed with
    timeval tv;
    if (timeout_s < 0.001) timeout_s = 0.001;
    tv.tv_sec = static_cast<long>(timeout_s);
    tv.tv_usec = static_cast<long>((timeout_s - tv.tv_sec) * 1e6);
    setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
    setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
    uint32_t klen = static_cast<uint32_t>(key_n);
    uint32_t vlen = static_cast<uint32_t>(val_n);
    // header and value go out as separate send()s: large values would
    // otherwise be copied into a fresh buffer per call (O(bytes) on the
    // p2p data-plane path)
    std::string hdr;
    hdr.reserve(9 + key_n);
    hdr.push_back(static_cast<char>(cmd));
    hdr.append(reinterpret_cast<char*>(&klen), 4);
    hdr.append(key_p, key_n);
    hdr.append(reinterpret_cast<char*>(&vlen), 4);
    if (!send_all(fd, hdr.data(), hdr.size())) return kNotSent;
    if (val_n && !send_all(fd, val_p, val_n)) return kNotSent;
    uint32_t rlen;
    if (!recv_all(fd, &rlen, 4)) return kNoResponse;
    last.resize(rlen);
    if (rlen && !recv_all(fd, last.data(), rlen)) return kNoResponse;
    return 0;
  }
};

}  // namespace

extern "C" {

// -- daemon ---------------------------------------------------------------
void* tdx_store_server_start(const char* host, int port) {
  auto* d = new Daemon();
  d->listen_fd = socket(AF_INET, SOCK_STREAM, 0);
  if (d->listen_fd < 0) {
    delete d;
    return nullptr;
  }
  int one = 1;
  setsockopt(d->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  inet_pton(AF_INET, host, &addr.sin_addr);
  if (bind(d->listen_fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0 ||
      listen(d->listen_fd, 128) != 0) {
    close(d->listen_fd);
    delete d;
    return nullptr;
  }
  socklen_t alen = sizeof(addr);
  getsockname(d->listen_fd, reinterpret_cast<sockaddr*>(&addr), &alen);
  d->port = ntohs(addr.sin_port);
  // non-blocking listener: the accept4 drain loop must not block when the
  // backlog empties
  fcntl(d->listen_fd, F_SETFL, fcntl(d->listen_fd, F_GETFL, 0) | O_NONBLOCK);
  d->epoll_fd = epoll_create1(0);
  epoll_event ev{};
  ev.events = EPOLLIN;
  ev.data.fd = d->listen_fd;
  epoll_ctl(d->epoll_fd, EPOLL_CTL_ADD, d->listen_fd, &ev);
  d->thr = std::thread([d] { d->loop(); });
  return d;
}

int tdx_store_server_port(void* h) { return static_cast<Daemon*>(h)->port; }

void tdx_store_server_stop(void* h) {
  auto* d = static_cast<Daemon*>(h);
  d->stop_flag = true;
  if (d->thr.joinable()) d->thr.join();
  delete d;
}

// -- client ---------------------------------------------------------------
void* tdx_store_client_connect(const char* host, int port, double timeout_s) {
  auto* c = new Client();
  // Budget is wall-clock against a monotonic deadline. (An earlier version
  // debited a flat 1.0s per EINPROGRESS poll; on loopback a refused
  // connect completes the poll in microseconds, so a 120s budget burned
  // in ~6s of wall time and slow-starting peers were never reached.)
  auto now = []() {
    struct timespec t;
    clock_gettime(CLOCK_MONOTONIC, &t);
    return static_cast<double>(t.tv_sec) + t.tv_nsec * 1e-9;
  };
  const double deadline = now() + timeout_s;
  const double step = 0.05;
  while (true) {
    c->fd = socket(AF_INET, SOCK_STREAM, 0);
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons(static_cast<uint16_t>(port));
    inet_pton(AF_INET, host, &addr.sin_addr);
    // non-blocking connect bounded by the caller timeout (a blackholed
    // master must not hold us for the kernel SYN cycle)
    int flags = fcntl(c->fd, F_GETFL, 0);
    fcntl(c->fd, F_SETFL, flags | O_NONBLOCK);
    int rc = connect(c->fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr));
    bool ok = (rc == 0);
    if (!ok && errno == EINPROGRESS) {
      double remaining = deadline - now();
      if (remaining < 0) remaining = 0;
      pollfd pfd{c->fd, POLLOUT, 0};
      int pr = poll(&pfd, 1, static_cast<int>(std::min(remaining, 1.0) * 1000));
      if (pr > 0) {
        int err = 0;
        socklen_t elen = sizeof(err);
        getsockopt(c->fd, SOL_SOCKET, SO_ERROR, &err, &elen);
        ok = (err == 0);
      }
    }
    if (ok) {
      fcntl(c->fd, F_SETFL, flags);  // back to blocking + timeouts below
      int one = 1;
      setsockopt(c->fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      timeval tv;
      tv.tv_sec = static_cast<long>(timeout_s);
      tv.tv_usec = static_cast<long>((timeout_s - tv.tv_sec) * 1e6);
      setsockopt(c->fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
      setsockopt(c->fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
      return c;
    }
    close(c->fd);
    if (now() + step >= deadline) {
      delete c;
      return nullptr;
    }
    struct timespec ts {0, static_cast<long>(step * 1e9)};
    nanosleep(&ts, nullptr);
  }
}

void tdx_store_client_close(void* h) {
  auto* c = static_cast<Client*>(h);
  if (c->fd >= 0) close(c->fd);
  delete c;
}

// Returns the response length; -1 when the request was not (fully) sent,
// so not applied; -2 when it was sent and its response was lost. Waits at
// most timeout_s for each send and receive. Response bytes are fetched
// with tdx_store_client_response (valid until the next call).
long tdx_store_client_call(void* h, int cmd, const char* key, long klen,
                           const char* val, long vlen, double timeout_s) {
  auto* c = static_cast<Client*>(h);
  // zero-copy through the ABI: the Python bytes buffers are sent directly
  int rc = c->call(static_cast<uint8_t>(cmd), key, static_cast<size_t>(klen),
                   val, static_cast<size_t>(vlen), timeout_s);
  if (rc != 0) return rc;
  return static_cast<long>(c->last.size());
}

const char* tdx_store_client_response(void* h) {
  return static_cast<Client*>(h)->last.data();
}

// -- bucket planner (torch _compute_bucket_assignment_by_size parity) -----
// sizes: leaf byte sizes; out_assignment: flattened bucket ids per leaf.
// Returns number of buckets. Greedy size-capped with a smaller first cap
// (reducer.hpp / SURVEY.md §2.2 N6).
long tdx_compute_buckets(const long* sizes, long n, double cap_bytes,
                         double first_cap_bytes, long* out_bucket_ids) {
  long bucket = 0;
  double cur = 0;
  double cap = first_cap_bytes;
  bool any = false;
  for (long i = 0; i < n; i++) {
    if (any && cur + static_cast<double>(sizes[i]) > cap) {
      bucket++;
      cur = 0;
      cap = cap_bytes;
      any = false;
    }
    out_bucket_ids[i] = bucket;
    cur += static_cast<double>(sizes[i]);
    any = true;
  }
  return n > 0 ? bucket + 1 : 0;
}

}  // extern "C"
