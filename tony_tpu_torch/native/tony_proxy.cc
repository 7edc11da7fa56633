// tony_proxy: TCP relay, gateway-host port -> in-cluster host:port.
//
// Native production equivalent of the reference's tony-proxy module
// (tony-proxy/src/main/java/com/linkedin/tony/ProxyServer.java:21-91). The
// reference relays with two blocking threads per connection; this is a
// single-threaded epoll event loop — one process handles every notebook /
// TensorBoard tunnel with no thread-per-connection overhead. The pure-Python
// fallback lives in tony_tpu_torch/proxy.py and both print the same
// "proxying 127.0.0.1:<port> -> <host>:<port>" line so launchers can parse
// the bound port.
//
// usage: tony_proxy <remote_host> <remote_port> [local_port]
//
// Connection auth: when the TONY_PROXY_TOKEN env var is set (env, never
// argv — argv is world-readable via /proc), every new connection must
// authenticate before the upstream is even CONNECTED: either a preamble
// line "TONY-PROXY-AUTH <token>\n" (stripped), or an HTTP first block
// carrying "?tony-proxy-token=<token>" in the request line or an
// "Authorization: Bearer <token>" header (forwarded unmodified). Same
// protocol as the Python fallback (tony_tpu_torch/proxy.py), including the
// grace unlock keyed by peer UID on loopback (source IP cannot
// distinguish local users there; /proc/net/tcp records the owner).

#include <arpa/inet.h>
#include <errno.h>
#include <fcntl.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <signal.h>
#include <ctype.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>
#include <sys/epoll.h>
#include <sys/socket.h>
#include <unistd.h>

#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr size_t kBufSize = 64 * 1024;
constexpr int kMaxEvents = 256;
constexpr size_t kAuthMax = 8 * 1024;  // auth must fit the first 8 KB
constexpr long kGraceSec = 600;        // sliding source-address unlock
constexpr long kAuthTimeoutSec = 10;   // pre-auth gate bound (matches
                                       // the Python _AUTH_TIMEOUT_SEC)
const char kAuthPreamble[] = "TONY-PROXY-AUTH ";

bool ConstTimeEq(const std::string& a, const std::string& b) {
  if (a.size() != b.size()) return false;
  unsigned char acc = 0;
  for (size_t i = 0; i < a.size(); ++i)
    acc |= static_cast<unsigned char>(a[i]) ^ static_cast<unsigned char>(b[i]);
  return acc == 0;
}

// HTTP first-block auth: ?token= in the request line or an
// Authorization: Bearer header.
bool CheckHttpAuth(const std::string& buf, const std::string& token) {
  size_t head_end = buf.find("\r\n\r\n");
  std::string head = buf.substr(0, head_end == std::string::npos
                                       ? buf.size() : head_end);
  size_t eol = head.find("\r\n");
  std::string request_line = head.substr(0, eol);
  size_t qmark = request_line.find('?');
  if (qmark != std::string::npos) {
    size_t end = request_line.find(' ', qmark);
    std::string query = request_line.substr(
        qmark + 1, end == std::string::npos ? std::string::npos
                                            : end - qmark - 1);
    size_t pos = 0;
    while (pos <= query.size()) {
      size_t amp = query.find('&', pos);
      std::string pair = query.substr(
          pos, amp == std::string::npos ? std::string::npos : amp - pos);
      // proxy-distinct param: plain ?token= belongs to the proxied app
      // (e.g. Jupyter's own login token)
      if (pair.rfind("tony-proxy-token=", 0) == 0 &&
          ConstTimeEq(pair.substr(17), token)) {
        return true;
      }
      if (amp == std::string::npos) break;
      pos = amp + 1;
    }
  }
  size_t line_start = eol == std::string::npos ? head.size() : eol + 2;
  while (line_start < head.size()) {
    size_t line_end = head.find("\r\n", line_start);
    std::string line = head.substr(
        line_start, line_end == std::string::npos ? std::string::npos
                                                  : line_end - line_start);
    std::string lower;
    for (char c : line)   // unsigned cast: tolower(negative) is UB
      lower.push_back(
          static_cast<char>(tolower(static_cast<unsigned char>(c))));
    if (lower.rfind("authorization:", 0) == 0) {
      std::string value = line.substr(line.find(':') + 1);
      size_t s = value.find_first_not_of(" \t");
      if (s != std::string::npos) value = value.substr(s);
      if (value.rfind("Bearer ", 0) == 0) {
        std::string tok = value.substr(7);
        size_t e = tok.find_last_not_of(" \t\r");
        tok = e == std::string::npos ? "" : tok.substr(0, e + 1);
        if (ConstTimeEq(tok, token)) return true;
      }
    }
    if (line_end == std::string::npos) break;
    line_start = line_end + 2;
  }
  return false;
}

struct Pipe {           // one direction of a relay
  char buf[kBufSize];
  size_t len = 0;       // bytes buffered
  size_t off = 0;       // write offset into buf
  bool eof = false;     // source half-closed
  bool shut = false;    // already propagated shutdown to sink
};

struct Relay {
  int client = -1;
  int upstream = -1;
  bool connecting = true;   // upstream connect() in flight
  bool doomed = false;      // close deferred to end of event batch
  bool authed = true;       // false until the auth gate passes (token mode)
  bool grace = false;       // source unlocked: credentials optional
  long auth_deadline = 0;   // pre-auth wall-clock bound (CLOCK_MONOTONIC s)
  std::string grace_key;    // computed once at accept (PeerUid scans /proc)
  std::string pending;      // pre-auth client bytes (bounded by kAuthMax)
  Pipe c2u, u2c;            // client->upstream, upstream->client
};

int SetNonBlocking(int fd) {
  int flags = fcntl(fd, F_GETFL, 0);
  return flags < 0 ? -1 : fcntl(fd, F_SETFL, flags | O_NONBLOCK);
}

// Dead-peer reaper: without keepalive a peer that vanishes silently
// (laptop sleep, NAT drop) parks the relay forever; an idle timeout would
// kill live-but-quiet websockets instead.
void SetKeepalive(int fd) {
  int one = 1, idle = 60, intvl = 20, cnt = 3;
  setsockopt(fd, SOL_SOCKET, SO_KEEPALIVE, &one, sizeof(one));
  setsockopt(fd, IPPROTO_TCP, TCP_KEEPIDLE, &idle, sizeof(idle));
  setsockopt(fd, IPPROTO_TCP, TCP_KEEPINTVL, &intvl, sizeof(intvl));
  setsockopt(fd, IPPROTO_TCP, TCP_KEEPCNT, &cnt, sizeof(cnt));
}

// UID owning the loopback peer socket, from /proc/net/tcp. -1 = unknown.
// s_addr holds the network-order bytes; /proc/net/tcp prints that storage
// as a host-order %08X, so passing s_addr through unchanged matches the
// file's encoding on any endianness (127.0.0.1 -> "0100007F" on LE).
long PeerUid(uint32_t s_addr, uint16_t port_host) {
  char want[32];
  snprintf(want, sizeof(want), "%08X:%04X", s_addr, port_host);
  FILE* f = fopen("/proc/net/tcp", "r");
  if (f == nullptr) return -1;
  char line[512];
  long uid = -1;
  if (fgets(line, sizeof(line), f) != nullptr) {  // skip header
    while (fgets(line, sizeof(line), f) != nullptr) {
      char local[64];
      long u;
      // sl local rem st tx:rx tr:tm retrnsmt uid ...
      if (sscanf(line, "%*d: %63s %*s %*s %*s %*s %*d %ld",
                 local, &u) == 2 &&
          strcmp(local, want) == 0) {
        uid = u;
        break;
      }
    }
  }
  fclose(f);
  return uid;
}

bool IsLoopback(uint32_t ip_be) {
  return (ntohl(ip_be) >> 24) == 127;
}

class Proxy {
 public:
  Proxy(std::string host, int port, std::string token)
      : remote_host_(std::move(host)), remote_port_(port),
        token_(std::move(token)) {}

  int Listen(int local_port) {
    listener_ = socket(AF_INET, SOCK_STREAM, 0);
    if (listener_ < 0) return -1;
    int one = 1;
    setsockopt(listener_, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
    addr.sin_port = htons(static_cast<uint16_t>(local_port));
    if (bind(listener_, reinterpret_cast<sockaddr*>(&addr),
             sizeof(addr)) < 0 ||
        listen(listener_, 64) < 0 || SetNonBlocking(listener_) < 0) {
      return -1;
    }
    socklen_t alen = sizeof(addr);
    getsockname(listener_, reinterpret_cast<sockaddr*>(&addr), &alen);
    return ntohs(addr.sin_port);
  }

  int Run() {
    epfd_ = epoll_create1(0);
    if (epfd_ < 0) return 1;
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.fd = listener_;
    epoll_ctl(epfd_, EPOLL_CTL_ADD, listener_, &ev);

    epoll_event events[kMaxEvents];
    std::vector<Relay*> doomed;
    for (;;) {
      // 1s tick (token mode) so pre-auth deadlines fire without events
      int n = epoll_wait(epfd_, events, kMaxEvents,
                         token_.empty() ? -1 : 1000);
      if (n < 0) {
        if (errno == EINTR) continue;
        return 1;
      }

      // Closes are deferred to the end of the batch: closing mid-batch
      // frees fd numbers that a same-batch Accept() could reuse, making a
      // stale queued event hit the wrong (healthy) relay.
      doomed.clear();
      for (int i = 0; i < n; ++i) {
        int fd = events[i].data.fd;
        if (fd == listener_) {
          Accept();
          continue;
        }
        auto it = relays_.find(fd);
        if (it == relays_.end()) continue;
        Relay* r = it->second;
        if (r->doomed) continue;
        if (!Service(r, fd, events[i].events)) {
          r->doomed = true;
          doomed.push_back(r);
        }
      }
      for (Relay* r : doomed) CloseRelay(r);
      // deadline sweep runs AFTER the batch: closing mid-batch frees fd
      // numbers a same-batch Accept() could reuse, landing stale queued
      // events on the wrong relay (same invariant as deferred dooms)
      if (!token_.empty()) SweepAuthDeadlines();
    }
  }

 private:
  void Accept() {
    for (;;) {
      sockaddr_in peer{};
      socklen_t plen = sizeof(peer);
      int cfd = accept(listener_, reinterpret_cast<sockaddr*>(&peer),
                       &plen);
      if (cfd < 0) return;  // EAGAIN or error: back to the loop
      SetNonBlocking(cfd);
      int one = 1;
      setsockopt(cfd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      SetKeepalive(cfd);

      auto* r = new Relay();
      r->client = cfd;
      if (!token_.empty()) {
        // browsers open extra connections without credentials: one
        // successful auth unlocks the source (peer UID on loopback, IP
        // otherwise) for a sliding window (see tony_tpu_torch/proxy.py). Even
        // unlocked connections go through Authenticate: a preamble line,
        // if present, must be consumed/verified, never relayed upstream.
        r->grace_key = GraceKey(peer.sin_addr.s_addr,
                                ntohs(peer.sin_port));
        r->grace = SourceUnlocked(r->grace_key);
        r->authed = false;
        r->auth_deadline = Now() + kAuthTimeoutSec;
      }
      relays_[cfd] = r;
      Register(cfd);
      // the upstream is only contacted AFTER the auth gate: rejected
      // probes must not cost the in-cluster server connect churn
      if (r->authed && !AttachUpstream(r)) {
        CloseRelay(r);
        continue;
      }
      Rearm(r);
    }
  }

  // grace key: "uid:<uid>" on loopback (IP can't distinguish local
  // users), "ip:<addr>" otherwise; "" = no grace possible
  std::string GraceKey(uint32_t s_addr, uint16_t port) const {
    char buf[48];
    if (IsLoopback(s_addr)) {
      long uid = PeerUid(s_addr, port);
      if (uid < 0) return "";
      snprintf(buf, sizeof(buf), "uid:%ld", uid);
    } else {
      snprintf(buf, sizeof(buf), "ip:%08X", s_addr);
    }
    return buf;
  }

  bool AttachUpstream(Relay* r) {
    int ufd = ConnectUpstream();
    if (ufd < 0) return false;
    SetKeepalive(ufd);
    r->upstream = ufd;
    r->connecting = true;
    relays_[ufd] = r;
    Register(ufd);
    return true;
  }

  int ConnectUpstream() {
    addrinfo hints{}, *res = nullptr;
    hints.ai_family = AF_INET;
    hints.ai_socktype = SOCK_STREAM;
    std::string port_s = std::to_string(remote_port_);
    if (getaddrinfo(remote_host_.c_str(), port_s.c_str(), &hints, &res) != 0)
      return -1;
    int fd = socket(res->ai_family, res->ai_socktype, res->ai_protocol);
    if (fd >= 0) {
      SetNonBlocking(fd);
      int one = 1;
      setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      if (connect(fd, res->ai_addr, res->ai_addrlen) < 0 &&
          errno != EINPROGRESS) {
        close(fd);
        fd = -1;
      }
    }
    freeaddrinfo(res);
    return fd;
  }

  void Register(int fd) {
    epoll_event ev{};
    ev.events = 0;
    ev.data.fd = fd;
    epoll_ctl(epfd_, EPOLL_CTL_ADD, fd, &ev);
  }

  // Recompute epoll interest from buffer state (level-triggered).
  void Rearm(Relay* r) {
    epoll_event ev{};
    ev.data.fd = r->client;
    // while the upstream connect is in flight, reading the client would
    // either overflow c2u or (level-triggered) busy-spin the loop on the
    // unread data — pause client reads until the connect resolves
    bool conn_wait = r->connecting && r->upstream >= 0;
    ev.events = (r->c2u.eof || r->c2u.len || conn_wait
                     ? 0u : unsigned(EPOLLIN)) |
                (r->u2c.len ? unsigned(EPOLLOUT) : 0u);
    epoll_ctl(epfd_, EPOLL_CTL_MOD, r->client, &ev);
    if (r->upstream < 0) return;   // pre-auth: no upstream exists yet
    ev.data.fd = r->upstream;
    ev.events = (r->u2c.eof || r->u2c.len ? 0u : unsigned(EPOLLIN)) |
                (r->c2u.len || r->connecting ? unsigned(EPOLLOUT) : 0u);
    epoll_ctl(epfd_, EPOLL_CTL_MOD, r->upstream, &ev);
  }

  long Now() const {
    timespec ts{};
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return ts.tv_sec;
  }

  bool SourceUnlocked(const std::string& key) {
    if (key.empty()) return false;
    auto it = unlocked_.find(key);
    // no slide here: only AUTHENTICATED connections extend the window
    // (Authenticate sets it) — otherwise an unauthenticated poller
    // could hold the unlock open forever
    return it != unlocked_.end() && it->second >= Now();
  }

  // Complete the auth gate: mark authed, slide the window if credentials
  // were verified, connect the upstream, queue `forward` to it.
  // `forward` BY VALUE: callers pass r->pending itself, and the clear()
  // below would otherwise wipe the bytes before they are queued.
  bool FinishAuth(Relay* r, std::string forward, bool verified) {
    r->pending.clear();
    r->authed = true;
    if (verified && !r->grace_key.empty())
      unlocked_[r->grace_key] = Now() + kGraceSec;
    if (!AttachUpstream(r)) return false;   // upstream only after auth
    if (forward.size() > kBufSize) return false;  // cannot happen (<=16K)
    memcpy(r->c2u.buf, forward.data(), forward.size());
    r->c2u.len = forward.size();
    r->c2u.off = 0;
    Rearm(r);  // c2u.len>0 arms upstream EPOLLOUT; upstream reads resume
    return true;
  }

  // Pre-relay auth gate: buffer client bytes until a decision.
  // false = reject (doom the relay); true = authed or still waiting.
  // Grace connections (source unlocked) may relay WITHOUT credentials,
  // but a preamble line, if present, is still consumed and verified —
  // it carries the token and must never reach the upstream as payload.
  bool Authenticate(Relay* r, uint32_t evmask) {
    if (!(evmask & EPOLLIN)) return true;
    // chunk cap kAuthMax keeps pending <= 2*kAuthMax so a stripped-
    // preamble remainder always fits the 64K relay buffer below
    char tmp[kAuthMax];
    ssize_t got = read(r->client, tmp, kAuthMax);
    if (got == 0) return false;  // EOF before auth (nothing to relay)
    if (got < 0) {
      return errno == EAGAIN || errno == EWOULDBLOCK || errno == EINTR;
    }
    r->pending.append(tmp, static_cast<size_t>(got));
    const size_t pre_len = sizeof(kAuthPreamble) - 1;
    if (r->pending.size() < pre_len &&
        memcmp(kAuthPreamble, r->pending.data(), r->pending.size()) == 0) {
      return true;   // could still become a preamble — keep reading
    }
    if (r->pending.rfind(kAuthPreamble, 0) == 0) {
      size_t nl = r->pending.find('\n');
      if (nl == std::string::npos)
        return r->pending.size() <= kAuthMax;   // wait for the line
      std::string line = r->pending.substr(0, nl);
      if (!line.empty() && line.back() == '\r') line.pop_back();
      if (!ConstTimeEq(line.substr(pre_len), token_)) return false;
      return FinishAuth(r, r->pending.substr(nl + 1), true);
    }
    if (r->grace) {
      // unlocked source, not a preamble: bare relay
      return FinishAuth(r, r->pending, false);
    }
    // HTTP mode: need the full header block for Authorization
    if (r->pending.find("\r\n\r\n") == std::string::npos) {
      return r->pending.size() <= kAuthMax;   // keep reading, bounded
    }
    if (!CheckHttpAuth(r->pending, token_)) return false;
    return FinishAuth(r, r->pending, true);   // forwarded unmodified
  }

  // Pre-auth connections must not pin fds forever: a silent-but-alive
  // peer passes TCP keepalive, so sweep on a wall-clock deadline. Grace
  // connections stalled mid-prefix complete as bare relays instead.
  void SweepAuthDeadlines() {
    std::vector<Relay*> expired;
    long now = Now();
    for (auto& kv : relays_) {
      Relay* r = kv.second;
      if (!r->authed && !r->doomed && r->auth_deadline < now)
        expired.push_back(r);
    }
    for (Relay* r : expired) {
      // pending bytes still unauthed can only be a (partial) preamble —
      // token bytes that must never reach the upstream as payload
      if (r->grace && r->pending.empty()) {
        if (FinishAuth(r, "", false)) continue;
      }
      CloseRelay(r);
    }
  }

  // Move bytes for one pipe; false = fatal error on this relay.
  static bool Pump(Pipe* p, int src, int dst, bool readable, bool writable) {
    if (readable && !p->eof && p->len == 0) {
      ssize_t got = read(src, p->buf, kBufSize);
      if (got == 0) {
        p->eof = true;
      } else if (got < 0) {
        if (errno != EAGAIN && errno != EWOULDBLOCK && errno != EINTR)
          return false;
      } else {
        p->len = static_cast<size_t>(got);
        p->off = 0;
      }
    }
    while (p->len > 0) {
      ssize_t put = write(dst, p->buf + p->off, p->len);
      if (put < 0) {
        if (errno == EAGAIN || errno == EWOULDBLOCK || errno == EINTR) break;
        return false;
      }
      p->off += static_cast<size_t>(put);
      p->len -= static_cast<size_t>(put);
    }
    if (p->eof && p->len == 0 && !p->shut) {
      shutdown(dst, SHUT_WR);
      p->shut = true;
    }
    return true;
  }

  bool Service(Relay* r, int fd, uint32_t evmask) {
    if (evmask & (EPOLLERR | EPOLLHUP)) {
      // HUP with pending readable data still needs draining; only bail on
      // hard errors or HUP with nothing left to move.
      if ((evmask & EPOLLERR) || !(evmask & EPOLLIN)) return false;
    }
    if (r->connecting && fd == r->upstream && (evmask & EPOLLOUT)) {
      int err = 0;
      socklen_t len = sizeof(err);
      getsockopt(fd, SOL_SOCKET, SO_ERROR, &err, &len);
      if (err != 0) return false;
      r->connecting = false;
    }
    bool on_client = fd == r->client;
    if (!r->authed && on_client) return Authenticate(r, evmask);
    if (r->connecting) {
      // upstream connect still in flight (auth completes before the
      // connect with the deferred-attach design): pumping now would
      // write() into an unconnected socket (ENOTCONN) and doom the
      // relay. Level-triggered epoll re-delivers once it's up.
      Rearm(r);
      return true;
    }
    Pipe* read_pipe = on_client ? &r->c2u : &r->u2c;   // fd is source
    Pipe* write_pipe = on_client ? &r->u2c : &r->c2u;  // fd is sink
    int peer = on_client ? r->upstream : r->client;
    if (!Pump(read_pipe, fd, peer, evmask & EPOLLIN, true)) return false;
    if (!Pump(write_pipe, peer, fd, false, evmask & EPOLLOUT)) return false;
    if (read_pipe->shut && write_pipe->shut) return false;  // both done
    Rearm(r);
    return true;
  }

  void CloseRelay(Relay* r) {
    epoll_ctl(epfd_, EPOLL_CTL_DEL, r->client, nullptr);
    relays_.erase(r->client);
    close(r->client);
    if (r->upstream >= 0) {
      epoll_ctl(epfd_, EPOLL_CTL_DEL, r->upstream, nullptr);
      relays_.erase(r->upstream);
      close(r->upstream);
    }
    delete r;
  }

  std::string remote_host_;
  int remote_port_;
  std::string token_;  // empty = open relay
  std::unordered_map<std::string, long> unlocked_;  // grace key -> expiry
  int listener_ = -1;
  int epfd_ = -1;
  std::unordered_map<int, Relay*> relays_;  // both fds -> relay
};

}  // namespace

int main(int argc, char** argv) {
  if (argc != 3 && argc != 4) {
    fprintf(stderr, "usage: %s <remote_host> <remote_port> [local_port]\n",
            argv[0]);
    return 2;
  }
  signal(SIGPIPE, SIG_IGN);
  const char* token_env = getenv("TONY_PROXY_TOKEN");
  Proxy proxy(argv[1], atoi(argv[2]), token_env ? token_env : "");
  int port = proxy.Listen(argc == 4 ? atoi(argv[3]) : 0);
  if (port < 0) {
    perror("listen");
    return 1;
  }
  printf("proxying 127.0.0.1:%d -> %s:%s\n", port, argv[1], argv[2]);
  fflush(stdout);
  return proxy.Run();
}
