// tony_portres: hold TCP ports with SO_REUSEPORT from a helper process.
//
// Native equivalent of the reference's reserve_reusable_port.py helper
// (spawned by ReusablePort.java:149-235): bind the requested number of
// ports with SO_REUSEPORT, print them one per line, touch the sentinel file
// to signal readiness, then hold the sockets until SIGTERM/SIGINT. A user
// process that also sets SO_REUSEPORT (TF gRPC with TF_GRPC_REUSE_PORT, a
// JAX coordinator) can bind the same port while this helper still holds it,
// closing the register-then-rebind race without ever freeing the port.
//
// usage: tony_portres <sentinel_file> [n_ports=1] [port...]
//   with explicit ports, re-reserves those exact ports instead of ephemeral.

#include <arpa/inet.h>
#include <errno.h>
#include <netinet/in.h>
#include <signal.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/socket.h>
#include <unistd.h>

#include <vector>

namespace {

volatile sig_atomic_t g_stop = 0;

void HandleStop(int) { g_stop = 1; }

int ReservePort(int want_port) {
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
#ifdef SO_REUSEPORT
  setsockopt(fd, SOL_SOCKET, SO_REUSEPORT, &one, sizeof(one));
#endif
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(static_cast<uint16_t>(want_port));
  if (bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0 ||
      listen(fd, 1) < 0) {
    close(fd);
    return -1;
  }
  return fd;
}

int BoundPort(int fd) {
  sockaddr_in addr{};
  socklen_t len = sizeof(addr);
  if (getsockname(fd, reinterpret_cast<sockaddr*>(&addr), &len) < 0)
    return -1;
  return ntohs(addr.sin_port);
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 2) {
    fprintf(stderr,
            "usage: %s <sentinel_file> [n_ports=1] [port...]\n", argv[0]);
    return 2;
  }
  const char* sentinel = argv[1];
  std::vector<int> fds;
  if (argc > 3) {  // explicit port list
    for (int i = 3; i < argc; ++i) {
      int fd = ReservePort(atoi(argv[i]));
      if (fd < 0) {
        fprintf(stderr, "cannot reserve port %s: %s\n", argv[i],
                strerror(errno));
        return 1;
      }
      fds.push_back(fd);
    }
  } else {
    int n = argc == 3 ? atoi(argv[2]) : 1;
    for (int i = 0; i < n; ++i) {
      int fd = ReservePort(0);
      if (fd < 0) {
        fprintf(stderr, "cannot reserve ephemeral port: %s\n",
                strerror(errno));
        return 1;
      }
      fds.push_back(fd);
    }
  }
  // Install handlers and BLOCK the stop signals BEFORE the readiness
  // sentinel is visible: a supervisor that reacts to the sentinel with an
  // immediate terminate() must find the handler already in place (else the
  // default SIGTERM action kills the helper with rc -15). Blocking
  // also closes the lost-wakeup race of `while (!g_stop) pause()` — the
  // signal can only be delivered inside sigsuspend below.
  struct sigaction sa{};
  sa.sa_handler = HandleStop;
  sigemptyset(&sa.sa_mask);
  sigaction(SIGTERM, &sa, nullptr);
  sigaction(SIGINT, &sa, nullptr);
  sigset_t block, old;
  sigemptyset(&block);
  sigaddset(&block, SIGTERM);
  sigaddset(&block, SIGINT);
  sigprocmask(SIG_BLOCK, &block, &old);

  for (int fd : fds) printf("%d\n", BoundPort(fd));
  fflush(stdout);

  // readiness sentinel (reference: helper touches the file once bound)
  FILE* f = fopen(sentinel, "w");
  if (f == nullptr) {
    fprintf(stderr, "cannot touch sentinel %s: %s\n", sentinel,
            strerror(errno));
    return 1;
  }
  fclose(f);

  // Atomically unblock + wait: a SIGTERM delivered at any point since the
  // sigprocmask above is seen either before the loop (g_stop already 1) or
  // by sigsuspend itself — never lost.
  sigset_t wait_mask = old;
  sigdelset(&wait_mask, SIGTERM);
  sigdelset(&wait_mask, SIGINT);
  while (!g_stop) sigsuspend(&wait_mask);
  for (int fd : fds) close(fd);
  return 0;
}
