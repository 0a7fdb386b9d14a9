// Native transport: length-prefixed TCP message transport with a key-based
// rendezvous handshake.
//
// The port's own copy of dynamo_tpu/runtime/csrc/dynamo_transport.cpp, byte
// for byte on the wire. It carries the disaggregated KV handoff's TCP leg
// (the `dcn` plane, which bounces through host memory) and the KVBM's
// cross-worker host-tier pull: the decode worker dials the prefill worker's
// bootstrap port, presents the request key, and streams the KV pages. The
// reference's NIXL backend takes this place there
// (examples/deploy/sglang/disagg.yaml:47-52, a bootstrap port).
//
// Exposed as a C ABI for ctypes (no pybind11). Every blocking call runs with
// the GIL released, as every ctypes foreign call does.

#include <arpa/inet.h>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <sys/types.h>
#include <unistd.h>

namespace {

constexpr uint32_t kMagic = 0x44594E4Du;  // "DYNM"
constexpr int kKeyLen = 64;               // fixed-size key field

// Send exactly len bytes; returns 0 on success, -1 on error.
int send_all(int fd, const void* buf, size_t len) {
  const char* p = static_cast<const char*>(buf);
  while (len > 0) {
    ssize_t n = ::send(fd, p, len, MSG_NOSIGNAL);
    if (n < 0) {
      if (errno == EINTR) continue;
      return -1;
    }
    p += n;
    len -= static_cast<size_t>(n);
  }
  return 0;
}

int recv_all(int fd, void* buf, size_t len) {
  char* p = static_cast<char*>(buf);
  while (len > 0) {
    ssize_t n = ::recv(fd, p, len, 0);
    if (n <= 0) {
      if (n < 0 && errno == EINTR) continue;
      return -1;
    }
    p += n;
    len -= static_cast<size_t>(n);
  }
  return 0;
}

void set_common_opts(int fd) {
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
}

}  // namespace

extern "C" {

// Listen on port (0 = ephemeral). Returns listen fd or -1. If port_out is
// non-null, the bound port is written there.
int dt_listen(uint16_t port, uint16_t* port_out) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  int one = 1;
  ::setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(port);
  if (::bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0 ||
      ::listen(fd, 64) < 0) {
    ::close(fd);
    return -1;
  }
  if (port_out != nullptr) {
    socklen_t alen = sizeof(addr);
    if (::getsockname(fd, reinterpret_cast<sockaddr*>(&addr), &alen) == 0) {
      *port_out = ntohs(addr.sin_port);
    }
  }
  return fd;
}

// Accept one connection and read its rendezvous handshake (magic + key).
// key_out must hold kKeyLen+1 bytes. timeout_ms < 0 blocks forever.
// Returns connection fd, -1 on error, -2 on timeout.
int dt_accept(int listen_fd, char* key_out, int timeout_ms) {
  if (timeout_ms >= 0) {
    timeval tv{timeout_ms / 1000, (timeout_ms % 1000) * 1000};
    fd_set rfds;
    FD_ZERO(&rfds);
    FD_SET(listen_fd, &rfds);
    int r = ::select(listen_fd + 1, &rfds, nullptr, nullptr, &tv);
    if (r == 0) return -2;
    if (r < 0) return -1;
  }
  int fd = ::accept(listen_fd, nullptr, nullptr);
  if (fd < 0) return -1;
  set_common_opts(fd);
  // Bound the handshake: a dialer that connects and sends nothing must not
  // wedge the accept loop. Cleared after the peer identifies itself.
  timeval hs_to{10, 0};
  ::setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &hs_to, sizeof(hs_to));
  uint32_t magic = 0;
  char key[kKeyLen];
  if (recv_all(fd, &magic, sizeof(magic)) != 0 || ntohl(magic) != kMagic ||
      recv_all(fd, key, kKeyLen) != 0) {
    ::close(fd);
    return -1;
  }
  timeval no_to{0, 0};
  ::setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &no_to, sizeof(no_to));
  std::memcpy(key_out, key, kKeyLen);
  key_out[kKeyLen] = '\0';
  return fd;
}

// Connect to host:port and present the rendezvous key. Returns fd or -1.
int dt_connect(const char* host, uint16_t port, const char* key) {
  addrinfo hints{};
  hints.ai_family = AF_INET;
  hints.ai_socktype = SOCK_STREAM;
  char portstr[16];
  std::snprintf(portstr, sizeof(portstr), "%u", port);
  addrinfo* res = nullptr;
  if (::getaddrinfo(host, portstr, &hints, &res) != 0 || res == nullptr) {
    return -1;
  }
  int fd = ::socket(res->ai_family, res->ai_socktype, res->ai_protocol);
  if (fd < 0) {
    ::freeaddrinfo(res);
    return -1;
  }
  if (::connect(fd, res->ai_addr, res->ai_addrlen) < 0) {
    ::freeaddrinfo(res);
    ::close(fd);
    return -1;
  }
  ::freeaddrinfo(res);
  set_common_opts(fd);
  uint32_t magic = htonl(kMagic);
  char keybuf[kKeyLen];
  std::memset(keybuf, 0, sizeof(keybuf));
  std::strncpy(keybuf, key, kKeyLen - 1);
  if (send_all(fd, &magic, sizeof(magic)) != 0 ||
      send_all(fd, keybuf, kKeyLen) != 0) {
    ::close(fd);
    return -1;
  }
  return fd;
}

// Send one length-prefixed message. Returns 0 / -1.
int dt_send_msg(int fd, const void* buf, int64_t len) {
  uint64_t be = htobe64(static_cast<uint64_t>(len));
  if (send_all(fd, &be, sizeof(be)) != 0) return -1;
  return send_all(fd, buf, static_cast<size_t>(len));
}

// Two-phase receive: first the length...
int64_t dt_recv_len(int fd) {
  uint64_t be = 0;
  if (recv_all(fd, &be, sizeof(be)) != 0) return -1;
  return static_cast<int64_t>(be64toh(be));
}

// ...then the payload into a caller-allocated buffer.
int dt_recv_into(int fd, void* buf, int64_t len) {
  return recv_all(fd, buf, static_cast<size_t>(len));
}

void dt_close(int fd) {
  if (fd >= 0) ::close(fd);
}

int dt_key_len() { return kKeyLen; }

}  // extern "C"
