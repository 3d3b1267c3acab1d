// The transport half of the native runtime library, the port's own copy.
//
// Copied from native/rebvo_native.cpp, which also holds a PNG/PGM frame
// loader and so needs libpng to build; this file has only what the
// telemetry channel uses and builds with g++ alone:
//
//   * CRC16 (Modbus polynomial) packet integrity (reference
//     src/UtilLib/libcrc.cpp semantics)
//   * fragmented-UDP telemetry transport: fire-and-forget fragments with
//     tag-based reassembly and timeout, lossy realtime semantics
//     (reference src/CommLib/udp_port.cpp semantics)
//   * keyline edge-map quantization to a fixed-point wire format
//     operating directly on the SoA float arrays (reference
//     src/CommLib/net_keypoint.cpp semantics)
//   * an N-player slot-ownership pipeline ring buffer (reference
//     include/UtilLib/pipeline.h semantics)
//
// The function names, record layout and behaviour are those of
// native/rebvo_native.cpp, plus rn_udp_set_rcvbuf (tests/test_torch_telemetry.py holds the two
// builds byte for byte against each other). Exported as a plain C API
// for ctypes (rebvo_tpu_torch/io/native.py builds and loads it).

#include <arpa/inet.h>
#include <netinet/in.h>
#include <sys/select.h>
#include <sys/socket.h>
#include <sys/time.h>
#include <unistd.h>

#include <algorithm>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// CRC16 (Modbus): polynomial 0xA001 reflected, init 0xFFFF.
// ---------------------------------------------------------------------------

uint16_t rn_crc16(const uint8_t* data, int len) {
  uint16_t crc = 0xFFFF;
  for (int i = 0; i < len; ++i) {
    crc ^= data[i];
    for (int b = 0; b < 8; ++b) {
      if (crc & 1)
        crc = (crc >> 1) ^ 0xA001;
      else
        crc >>= 1;
    }
  }
  return crc;
}

// ---------------------------------------------------------------------------
// Pipeline ring buffer: N slots, P players; slot s is available to
// player p once player (p-1) mod P has released it. Player 0 produces
// into free slots.
// ---------------------------------------------------------------------------

struct RnPipeline {
  int nbuf;
  int nplayers;
  std::vector<int> owner;   // which player may claim each slot next
  std::vector<int> cursor;  // per-player ring cursor
  std::mutex mu;
  std::condition_variable cv;
};

void* rn_pipeline_create(int nbuf, int nplayers) {
  auto* p = new RnPipeline();
  p->nbuf = nbuf;
  p->nplayers = nplayers;
  p->owner.assign(nbuf, 0);
  p->cursor.assign(nplayers, 0);
  return p;
}

void rn_pipeline_destroy(void* h) { delete static_cast<RnPipeline*>(h); }

// Returns the slot index, or -1 on timeout (timeout_ms < 0: block).
int rn_pipeline_request(void* h, int player, int timeout_ms) {
  auto* p = static_cast<RnPipeline*>(h);
  std::unique_lock<std::mutex> lk(p->mu);
  int slot = p->cursor[player];
  auto ready = [&] { return p->owner[slot] == player; };
  if (timeout_ms < 0) {
    p->cv.wait(lk, ready);
  } else {
    if (!p->cv.wait_for(lk, std::chrono::milliseconds(timeout_ms), ready))
      return -1;
  }
  return slot;
}

void rn_pipeline_release(void* h, int player) {
  auto* p = static_cast<RnPipeline*>(h);
  std::lock_guard<std::mutex> lk(p->mu);
  int slot = p->cursor[player];
  p->owner[slot] = (player + 1) % p->nplayers;
  p->cursor[player] = (slot + 1) % p->nbuf;
  p->cv.notify_all();
}

// ---------------------------------------------------------------------------
// Fragmented UDP transport.
// ---------------------------------------------------------------------------

static const int RN_MAX_FRAG = 32000;

#pragma pack(push, 1)
struct RnFragHeader {
  uint32_t tag;
  uint16_t frag_pos;
  uint16_t frag_num;
  uint32_t frag_size;
  uint32_t pack_size;
};
#pragma pack(pop)

struct RnUdp {
  int fd = -1;
  sockaddr_in peer{};
  uint32_t send_tag = 1;
  // reassembly state per tag
  struct Partial {
    std::vector<uint8_t> data;
    std::vector<bool> have;
    uint32_t got = 0;
    double t0 = 0;
  };
  std::map<uint32_t, Partial> partials;
};

static double rn_now() {
  timeval tv;
  gettimeofday(&tv, nullptr);
  return tv.tv_sec + 1e-6 * tv.tv_usec;
}

void* rn_udp_create(const char* host, int port, int bind_local) {
  auto* u = new RnUdp();
  u->fd = socket(AF_INET, SOCK_DGRAM, 0);
  if (u->fd < 0) {
    delete u;
    return nullptr;
  }
  u->peer.sin_family = AF_INET;
  u->peer.sin_port = htons(port);
  inet_aton(host, &u->peer.sin_addr);
  if (bind_local) {
    sockaddr_in local{};
    local.sin_family = AF_INET;
    local.sin_port = htons(port);
    local.sin_addr.s_addr = INADDR_ANY;
    int one = 1;
    setsockopt(u->fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    if (bind(u->fd, reinterpret_cast<sockaddr*>(&local), sizeof(local)) < 0) {
      close(u->fd);
      delete u;
      return nullptr;
    }
  }
  return u;
}

void rn_udp_destroy(void* h) {
  auto* u = static_cast<RnUdp*>(h);
  if (u->fd >= 0) close(u->fd);
  delete u;
}

// Not in native/rebvo_native.cpp: asks for a receive buffer of `bytes`
// on the port's socket and returns what the kernel granted (Linux reports
// twice the bookkeeping size). A packet's fragments arrive as one burst,
// faster than a receiving thread wakes to drain them, so a buffer smaller
// than the packet drops fragments, and with them the whole packet.
// SO_RCVBUFFORCE (CAP_NET_ADMIN) passes net.core.rmem_max; without it
// SO_RCVBUF is capped there.
int rn_udp_set_rcvbuf(void* h, int bytes) {
  auto* u = static_cast<RnUdp*>(h);
  if (setsockopt(u->fd, SOL_SOCKET, SO_RCVBUFFORCE, &bytes, sizeof(bytes)))
    setsockopt(u->fd, SOL_SOCKET, SO_RCVBUF, &bytes, sizeof(bytes));
  int got = 0;
  socklen_t len = sizeof(got);
  getsockopt(u->fd, SOL_SOCKET, SO_RCVBUF, &got, &len);
  return got;
}

// Splits `len` bytes into <=RN_MAX_FRAG fragments; fire-and-forget.
int rn_udp_send_fragmented(void* h, const uint8_t* data, int len) {
  auto* u = static_cast<RnUdp*>(h);
  uint32_t tag = u->send_tag++;
  int nfrag = (len + RN_MAX_FRAG - 1) / RN_MAX_FRAG;
  std::vector<uint8_t> buf(sizeof(RnFragHeader) + RN_MAX_FRAG);
  for (int i = 0; i < nfrag; ++i) {
    int off = i * RN_MAX_FRAG;
    int fsz = std::min(RN_MAX_FRAG, len - off);
    RnFragHeader hd{tag, static_cast<uint16_t>(i),
                    static_cast<uint16_t>(nfrag), static_cast<uint32_t>(fsz),
                    static_cast<uint32_t>(len)};
    memcpy(buf.data(), &hd, sizeof(hd));
    memcpy(buf.data() + sizeof(hd), data + off, fsz);
    ssize_t n = sendto(u->fd, buf.data(), sizeof(hd) + fsz, 0,
                       reinterpret_cast<sockaddr*>(&u->peer),
                       sizeof(u->peer));
    if (n < 0) return -1;
  }
  return nfrag;
}

// Receives until a full packet is reassembled or the timeout expires.
// Returns the packet length (copied into out, up to out_cap), 0 on
// timeout, -1 on error. Stale partial packets are discarded after 2 s
// (loss tolerance — no acks, no retransmit).
int rn_udp_recv_fragmented(void* h, uint8_t* out, int out_cap,
                           int timeout_ms) {
  auto* u = static_cast<RnUdp*>(h);
  double deadline = rn_now() + timeout_ms * 1e-3;
  std::vector<uint8_t> buf(sizeof(RnFragHeader) + RN_MAX_FRAG);
  for (;;) {
    double remain = deadline - rn_now();
    if (remain <= 0) return 0;
    timeval tv;
    tv.tv_sec = static_cast<int>(remain);
    tv.tv_usec = static_cast<int>((remain - tv.tv_sec) * 1e6);
    fd_set fds;
    FD_ZERO(&fds);
    FD_SET(u->fd, &fds);
    int r = select(u->fd + 1, &fds, nullptr, nullptr, &tv);
    if (r < 0) return -1;
    if (r == 0) return 0;
    ssize_t n = recv(u->fd, buf.data(), buf.size(), 0);
    if (n < static_cast<ssize_t>(sizeof(RnFragHeader))) continue;
    RnFragHeader hd;
    memcpy(&hd, buf.data(), sizeof(hd));
    if (hd.frag_num == 0 || hd.frag_pos >= hd.frag_num) continue;
    if (hd.frag_size + sizeof(hd) != static_cast<uint32_t>(n)) continue;
    auto& part = u->partials[hd.tag];
    if (part.data.empty()) {
      part.data.resize(hd.pack_size);
      part.have.assign(hd.frag_num, false);
      part.t0 = rn_now();
    }
    uint32_t off = static_cast<uint32_t>(hd.frag_pos) * RN_MAX_FRAG;
    if (off + hd.frag_size > part.data.size()) continue;
    if (!part.have[hd.frag_pos]) {
      memcpy(part.data.data() + off, buf.data() + sizeof(hd), hd.frag_size);
      part.have[hd.frag_pos] = true;
      part.got++;
    }
    if (part.got == hd.frag_num) {
      int len = std::min<int>(part.data.size(), out_cap);
      memcpy(out, part.data.data(), len);
      u->partials.erase(hd.tag);
      return len;
    }
    // garbage-collect stale partials
    for (auto it = u->partials.begin(); it != u->partials.end();) {
      if (rn_now() - it->second.t0 > 2.0)
        it = u->partials.erase(it);
      else
        ++it;
    }
  }
}

// ---------------------------------------------------------------------------
// Keyline edge-map wire format: fixed-point quantization of the SoA
// arrays. Record layout (little endian, 16 bytes):
//   u16 qx, qy        image position * 8 (1/8 px)
//   u16 rho, s_rho    inverse depth * (10000 / k_scale)
//   i32 n_id          chain link (network id)
//   u8  m_num         consecutive-match count (saturated)
//   i8  gx, gy        gradient direction * 127 / |g|
//   u8  pad
// ---------------------------------------------------------------------------

#pragma pack(push, 1)
struct RnNetKeyline {
  uint16_t qx, qy;
  uint16_t rho, s_rho;
  int32_t n_id;
  uint8_t m_num;
  int8_t gx, gy;
  uint8_t pad;
};
#pragma pack(pop)

static uint16_t rn_sat_u16(float v) {
  if (v < 0) return 0;
  if (v > 65535.0f) return 65535;
  return static_cast<uint16_t>(v + 0.5f);
}

// Quantize n keylines (those with valid[i] != 0). id_map must hold K
// int32s; it receives the slot->net-id mapping (-1 for invalid) so
// chain links can be rewired. Returns the number of emitted records.
int rn_quantize_keylines(const float* x, const float* y, const float* gx,
                         const float* gy, const float* n_m, const float* rho,
                         const float* s_rho, const int32_t* n_id,
                         const int32_t* m_num, const uint8_t* valid, int K,
                         float k_scale, RnNetKeyline* out, int32_t* id_map) {
  float rs = 10000.0f / (k_scale > 1e-9f ? k_scale : 1.0f);
  int n = 0;
  for (int i = 0; i < K; ++i)
    id_map[i] = valid[i] ? n++ : -1;
  n = 0;
  for (int i = 0; i < K; ++i) {
    if (!valid[i]) continue;
    RnNetKeyline& r = out[n];
    r.qx = rn_sat_u16(x[i] * 8.0f);
    r.qy = rn_sat_u16(y[i] * 8.0f);
    r.rho = rn_sat_u16(rho[i] * rs);
    r.s_rho = rn_sat_u16(s_rho[i] * rs);
    int32_t link = n_id[i];
    r.n_id = (link >= 0 && link < K) ? id_map[link] : -1;
    int mn = m_num[i];
    r.m_num = mn < 0 ? 0 : (mn > 255 ? 255 : mn);
    float nm = n_m[i] > 1e-9f ? n_m[i] : 1.0f;
    r.gx = static_cast<int8_t>(127.0f * gx[i] / nm);
    r.gy = static_cast<int8_t>(127.0f * gy[i] / nm);
    r.pad = 0;
    ++n;
  }
  return n;
}

// Inverse transform (for receivers / tests).
void rn_dequantize_keylines(const RnNetKeyline* in, int n, float k_scale,
                            float* x, float* y, float* rho, float* s_rho,
                            int32_t* n_id, int32_t* m_num, float* gx,
                            float* gy) {
  float rs = (k_scale > 1e-9f ? k_scale : 1.0f) / 10000.0f;
  for (int i = 0; i < n; ++i) {
    x[i] = in[i].qx / 8.0f;
    y[i] = in[i].qy / 8.0f;
    rho[i] = in[i].rho * rs;
    s_rho[i] = in[i].s_rho * rs;
    n_id[i] = in[i].n_id;
    m_num[i] = in[i].m_num;
    gx[i] = in[i].gx / 127.0f;
    gy[i] = in[i].gy / 127.0f;
  }
}

int rn_net_keyline_size() { return sizeof(RnNetKeyline); }

}  // extern "C"
