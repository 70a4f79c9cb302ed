// Native volume-server data plane: HTTP needle reads/writes in C++.
// Counterpart of seaweedfs_tpu/native/dataplane.cpp.
//
// The reference's data plane is Go's net/http + a compiled storage engine
// (SeaweedFS weed/server/volume_server_handlers_read.go:31,
// volume_server_handlers_write.go:18, weed/storage/needle/needle_write.go:20).
// A Python per-request handler costs ~1-3ms of interpreter time; this plane
// serves the hot paths — GET/PUT/DELETE of /vid,fid — from a C++ thread pool
// with keepalive, and 307-redirects everything else (status pages, EC
// volumes, range/conditional/image requests, multipart) to the Python
// listener, which keeps full behavioral coverage.
//
// On-disk formats are bit-identical to the Python engine (and the
// reference): needle v1/v2/v3 records (needle.py, needle_write.go:20-113),
// append-only .idx entries id8+offset4+size4 big-endian in units of 8
// bytes, CRC32-Castagnoli data checksums. Python-side mutations funnel
// through swdp_append_record/swdp_delete so there is exactly one writer
// authority per volume (see native/dataplane.py).
//
// Exported C ABI (ctypes):
//   swdp_start / swdp_stop
//   swdp_add_volume / swdp_remove_volume / swdp_reload_volume
//   swdp_set_writable
//   swdp_append_record / swdp_delete / swdp_read  (+ swdp_free)
//   swdp_volume_stats
//   swdp_request_count

#include <arpa/inet.h>
#include <netdb.h>
#include <cerrno>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/sendfile.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <deque>
#include <memory>
#include <mutex>
#include <shared_mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

// ---------------------------------------------------------------- crc32c --

uint32_t crc_table[8][256];

void crc_init() {
  const uint32_t poly = 0x82F63B78u;  // reversed Castagnoli
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++) c = (c & 1) ? (c >> 1) ^ poly : c >> 1;
    crc_table[0][i] = c;
  }
  for (uint32_t i = 0; i < 256; i++)
    for (int t = 1; t < 8; t++)
      crc_table[t][i] =
          (crc_table[t - 1][i] >> 8) ^ crc_table[0][crc_table[t - 1][i] & 0xFF];
}

uint32_t crc32c(const uint8_t* p, size_t n, uint32_t crc = 0) {
  crc = ~crc;
  while (n >= 8) {
    crc ^= (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
           ((uint32_t)p[3] << 24);
    uint32_t hi = (uint32_t)p[4] | ((uint32_t)p[5] << 8) |
                  ((uint32_t)p[6] << 16) | ((uint32_t)p[7] << 24);
    crc = crc_table[7][crc & 0xFF] ^ crc_table[6][(crc >> 8) & 0xFF] ^
          crc_table[5][(crc >> 16) & 0xFF] ^ crc_table[4][crc >> 24] ^
          crc_table[3][hi & 0xFF] ^ crc_table[2][(hi >> 8) & 0xFF] ^
          crc_table[1][(hi >> 16) & 0xFF] ^ crc_table[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n--) crc = crc_table[0][(crc ^ *p++) & 0xFF] ^ (crc >> 8);
  return ~crc;
}

// legacy CRC.Value() transform accepted on reads (crc.py crc_value_legacy,
// reference crc.go:25-27): rotate + magic add, kept for old volumes
uint32_t crc_legacy(uint32_t v) {
  return (((v >> 15) | (v << 17)) + 0xA282EAD8u) & 0xFFFFFFFFu;
}

// ------------------------------------------------------------- constants --

constexpr int kHeaderSize = 16;    // cookie4 + id8 + size4
constexpr int kChecksumSize = 4;
constexpr int kTimestampSize = 8;  // v3 appendAtNs
constexpr int kPad = 8;
constexpr int32_t kTombstone = -1;
constexpr int64_t kMaxVolumeSize = 32LL * 1024 * 1024 * 1024;

constexpr uint8_t kFlagCompressed = 0x01;
constexpr uint8_t kFlagHasName = 0x02;
constexpr uint8_t kFlagHasMime = 0x04;
constexpr uint8_t kFlagHasLastModified = 0x08;
constexpr uint8_t kFlagHasTtl = 0x10;
constexpr uint8_t kFlagHasPairs = 0x20;

int pad_len(int32_t size, int version) {
  int64_t body = kHeaderSize + (int64_t)size + kChecksumSize;
  if (version == 3) body += kTimestampSize;
  return kPad - (int)(body % kPad);  // always 1..8 (types.py padding_length)
}

int64_t actual_size(int32_t size, int version) {
  int64_t body = kHeaderSize + (int64_t)size + kChecksumSize;
  if (version == 3) body += kTimestampSize;
  return body + pad_len(size, version);
}

void put_u32(uint8_t* p, uint32_t v) {
  p[0] = v >> 24; p[1] = v >> 16; p[2] = v >> 8; p[3] = v;
}
void put_u64(uint8_t* p, uint64_t v) {
  for (int i = 0; i < 8; i++) p[i] = (uint8_t)(v >> (56 - 8 * i));
}
uint32_t get_u32(const uint8_t* p) {
  return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
         ((uint32_t)p[2] << 8) | p[3];
}
uint64_t get_u64(const uint8_t* p) {
  uint64_t v = 0;
  for (int i = 0; i < 8; i++) v = (v << 8) | p[i];
  return v;
}

// --------------------------------------------------------------- volumes --

struct NeedleValue {
  uint32_t stored_offset;  // units of 8 bytes
  int32_t size;            // body size field; <=0 invalid
};

// Shared descriptor ownership: readers copy the shared_ptr under the
// volume mutex (no syscall) and pread after unlocking; a reload
// (vacuum commit) swaps in a new owner while in-flight readers keep the
// pre-reload inode alive. This replaces the old dup()+close() pair that
// cost two syscalls on EVERY GET.
struct FdOwner {
  int fd = -1;
  explicit FdOwner(int f) : fd(f) {}
  FdOwner(const FdOwner&) = delete;
  FdOwner& operator=(const FdOwner&) = delete;
  ~FdOwner() {
    if (fd >= 0) close(fd);
  }
};

struct Volume {
  uint32_t vid = 0;
  std::string dat_path, idx_path;
  std::shared_ptr<FdOwner> dat, idx;
  int version = 3;
  bool writable = true;
  std::mutex mu;  // guards appends + map mutation + counters
  std::unordered_map<uint64_t, NeedleValue> map;
  int64_t idx_loaded = 0;  // bytes of .idx reflected in `map`
  int64_t dat_size = 0;
  int64_t idx_size = 0;  // append offset: tracked, not lseek'd per PUT
  uint64_t last_append_ns = 0;
  uint64_t max_key = 0;
  int64_t file_count = 0, file_bytes = 0;
  int64_t del_count = 0, del_bytes = 0;

  int dat_fd() const { return dat ? dat->fd : -1; }
  int idx_fd() const { return idx ? idx->fd : -1; }

  // Apply one idx entry to the in-memory map (NeedleMap._load semantics).
  void apply(uint64_t key, uint32_t off, int32_t size) {
    if (key > max_key) max_key = key;
    file_count++;
    auto it = map.find(key);
    // size == 0 is a live empty file (python Volume.write_needle keeps it
    // in its map); only off==0 / negative size (tombstone) delete
    if (off != 0 && size >= 0) {
      if (it != map.end() && it->second.stored_offset != 0 &&
          it->second.size >= 0) {
        del_count++;
        del_bytes += it->second.size;
      }
      map[key] = NeedleValue{off, size};
      if (size > 0) file_bytes += size;
    } else {
      del_count++;
      if (it != map.end()) {
        if (it->second.size > 0) del_bytes += it->second.size;
        map.erase(it);
      }
    }
  }

  // Read .idx entries in [idx_loaded, EOF) into the map. mu held.
  bool catchup() {
    struct stat st;
    if (fstat(idx_fd(), &st) != 0) return false;
    if (st.st_size > idx_size) idx_size = st.st_size;
    if (st.st_size <= idx_loaded) return true;
    int64_t want = st.st_size - idx_loaded;
    std::vector<uint8_t> buf(want);
    int64_t got = pread(idx_fd(), buf.data(), want, idx_loaded);
    if (got < 0) return false;
    got -= got % 16;
    for (int64_t i = 0; i + 16 <= got; i += 16)
      apply(get_u64(&buf[i]), get_u32(&buf[i + 8]),
            (int32_t)get_u32(&buf[i + 12]));
    idx_loaded += got;
    return true;
  }

  bool open_files() {
    int dfd = open(dat_path.c_str(), O_RDWR | O_CREAT, 0644);
    int ifd = open(idx_path.c_str(), O_RDWR | O_CREAT, 0644);
    if (dfd < 0 || ifd < 0) {
      if (dfd >= 0) close(dfd);
      if (ifd >= 0) close(ifd);
      return false;
    }
    // old owners (if any) release when the last in-flight reader drops
    dat = std::make_shared<FdOwner>(dfd);
    idx = std::make_shared<FdOwner>(ifd);
    struct stat st;
    if (fstat(dfd, &st) == 0) dat_size = st.st_size;
    if (fstat(ifd, &st) == 0) idx_size = st.st_size;
    map.clear();
    idx_loaded = 0;
    file_count = file_bytes = del_count = del_bytes = 0;
    max_key = 0;
    return catchup();
  }

  uint64_t next_append_ns() {
    struct timespec ts;
    clock_gettime(CLOCK_REALTIME, &ts);
    uint64_t now = (uint64_t)ts.tv_sec * 1000000000ull + ts.tv_nsec;
    if (now <= last_append_ns) now = last_append_ns + 1;
    last_append_ns = now;
    return now;
  }

  // Append a fully-built record; write the idx entry; update the map.
  // ns_off >= 0: stamp a fresh monotonic appendAtNs into blob[ns_off..+8).
  // idx_size: size field for the idx entry (kTombstone for deletes).
  // Returns byte offset in .dat, or -1. mu held.
  int64_t append(uint8_t* blob, int64_t len, uint64_t key, int32_t ent_size,
                 int64_t ns_off, uint64_t* ns_out) {
    // dat_size/idx_size are authoritative (single writer under mu, both
    // re-derived on open/reload): appends cost two pwrites, not the old
    // two lseeks + two pwrites — syscalls dominate this hot path.
    int64_t off = dat_size;
    if (off % kPad) {  // realign a torn tail (volume.py _append_record)
      off += kPad - (off % kPad);
      if (ftruncate(dat_fd(), off) != 0) return -1;
      dat_size = off;
    }
    if (off + len > kMaxVolumeSize) { errno = EFBIG; return -1; }
    if (ns_off >= 0) {
      uint64_t ns = next_append_ns();
      put_u64(blob + ns_off, ns);
      if (ns_out) *ns_out = ns;
    }
    int64_t wr = pwrite(dat_fd(), blob, len, off);
    if (wr != len) {
      (void)!ftruncate(dat_fd(), off);
      return -1;
    }
    dat_size = off + len;
    uint8_t ent[16];
    put_u64(ent, key);
    put_u32(ent + 8, (uint32_t)(off / kPad));
    put_u32(ent + 12, (uint32_t)ent_size);
    int64_t ioff = idx_size;
    if (pwrite(idx_fd(), ent, 16, ioff) != 16) {
      // an acknowledged-but-unindexed needle would 404 forever: undo the
      // .dat append and fail the request instead
      (void)!ftruncate(idx_fd(), ioff);
      (void)!ftruncate(dat_fd(), off);
      dat_size = off;
      return -1;
    }
    idx_size = ioff + 16;
    if (ioff == idx_loaded) {
      apply(key, (uint32_t)(off / kPad), ent_size);
      idx_loaded += 16;
    } else {
      catchup();
    }
    return off;
  }
};

struct Registry {
  std::shared_mutex mu;
  std::unordered_map<uint32_t, std::shared_ptr<Volume>> vols;

  std::shared_ptr<Volume> find(uint32_t vid) {
    std::shared_lock<std::shared_mutex> l(mu);
    auto it = vols.find(vid);
    return it == vols.end() ? nullptr : it->second;
  }
};

// ------------------------------------------------------ needle build/read --

struct ParsedNeedle {
  uint32_t cookie = 0;
  uint64_t id = 0;
  int32_t size = 0;
  const uint8_t* data = nullptr;
  uint32_t data_len = 0;
  uint8_t flags = 0;
  const uint8_t* mime = nullptr;
  uint8_t mime_len = 0;
  uint64_t last_modified = 0;
  uint32_t checksum = 0;
};

// Parse a v2/v3 record blob (needle.py from_bytes). Returns false on
// structural error.
bool parse_record(const uint8_t* b, int64_t len, int version,
                  ParsedNeedle* out) {
  if (len < kHeaderSize) return false;
  out->cookie = get_u32(b);
  out->id = get_u64(b + 4);
  out->size = (int32_t)get_u32(b + 12);
  int32_t size = out->size;
  if (size < 0 || kHeaderSize + (int64_t)size + kChecksumSize > len)
    return false;
  if (version == 1) {
    out->data = b + kHeaderSize;
    out->data_len = size;
  } else {
    const uint8_t* p = b + kHeaderSize;
    const uint8_t* end = p + size;
    if (p + 4 > end) { out->data_len = 0; }
    else {
      uint32_t dlen = get_u32(p);
      p += 4;
      if (p + dlen > end) return false;
      out->data = p;
      out->data_len = dlen;
      p += dlen;
      if (p < end) out->flags = *p++;
      if (p < end && (out->flags & kFlagHasName)) {
        uint8_t nl = *p++;
        p += nl;  // name skipped (not served in fast-path headers)
      }
      if (p < end && (out->flags & kFlagHasMime)) {
        out->mime_len = *p++;
        out->mime = p;
        p += out->mime_len;
      }
      if (p + 5 <= end && (out->flags & kFlagHasLastModified)) {
        uint64_t lm = 0;
        for (int i = 0; i < 5; i++) lm = (lm << 8) | p[i];
        out->last_modified = lm;
        p += 5;
      }
      if (p > end) return false;
    }
  }
  if (size > 0)
    out->checksum = get_u32(b + kHeaderSize + size);
  return true;
}

// ------------------------------------------------------------ HTTP plumb --

struct Plane {
  int id = 0;
  Registry reg;
  std::atomic<uint64_t> requests{0};
  // zero-copy GET serving: bodies at least zerocopy_min bytes
  // go disk->socket via sendfile(2); -1 disables the path entirely
  std::atomic<uint64_t> sendfiles{0};
  std::atomic<int64_t> zerocopy_min{4096};
  int listen_fd = -1;
  int port = 0;
  int redirect_port = 0;
  std::atomic<bool> stop{false};
  std::thread acceptor;
  std::atomic<int> live_conns{0};
};

std::mutex g_planes_mu;
std::unordered_map<int, std::shared_ptr<Plane>> g_planes;
int g_next_plane = 1;

std::shared_ptr<Plane> plane_of(int id) {
  std::lock_guard<std::mutex> l(g_planes_mu);
  auto it = g_planes.find(id);
  return it == g_planes.end() ? nullptr : it->second;
}

// Look a volume up across planes by (plane, vid).
std::shared_ptr<Volume> find_volume(int plane_id, uint32_t vid) {
  auto pl = plane_of(plane_id);
  return pl ? pl->reg.find(vid) : nullptr;
}

struct Request {
  std::string method, path, query, version;
  std::unordered_map<std::string, std::string> headers;  // lower-case keys
  std::vector<uint8_t> body;
  bool keepalive = true;
  // body arrived as Transfer-Encoding: chunked and was consumed off the
  // socket during parsing — the client CANNOT replay it after a 307
  // (requests raises UnrewindableBodyError on generator bodies), so
  // fall-back paths must proxy instead of redirect
  bool chunked = false;

  std::string header(const std::string& k) const {
    auto it = headers.find(k);
    return it == headers.end() ? "" : it->second;
  }
};

// recv with the 1s SO_RCVTIMEO tick: >0 bytes, 0 peer closed,
// -1 timeout tick (check stop / idle policy), -2 hard error.
ssize_t recv_step(int fd, char* tmp, size_t cap) {
  ssize_t n = recv(fd, tmp, cap, 0);
  if (n > 0) return n;
  if (n == 0) return 0;
  if (errno == EAGAIN || errno == EWOULDBLOCK || errno == EINTR) return -1;
  return -2;
}

bool read_exact(int fd, std::string& buf, size_t upto,
                const std::atomic<bool>& stop) {
  char tmp[8192];
  int idle_ticks = 0;
  while (buf.size() < upto) {
    ssize_t n = recv_step(fd, tmp, sizeof tmp);
    if (n > 0) { buf.append(tmp, n); idle_ticks = 0; continue; }
    if (n == -1) {  // mid-body stall: give a slow sender 30s
      if (stop.load(std::memory_order_relaxed) || ++idle_ticks > 30)
        return false;
      continue;
    }
    return false;
  }
  return true;
}

// Decode a chunked body starting at buf[body_start] (RFC 7230 §4.1),
// pulling more bytes from fd as needed. On success req->body holds the
// decoded payload and buf is trimmed past the final CRLF. Returns 0 ok,
// -1 connection lost, -2 bad framing. The python servers accept chunked
// uploads (server/filer.py _ChunkedReader), so the native planes must
// too — requests sends generator bodies this way (the S3 gateway's
// streaming unsigned PUT path).
int read_chunked(int fd, std::string& buf, size_t body_start, Request* req,
                 const std::atomic<bool>& stop) {
  req->body.clear();
  size_t pos = body_start;
  for (;;) {
    size_t eol;
    while ((eol = buf.find("\r\n", pos)) == std::string::npos) {
      if (buf.size() - pos > 1024) return -2;  // absurd chunk-size line
      if (!read_exact(fd, buf, buf.size() + 1, stop)) return -1;
    }
    std::string szline = buf.substr(pos, eol - pos);
    size_t semi = szline.find(';');  // drop chunk extensions
    if (semi != std::string::npos) szline.resize(semi);
    char* endp = nullptr;
    errno = 0;
    unsigned long long csz = strtoull(szline.c_str(), &endp, 16);
    if (endp == szline.c_str() || errno == ERANGE) return -2;
    // bound csz FIRST: body.size()+csz could wrap uint64 and a wrapped
    // data_start+csz would make read_exact trivially "succeed"
    if (csz > 256ull * 1024 * 1024 ||
        req->body.size() + csz > 256ull * 1024 * 1024)
      return -2;
    size_t data_start = eol + 2;
    if (csz == 0) {
      // optional trailers, then a blank line
      pos = data_start;
      for (;;) {
        size_t teol;
        while ((teol = buf.find("\r\n", pos)) == std::string::npos) {
          if (buf.size() - pos > 64 * 1024) return -2;
          if (!read_exact(fd, buf, buf.size() + 1, stop)) return -1;
        }
        bool blank = teol == pos;
        pos = teol + 2;
        if (blank) break;
      }
      buf.erase(0, pos);
      return 0;
    }
    if (!read_exact(fd, buf, data_start + csz + 2, stop)) return -1;
    req->body.insert(req->body.end(), buf.begin() + data_start,
                     buf.begin() + data_start + csz);
    if (buf.compare(data_start + csz, 2, "\r\n") != 0) return -2;
    pos = data_start + csz + 2;
    if (pos > (1u << 20)) {  // bound the staging buffer
      buf.erase(0, pos);
      pos = 0;
    }
  }
}

// Read one HTTP request. Returns 0 ok, -1 connection done, -2 bad request.
int read_request(int fd, std::string& buf, Request* req,
                 const std::atomic<bool>& stop) {
  size_t hdr_end;
  int idle_ticks = 0;
  while ((hdr_end = buf.find("\r\n\r\n")) == std::string::npos) {
    if (buf.size() > 64 * 1024) return -2;
    char tmp[8192];
    ssize_t n = recv_step(fd, tmp, sizeof tmp);
    if (n > 0) { buf.append(tmp, n); idle_ticks = 0; continue; }
    if (n == -1) {
      if (stop.load(std::memory_order_relaxed)) return -1;
      // idle keepalive connections may wait forever; a half-sent
      // request line gets 30s
      if (!buf.empty() && ++idle_ticks > 30) return -1;
      continue;
    }
    return -1;
  }
  std::string head = buf.substr(0, hdr_end);
  size_t line_end = head.find("\r\n");
  std::string reqline = head.substr(0, line_end);
  size_t sp1 = reqline.find(' '), sp2 = reqline.rfind(' ');
  if (sp1 == std::string::npos || sp2 == sp1) return -2;
  req->method = reqline.substr(0, sp1);
  std::string target = reqline.substr(sp1 + 1, sp2 - sp1 - 1);
  req->version = reqline.substr(sp2 + 1);
  size_t qpos = target.find('?');
  req->path = qpos == std::string::npos ? target : target.substr(0, qpos);
  req->query = qpos == std::string::npos ? "" : target.substr(qpos + 1);
  req->headers.clear();
  size_t pos = line_end + 2;
  while (pos < head.size()) {
    size_t eol = head.find("\r\n", pos);
    if (eol == std::string::npos) eol = head.size();
    std::string line = head.substr(pos, eol - pos);
    pos = eol + 2;
    size_t colon = line.find(':');
    if (colon == std::string::npos) continue;
    std::string k = line.substr(0, colon);
    for (auto& c : k) c = (char)tolower((unsigned char)c);
    size_t vstart = colon + 1;
    while (vstart < line.size() && line[vstart] == ' ') vstart++;
    req->headers[k] = line.substr(vstart);
  }
  req->keepalive = req->version != "HTTP/1.0";
  std::string conn = req->header("connection");
  for (auto& c : conn) c = (char)tolower((unsigned char)c);
  if (conn == "close") req->keepalive = false;
  if (conn == "keep-alive") req->keepalive = true;

  size_t body_start = hdr_end + 4;
  size_t clen = 0;
  std::string cl = req->header("content-length");
  if (!cl.empty()) clen = (size_t)strtoull(cl.c_str(), nullptr, 10);
  if (clen > 256u * 1024 * 1024) return -2;
  std::string te = req->header("transfer-encoding");
  req->chunked = false;
  if (!te.empty()) {
    for (auto& c : te) c = (char)tolower((unsigned char)c);
    if (te != "chunked") return -2;  // gzip/deflate TE: not supported
    req->chunked = true;
    return read_chunked(fd, buf, body_start, req, stop);
  }
  if (!read_exact(fd, buf, body_start + clen, stop)) return -1;
  req->body.assign(buf.begin() + body_start, buf.begin() + body_start + clen);
  buf.erase(0, body_start + clen);
  return 0;
}

void send_all(int fd, const void* p, size_t n) {
  const char* c = (const char*)p;
  while (n) {
    ssize_t w = send(fd, c, n, MSG_NOSIGNAL);
    if (w <= 0) return;
    c += w;
    n -= (size_t)w;
  }
}

const char* status_text(int code) {
  switch (code) {
    case 200: return "OK";
    case 201: return "Created";
    case 202: return "Accepted";
    case 206: return "Partial Content";
    case 304: return "Not Modified";
    case 307: return "Temporary Redirect";
    case 400: return "Bad Request";
    case 403: return "Forbidden";
    case 404: return "Not Found";
    case 411: return "Length Required";
    case 500: return "Internal Server Error";
    default: return "";
  }
}

void respond(int fd, const Request& req, int code, const std::string& ctype,
             const std::string& extra_headers, const uint8_t* body,
             size_t body_len) {
  if (req.method == "HEAD") body = nullptr;
  // single buffer -> single send(): no Nagle/delayed-ACK interaction.
  // Composed as a std::string: header size is unbounded (redirect
  // Locations echo the request path).
  std::string out;
  out.reserve(256 + extra_headers.size() + (body ? body_len : 0));
  out += "HTTP/1.1 ";
  out += std::to_string(code);
  out += ' ';
  out += status_text(code);
  out += "\r\nContent-Type: ";
  out += ctype;
  out += "\r\nContent-Length: ";
  out += std::to_string(body_len);
  out += "\r\n";
  out += extra_headers;
  if (!req.keepalive) out += "Connection: close\r\n";
  out += "\r\n";
  if (body && body_len) out.append((const char*)body, body_len);
  send_all(fd, out.data(), out.size());
}

void respond_json(int fd, const Request& req, int code,
                  const std::string& json) {
  respond(fd, req, code, "application/json", "", (const uint8_t*)json.data(),
          json.size());
}

// Forward an already-parsed request to the python server on loopback
// with Content-Length framing and relay the response verbatim. Used for
// chunked-TE requests, whose body the client cannot re-send after a 307.
void proxy_to_python(int fd, const Request& req, int backend_port) {
  int b = socket(AF_INET, SOCK_STREAM, 0);
  struct sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons((uint16_t)backend_port);
  addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  if (b < 0 || connect(b, (struct sockaddr*)&addr, sizeof addr) != 0) {
    if (b >= 0) close(b);
    return respond_json(fd, req, 500,
                        "{\"error\":\"python backend unreachable\"}");
  }
  struct timeval tv{60, 0};  // python writes can take a while
  setsockopt(b, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof tv);
  std::string out = req.method + " " + req.path +
                    (req.query.empty() ? "" : "?" + req.query) +
                    " HTTP/1.1\r\n";
  for (const auto& kv : req.headers) {
    if (kv.first == "transfer-encoding" || kv.first == "content-length" ||
        kv.first == "connection" || kv.first == "expect")
      continue;
    out += kv.first + ": " + kv.second + "\r\n";
  }
  out += "Content-Length: " + std::to_string(req.body.size()) + "\r\n";
  out += "Connection: close\r\n\r\n";
  send_all(b, out.data(), out.size());
  if (!req.body.empty()) send_all(b, req.body.data(), req.body.size());
  // relay until the backend closes (it honors Connection: close); the
  // relayed headers carry that close, so the client re-opens cleanly
  char tmp[16384];
  for (;;) {
    ssize_t n = recv(b, tmp, sizeof tmp, 0);
    if (n > 0) {
      send_all(fd, tmp, (size_t)n);
      continue;
    }
    if (n < 0 && errno == EINTR) continue;
    break;  // 0 = done; timeout/error = give up (client sees truncation)
  }
  close(b);
}

void redirect(int fd, const Request& req, int redirect_port) {
  if (req.chunked)  // consumed body is not replayable: forward instead
    return proxy_to_python(fd, req, redirect_port);
  std::string host = req.header("host");
  size_t colon = host.rfind(':');
  if (colon != std::string::npos) host = host.substr(0, colon);
  if (host.empty()) host = "127.0.0.1";
  std::string loc = "Location: http://" + host + ":" +
                    std::to_string(redirect_port) + req.path +
                    (req.query.empty() ? "" : "?" + req.query) + "\r\n";
  respond(fd, req, 307, "text/plain", loc, nullptr, 0);
}

// Parse a CLEAN "bytes=lo-hi" / "bytes=lo-" Range header. Anything
// unusual — suffix/multi ranges, non-digits, overflow-scale bounds —
// returns false and the caller defers to python, so edge semantics live
// in exactly one place per plane's python counterpart.
bool parse_clean_range(const std::string& rng, uint64_t* start,
                       uint64_t* hi, bool* has_hi) {
  if (rng.rfind("bytes=", 0) != 0) return false;
  std::string spec = rng.substr(6);
  size_t dash = spec.find('-');
  if (dash == std::string::npos || dash == 0 || dash > 15 ||
      spec.size() - dash - 1 > 15 ||
      spec.find(',') != std::string::npos)
    return false;
  for (size_t i = 0; i < spec.size(); i++)
    if (i != dash && !isdigit((unsigned char)spec[i])) return false;
  *start = strtoull(spec.c_str(), nullptr, 10);
  *has_hi = dash + 1 < spec.size();
  if (*has_hi) *hi = strtoull(spec.c_str() + dash + 1, nullptr, 10);
  return true;
}

// Parse "/vid,keyhex+cookiehex[.ext]". Returns false if not a fid path.
bool parse_fid_path(const std::string& path, uint32_t* vid, uint64_t* key,
                    uint32_t* cookie) {
  if (path.size() < 4 || path[0] != '/') return false;
  size_t comma = path.find(',');
  if (comma == std::string::npos || comma <= 1) return false;
  uint32_t v = 0;
  for (size_t i = 1; i < comma; i++) {
    if (!isdigit((unsigned char)path[i])) return false;
    v = v * 10 + (path[i] - '0');
  }
  std::string hex = path.substr(comma + 1);
  size_t dot = hex.find('.');
  if (dot != std::string::npos) hex = hex.substr(0, dot);
  uint64_t delta = 0;
  size_t us = hex.rfind('_');
  if (us != std::string::npos) {  // "key_delta" batched-assign suffix
    for (size_t i = us + 1; i < hex.size(); i++) {
      if (!isdigit((unsigned char)hex[i])) return false;
      delta = delta * 10 + (unsigned)(hex[i] - '0');
    }
    if (us + 1 >= hex.size()) return false;
    hex = hex.substr(0, us);
  }
  if (hex.size() <= 8 || hex.size() > 24) return false;
  uint64_t k = 0;
  uint32_t c = 0;
  size_t split = hex.size() - 8;
  for (size_t i = 0; i < hex.size(); i++) {
    char ch = (char)tolower((unsigned char)hex[i]);
    int d;
    if (ch >= '0' && ch <= '9') d = ch - '0';
    else if (ch >= 'a' && ch <= 'f') d = ch - 'a' + 10;
    else return false;
    if (i < split) k = (k << 4) | (unsigned)d;
    else c = (c << 4) | (unsigned)d;
  }
  *vid = v;
  *key = k + delta;
  *cookie = c;
  return true;
}

std::string etag_hex(uint32_t crc) {
  char b[16];
  snprintf(b, sizeof b, "%08x", crc);
  return std::string(b);
}

std::string http_date(uint64_t unix_secs) {
  char b[64];
  time_t t = (time_t)unix_secs;
  struct tm g;
  gmtime_r(&t, &g);
  strftime(b, sizeof b, "%a, %d %b %Y %H:%M:%S GMT", &g);
  return std::string(b);
}

// RFC 7232 §3.2 If-None-Match for GET/HEAD: WEAK comparison over the
// entity-tag list ("*" matches any representation) — mirrors
// utils/http.py parse_etag_list/weak_etag_match so both planes answer
// conditionals identically.
bool inm_matches(const std::string& inm, const std::string& etag) {
  std::string target = etag;
  if (target.rfind("W/", 0) == 0 || target.rfind("w/", 0) == 0)
    target = target.substr(2);
  size_t i = 0;
  while (i < inm.size()) {
    while (i < inm.size() &&
           (inm[i] == ',' || inm[i] == ' ' || inm[i] == '\t'))
      i++;
    if (i >= inm.size()) break;
    if (inm[i] == '*') return true;
    if (inm.compare(i, 2, "W/") == 0 || inm.compare(i, 2, "w/") == 0)
      i += 2;
    if (i < inm.size() && inm[i] == '"') {
      size_t end = inm.find('"', i + 1);
      if (end == std::string::npos) return false;
      if (inm.compare(i, end - i + 1, target) == 0) return true;
      i = end + 1;
    } else {  // lenient: bare token (some clients send unquoted md5s)
      size_t end = inm.find(',', i);
      if (end == std::string::npos) end = inm.size();
      std::string tok = inm.substr(i, end - i);
      while (!tok.empty() && (tok.back() == ' ' || tok.back() == '\t'))
        tok.pop_back();
      if (tok == target) return true;
      i = end;
    }
  }
  return false;
}

// ------------------------------------------------------------- handlers --

// Zero-copy GET: serve the needle body straight off
// the .dat fd with sendfile(2) — the payload never crosses user space.
// Two bounded preads fetch the record ENVELOPE only (the prefix locating
// the data span; the post-data tail carrying flags/mime/mtime and the
// stored checksum), then the kernel moves data_len bytes disk->socket.
// The stored checksum becomes the ETag WITHOUT a verify pass — skipping
// the per-GET CRC is exactly the copy this path deletes; at-rest
// integrity is owned by the scrub plane, and every buffered
// read (python, small needles, compressed/TTL records) still verifies.
// Returns true when the response (or a deliberate redirect) was fully
// handled; false falls through to the buffered path.
bool try_sendfile_get(Plane& pl, int fd, const Request& req, Volume& vol,
                      const NeedleValue& nv,
                      const std::shared_ptr<FdOwner>& ref,
                      uint32_t cookie) {
  int64_t zmin = pl.zerocopy_min.load(std::memory_order_relaxed);
  if (zmin < 0 || req.method != "GET" || nv.size <= 0) return false;
  int64_t base = (int64_t)nv.stored_offset * kPad;
  int32_t size = nv.size;
  int64_t data_off, data_len;
  uint8_t prefix[kHeaderSize + 4];
  if (vol.version == 1) {
    if (pread(ref->fd, prefix, kHeaderSize, base) != kHeaderSize)
      return false;
    data_off = kHeaderSize;
    data_len = size;
  } else {
    if (pread(ref->fd, prefix, sizeof prefix, base) !=
        (ssize_t)sizeof prefix)
      return false;
    data_off = kHeaderSize + 4;
    data_len = get_u32(prefix + kHeaderSize);
  }
  if (get_u32(prefix) != cookie) return false;  // buffered path 404s
  if (data_len < zmin) return false;  // small body: one pread is cheaper
  // the envelope after the data: flags/name/mime/lm + stored checksum
  int64_t tail_off = base + data_off + data_len;
  int64_t tail_len = base + kHeaderSize + size + kChecksumSize - tail_off;
  if (tail_len < kChecksumSize || tail_len > 4096)
    return false;  // structurally off / huge meta: buffered path decides
  uint8_t tail[4096 + kChecksumSize];
  if (pread(ref->fd, tail, tail_len, tail_off) != (ssize_t)tail_len)
    return false;
  uint8_t flags = 0;
  const uint8_t* mime = nullptr;
  uint8_t mime_len = 0;
  uint64_t last_modified = 0;
  const uint8_t* p = tail;
  const uint8_t* end = tail + (tail_len - kChecksumSize);
  if (vol.version != 1) {
    if (p < end) flags = *p++;
    if (p < end && (flags & kFlagHasName)) {
      uint8_t nl = *p++;
      p += nl;
    }
    if (p < end && (flags & kFlagHasMime)) {
      mime_len = *p++;
      if (p + mime_len > end) return false;
      mime = p;
      p += mime_len;
    }
    if (p + 5 <= end && (flags & kFlagHasLastModified)) {
      for (int i = 0; i < 5; i++)
        last_modified = (last_modified << 8) | p[i];
      p += 5;
    }
    if (p > end) return false;
  }
  if (flags & (kFlagHasTtl | kFlagHasPairs | kFlagCompressed))
    return false;  // py semantics / AE negotiation: buffered path
  uint32_t checksum = get_u32(tail + (tail_len - kChecksumSize));
  std::string etag = "\"" + etag_hex(checksum) + "\"";
  std::string extra = "ETag: " + etag + "\r\n";
  if (last_modified)
    extra += "Last-Modified: " + http_date(last_modified) + "\r\n";
  std::string inm = req.header("if-none-match");
  if (!inm.empty() && inm_matches(inm, etag)) {
    respond(fd, req, 304, "text/plain", extra, nullptr, 0);
    return true;
  }
  std::string ctype = mime_len
                          ? std::string((const char*)mime, mime_len)
                          : "application/octet-stream";
  uint64_t start = 0, stop = (uint64_t)data_len;
  int code = 200;
  std::string rng = req.header("range");
  if (!rng.empty()) {
    uint64_t lo = 0, hi = 0;
    bool has_hi = false;
    // inverted/past-EOF spans redirect too: python's shared
    // parse_range answers them with a spec-shaped 416
    if (!parse_clean_range(rng, &lo, &hi, &has_hi) ||
        lo >= (uint64_t)data_len || (has_hi && hi < lo)) {
      redirect(fd, req, pl.redirect_port);
      return true;
    }
    start = lo;
    stop = has_hi ? hi + 1 : (uint64_t)data_len;
    if (stop > (uint64_t)data_len) stop = (uint64_t)data_len;
    extra += "Content-Range: bytes " + std::to_string(start) + "-" +
             std::to_string(stop - 1) + "/" +
             std::to_string(data_len) + "\r\n";
    code = 206;
  }
  uint64_t body_len = stop > start ? stop - start : 0;
  std::string head;
  head.reserve(256 + extra.size());
  head += "HTTP/1.1 ";
  head += std::to_string(code);
  head += ' ';
  head += status_text(code);
  head += "\r\nContent-Type: ";
  head += ctype;
  head += "\r\nContent-Length: ";
  head += std::to_string(body_len);
  head += "\r\n";
  head += extra;
  if (!req.keepalive) head += "Connection: close\r\n";
  head += "\r\n";
  send_all(fd, head.data(), head.size());
  off_t off = (off_t)(base + data_off + (int64_t)start);
  uint64_t remaining = body_len;
  bool zero_copy = true;
  while (remaining > 0) {
    ssize_t s = sendfile(fd, ref->fd, &off, remaining);
    if (s > 0) {
      remaining -= (uint64_t)s;
      continue;
    }
    if (s < 0 && errno == EINTR) continue;
    if (s < 0 && (errno == EINVAL || errno == ENOSYS)) {
      // fs without sendfile support: finish buffered — the status line
      // is already on the wire, so this must complete the same body
      zero_copy = false;
      std::vector<uint8_t> buf(64 * 1024);
      while (remaining > 0) {
        ssize_t got = pread(
            ref->fd, buf.data(),
            remaining < buf.size() ? remaining : buf.size(), off);
        if (got <= 0) break;
        send_all(fd, buf.data(), (size_t)got);
        off += got;
        remaining -= (uint64_t)got;
      }
    }
    break;  // client gone / hard error: Content-Length exposes the gap
  }
  if (remaining == 0 && zero_copy)
    pl.sendfiles.fetch_add(1, std::memory_order_relaxed);
  return true;
}

void handle_get(Plane& pl, int fd, const Request& req, uint32_t vid,
                uint64_t key, uint32_t cookie) {
  auto vol = pl.reg.find(vid);
  if (!vol) return redirect(fd, req, pl.redirect_port);
  NeedleValue nv{0, 0};
  bool no_dat = false;
  std::shared_ptr<FdOwner> ref;
  {
    std::lock_guard<std::mutex> l(vol->mu);
    no_dat = !vol->dat;
    auto it = vol->map.find(key);
    if (it == vol->map.end()) {
      vol->catchup();  // maybe written outside our map (reload races)
      it = vol->map.find(key);
    }
    if (it != vol->map.end()) nv = it->second;
    // pin the fd owner while the map snapshot is consistent with it:
    // swdp_reload_volume (vacuum commit) swaps in a new owner under mu,
    // so a bare pread after unlock could hit the post-compaction file
    // at a stale offset. The shared_ptr copy keeps the pre-reload inode
    // open, against which nv's offset is valid — no dup() syscall.
    if (nv.stored_offset != 0 && nv.size >= 0) ref = vol->dat;
  }
  if (no_dat)
    // failed reload cleared the handles and the map: an empty map must
    // NOT read as a definitive 404 (the filer's read ladder would stop
    // failing over) — python owns the truth for this volume now
    return redirect(fd, req, pl.redirect_port);
  if (nv.stored_offset == 0 || nv.size < 0)
    return respond(fd, req, 404, "text/plain", "", nullptr, 0);
  if (!ref || ref->fd < 0)
    return respond_json(fd, req, 500, "{\"error\":\"no dat file\"}");
  // conditional-request conformance: If-None-Match both fast
  // paths evaluate natively (weak list comparison); every OTHER
  // validator header (If-Range, If-(Un)Modified-Since, If-Match) is
  // decided in exactly one place — the python handler
  if (!req.header("if-range").empty() ||
      !req.header("if-modified-since").empty() ||
      !req.header("if-match").empty() ||
      !req.header("if-unmodified-since").empty())
    return redirect(fd, req, pl.redirect_port);
  if (try_sendfile_get(pl, fd, req, *vol, nv, ref, cookie)) return;
  int64_t total = actual_size(nv.size, vol->version);
  std::vector<uint8_t> blob(total);
  int64_t got = pread(ref->fd, blob.data(), total,
                      (int64_t)nv.stored_offset * kPad);
  if (got != total)
    return respond_json(fd, req, 500, "{\"error\":\"short read\"}");
  ParsedNeedle n;
  if (!parse_record(blob.data(), total, vol->version, &n) || n.size != nv.size)
    return respond_json(fd, req, 500, "{\"error\":\"corrupt record\"}");
  if (n.cookie != cookie)
    return respond(fd, req, 404, "text/plain", "", nullptr, 0);
  if (n.flags & (kFlagHasTtl | kFlagHasPairs))
    return redirect(fd, req, pl.redirect_port);  // rare: py semantics
  uint32_t actual = crc32c(n.data, n.data_len);
  if (n.size > 0 && n.checksum != actual && n.checksum != crc_legacy(actual))
    return respond_json(fd, req, 500,
                        "{\"error\":\"CRC error! Data On Disk Corrupted\"}");
  std::string etag = "\"" + etag_hex(actual) + "\"";
  std::string inm = req.header("if-none-match");
  std::string extra = "ETag: " + etag + "\r\n";
  if (n.last_modified)
    extra += "Last-Modified: " + http_date(n.last_modified) + "\r\n";
  if (!inm.empty() && inm_matches(inm, etag))
    return respond(fd, req, 304, "text/plain", extra, nullptr, 0);
  std::string ctype = n.mime_len
                          ? std::string((const char*)n.mime, n.mime_len)
                          : "application/octet-stream";
  std::string rng = req.header("range");
  if (n.flags & kFlagCompressed) {
    // py decompresses for non-gzip clients and for ranged reads
    std::string ae = req.header("accept-encoding");
    if (ae.find("gzip") == std::string::npos || !rng.empty())
      return redirect(fd, req, pl.redirect_port);
    extra += "Content-Encoding: gzip\r\n";
  }
  if (!rng.empty()) {
    // Common "bytes=lo-hi" / "bytes=lo-" ranges are served natively with
    // volume.py's clamp semantics; anything else (incl. start past EOF)
    // is delegated to the python handler.
    uint64_t start = 0, hi = 0;
    bool has_hi = false;
    bool clean = parse_clean_range(rng, &start, &hi, &has_hi);
    // inverted spans redirect like suffix/past-EOF ones: python's
    // shared parse_range answers them with a spec-shaped 416
    if (!clean || start >= n.data_len || (has_hi && hi < start))
      return redirect(fd, req, pl.redirect_port);
    uint64_t stop = has_hi ? hi + 1 : n.data_len;
    if (stop > n.data_len) stop = n.data_len;
    extra += "Content-Range: bytes " + std::to_string(start) + "-" +
             std::to_string(stop - 1) + "/" +
             std::to_string(n.data_len) + "\r\n";
    return respond(fd, req, 206, ctype, extra, n.data + start,
                   stop - start);
  }
  respond(fd, req, 200, ctype, extra, n.data, n.data_len);
}

void handle_put(Plane& pl, int fd, const Request& req, uint32_t vid,
                uint64_t key, uint32_t cookie) {
  auto vol = pl.reg.find(vid);
  if (!vol || !vol->writable)
    return redirect(fd, req, pl.redirect_port);
  bool put_no_dat;
  {
    std::lock_guard<std::mutex> l(vol->mu);
    put_no_dat = !vol->dat;
  }
  if (put_no_dat)  // handles cleared by a failed reload: python owns it
    return redirect(fd, req, pl.redirect_port);
  std::string ct = req.header("content-type");
  if (ct.rfind("multipart/", 0) == 0)
    return redirect(fd, req, pl.redirect_port);
  bool compressed = req.header("content-encoding") == "gzip";

  const uint8_t* data = req.body.data();
  uint32_t dlen = (uint32_t)req.body.size();
  uint8_t flags = kFlagHasLastModified;
  if (!ct.empty() && ct.size() < 256) flags |= kFlagHasMime;
  if (compressed) flags |= kFlagCompressed;
  uint64_t now_secs = (uint64_t)time(nullptr);

  int32_t size = dlen ? (int32_t)(4 + dlen + 1 +
                                  ((flags & kFlagHasMime) ? 1 + ct.size() : 0) +
                                  5)
                      : 0;
  uint32_t crc = crc32c(data, dlen);
  int64_t total = actual_size(size, vol->version);
  std::vector<uint8_t> blob(total, 0);
  uint8_t* p = blob.data();
  put_u32(p, cookie);
  put_u64(p + 4, key);
  put_u32(p + 12, (uint32_t)size);
  int64_t off = kHeaderSize;
  if (dlen) {
    put_u32(p + off, dlen);
    off += 4;
    memcpy(p + off, data, dlen);
    off += dlen;
    p[off++] = flags;
    if (flags & kFlagHasMime) {
      p[off++] = (uint8_t)ct.size();
      memcpy(p + off, ct.data(), ct.size());
      off += ct.size();
    }
    for (int i = 0; i < 5; i++)
      p[off + i] = (uint8_t)(now_secs >> (32 - 8 * i));
    off += 5;
  }
  put_u32(p + off, crc);
  off += 4;
  int64_t ns_off = vol->version == 3 ? off : -1;

  {
    std::lock_guard<std::mutex> l(vol->mu);
    if (!vol->writable) {  // frozen between our gate check and the lock
      // (commit_compact freeze: appending now would write the old inode)
      goto frozen;
    }
    // dedup identical rewrite (volume.py _is_file_unchanged)
    auto it = vol->map.find(key);
    if (it != vol->map.end() && it->second.size > 0) {
      int64_t old_total = actual_size(it->second.size, vol->version);
      std::vector<uint8_t> old(old_total);
      if (pread(vol->dat_fd(), old.data(), old_total,
                (int64_t)it->second.stored_offset * kPad) == old_total) {
        ParsedNeedle on;
        if (parse_record(old.data(), old_total, vol->version, &on)) {
          if (on.cookie != cookie) {
            return respond_json(fd, req, 403,
                                "{\"error\":\"mismatching cookie\"}");
          }
          if (on.checksum == crc && on.data_len == dlen &&
              memcmp(on.data, data, dlen) == 0) {
            char out[128];
            snprintf(out, sizeof out,
                     "{\"name\": \"\", \"size\": %u, \"eTag\": \"%s\"}", dlen,
                     etag_hex(crc).c_str());
            return respond_json(fd, req, 201, out);
          }
        }
      }
    }
    if (vol->append(blob.data(), total, key, size, ns_off, nullptr) < 0)
      return respond_json(fd, req, 500, "{\"error\":\"append failed\"}");
  }
  {
    char out[128];
    snprintf(out, sizeof out,
             "{\"name\": \"\", \"size\": %d, \"eTag\": \"%s\"}",
             size, etag_hex(crc).c_str());
    return respond_json(fd, req, 201, out);
  }
frozen:
  redirect(fd, req, pl.redirect_port);
}

void handle_delete(Plane& pl, int fd, const Request& req, uint32_t vid,
                   uint64_t key, uint32_t cookie) {
  auto vol = pl.reg.find(vid);
  if (!vol || !vol->writable)
    return redirect(fd, req, pl.redirect_port);
  bool del_no_dat;
  {
    std::lock_guard<std::mutex> l(vol->mu);
    del_no_dat = !vol->dat;
  }
  if (del_no_dat)  // handles cleared by a failed reload: python owns it
    return redirect(fd, req, pl.redirect_port);
  int32_t freed = 0;
  {
    std::lock_guard<std::mutex> l(vol->mu);
    if (!vol->writable)  // frozen between gate check and lock
      goto frozen;
    auto it = vol->map.find(key);
    if (it == vol->map.end() || it->second.size < 0)
      return respond_json(fd, req, 404, "{\"size\": 0}");
    // cookie check against the stored record (volume.py delete_needle)
    uint8_t hdr[kHeaderSize];
    if (pread(vol->dat_fd(), hdr, kHeaderSize,
              (int64_t)it->second.stored_offset * kPad) == kHeaderSize) {
      if (get_u32(hdr) != cookie)
        return respond_json(fd, req, 403,
                            "{\"error\":\"cookie mismatch on delete\"}");
    }
    freed = it->second.size;
    // zero-size deletion marker record (doDeleteRequest)
    int64_t total = actual_size(0, vol->version);
    std::vector<uint8_t> blob(total, 0);
    put_u32(blob.data(), cookie);
    put_u64(blob.data() + 4, key);
    int64_t ns_off = vol->version == 3 ? kHeaderSize + kChecksumSize : -1;
    if (vol->append(blob.data(), total, key, kTombstone, ns_off, nullptr) < 0)
      return respond_json(fd, req, 500, "{\"error\":\"append failed\"}");
  }
  {
    char out[64];
    snprintf(out, sizeof out, "{\"size\": %d}", freed);
    return respond_json(fd, req, 202, out);
  }
frozen:
  redirect(fd, req, pl.redirect_port);
}

void handle_request(Plane& pl, int fd, const Request& req) {
  pl.requests.fetch_add(1, std::memory_order_relaxed);
  uint32_t vid, cookie;
  uint64_t key;
  if (!parse_fid_path(req.path, &vid, &key, &cookie))
    return redirect(fd, req, pl.redirect_port);
  if (req.method == "GET" || req.method == "HEAD") {
    // queries (resize, readDeleted) and ims need python semantics;
    // plain "bytes=lo-hi" ranges are served natively (filer chunk views)
    if (!req.query.empty() || !req.header("if-modified-since").empty())
      return redirect(fd, req, pl.redirect_port);
    return handle_get(pl, fd, req, vid, key, cookie);
  }
  if (req.method == "PUT" || req.method == "POST") {
    if (!req.query.empty() && req.query != "type=replicate")
      return redirect(fd, req, pl.redirect_port);
    return handle_put(pl, fd, req, vid, key, cookie);
  }
  if (req.method == "DELETE") {
    if (!req.query.empty() && req.query != "type=replicate")
      return redirect(fd, req, pl.redirect_port);
    return handle_delete(pl, fd, req, vid, key, cookie);
  }
  redirect(fd, req, pl.redirect_port);
}

void conn_loop(Plane* srv, int fd) {
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
  struct timeval tv{1, 0};  // 1s ticks so stop is noticed promptly
  setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof tv);
  std::string buf;
  Request req;
  while (!srv->stop.load(std::memory_order_relaxed)) {
    int rc = read_request(fd, buf, &req, srv->stop);
    if (rc == -1) break;
    if (rc == -2) {
      respond(fd, req, 400, "text/plain", "", nullptr, 0);
      break;
    }
    handle_request(*srv, fd, req);
    if (!req.keepalive) break;
  }
  close(fd);
  srv->live_conns.fetch_sub(1, std::memory_order_relaxed);
}

void acceptor_loop(Plane* srv) {
  while (!srv->stop.load(std::memory_order_relaxed)) {
    int fd = accept(srv->listen_fd, nullptr, nullptr);
    if (fd < 0) {
      if (srv->stop.load(std::memory_order_relaxed)) return;
      // a persistent failure (e.g. EMFILE under thread-per-conn load)
      // would otherwise busy-spin a full core
      if (errno != EINTR) usleep(20000);
      continue;
    }
    if (srv->live_conns.load(std::memory_order_relaxed) >= 1024) {
      close(fd);  // connection-flood backstop
      continue;
    }
    srv->live_conns.fetch_add(1, std::memory_order_relaxed);
    std::thread(conn_loop, srv, fd).detach();
  }
}

// ------------------------------------------------------- filer hot plane --
//
// C++ ownership of whole-object PUT/GET under a path prefix (default
// "/buckets/"), the filer analogue of the volume data plane above and the
// round-3 answer to the all-Python filer write path (~250 writes/s:
// 3 HTTP hops + store + event log per PUT). Design:
//
//   * Python leases fid blocks (batched master assigns) into the plane;
//     each native PUT mints one fid and appends the needle DIRECTLY into
//     the co-located volume plane's registry — zero HTTP hops when filer
//     and volume server share the process (`weed server`).
//   * Entry metadata is appended to a hot log + in-memory map; the
//     Python filer tails the log (FilerServer._absorb_hot_log) into the
//     real store, emitting metadata events on absorption. Listings /
//     metadata reads absorb-then-serve, so read-your-writes holds.
//   * GETs of hot objects are served from the map straight off the
//     volume plane; anything else (queries, ranges, conditionals,
//     multipart, oversized bodies, unknown paths) 307s to Python.
//   * Python-side mutations (S3 gateway, DELETE, rename) call
//     swfp_invalidate via the Filer.on_mutate hook so the map never
//     serves stale bytes.
//
// Reference counterpart: filer_server_handlers_write_autochunk.go:24
// (the per-request assign+upload+CreateEntry pipeline this replaces).

struct HotEntry {
  uint32_t vid = 0;
  uint64_t key = 0;
  uint32_t cookie = 0;
  uint64_t size = 0;
  uint32_t crc = 0;
  uint64_t mtime_ns = 0;
  std::string mime;
};

struct FidLease {
  uint32_t vid = 0;
  uint64_t base = 0;
  uint32_t cookie = 0;
  uint32_t next = 0;
  uint32_t count = 0;
};

struct FilerPlane {
  int id = 0;
  int listen_fd = -1;
  int port = 0, redirect_port = 0;
  int vol_plane_id = -1;
  size_t max_body = 4u << 20;
  std::string prefix = "/buckets/";
  std::atomic<bool> stop{false};
  std::thread acceptor;
  std::atomic<int> live_conns{0};
  std::atomic<uint64_t> requests{0}, native_puts{0}, native_gets{0},
      redirects{0};

  std::mutex mu;  // map + hot log + leases
  std::condition_variable lease_cv;  // signaled on swfp_add_lease
  std::unordered_map<std::string, HotEntry> map;
  std::deque<FidLease> leases;
  uint64_t lease_remaining = 0;
  int log_fd = -1;
  // set when a hot-log append failed (disk full / IO error): acked PUTs
  // could no longer be made durable, so the fast path stands down and
  // every PUT defers to the python filer until restart
  bool log_failed = false;

  ~FilerPlane() {
    if (log_fd >= 0) close(log_fd);
  }
};

std::mutex g_fplanes_mu;
std::unordered_map<int, std::shared_ptr<FilerPlane>> g_fplanes;
int g_next_fplane = 1;

std::shared_ptr<FilerPlane> fplane_of(int id) {
  std::lock_guard<std::mutex> l(g_fplanes_mu);
  auto it = g_fplanes.find(id);
  return it == g_fplanes.end() ? nullptr : it->second;
}

// Hot-log record, little-endian (tools read it with struct '<'):
// [u8 op=1][u16 plen][u16 mimelen][u32 vid][u64 key][u32 cookie]
// [u64 size][u32 crc][u64 mtime_ns][path][mime]
constexpr size_t kHotHdr = 1 + 2 + 2 + 4 + 8 + 4 + 8 + 4 + 8;

void put_le16(uint8_t* p, uint16_t v) { p[0] = v & 0xFF; p[1] = v >> 8; }
void put_le32(uint8_t* p, uint32_t v) {
  for (int i = 0; i < 4; i++) p[i] = (v >> (8 * i)) & 0xFF;
}
void put_le64(uint8_t* p, uint64_t v) {
  for (int i = 0; i < 8; i++) p[i] = (v >> (8 * i)) & 0xFF;
}

// Append one record; caller holds fp.mu. Returns false when the record
// could not be made fully durable — the caller must NOT ack the PUT
// (the acked entry would vanish on restart) and the plane stands down.
bool hotlog_append(FilerPlane& fp, const std::string& path,
                   const HotEntry& e) {
  if (fp.log_fd < 0 || fp.log_failed) return false;
  std::vector<uint8_t> rec(kHotHdr + path.size() + e.mime.size());
  uint8_t* p = rec.data();
  p[0] = 1;
  put_le16(p + 1, (uint16_t)path.size());
  put_le16(p + 3, (uint16_t)e.mime.size());
  put_le32(p + 5, e.vid);
  put_le64(p + 9, e.key);
  put_le32(p + 17, e.cookie);
  put_le64(p + 21, e.size);
  put_le32(p + 29, e.crc);
  put_le64(p + 33, e.mtime_ns);
  memcpy(p + kHotHdr, path.data(), path.size());
  memcpy(p + kHotHdr + path.size(), e.mime.data(), e.mime.size());
  // single write() so the python tailer never sees a torn record except
  // at a crash boundary (where it stops at the last complete record)
  off_t pre = lseek(fp.log_fd, 0, SEEK_CUR);
  ssize_t w = write(fp.log_fd, rec.data(), rec.size());
  if (w == (ssize_t)rec.size()) return true;
  // failed or short (disk full): remove the torn tail so the absorber
  // never stalls on it, and disable the fast path for good measure
  if (pre >= 0) {
    if (ftruncate(fp.log_fd, pre) == 0) lseek(fp.log_fd, pre, SEEK_SET);
  }
  fp.log_failed = true;
  return false;
}

std::string json_escape(const std::string& s) {
  std::string out;
  out.reserve(s.size() + 2);
  for (unsigned char c : s) {
    if (c == '"' || c == '\\') { out += '\\'; out += (char)c; }
    else if (c < 0x20) {
      char b[8];
      snprintf(b, sizeof b, "\\u%04x", c);
      out += b;
    } else out += (char)c;
  }
  return out;
}

// First-file-part extraction from multipart/form-data, mirroring the
// python filer's semantics (server/volume.py _extract_upload: first part
// with a payload wins, stored mime is empty). False defers to python
// (no/odd boundary, transfer-encoded or nested-multipart parts, framing
// surprises). Operates on a string_view over the body — no full copy.
bool parse_multipart(const std::string& ct, const std::vector<uint8_t>& body,
                     std::vector<uint8_t>* out) {
  size_t bp = ct.find("boundary=");
  if (bp == std::string::npos) return false;
  std::string b = ct.substr(bp + 9);
  if (!b.empty() && b.front() == '"') {
    size_t q = b.find('"', 1);
    if (q == std::string::npos) return false;
    b = b.substr(1, q - 1);
  } else {
    size_t sc = b.find(';');
    if (sc != std::string::npos) b = b.substr(0, sc);
  }
  if (b.empty()) return false;
  std::string delim = "--" + b;
  std::string_view data((const char*)body.data(), body.size());
  size_t p = data.find(delim);
  if (p == std::string::npos) return false;
  p += delim.size();
  if (data.substr(p, 2) != "\r\n") return false;
  p += 2;
  size_t hdr_end = data.find("\r\n\r\n", p);
  if (hdr_end == std::string::npos) return false;
  std::string hdrs(data.substr(p, hdr_end - p));
  for (auto& c : hdrs) c = (char)tolower((unsigned char)c);
  if (hdrs.find("content-transfer-encoding:") != std::string::npos)
    return false;  // base64/qp parts need python's email decoder
  if (hdrs.find("content-type: multipart/") != std::string::npos ||
      hdrs.find("content-type:multipart/") != std::string::npos)
    return false;  // nested container part: python skips to its children
  size_t body_start = hdr_end + 4;
  // the part ends at a TRUE delimiter LINE: CRLF + delim followed (after
  // optional linear whitespace padding) by CRLF or the closing "--".
  // RFC 2046 allows content containing CRLF + a PREFIX of the delimiter
  // ("\r\n--bonus" with boundary "b"), so a bare find() would truncate.
  std::string marker = "\r\n" + delim;
  size_t next = body_start > 0 ? body_start - 2 : 0;  // part may be empty
  for (;;) {
    next = data.find(marker, next);
    if (next == std::string::npos) return false;
    size_t after = next + marker.size();
    while (after < data.size() &&
           (data[after] == ' ' || data[after] == '\t'))
      after++;
    if (data.substr(after, 2) == "\r\n" || data.substr(after, 2) == "--")
      break;
    next += 1;  // prefix match inside content: keep scanning
  }
  if (next < body_start) return false;  // delimiter inside part headers
  out->assign(body.begin() + body_start, body.begin() + next);
  return true;
}

void handle_filer_put(FilerPlane& fp, int fd, const Request& req,
                      const std::string& path) {
  if (!req.query.empty() || req.body.size() > fp.max_body)
    return fp.redirects++, redirect(fd, req, fp.redirect_port);
  // the caller wants the whole-body md5 recorded as the entity-tag
  // (the S3 gateway's ETag contract) — only the python PUT path
  // computes it, so the absorbed entry would serve a different ETag
  // than the PUT returned
  if (!req.header("x-swfs-want-md5").empty() ||
      !req.header("content-md5").empty())
    return fp.redirects++, redirect(fd, req, fp.redirect_port);
  std::string ct = req.header("content-type");
  if (ct.size() >= 256 || !req.header("content-encoding").empty())
    return fp.redirects++, redirect(fd, req, fp.redirect_port);
  std::vector<uint8_t> part;
  bool is_multipart = ct.rfind("multipart/form-data", 0) == 0;
  if (is_multipart) {
    if (!parse_multipart(ct, req.body, &part))
      return fp.redirects++, redirect(fd, req, fp.redirect_port);
    ct.clear();  // python stores multipart uploads with empty mime
  } else if (ct.rfind("multipart/", 0) == 0) {
    return fp.redirects++, redirect(fd, req, fp.redirect_port);
  }
  if (path.empty() || path.size() >= 4096 || path.back() == '/')
    return fp.redirects++, redirect(fd, req, fp.redirect_port);
  bool log_down;
  {
    std::lock_guard<std::mutex> l(fp.mu);
    log_down = fp.log_failed;
  }
  if (log_down)  // can't make metadata durable: python owns PUTs
    return fp.redirects++, redirect(fd, req, fp.redirect_port);

  // mint a fid from the leased blocks; a dry pool briefly waits for the
  // python refill thread (bursts outrun it) before giving up to python
  uint32_t vid = 0, cookie = 0;
  uint64_t key = 0;
  {
    std::unique_lock<std::mutex> l(fp.mu);
    for (int attempt = 0; attempt < 2 && vid == 0; attempt++) {
      while (!fp.leases.empty()) {
        FidLease& ls = fp.leases.front();
        if (ls.next >= ls.count) { fp.leases.pop_front(); continue; }
        vid = ls.vid;
        key = ls.base + ls.next;
        cookie = ls.cookie;
        ls.next++;
        fp.lease_remaining--;
        break;
      }
      if (vid == 0 && attempt == 0)
        fp.lease_cv.wait_for(l, std::chrono::milliseconds(500),
                             [&] { return !fp.leases.empty(); });
    }
  }
  if (vid == 0)
    return fp.redirects++, redirect(fd, req, fp.redirect_port);
  auto vol = find_volume(fp.vol_plane_id, vid);
  if (!vol || !vol->writable)
    return fp.redirects++, redirect(fd, req, fp.redirect_port);

  // build + append the needle record (same wire as handle_put; fresh
  // keys never collide, so no dedup/cookie-check pass is needed)
  const uint8_t* data = is_multipart ? part.data() : req.body.data();
  uint32_t dlen =
      (uint32_t)(is_multipart ? part.size() : req.body.size());
  uint8_t flags = kFlagHasLastModified;
  if (!ct.empty()) flags |= kFlagHasMime;
  uint64_t now_secs = (uint64_t)time(nullptr);
  int32_t size = dlen ? (int32_t)(4 + dlen + 1 +
                                  ((flags & kFlagHasMime) ? 1 + ct.size() : 0) +
                                  5)
                      : 0;
  uint32_t crc = crc32c(data, dlen);
  int64_t total = actual_size(size, vol->version);
  std::vector<uint8_t> blob(total, 0);
  uint8_t* p = blob.data();
  put_u32(p, cookie);
  put_u64(p + 4, key);
  put_u32(p + 12, (uint32_t)size);
  int64_t off = kHeaderSize;
  if (dlen) {
    put_u32(p + off, dlen);
    off += 4;
    memcpy(p + off, data, dlen);
    off += dlen;
    p[off++] = flags;
    if (flags & kFlagHasMime) {
      p[off++] = (uint8_t)ct.size();
      memcpy(p + off, ct.data(), ct.size());
      off += ct.size();
    }
    for (int i = 0; i < 5; i++)
      p[off + i] = (uint8_t)(now_secs >> (32 - 8 * i));
    off += 5;
  }
  put_u32(p + off, crc);
  off += 4;
  int64_t ns_off = vol->version == 3 ? off : -1;
  uint64_t ns = 0;
  // socket writes (redirect/respond) happen OUTSIDE vol->mu: a slow
  // client must not stall the volume's whole IO (cf. handle_put's
  // goto-frozen structure)
  int append_rc = 1;  // 1 frozen, 0 ok, -1 failed
  {
    std::lock_guard<std::mutex> l(vol->mu);
    if (vol->writable)
      append_rc =
          vol->append(blob.data(), total, key, size, ns_off, &ns) < 0 ? -1
                                                                      : 0;
  }
  if (append_rc > 0)
    return fp.redirects++, redirect(fd, req, fp.redirect_port);
  if (append_rc < 0)
    return respond_json(fd, req, 500, "{\"error\":\"append failed\"}");
  if (!ns) ns = now_secs * 1000000000ull;

  HotEntry e;
  e.vid = vid;
  e.key = key;
  e.cookie = cookie;
  e.size = dlen;
  e.crc = crc;
  e.mtime_ns = ns;
  e.mime = ct;
  bool logged;
  {
    std::lock_guard<std::mutex> l(fp.mu);
    logged = hotlog_append(fp, path, e);
    if (logged) fp.map[path] = std::move(e);
  }
  if (!logged) {
    // never ack what the restart path can't recover; the needle becomes
    // an unreferenced orphan (vacuum reclaims it)
    return respond_json(fd, req, 500, "{\"error\":\"hot log write failed\"}");
  }
  fp.native_puts++;
  std::string name = path.substr(path.rfind('/') + 1);
  std::string out = "{\"name\": \"" + json_escape(name) +
                    "\", \"size\": " + std::to_string(dlen) + "}";
  respond_json(fd, req, 201, out);
}

void handle_filer_get(FilerPlane& fp, int fd, const Request& req,
                      const std::string& path) {
  // every validator except If-None-Match defers to python (the volume
  // plane's one-decision-point rule): If-Range especially — serving a
  // 206 against a stale validator would let a client splice new bytes
  // onto an old partial download
  if (!req.query.empty() || !req.header("if-modified-since").empty() ||
      !req.header("if-range").empty() || !req.header("if-match").empty() ||
      !req.header("if-unmodified-since").empty())
    return fp.redirects++, redirect(fd, req, fp.redirect_port);
  HotEntry e;
  {
    std::lock_guard<std::mutex> l(fp.mu);
    auto it = fp.map.find(path);
    if (it == fp.map.end())
      return fp.redirects++, redirect(fd, req, fp.redirect_port);
    e = it->second;
  }
  auto vol = find_volume(fp.vol_plane_id, e.vid);
  if (!vol)
    return fp.redirects++, redirect(fd, req, fp.redirect_port);
  NeedleValue nv{0, 0};
  std::shared_ptr<FdOwner> ref;
  {
    std::lock_guard<std::mutex> l(vol->mu);
    auto it = vol->map.find(e.key);
    if (it == vol->map.end()) {
      vol->catchup();
      it = vol->map.find(e.key);
    }
    if (it != vol->map.end()) nv = it->second;
    if (nv.stored_offset != 0 && nv.size >= 0) ref = vol->dat;
  }
  if (nv.stored_offset == 0 || nv.size < 0 || !ref || ref->fd < 0)
    return fp.redirects++, redirect(fd, req, fp.redirect_port);
  int64_t total = actual_size(nv.size, vol->version);
  std::vector<uint8_t> blob(total);
  int64_t got = pread(ref->fd, blob.data(), total,
                      (int64_t)nv.stored_offset * kPad);
  ParsedNeedle n;
  if (got != total ||
      !parse_record(blob.data(), total, vol->version, &n) ||
      n.cookie != e.cookie || crc32c(n.data, n.data_len) != e.crc)
    return fp.redirects++, redirect(fd, req, fp.redirect_port);
  std::string etag = "\"" + etag_hex(e.crc) + "\"";
  std::string extra = "ETag: " + etag + "\r\n";
  extra += "Last-Modified: " + http_date(e.mtime_ns / 1000000000ull) +
           "\r\n";
  std::string inm = req.header("if-none-match");
  if (!inm.empty() && inm_matches(inm, etag)) {
    fp.native_gets++;
    return respond(fd, req, 304, "text/plain", extra, nullptr, 0);
  }
  std::string ctype =
      e.mime.empty() ? "application/octet-stream" : e.mime;
  std::string rng = req.header("range");
  if (!rng.empty()) {
    // clean "bytes=lo-hi" / "bytes=lo-" only, mirroring the python
    // filer's _parse_range clamp exactly on this subset; suffix forms,
    // multi-ranges, malformed and unsatisfiable specs defer to python
    // (which owns the 416 / ServeContent-leniency edge semantics)
    uint64_t start = 0, hi = 0;
    bool has_hi = false;
    bool clean = parse_clean_range(rng, &start, &hi, &has_hi);
    uint64_t size = n.data_len;
    uint64_t stop = has_hi ? (hi + 1 < size ? hi + 1 : size) : size;
    if (!clean || start >= size || stop <= start)
      return fp.redirects++, redirect(fd, req, fp.redirect_port);
    extra += "Content-Range: bytes " + std::to_string(start) + "-" +
             std::to_string(stop - 1) + "/" + std::to_string(size) +
             "\r\n";
    fp.native_gets++;
    return respond(fd, req, 206, ctype, extra, n.data + start,
                   stop - start);
  }
  fp.native_gets++;
  respond(fd, req, 200, ctype, extra, n.data, n.data_len);
}

bool valid_utf8(const std::string& s) {
  size_t i = 0;
  while (i < s.size()) {
    unsigned char c = s[i];
    int follow;
    unsigned cp_min;
    if (c < 0x80) { i++; continue; }
    else if ((c & 0xE0) == 0xC0) { follow = 1; cp_min = 0x80; }
    else if ((c & 0xF0) == 0xE0) { follow = 2; cp_min = 0x800; }
    else if ((c & 0xF8) == 0xF0) { follow = 3; cp_min = 0x10000; }
    else return false;
    if (i + follow >= s.size()) return false;
    unsigned cp = c & (0x3F >> follow);
    for (int k = 1; k <= follow; k++) {
      unsigned char b = s[i + k];
      if ((b & 0xC0) != 0x80) return false;
      cp = (cp << 6) | (b & 0x3F);
    }
    if (cp < cp_min || cp > 0x10FFFF || (cp >= 0xD800 && cp <= 0xDFFF))
      return false;
    i += 1 + follow;
  }
  return true;
}

// Percent-decode a request path (RFC 3986; '+' stays literal, matching
// python's urllib.parse.unquote used by server/filer.py). False on a
// malformed escape OR a non-UTF8 result (escaped or raw) — the python
// absorber decodes logged paths with errors="replace", so keying the
// hot map by non-UTF8 bytes would diverge from the store path and
// python-side deletes could never invalidate the entry; those requests
// defer to python instead.
bool url_decode(const std::string& in, std::string* out) {
  out->clear();
  out->reserve(in.size());
  for (size_t i = 0; i < in.size(); i++) {
    if (in[i] != '%') {
      // raw bytes >= 0x80 decode as iso-8859-1 mojibake on the python
      // side (BaseHTTPRequestHandler), and a literal ';' is stripped
      // into urlparse's .params there — both canonicalize differently
      // from a byte-for-byte key, so defer them
      if ((unsigned char)in[i] >= 0x80 || in[i] == ';') return false;
      out->push_back(in[i]);
      continue;
    }
    if (i + 2 >= in.size() || !isxdigit((unsigned char)in[i + 1]) ||
        !isxdigit((unsigned char)in[i + 2]))
      return false;
    auto hex = [](char c) {
      return c <= '9' ? c - '0' : (c | 0x20) - 'a' + 10;
    };
    out->push_back((char)(hex(in[i + 1]) * 16 + hex(in[i + 2])));
    i += 2;
  }
  // C0 controls (esp. %00: swfp_invalidate takes NUL-terminated C
  // strings, so a key containing NUL could never be invalidated) and
  // non-UTF8 both defer to python
  for (unsigned char c : *out)
    if (c < 0x20) return false;
  return valid_utf8(*out);
}

void handle_filer_request(FilerPlane& fp, int fd, const Request& req) {
  fp.requests.fetch_add(1, std::memory_order_relaxed);
  // the python filer stores entries under the DECODED path
  // (server/filer.py unquote); hot-map keys, log records and
  // invalidations all use that same canonical form, so '/a%20b' and
  // '/a b' hit one entry rather than corrupting two. Paths the python
  // side would further normalize ('//' collapse, filer.py normalize)
  // defer to python — a hot-map key diverging from the store path could
  // never be invalidated.
  std::string path;
  if (url_decode(req.path, &path) &&
      path.find("//") == std::string::npos &&
      path.rfind(fp.prefix, 0) == 0) {
    if (req.method == "GET" || req.method == "HEAD")
      return handle_filer_get(fp, fd, req, path);
    if (req.method == "PUT" || req.method == "POST")
      return handle_filer_put(fp, fd, req, path);
  }
  fp.redirects++;
  redirect(fd, req, fp.redirect_port);
}

void filer_conn_loop(FilerPlane* srv, int fd) {
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
  struct timeval tv{1, 0};
  setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof tv);
  std::string buf;
  Request req;
  while (!srv->stop.load(std::memory_order_relaxed)) {
    int rc = read_request(fd, buf, &req, srv->stop);
    if (rc == -1) break;
    if (rc == -2) {
      respond(fd, req, 400, "text/plain", "", nullptr, 0);
      break;
    }
    handle_filer_request(*srv, fd, req);
    if (!req.keepalive) break;
  }
  close(fd);
  srv->live_conns.fetch_sub(1, std::memory_order_relaxed);
}

void filer_acceptor_loop(FilerPlane* srv) {
  while (!srv->stop.load(std::memory_order_relaxed)) {
    int fd = accept(srv->listen_fd, nullptr, nullptr);
    if (fd < 0) {
      if (srv->stop.load(std::memory_order_relaxed)) return;
      if (errno != EINTR) usleep(20000);
      continue;
    }
    if (srv->live_conns.load(std::memory_order_relaxed) >= 1024) {
      close(fd);
      continue;
    }
    srv->live_conns.fetch_add(1, std::memory_order_relaxed);
    std::thread(filer_conn_loop, srv, fd).detach();
  }
}

}  // namespace

// ----------------------------------------------------------------- C ABI --

extern "C" {

// Starts a plane; returns its positive id, or a negative errno.
int swdp_start(const char* bind_ip, int port, int redirect_port,
               int nthreads) {
  static std::once_flag crc_once;
  std::call_once(crc_once, crc_init);
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -errno;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
  struct sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons((uint16_t)port);
  addr.sin_addr.s_addr =
      bind_ip && *bind_ip ? inet_addr(bind_ip) : INADDR_ANY;
  if (bind(fd, (struct sockaddr*)&addr, sizeof addr) != 0 ||
      listen(fd, 256) != 0) {
    int e = errno;
    close(fd);
    return -e;
  }
  auto pl = std::make_shared<Plane>();
  pl->listen_fd = fd;
  pl->port = port;
  pl->redirect_port = redirect_port;
  (void)nthreads;  // per-connection threads; kept for ABI stability
  {
    std::lock_guard<std::mutex> l(g_planes_mu);
    pl->id = g_next_plane++;
    g_planes[pl->id] = pl;
  }
  pl->acceptor = std::thread(acceptor_loop, pl.get());
  return pl->id;
}

void swdp_stop(int plane_id) {
  std::shared_ptr<Plane> pl;
  {
    std::lock_guard<std::mutex> l(g_planes_mu);
    auto it = g_planes.find(plane_id);
    if (it == g_planes.end()) return;
    pl = it->second;
    g_planes.erase(it);
  }
  pl->stop.store(true);
  shutdown(pl->listen_fd, SHUT_RDWR);
  close(pl->listen_fd);
  pl->acceptor.join();
  // connection threads hold a raw Plane*; wait for them to notice stop
  // (1s recv ticks). If any straggle, park the plane in a graveyard so
  // the pointer stays valid for the thread's remaining lifetime.
  for (int i = 0; i < 50 && pl->live_conns.load() > 0; i++)
    usleep(100 * 1000);
  {
    std::unique_lock<std::shared_mutex> l(pl->reg.mu);
    pl->reg.vols.clear();
  }
  if (pl->live_conns.load() > 0) {
    static std::vector<std::shared_ptr<Plane>> graveyard;
    static std::mutex gm;
    std::lock_guard<std::mutex> l(gm);
    graveyard.push_back(pl);
  }
}

int swdp_add_volume(int plane_id, uint32_t vid, const char* dat_path,
                    const char* idx_path, int version, int writable) {
  auto pl = plane_of(plane_id);
  if (!pl) return -ENOENT;
  auto vol = std::make_shared<Volume>();
  vol->vid = vid;
  vol->dat_path = dat_path;
  vol->idx_path = idx_path;
  vol->version = version;
  vol->writable = writable != 0;
  if (!vol->open_files()) return -errno;
  std::unique_lock<std::shared_mutex> l(pl->reg.mu);
  pl->reg.vols[vid] = vol;
  return 0;
}

int swdp_remove_volume(int plane_id, uint32_t vid) {
  auto pl = plane_of(plane_id);
  if (!pl) return -ENOENT;
  std::unique_lock<std::shared_mutex> l(pl->reg.mu);
  return pl->reg.vols.erase(vid) ? 0 : -1;
}

int swdp_reload_volume(int plane_id, uint32_t vid) {
  auto vol = find_volume(plane_id, vid);
  if (!vol) return -1;
  std::lock_guard<std::mutex> l(vol->mu);
  // open_files swaps in fresh FdOwners; the old descriptors close when
  // the last in-flight reader releases its pinned shared_ptr
  if (!vol->open_files()) {
    int e = errno;
    // fail LOUDLY: a failed reopen after vacuum commit must not leave
    // the plane serving (and appending to) the pre-compaction inode —
    // dropping the holders + map turns every request into an explicit
    // error until a later reload succeeds
    vol->dat.reset();
    vol->idx.reset();
    vol->map.clear();
    vol->idx_loaded = 0;
    return -(e ? e : EIO);
  }
  return 0;
}

int swdp_set_writable(int plane_id, uint32_t vid, int writable) {
  auto vol = find_volume(plane_id, vid);
  if (!vol) return -1;
  std::lock_guard<std::mutex> l(vol->mu);
  vol->writable = writable != 0;
  return 0;
}

// Append a caller-built record (Python mutation funnel). Stamps a fresh
// monotonic appendAtNs at ns_off when ns_off >= 0. Returns the byte offset
// or a negative errno. idx_size: entry size field (-1 tombstone).
int64_t swdp_append_record(int plane_id, uint32_t vid, uint64_t key,
                           uint8_t* blob, int64_t len, int32_t idx_size,
                           int64_t ns_off, uint64_t* ns_out) {
  auto vol = find_volume(plane_id, vid);
  if (!vol) return -ENOENT;
  std::lock_guard<std::mutex> l(vol->mu);
  int64_t off = vol->append(blob, len, key, idx_size, ns_off, ns_out);
  return off < 0 ? -(int64_t)(errno ? errno : EIO) : off;
}

// Read the full record blob for a needle. *out is malloc'd; caller frees
// via swdp_free. Returns blob length, 0 if absent/deleted, negative errno.
int64_t swdp_read(int plane_id, uint32_t vid, uint64_t key, uint8_t** out) {
  auto vol = find_volume(plane_id, vid);
  if (!vol) return -ENOENT;
  NeedleValue nv{0, 0};
  std::shared_ptr<FdOwner> ref;
  {
    std::lock_guard<std::mutex> l(vol->mu);
    auto it = vol->map.find(key);
    if (it == vol->map.end()) {
      vol->catchup();
      it = vol->map.find(key);
    }
    if (it != vol->map.end()) nv = it->second;
    // see handle_get: pin the fd owner the snapshot refers to across
    // reloads (shared_ptr copy, no dup syscall)
    if (nv.stored_offset != 0 && nv.size >= 0) ref = vol->dat;
  }
  if (nv.stored_offset == 0 || nv.size < 0) return 0;
  if (!ref || ref->fd < 0) return -EIO;
  int64_t total = actual_size(nv.size, vol->version);
  uint8_t* buf = (uint8_t*)malloc(total);
  if (!buf) return -ENOMEM;
  int64_t got = pread(ref->fd, buf, total, (int64_t)nv.stored_offset * kPad);
  if (got != total) {
    free(buf);
    return -EIO;
  }
  *out = buf;
  return total;
}

void swdp_free(uint8_t* p) { free(p); }

int swdp_volume_stats(int plane_id, uint32_t vid, int64_t* file_count,
                      int64_t* file_bytes, int64_t* del_count,
                      int64_t* del_bytes, uint64_t* max_key,
                      int64_t* dat_size) {
  auto vol = find_volume(plane_id, vid);
  if (!vol) return -1;
  std::lock_guard<std::mutex> l(vol->mu);
  vol->catchup();
  if (file_count) *file_count = vol->file_count;
  if (file_bytes) *file_bytes = vol->file_bytes;
  if (del_count) *del_count = vol->del_count;
  if (del_bytes) *del_bytes = vol->del_bytes;
  if (max_key) *max_key = vol->max_key;
  if (dat_size) *dat_size = vol->dat_size;
  return 0;
}

// ---------------------------------------------------------- bench client --
// Native benchmark client: one keepalive connection looping PUT or GET
// over a fid list (the compiled-client counterpart of the reference's Go
// `weed benchmark` loop, benchmark.go:73-111). Returns the number of
// 2xx responses; per-request latencies (ns) land in out_lat_ns.

static bool bench_connect(const char* host, int port, int* out_fd) {
  struct sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons((uint16_t)port);
  addr.sin_addr.s_addr = inet_addr(host);
  if (addr.sin_addr.s_addr == INADDR_NONE) {
    struct addrinfo hints{}, *res = nullptr;
    hints.ai_family = AF_INET;
    hints.ai_socktype = SOCK_STREAM;
    if (getaddrinfo(host, nullptr, &hints, &res) != 0 || !res) {
      if (res) freeaddrinfo(res);
      return false;
    }
    addr.sin_addr = ((struct sockaddr_in*)res->ai_addr)->sin_addr;
    freeaddrinfo(res);
  }
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return false;
  if (connect(fd, (struct sockaddr*)&addr, sizeof addr) != 0) {
    close(fd);
    return false;
  }
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
  struct timeval tv{30, 0};
  setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof tv);
  *out_fd = fd;
  return true;
}

// Read one HTTP response (headers + content-length body); returns status
// or -1. `buf` carries leftover pipelined bytes between calls.
static int bench_read_response(int fd, std::string& buf) {
  size_t hdr_end;
  while ((hdr_end = buf.find("\r\n\r\n")) == std::string::npos) {
    char tmp[8192];
    ssize_t n = recv(fd, tmp, sizeof tmp, 0);
    if (n <= 0) return -1;
    buf.append(tmp, n);
  }
  if (buf.size() < 12) return -1;
  int status = atoi(buf.c_str() + 9);
  size_t clen = 0;
  size_t p = buf.find("ontent-Length:");
  if (p != std::string::npos && p < hdr_end)
    clen = (size_t)strtoull(buf.c_str() + p + 14, nullptr, 10);
  size_t total = hdr_end + 4 + clen;
  char tmp[8192];
  while (buf.size() < total) {
    ssize_t n = recv(fd, tmp, sizeof tmp, 0);
    if (n <= 0) return -1;
    buf.append(tmp, n);
  }
  buf.erase(0, total);
  return status;
}

extern "C" int64_t swdp_bench(const char* host, int port, int is_put,
                              const char** fids, int nfids,
                              const uint8_t* payload, int64_t plen,
                              int64_t* out_lat_ns) {
  int fd;
  if (!bench_connect(host, port, &fd)) return -errno;
  std::string head;
  head.reserve(512);
  std::string buf;
  int64_t ok = 0;
  for (int i = 0; i < nfids; i++) {
    struct timespec t0, t1;
    clock_gettime(CLOCK_MONOTONIC, &t0);
    head.clear();
    if (is_put) {
      head += "PUT /";
      head += fids[i];
      head += " HTTP/1.1\r\nHost: bench\r\nContent-Type: "
              "application/octet-stream\r\nContent-Length: ";
      head += std::to_string(plen);
      head += "\r\n\r\n";
      // head + body in ONE send: small-file PUTs are syscall-bound, and
      // two sends also invite a delayed-ACK stall
      head.append((const char*)payload, (size_t)plen);
      send_all(fd, head.data(), head.size());
    } else {
      head += "GET /";
      head += fids[i];
      head += " HTTP/1.1\r\nHost: bench\r\n\r\n";
      send_all(fd, head.data(), head.size());
    }
    int status = bench_read_response(fd, buf);
    if (status < 0) {  // dropped keepalive: reconnect once
      close(fd);
      buf.clear();
      if (!bench_connect(host, port, &fd)) break;
      continue;
    }
    clock_gettime(CLOCK_MONOTONIC, &t1);
    if (out_lat_ns)
      out_lat_ns[i] = (t1.tv_sec - t0.tv_sec) * 1000000000LL +
                      (t1.tv_nsec - t0.tv_nsec);
    if (status >= 200 && status < 300) ok++;
  }
  close(fd);
  return ok;
}

uint64_t swdp_request_count(int plane_id) {
  auto pl = plane_of(plane_id);
  return pl ? pl->requests.load() : 0;
}

// GETs served zero-copy via sendfile(2) since plane start.
uint64_t swdp_sendfile_count(int plane_id) {
  auto pl = plane_of(plane_id);
  return pl ? pl->sendfiles.load() : 0;
}

// Minimum body size for the sendfile path; -1 disables it (the A/B OFF
// arm / SWFS_ZEROCOPY=0). Returns 0 on success.
int swdp_set_zerocopy_min(int plane_id, int64_t min_bytes) {
  auto pl = plane_of(plane_id);
  if (!pl) return -1;
  pl->zerocopy_min.store(min_bytes);
  return 0;
}

// ------------------------------------------------- filer hot plane ABI --

// Starts a filer hot plane bound to `port`; non-hot requests 307 to
// `redirect_port` (the python filer listener). `vol_plane_id` is the
// co-located volume plane whose registry serves the needle IO.
// `log_path` is the hot entry log the python filer absorbs.
int swfp_start(const char* bind_ip, int port, int redirect_port,
               int vol_plane_id, const char* log_path, const char* prefix,
               int64_t max_body) {
  static std::once_flag crc_once;
  std::call_once(crc_once, crc_init);
  int lfd = open(log_path, O_WRONLY | O_CREAT | O_APPEND, 0644);
  if (lfd < 0) return -errno;
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) {
    close(lfd);
    return -errno;
  }
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
  struct sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons((uint16_t)port);
  addr.sin_addr.s_addr =
      bind_ip && *bind_ip ? inet_addr(bind_ip) : INADDR_ANY;
  if (bind(fd, (struct sockaddr*)&addr, sizeof addr) != 0 ||
      listen(fd, 256) != 0) {
    int e = errno;
    close(fd);
    close(lfd);
    return -e;
  }
  auto fp = std::make_shared<FilerPlane>();
  fp->listen_fd = fd;
  fp->log_fd = lfd;
  fp->port = port;
  fp->redirect_port = redirect_port;
  fp->vol_plane_id = vol_plane_id;
  if (prefix && *prefix) fp->prefix = prefix;
  if (max_body > 0) fp->max_body = (size_t)max_body;
  {
    std::lock_guard<std::mutex> l(g_fplanes_mu);
    fp->id = g_next_fplane++;
    g_fplanes[fp->id] = fp;
  }
  fp->acceptor = std::thread(filer_acceptor_loop, fp.get());
  return fp->id;
}

void swfp_stop(int id) {
  std::shared_ptr<FilerPlane> fp;
  {
    std::lock_guard<std::mutex> l(g_fplanes_mu);
    auto it = g_fplanes.find(id);
    if (it == g_fplanes.end()) return;
    fp = it->second;
    g_fplanes.erase(it);
  }
  fp->stop.store(true);
  shutdown(fp->listen_fd, SHUT_RDWR);
  close(fp->listen_fd);
  fp->acceptor.join();
  for (int i = 0; i < 300 && fp->live_conns.load() > 0; i++)
    usleep(10000);
}

// Feed a block of `count` fids (vid, base_key..base_key+count-1, cookie)
// from a batched master assign.
int swfp_add_lease(int id, uint32_t vid, uint64_t base_key, uint32_t cookie,
                   uint32_t count) {
  auto fp = fplane_of(id);
  if (!fp) return -ENOENT;
  {
    std::lock_guard<std::mutex> l(fp->mu);
    fp->leases.push_back(FidLease{vid, base_key, cookie, 0, count});
    fp->lease_remaining += count;
  }
  fp->lease_cv.notify_all();
  return 0;
}

uint64_t swfp_lease_remaining(int id) {
  auto fp = fplane_of(id);
  if (!fp) return 0;
  std::lock_guard<std::mutex> l(fp->mu);
  return fp->lease_remaining;
}

// Stand the fast path down: stop acking native PUTs (they redirect to
// python instead). Called when the python absorber detects hot-log
// corruption — acking writes whose metadata can never be absorbed would
// silently lose them.
int swfp_disable_log(int id) {
  auto fp = fplane_of(id);
  if (!fp) return -ENOENT;
  std::lock_guard<std::mutex> l(fp->mu);
  fp->log_failed = true;
  return 0;
}

// Drop a path from the hot map (python-side mutation: delete, rename,
// S3 overwrite). Returns 1 when present.
int swfp_invalidate(int id, const char* path) {
  auto fp = fplane_of(id);
  if (!fp) return -ENOENT;
  std::lock_guard<std::mutex> l(fp->mu);
  return fp->map.erase(path) ? 1 : 0;
}

// Drop a path and everything beneath it (recursive delete / rename).
int swfp_invalidate_prefix(int id, const char* path) {
  auto fp = fplane_of(id);
  if (!fp) return -ENOENT;
  std::string p(path);
  while (p.size() > 1 && p.back() == '/') p.pop_back();
  std::string prefix = p + "/";
  int n = 0;
  std::lock_guard<std::mutex> l(fp->mu);
  n += (int)fp->map.erase(p);
  for (auto it = fp->map.begin(); it != fp->map.end();) {
    if (it->first.rfind(prefix, 0) == 0) {
      it = fp->map.erase(it);
      n++;
    } else {
      ++it;
    }
  }
  return n;
}

int swfp_stats(int id, uint64_t* requests, uint64_t* native_puts,
               uint64_t* native_gets, uint64_t* redirects) {
  auto fp = fplane_of(id);
  if (!fp) return -ENOENT;
  if (requests) *requests = fp->requests.load();
  if (native_puts) *native_puts = fp->native_puts.load();
  if (native_gets) *native_gets = fp->native_gets.load();
  if (redirects) *redirects = fp->redirects.load();
  return 0;
}

}  // extern "C"
