// Native host runtime for rust_robotics_tpu_torch (C++17, no dependencies).
//
// The port's own copy of rust_robotics_tpu/native/host_runtime.cpp. The
// reference implements its host-side runtime in native code (Rust):
//   - MovingAI .map/.scen benchmark loader: planning/src/moving_ai.rs:21,178
//   - g2o pose-graph text I/O:              slam/src/g2o.rs:48,137
//   - dependency-free GIF rasterizer+encoder: viz/src/gif_recorder.rs:47-420
// This is host code, not a device kernel: the device path is PyTorch and the
// port's CUDA kernels; the parsing/encoding loops here are native so dataset
// ingest and media export never bottleneck on the Python interpreter.
// Exposed through a plain C ABI consumed via ctypes
// (rust_robotics_tpu_torch/native), built by g++ at first use
// (rust_robotics_tpu_torch/ops/_build.py::build_host).
//
// Protocol: parse functions return an opaque handle; callers query counts,
// copy into caller-allocated (numpy) buffers, then free the handle.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <string>
#include <vector>

#if defined(_WIN32)
#define RR_EXPORT extern "C" __declspec(dllexport)
#else
#define RR_EXPORT extern "C" __attribute__((visibility("default")))
#endif

namespace {

// ---------------------------------------------------------------------------
// small text utilities
// ---------------------------------------------------------------------------

struct LineIter {
  const char* p;
  const char* end;
  explicit LineIter(const char* text, size_t len) : p(text), end(text + len) {}
  // returns false when exhausted; line excludes the terminator
  bool next(const char** line, size_t* n) {
    if (p >= end) return false;
    const char* start = p;
    while (p < end && *p != '\n') ++p;
    const char* stop = p;
    if (p < end) ++p;                        // skip '\n'
    while (stop > start && (stop[-1] == '\r' || stop[-1] == ' ')) --stop;
    *line = start;
    *n = static_cast<size_t>(stop - start);
    return true;
  }
};

// split a line into whitespace-separated tokens (views into the buffer)
static int tokenize(const char* line, size_t n, const char** tok, size_t* tn,
                    int max_tok) {
  int k = 0;
  size_t i = 0;
  while (i < n && k < max_tok) {
    while (i < n && (line[i] == ' ' || line[i] == '\t')) ++i;
    if (i >= n) break;
    size_t s = i;
    while (i < n && line[i] != ' ' && line[i] != '\t') ++i;
    tok[k] = line + s;
    tn[k] = i - s;
    ++k;
  }
  return k;
}

static bool tok_eq(const char* t, size_t n, const char* lit) {
  return std::strlen(lit) == n && std::memcmp(t, lit, n) == 0;
}

static bool parse_i64(const char* t, size_t n, int64_t* out) {
  char buf[32];
  if (n == 0 || n >= sizeof(buf)) return false;
  std::memcpy(buf, t, n);
  buf[n] = 0;
  char* endp = nullptr;
  long long v = std::strtoll(buf, &endp, 10);
  if (endp != buf + n) return false;
  *out = v;
  return true;
}

static bool parse_f64(const char* t, size_t n, double* out) {
  char buf[64];
  if (n == 0 || n >= sizeof(buf)) return false;
  std::memcpy(buf, t, n);
  buf[n] = 0;
  char* endp = nullptr;
  double v = std::strtod(buf, &endp);
  if (endp != buf + n) return false;
  *out = v;
  return true;
}

// last error message (per-process; host parsing is single-threaded in our use)
static std::string g_err;
static void set_err(const std::string& m) { g_err = m; }

}  // namespace

RR_EXPORT const char* rr_last_error() { return g_err.c_str(); }

// ===========================================================================
// MovingAI .map parser (moving_ai.rs:21-151 semantics)
// ===========================================================================
//
// Octile maps: "type octile" / "height H" / "width W" / "map" / H rows.
// Passable tiles {'.','G','S','W'}; valid set {.,G,@,O,T,S,W}.

struct RRMap {
  int64_t width = 0;
  int64_t height = 0;
  std::vector<uint8_t> passable;  // row-major [height][width], 1 = passable
  std::vector<char> tiles;        // raw tile chars, row-major
};

RR_EXPORT void* rr_map_parse(const char* text, int64_t len) {
  LineIter it(text, static_cast<size_t>(len));
  const char* ln;
  size_t n;
  const char* tok[8];
  size_t tn[8];

  auto next_nonempty = [&](const char** l, size_t* m) {
    while (it.next(l, m)) {
      // skip blank lines (the Python parser also drops them)
      size_t i = 0;
      while (i < *m && (((*l)[i] == ' ') || ((*l)[i] == '\t'))) ++i;
      if (i < *m) return true;
    }
    return false;
  };

  if (!next_nonempty(&ln, &n) ||
      tokenize(ln, n, tok, tn, 8) != 2 ||
      !tok_eq(tok[0], tn[0], "type") || !tok_eq(tok[1], tn[1], "octile")) {
    set_err("unsupported MovingAI map type (expected 'type octile')");
    return nullptr;
  }
  auto hdr_int = [&](const char* key, int64_t* out) {
    if (!next_nonempty(&ln, &n)) return false;
    int k = tokenize(ln, n, tok, tn, 8);
    return k == 2 && tok_eq(tok[0], tn[0], key) && parse_i64(tok[1], tn[1], out);
  };
  auto* m = new RRMap();
  // height then width (the MovingAI header order)
  if (!hdr_int("height", &m->height) || !hdr_int("width", &m->width) ||
      m->height <= 0 || m->width <= 0) {
    set_err("bad height/width header");
    delete m;
    return nullptr;
  }
  if (!next_nonempty(&ln, &n) || !tok_eq(ln, n, "map")) {
    set_err("expected 'map' marker");
    delete m;
    return nullptr;
  }
  const size_t W = static_cast<size_t>(m->width);
  const size_t H = static_cast<size_t>(m->height);
  m->passable.assign(W * H, 0);
  m->tiles.assign(W * H, '@');
  for (size_t row = 0; row < H; ++row) {
    if (!next_nonempty(&ln, &n) || n < W) {
      set_err("map body shorter than declared height/width at row " +
              std::to_string(row));
      delete m;
      return nullptr;
    }
    for (size_t col = 0; col < W; ++col) {
      char c = ln[col];
      switch (c) {
        case '.': case 'G': case 'S': case 'W':
          m->passable[row * W + col] = 1;
          break;
        case '@': case 'O': case 'T':
          break;
        default:
          set_err(std::string("unknown tile '") + c + "'");
          delete m;
          return nullptr;
      }
      m->tiles[row * W + col] = c;
    }
  }
  return m;
}

RR_EXPORT int64_t rr_map_width(void* h) { return static_cast<RRMap*>(h)->width; }
RR_EXPORT int64_t rr_map_height(void* h) { return static_cast<RRMap*>(h)->height; }

// copies row-major [height][width]; buffers sized height*width by the caller
RR_EXPORT void rr_map_passable(void* h, uint8_t* out) {
  auto* m = static_cast<RRMap*>(h);
  std::memcpy(out, m->passable.data(), m->passable.size());
}
RR_EXPORT void rr_map_tiles(void* h, char* out) {
  auto* m = static_cast<RRMap*>(h);
  std::memcpy(out, m->tiles.data(), m->tiles.size());
}
RR_EXPORT void rr_map_free(void* h) { delete static_cast<RRMap*>(h); }

// ===========================================================================
// MovingAI .scen parser (moving_ai.rs:178-230)
// ===========================================================================
//
// Rows: bucket map_name width height sx sy gx gy optimal_length.
// Output: int64 columns [N,7] (bucket,w,h,sx,sy,gx,gy), double [N], names blob.

struct RRScen {
  std::vector<int64_t> ints;       // 7 per row
  std::vector<double> optimal;     // 1 per row
  std::string names;               // '\n'-joined map names, row order
};

RR_EXPORT void* rr_scen_parse(const char* text, int64_t len) {
  LineIter it(text, static_cast<size_t>(len));
  auto* s = new RRScen();
  const char* ln;
  size_t n;
  const char* tok[12];
  size_t tn[12];
  while (it.next(&ln, &n)) {
    int k = tokenize(ln, n, tok, tn, 12);
    if (k == 0) continue;
    if (tok_eq(tok[0], tn[0], "version") || tok_eq(tok[0], tn[0], "Version"))
      continue;
    if (k != 9) {
      set_err("bad .scen row (expected 9 fields, got " + std::to_string(k) + ")");
      delete s;
      return nullptr;
    }
    int64_t v[7];
    double opt;
    bool ok = parse_i64(tok[0], tn[0], &v[0]);
    for (int j = 0; j < 6; ++j)
      ok = ok && parse_i64(tok[2 + j], tn[2 + j], &v[1 + j]);
    ok = ok && parse_f64(tok[8], tn[8], &opt);
    if (!ok) {
      set_err("unparseable .scen fields");
      delete s;
      return nullptr;
    }
    for (int j = 0; j < 7; ++j) s->ints.push_back(v[j]);
    s->optimal.push_back(opt);
    if (!s->names.empty()) s->names.push_back('\n');
    s->names.append(tok[1], tn[1]);
  }
  return s;
}

RR_EXPORT int64_t rr_scen_count(void* h) {
  return static_cast<int64_t>(static_cast<RRScen*>(h)->optimal.size());
}
RR_EXPORT int64_t rr_scen_names_len(void* h) {
  return static_cast<int64_t>(static_cast<RRScen*>(h)->names.size());
}
// ints: [N,7] int64 (bucket,w,h,sx,sy,gx,gy); opt: [N] double; names: blob
RR_EXPORT void rr_scen_fill(void* h, int64_t* ints, double* opt, char* names) {
  auto* s = static_cast<RRScen*>(h);
  std::memcpy(ints, s->ints.data(), s->ints.size() * sizeof(int64_t));
  std::memcpy(opt, s->optimal.data(), s->optimal.size() * sizeof(double));
  std::memcpy(names, s->names.data(), s->names.size());
}
RR_EXPORT void rr_scen_free(void* h) { delete static_cast<RRScen*>(h); }

// ===========================================================================
// g2o text parser (slam/src/g2o.rs:48-137)
// ===========================================================================
//
// VERTEX_SE2 id x y th
// EDGE_SE2 from to dx dy dth  i11 i12 i13 i22 i23 i33        (upper tri 3x3)
// VERTEX_SE3:QUAT id tx ty tz qx qy qz qw
// EDGE_SE3:QUAT from to t(3) q(4) 21 upper-tri entries of 6x6 info
// Information matrices are expanded to full symmetric in the output arrays.

struct RRG2o {
  std::vector<int64_t> v2_ids;
  std::vector<double> v2_pose;     // [N2,3]
  std::vector<int64_t> e2_idx;     // [E2,2] raw ids (from,to)
  std::vector<double> e2_meas;     // [E2,3]
  std::vector<double> e2_info;     // [E2,9] full symmetric
  std::vector<int64_t> v3_ids;
  std::vector<double> v3_pose;     // [N3,7] t(3) q(4)
  std::vector<int64_t> e3_idx;     // [E3,2]
  std::vector<double> e3_meas;     // [E3,7] t(3) q(4)
  std::vector<double> e3_info;     // [E3,36] full symmetric
};

static bool fill_upper(const char** tok, size_t* tn, int base, int n,
                       std::vector<double>* out) {
  // read n*(n+1)/2 upper-tri values, append full symmetric n*n
  double u[21];
  const int cnt = n * (n + 1) / 2;
  for (int k = 0; k < cnt; ++k)
    if (!parse_f64(tok[base + k], tn[base + k], &u[k])) return false;
  size_t at = out->size();
  out->resize(at + static_cast<size_t>(n) * n);
  double* m = out->data() + at;
  int k = 0;
  for (int i = 0; i < n; ++i)
    for (int j = i; j < n; ++j) {
      m[i * n + j] = u[k];
      m[j * n + i] = u[k];
      ++k;
    }
  return true;
}

RR_EXPORT void* rr_g2o_parse(const char* text, int64_t len) {
  LineIter it(text, static_cast<size_t>(len));
  auto* g = new RRG2o();
  const char* ln;
  size_t n;
  const char* tok[40];
  size_t tn[40];
  int64_t line_no = 0;
  while (it.next(&ln, &n)) {
    ++line_no;
    int k = tokenize(ln, n, tok, tn, 40);
    if (k == 0) continue;
    bool ok = true;
    if (tok_eq(tok[0], tn[0], "VERTEX_SE2")) {
      int64_t id;
      double p[3];
      ok = k >= 5 && parse_i64(tok[1], tn[1], &id);
      for (int j = 0; j < 3 && ok; ++j) ok = parse_f64(tok[2 + j], tn[2 + j], &p[j]);
      if (ok) {
        g->v2_ids.push_back(id);
        g->v2_pose.insert(g->v2_pose.end(), p, p + 3);
      }
    } else if (tok_eq(tok[0], tn[0], "EDGE_SE2")) {
      int64_t a, b;
      double m[3];
      ok = k >= 12 && parse_i64(tok[1], tn[1], &a) && parse_i64(tok[2], tn[2], &b);
      for (int j = 0; j < 3 && ok; ++j) ok = parse_f64(tok[3 + j], tn[3 + j], &m[j]);
      ok = ok && fill_upper(tok, tn, 6, 3, &g->e2_info);
      if (ok) {
        g->e2_idx.push_back(a);
        g->e2_idx.push_back(b);
        g->e2_meas.insert(g->e2_meas.end(), m, m + 3);
      }
    } else if (tok_eq(tok[0], tn[0], "VERTEX_SE3:QUAT")) {
      int64_t id;
      double p[7];
      ok = k >= 9 && parse_i64(tok[1], tn[1], &id);
      for (int j = 0; j < 7 && ok; ++j) ok = parse_f64(tok[2 + j], tn[2 + j], &p[j]);
      if (ok) {
        g->v3_ids.push_back(id);
        g->v3_pose.insert(g->v3_pose.end(), p, p + 7);
      }
    } else if (tok_eq(tok[0], tn[0], "EDGE_SE3:QUAT")) {
      int64_t a, b;
      double m[7];
      ok = k >= 31 && parse_i64(tok[1], tn[1], &a) && parse_i64(tok[2], tn[2], &b);
      for (int j = 0; j < 7 && ok; ++j) ok = parse_f64(tok[3 + j], tn[3 + j], &m[j]);
      ok = ok && fill_upper(tok, tn, 10, 6, &g->e3_info);
      if (ok) {
        g->e3_idx.push_back(a);
        g->e3_idx.push_back(b);
        g->e3_meas.insert(g->e3_meas.end(), m, m + 7);
      }
    } else {
      continue;  // unknown tags skipped, matching the Python parser
    }
    if (!ok) {
      set_err("bad g2o record at line " + std::to_string(line_no));
      delete g;
      return nullptr;
    }
  }
  return g;
}

RR_EXPORT void rr_g2o_counts(void* h, int64_t* out4) {
  auto* g = static_cast<RRG2o*>(h);
  out4[0] = static_cast<int64_t>(g->v2_ids.size());
  out4[1] = static_cast<int64_t>(g->e2_idx.size() / 2);
  out4[2] = static_cast<int64_t>(g->v3_ids.size());
  out4[3] = static_cast<int64_t>(g->e3_idx.size() / 2);
}

RR_EXPORT void rr_g2o_fill_se2(void* h, int64_t* vids, double* vpose,
                               int64_t* eidx, double* emeas, double* einfo) {
  auto* g = static_cast<RRG2o*>(h);
  std::memcpy(vids, g->v2_ids.data(), g->v2_ids.size() * sizeof(int64_t));
  std::memcpy(vpose, g->v2_pose.data(), g->v2_pose.size() * sizeof(double));
  std::memcpy(eidx, g->e2_idx.data(), g->e2_idx.size() * sizeof(int64_t));
  std::memcpy(emeas, g->e2_meas.data(), g->e2_meas.size() * sizeof(double));
  std::memcpy(einfo, g->e2_info.data(), g->e2_info.size() * sizeof(double));
}

RR_EXPORT void rr_g2o_fill_se3(void* h, int64_t* vids, double* vpose,
                               int64_t* eidx, double* emeas, double* einfo) {
  auto* g = static_cast<RRG2o*>(h);
  std::memcpy(vids, g->v3_ids.data(), g->v3_ids.size() * sizeof(int64_t));
  std::memcpy(vpose, g->v3_pose.data(), g->v3_pose.size() * sizeof(double));
  std::memcpy(eidx, g->e3_idx.data(), g->e3_idx.size() * sizeof(int64_t));
  std::memcpy(emeas, g->e3_meas.data(), g->e3_meas.size() * sizeof(double));
  std::memcpy(einfo, g->e3_info.data(), g->e3_info.size() * sizeof(double));
}

RR_EXPORT void rr_g2o_free(void* h) { delete static_cast<RRG2o*>(h); }

// ===========================================================================
// GIF89a streaming encoder + rasterizer (gif_recorder.rs:47-420 analog)
// ===========================================================================
//
// Dependency-free like the reference: fixed 6x7x6 color cube palette
// (252 colors + 4 grays), LZW compression, NETSCAPE looping extension,
// frames streamed straight to the file (no frame list kept in memory).

namespace {

struct BitWriter {
  std::vector<uint8_t>* out;
  uint32_t acc = 0;
  int nbits = 0;
  void put(uint32_t code, int width) {
    acc |= code << nbits;
    nbits += width;
    while (nbits >= 8) {
      out->push_back(static_cast<uint8_t>(acc & 0xff));
      acc >>= 8;
      nbits -= 8;
    }
  }
  void flush() {
    if (nbits > 0) out->push_back(static_cast<uint8_t>(acc & 0xff));
    acc = 0;
    nbits = 0;
  }
};

// LZW-compress 8-bit index stream into GIF sub-blocks appended to `out`.
static void lzw_encode(const uint8_t* idx, size_t n, std::vector<uint8_t>* out) {
  const int min_code_size = 8;
  out->push_back(static_cast<uint8_t>(min_code_size));
  std::vector<uint8_t> payload;
  payload.reserve(n);
  BitWriter bw{&payload};

  const int CLEAR = 1 << min_code_size;          // 256
  const int EOI = CLEAR + 1;                     // 257
  // dict: (prefix_code << 8) | next_byte -> code; flat array for speed
  std::vector<int32_t> dict(4096 * 256);
  auto reset = [&]() { std::fill(dict.begin(), dict.end(), -1); };
  reset();
  int next_code = EOI + 1;
  int code_width = min_code_size + 1;

  bw.put(static_cast<uint32_t>(CLEAR), code_width);
  if (n == 0) {
    bw.put(static_cast<uint32_t>(EOI), code_width);
  } else {
    int cur = idx[0];
    for (size_t i = 1; i < n; ++i) {
      int c = idx[i];
      int32_t& slot = dict[(static_cast<size_t>(cur) << 8) | c];
      if (slot >= 0) {
        cur = slot;
        continue;
      }
      bw.put(static_cast<uint32_t>(cur), code_width);
      if (next_code < 4096) {
        slot = next_code++;
        if (next_code - 1 == (1 << code_width) && code_width < 12) ++code_width;
      } else {
        bw.put(static_cast<uint32_t>(CLEAR), code_width);
        reset();
        next_code = EOI + 1;
        code_width = min_code_size + 1;
      }
      cur = c;
    }
    bw.put(static_cast<uint32_t>(cur), code_width);
    bw.put(static_cast<uint32_t>(EOI), code_width);
  }
  bw.flush();
  // chop into <=255-byte sub-blocks
  size_t off = 0;
  while (off < payload.size()) {
    size_t chunk = payload.size() - off;
    if (chunk > 255) chunk = 255;
    out->push_back(static_cast<uint8_t>(chunk));
    out->insert(out->end(), payload.begin() + off, payload.begin() + off + chunk);
    off += chunk;
  }
  out->push_back(0);  // block terminator
}

struct RRGif {
  FILE* f = nullptr;
  int w = 0, h = 0;
  int frames = 0;
};

// 6x7x6 cube palette index for one RGB pixel
static inline uint8_t quantize_px(uint8_t r, uint8_t g, uint8_t b) {
  // rounding division by 255 into 0..5 / 0..6 levels
  int ri = (r * 5 + 127) / 255;
  int gi = (g * 6 + 127) / 255;
  int bi = (b * 5 + 127) / 255;
  return static_cast<uint8_t>(ri * 42 + gi * 6 + bi);
}

static void write_palette(FILE* f) {
  uint8_t pal[256 * 3];
  int k = 0;
  for (int ri = 0; ri < 6; ++ri)
    for (int gi = 0; gi < 7; ++gi)
      for (int bi = 0; bi < 6; ++bi) {
        pal[k * 3 + 0] = static_cast<uint8_t>(ri * 255 / 5);
        pal[k * 3 + 1] = static_cast<uint8_t>(gi * 255 / 6);
        pal[k * 3 + 2] = static_cast<uint8_t>(bi * 255 / 5);
        ++k;
      }
  for (; k < 256; ++k) {  // leftover slots: grays
    uint8_t v = static_cast<uint8_t>((k - 252) * 85);
    pal[k * 3 + 0] = pal[k * 3 + 1] = pal[k * 3 + 2] = v;
  }
  std::fwrite(pal, 1, sizeof(pal), f);
}

}  // namespace

RR_EXPORT void* rr_gif_open(const char* path, int32_t w, int32_t h) {
  FILE* f = std::fopen(path, "wb");
  if (!f) {
    set_err(std::string("cannot open ") + path);
    return nullptr;
  }
  auto* g = new RRGif{f, w, h, 0};
  std::fwrite("GIF89a", 1, 6, f);
  uint8_t lsd[7] = {
      static_cast<uint8_t>(w & 0xff), static_cast<uint8_t>(w >> 8),
      static_cast<uint8_t>(h & 0xff), static_cast<uint8_t>(h >> 8),
      0xF7,  // GCT present, 8 bits/color, 256 entries
      0, 0};
  std::fwrite(lsd, 1, 7, f);
  write_palette(f);
  // NETSCAPE2.0 infinite loop
  const uint8_t loop[] = {0x21, 0xFF, 0x0B, 'N', 'E', 'T', 'S', 'C', 'A', 'P',
                          'E', '2', '.', '0', 0x03, 0x01, 0x00, 0x00, 0x00};
  std::fwrite(loop, 1, sizeof(loop), f);
  return g;
}

// rgb: [h,w,3] row-major; delay in centiseconds
RR_EXPORT int32_t rr_gif_add_frame(void* handle, const uint8_t* rgb,
                                   int32_t delay_cs) {
  auto* g = static_cast<RRGif*>(handle);
  const size_t npx = static_cast<size_t>(g->w) * g->h;
  std::vector<uint8_t> idx(npx);
  for (size_t i = 0; i < npx; ++i)
    idx[i] = quantize_px(rgb[i * 3], rgb[i * 3 + 1], rgb[i * 3 + 2]);

  uint8_t gce[8] = {0x21, 0xF9, 0x04, 0x00,
                    static_cast<uint8_t>(delay_cs & 0xff),
                    static_cast<uint8_t>((delay_cs >> 8) & 0xff), 0x00, 0x00};
  std::fwrite(gce, 1, 8, g->f);
  uint8_t desc[10] = {0x2C, 0, 0, 0, 0,
                      static_cast<uint8_t>(g->w & 0xff),
                      static_cast<uint8_t>(g->w >> 8),
                      static_cast<uint8_t>(g->h & 0xff),
                      static_cast<uint8_t>(g->h >> 8),
                      0x00};  // no local color table
  std::fwrite(desc, 1, 10, g->f);
  std::vector<uint8_t> data;
  data.reserve(npx / 4);
  lzw_encode(idx.data(), npx, &data);
  std::fwrite(data.data(), 1, data.size(), g->f);
  ++g->frames;
  return g->frames;
}

RR_EXPORT int32_t rr_gif_close(void* handle) {
  auto* g = static_cast<RRGif*>(handle);
  std::fputc(0x3B, g->f);  // trailer
  int rc = std::fclose(g->f);
  int frames = g->frames;
  delete g;
  return rc == 0 ? frames : -1;
}

// quantize an RGB frame to the encoder's palette, returning palette RGB —
// lets tests assert the exact round-trip without decoding the GIF here
RR_EXPORT void rr_gif_quantize_rgb(const uint8_t* rgb, int64_t npx,
                                   uint8_t* out) {
  for (int64_t i = 0; i < npx; ++i) {
    uint8_t q = quantize_px(rgb[i * 3], rgb[i * 3 + 1], rgb[i * 3 + 2]);
    int ri = q / 42, gi = (q % 42) / 6, bi = q % 6;
    out[i * 3 + 0] = static_cast<uint8_t>(ri * 255 / 5);
    out[i * 3 + 1] = static_cast<uint8_t>(gi * 255 / 6);
    out[i * 3 + 2] = static_cast<uint8_t>(bi * 255 / 5);
  }
}

// ---------------------------------------------------------------------------
// Rasterizer: Bresenham polyline with disc stamping into an RGB buffer
// (gif_recorder.rs draw-primitive analog; hot when recording long demos)
// ---------------------------------------------------------------------------

static inline void stamp_disc(uint8_t* rgb, int w, int h, int cx, int cy,
                              int r, uint8_t cr, uint8_t cg, uint8_t cb) {
  for (int dy = -r; dy <= r; ++dy)
    for (int dx = -r; dx <= r; ++dx) {
      if (dx * dx + dy * dy > r * r) continue;
      int x = cx + dx, y = cy + dy;
      if (x < 0 || x >= w || y < 0 || y >= h) continue;
      uint8_t* p = rgb + (static_cast<size_t>(y) * w + x) * 3;
      p[0] = cr;
      p[1] = cg;
      p[2] = cb;
    }
}

// pts: [n,2] int32 pixel coords; draws connected polyline (n==1: one stamp)
RR_EXPORT void rr_draw_polyline(uint8_t* rgb, int32_t w, int32_t h,
                                const int32_t* pts, int64_t n,
                                int32_t radius, uint8_t r, uint8_t g,
                                uint8_t b) {
  if (n <= 0) return;
  if (n == 1) {
    stamp_disc(rgb, w, h, pts[0], pts[1], radius, r, g, b);
    return;
  }
  for (int64_t i = 0; i + 1 < n; ++i) {
    int x0 = pts[i * 2], y0 = pts[i * 2 + 1];
    int x1 = pts[(i + 1) * 2], y1 = pts[(i + 1) * 2 + 1];
    int dx = std::abs(x1 - x0), sx = x0 < x1 ? 1 : -1;
    int dy = -std::abs(y1 - y0), sy = y0 < y1 ? 1 : -1;
    int err = dx + dy;
    while (true) {
      stamp_disc(rgb, w, h, x0, y0, radius, r, g, b);
      if (x0 == x1 && y0 == y1) break;
      int e2 = 2 * err;
      if (e2 >= dy) {
        err += dy;
        x0 += sx;
      }
      if (e2 <= dx) {
        err += dx;
        y0 += sy;
      }
    }
  }
}
