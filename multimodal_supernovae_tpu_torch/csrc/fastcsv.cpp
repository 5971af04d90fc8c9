// fastcsv — minimal, fast CSV parsing for the ingest layer (the port's own
// copy of multimodal_supernovae_tpu/data/native/fastcsv.cpp, same C ABI),
// and the PNG row unfilter of data/png.py.
//
// The data layer parses thousands of small light-curve/spectra CSVs once at
// ingest (data/ztfbts.py). This parser reads the whole file with one syscall
// and tokenises in place, auto-typing each column (numeric -> double with NaN
// for empty/invalid cells, else string). Exposed through a tiny C ABI bound
// with ctypes (data/native.py), built at first use by kernels/build.py with
// the host compiler.
//
// Scope intentionally small: comma separator, optional header row, no
// quoted-field escapes (the ZTF BTS corpus has none).

#include <cerrno>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Column {
  std::string name;
  bool numeric = true;
  std::vector<double> values;        // valid when numeric
  std::vector<std::string> strings;  // always populated (numeric parse may fail late)
};

struct Table {
  std::vector<Column> cols;
  long long nrows = 0;
};

// Split one line into fields (in place over the buffer slice).
inline void split_fields(const char* begin, const char* end,
                         std::vector<std::pair<const char*, const char*>>& out) {
  out.clear();
  const char* field = begin;
  for (const char* p = begin; p <= end; ++p) {
    if (p == end || *p == ',') {
      const char* fe = p;
      // trim \r and spaces
      while (fe > field && (fe[-1] == '\r' || fe[-1] == ' ')) --fe;
      const char* fb = field;
      while (fb < fe && *fb == ' ') ++fb;
      out.emplace_back(fb, fe);
      field = p + 1;
    }
  }
}

inline bool parse_double(const char* b, const char* e, double* out) {
  if (b == e) {
    *out = std::nan("");
    return true;  // empty cell -> NaN, still numeric
  }
  char buf[64];
  size_t n = static_cast<size_t>(e - b);
  if (n >= sizeof(buf)) return false;
  std::memcpy(buf, b, n);
  buf[n] = 0;
  char* endp = nullptr;
  errno = 0;
  double v = std::strtod(buf, &endp);
  if (endp != buf + n || errno == ERANGE) {
    // allow NaN spellings
    if ((n == 3 && (std::strncmp(buf, "nan", 3) == 0 || std::strncmp(buf, "NaN", 3) == 0)) ||
        (n == 2 && std::strncmp(buf, "NA", 2) == 0)) {
      *out = std::nan("");
      return true;
    }
    return false;
  }
  *out = v;
  return true;
}

}  // namespace

extern "C" {

void* fastcsv_parse(const char* path, int has_header) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::string buf(static_cast<size_t>(size), '\0');
  if (size > 0 && std::fread(&buf[0], 1, static_cast<size_t>(size), f) !=
                      static_cast<size_t>(size)) {
    std::fclose(f);
    return nullptr;
  }
  std::fclose(f);

  Table* t = new Table();
  std::vector<std::pair<const char*, const char*>> fields;
  const char* p = buf.data();
  const char* end = buf.data() + buf.size();
  bool first_line = true;

  while (p < end) {
    const char* nl = static_cast<const char*>(std::memchr(p, '\n', end - p));
    const char* line_end = nl ? nl : end;
    if (line_end > p) {  // skip blank lines
      split_fields(p, line_end, fields);
      if (first_line) {
        t->cols.resize(fields.size());
        for (size_t c = 0; c < fields.size(); ++c) {
          if (has_header) {
            t->cols[c].name.assign(fields[c].first, fields[c].second);
          } else {
            t->cols[c].name = std::to_string(c);
          }
        }
        first_line = false;
        if (has_header) {
          p = line_end + 1;
          continue;
        }
      }
      size_t n = fields.size() < t->cols.size() ? fields.size() : t->cols.size();
      for (size_t c = 0; c < t->cols.size(); ++c) {
        const char* fb = c < n ? fields[c].first : nullptr;
        const char* fe = c < n ? fields[c].second : nullptr;
        Column& col = t->cols[c];
        col.strings.emplace_back(fb ? std::string(fb, fe) : std::string());
        if (col.numeric) {
          double v;
          if (fb ? parse_double(fb, fe, &v) : (v = std::nan(""), true)) {
            col.values.push_back(v);
          } else {
            col.numeric = false;
            col.values.clear();
          }
        }
      }
      ++t->nrows;
    }
    if (!nl) break;
    p = nl + 1;
  }
  return t;
}

int fastcsv_ncols(void* handle) {
  return static_cast<int>(static_cast<Table*>(handle)->cols.size());
}

long long fastcsv_nrows(void* handle) {
  return static_cast<Table*>(handle)->nrows;
}

const char* fastcsv_colname(void* handle, int c) {
  return static_cast<Table*>(handle)->cols[static_cast<size_t>(c)].name.c_str();
}

int fastcsv_col_is_numeric(void* handle, int c) {
  return static_cast<Table*>(handle)->cols[static_cast<size_t>(c)].numeric ? 1 : 0;
}

void fastcsv_copy_numeric(void* handle, int c, double* out) {
  const Column& col = static_cast<Table*>(handle)->cols[static_cast<size_t>(c)];
  std::memcpy(out, col.values.data(), col.values.size() * sizeof(double));
}

const char* fastcsv_string_item(void* handle, int c, long long r) {
  return static_cast<Table*>(handle)
      ->cols[static_cast<size_t>(c)]
      .strings[static_cast<size_t>(r)]
      .c_str();
}

void fastcsv_free(void* handle) { delete static_cast<Table*>(handle); }

// PNG scanline unfiltering (filter method 0, 8-bit samples): ``raw`` holds
// ``height`` rows of one filter-type byte and ``row_bytes`` filtered bytes;
// ``out`` receives height * row_bytes reconstructed bytes. ``bpp`` is the
// bytes per pixel (the left neighbour's distance). Returns 0, or -1 - r for
// an unknown filter type in row r.
int png_unfilter(const uint8_t* raw, uint8_t* out, int height, int row_bytes, int bpp) {
  for (int r = 0; r < height; ++r) {
    const uint8_t* src = raw + static_cast<size_t>(r) * (row_bytes + 1);
    const int ftype = src[0];
    ++src;
    uint8_t* cur = out + static_cast<size_t>(r) * row_bytes;
    const uint8_t* up = r > 0 ? cur - row_bytes : nullptr;
    for (int i = 0; i < row_bytes; ++i) {
      const int a = i >= bpp ? cur[i - bpp] : 0;
      const int b = up ? up[i] : 0;
      const int c = (up && i >= bpp) ? up[i - bpp] : 0;
      int pred;
      switch (ftype) {
        case 0: pred = 0; break;
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: {
          const int p = a + b - c;
          const int pa = p > a ? p - a : a - p;
          const int pb = p > b ? p - b : b - p;
          const int pc = p > c ? p - c : c - p;
          pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          break;
        }
        default: return -1 - r;
      }
      cur[i] = static_cast<uint8_t>(src[i] + pred);
    }
  }
  return 0;
}

}  // extern "C"
