// somvq_io — native data-file engine for som_lvq_pak_tpu.
//
// The reference package's data layer is ANSI C (datafile.c: line parser
// load_entry :552-748, writer write_entry :420-447); this is the
// framework's native equivalent: a single-pass parser that turns the
// text data/codebook format into dense arrays (the framework's Dataset
// layout) and a writer that formats them back, both exposed through a
// plain C ABI consumed via ctypes (no pybind11 in the image).
//
// Parity notes:
//   * component tokens parse as (float)strtod — the same double-rounded-
//     to-float value as the reference's `(float)atof` and NumPy's
//     float32(str)
//   * the writer emits "%g" per component with the reference's trailing-
//     space convention (write_entry, datafile.c:420-447)
//   * entries whose components are ALL masked are skipped when
//     skip_empty is set (datafile.c:676-696)
//   * weight= parses with atoi semantics (get_weight, datafile.c:912-915)
//
// Build: make -C native   (g++ -O3 -shared -fPIC)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

extern "C" {

typedef struct {
  int64_t n;          // number of entries
  int32_t dim;
  int32_t topol;      // 0 unknown, 1 data, 2 lvq, 3 hexa, 4 rect
  int32_t neigh;      // 0 unknown, 1 bubble, 2 gaussian
  int32_t xdim, ydim;

  float*   points;    // n * dim
  uint8_t* mask;      // n * dim, NULL if nothing masked
  float*   weight;    // n, NULL if no weight= token seen
  int32_t* fixedpt;   // n * 2, NULL if no fixed= token seen

  // labels: every label token of every entry, '\0'-separated, in entry
  // order; labcnt[i] = number of labels of entry i
  char*    labstr;
  int64_t  labstr_len;
  int32_t* labcnt;
  int64_t  total_labels;

  // '\n'-joined '#' comment lines seen before the header
  char*    comments;
  int64_t  comments_len;

  char     error[256];
} svq_data;

static void svq_init(svq_data* d) { memset(d, 0, sizeof(*d)); }

void svq_free(svq_data* d) {
  free(d->points); free(d->mask); free(d->weight); free(d->fixedpt);
  free(d->labstr); free(d->labcnt); free(d->comments);
  svq_init(d);
}

static int is_sep(char c) { return c == ' ' || c == '\t' || c == '\r'; }

// tokenize one line in place; returns token count
static int split_line(char* line, std::vector<char*>& toks) {
  toks.clear();
  char* p = line;
  while (*p) {
    while (is_sep(*p)) ++p;
    if (!*p || *p == '\n') break;
    toks.push_back(p);
    while (*p && !is_sep(*p) && *p != '\n') ++p;
    if (*p) { *p = '\0'; ++p; }
  }
  return (int)toks.size();
}

static int topol_id(const char* s) {
  if (!strcmp(s, "data")) return 1;
  if (!strcmp(s, "lvq"))  return 2;
  if (!strcmp(s, "hexa")) return 3;
  if (!strcmp(s, "rect")) return 4;
  return 0;
}

static int neigh_id(const char* s) {
  if (!strcmp(s, "bubble"))   return 1;
  if (!strcmp(s, "gaussian")) return 2;
  return 0;
}

// Per-slab row accumulator: the data lines of one contiguous region of
// the buffer parsed into column vectors (no header handling).  Slabs are
// disjoint, so N workers can fill N of these concurrently and the merge
// concatenates them in file order — output byte-identical to the
// single-threaded parse (tests/test_native.py asserts it).
struct RowData {
  std::vector<float>   points;
  std::vector<uint8_t> mask;
  std::vector<float>   weight;
  std::vector<int32_t> fixedpt;
  std::vector<int32_t> labcnt;
  std::string          labstr;
  bool any_mask = false, any_weight = false, any_fixed = false;
  int64_t total_labels = 0;
  char err[256] = {0};
};

// parse the data lines in [begin, end) — tokenizes in place.  A slab
// may only write within its own region: internal slabs end in '\n'
// (overwritten to '\0' here); the final slab ends at the buffer's
// trailing '\0' (the svq_parse_buffer contract) — never write at *end,
// that byte belongs to the next slab's worker.
static void parse_rows(char* begin, char* end, int dim,
                       const char* mask_str, int skip_empty, RowData* rd) {
  if (end > begin && end[-1] == '\n') end[-1] = '\0';
  std::vector<char*> toks;
  char* save = nullptr;
  for (char* line = strtok_r(begin, "\n", &save); line;
       line = strtok_r(nullptr, "\n", &save)) {
    if (line[0] == '#') continue;  // body comments are skipped
    int nt = split_line(line, toks);
    if (nt == 0) continue;
    if (nt < dim) {
      snprintf(rd->err, sizeof(rd->err),
               "short line: %d tokens, dim %d", nt, dim);
      return;
    }
    size_t row0 = rd->points.size();
    rd->points.resize(row0 + dim, 0.0f);
    rd->mask.resize(row0 + dim, 0);
    int nmasked = 0;
    for (int i = 0; i < dim; ++i) {
      if (!strcmp(toks[i], mask_str)) {
        rd->mask[row0 + i] = 1;
        ++nmasked;
        rd->any_mask = true;
      } else {
        rd->points[row0 + i] = (float)strtod(toks[i], nullptr);
      }
    }
    if (nmasked == dim && skip_empty) {  // datafile.c:676-686
      rd->points.resize(row0);
      rd->mask.resize(row0);
      continue;
    }
    float w = 0.0f;  // no weight= token => 0 sentinel (datafile.c:497)
    int32_t fx = -1, fy = -1;
    int nlabs = 0;
    for (int i = dim; i < nt; ++i) {
      if (!strncmp(toks[i], "weight=", 7)) {
        w = (float)atoi(toks[i] + 7);  // get_weight is atoi
        rd->any_weight = true;
      } else if (!strncmp(toks[i], "fixed=", 6)) {
        char* comma = strchr(toks[i] + 6, ',');
        fx = atoi(toks[i] + 6);
        fy = comma ? atoi(comma + 1) : 0;
        rd->any_fixed = true;
      } else {
        rd->labstr.append(toks[i]);
        rd->labstr.push_back('\0');
        ++nlabs;
      }
    }
    rd->weight.push_back(w);
    rd->fixedpt.push_back(fx);
    rd->fixedpt.push_back(fy);
    rd->labcnt.push_back(nlabs);
    rd->total_labels += nlabs;
  }
}

static int default_threads() {
  const char* env = getenv("SOMVQ_PARSE_THREADS");
  if (env && *env) {
    int t = atoi(env);
    if (t >= 1) return t > 64 ? 64 : t;
  }
  unsigned hc = std::thread::hardware_concurrency();
  int t = hc ? (int)hc : 1;
  return t > 16 ? 16 : t;
}

// parse a '\n'-separated text buffer (caller owns `buf`; it is modified
// in place during tokenization).  Files past ~4 MB parse the data region
// with a thread per slab (slabs split at line boundaries, merged in file
// order — the replacement for the reference's single-threaded
// read_entries loop, datafile.c:237-344, at device-training data volumes).
int svq_parse_buffer(char* buf, int64_t len, const char* mask_str,
                     int skip_empty, svq_data* out) {
  svq_init(out);

  std::string comments;
  int dim = -1;
  char* body = nullptr;  // first byte after the header line

  // header scan: comments and blank lines, then `dim [topol [x y neigh]]`
  char* p = buf;
  char* bufend = buf + (len >= 0 ? len : (int64_t)strlen(buf));
  while (p < bufend && dim < 0) {
    char* eol = (char*)memchr(p, '\n', bufend - p);
    char* lend = eol ? eol : bufend;
    if (p[0] == '#') {
      if (!comments.empty()) comments += '\n';
      comments.append(p, lend - p);
      // strip a trailing '\r'
      while (!comments.empty() && comments.back() == '\r') comments.pop_back();
    } else {
      // tokenize the candidate header in place
      char saved = *lend;
      *lend = '\0';
      std::vector<char*> toks;
      int nt = split_line(p, toks);
      if (nt > 0) {
        dim = atoi(toks[0]);
        if (dim <= 0) {
          *lend = saved;
          snprintf(out->error, sizeof(out->error), "bad header dimension");
          return 1;
        }
        out->dim = dim;
        if (nt > 1) out->topol = topol_id(toks[1]);
        if (nt > 2) out->xdim = atoi(toks[2]);
        if (nt > 3) out->ydim = atoi(toks[3]);
        if (nt > 4) out->neigh = neigh_id(toks[4]);
      }
      *lend = saved;
    }
    p = eol ? eol + 1 : bufend;
  }
  if (dim < 0) {
    snprintf(out->error, sizeof(out->error), "no header line");
    return 1;
  }
  body = p;

  // slab split: nominal even split of [body, bufend), each boundary
  // advanced to the next '\n' so every slab holds whole lines
  int64_t body_len = bufend - body;
  int nthreads = default_threads();
  if (body_len < (4 << 20) || nthreads < 2) nthreads = 1;
  std::vector<char*> starts(nthreads + 1);
  starts[0] = body;
  starts[nthreads] = bufend;
  for (int t = 1; t < nthreads; ++t) {
    char* cand = body + body_len * t / nthreads;
    if (cand <= starts[t - 1]) cand = starts[t - 1];
    char* nl = (char*)memchr(cand, '\n', bufend - cand);
    starts[t] = nl ? nl + 1 : bufend;
  }

  std::vector<RowData> slabs(nthreads);
  if (nthreads == 1) {
    parse_rows(body, bufend, dim, mask_str, skip_empty, &slabs[0]);
  } else {
    std::vector<std::thread> ths;
    for (int t = 0; t < nthreads; ++t)
      ths.emplace_back(parse_rows, starts[t], starts[t + 1], dim,
                       mask_str, skip_empty, &slabs[t]);
    for (auto& th : ths) th.join();
  }
  for (auto& rd : slabs)
    if (rd.err[0]) {
      snprintf(out->error, sizeof(out->error), "%s", rd.err);
      return 1;
    }

  // order-preserving merge
  int64_t n = 0, labstr_len = 0;
  bool any_mask = false, any_weight = false, any_fixed = false;
  for (auto& rd : slabs) {
    n += (int64_t)rd.labcnt.size();
    labstr_len += (int64_t)rd.labstr.size();
    any_mask |= rd.any_mask;
    any_weight |= rd.any_weight;
    any_fixed |= rd.any_fixed;
    out->total_labels += rd.total_labels;
  }
  out->n = n;
  out->points = (float*)malloc(sizeof(float) * n * dim);
  if (any_mask) out->mask = (uint8_t*)calloc(n * dim, 1);
  if (any_weight) out->weight = (float*)malloc(sizeof(float) * n);
  if (any_fixed) out->fixedpt = (int32_t*)malloc(sizeof(int32_t) * n * 2);
  out->labcnt = (int32_t*)malloc(sizeof(int32_t) * n);
  out->labstr = (char*)malloc(labstr_len + 1);
  int64_t ro = 0, lo = 0;
  for (auto& rd : slabs) {
    int64_t rn = (int64_t)rd.labcnt.size();
    memcpy(out->points + ro * dim, rd.points.data(),
           sizeof(float) * rn * dim);
    if (any_mask && !rd.mask.empty())
      memcpy(out->mask + ro * dim, rd.mask.data(), rn * dim);
    if (any_weight)
      memcpy(out->weight + ro, rd.weight.data(), sizeof(float) * rn);
    if (any_fixed)
      memcpy(out->fixedpt + ro * 2, rd.fixedpt.data(),
             sizeof(int32_t) * rn * 2);
    memcpy(out->labcnt + ro, rd.labcnt.data(), sizeof(int32_t) * rn);
    memcpy(out->labstr + lo, rd.labstr.data(), rd.labstr.size());
    ro += rn;
    lo += (int64_t)rd.labstr.size();
  }
  out->labstr[labstr_len] = '\0';
  out->labstr_len = labstr_len;
  out->comments_len = (int64_t)comments.size();
  out->comments = (char*)malloc(comments.size() + 1);
  memcpy(out->comments, comments.data(), comments.size());
  out->comments[comments.size()] = '\0';
  return 0;
}

int svq_parse_file(const char* path, const char* mask_str, int skip_empty,
                   svq_data* out) {
  svq_init(out);
  FILE* f = fopen(path, "rb");
  if (!f) {
    snprintf(out->error, sizeof(out->error), "cannot open %s", path);
    return 1;
  }
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  char* buf = (char*)malloc(sz + 1);
  size_t rd = fread(buf, 1, sz, f);
  fclose(f);
  buf[rd] = '\0';  // svq_parse_buffer contract: trailing NUL at buf[len]
  int rc = svq_parse_buffer(buf, (int64_t)rd, mask_str, skip_empty, out);
  free(buf);
  return rc;
}

// ---------------------------------------------------------------------
// Writer: format entries back to text (write_entry, datafile.c:420-447).
// labels arrive as a '\0'-separated token stream + per-entry counts, so
// the intern table stays on the Python side.
// Returns a malloc'd buffer (caller frees with svq_free_text).
// ---------------------------------------------------------------------

static void format_rows(const float* points, const uint8_t* mask,
                        const char* labstr_at, const int32_t* labcnt,
                        int64_t lo, int64_t hi, int32_t dim,
                        const char* mask_str, std::string* out) {
  out->reserve((size_t)(hi - lo) * dim * 8);
  char tmp[64];
  const char* lp = labstr_at;
  for (int64_t i = lo; i < hi; ++i) {
    for (int32_t d = 0; d < dim; ++d) {
      if (mask && mask[i * dim + d]) {
        *out += mask_str;
      } else {
        snprintf(tmp, sizeof(tmp), "%g", (double)points[i * dim + d]);
        *out += tmp;
      }
      *out += ' ';
    }
    if (labcnt) {
      for (int32_t k = 0; k < labcnt[i]; ++k) {
        *out += lp;
        *out += ' ';
        lp += strlen(lp) + 1;
      }
    }
    *out += '\n';
  }
}

char* svq_format_entries(const float* points, const uint8_t* mask,
                         const char* labstr, const int32_t* labcnt,
                         int64_t n, int32_t dim, const char* mask_str,
                         int64_t* out_len) {
  // row-slab parallel formatting (same threading policy as the parser;
  // byte-identical output — slabs concatenate in row order).  Each
  // slab's label cursor is pre-advanced past the earlier rows' tokens.
  int nthreads = default_threads();
  if ((int64_t)n * dim < (1 << 20) || nthreads < 2) nthreads = 1;
  std::vector<int64_t> lo(nthreads + 1);
  for (int t = 0; t <= nthreads; ++t) lo[t] = n * t / nthreads;
  std::vector<const char*> lab_at(nthreads, labstr);
  if (labcnt && labstr) {
    const char* lp = labstr;
    int64_t row = 0;
    for (int t = 0; t < nthreads; ++t) {
      for (; row < lo[t]; ++row)
        for (int32_t k = 0; k < labcnt[row]; ++k) lp += strlen(lp) + 1;
      lab_at[t] = lp;
    }
  }
  std::vector<std::string> parts(nthreads);
  if (nthreads == 1) {
    format_rows(points, mask, labstr, labcnt, 0, n, dim, mask_str,
                &parts[0]);
  } else {
    std::vector<std::thread> ths;
    for (int t = 0; t < nthreads; ++t)
      ths.emplace_back(format_rows, points, mask, lab_at[t], labcnt,
                       lo[t], lo[t + 1], dim, mask_str, &parts[t]);
    for (auto& th : ths) th.join();
  }
  size_t total = 0;
  for (auto& p : parts) total += p.size();
  *out_len = (int64_t)total;
  char* ret = (char*)malloc(total + 1);
  size_t off = 0;
  for (auto& p : parts) {
    memcpy(ret + off, p.data(), p.size());
    off += p.size();
  }
  ret[total] = '\0';
  return ret;
}

void svq_free_text(char* p) { free(p); }

}  // extern "C"
