// Fast TSV parsers (native side of g2vec_tpu_torch.io.readers): the
// expression matrix (the port's copy of g2vec_tpu/native/tsv_reader.cpp,
// with parse errors naming "path:line" as the port's Python reader does)
// and the network edge list.
//
// Expression contract (same as the Python reader, ref: G2Vec.py:478-503):
// first row is "PATIENT\t<sample ids...>", each body row "gene\tfloat...",
// rows may end in \r\n or trailing whitespace, header column count defines
// the sample count. The matrix is gene-major in the file; this parser
// writes straight into a samples x genes float32 buffer (the transpose the
// Python reader does as a second pass, ref: G2Vec.py:498).
//
// Network contract (the Python reader's, ref: G2Vec.py:455-476): the file
// read as text with universal newlines, each line rstrip()ped, lines blank
// after the strip dropped, the first remaining line the header and every
// other one "src\tdest[\t...]". Endpoint names are interned in first-seen
// order (src before dest within a row), so the edge list comes back as two
// int32 id arrays and the names once each. Where a byte-level parse could
// part from Python's text-level one, g2v_net_read parses nothing and
// returns NULL, and the caller hands the file to the Python reader, whose
// answer (or error) is then the answer: a bare \r (a universal-newline
// break), bytes that are not UTF-8 (any byte >= 0x80 unless `utf8`), a
// byte >= 0x80 ending a stripped line (Unicode whitespace that rstrip()
// drops), a row with fewer than two fields, or no header.
//
// C API (ctypes-friendly, no C++ types across the boundary):
//   g2v_expr_read(path, err, errlen) -> opaque handle or NULL (err filled)
//   g2v_expr_nsamples / g2v_expr_ngenes
//   g2v_expr_sample / g2v_expr_gene   (borrowed pointers, valid until free)
//   g2v_expr_copy(handle, out)        (out: samples*genes float32)
//   g2v_expr_free
//   g2v_net_read(path, utf8) -> opaque handle, or NULL: parse in Python
//   g2v_net_nedges / g2v_net_nnames / g2v_net_names_size
//   g2v_net_copy(handle, names, src, dst)
//                                     (names: the names_size bytes of the
//                                     names joined by '\n'; src, dst:
//                                     nedges int32 ids into them)
//   g2v_net_free
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {

struct Expr {
  std::vector<std::string> samples;
  std::vector<std::string> genes;
  std::vector<float> matrix;  // samples x genes (transposed from file)
};

struct Net {
  std::string names;  // first-seen order, joined by '\n'
  int64_t n_names = 0;
  std::vector<int32_t> src, dst;
};

void fail(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) {
    std::snprintf(err, static_cast<size_t>(errlen), "%s", msg.c_str());
  }
}

// The whole file into *buf; false with *why set when it cannot be read.
bool read_file(const char* path, std::string* buf, std::string* why) {
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    *why = std::string(path) + ": " + std::strerror(errno);
    return false;
  }
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (size < 0) {  // unseekable (FIFO, ...) — refuse instead of overflowing
    std::fclose(f);
    *why = std::string(path) + ": not a regular seekable file";
    return false;
  }
  buf->assign(static_cast<size_t>(size), '\0');
  if (size > 0 && std::fread(&(*buf)[0], 1, static_cast<size_t>(size), f) !=
                      static_cast<size_t>(size)) {
    std::fclose(f);
    *why = std::string(path) + ": short read";
    return false;
  }
  std::fclose(f);
  return true;
}

// True when the bytes decode as Python's strict UTF-8 codec decodes them
// (no overlong forms, no surrogates, nothing past U+10FFFF); with `utf8`
// false, only when they are ASCII.
bool decodes(const unsigned char* s, size_t n, bool utf8) {
  size_t i = 0;
  while (i < n) {
    if (n - i >= 8) {  // eight ASCII bytes at a time
      uint64_t w;
      std::memcpy(&w, s + i, 8);
      if (!(w & 0x8080808080808080ULL)) {
        i += 8;
        continue;
      }
    }
    unsigned char c = s[i];
    if (c < 0x80) {
      ++i;
      continue;
    }
    if (!utf8) return false;
    size_t len = 0;
    unsigned char lo = 0x80, hi = 0xBF;  // the second byte's range
    if (c >= 0xC2 && c <= 0xDF) {
      len = 2;
    } else if (c == 0xE0) {
      len = 3, lo = 0xA0;
    } else if ((c >= 0xE1 && c <= 0xEC) || c == 0xEE || c == 0xEF) {
      len = 3;
    } else if (c == 0xED) {
      len = 3, hi = 0x9F;
    } else if (c == 0xF0) {
      len = 4, lo = 0x90;
    } else if (c >= 0xF1 && c <= 0xF3) {
      len = 4;
    } else if (c == 0xF4) {
      len = 4, hi = 0x8F;
    } else {
      return false;
    }
    if (n - i < len || s[i + 1] < lo || s[i + 1] > hi) return false;
    for (size_t k = 2; k < len; ++k) {
      if (s[i + k] < 0x80 || s[i + k] > 0xBF) return false;
    }
    i += len;
  }
  return true;
}

// The ASCII characters str.rstrip() drops, but '\n' and '\r': a line ends
// at '\n' (after a '\r' there, which the caller takes off).
inline bool strip_char(char c) {
  return c == ' ' || c == '\t' || c == '\v' || c == '\f' ||
         (c >= '\x1c' && c <= '\x1f');
}

// Split one line on tabs after stripping trailing whitespace.
void split_fields(const char* begin, const char* end,
                  std::vector<std::pair<const char*, const char*>>* out) {
  while (end > begin &&
         (end[-1] == ' ' || end[-1] == '\t' || end[-1] == '\r')) {
    --end;
  }
  out->clear();
  const char* field = begin;
  for (const char* p = begin; p <= end; ++p) {
    if (p == end || *p == '\t') {
      out->push_back({field, p});
      field = p + 1;
    }
  }
}

}  // namespace

extern "C" {

void* g2v_expr_read(const char* path, char* err, int errlen) try {
  std::string buf, why;
  if (!read_file(path, &buf, &why)) {
    fail(err, errlen, why);
    return nullptr;
  }

  auto expr = std::make_unique<Expr>();
  std::vector<std::pair<const char*, const char*>> fields;
  const char* p = buf.data();
  const char* bufend = buf.data() + buf.size();
  long lineno = 0;
  // First pass: collect gene rows as (name, value-span) so we can size the
  // matrix once; value parsing happens in the second pass, writing
  // transposed.
  std::vector<std::pair<const char*, const char*>> gene_rows;
  std::vector<long> gene_lines;  // each gene row's line number in the file
  while (p < bufend) {
    const char* nl = static_cast<const char*>(
        std::memchr(p, '\n', static_cast<size_t>(bufend - p)));
    const char* line_end = nl ? nl : bufend;
    ++lineno;
    if (lineno == 1) {
      split_fields(p, line_end, &fields);
      if (fields.size() < 2) {
        fail(err, errlen, std::string(path) +
                              ": expression header needs at least one sample");
        return nullptr;
      }
      for (size_t i = 1; i < fields.size(); ++i) {
        expr->samples.emplace_back(fields[i].first,
                                   fields[i].second - fields[i].first);
      }
    } else {
      // Blank-line test AFTER stripping trailing whitespace, so a CRLF
      // file's trailing "\r\n" line is skipped exactly like the Python
      // reader's rstrip() path.
      const char* stripped_end = line_end;
      while (stripped_end > p &&
             (stripped_end[-1] == ' ' || stripped_end[-1] == '\t' ||
              stripped_end[-1] == '\r')) {
        --stripped_end;
      }
      if (stripped_end > p) {
        gene_rows.push_back({p, line_end});
        gene_lines.push_back(lineno);
      }
    }
    p = nl ? nl + 1 : bufend;
  }
  size_t n_samples = expr->samples.size();
  size_t n_genes = gene_rows.size();
  if (n_genes == 0) {
    // Same wording contract as the Python reader: actionable, names the
    // file shape the caller must fix.
    fail(err, errlen, std::string(path) +
                          ": expression file needs a header and at least "
                          "one gene row");
    return nullptr;
  }
  expr->genes.reserve(n_genes);
  expr->matrix.resize(n_samples * n_genes);

  for (size_t j = 0; j < n_genes; ++j) {
    split_fields(gene_rows[j].first, gene_rows[j].second, &fields);
    if (fields.size() != n_samples + 1) {
      // Name the offending gene (Python-reader parity): a truncated row
      // in a million-line TSV is unfindable by row count alone.
      std::string gene(fields.empty() ? "" : fields[0].first,
                       fields.empty()
                           ? 0
                           : static_cast<size_t>(fields[0].second -
                                                 fields[0].first));
      fail(err, errlen,
           std::string(path) + ":" + std::to_string(gene_lines[j]) +
               ": gene '" + gene + "' has " +
               std::to_string(fields.empty() ? 0 : fields.size() - 1) +
               " values, expected " + std::to_string(n_samples) +
               " (one per sample in the header)");
      return nullptr;
    }
    expr->genes.emplace_back(fields[0].first,
                             fields[0].second - fields[0].first);
    for (size_t i = 1; i <= n_samples; ++i) {
      // Parsing in place is safe: std::string guarantees buf is
      // NUL-terminated, and strtof stops at the field's '\t'/'\n'/'\r'
      // delimiter (none of which can appear inside a float).
      char* parse_end = nullptr;
      float v = std::strtof(fields[i].first, &parse_end);
      if (parse_end != fields[i].second) {  // empty, garbage, or trailing junk
        fail(err, errlen,
             std::string(path) + ":" + std::to_string(gene_lines[j]) +
                 ": non-numeric expression value in column " +
                 std::to_string(i + 1));
        return nullptr;
      }
      expr->matrix[(i - 1) * n_genes + j] = v;  // transposed write
    }
  }
  return expr.release();
} catch (const std::exception& e) {
  // Never let a C++ exception cross the C ABI into ctypes (it aborts the
  // whole Python process). bad_alloc on oversized files lands here too.
  fail(err, errlen, std::string(path) + ": " + e.what());
  return nullptr;
} catch (...) {
  fail(err, errlen, std::string(path) + ": unknown native parser error");
  return nullptr;
}

int g2v_expr_nsamples(void* h) {
  return static_cast<int>(static_cast<Expr*>(h)->samples.size());
}

int g2v_expr_ngenes(void* h) {
  return static_cast<int>(static_cast<Expr*>(h)->genes.size());
}

const char* g2v_expr_sample(void* h, int i) {
  return static_cast<Expr*>(h)->samples[static_cast<size_t>(i)].c_str();
}

const char* g2v_expr_gene(void* h, int j) {
  return static_cast<Expr*>(h)->genes[static_cast<size_t>(j)].c_str();
}

void g2v_expr_copy(void* h, float* out) {
  Expr* e = static_cast<Expr*>(h);
  std::memcpy(out, e->matrix.data(), e->matrix.size() * sizeof(float));
}

void g2v_expr_free(void* h) { delete static_cast<Expr*>(h); }

void* g2v_net_read(const char* path, int utf8) try {
  std::string buf, why;
  if (!read_file(path, &buf, &why)) return nullptr;
  const char* p = buf.data();
  const char* bufend = p + buf.size();
  if (!decodes(reinterpret_cast<const unsigned char*>(p), buf.size(),
               utf8 != 0)) {
    return nullptr;
  }
  for (const char* r = static_cast<const char*>(
           std::memchr(p, '\r', buf.size()));
       r; r = static_cast<const char*>(std::memchr(
              r + 1, '\r', static_cast<size_t>(bufend - r - 1)))) {
    if (r + 1 == bufend || r[1] != '\n') return nullptr;  // a bare \r
  }

  auto net = std::make_unique<Net>();
  std::unordered_map<std::string_view, int32_t> ids;
  ids.reserve(1 << 16);
  auto intern = [&](const char* b, const char* e) {
    auto [it, fresh] = ids.try_emplace(
        std::string_view(b, static_cast<size_t>(e - b)),
        static_cast<int32_t>(ids.size()));
    if (fresh) {
      if (it->second > 0) net->names.push_back('\n');
      net->names.append(b, static_cast<size_t>(e - b));
    }
    return it->second;
  };
  net->src.reserve(buf.size() / 16);
  net->dst.reserve(buf.size() / 16);
  bool header = false;
  while (p < bufend) {
    const char* nl = static_cast<const char*>(
        std::memchr(p, '\n', static_cast<size_t>(bufend - p)));
    const char* end = nl ? nl : bufend;
    if (end > p && end[-1] == '\r') --end;  // CRLF (bare \r refused above)
    while (end > p && strip_char(end[-1])) --end;
    const char* line = p;
    p = nl ? nl + 1 : bufend;
    if (end > line && static_cast<unsigned char>(end[-1]) >= 0x80) {
      return nullptr;  // may be whitespace that rstrip() drops
    }
    if (end == line) continue;  // blank after the strip
    if (!header) {
      header = true;
      continue;
    }
    const char* tab = static_cast<const char*>(
        std::memchr(line, '\t', static_cast<size_t>(end - line)));
    if (!tab) return nullptr;  // one field: the Python reader's error
    const char* dest = tab + 1;
    const char* dest_end = static_cast<const char*>(
        std::memchr(dest, '\t', static_cast<size_t>(end - dest)));
    if (ids.size() + 2 > static_cast<size_t>(INT32_MAX)) return nullptr;
    net->src.push_back(intern(line, tab));
    net->dst.push_back(intern(dest, dest_end ? dest_end : end));
  }
  if (!header) return nullptr;  // the Python reader's error
  net->n_names = static_cast<int64_t>(ids.size());
  return net.release();
} catch (...) {
  // Never let a C++ exception cross the C ABI into ctypes; the Python
  // reader reads the file instead.
  return nullptr;
}

int64_t g2v_net_nedges(void* h) {
  return static_cast<int64_t>(static_cast<Net*>(h)->src.size());
}

int64_t g2v_net_nnames(void* h) { return static_cast<Net*>(h)->n_names; }

int64_t g2v_net_names_size(void* h) {
  return static_cast<int64_t>(static_cast<Net*>(h)->names.size());
}

void g2v_net_copy(void* h, char* names, int32_t* src, int32_t* dst) {
  Net* n = static_cast<Net*>(h);
  if (!n->names.empty()) {
    std::memcpy(names, n->names.data(), n->names.size());
  }
  if (!n->src.empty()) {
    std::memcpy(src, n->src.data(), n->src.size() * sizeof(int32_t));
    std::memcpy(dst, n->dst.data(), n->dst.size() * sizeof(int32_t));
  }
}

void g2v_net_free(void* h) { delete static_cast<Net*>(h); }

}  // extern "C"
