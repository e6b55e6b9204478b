// Fast expression-TSV parser (native side of g2vec_tpu_torch.io.readers;
// the port's copy of g2vec_tpu/native/tsv_reader.cpp, with parse errors
// naming "path:line" as the port's Python reader does).
//
// File contract (same as the Python reader, ref: G2Vec.py:478-503): first
// row is "PATIENT\t<sample ids...>", each body row "gene\tfloat...", rows
// may end in \r\n or trailing whitespace, header column count defines the
// sample count. The matrix is gene-major in the file; this parser writes
// straight into a samples x genes float32 buffer (the transpose the Python
// reader does as a second pass, ref: G2Vec.py:498).
//
// C API (ctypes-friendly, no C++ types across the boundary):
//   g2v_expr_read(path, err, errlen) -> opaque handle or NULL (err filled)
//   g2v_expr_nsamples / g2v_expr_ngenes
//   g2v_expr_sample / g2v_expr_gene   (borrowed pointers, valid until free)
//   g2v_expr_copy(handle, out)        (out: samples*genes float32)
//   g2v_expr_free
#include <cerrno>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <string>
#include <vector>

namespace {

struct Expr {
  std::vector<std::string> samples;
  std::vector<std::string> genes;
  std::vector<float> matrix;  // samples x genes (transposed from file)
};

void fail(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) {
    std::snprintf(err, static_cast<size_t>(errlen), "%s", msg.c_str());
  }
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
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    fail(err, errlen, std::string(path) + ": " + std::strerror(errno));
    return nullptr;
  }
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (size < 0) {  // unseekable (FIFO, ...) — refuse instead of overflowing
    std::fclose(f);
    fail(err, errlen, std::string(path) + ": not a regular seekable file");
    return nullptr;
  }
  std::string buf(static_cast<size_t>(size), '\0');
  if (size > 0 && std::fread(&buf[0], 1, static_cast<size_t>(size), f) !=
                      static_cast<size_t>(size)) {
    std::fclose(f);
    fail(err, errlen, std::string(path) + ": short read");
    return nullptr;
  }
  std::fclose(f);

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

}  // extern "C"
