// C API for in-process extraction via ctypes (no subprocess overhead in
// the data pipeline). See code2vec_tpu/extractor/native.py.

#include <cstdlib>
#include <cstring>
#include <string>

#include "parser.h"
#include "paths.h"

extern "C" {

// Extract path-contexts from Java source text. Returns a malloc'd
// NUL-terminated buffer of newline-separated method lines (caller frees
// with c2v_free), or nullptr on failure.
char* c2v_extract_source(const char* source, int max_path_length,
                         int max_path_width, int max_leaves) {
  if (!source) return nullptr;
  c2v::ExtractOptions opts;
  opts.max_path_length = max_path_length;
  opts.max_path_width = max_path_width;
  if (max_leaves > 0) opts.max_leaves = max_leaves;
  c2v::ParseResult pr = c2v::ParseJava(source);
  auto features = c2v::ExtractFeatures(pr.ast, pr.method_nodes, opts);
  std::string out;
  for (const auto& mf : features) {
    out += c2v::RenderLine(mf);
    out.push_back('\n');
  }
  char* buf = static_cast<char*>(std::malloc(out.size() + 1));
  if (!buf) return nullptr;
  std::memcpy(buf, out.data(), out.size());
  buf[out.size()] = '\0';
  return buf;
}

void c2v_free(char* p) { std::free(p); }

// Java String.hashCode, exposed so Python-side tests can cross-check.
int c2v_java_string_hash(const char* s) {
  return c2v::JavaStringHash(s ? s : "");
}

}  // extern "C"
