// Path-context enumeration over the AST, token normalization, and the
// output line format (SURVEY.md §3 "JavaExtractor (NATIVE)" + §3.2):
// per method, collect AST leaves, enumerate leaf pairs whose connecting
// path has length <= max_path_length and width <= max_path_width, render
// the path as a node-type sequence with direction markers, hash it with
// Java String.hashCode semantics, normalize leaf tokens (lowercase
// subtokens joined with '|'), and emit one line per method:
//   `name ctx1 ... ctxN`, ctx = `tok,pathHash,tok`.
#pragma once

#include <cstdint>
#include <string>
#include <vector>

#include "ast.h"

namespace c2v {

struct ExtractOptions {
  int max_path_length = 8;   // edges on the up+down path
  int max_path_width = 2;    // child-index gap at the pivot (LCA)
  int max_leaves = 1000;     // guard against O(L^2) blowup on huge methods
  bool hash_paths = true;    // false: emit the readable path string
};

// Java String.hashCode (32-bit wraparound) — the reference hashes path
// strings this way for compactness.
int32_t JavaStringHash(const std::string& s);

// common.py-compatible normalization: split camelCase/underscores/digits,
// strip non-letters (fallback: lowercased original), lowercase, join '|'.
std::string NormalizeToken(const std::string& raw);

// One extracted method: target name + context triples.
struct MethodFeatures {
  std::string name;                       // normalized target label
  std::vector<std::string> contexts;      // "tok,path,tok"
};

// Extract features for every method node in the AST.
std::vector<MethodFeatures> ExtractFeatures(const Ast& ast,
                                            const std::vector<int>& methods,
                                            const ExtractOptions& opts);

// Render a MethodFeatures as one output line.
std::string RenderLine(const MethodFeatures& mf);

}  // namespace c2v
