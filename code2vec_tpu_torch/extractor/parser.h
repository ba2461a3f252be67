// Recursive-descent parser for a practical Java subset -> JavaParser-like
// AST. Replaces the reference's JavaParser dependency (SURVEY.md §3.1:
// no JVM in this environment; §8.4 item 1: "a restricted Java grammar
// must still hit high method coverage"). Malformed constructs recover at
// brace/semicolon boundaries; methods that fail to parse are dropped and
// counted, never fatal.
#pragma once

#include <string>
#include <vector>

#include "ast.h"
#include "lexer.h"

namespace c2v {

struct ParseResult {
  Ast ast;
  std::vector<int> method_nodes;  // ids of MethodDeclaration nodes
  int dropped_methods = 0;
};

// Parse one compilation unit (never throws; best-effort recovery).
ParseResult ParseJava(const std::string& source);

}  // namespace c2v
