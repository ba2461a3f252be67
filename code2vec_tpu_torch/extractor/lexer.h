// Java lexer for the native path-context extractor.
//
// Replaces the reference's JVM JavaExtractor front half (SURVEY.md §3
// "JavaExtractor (NATIVE)": JavaParser-based lexing/parsing). No JVM
// exists in this environment, so tokenization is implemented from
// scratch: identifiers, keywords, int/float/char/string literals
// (including text blocks), operators, comments, annotations.
#pragma once

#include <cstdint>
#include <string>
#include <vector>

namespace c2v {

enum class TokKind : uint8_t {
  Identifier,
  Keyword,
  IntLiteral,
  FloatLiteral,
  CharLiteral,
  StringLiteral,
  Operator,   // punctuation + operators, spelled in `text`
  End,
};

struct Token {
  TokKind kind;
  std::string text;
  int line;
};

// Tokenize Java source. Comments and annotations-bodies are skipped;
// malformed input produces best-effort tokens (never throws).
std::vector<Token> Lex(const std::string& src);

bool IsJavaKeyword(const std::string& s);

}  // namespace c2v
