#include "lexer.h"

#include <cctype>
#include <unordered_set>

namespace c2v {

bool IsJavaKeyword(const std::string& s) {
  static const std::unordered_set<std::string> kKeywords = {
      "abstract", "assert", "boolean", "break", "byte", "case", "catch",
      "char", "class", "const", "continue", "default", "do", "double",
      "else", "enum", "extends", "final", "finally", "float", "for",
      "goto", "if", "implements", "import", "instanceof", "int",
      "interface", "long", "native", "new", "package", "private",
      "protected", "public", "return", "short", "static", "strictfp",
      "super", "switch", "synchronized", "this", "throw", "throws",
      "transient", "try", "void", "volatile", "while", "record",
      "var", "true", "false", "null"};
  return kKeywords.count(s) > 0;
}

namespace {

inline bool IsIdentStart(char c) {
  return std::isalpha(static_cast<unsigned char>(c)) || c == '_' ||
         c == '$' || static_cast<unsigned char>(c) >= 0x80;
}
inline bool IsIdentPart(char c) {
  return IsIdentStart(c) || std::isdigit(static_cast<unsigned char>(c));
}

}  // namespace

std::vector<Token> Lex(const std::string& src) {
  std::vector<Token> out;
  size_t i = 0, n = src.size();
  int line = 1;
  auto push = [&](TokKind k, std::string text) {
    out.push_back(Token{k, std::move(text), line});
  };
  while (i < n) {
    char c = src[i];
    if (c == '\n') { ++line; ++i; continue; }
    if (std::isspace(static_cast<unsigned char>(c))) { ++i; continue; }
    // comments
    if (c == '/' && i + 1 < n && src[i + 1] == '/') {
      while (i < n && src[i] != '\n') ++i;
      continue;
    }
    if (c == '/' && i + 1 < n && src[i + 1] == '*') {
      i += 2;
      while (i + 1 < n && !(src[i] == '*' && src[i + 1] == '/')) {
        if (src[i] == '\n') ++line;
        ++i;
      }
      i = (i + 1 < n) ? i + 2 : n;
      continue;
    }
    // identifiers / keywords
    if (IsIdentStart(c)) {
      size_t j = i + 1;
      while (j < n && IsIdentPart(src[j])) ++j;
      std::string word = src.substr(i, j - i);
      // evaluate the kind BEFORE std::move empties `word` (argument
      // evaluation order is unspecified)
      TokKind kind = IsJavaKeyword(word) ? TokKind::Keyword
                                         : TokKind::Identifier;
      push(kind, std::move(word));
      i = j;
      continue;
    }
    // numeric literals
    if (std::isdigit(static_cast<unsigned char>(c)) ||
        (c == '.' && i + 1 < n &&
         std::isdigit(static_cast<unsigned char>(src[i + 1])))) {
      size_t j = i;
      bool is_float = false;
      if (src[j] == '0' && j + 1 < n &&
          (src[j + 1] == 'x' || src[j + 1] == 'X' || src[j + 1] == 'b' ||
           src[j + 1] == 'B')) {
        j += 2;
        while (j < n && (std::isalnum(static_cast<unsigned char>(src[j])) ||
                         src[j] == '_'))
          ++j;
      } else {
        while (j < n && (std::isdigit(static_cast<unsigned char>(src[j])) ||
                         src[j] == '_'))
          ++j;
        if (j < n && src[j] == '.') {
          is_float = true;
          ++j;
          while (j < n &&
                 (std::isdigit(static_cast<unsigned char>(src[j])) ||
                  src[j] == '_'))
            ++j;
        }
        if (j < n && (src[j] == 'e' || src[j] == 'E')) {
          is_float = true;
          ++j;
          if (j < n && (src[j] == '+' || src[j] == '-')) ++j;
          while (j < n && std::isdigit(static_cast<unsigned char>(src[j])))
            ++j;
        }
        if (j < n && (src[j] == 'f' || src[j] == 'F' || src[j] == 'd' ||
                      src[j] == 'D')) {
          is_float = true;
          ++j;
        } else if (j < n && (src[j] == 'l' || src[j] == 'L')) {
          ++j;
        }
      }
      push(is_float ? TokKind::FloatLiteral : TokKind::IntLiteral,
           src.substr(i, j - i));
      i = j;
      continue;
    }
    // char literal
    if (c == '\'') {
      size_t j = i + 1;
      while (j < n && src[j] != '\'') {
        if (src[j] == '\\') ++j;
        ++j;
      }
      j = (j < n) ? j + 1 : n;
      push(TokKind::CharLiteral, src.substr(i, j - i));
      i = j;
      continue;
    }
    // string literal (incl. """text blocks""")
    if (c == '"') {
      if (i + 2 < n && src[i + 1] == '"' && src[i + 2] == '"') {
        size_t j = i + 3;
        while (j + 2 < n &&
               !(src[j] == '"' && src[j + 1] == '"' && src[j + 2] == '"')) {
          if (src[j] == '\n') ++line;
          ++j;
        }
        j = (j + 2 < n) ? j + 3 : n;
        push(TokKind::StringLiteral, "\"<textblock>\"");
        i = j;
        continue;
      }
      size_t j = i + 1;
      while (j < n && src[j] != '"' && src[j] != '\n') {
        if (src[j] == '\\') ++j;
        ++j;
      }
      j = (j < n && src[j] == '"') ? j + 1 : j;
      push(TokKind::StringLiteral, src.substr(i, j - i));
      i = j;
      continue;
    }
    // annotations: skip `@Name` and a balanced `(...)` argument list.
    // (JavaParser models annotations as AST nodes; the reference's
    // extractor does not emit leaves from them, so dropping them at lex
    // time keeps the tree equivalent for path purposes.)
    if (c == '@') {
      size_t j = i + 1;
      if (j < n && IsIdentStart(src[j])) {
        while (j < n && (IsIdentPart(src[j]) || src[j] == '.')) ++j;
        // "@interface" is a declaration keyword, not an annotation use
        if (src.substr(i + 1, j - i - 1) == "interface") {
          push(TokKind::Keyword, "@interface");
          i = j;
          continue;
        }
        while (j < n && std::isspace(static_cast<unsigned char>(src[j])))
          ++j;
        if (j < n && src[j] == '(') {
          int depth = 0;
          do {
            if (src[j] == '(') ++depth;
            else if (src[j] == ')') --depth;
            else if (src[j] == '\n') ++line;
            ++j;
          } while (j < n && depth > 0);
        }
        i = j;
        continue;
      }
      ++i;
      continue;
    }
    // multi-char operators, longest-match
    static const char* kOps3[] = {">>>=", nullptr};
    static const char* kOps3b[] = {"<<=", ">>=", ">>>", "...", nullptr};
    static const char* kOps2[] = {"==", "!=", "<=", ">=", "&&", "||",
                                  "++", "--", "+=", "-=", "*=", "/=",
                                  "%=", "&=", "|=", "^=", "<<", ">>",
                                  "->", "::", nullptr};
    bool matched = false;
    for (const char** p = kOps3; *p && !matched; ++p)
      if (src.compare(i, 4, *p) == 0) {
        push(TokKind::Operator, *p); i += 4; matched = true;
      }
    for (const char** p = kOps3b; *p && !matched; ++p)
      if (src.compare(i, 3, *p) == 0) {
        push(TokKind::Operator, *p); i += 3; matched = true;
      }
    for (const char** p = kOps2; *p && !matched; ++p)
      if (src.compare(i, 2, *p) == 0) {
        push(TokKind::Operator, *p); i += 2; matched = true;
      }
    if (matched) continue;
    push(TokKind::Operator, std::string(1, c));
    ++i;
  }
  push(TokKind::End, "");
  return out;
}

}  // namespace c2v
