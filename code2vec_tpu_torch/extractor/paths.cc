#include "paths.h"

#include <cctype>
#include <unordered_set>

namespace c2v {

int32_t JavaStringHash(const std::string& s) {
  int32_t h = 0;
  for (unsigned char c : s)
    h = static_cast<int32_t>(static_cast<uint32_t>(h) * 31u + c);
  return h;
}

namespace {

inline bool IsUpper(char c) { return c >= 'A' && c <= 'Z'; }
inline bool IsLower(char c) { return c >= 'a' && c <= 'z'; }
inline bool IsDigit(char c) { return c >= '0' && c <= '9'; }

// Mirror common.split_to_subtokens: split on _, digits, whitespace,
// lower->Upper boundaries and Upper-Upper-lower boundaries; each piece is
// normalized (strip non-letters; fallback lowercase original) and empty
// pieces dropped.
std::vector<std::string> SplitSubtokens(const std::string& word) {
  std::vector<std::string> pieces;
  std::string cur;
  auto flush = [&]() {
    if (!cur.empty()) {
      pieces.push_back(cur);
      cur.clear();
    }
  };
  size_t n = word.size();
  for (size_t i = 0; i < n; ++i) {
    char c = word[i];
    if (c == '_' || IsDigit(c) ||
        std::isspace(static_cast<unsigned char>(c))) {
      flush();
      continue;
    }
    if (i > 0) {
      char p = word[i - 1];
      if ((IsLower(p) && IsUpper(c)) ||
          (IsUpper(p) && IsUpper(c) && i + 1 < n && IsLower(word[i + 1]))) {
        flush();
      }
    }
    cur.push_back(c);
  }
  flush();
  // normalize each piece
  std::vector<std::string> out;
  for (auto& p : pieces) {
    std::string stripped;
    for (char c : p)
      if (std::isalpha(static_cast<unsigned char>(c)))
        stripped.push_back(
            static_cast<char>(std::tolower(static_cast<unsigned char>(c))));
    if (stripped.empty()) {
      for (char c : p)
        stripped.push_back(
            static_cast<char>(std::tolower(static_cast<unsigned char>(c))));
    }
    if (!stripped.empty()) out.push_back(stripped);
  }
  return out;
}

std::string JoinPipe(const std::vector<std::string>& parts) {
  std::string out;
  for (size_t i = 0; i < parts.size(); ++i) {
    if (i) out.push_back('|');
    out += parts[i];
  }
  return out;
}

// Leaf token text -> the normalized token emitted in contexts. Literals
// get value-preserving treatment: numbers stay numeric, strings are
// subtokenized content (or a placeholder when empty/non-alpha).
std::string LeafToken(const Node& node) {
  const std::string& t = node.type;
  const std::string& raw = node.leaf;
  if (t == "IntegerLiteralExpr" || t == "LongLiteralExpr" ||
      t == "DoubleLiteralExpr") {
    std::string digits;
    for (char c : raw)
      if (!std::isspace(static_cast<unsigned char>(c)) && c != '_' &&
          c != 'l' && c != 'L' && c != 'f' && c != 'F' && c != 'd' &&
          c != 'D')
        digits.push_back(
            static_cast<char>(std::tolower(static_cast<unsigned char>(c))));
    return digits.empty() ? "0" : digits;
  }
  if (t == "StringLiteralExpr") {
    if (raw.size() > 2) {
      std::string inner = raw.substr(1, raw.size() - 2);
      std::string norm = JoinPipe(SplitSubtokens(inner));
      if (!norm.empty()) return norm;
    }
    return "STR";
  }
  if (t == "CharLiteralExpr") {
    if (raw.size() > 2) {
      std::string inner = raw.substr(1, raw.size() - 2);
      std::string norm = JoinPipe(SplitSubtokens(inner));
      if (!norm.empty()) return norm;
    }
    return "CHR";
  }
  std::string norm = JoinPipe(SplitSubtokens(raw));
  return norm.empty() ? "TOKEN" : norm;
}

}  // namespace

std::string NormalizeToken(const std::string& raw) {
  std::string norm = JoinPipe(SplitSubtokens(raw));
  if (!norm.empty()) return norm;
  std::string lower;
  for (char c : raw)
    lower.push_back(
        static_cast<char>(std::tolower(static_cast<unsigned char>(c))));
  return lower;
}

namespace {

// Collect leaf node ids of a method subtree in DFS (source) order. The
// method's own SimpleName leaf (first SimpleName child of the method
// node) is replaced by the special METHOD_NAME token to prevent label
// leakage, matching the reference extractor.
void CollectLeaves(const Ast& ast, int node, int method_node,
                   std::vector<int>* leaves, std::vector<int>* depths,
                   int depth, int max_leaves) {
  if (static_cast<int>(leaves->size()) >= max_leaves) return;
  const Node& n = ast.at(node);
  if (n.children.empty() && !n.leaf.empty()) {
    leaves->push_back(node);
    depths->push_back(depth);
    return;
  }
  for (int c : n.children)
    CollectLeaves(ast, c, method_node, leaves, depths, depth + 1,
                  max_leaves);
}

}  // namespace

std::vector<MethodFeatures> ExtractFeatures(const Ast& ast,
                                            const std::vector<int>& methods,
                                            const ExtractOptions& opts) {
  std::vector<MethodFeatures> out;
  for (int m : methods) {
    const Node& mnode = ast.at(m);
    // the declaration's name leaf = first SimpleName child of the method
    int name_leaf = -1;
    for (int c : mnode.children) {
      if (ast.at(c).type == "SimpleName") { name_leaf = c; break; }
    }
    if (name_leaf < 0) continue;
    MethodFeatures mf;
    mf.name = NormalizeToken(ast.at(name_leaf).leaf);
    if (mf.name.empty()) continue;

    std::vector<int> leaves, depths;
    CollectLeaves(ast, m, m, &leaves, &depths, 0, opts.max_leaves);

    size_t L = leaves.size();
    // precompute ancestors-to-method for each leaf (paths are short; the
    // length filter prunes most pairs before LCA walk completes)
    for (size_t i = 0; i < L; ++i) {
      for (size_t j = i + 1; j < L; ++j) {
        int a = leaves[i], b = leaves[j];
        if (a == name_leaf && b == name_leaf) continue;
        // climb to equal depth, then together to the LCA
        int da = depths[i], db = depths[j];
        int ua = a, ub = b;
        int up_a = 0, up_b = 0;
        while (da > db) { ua = ast.at(ua).parent; --da; ++up_a; }
        while (db > da) { ub = ast.at(ub).parent; --db; ++up_b; }
        while (ua != ub && ua >= 0 && ub >= 0) {
          ua = ast.at(ua).parent;
          ub = ast.at(ub).parent;
          ++up_a;
          ++up_b;
        }
        if (ua < 0 || ua != ub) continue;
        int path_len = up_a + up_b;
        if (path_len > opts.max_path_length) continue;
        // width: child-index gap of the two arms at the LCA
        int ca = a, cb = b;
        for (int k = 0; k < up_a - 1; ++k) ca = ast.at(ca).parent;
        for (int k = 0; k < up_b - 1; ++k) cb = ast.at(cb).parent;
        int width = (up_a == 0) ? 0
                    : (up_b == 0) ? 0
                    : ast.at(cb).child_index - ast.at(ca).child_index;
        if (width < 0) width = -width;
        if (width > opts.max_path_width) continue;

        // render path: typeA ^ ... ^ LCA _ ... _ typeB
        std::string path;
        int cur = a;
        for (int k = 0; k < up_a; ++k) {
          path += ast.at(cur).type;
          path.push_back('^');
          cur = ast.at(cur).parent;
        }
        path += ast.at(cur).type;  // LCA
        // downward arm, collected bottom-up then appended in reverse
        std::vector<const std::string*> down;
        cur = b;
        for (int k = 0; k < up_b; ++k) {
          down.push_back(&ast.at(cur).type);
          cur = ast.at(cur).parent;
        }
        for (auto it = down.rbegin(); it != down.rend(); ++it) {
          path.push_back('_');
          path += **it;
        }

        std::string tok_a = (a == name_leaf) ? "METHOD_NAME"
                                             : LeafToken(ast.at(a));
        std::string tok_b = (b == name_leaf) ? "METHOD_NAME"
                                             : LeafToken(ast.at(b));
        std::string path_repr =
            opts.hash_paths ? std::to_string(JavaStringHash(path)) : path;
        mf.contexts.push_back(tok_a + "," + path_repr + "," + tok_b);
      }
    }
    if (!mf.contexts.empty()) out.push_back(std::move(mf));
  }
  return out;
}

std::string RenderLine(const MethodFeatures& mf) {
  std::string line = mf.name;
  for (const auto& c : mf.contexts) {
    line.push_back(' ');
    line += c;
  }
  return line;
}

}  // namespace c2v
