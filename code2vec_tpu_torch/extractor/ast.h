// Arena AST for the native path-context extractor.
//
// Node type names follow JavaParser's class names (MethodDeclaration,
// BlockStmt, NameExpr, ...) so rendered paths look like the reference
// JavaExtractor's (SURVEY.md §3: path rendered as node-type sequence with
// direction markers). Binary/unary/assign nodes carry their operator in
// the type string (e.g. "BinaryExpr:plus") as JavaParser-based extractors
// do.
#pragma once

#include <string>
#include <vector>

namespace c2v {

struct Node {
  std::string type;    // JavaParser-style node type name
  std::string leaf;    // raw token text; non-empty iff this is a leaf
  int parent = -1;
  int child_index = 0;     // position among parent's children
  std::vector<int> children;
};

class Ast {
 public:
  int Add(std::string type, int parent, std::string leaf = "") {
    int id = static_cast<int>(nodes_.size());
    nodes_.push_back(Node{std::move(type), std::move(leaf), parent, 0, {}});
    if (parent >= 0) {
      nodes_[parent].children.push_back(id);
      nodes_[id].child_index =
          static_cast<int>(nodes_[parent].children.size()) - 1;
    }
    return id;
  }

  Node& at(int id) { return nodes_[id]; }
  const Node& at(int id) const { return nodes_[id]; }
  int size() const { return static_cast<int>(nodes_.size()); }

  // Re-parent `child` under `new_parent` (used when wrapping an already
  // parsed subtree, e.g. binary expressions built bottom-up).
  void Reparent(int child, int new_parent) {
    nodes_[child].parent = new_parent;
    nodes_[new_parent].children.push_back(child);
    nodes_[child].child_index =
        static_cast<int>(nodes_[new_parent].children.size()) - 1;
  }

 private:
  std::vector<Node> nodes_;
};

}  // namespace c2v
