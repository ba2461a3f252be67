#include "parser.h"

#include <functional>

namespace c2v {
namespace {

// JavaParser BinaryExpr.Operator names, keyed by operator spelling.
const char* BinOpName(const std::string& op) {
  if (op == "||") return "OR";
  if (op == "&&") return "AND";
  if (op == "|") return "BINARY_OR";
  if (op == "^") return "XOR";
  if (op == "&") return "BINARY_AND";
  if (op == "==") return "EQUALS";
  if (op == "!=") return "NOT_EQUALS";
  if (op == "<") return "LESS";
  if (op == ">") return "GREATER";
  if (op == "<=") return "LESS_EQUALS";
  if (op == ">=") return "GREATER_EQUALS";
  if (op == "<<") return "LEFT_SHIFT";
  if (op == ">>") return "SIGNED_RIGHT_SHIFT";
  if (op == ">>>") return "UNSIGNED_RIGHT_SHIFT";
  if (op == "+") return "PLUS";
  if (op == "-") return "MINUS";
  if (op == "*") return "MULTIPLY";
  if (op == "/") return "DIVIDE";
  if (op == "%") return "REMAINDER";
  return "UNKNOWN";
}

const char* AssignOpName(const std::string& op) {
  if (op == "=") return "ASSIGN";
  if (op == "+=") return "PLUS";
  if (op == "-=") return "MINUS";
  if (op == "*=") return "MULTIPLY";
  if (op == "/=") return "DIVIDE";
  if (op == "%=") return "REMAINDER";
  if (op == "&=") return "BINARY_AND";
  if (op == "|=") return "BINARY_OR";
  if (op == "^=") return "XOR";
  if (op == "<<=") return "LEFT_SHIFT";
  if (op == ">>=") return "SIGNED_RIGHT_SHIFT";
  if (op == ">>>=") return "UNSIGNED_RIGHT_SHIFT";
  return "ASSIGN";
}

class Parser {
 public:
  explicit Parser(std::vector<Token> toks) : toks_(std::move(toks)) {}

  ParseResult Run() {
    ParseCompilationUnit();
    result_.ast = std::move(ast_);
    return std::move(result_);
  }

 private:
  std::vector<Token> toks_;
  size_t pos_ = 0;
  Ast ast_;
  ParseResult result_;
  int depth_ = 0;

  struct DepthGuard {
    Parser* p;
    bool ok;
    explicit DepthGuard(Parser* p_) : p(p_), ok(++p_->depth_ < 220) {}
    ~DepthGuard() { --p->depth_; }
  };

  // ---- token helpers ----
  const Token& Cur() const { return toks_[pos_]; }
  const Token& Peek(size_t k = 1) const {
    size_t i = pos_ + k;
    return i < toks_.size() ? toks_[i] : toks_.back();
  }
  bool AtEnd() const { return Cur().kind == TokKind::End; }
  void Advance() { if (!AtEnd()) ++pos_; }
  bool Is(TokKind k, const char* text = nullptr) const {
    return Cur().kind == k && (!text || Cur().text == text);
  }
  bool IsOp(const char* text) const { return Is(TokKind::Operator, text); }
  bool IsKw(const char* text) const { return Is(TokKind::Keyword, text); }
  bool Eat(TokKind k, const char* text = nullptr) {
    if (Is(k, text)) { Advance(); return true; }
    return false;
  }
  bool EatOp(const char* text) { return Eat(TokKind::Operator, text); }
  bool EatKw(const char* text) { return Eat(TokKind::Keyword, text); }

  // Skip a balanced region starting at the current open token.
  void SkipBalanced(const char* open, const char* close) {
    int depth = 0;
    while (!AtEnd()) {
      if (IsOp(open)) ++depth;
      else if (IsOp(close)) {
        --depth;
        if (depth <= 0) { Advance(); return; }
      }
      Advance();
    }
  }

  void SkipToStatementSync() {
    int brace = 0;
    while (!AtEnd()) {
      if (IsOp(";") && brace == 0) { Advance(); return; }
      if (IsOp("{")) ++brace;
      if (IsOp("}")) {
        if (brace == 0) return;  // let the caller consume it
        --brace;
      }
      Advance();
    }
  }

  // ---- modifiers / annotations (dropped from the tree) ----
  void SkipModifiers() {
    static const char* kMods[] = {
        "public", "private", "protected", "static", "final", "abstract",
        "native", "synchronized", "transient", "volatile", "strictfp",
        "default", nullptr};
    for (;;) {
      bool any = false;
      for (const char** m = kMods; *m; ++m)
        if (IsKw(*m)) { Advance(); any = true; break; }
      if (!any) return;
    }
  }

  // ---- types ----
  bool LooksLikePrimitive() const {
    static const char* kPrims[] = {"int", "long", "short", "byte", "char",
                                   "boolean", "float", "double", nullptr};
    for (const char** p = kPrims; *p; ++p)
      if (IsKw(*p)) return true;
    return false;
  }

  // Try to skip a generic argument list `<...>` at the current position;
  // returns false (position restored) if it does not look like one.
  bool TrySkipTypeArgs() {
    if (!IsOp("<")) return false;
    size_t save = pos_;
    int depth = 0;
    int fuel = 400;
    while (!AtEnd() && fuel-- > 0) {
      if (IsOp("<")) ++depth;
      else if (IsOp(">")) { --depth; if (depth == 0) { Advance(); return true; } }
      else if (IsOp(">>")) { depth -= 2; if (depth <= 0) { Advance(); return true; } }
      else if (IsOp(">>>")) { depth -= 3; if (depth <= 0) { Advance(); return true; } }
      else if (Cur().kind != TokKind::Identifier && !IsOp(",") &&
               !IsOp("?") && !IsKw("extends") && !IsKw("super") &&
               !IsOp(".") && !IsOp("[") && !IsOp("]") &&
               !LooksLikePrimitive() && !IsOp("&")) {
        break;  // not a type-arg list (e.g. a comparison)
      }
      Advance();
    }
    pos_ = save;
    return false;
  }

  // Parse a type into the tree under `parent`. Returns node id or -1.
  int ParseType(int parent) {
    if (IsKw("void")) {
      int id = ast_.Add("VoidType", parent, Cur().text);
      Advance();
      return id;
    }
    if (LooksLikePrimitive()) {
      int id = ast_.Add("PrimitiveType", parent, Cur().text);
      Advance();
      while (IsOp("[") && Peek().text == "]") {
        Advance(); Advance();
        id = WrapArray(id, parent);
      }
      return id;
    }
    if (Cur().kind != TokKind::Identifier && !IsKw("var")) return -1;
    // qualified name a.b.C — leaf keeps the LAST segment (JavaParser's
    // ClassOrInterfaceType name)
    std::string last = Cur().text;
    Advance();
    TrySkipTypeArgs();
    while (IsOp(".") && Peek().kind == TokKind::Identifier) {
      Advance();
      last = Cur().text;
      Advance();
      TrySkipTypeArgs();
    }
    int id = ast_.Add("ClassOrInterfaceType", parent, last);
    while (IsOp("[") && Peek().text == "]") {
      Advance(); Advance();
      id = WrapArray(id, parent);
    }
    // varargs handled by caller
    return id;
  }

  int WrapArray(int component, int parent) {
    // Rebuild as ArrayType{component}; component was last child of parent.
    int arr = ast_.Add("ArrayType", parent);
    // move component under arr
    auto& pch = ast_.at(parent).children;
    for (size_t k = 0; k < pch.size(); ++k) {
      if (pch[k] == component) { pch.erase(pch.begin() + k); break; }
    }
    // fix child_index bookkeeping of remaining children
    for (size_t k = 0; k < pch.size(); ++k) ast_.at(pch[k]).child_index =
        static_cast<int>(k);
    ast_.at(arr).child_index = static_cast<int>(pch.size()) - 1;
    ast_.Reparent(component, arr);
    return arr;
  }

  // Heuristic: does a statement starting here look like a local variable
  // declaration?
  bool LooksLikeLocalVarDecl() {
    if (IsKw("final")) return true;
    if (IsKw("var") && Peek().kind == TokKind::Identifier) return true;
    if (LooksLikePrimitive()) return true;
    if (Cur().kind != TokKind::Identifier) return false;
    size_t save = pos_;
    bool result = false;
    Advance();
    // qualified segments
    while (IsOp(".") && Peek().kind == TokKind::Identifier) {
      Advance(); Advance();
    }
    TrySkipTypeArgs();
    while (IsOp("[") && Peek().text == "]") { Advance(); Advance(); }
    if (Cur().kind == TokKind::Identifier) {
      const Token& nxt = Peek();
      if (nxt.text == "=" || nxt.text == ";" || nxt.text == "," ||
          nxt.text == ")" || nxt.text == ":" || nxt.text == "[")
        result = true;
    }
    pos_ = save;
    return result;
  }

  // ---- compilation unit / declarations ----
  void ParseCompilationUnit() {
    int root = ast_.Add("CompilationUnit", -1);
    while (!AtEnd()) {
      if (EatKw("package") || EatKw("import")) {
        while (!AtEnd() && !EatOp(";")) Advance();
        continue;
      }
      SkipModifiers();
      if (IsKw("class") || IsKw("interface") || IsKw("enum") ||
          IsKw("record") || IsKw("@interface")) {
        ParseTypeDeclaration(root);
      } else if (IsOp(";")) {
        Advance();
      } else {
        Advance();  // stray token at top level
      }
    }
  }

  void ParseTypeDeclaration(int parent) {
    DepthGuard g(this);
    if (!g.ok) { SkipToStatementSync(); return; }
    std::string kw = Cur().text;
    Advance();
    const char* type = (kw == "enum") ? "EnumDeclaration"
                      : (kw == "record") ? "RecordDeclaration"
                      : "ClassOrInterfaceDeclaration";
    int id = ast_.Add(type, parent);
    if (Cur().kind == TokKind::Identifier) {
      ast_.Add("SimpleName", id, Cur().text);
      Advance();
    }
    TrySkipTypeArgs();  // type parameters
    // record header
    if (kw == "record" && IsOp("(")) {
      Advance();
      while (!AtEnd() && !IsOp(")")) {
        ParseParameter(id);
        if (!EatOp(",")) break;
      }
      EatOp(")");
    }
    while (EatKw("extends") || EatKw("implements")) {
      do {
        ParseType(id);
      } while (EatOp(","));
    }
    if (!EatOp("{")) { SkipToStatementSync(); return; }
    if (kw == "enum") ParseEnumConstants(id);
    while (!AtEnd() && !IsOp("}")) ParseMember(id);
    EatOp("}");
  }

  void ParseEnumConstants(int parent) {
    // constants: NAME(args)? {body}? , ... ;
    while (Cur().kind == TokKind::Identifier) {
      int c = ast_.Add("EnumConstantDeclaration", parent);
      ast_.Add("SimpleName", c, Cur().text);
      Advance();
      if (IsOp("(")) SkipBalanced("(", ")");
      if (IsOp("{")) {
        Advance();
        while (!AtEnd() && !IsOp("}")) ParseMember(c);
        EatOp("}");
      }
      if (!EatOp(",")) break;
    }
    EatOp(";");
  }

  void ParseMember(int parent) {
    DepthGuard g(this);
    if (!g.ok) { SkipToStatementSync(); EatOp("}"); return; }
    SkipModifiers();
    if (IsOp(";")) { Advance(); return; }
    if (IsKw("class") || IsKw("interface") || IsKw("enum") ||
        IsKw("record") || IsKw("@interface")) {
      ParseTypeDeclaration(parent);
      return;
    }
    if (IsOp("{")) {  // static/instance initializer block
      int init = ast_.Add("InitializerDeclaration", parent);
      ParseBlock(init);
      return;
    }
    TrySkipTypeArgs();  // method type parameters
    size_t save = pos_;
    // constructor: Identifier (
    if (Cur().kind == TokKind::Identifier && Peek().text == "(") {
      ParseCallableRest(parent, "ConstructorDeclaration", Cur().text,
                        /*has_return_type=*/false);
      return;
    }
    // method or field: Type Name ...
    int probe_parent = ast_.Add("__probe__", -1);
    int t = ParseType(probe_parent);
    if (t >= 0 && Cur().kind == TokKind::Identifier &&
        Peek().text == "(") {
      std::string name = Cur().text;
      int m = ast_.Add("MethodDeclaration", parent);
      AdoptProbe(probe_parent, m);
      ParseCallableRest(m, "", name, /*has_return_type=*/true);
      return;
    }
    if (t >= 0 && Cur().kind == TokKind::Identifier) {
      // field declaration(s)
      int f = ast_.Add("FieldDeclaration", parent);
      AdoptProbe(probe_parent, f);
      do {
        int vd = ast_.Add("VariableDeclarator", f);
        if (Cur().kind == TokKind::Identifier) {
          ast_.Add("SimpleName", vd, Cur().text);
          Advance();
        }
        while (IsOp("[") && Peek().text == "]") { Advance(); Advance(); }
        if (EatOp("=")) ParseVarInit(vd);
      } while (EatOp(","));
      if (!EatOp(";")) SkipToStatementSync();
      return;
    }
    // unrecognized member — resync
    pos_ = save;
    ++result_.dropped_methods;
    SkipMemberLike();
  }

  // Move the probe's children (parsed type nodes) under `new_parent`.
  void AdoptProbe(int probe, int new_parent) {
    auto children = ast_.at(probe).children;  // copy
    for (int c : children) ast_.Reparent(c, new_parent);
    ast_.at(probe).children.clear();
  }

  void SkipMemberLike() {
    // skip to `;` or a balanced `{...}`
    while (!AtEnd()) {
      if (IsOp(";")) { Advance(); return; }
      if (IsOp("{")) { SkipBalanced("{", "}"); return; }
      if (IsOp("}")) return;
      Advance();
    }
  }

  // Shared tail of methods/constructors: (params) throws? body
  // `callable_type` non-empty => create the node here (constructors);
  // empty => parent IS the already-created MethodDeclaration.
  void ParseCallableRest(int parent_or_self, const char* callable_type,
                         const std::string& name, bool has_return_type) {
    int m = parent_or_self;
    if (callable_type && *callable_type) {
      m = ast_.Add(callable_type, parent_or_self);
    }
    // The method's own name leaf: JavaExtractor replaces it with a
    // special token to prevent label leakage (the target IS the name).
    ast_.Add("SimpleName", m,
             has_return_type || std::string(callable_type) ==
                 "ConstructorDeclaration" ? name : name);
    Advance();  // name
    size_t guard = pos_;
    EatOp("(");
    while (!AtEnd() && !IsOp(")")) {
      ParseParameter(m);
      if (!EatOp(",")) break;
    }
    EatOp(")");
    while (IsOp("[") && Peek().text == "]") { Advance(); Advance(); }
    if (EatKw("throws")) {
      do {
        ParseType(m);
      } while (EatOp(","));
    }
    if (IsOp("{")) {
      size_t body_start = pos_;
      ParseBlock(m);
      (void)body_start;
      if (std::string(ast_.at(m).type) == "MethodDeclaration")
        result_.method_nodes.push_back(m);
      else if (ast_.at(m).type == "ConstructorDeclaration")
        result_.method_nodes.push_back(m);
    } else if (EatOp(";")) {
      // abstract/interface method: no body, still a method node but the
      // reference only emits methods with bodies — skip.
    } else if (EatOp("=")) {
      // annotation member default — skip to ;
      SkipToStatementSync();
    } else {
      if (pos_ == guard) Advance();
      ++result_.dropped_methods;
      SkipMemberLike();
    }
  }

  void ParseParameter(int parent) {
    SkipModifiers();
    int p = ast_.Add("Parameter", parent);
    ParseType(p);
    EatOp("...");  // varargs
    if (Cur().kind == TokKind::Identifier) {
      ast_.Add("SimpleName", p, Cur().text);
      Advance();
    }
    while (IsOp("[") && Peek().text == "]") { Advance(); Advance(); }
  }

  // ---- statements ----
  void ParseBlock(int parent) {
    DepthGuard g(this);
    int b = ast_.Add("BlockStmt", parent);
    if (!EatOp("{")) return;
    if (!g.ok) { SkipBalanced("{", "}"); return; }
    while (!AtEnd() && !IsOp("}")) {
      size_t before = pos_;
      ParseStatement(b);
      if (pos_ == before) Advance();  // always make progress
    }
    EatOp("}");
  }

  void ParseStatement(int parent) {
    DepthGuard g(this);
    if (!g.ok) { SkipToStatementSync(); return; }
    if (IsOp("{")) { ParseBlock(parent); return; }
    if (IsOp(";")) { ast_.Add("EmptyStmt", parent); Advance(); return; }
    if (IsKw("if")) { ParseIf(parent); return; }
    if (IsKw("while")) {
      int s = ast_.Add("WhileStmt", parent);
      Advance();
      ParseParenExpr(s);
      ParseStatement(s);
      return;
    }
    if (IsKw("do")) {
      int s = ast_.Add("DoStmt", parent);
      Advance();
      ParseStatement(s);
      if (EatKw("while")) ParseParenExpr(s);
      EatOp(";");
      return;
    }
    if (IsKw("for")) { ParseFor(parent); return; }
    if (IsKw("return")) {
      int s = ast_.Add("ReturnStmt", parent);
      Advance();
      if (!IsOp(";")) ParseExpression(s);
      if (!EatOp(";")) SkipToStatementSync();
      return;
    }
    if (IsKw("throw")) {
      int s = ast_.Add("ThrowStmt", parent);
      Advance();
      ParseExpression(s);
      if (!EatOp(";")) SkipToStatementSync();
      return;
    }
    if (IsKw("break")) {
      ast_.Add("BreakStmt", parent);
      Advance();
      if (Cur().kind == TokKind::Identifier) Advance();
      EatOp(";");
      return;
    }
    if (IsKw("continue")) {
      ast_.Add("ContinueStmt", parent);
      Advance();
      if (Cur().kind == TokKind::Identifier) Advance();
      EatOp(";");
      return;
    }
    if (IsKw("try")) { ParseTry(parent); return; }
    if (IsKw("switch")) { ParseSwitch(parent); return; }
    if (IsKw("synchronized")) {
      int s = ast_.Add("SynchronizedStmt", parent);
      Advance();
      if (IsOp("(")) ParseParenExpr(s);
      ParseStatement(s);
      return;
    }
    if (IsKw("assert")) {
      int s = ast_.Add("AssertStmt", parent);
      Advance();
      ParseExpression(s);
      if (EatOp(":")) ParseExpression(s);
      if (!EatOp(";")) SkipToStatementSync();
      return;
    }
    if (IsKw("yield")) {
      int s = ast_.Add("YieldStmt", parent);
      Advance();
      ParseExpression(s);
      if (!EatOp(";")) SkipToStatementSync();
      return;
    }
    if (IsKw("class") || IsKw("interface") || IsKw("enum")) {
      int s = ast_.Add("LocalClassDeclarationStmt", parent);
      ParseTypeDeclaration(s);
      return;
    }
    if (IsKw("this") && Peek().text == "(") {
      int s = ast_.Add("ExplicitConstructorInvocationStmt", parent);
      Advance();
      ParseArguments(s);
      EatOp(";");
      return;
    }
    if (IsKw("super") && Peek().text == "(") {
      int s = ast_.Add("ExplicitConstructorInvocationStmt", parent);
      Advance();
      ParseArguments(s);
      EatOp(";");
      return;
    }
    // labeled statement: Identifier ':' (but not switch-case / ternary)
    if (Cur().kind == TokKind::Identifier && Peek().text == ":") {
      int s = ast_.Add("LabeledStmt", parent);
      Advance(); Advance();
      ParseStatement(s);
      return;
    }
    if (LooksLikeLocalVarDecl()) {
      int s = ast_.Add("ExpressionStmt", parent);
      ParseVarDeclExpr(s);
      if (!EatOp(";")) SkipToStatementSync();
      return;
    }
    // expression statement
    int s = ast_.Add("ExpressionStmt", parent);
    ParseExpression(s);
    if (!EatOp(";")) SkipToStatementSync();
  }

  void ParseIf(int parent) {
    int s = ast_.Add("IfStmt", parent);
    Advance();
    ParseParenExpr(s);
    ParseStatement(s);
    if (EatKw("else")) ParseStatement(s);
  }

  void ParseParenExpr(int parent) {
    if (!EatOp("(")) { SkipToStatementSync(); return; }
    ParseExpression(parent);
    if (!EatOp(")")) {
      // resync to the matching paren
      int depth = 1;
      while (!AtEnd() && depth > 0) {
        if (IsOp("(")) ++depth;
        else if (IsOp(")")) --depth;
        Advance();
      }
    }
  }

  void ParseFor(int parent) {
    Advance();  // 'for'
    size_t save = pos_;
    // detect for-each: for ( Type name : expr )
    if (EatOp("(")) {
      size_t depth_save = pos_;
      (void)depth_save;
      bool foreach_detected = false;
      int scan_depth = 1;
      size_t scan = pos_;
      int fuel = 2000;
      while (scan < toks_.size() && scan_depth > 0 && fuel-- > 0) {
        const auto& t = toks_[scan];
        if (t.kind == TokKind::Operator) {
          if (t.text == "(") ++scan_depth;
          else if (t.text == ")") --scan_depth;
          else if (t.text == ";" && scan_depth == 1) break;
          else if (t.text == ":" && scan_depth == 1) {
            foreach_detected = true;
            break;
          } else if (t.text == "?" && scan_depth == 1) {
            break;  // ternary ':' would confuse the scan
          }
        }
        ++scan;
      }
      if (foreach_detected) {
        int s = ast_.Add("ForEachStmt", parent);
        int vd = ast_.Add("VariableDeclarationExpr", s);
        ParseType(vd);
        int var = ast_.Add("VariableDeclarator", vd);
        if (Cur().kind == TokKind::Identifier) {
          ast_.Add("SimpleName", var, Cur().text);
          Advance();
        }
        EatOp(":");
        ParseExpression(s);
        EatOp(")");
        ParseStatement(s);
        return;
      }
      int s = ast_.Add("ForStmt", parent);
      // init
      if (!IsOp(";")) {
        if (LooksLikeLocalVarDecl()) ParseVarDeclExpr(s);
        else {
          do { ParseExpression(s); } while (EatOp(","));
        }
      }
      EatOp(";");
      if (!IsOp(";")) ParseExpression(s);  // condition
      EatOp(";");
      if (!IsOp(")")) {
        do { ParseExpression(s); } while (EatOp(","));
      }
      EatOp(")");
      ParseStatement(s);
      return;
    }
    pos_ = save;
    SkipToStatementSync();
  }

  void ParseTry(int parent) {
    int s = ast_.Add("TryStmt", parent);
    Advance();
    if (IsOp("(")) {  // try-with-resources
      Advance();
      while (!AtEnd() && !IsOp(")")) {
        if (LooksLikeLocalVarDecl()) ParseVarDeclExpr(s);
        else ParseExpression(s);
        if (!EatOp(";")) break;
      }
      EatOp(")");
    }
    if (IsOp("{")) ParseBlock(s);
    while (IsKw("catch")) {
      int c = ast_.Add("CatchClause", s);
      Advance();
      if (EatOp("(")) {
        SkipModifiers();
        int p = ast_.Add("Parameter", c);
        ParseType(p);
        while (EatOp("|")) ParseType(p);  // union type
        if (Cur().kind == TokKind::Identifier) {
          ast_.Add("SimpleName", p, Cur().text);
          Advance();
        }
        EatOp(")");
      }
      if (IsOp("{")) ParseBlock(c);
    }
    if (EatKw("finally")) {
      if (IsOp("{")) ParseBlock(s);
    }
  }

  void ParseSwitch(int parent) {
    int s = ast_.Add("SwitchStmt", parent);
    Advance();
    ParseParenExpr(s);
    if (!EatOp("{")) { SkipToStatementSync(); return; }
    while (!AtEnd() && !IsOp("}")) {
      if (EatKw("case")) {
        int e = ast_.Add("SwitchEntry", s);
        do {
          ParseExpression(e);
        } while (EatOp(","));
        if (EatOp("->")) {
          ParseStatement(e);
          continue;
        }
        EatOp(":");
        while (!AtEnd() && !IsKw("case") && !IsKw("default") && !IsOp("}")) {
          size_t before = pos_;
          ParseStatement(e);
          if (pos_ == before) Advance();
        }
      } else if (EatKw("default")) {
        int e = ast_.Add("SwitchEntry", s);
        if (EatOp("->")) {
          ParseStatement(e);
          continue;
        }
        EatOp(":");
        while (!AtEnd() && !IsKw("case") && !IsKw("default") && !IsOp("}")) {
          size_t before = pos_;
          ParseStatement(e);
          if (pos_ == before) Advance();
        }
      } else {
        Advance();
      }
    }
    EatOp("}");
  }

  void ParseVarDeclExpr(int parent) {
    int d = ast_.Add("VariableDeclarationExpr", parent);
    SkipModifiers();
    ParseType(d);
    do {
      int vd = ast_.Add("VariableDeclarator", d);
      if (Cur().kind == TokKind::Identifier) {
        ast_.Add("SimpleName", vd, Cur().text);
        Advance();
      }
      while (IsOp("[") && Peek().text == "]") { Advance(); Advance(); }
      if (EatOp("=")) ParseVarInit(vd);
    } while (EatOp(","));
  }

  void ParseVarInit(int parent) {
    if (IsOp("{")) { ParseArrayInitializer(parent); return; }
    ParseExpression(parent);
  }

  void ParseArrayInitializer(int parent) {
    int a = ast_.Add("ArrayInitializerExpr", parent);
    EatOp("{");
    while (!AtEnd() && !IsOp("}")) {
      if (IsOp("{")) ParseArrayInitializer(a);
      else ParseExpression(a);
      if (!EatOp(",")) break;
    }
    EatOp("}");
  }

  void ParseArguments(int parent) {
    if (!EatOp("(")) return;
    while (!AtEnd() && !IsOp(")")) {
      ParseExpression(parent);
      if (!EatOp(",")) break;
    }
    EatOp(")");
  }

  // ---- expressions (precedence climbing; nodes built detached and
  // attached via Reparent so children keep source order) ----
  void ParseExpression(int parent) {
    int e = ParseAssignment();
    if (e >= 0) ast_.Reparent(e, parent);
  }

  int ParseAssignment() {
    DepthGuard g(this);
    if (!g.ok) { SkipToStatementSync(); return -1; }
    int lhs = ParseTernary();
    static const char* kAssign[] = {"=", "+=", "-=", "*=", "/=", "%=",
                                    "&=", "|=", "^=", "<<=", ">>=",
                                    ">>>=", nullptr};
    for (const char** a = kAssign; *a; ++a) {
      if (IsOp(*a)) {
        std::string op = Cur().text;
        Advance();
        int rhs = ParseAssignment();  // right-assoc
        int node = ast_.Add(std::string("AssignExpr:") + AssignOpName(op),
                            -1);
        if (lhs >= 0) ast_.Reparent(lhs, node);
        if (rhs >= 0) ast_.Reparent(rhs, node);
        return node;
      }
    }
    return lhs;
  }

  int ParseTernary() {
    int cond = ParseBinary(0);
    if (IsOp("?")) {
      Advance();
      int then_e = ParseAssignment();
      EatOp(":");
      int else_e = ParseAssignment();
      int node = ast_.Add("ConditionalExpr", -1);
      if (cond >= 0) ast_.Reparent(cond, node);
      if (then_e >= 0) ast_.Reparent(then_e, node);
      if (else_e >= 0) ast_.Reparent(else_e, node);
      return node;
    }
    return cond;
  }

  // precedence table for binary ops, lowest first
  int ParseBinary(int level) {
    static const std::vector<std::vector<std::string>> kLevels = {
        {"||"}, {"&&"}, {"|"}, {"^"}, {"&"},
        {"==", "!="},
        {"<", ">", "<=", ">=", "instanceof"},
        {"<<", ">>", ">>>"},
        {"+", "-"},
        {"*", "/", "%"},
    };
    if (level >= static_cast<int>(kLevels.size())) return ParseUnary();
    int lhs = ParseBinary(level + 1);
    for (;;) {
      bool matched = false;
      for (const auto& op : kLevels[level]) {
        if (op == "instanceof" ? IsKw("instanceof") : IsOp(op.c_str())) {
          // `<` here could open generics of a following decl — but in
          // expression position we treat it as less-than.
          if (op == "instanceof") {
            Advance();
            int node = ast_.Add("InstanceOfExpr", -1);
            if (lhs >= 0) ast_.Reparent(lhs, node);
            ParseType(node);
            // pattern variable (Java 16): instanceof Type name
            if (Cur().kind == TokKind::Identifier) {
              ast_.Add("SimpleName", node, Cur().text);
              Advance();
            }
            lhs = node;
          } else {
            Advance();
            int rhs = ParseBinary(level + 1);
            int node = ast_.Add(
                std::string("BinaryExpr:") + BinOpName(op), -1);
            if (lhs >= 0) ast_.Reparent(lhs, node);
            if (rhs >= 0) ast_.Reparent(rhs, node);
            lhs = node;
          }
          matched = true;
          break;
        }
      }
      if (!matched) return lhs;
    }
  }

  int ParseUnary() {
    DepthGuard g(this);
    if (!g.ok) { SkipToStatementSync(); return -1; }
    if (IsOp("!")) {
      Advance();
      int e = ParseUnary();
      int node = ast_.Add("UnaryExpr:LOGICAL_COMPLEMENT", -1);
      if (e >= 0) ast_.Reparent(e, node);
      return node;
    }
    if (IsOp("~")) {
      Advance();
      int e = ParseUnary();
      int node = ast_.Add("UnaryExpr:BITWISE_COMPLEMENT", -1);
      if (e >= 0) ast_.Reparent(e, node);
      return node;
    }
    if (IsOp("-")) {
      Advance();
      int e = ParseUnary();
      int node = ast_.Add("UnaryExpr:MINUS", -1);
      if (e >= 0) ast_.Reparent(e, node);
      return node;
    }
    if (IsOp("+")) {
      Advance();
      int e = ParseUnary();
      int node = ast_.Add("UnaryExpr:PLUS", -1);
      if (e >= 0) ast_.Reparent(e, node);
      return node;
    }
    if (IsOp("++") || IsOp("--")) {
      std::string op = Cur().text;
      Advance();
      int e = ParseUnary();
      int node = ast_.Add(std::string("UnaryExpr:") +
                          (op == "++" ? "PREFIX_INCREMENT"
                                      : "PREFIX_DECREMENT"), -1);
      if (e >= 0) ast_.Reparent(e, node);
      return node;
    }
    // cast: ( Type ) unary  — heuristic lookahead
    if (IsOp("(") && LooksLikeCast()) {
      Advance();
      int node = ast_.Add("CastExpr", -1);
      ParseType(node);
      EatOp(")");
      int e = ParseUnary();
      if (e >= 0) ast_.Reparent(e, node);
      return node;
    }
    return ParsePostfix();
  }

  bool LooksLikeCast() {
    // `( PrimitiveType )` always a cast; `( Name )` followed by an
    // identifier/literal/'(' and Name is a plausible type.
    size_t save = pos_;
    bool result = false;
    Advance();  // '('
    if (LooksLikePrimitive()) {
      size_t j = pos_;
      ++j;
      while (j < toks_.size() && toks_[j].text == "[" &&
             j + 1 < toks_.size() && toks_[j + 1].text == "]")
        j += 2;
      if (j < toks_.size() && toks_[j].text == ")") result = true;
    } else if (Cur().kind == TokKind::Identifier) {
      size_t j = pos_ + 1;
      int fuel = 100;
      while (j < toks_.size() && fuel-- > 0 &&
             (toks_[j].text == "." || toks_[j].text == "[" ||
              toks_[j].text == "]" ||
              toks_[j].kind == TokKind::Identifier))
        ++j;
      // allow one generic hop
      if (j < toks_.size() && toks_[j].text == "<") {
        int depth = 0;
        while (j < toks_.size() && fuel-- > 0) {
          if (toks_[j].text == "<") ++depth;
          else if (toks_[j].text == ">") { --depth; if (!depth) { ++j; break; } }
          else if (toks_[j].text == ">>") { depth -= 2; if (depth <= 0) { ++j; break; } }
          ++j;
        }
      }
      if (j < toks_.size() && toks_[j].text == ")" &&
          j + 1 < toks_.size()) {
        const Token& nxt = toks_[j + 1];
        if (nxt.kind == TokKind::Identifier ||
            nxt.kind == TokKind::IntLiteral ||
            nxt.kind == TokKind::FloatLiteral ||
            nxt.kind == TokKind::StringLiteral ||
            nxt.kind == TokKind::CharLiteral ||
            nxt.text == "(" || nxt.text == "new" || nxt.text == "this" ||
            nxt.text == "!" || nxt.text == "~")
          result = true;
      }
    }
    pos_ = save;
    return result;
  }

  int ParsePostfix() {
    int e = ParsePrimary();
    for (;;) {
      if (IsOp(".")) {
        // method call / field access / .class / .this / method ref
        Advance();
        TrySkipTypeArgs();  // explicit generic call foo.<T>bar()
        if (IsKw("class")) {
          Advance();
          int node = ast_.Add("ClassExpr", -1);
          if (e >= 0) ast_.Reparent(e, node);
          e = node;
          continue;
        }
        if (IsKw("this")) {
          Advance();
          int node = ast_.Add("ThisExpr", -1, "this");
          if (e >= 0) ast_.Reparent(e, node);
          e = node;
          continue;
        }
        if (IsKw("new")) {
          // qualified new — treat as ObjectCreationExpr with scope
          Advance();
          int node = ParseObjectCreation();
          if (e >= 0 && node >= 0) ast_.Reparent(e, node);
          e = node;
          continue;
        }
        if (Cur().kind == TokKind::Identifier) {
          std::string name = Cur().text;
          Advance();
          if (IsOp("(")) {
            int node = ast_.Add("MethodCallExpr", -1);
            if (e >= 0) ast_.Reparent(e, node);
            ast_.Add("SimpleName", node, name);
            ParseArguments(node);
            e = node;
          } else {
            int node = ast_.Add("FieldAccessExpr", -1);
            if (e >= 0) ast_.Reparent(e, node);
            ast_.Add("SimpleName", node, name);
            e = node;
          }
          continue;
        }
        continue;  // stray dot
      }
      if (IsOp("::")) {
        Advance();
        int node = ast_.Add("MethodReferenceExpr", -1);
        if (e >= 0) ast_.Reparent(e, node);
        if (Cur().kind == TokKind::Identifier || IsKw("new")) {
          ast_.Add("SimpleName", node, Cur().text);
          Advance();
        }
        e = node;
        continue;
      }
      if (IsOp("[")) {
        Advance();
        int node = ast_.Add("ArrayAccessExpr", -1);
        if (e >= 0) ast_.Reparent(e, node);
        if (!IsOp("]")) ParseExpression(node);
        EatOp("]");
        e = node;
        continue;
      }
      if (IsOp("++") || IsOp("--")) {
        std::string op = Cur().text;
        Advance();
        int node = ast_.Add(std::string("UnaryExpr:") +
                            (op == "++" ? "POSTFIX_INCREMENT"
                                        : "POSTFIX_DECREMENT"), -1);
        if (e >= 0) ast_.Reparent(e, node);
        e = node;
        continue;
      }
      return e;
    }
  }

  bool LooksLikeLambda() {
    // `ident ->` or `( params ) ->`
    if (Cur().kind == TokKind::Identifier && Peek().text == "->")
      return true;
    if (!IsOp("(")) return false;
    size_t j = pos_;
    int depth = 0;
    int fuel = 300;
    while (j < toks_.size() && fuel-- > 0) {
      if (toks_[j].text == "(") ++depth;
      else if (toks_[j].text == ")") {
        --depth;
        if (depth == 0)
          return j + 1 < toks_.size() && toks_[j + 1].text == "->";
      }
      ++j;
    }
    return false;
  }

  int ParseLambda() {
    int node = ast_.Add("LambdaExpr", -1);
    if (IsOp("(")) {
      Advance();
      while (!AtEnd() && !IsOp(")")) {
        SkipModifiers();
        int p = ast_.Add("Parameter", node);
        // typed or untyped param
        if (Cur().kind == TokKind::Identifier &&
            (Peek().text == "," || Peek().text == ")")) {
          ast_.Add("SimpleName", p, Cur().text);
          Advance();
        } else {
          ParseType(p);
          if (Cur().kind == TokKind::Identifier) {
            ast_.Add("SimpleName", p, Cur().text);
            Advance();
          }
        }
        if (!EatOp(",")) break;
      }
      EatOp(")");
    } else if (Cur().kind == TokKind::Identifier) {
      int p = ast_.Add("Parameter", node);
      ast_.Add("SimpleName", p, Cur().text);
      Advance();
    }
    EatOp("->");
    if (IsOp("{")) ParseBlock(node);
    else ParseExpression(node);
    return node;
  }

  int ParseObjectCreation() {
    // after 'new'
    int node = ast_.Add("ObjectCreationExpr", -1);
    int t = ParseType(node);
    if (IsOp("[") || (t >= 0 && ast_.at(t).type == "ArrayType")) {
      // array creation: new T[expr]... or new T[]{...}
      ast_.at(node).type = "ArrayCreationExpr";
      while (IsOp("[")) {
        Advance();
        if (!IsOp("]")) {
          int lvl = ast_.Add("ArrayCreationLevel", node);
          ParseExpression(lvl);
        }
        EatOp("]");
      }
      if (IsOp("{")) ParseArrayInitializer(node);
      return node;
    }
    if (IsOp("(")) ParseArguments(node);
    if (IsOp("{")) {
      // anonymous class body: members parsed so nested methods are
      // visited too (the reference's FunctionVisitor recurses into them)
      Advance();
      while (!AtEnd() && !IsOp("}")) ParseMember(node);
      EatOp("}");
    }
    return node;
  }

  int ParsePrimary() {
    DepthGuard g(this);
    if (!g.ok) { SkipToStatementSync(); return -1; }
    if (LooksLikeLambda()) return ParseLambda();
    const Token& t = Cur();
    switch (t.kind) {
      case TokKind::IntLiteral: {
        bool is_long = !t.text.empty() &&
                       (t.text.back() == 'l' || t.text.back() == 'L');
        int id = ast_.Add(is_long ? "LongLiteralExpr" : "IntegerLiteralExpr",
                          -1, t.text);
        Advance();
        return id;
      }
      case TokKind::FloatLiteral: {
        int id = ast_.Add("DoubleLiteralExpr", -1, t.text);
        Advance();
        return id;
      }
      case TokKind::CharLiteral: {
        int id = ast_.Add("CharLiteralExpr", -1, t.text);
        Advance();
        return id;
      }
      case TokKind::StringLiteral: {
        int id = ast_.Add("StringLiteralExpr", -1, t.text);
        Advance();
        return id;
      }
      default: break;
    }
    if (IsKw("true") || IsKw("false")) {
      int id = ast_.Add("BooleanLiteralExpr", -1, t.text);
      Advance();
      return id;
    }
    if (IsKw("null")) {
      int id = ast_.Add("NullLiteralExpr", -1, "null");
      Advance();
      return id;
    }
    if (IsKw("this")) {
      int id = ast_.Add("ThisExpr", -1, "this");
      Advance();
      return id;
    }
    if (IsKw("super")) {
      int id = ast_.Add("SuperExpr", -1, "super");
      Advance();
      return id;
    }
    if (IsKw("new")) {
      Advance();
      return ParseObjectCreation();
    }
    if (IsKw("switch")) {
      // switch expression (Java 14)
      int id = ast_.Add("SwitchExpr", -1);
      ParseSwitch(id);
      return id;
    }
    if (LooksLikePrimitive() || IsKw("void")) {
      // e.g. int.class, void.class
      int id = ast_.Add("PrimitiveType", -1, t.text);
      Advance();
      while (IsOp("[") && Peek().text == "]") { Advance(); Advance(); }
      return id;
    }
    if (IsOp("(")) {
      Advance();
      int node = ast_.Add("EnclosedExpr", -1);
      ParseExpression(node);
      EatOp(")");
      return node;
    }
    if (t.kind == TokKind::Identifier) {
      int id = ast_.Add("NameExpr", -1, t.text);
      Advance();
      if (IsOp("(")) {
        // unqualified call: wrap as MethodCallExpr with the name leaf
        int node = ast_.Add("MethodCallExpr", -1);
        ast_.at(id).type = "SimpleName";
        ast_.Reparent(id, node);
        ParseArguments(node);
        return node;
      }
      return id;
    }
    // unknown token in expression position
    Advance();
    return -1;
  }
};

}  // namespace

ParseResult ParseJava(const std::string& source) {
  Parser p(Lex(source));
  return p.Run();
}

}  // namespace c2v
