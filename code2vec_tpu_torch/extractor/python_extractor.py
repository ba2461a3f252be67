"""Python AST path-context extractor — the python150k frontend. A copy
of extractor/python_extractor.py of the JAX package (SURVEY.md §8.3 step 8: "swap JavaExtractor -> Python AST extractor";
CPython `ast` in-process is acceptable since Python parsing is native to
the host — this asymmetry vs. the C++ Java extractor is deliberate).

Same output contract as the Java extractor (SURVEY.md §3.2): one line per
function, `name tok,pathHash,tok ...`, path hashed with Java
String.hashCode semantics so both frontends share preprocessing and
vocabulary code.
"""

from __future__ import annotations

import ast as pyast
from typing import List, Optional, Tuple

from code2vec_tpu_torch.common import split_to_subtokens


def _normalize(name: str) -> str:
    return "|".join(split_to_subtokens(name)) or name.lower()


def java_string_hash(s: str) -> int:
    h = 0
    for b in s.encode("utf-8"):
        h = (h * 31 + b) & 0xFFFFFFFF
    return h - 0x100000000 if h >= 0x80000000 else h


class _Node:
    __slots__ = ("type", "leaf", "parent", "child_index", "children")

    def __init__(self, type_: str, parent: int, leaf: str = ""):
        self.type = type_
        self.leaf = leaf
        self.parent = parent
        self.child_index = 0
        self.children: List[int] = []


class _TreeBuilder:
    """Flatten a CPython ast into the same arena shape the C++ side uses.
    Leaves: identifiers (Name/arg/attr/keyword names), constants, and
    function names (replaced by METHOD_NAME inside their own subtree)."""

    def __init__(self) -> None:
        self.nodes: List[_Node] = []

    def add(self, type_: str, parent: int, leaf: str = "") -> int:
        nid = len(self.nodes)
        self.nodes.append(_Node(type_, parent, leaf))
        if parent >= 0:
            self.nodes[parent].children.append(nid)
            self.nodes[nid].child_index = \
                len(self.nodes[parent].children) - 1
        return nid

    def build(self, node: pyast.AST, parent: int) -> int:
        type_name = type(node).__name__
        # operator nodes fold into the parent type like the Java side's
        # BinaryExpr:PLUS
        if isinstance(node, pyast.BinOp):
            nid = self.add(f"BinOp:{type(node.op).__name__}", parent)
            self.build(node.left, nid)
            self.build(node.right, nid)
            return nid
        if isinstance(node, pyast.BoolOp):
            nid = self.add(f"BoolOp:{type(node.op).__name__}", parent)
            for v in node.values:
                self.build(v, nid)
            return nid
        if isinstance(node, pyast.UnaryOp):
            nid = self.add(f"UnaryOp:{type(node.op).__name__}", parent)
            self.build(node.operand, nid)
            return nid
        if isinstance(node, pyast.Compare):
            ops = "|".join(type(o).__name__ for o in node.ops)
            nid = self.add(f"Compare:{ops}", parent)
            self.build(node.left, nid)
            for c in node.comparators:
                self.build(c, nid)
            return nid
        if isinstance(node, pyast.Name):
            return self.add("Name", parent, node.id)
        if isinstance(node, pyast.arg):
            return self.add("arg", parent, node.arg)
        if isinstance(node, pyast.Constant):
            v = node.value
            if isinstance(v, str):
                leaf = v if v else "STR"
            elif v is None or isinstance(v, bool):
                leaf = str(v)
            else:
                leaf = str(v)
            return self.add(f"Constant:{type(v).__name__}", parent, leaf)
        if isinstance(node, pyast.Attribute):
            nid = self.add("Attribute", parent)
            self.build(node.value, nid)
            self.add("attr", nid, node.attr)
            return nid
        if isinstance(node, pyast.keyword):
            nid = self.add("keyword", parent)
            if node.arg:
                self.add("kwname", nid, node.arg)
            self.build(node.value, nid)
            return nid
        if isinstance(node, (pyast.FunctionDef, pyast.AsyncFunctionDef)):
            nid = self.add("FunctionDef", parent)
            self.add("name", nid, node.name)
            self.build(node.args, nid)
            for s in node.body:
                self.build(s, nid)
            # decorators/returns annotation excluded (label-adjacent noise)
            return nid
        # generic: recurse over child AST nodes in field order
        nid = self.add(type_name, parent)
        for _field, value in pyast.iter_fields(node):
            if isinstance(value, pyast.AST):
                self.build(value, nid)
            elif isinstance(value, list):
                for item in value:
                    if isinstance(item, pyast.AST):
                        self.build(item, nid)
        return nid


def _enumerate_paths(nodes: List[_Node], func_id: int, max_len: int,
                     max_width: int, max_leaves: int,
                     hash_paths: bool = True) -> Optional[Tuple[str, List[str]]]:
    func = nodes[func_id]
    name_leaf = next((c for c in func.children
                      if nodes[c].type == "name"), -1)
    if name_leaf < 0:
        return None
    target = _normalize(nodes[name_leaf].leaf)

    leaves: List[int] = []
    depths: List[int] = []

    def collect(nid: int, depth: int) -> None:
        if len(leaves) >= max_leaves:
            return
        n = nodes[nid]
        if not n.children and n.leaf:
            leaves.append(nid)
            depths.append(depth)
            return
        for c in n.children:
            collect(c, depth + 1)

    collect(func_id, 0)

    def token_of(nid: int) -> str:
        if nid == name_leaf:
            return "METHOD_NAME"
        n = nodes[nid]
        if n.type.startswith("Constant:"):
            kind = n.type.split(":", 1)[1]
            if kind in ("int", "float"):
                return n.leaf.lower()
            norm = _normalize(n.leaf)
            return norm or ("STR" if kind == "str" else "CONST")
        return _normalize(n.leaf) or "TOKEN"

    contexts: List[str] = []
    L = len(leaves)
    for i in range(L):
        for j in range(i + 1, L):
            a, b = leaves[i], leaves[j]
            da, db = depths[i], depths[j]
            ua, ub, up_a, up_b = a, b, 0, 0
            while da > db:
                ua = nodes[ua].parent
                da -= 1
                up_a += 1
            while db > da:
                ub = nodes[ub].parent
                db -= 1
                up_b += 1
            while ua != ub and ua >= 0 and ub >= 0:
                ua = nodes[ua].parent
                ub = nodes[ub].parent
                up_a += 1
                up_b += 1
            if ua < 0 or ua != ub:
                continue
            if up_a + up_b > max_len:
                continue
            ca, cb = a, b
            for _ in range(up_a - 1):
                ca = nodes[ca].parent
            for _ in range(up_b - 1):
                cb = nodes[cb].parent
            if up_a and up_b:
                width = abs(nodes[cb].child_index - nodes[ca].child_index)
                if width > max_width:
                    continue
            parts = []
            cur = a
            for _ in range(up_a):
                parts.append(nodes[cur].type)
                parts.append("^")
                cur = nodes[cur].parent
            parts.append(nodes[cur].type)
            down = []
            cur = b
            for _ in range(up_b):
                down.append(nodes[cur].type)
                cur = nodes[cur].parent
            for t in reversed(down):
                parts.append("_")
                parts.append(t)
            path = "".join(parts)
            pr = str(java_string_hash(path)) if hash_paths else path
            contexts.append(f"{token_of(a)},{pr},{token_of(b)}")
    if not contexts:
        return None
    return target, contexts


def extract_source(source: str, max_path_length: int = 8,
                   max_path_width: int = 2, max_leaves: int = 1000,
                   hash_paths: bool = True) -> List[str]:
    """Python source text -> extractor output lines."""
    try:
        tree = pyast.parse(source)
    except SyntaxError:
        return []
    tb = _TreeBuilder()
    tb.build(tree, -1)
    func_ids = [i for i, n in enumerate(tb.nodes)
                if n.type == "FunctionDef"]
    out = []
    for fid in func_ids:
        res = _enumerate_paths(tb.nodes, fid, max_path_length,
                               max_path_width, max_leaves, hash_paths)
        if res is not None:
            name, contexts = res
            out.append(name + " " + " ".join(contexts))
    return out


def extract_file(path: str, max_path_length: int = 8,
                 max_path_width: int = 2) -> List[str]:
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        return extract_source(f.read(), max_path_length, max_path_width)
