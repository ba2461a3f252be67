"""Source-level adversarial attack driver: rename variables / insert
dead code in real Java or Python source, verified end to end through the
extractor.

Counterpart of `attacks/source_attack.py` in the JAX package (the
`noamyft/code2vec` fork delta; "Adversarial Examples for Models of
Code", Yefet, Alon & Yahav 2020). The tensor-space search is
attacks/gradient_attack.py; this module closes the loop to source code:

  extract -> tensorize -> gradient attack -> rewrite the source ->
  RE-extract -> RE-predict  (the reported outcome is always the model's
  output on the rewritten source, never the tensor-space estimate).

Two manipulations, per the paper:
- **variable rename**: replace every occurrence of one declared
  variable (local/param/field, found by a declaration heuristic) with
  the adversarially-chosen name — semantics-preserving.
- **dead-code insertion** (`--attack_deadcode`): insert an unused local
  declaration `int <advName>;` at the top of the method body and let the
  gradient attack choose `<advName>`.

Validity guards: candidate new names exclude every identifier already
present in the source (no shadowing/duplicate-declaration collisions),
and the rename targets are restricted to identifiers that appear in a
declaration position (`Type name`), so called methods and type names are
not rewritten. Every Java-source scan and rewrite is COMMENT/STRING-
AWARE: a lexical mask (`code_char_mask` — line/block comments, string
and char literals with escapes, text blocks) restricts the regexes to
code regions. Python sources are renamed through CPython's `ast`. The
scanners and rewriters are the JAX package's, copied as they are.

The extraction is the port's (serving/extractor.Extractor: the native
extractor built from the port's C++ sources, or the Python frontend),
the tensorization its data/reader.parse_c2v_rows, and the model a
predict-side `Code2VecModel` (`Code2VecTrainer.predictor()`): the attack
runs on the model's device with its kernel choice, and on its mesh's
windows of the tables under a model axis, its cohort's followers
joining each step (attacks/gradient_attack.py, serving/cohort.py).
"""

from __future__ import annotations

import dataclasses
import os
import re
import tempfile
from typing import Dict, List, Optional, Tuple

from code2vec_tpu_torch.attacks.gradient_attack import (JAVA_KEYWORDS,
                                                        AttackResult,
                                                        GradientRenameAttack,
                                                        render_identifier)
from code2vec_tpu_torch.common import split_to_subtokens
from code2vec_tpu_torch.data.reader import parse_c2v_rows
from code2vec_tpu_torch.serving.extractor import Extractor

_IDENT_RE = re.compile(r"\b[A-Za-z_][A-Za-z0-9_]*\b")
# one keyword list (gradient_attack.JAVA_KEYWORDS, lowercase) + the
# exact-case type name the identifier scanner must also skip
_JAVA_KEYWORDS = JAVA_KEYWORDS | {"String"}
# keywords that may legally precede an identifier but are NOT types —
# `return index;` must not read as a declaration of `index`
_NOT_A_TYPE = frozenset(
    "return new case throw else do instanceof class interface enum "
    "extends implements throws package import goto break continue "
    "assert".split())
_DECL_RE = re.compile(
    r"\b([A-Za-z_][A-Za-z0-9_]*)"          # base type identifier
    r"(?:\s*<[^<>;(){}]*>)?(?:\s*\[\s*\])*"  # generics / array suffix
    r"\s+([a-z_][A-Za-z0-9_]*)\s*(?=[=;,):])")  # variable name


def code_char_mask(source: str) -> List[bool]:
    """True where source[i] is CODE — False inside // and /* */
    comments, "string" / 'char' literals (backslash escapes honored),
    and Java 15 text blocks (\"\"\"...\"\"\", which legally contain
    unescaped double quotes — handled as their own state so an
    embedded quote neither exposes the block's content nor inverts
    the scanner for the code after it). A lexical scanner, not a
    parser: enough to keep the attack's regexes out of text the
    compiler ignores."""
    mask = [True] * len(source)
    i, n = 0, len(source)
    state = "code"
    while i < n:
        c = source[i]
        if state == "code":
            two = source[i:i + 2]
            if two == "//":
                state = "line"
                mask[i] = mask[i + 1] = False
                i += 2
                continue
            if two == "/*":
                state = "block"
                mask[i] = mask[i + 1] = False
                i += 2
                continue
            if source[i:i + 3] == '"""':
                state = "text"
                mask[i] = mask[i + 1] = mask[i + 2] = False
                i += 3
                continue
            if c == '"':
                state = "str"
                mask[i] = False
            elif c == "'":
                state = "char"
                mask[i] = False
            i += 1
            continue
        mask[i] = False
        if state == "line":
            if c == "\n":
                mask[i] = True  # the newline itself is code structure
                state = "code"
            i += 1
        elif state == "block":
            if source[i:i + 2] == "*/":
                mask[i + 1] = False
                i += 2
                state = "code"
            else:
                i += 1
        elif state == "text":
            if c == "\\" and i + 1 < n:
                mask[i + 1] = False
                i += 2
            elif source[i:i + 3] == '"""':
                mask[i + 1] = mask[i + 2] = False
                i += 3
                state = "code"
            else:
                i += 1
        else:  # str / char
            quote = '"' if state == "str" else "'"
            if c == "\\" and i + 1 < n:
                mask[i + 1] = False
                i += 2
            else:
                if c == quote:
                    state = "code"
                i += 1
    return mask


def mask_non_code(source: str) -> str:
    """The source with every non-code character blanked to a space —
    offsets (and therefore every regex match position) are preserved,
    so scans on the masked text map 1:1 onto the original."""
    mask = code_char_mask(source)
    return "".join(c if m or c == "\n" else " "
                   for c, m in zip(source, mask))


def normalize_identifier(ident: str) -> str:
    return "|".join(split_to_subtokens(ident))


def normalize_target_name(name: Optional[str]) -> Optional[str]:
    """CLI/REPL attack targets arrive as camelCase (`sortArray`) or
    already in stored subtoken form (`sort|array`); normalize the
    former. Shared by the command line's --attack_target and the
    REPL's `attack <name>` command."""
    if name and "|" not in name:
        return normalize_identifier(name)
    return name


def declared_variables(source: str) -> List[str]:
    """Identifiers in declaration position (`Type name` followed by
    `= ; , ) :`): params, locals, fields. Heuristic — a regex, not a
    parser — but it excludes called methods and type names, which is
    what keeps the rewrite semantics-preserving."""
    out, seen = [], set()
    for m in _DECL_RE.finditer(mask_non_code(source)):
        type_word, name = m.group(1), m.group(2)
        if type_word in _NOT_A_TYPE or name in _JAVA_KEYWORDS:
            continue
        if name not in seen:
            seen.add(name)
            out.append(name)
    return out


def declared_variables_python(source: str) -> List[str]:
    """Python counterpart of declared_variables, via the real parser
    (the python frontend itself uses CPython `ast` — SURVEY.md §8.3
    step 8): function params plus assignment / for / with / comprehension
    binding targets. Called functions and attribute names never bind
    here; together with rename_in_source_python's AST-precise rewrite
    the Python rename path stays semantics-preserving."""
    import ast
    try:
        tree = ast.parse(source)
    except SyntaxError:
        return []
    # names bound by constructs whose binder the renamer cannot rewrite
    # as a positioned node (`except E as x`, `import m as x`) are
    # excluded — renaming their uses but not the binder would break the
    # program. global/nonlocal names stay eligible: the renamer
    # rewrites those statements too.
    hazards = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ExceptHandler) and node.name:
            hazards.add(node.name)
        elif isinstance(node, ast.alias):
            # `import os.path` binds the FIRST segment (`os`)
            hazards.add((node.asname or node.name).split(".")[0])
        elif isinstance(node, (ast.MatchAs, ast.MatchStar)) \
                and node.name:
            hazards.add(node.name)  # match-pattern capture binders
        elif isinstance(node, ast.MatchMapping) and node.rest:
            hazards.add(node.rest)
    out, seen = [], set()

    def add(name: str) -> None:
        if (name not in seen and name not in hazards
                and not name.startswith("__")):
            seen.add(name)
            out.append(name)

    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            a = node.args
            for arg in (a.posonlyargs + a.args + a.kwonlyargs
                        + ([a.vararg] if a.vararg else [])
                        + ([a.kwarg] if a.kwarg else [])):
                add(arg.arg)
        elif isinstance(node, ast.Name) and isinstance(node.ctx,
                                                       ast.Store):
            add(node.id)
    return out


def declared_for(source: str, language: str) -> List[str]:
    """Declaration-position identifiers, per source language."""
    return (declared_variables_python(source) if language == "python"
            else declared_variables(source))


def identifiers_for_token(source: str, token_word: str,
                          declared_only: bool = True,
                          language: str = "java") -> List[str]:
    """Source identifiers that normalize to the stored vocab token."""
    pool = (declared_for(source, language) if declared_only else
            [m.group(0)
             for m in _IDENT_RE.finditer(mask_non_code(source))
             if m.group(0) not in _JAVA_KEYWORDS])
    found, seen = [], set()
    for ident in pool:
        if ident not in seen and normalize_identifier(ident) == token_word:
            seen.add(ident)
            found.append(ident)
    return found


def rename_in_source(source: str, old_ident: str, new_ident: str) -> str:
    """Word-boundary rename restricted to CODE regions: occurrences
    inside comments or string literals are untouched (they are not the
    program's identifiers — and rewriting a string would change
    behavior)."""
    pat = re.compile(rf"\b{re.escape(old_ident)}\b")
    masked = mask_non_code(source)
    out, last = [], 0
    for m in pat.finditer(masked):
        out.append(source[last:m.start()])
        out.append(new_ident)
        last = m.end()
    out.append(source[last:])
    return "".join(out)


def rename_in_source_python(source: str, old_ident: str,
                            new_ident: str) -> str:
    """AST-precise Python rename: rewrites only `Name` nodes and
    function-parameter `arg` nodes whose identifier matches — never
    keyword-argument NAMES in calls (`fetch(timeout=x)` keeps its
    `timeout=`, which belongs to the callee), attribute names, or
    string contents. This is what keeps Python renames
    semantics-preserving where a word-boundary regex is not."""
    import ast
    try:
        tree = ast.parse(source)
    except SyntaxError:
        return rename_in_source(source, old_ident, new_ident)
    lines = source.splitlines(keepends=True)
    spots = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Name) and node.id == old_ident) or \
                (isinstance(node, ast.arg) and node.arg == old_ident):
            spots.append((node.lineno, node.col_offset))
        elif isinstance(node, (ast.Global, ast.Nonlocal)) \
                and old_ident in node.names:
            # names here are bare strings without node positions; the
            # statement span contains only keywords/names/commas, so a
            # word-boundary scan inside it locates them exactly
            for ln in range(node.lineno, node.end_lineno + 1):
                text = lines[ln - 1]
                lo = node.col_offset if ln == node.lineno else 0
                hi = (node.end_col_offset if ln == node.end_lineno
                      else len(text))
                for m in re.finditer(
                        rf"\b{re.escape(old_ident)}\b", text[lo:hi]):
                    spots.append((ln, lo + m.start()))
    for ln, col in sorted(spots, reverse=True):
        line = lines[ln - 1]
        if line[col:col + len(old_ident)] == old_ident:
            lines[ln - 1] = (line[:col] + new_ident
                             + line[col + len(old_ident):])
    return "".join(lines)


def insert_dead_declaration(source: str, method_name_word: str,
                            var_name: str, ordinal: int = 0
                            ) -> Optional[str]:
    """Insert `int <var_name>;` right after the opening brace of the
    (ordinal-th) method whose extractor-normalized name is
    `method_name_word`. Returns the modified source, or None if the
    method isn't found."""
    skip = ordinal
    masked = mask_non_code(source)
    for m in _IDENT_RE.finditer(masked):
        if normalize_identifier(m.group(0)) != method_name_word:
            continue
        # require a parameter list then a brace: it's a method, not a
        # use. The `[^{;)]*` between `)` and `{` rejects call sites in
        # conditions — `if (check()) {` leaves a stray `)` after the
        # matched parens that a declaration never has. Scanned on the
        # code-masked text so a mention in a comment or string never
        # matches (offsets are identical to the original).
        rest = masked[m.end():]
        sig = re.match(r"\s*\([^)]*\)[^{;)]*\{", rest, re.S)
        if not sig:
            continue
        if skip > 0:
            skip -= 1
            continue
        pos = m.end() + sig.end()
        return source[:pos] + f" int {var_name}; " + source[pos:]
    return None


@dataclasses.dataclass
class SourceAttackResult:
    attack: AttackResult              # the tensor-space trajectory
    renames: Dict[str, str]           # source-identifier rewrites applied
    adversarial_source: Optional[str]
    # predictions on the REWRITTEN source, re-extracted (ground truth):
    verified_prediction: Optional[str]
    verified_success: Optional[bool]

    def __str__(self) -> str:
        lines = [str(self.attack)]
        if self.renames:
            lines.append("source rewrites: " + ", ".join(
                f"{a} -> {b}" for a, b in self.renames.items()))
        if self.verified_prediction is not None:
            lines.append(
                f"re-extracted prediction: '{self.verified_prediction}' "
                f"({'SUCCESS' if self.verified_success else 'failed'} "
                f"end-to-end)")
        return "\n".join(lines)


class SourceAttack:
    """Attacks one method of one source file against a loaded model."""

    def __init__(self, config, model, *, top_k_candidates: int = 32,
                 max_iters: int = 4):
        self.config = config
        self.model = model
        self.extractor = Extractor(config)  # re-created per attack_file
        #                                     to match the source language
        self.attack = GradientRenameAttack.over(
            model, top_k_candidates=top_k_candidates, max_iters=max_iters)

    def _tensorize(self, line: str):
        labels, src, pth, dst, mask, _, _ = parse_c2v_rows(
            [line], self.model.vocabs, self.config.MAX_CONTEXTS,
            keep_strings=True)
        return int(labels[0]), (src[0], pth[0], dst[0], mask[0])

    def _predict_word(self, method) -> str:
        top1 = self.attack.predict_fn(self.model.params,
                                      self.attack.tensors(method))
        return self.model.vocabs.target_vocab.lookup_word(int(top1))

    def _forbidden_ids(self, source: str) -> frozenset:
        """Vocab ids of every identifier already in the source — never
        valid as a NEW name (duplicate declarations / symbol capture)."""
        tv = self.attack.token_vocab
        ids = set()
        # code regions only: a name that appears solely in a comment
        # or string binds nothing, so it stays usable as a new name
        for m in _IDENT_RE.finditer(mask_non_code(source)):
            idx = tv.lookup_index(normalize_identifier(m.group(0)))
            if idx != tv.oov_index:
                ids.add(idx)
        return frozenset(ids)

    def attack_file(self, path: str, *, method_index: int = 0,
                    targeted: bool = False,
                    target_name: Optional[str] = None,
                    max_renames: int = 1,
                    deadcode: bool = False) -> SourceAttackResult:
        language = "python" if path.endswith(".py") else "java"
        if self.extractor.language != language:
            self.extractor = Extractor(self.config, language=language)
        if deadcode and language == "python":
            raise ValueError(
                "--attack_deadcode supports Java sources only (the "
                "python insertion heuristic is not implemented); use "
                "the rename attack for .py inputs")
        with open(path, encoding="utf-8") as f:
            source = f.read()
        names, lines = self.extractor.extract_paths(path)
        if method_index >= len(names):
            raise ValueError(
                f"file has {len(names)} methods, asked for "
                f"#{method_index}")
        method_name = names[method_index]
        # overloads share a normalized name; track WHICH occurrence
        ordinal = names[:method_index].count(method_name)

        if deadcode:
            # baseline: the PRISTINE file's prediction — success must
            # mean "differs from the original program", and inserting
            # the placeholder alone can already move the prediction
            _, pristine = self._tensorize(lines[method_index])
            p_top1 = self.attack.predict_fn(self.model.params,
                                            self.attack.tensors(pristine))
            var0 = self._fresh_variable_name(source)
            mod = insert_dead_declaration(source, method_name, var0,
                                          ordinal)
            if mod is None:
                raise ValueError(
                    f"could not locate method '{method_name}' in {path} "
                    f"to insert dead code")
            return self._run(mod, method_name, ordinal, targeted,
                             target_name, token_ids_from=var0,
                             max_renames=1, baseline_top1=int(p_top1))
        return self._run(source, method_name, ordinal, targeted,
                         target_name, token_ids_from=None,
                         max_renames=max_renames,
                         extraction=(names, lines))

    # ----------------------------------------------------------------
    def _fresh_variable_name(self, source: str) -> str:
        """An initial dead-variable name: in-vocab, identifier-renderable,
        not already present in the source (so its occurrence slots are
        exactly the inserted declaration's)."""
        used = {normalize_identifier(m.group(0))
                for m in _IDENT_RE.finditer(mask_non_code(source))}
        tv = self.attack.token_vocab
        for idx in range(tv.size - 1, 1, -1):
            word = tv.lookup_word(idx)
            ident = render_identifier(word)
            if ident and word not in used:
                return ident
        raise ValueError("no unused in-vocab identifier available")

    def _extract_lines_of(self, source: str) -> Tuple[List[str],
                                                      List[str]]:
        suffix = ".py" if self.extractor.language == "python" else ".java"
        fd, tmp = tempfile.mkstemp(suffix=suffix, prefix="c2v_attack_")
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                f.write(source)
            return self.extractor.extract_paths(tmp)
        finally:
            os.unlink(tmp)

    @staticmethod
    def _method_row(names: List[str], method_name: str,
                    ordinal: int) -> int:
        """Row of the (ordinal-th) method named `method_name`."""
        matches = [i for i, n in enumerate(names) if n == method_name]
        if not matches:
            raise ValueError(f"method '{method_name}' not found after "
                             f"re-extraction")
        return matches[min(ordinal, len(matches) - 1)]

    def _run(self, source: str, method_name: str, ordinal: int,
             targeted: bool, target_name: Optional[str],
             token_ids_from: Optional[str], max_renames: int,
             extraction: Optional[Tuple[List[str], List[str]]] = None,
             baseline_top1: Optional[int] = None) -> SourceAttackResult:
        names, lines = (extraction if extraction is not None
                        else self._extract_lines_of(source))
        idx = self._method_row(names, method_name, ordinal)
        _, method = self._tensorize(lines[idx])
        if token_ids_from is not None:
            # dead-code mode: attack exactly the inserted variable
            tid = self.attack.token_vocab.lookup_index(
                normalize_identifier(token_ids_from))
            if not ((method[0] == tid).any()
                    or (method[2] == tid).any()):
                raise ValueError(
                    "the inserted dead declaration's contexts were all "
                    "dropped by MAX_CONTEXTS downsampling (method has "
                    "more contexts than fit); raise --max_contexts to "
                    "attack this method with dead code")
            token_ids = [tid]
        else:
            # rename mode: only tokens that map to a DECLARED variable
            # in this source are legitimate rename targets
            declared = {normalize_identifier(d) for d in
                        declared_for(source,
                                     self.extractor.language)}
            token_ids = [t for t, _ in self.attack.attackable_tokens(
                method[0], method[2], method[3])
                if self.attack.token_vocab.lookup_word(t) in declared]
        result = self.attack.attack_method(
            self.model.params, method, targeted=targeted,
            target_name=target_name, max_renames=max_renames,
            token_ids=token_ids,
            forbidden=self._forbidden_ids(source),
            baseline_top1=baseline_top1)

        renames: Dict[str, str] = {}
        adv_source = source
        for orig_tok, final_tok in result.renames:
            new_ident = render_identifier(final_tok)
            if new_ident is None:
                continue
            if token_ids_from is not None and \
                    normalize_identifier(token_ids_from) == orig_tok:
                idents = [token_ids_from]
            else:
                idents = identifiers_for_token(
                    source, orig_tok,
                    language=self.extractor.language)
            rename = (rename_in_source_python
                      if self.extractor.language == "python"
                      else rename_in_source)
            for ident in idents:
                adv_source = rename(adv_source, ident, new_ident)
                renames[ident] = new_ident

        verified_pred = verified_ok = None
        if not renames and token_ids_from is not None and result.success:
            # The placeholder insertion ALONE flipped the prediction —
            # the inserted-declaration source is itself the adversarial
            # example. It was already extracted and predicted in this
            # run (that is where `result` came from), so the verified
            # outcome is exactly the final prediction on it.
            verified_pred = result.final_prediction
            verified_ok = (verified_pred == target_name if targeted
                           else verified_pred
                           != result.original_prediction)
            return SourceAttackResult(
                attack=result, renames={}, adversarial_source=source,
                verified_prediction=verified_pred,
                verified_success=verified_ok)
        if renames:
            try:
                v_names, v_lines = self._extract_lines_of(adv_source)
                v_idx = self._method_row(v_names, method_name, ordinal)
                _, v_method = self._tensorize(v_lines[v_idx])
                verified_pred = self._predict_word(v_method)
                if targeted:
                    verified_ok = verified_pred == target_name
                else:
                    verified_ok = (verified_pred
                                   != result.original_prediction)
            except Exception as e:  # honest failure, not a crash
                verified_pred = f"<re-extraction failed: {e}>"
                verified_ok = False
        return SourceAttackResult(
            attack=result, renames=renames,
            adversarial_source=adv_source if renames else None,
            verified_prediction=verified_pred,
            verified_success=verified_ok)
