#!/usr/bin/env python3
"""Generate a realistic synthetic Java corpus for the quality study: a
copy of tools/gen_java_corpus.py of the JAX package (standard library
only), with its names, flags and draws: for the same flags and seed it
writes the same bytes.

The sampled-softmax and low-precision ablations need a corpus with a
>= 50K-name target vocabulary and realistic skew; a small fixture
cannot show an F1 gap. This generator writes Java classes whose method
names are verb+adjective+noun subtoken compositions (Zipf-weighted, so
name frequencies look like real code) and whose bodies reference
identifiers correlated with the name, the signal code2vec learns. The
corpus goes through the native C++ extractor like any real dataset
(code2vec_tpu_torch/extractor: `c2v_extract --dir`).

Usage:
  python -m code2vec_tpu_torch.tools.gen_java_corpus --out /tmp/qs/raw \
      --names 50000 --methods 250000 [--seed 7]
creates <out>/{train,val,test}/*.java. It runs on the host alone, so it
has no --backend flag.
"""

from __future__ import annotations

import argparse
import os
import random
import sys

VERBS = ["get", "set", "is", "has", "compute", "find", "make", "build",
         "read", "write", "add", "remove", "update", "create", "delete",
         "load", "store", "parse", "format", "init", "reset", "clear",
         "count", "sum", "merge", "split", "copy", "move", "sort",
         "filter", "map", "apply", "check", "validate", "convert",
         "encode", "decode", "open", "close", "flush"]
ADJS = ["", "max", "min", "total", "last", "first", "next", "prev",
        "old", "new", "raw", "base", "temp", "local", "global", "cached",
        "active", "pending", "valid", "dirty", "sorted", "unique",
        "shared", "remote", "inner", "outer", "upper", "lower", "left",
        "right", "partial", "full", "empty", "default", "current",
        "initial", "final2", "safe", "fast", "slow"]
NOUNS = ["value", "name", "index", "count", "item", "node", "list",
         "map2", "key", "entry", "buffer", "stream", "file", "path",
         "user", "account", "session", "token", "request", "response",
         "message", "event", "handler", "state", "config", "option",
         "result", "error", "status", "code", "line", "column", "row",
         "cell", "table", "record", "field", "type", "size", "length",
         "width", "height", "offset", "position", "range", "limit",
         "total", "amount", "price", "rate", "score", "weight", "level",
         "depth", "degree", "angle", "point", "vector", "matrix",
         "color", "image", "pixel", "frame", "page", "block", "chunk",
         "segment", "region", "zone", "area", "bounds", "margin",
         "border", "padding", "label", "title", "text", "word", "char2",
         "digit", "number", "flag", "mask", "bit", "byte2", "hash",
         "checksum", "id2", "uuid", "version", "revision", "timestamp",
         "date", "time", "duration", "interval", "delay", "timeout",
         "retry", "attempt", "batch", "queue", "stack", "heap", "tree",
         "graph", "edge", "vertex", "parent", "child", "sibling",
         "root", "leaf", "branch", "head", "tail", "cursor", "iterator"]


def cap(s: str) -> str:
    return s[:1].upper() + s[1:] if s else s


def tail_name(rng: random.Random) -> str:
    """A random camelCase identifier from a combinatorially large space
    — the long-tail distractor-name universe of --tail_names mode."""
    syll = ["tmp", "buf", "acc", "cur", "aux", "raw", "alt", "seq",
            "loc", "ref", "arg", "ctx", "mem", "reg", "idx", "ptr",
            "len", "pos", "src", "dst", "obj", "rec", "seg", "blk"]
    k = rng.randint(2, 3)
    parts = [rng.choice(syll) for _ in range(k)]
    return parts[0] + "".join(cap(p) for p in parts[1:])


def method_source(rng: random.Random, verb: str, adj: str,
                  noun: str, tail_pool=None) -> str:
    """A method whose body references identifiers correlated with the
    name (the signal), plus random distractor statements (the noise).

    With `tail_pool` (a list of long-tail junk names, --tail_names
    mode), the body additionally declares 2-3 distractor locals drawn
    from the tail and REPEATS the signal through a second correlated
    local — the regime real code lives in: redundant naming cues plus
    a rare-name tail, where single-token renames are weaker and
    gradient-chosen replacements become frequency outliers
    (the JAX package's BASELINE.md "Adversarial robustness")."""
    field = (adj + cap(noun)) if adj else noun
    mname = verb + cap(adj) + cap(noun) if adj else verb + cap(noun)
    distract = rng.choice(NOUNS)
    d2 = rng.choice(NOUNS)
    lines = []
    if verb in ("get", "read", "load"):
        lines = [f"int {mname}() {{",
                 f"  return {field};", "}"]
    elif verb in ("set", "write", "store", "update"):
        lines = [f"void {mname}(int {field}) {{",
                 f"  this.{field} = {field};", "}"]
    elif verb in ("is", "has", "check", "validate"):
        lines = [f"boolean {mname}() {{",
                 f"  return {field} > 0;", "}"]
    elif verb in ("count", "sum"):
        lines = [f"int {mname}(int[] items) {{",
                 "  int total = 0;",
                 "  for (int i = 0; i < items.length; i++) {",
                 f"    total += items[i] * {field};", "  }",
                 "  return total;", "}"]
    elif verb in ("find",):
        lines = [f"int {mname}(int[] items) {{",
                 "  for (int i = 0; i < items.length; i++) {",
                 f"    if (items[i] == {field}) {{ return i; }}", "  }",
                 "  return -1;", "}"]
    elif verb in ("add", "merge"):
        lines = [f"int {mname}(int other) {{",
                 f"  {field} = {field} + other;",
                 f"  return {field};", "}"]
    elif verb in ("remove", "delete", "clear", "reset"):
        lines = [f"void {mname}() {{",
                 f"  {field} = 0;",
                 f"  int {distract} = 0;", "}"]
    else:
        lines = [f"int {mname}(int x) {{",
                 f"  int {field} = x * 2 + {d2};",
                 f"  if ({field} > x) {{ {field} -= 1; }}",
                 f"  return {field};", "}"]
    extra = ([f"  int {distract} = {d2} + 1;"]
             if rng.random() < 0.3 else [])
    if tail_pool:
        # tail mode inserts EVERYTHING before the last return statement
        # (javac-valid placement), junk names sampled WITHOUT
        # replacement (no duplicate locals)
        at = len(lines) - 1
        for idx in range(len(lines) - 1, -1, -1):
            if lines[idx].lstrip().startswith("return"):
                at = idx
                break
        extra += [f"  int {field}Copy = {field} + 0;"]
        extra += [f"  int {junk} = {rng.randrange(9)};"
                  for junk in rng.sample(tail_pool, rng.randint(2, 3))]
        lines[at:at] = extra
    else:
        # default mode keeps the historical before-brace placement —
        # it can land after a trailing return (extractor-only corpus;
        # javac-correctness is a tail-mode property), and moving it
        # would break the byte-identical-rebuild anchor the quality
        # study's reproducibility claim rests on
        for e in extra:
            lines.insert(-1, e)
    return "\n".join("  " + ln for ln in lines)


REDUNDANT_SUFFIXES = ("Src", "Buf", "Acc")  # one per cue position

# --deep_tail mode's identifier alphabet. 40 syllables -> 40^k names of
# k parts; deep_tail_name() encodes an integer index in little-endian
# base-40, so names are distinct BY CONSTRUCTION (no rejection sampling,
# any pool size) and subtoken-decompose into common short subtokens the
# way real Java locals do (`tmpBufAcc` -> tmp|buf|acc).
DT_SYLL = ["tmp", "buf", "acc", "cur", "aux", "raw", "alt", "seq",
           "loc", "ref", "arg", "ctx", "mem", "reg", "idx", "ptr",
           "len", "pos", "src", "dst", "obj", "rec", "seg", "blk",
           "cnt", "val", "itm", "nod", "lnk", "key", "qty", "sum",
           "avg", "tot", "rem", "div", "mul", "off", "cap", "dim"]


def deep_tail_name(i: int) -> str:
    """Distinct camelCase identifier for pool index `i` (injective:
    standard little-endian base-len(DT_SYLL) digit sequences)."""
    digits = []
    n = i
    while True:
        digits.append(n % len(DT_SYLL))
        n //= len(DT_SYLL)
        if n == 0:
            break
    parts = [DT_SYLL[d] for d in digits]
    return parts[0] + "".join(cap(p) for p in parts[1:])


class DeepTailJunk:
    """--deep_tail junk-identifier source (put the
    rarity detector in the regime the paper claims it works in — a
    java-large-shaped identifier pool with a deep Zipf tail).

    Two disjoint index ranges of the deep_tail_name() space:
      - a `zipf_head` of the first `head` names, drawn Zipf-weighted
        (`zipf_per_method` draws/method) — the common/mid-frequency
        junk mass every real corpus has;
      - an unbounded FRESH iterator starting at index `head`
        (`fresh_per_method` names/method, never reused) — every draw is
        a corpus singleton, which is what makes the train-token
        histogram's tail deep (~methods x fresh_per_method distinct
        once-seen tokens). The iterator keeps advancing through
        val/test generation, so held-out methods carry never-seen
        (OOV-at-eval) junk exactly like unseen real code does.
    """

    def __init__(self, head: int, fresh_per_method: int,
                 zipf_per_method: int):
        self.head = head
        self.fresh_per_method = fresh_per_method
        self.zipf_per_method = zipf_per_method
        self._next_fresh = head
        self._zipf_w = [1.0 / (r + 10) for r in range(head)]

    def names_for_method(self, rng: random.Random,
                         forbidden=()) -> list:
        # dedupe all draws against this method's other locals so the
        # emitted class stays javac-valid (no duplicate declarations):
        # rng.choices draws with replacement, fresh names at small
        # --deep_tail_head are single-syllable words overlapping NOUNS,
        # and the caller's forbidden set carries its other declarations
        out = []
        taken = set(forbidden)
        while len(out) < self.fresh_per_method:
            nm = deep_tail_name(self._next_fresh)
            self._next_fresh += 1
            if nm not in taken:
                out.append(nm)
                taken.add(nm)
        if self.head:
            for i in rng.choices(range(self.head), weights=self._zipf_w,
                                 k=self.zipf_per_method):
                nm = deep_tail_name(i)
                if nm not in taken:
                    out.append(nm)
                    taken.add(nm)
        return out


def method_source_redundant(rng: random.Random, verb: str, adj: str,
                            noun: str, k_cues: int,
                            junk: DeepTailJunk = None) -> str:
    """--redundant_cues mode (the defense positive
    control): the label is carried by `k_cues` DISTINCT local variables,
    each individually label-identifying (cue_i = methodName+suffix_i, a
    distinct vocab token whose subtokens spell the full label), chained
    so every cue appears in multiple path contexts. Renaming any single
    variable provably leaves k-1 intact cues — an information-theoretic
    guarantee the default corpus lacks (there one field token is the
    only cue, so one rename destroys the label signal and NO defense
    can win)."""
    mname = verb + cap(adj) + cap(noun) if adj else verb + cap(noun)
    cues = [mname + REDUNDANT_SUFFIXES[i % len(REDUNDANT_SUFFIXES)]
            + (str(i // len(REDUNDANT_SUFFIXES)) if
               i >= len(REDUNDANT_SUFFIXES) else "")
            for i in range(k_cues)]
    distract = rng.choice(NOUNS)
    lines = [f"int {mname}(int x) {{",
             f"  int {cues[0]} = x + 1;"]
    for prev, cur in zip(cues, cues[1:]):
        lines.append(f"  int {cur} = {prev} * 2;")
    if rng.random() < 0.3:
        lines.append(f"  int {distract} = x - 1;")
    if junk is not None:
        # deep-tail junk locals, javac-valid placement before the
        # return; each is a USED local (chained into a dead sum) so the
        # extractor gives it multiple path contexts, like real code —
        # a declared-but-unread local would surface in fewer contexts
        # than the attack's rename target ever does. `forbidden` keeps
        # a junk draw from colliding with ANY other declaration in this
        # method (DT_SYLL composites overlap NOUNS words and the cue /
        # sum locals on rare draws)
        names = junk.names_for_method(
            rng, forbidden=(distract, distract + "Sum", mname, *cues))
        lines += [f"  int {nm} = x + {i};"
                  for i, nm in enumerate(names)]
        lines.append("  int " + distract + "Sum = "
                     + " + ".join(names) + ";")
    lines.append(f"  return {cues[-1]};")
    lines.append("}")
    return "\n".join("  " + ln for ln in lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m code2vec_tpu_torch.tools.gen_java_corpus")
    ap.add_argument("--out", required=True)
    ap.add_argument("--names", type=int, default=50_000)
    ap.add_argument("--methods", type=int, default=250_000)
    ap.add_argument("--methods_per_class", type=int, default=50)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--tail_names", type=int, default=0,
                    help="size of a long-tail distractor-name pool; "
                         "0 (default) keeps the original corpus "
                         "byte-identical")
    ap.add_argument("--redundant_cues", type=int, default=0,
                    help="k>=1: every method carries k independent "
                         "label-identifying locals (defense positive "
                         "control; see method_source_redundant). "
                         "0 (default) keeps the original bodies")
    ap.add_argument("--deep_tail_fresh", type=int, default=0,
                    help="java-large-shaped identifier pool (detection "
                         "regime): N never-reused "
                         "singleton junk locals per method (the deep "
                         "tail). Requires --redundant_cues")
    ap.add_argument("--deep_tail_zipf", type=int, default=1,
                    help="Zipf-weighted draws/method from the junk "
                         "head pool (common junk mass); active only "
                         "with --deep_tail_fresh")
    ap.add_argument("--deep_tail_head", type=int, default=50_000,
                    help="size of the Zipf-weighted junk head pool")
    args = ap.parse_args(argv)
    if args.deep_tail_fresh and not args.redundant_cues:
        ap.error("--deep_tail_fresh requires --redundant_cues (the "
                 "detection-regime corpus must not be single-token-"
                 "determined, or no defense/detection can win)")
    junk = (DeepTailJunk(args.deep_tail_head, args.deep_tail_fresh,
                         args.deep_tail_zipf)
            if args.deep_tail_fresh else None)
    rng = random.Random(args.seed)
    tail_pool = None
    if args.tail_names:
        tail_rng = random.Random(args.seed ^ 0x7A11)  # own stream:
        # the default (tail_names=0) rng sequence stays untouched.
        # dict.fromkeys: dedupe in generation order (a set's iteration
        # order varies with hash randomization -> nondeterministic pool)
        seen = dict.fromkeys(())
        attempts = 0
        while len(seen) < args.tail_names and \
                attempts < args.tail_names * 200:
            seen.setdefault(tail_name(tail_rng))
            attempts += 1
        if len(seen) < args.tail_names:
            ap.error(f"--tail_names {args.tail_names} exceeds the "
                     f"reachable name space (~14400; got {len(seen)})")
        tail_pool = list(seen)

    # build the name universe and give it a Zipf weighting
    combos = [(v, a, n) for v in VERBS for a in ADJS for n in NOUNS]
    rng.shuffle(combos)
    names = combos[:args.names]
    weights = [1.0 / (r + 10) for r in range(len(names))]  # Zipf-ish

    splits = (("train", 0.8), ("val", 0.1), ("test", 0.1))
    total_written = 0
    for split, frac in splits:
        n_methods = int(args.methods * frac)
        d = os.path.join(args.out, split)
        os.makedirs(d, exist_ok=True)
        # train: guarantee every name appears >=2 times (so the full
        # target vocab exists and is learnable), then fill the rest with
        # the Zipf draw; val/test: natural Zipf draw only.
        pool = []
        if split == "train":
            pool = [nm for nm in names for _ in range(2)]
            rng.shuffle(pool)
            pool = pool[:n_methods]
        pool += rng.choices(names, weights=weights,
                            k=n_methods - len(pool))
        rng.shuffle(pool)
        file_idx = 0
        written = 0
        while written < n_methods:
            k = min(args.methods_per_class, n_methods - written)
            chosen = pool[written:written + k]
            body = []
            fields = set()
            for v, a, n in chosen:
                if args.redundant_cues:
                    body.append(method_source_redundant(
                        rng, v, a, n, args.redundant_cues, junk=junk))
                else:
                    fields.add((a + cap(n)) if a else n)
                    body.append(method_source(rng, v, a, n,
                                              tail_pool=tail_pool))
            field_decls = "\n".join(f"  int {f};" for f in sorted(fields))
            cls = (f"class C{split.capitalize()}{file_idx} {{\n"
                   f"{field_decls}\n" + "\n".join(body) + "\n}\n")
            with open(os.path.join(d, f"C{file_idx}.java"), "w") as f:
                f.write(cls)
            file_idx += 1
            written += k
        total_written += written
        print(f"{split}: {written} methods in {file_idx} files")
    print(f"total: {total_written} methods, "
          f"{len(names)} distinct target names")
    if junk is not None:
        print(f"deep tail: {junk._next_fresh - junk.head} fresh "
              f"singleton junk names + {junk.head} Zipf-head junk "
              f"names across all splits")
    return 0


if __name__ == "__main__":
    sys.exit(main())
