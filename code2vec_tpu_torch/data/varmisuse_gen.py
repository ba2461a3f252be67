"""VarMisuse dataset generation: Java methods with a hole, through the
native extractor.

A copy of `data/varmisuse_gen.py` in the JAX package: the same
`random.Random` draws, so one seed gives the same sources and (through
the port's own copy of the extractor, extractor/native.py) the same
rows. Each example is a Java method in which ONE variable use is
replaced by the `slotvar` hole marker; the task is to point at the
variable that belongs there among the method's candidates. Variables
get role-consistent names and uses (counters in loop headers,
accumulators in `x = x + ...`, limits in comparisons, flags in
conditionals, results in returns), so the hole's path-contexts
determine the answer.

Row format (`.vm.c2v`):
    <label_idx> <cand_1,...,cand_K> <ctx> <ctx> ...
label_idx indexes the candidate list; candidates are normalized tokens;
contexts are `left,pathHash,right` triples from the extractor.
"""

from __future__ import annotations

import random
import re
from typing import List, Tuple

from code2vec_tpu_torch.models.varmisuse import SLOT_TOKEN

ROLE_NAMES = {
    "counter": ["i", "j", "k", "idx", "pos", "cursor"],
    "accumulator": ["total", "sum", "acc", "agg", "tally"],
    "limit": ["limit", "bound", "size", "len", "cap"],
    "flag": ["flag", "valid", "done", "ready", "ok"],
    "result": ["result", "out", "res", "answer", "value"],
}
ROLES = list(ROLE_NAMES)


def make_vm_source(rng: random.Random
                   ) -> Tuple[str, List[str], int]:
    """One method with a hole. Returns (java_source, candidates,
    label_index): candidates are the method's variable names (shuffled),
    label_index points at the variable the hole replaces."""
    names = {role: rng.choice(opts) for role, opts in ROLE_NAMES.items()}
    counter, accum = names["counter"], names["accumulator"]
    limit, flag, result = names["limit"], names["flag"], names["result"]

    # every var has role-typical use sites; one site becomes the hole
    sites = {
        "counter_cond": f"{counter} < {limit}",
        "counter_inc": f"{counter} = {counter} + 1",
        "accum_add": f"{accum} = {accum} + {counter}",
        "flag_check": f"if ({flag} > 0) {{ {accum} = {accum} * 2; }}",
        "result_set": f"{result} = {accum} + {flag}",
    }
    hole_role, hole_site = rng.choice([
        ("counter", "counter_cond"), ("counter", "counter_inc"),
        ("accumulator", "accum_add"), ("flag", "flag_check"),
        ("limit", "counter_cond"), ("result", "result_set"),
        ("accumulator", "result_set"),
    ])
    hole_var = names[hole_role]
    # replace exactly one whole-token occurrence of the hole variable
    # (identifier-boundary regex: 'i' inside 'limit' must not match)
    parts = re.split(rf"\b{re.escape(hole_var)}\b", sites[hole_site])
    assert len(parts) >= 2, (hole_site, hole_var)
    occ = rng.randrange(len(parts) - 1)
    sites[hole_site] = (hole_var.join(parts[:occ + 1]) + SLOT_TOKEN
                        + hole_var.join(parts[occ + 1:]))

    body = [
        f"int method{rng.randrange(10_000)}(int {limit}, int {flag}) {{",
        f"  int {accum} = 0;",
        f"  int {result} = 0;",
        f"  for (int {counter} = 0; {sites['counter_cond']}; "
        f"{sites['counter_inc']}) {{",
        f"    {sites['accum_add']};",
        f"    {sites['flag_check']}",
        "  }",
        f"  {sites['result_set']};",
        f"  return {result};",
        "}",
    ]
    source = ("class VM {\n" + "\n".join("  " + ln for ln in body)
              + "\n}\n")
    candidates = [counter, accum, limit, flag, result]
    rng.shuffle(candidates)
    return source, candidates, candidates.index(hole_var)


def make_vm_rows(n: int, seed: int = 0,
                 extract=None) -> List[str]:
    """n `.vm.c2v` rows. `extract` maps java source -> extractor output
    lines (defaults to the native C++ extractor)."""
    if extract is None:
        from code2vec_tpu_torch.extractor import native

        def extract(src: str) -> List[str]:
            return native.extract_source(src)

    rng = random.Random(seed)
    rows = []
    while len(rows) < n:
        source, candidates, label = make_vm_source(rng)
        lines = extract(source)
        if not lines:
            continue
        # one method per class -> one line; drop the method-name field
        contexts = lines[0].split(" ")[1:]
        if not any(SLOT_TOKEN in c for c in contexts):
            continue  # hole optimized away by extraction; rare
        rows.append(f"{label} {','.join(candidates)} "
                    + " ".join(contexts))
    return rows


def write_vm_dataset(out_prefix: str, n_train: int, n_val: int,
                     n_test: int, seed: int = 0,
                     extract=None) -> None:
    for split, n, s in (("train", n_train, seed),
                        ("val", n_val, seed + 1),
                        ("test", n_test, seed + 2)):
        rows = make_vm_rows(n, seed=s, extract=extract)
        with open(f"{out_prefix}.{split}.vm.c2v", "w") as f:
            f.write("\n".join(rows) + "\n")
