"""Offline preprocessing: raw extractor output -> `.c2v` shards + `.dict.c2v`.

A copy of `data/preprocess.py` in the JAX package, so that the port
prepares a corpus without it: one histogram pass over the train split
counting token / path / target frequencies, then a rewrite of each
split that keeps at most `max_contexts` contexts a method (a
`random.Random(seed)` sample, one stream across the splits in the order
train, val, test), pads each row to that many fields and writes
`<name>.<split>.c2v`; last the three count dicts and the example count
are pickled one after another into `<name>.dict.c2v`. For the same raw
input and seed both packages write the same bytes.

Row format: space-separated; field 0 = target label (`|`-joined
subtokens), fields 1..max_contexts = `left,path,right`, missing contexts
as empty fields.

Usage (the reference's flag spelling):
  python -m code2vec_tpu_torch.data.preprocess \
      --train_data raw.train.txt --val_data raw.val.txt --test_data raw.test.txt \
      --max_contexts 200 --word_vocab_size 1301136 --path_vocab_size 911417 \
      --target_vocab_size 261245 --output_name data/java-small/java-small
"""

from __future__ import annotations

import argparse
import pickle
import random
from collections import Counter
from typing import Iterable, Optional, Tuple


def parse_raw_line(line: str) -> Optional[Tuple[str, list]]:
    """One extractor output line -> (target_name, [context_str, ...])."""
    parts = line.strip().split(" ")
    if not parts or not parts[0]:
        return None
    return parts[0], [p for p in parts[1:] if p]


def count_histograms(path: str) -> Tuple[Counter, Counter, Counter, int]:
    """The histogram pass over the train split."""
    token_counts: Counter = Counter()
    path_counts: Counter = Counter()
    target_counts: Counter = Counter()
    num_examples = 0
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            parsed = parse_raw_line(line)
            if parsed is None:
                continue
            target, contexts = parsed
            target_counts[target] += 1
            num_examples += 1
            for ctx in contexts:
                fields = ctx.split(",")
                if len(fields) != 3:
                    continue
                left, path_str, right = fields
                token_counts[left] += 1
                token_counts[right] += 1
                path_counts[path_str] += 1
    return token_counts, path_counts, target_counts, num_examples


def process_split(in_path: str, out_path: str, max_contexts: int,
                  rng: random.Random) -> int:
    """Truncate/pad each method row to exactly `max_contexts` context
    fields and write the `.c2v` shard. Returns the number of examples."""
    n = 0
    with open(in_path, "r", encoding="utf-8", errors="replace") as fin, \
            open(out_path, "w", encoding="utf-8") as fout:
        for line in fin:
            parsed = parse_raw_line(line)
            if parsed is None:
                continue
            target, contexts = parsed
            contexts = [c for c in contexts if len(c.split(",")) == 3]
            if len(contexts) > max_contexts:
                contexts = rng.sample(contexts, max_contexts)
            elif len(contexts) < max_contexts:
                contexts = contexts + [""] * (max_contexts - len(contexts))
            fout.write(target + " " + " ".join(contexts) + "\n")
            n += 1
    return n


def save_dictionaries(dict_path: str, token_counts: Counter,
                      path_counts: Counter, target_counts: Counter,
                      num_examples: int) -> None:
    """Sequential-pickle format of the reference's `.dict.c2v`."""
    with open(dict_path, "wb") as f:
        pickle.dump(dict(token_counts), f)
        pickle.dump(dict(path_counts), f)
        pickle.dump(dict(target_counts), f)
        pickle.dump(num_examples, f)


def main(argv: Optional[Iterable[str]] = None) -> None:
    p = argparse.ArgumentParser(description="code2vec_tpu_torch preprocess")
    p.add_argument("--train_data", required=True)
    p.add_argument("--val_data", dest="val_data", default=None)
    p.add_argument("--test_data", dest="test_data", default=None)
    p.add_argument("--max_contexts", type=int, default=200)
    p.add_argument("--word_vocab_size", type=int, default=1301136)
    p.add_argument("--path_vocab_size", type=int, default=911417)
    p.add_argument("--target_vocab_size", type=int, default=261245)
    p.add_argument("--output_name", required=True)
    p.add_argument("--seed", type=int, default=239)
    args = p.parse_args(list(argv) if argv is not None else None)

    rng = random.Random(args.seed)
    token_counts, path_counts, target_counts, _ = count_histograms(
        args.train_data)

    num_train = process_split(args.train_data,
                              f"{args.output_name}.train.c2v",
                              args.max_contexts, rng)
    if args.val_data:
        process_split(args.val_data, f"{args.output_name}.val.c2v",
                      args.max_contexts, rng)
    if args.test_data:
        process_split(args.test_data, f"{args.output_name}.test.c2v",
                      args.max_contexts, rng)

    save_dictionaries(f"{args.output_name}.dict.c2v", token_counts,
                      path_counts, target_counts, num_train)
    print(f"preprocess: wrote {num_train} train examples and dictionaries "
          f"to {args.output_name}.*")


if __name__ == "__main__":
    main()
