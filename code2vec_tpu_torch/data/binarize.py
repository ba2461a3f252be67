"""Offline int-izer: `.c2v` text -> pre-tokenized int32 binary shard.

A copy of `data/binarize.py` in the JAX package. Training reads
memmapped int32 shards instead of parsing text on the host
(data/reader.BinaryShardReader). The shard is a [N, 1 + 3*C] int32
matrix, one row per example:
  col 0                     : target label index
  cols 1        .. C        : source-token indices
  cols 1 +   C  .. 2C       : path indices
  cols 1 + 2*C  .. 3C       : target-token indices
padded positions hold the PAD index; the reader recomputes the padding
mask as `path != PAD` (a real context always has a path).

A `<prefix>.bin.targets` sidecar stores one raw target string per
example (same order), so evaluation, which needs the original name for
the subtoken metrics even when it is out of the target vocab, reads the
binary shard too. For the same `.c2v` and `.dict.c2v` both packages
write the same `.bin`, `.bin.json` and `.bin.targets` bytes.

Usage:
  python -m code2vec_tpu_torch.data.binarize --data prefix  # binarizes
      prefix.{train,val,test}.c2v using prefix.dict.c2v vocabularies
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import numpy as np

from code2vec_tpu_torch.data.reader import parse_c2v_rows
from code2vec_tpu_torch.vocab.vocabularies import Code2VecVocabs


def binarize_file(c2v_path: str, out_prefix: str, vocabs: Code2VecVocabs,
                  max_contexts: int, chunk: int = 8192) -> int:
    """Stream-convert one `.c2v` file; returns example count."""
    C = max_contexts
    row_width = 1 + 3 * C
    n_total = 0
    tmp_path = out_prefix + ".bin.tmp"
    tgt_tmp = out_prefix + ".bin.targets.tmp"
    with open(c2v_path, "r", encoding="utf-8", errors="replace") as fin, \
            open(tmp_path, "wb") as fout, \
            open(tgt_tmp, "w", encoding="utf-8") as ftgt:
        batch = []
        for line in fin:
            if not line.strip():
                continue
            batch.append(line)
            ftgt.write(line.split(" ", 1)[0].strip() + "\n")
            if len(batch) >= chunk:
                n_total += _write_chunk(batch, fout, vocabs, C, row_width)
                batch = []
        if batch:
            n_total += _write_chunk(batch, fout, vocabs, C, row_width)
    os.replace(tmp_path, out_prefix + ".bin")
    os.replace(tgt_tmp, out_prefix + ".bin.targets")
    with open(out_prefix + ".bin.json", "w") as f:
        json.dump({"num_examples": n_total, "max_contexts": C,
                   "pad_index": vocabs.token_vocab.pad_index,
                   "layout": "label,src*C,path*C,tgt*C", "dtype": "int32"},
                  f)
    return n_total


def _write_chunk(lines, fout, vocabs, C, row_width) -> int:
    labels, src, pth, dst, _mask, _, _ = parse_c2v_rows(lines, vocabs, C)
    rows = np.empty((len(lines), row_width), dtype=np.int32)
    rows[:, 0] = labels
    rows[:, 1:1 + C] = src
    rows[:, 1 + C:1 + 2 * C] = pth
    rows[:, 1 + 2 * C:1 + 3 * C] = dst
    rows.tofile(fout)
    return len(lines)


def main(argv: Optional[list] = None) -> None:
    p = argparse.ArgumentParser(description="code2vec_tpu_torch binarize")
    p.add_argument("--data", required=True,
                   help="dataset prefix (expects <prefix>.{split}.c2v and "
                        "<prefix>.dict.c2v)")
    p.add_argument("--max_contexts", type=int, default=200)
    p.add_argument("--word_vocab_size", type=int, default=1301136)
    p.add_argument("--path_vocab_size", type=int, default=911417)
    p.add_argument("--target_vocab_size", type=int, default=261245)
    args = p.parse_args(argv)

    vocabs = Code2VecVocabs.load_from_dict_file(
        args.data + ".dict.c2v", args.word_vocab_size,
        args.path_vocab_size, args.target_vocab_size)
    for split in ("train", "val", "test"):
        c2v = f"{args.data}.{split}.c2v"
        if os.path.exists(c2v):
            n = binarize_file(c2v, f"{args.data}.{split}", vocabs,
                              args.max_contexts)
            print(f"binarize: {c2v} -> {n} examples")


if __name__ == "__main__":
    main()
