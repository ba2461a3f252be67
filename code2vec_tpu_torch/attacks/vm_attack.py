"""Gradient rename attack on the VarMisuse head.

Counterpart of `attacks/vm_attack.py` in the JAX package ("Adversarial
Examples for Models of Code", Yefet, Alon & Yahav 2020, attacks both of
its subject models): renaming one variable makes the pointer of the
VarMisuse head (models/varmisuse.py) miss a real bug or flag correct
code.

A VM row is (src, pth, dst, mask, cand_ids [K], cand_mask [K]);
"renaming candidate k's variable" replaces its token id at every context
occurrence AND at cand_ids[k] — the pointer embeds candidates with the
same token table, so the rename moves both the syntactic environment and
the candidate's own embedding. The search is the code2vec attack's
(attacks/gradient_attack.py): one backward pass for the loss gradient at
a shared occurrence embedding (the local table of `occurrence_table`,
the candidate slots included), one [V, E] x [E] product scoring every
vocab token, exact re-scoring of the top-K shortlist in one batched
forward. `vm_scores` pools through kernel 1 on the card (the training
pool for the gradient, `attention_pool_fused` for the re-scores) and the
plain pool on CPU tensors. Success: the predicted candidate SLOT differs
from the clean prediction (untargeted) or equals an attacker-chosen slot
(targeted).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from code2vec_tpu_torch.attacks.gradient_attack import (attack_succeeded,
                                                        build_shortlist,
                                                        candidate_mask,
                                                        guard_leaked,
                                                        occurrence_table)
from code2vec_tpu_torch.device import resolve_device
from code2vec_tpu_torch.models.encoder import ModelDims
from code2vec_tpu_torch.models.varmisuse import candidate_ce, vm_scores
from code2vec_tpu_torch.vocab.vocabularies import Vocab


@dataclasses.dataclass
class VMAttackResult:
    success: bool
    targeted: bool
    original_slot: int            # clean predicted candidate slot
    final_slot: int
    target_slot: Optional[int]
    renames: List[Tuple[str, str]]  # per-variable (orig, final) tokens
    iterations: int

    def __str__(self) -> str:
        kind = "targeted" if self.targeted else "untargeted"
        status = "SUCCESS" if self.success else "failed"
        rename = (", ".join(f"{a} -> {b}" for a, b in self.renames)
                  if self.renames else "(no rename)")
        line = (f"[vm {kind} {status}] rename {rename}: predicted slot "
                f"{self.original_slot} -> {self.final_slot}")
        if self.targeted:
            line += f" (target slot {self.target_slot})"
        return line


def make_vm_attack_steps(dims: ModelDims, *, compute_dtype=torch.float32,
                         use_kernel: bool = True):
    """(score_fn, eval_fn, predict_fn) for one VM row, on the params'
    device.

    `ids` = (src [C], pth [C], dst [C], mask [C], cand [K], cmask [K])
    tensors; `occ` = (occ_src [C], occ_dst [C], occ_cand [K]) bool slots
    of the attacked variable; `label` is a candidate SLOT index."""

    def score_fn(params, ids, occ, label, sign):
        src, pth, dst, mask, cand, cmask = (t[None] for t in ids)
        occ_src, occ_dst, occ_cand = (t[None] for t in occ)
        table = params["token_emb"]
        cur_id = torch.amax(torch.where(occ_cand, cand,
                                        torch.full_like(cand, -1)))
        e_var = table[cur_id].to(torch.float32)
        e = e_var.clone()[None].requires_grad_(True)
        labels = torch.full((1,), int(label), dtype=torch.int64,
                            device=src.device)
        with torch.enable_grad():
            local, (src2, dst2, cand2) = occurrence_table(
                table, (src, dst, cand), (occ_src, occ_dst, occ_cand), e)
            scores, _ = vm_scores(dict(params, token_emb=local), src2, pth,
                                  dst2, mask, cand2, cmask,
                                  compute_dtype=compute_dtype,
                                  use_kernel=use_kernel, train=True)
            loss = sign * candidate_ce(scores, labels)[0]
            (g,) = torch.autograd.grad(loss, [e])
        with torch.no_grad():
            g = g[0]
            return torch.matmul(table.to(torch.float32), g) - e_var @ g

    @torch.no_grad()
    def eval_fn(params, ids, occ, cand_tok, label):
        src, pth, dst, mask, cand, cmask = ids
        occ_src, occ_dst, occ_cand = occ
        Kc = cand_tok.shape[0]
        ct = cand_tok.to(src.dtype)[:, None]
        srcK = torch.where(occ_src[None, :], ct, src[None, :])
        dstK = torch.where(occ_dst[None, :], ct, dst[None, :])
        candK = torch.where(occ_cand[None, :], ct, cand[None, :])

        def tile(t):
            return t[None, :].expand(Kc, t.shape[0])

        scores, _ = vm_scores(params, srcK, tile(pth), dstK, tile(mask),
                              candK, tile(cmask),
                              compute_dtype=compute_dtype,
                              use_kernel=use_kernel)
        labels = torch.full((Kc,), int(label), dtype=torch.int64,
                            device=src.device)
        return candidate_ce(scores, labels), torch.argmax(scores, dim=-1)

    @torch.no_grad()
    def predict_fn(params, ids):
        scores, _ = vm_scores(params, *(t[None] for t in ids),
                              compute_dtype=compute_dtype,
                              use_kernel=use_kernel)
        return torch.argmax(scores[0])

    return score_fn, eval_fn, predict_fn


class VMGradientRenameAttack:
    """Host loop — the code2vec attack's structure over VM rows: greedy
    over candidate variables, iterative gradient-shortlist + exact
    re-score per variable. `device=None` is the card (it raises without
    one); the params must lie there."""

    def __init__(self, dims: ModelDims, token_vocab: Vocab, *,
                 top_k_candidates: int = 32, max_iters: int = 4,
                 compute_dtype=torch.float32,
                 device: Optional[Union[str, torch.device]] = None,
                 use_kernel: bool = True):
        self.dims = dims
        self.token_vocab = token_vocab
        self.top_k = min(top_k_candidates,
                         dims.padded(dims.token_vocab_size))
        self.max_iters = max_iters
        self.device = resolve_device(device)
        self.score_fn, self.eval_fn, self.predict_fn = \
            make_vm_attack_steps(dims, compute_dtype=compute_dtype,
                                 use_kernel=use_kernel)
        self.legal = candidate_mask(token_vocab,
                                    dims.padded(dims.token_vocab_size))

    def tensors(self, arrays) -> tuple:
        """Host arrays on the attack's device."""
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device) for a in arrays)

    def attackable_slots(self, cand: np.ndarray, cmask: np.ndarray
                         ) -> List[int]:
        """Candidate slots whose token is a legal rename target (the
        sweep filters rows with none — protocol parity with the
        code2vec sweep's attackable_tokens check)."""
        return [k for k in range(len(cand))
                if cmask[k] > 0 and int(cand[k]) < len(self.legal)
                and self.legal[int(cand[k])]]

    def attack_method(self, params, row, *, targeted: bool = False,
                      target_slot: Optional[int] = None,
                      max_renames: int = 1,
                      forbidden: frozenset = frozenset()
                      ) -> VMAttackResult:
        """`row` = (src, pth, dst, mask, cand_ids, cand_mask) for ONE
        VM example (numpy). Greedily renames up to `max_renames`
        candidate variables (most context occurrences first);
        `forbidden` token ids are never chosen as new names."""
        src, pth, dst, mask, cand, cmask = (np.asarray(a) for a in row)
        original = int(self.predict_fn(params, self.tensors(
            (src, pth, dst, mask, cand, cmask))))
        if targeted:
            if target_slot is None:
                raise ValueError("targeted VM attack needs a slot")
            if not 0 <= int(target_slot) < len(cmask) \
                    or cmask[int(target_slot)] == 0:
                raise ValueError(
                    f"target slot {target_slot} is not a live candidate "
                    f"(K={len(cmask)}, "
                    f"{int((cmask > 0).sum())} valid slots)")
            label, sign = int(target_slot), 1.0
        else:
            label, sign = original, -1.0

        # attackable slots, ordered by context-occurrence count
        slots = sorted(
            ((int((src == int(cand[k])).sum()
                  + (dst == int(cand[k])).sum()), k)
             for k in self.attackable_slots(cand, cmask)),
            reverse=True)

        cur = (src.copy(), pth, dst.copy(), mask, cand.copy(), cmask)
        renames: List[Tuple[int, int]] = []
        iters = 0
        success = False
        for _, k in slots[:max_renames]:
            ok, final_id, changed, used = self._attack_slot(
                params, cur, k, label, sign, targeted, original,
                forbidden)
            iters += used
            if changed:
                renames.append((int(cand[k]), final_id))
            if ok:
                success = True
                break

        final = int(self.predict_fn(params, self.tensors(cur)))
        look = self.token_vocab.lookup_word
        return VMAttackResult(
            success=success, targeted=targeted, original_slot=original,
            final_slot=final, target_slot=target_slot,
            renames=[(look(a), look(b)) for a, b in renames],
            iterations=iters)

    def _attack_slot(self, params, cur, k: int, label: int, sign: float,
                     targeted: bool, original: int,
                     forbidden: frozenset
                     ) -> Tuple[bool, int, bool, int]:
        """Iteratively rename candidate slot k's variable IN PLACE in
        `cur`. Returns (success, final_token_id, changed, iters)."""
        src, pth, dst, mask, cand, cmask = cur
        token_id = int(cand[k])
        occ_src, occ_dst = src == token_id, dst == token_id
        occ_cand = cand == token_id
        occ = self.tensors((occ_src, occ_dst, occ_cand))
        tried = ({token_id} | set(forbidden)
                 | set(np.unique(np.concatenate(
                     [src.ravel(), dst.ravel(), cand.ravel()])).tolist()))
        cur_id = token_id
        changed = False
        for it in range(1, self.max_iters + 1):
            ids = self.tensors((src, pth, dst, mask, cand, cmask))
            scores = self.score_fn(params, ids, occ, label,
                                   sign).cpu().numpy()
            shortlist = build_shortlist(scores, self.legal, tried,
                                        self.top_k, cur_id)
            (sl,) = self.tensors((shortlist,))
            ce, pred = self.eval_fn(params, ids, occ, sl, label)
            att = guard_leaked(sign * ce.cpu().numpy(), scores, shortlist)
            pred = pred.cpu().numpy()
            best = int(np.argmin(att[:-1]))
            tried.update(int(c) for c in shortlist)
            if att[best] >= float(att[-1]):
                return (attack_succeeded(targeted, int(pred[-1]), label,
                                         original), cur_id, changed, it)
            new_id = int(shortlist[best])
            for arr, o in ((src, occ_src), (dst, occ_dst),
                           (cand, occ_cand)):
                arr[o] = new_id
            cur_id = new_id
            changed = True
            if attack_succeeded(targeted, int(pred[best]), label,
                                original):
                return True, cur_id, True, it
        return False, cur_id, changed, self.max_iters
