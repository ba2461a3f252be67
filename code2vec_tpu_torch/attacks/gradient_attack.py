"""Gradient-guided discrete adversarial attacks: variable renaming.

Counterpart of `attacks/gradient_attack.py` in the JAX package (the
`noamyft/code2vec` fork delta; "Adversarial Examples for Models of
Code", Yefet, Alon & Yahav, 2020): rename one variable so the model
predicts an attacker-chosen method name (targeted) or any wrong name
(untargeted). The search is dense linear algebra:

1. one backward pass gives the gradient g [E] of the attack loss with
   respect to one shared embedding e placed at every occurrence slot of
   the attacked variable;
2. the first-order loss deltas of renaming to EVERY token of the
   vocabulary at once are one [V, E] x [E] product (`torch.matmul`, as
   XLA computes it outside any Pallas kernel in the JAX package);
3. the top-K shortlist is re-scored EXACTLY in one forward over a
   [K, C] batch of variants, so success is always decided on true
   model outputs.

The JAX package puts e in a spare row of a functional copy of the token
table and differentiates through the gather. Here e goes into a small
local table instead: the rows of the method's own ids, then one row of
e per method, and the method's ids remapped into it with the occurrence
slots pointing at e's row (`occurrence_table`). The encoder reads e at
those slots and its gradient is the sum of the slot gradients, in the
fixed order of ops/scatter.py, without a copy of the [V, E] table or a
[V, E] gradient. The encoder is `get_encode_fn(dims)`, bag or
transformer: on the card the scores differentiate through the training
pool (`encode(train=True)` without dropout: kernel 1's forward, the
plain recompute backward) or kernels 2 and 3, and the exact re-scores
and predictions go through kernel 1's `attention_pool_fused` (or kernel
2); on CPU tensors the plain versions run, as the JAX attack calls its
plain pool. `use_kernel=False` takes the plain versions on any device.

The lockstep batch (`attack_batch`) differentiates M methods in one
pass: their losses are independent, so one backward of their sum with
respect to a stacked [M, E] leaf gives every method's g, and the scores
are one product of the float32 table with [E, M]. Its top-T selection
on the device is `topk_stable` (training/steps.py), whose order among
equal scores is `jax.lax.top_k`'s; the serial path's shortlist stays
`np.argpartition` on the host, as in the JAX package.

Under a `mesh` whose model axis row-shards the tables (the JAX attack
on model-sharded params, tests/test_attacks.py:158) the steps read the
rank's windows: the rows a forward reads (the method's token and path
ids, a re-score's candidates, e's current row) are gathered whole from
the windows into the local tables (`parallel/sharding.take_window`, the
model group's sum), so the encode is one device's on every rank of the
model group; the logits are the rank's columns, the cross entropy the
sharded softmax's and the top-1 the merged top-k's (models/encoder.py,
training/steps.topk_merged); the first-order score is the rank's
window's product, gathered over the model group into the whole [M, V]
vector on every rank, so every rank's host code picks the same
shortlist. `candidate_mask` and `spare_row` index the whole vocab. Under
a mesh without a model axis (data, dcn, ctx) the params are whole on
every rank and the steps run without the mesh, as the JAX attack's
mesh-free `get_encode_fn(dims)`. The attack built over a model that
leads a cohort (`GradientRenameAttack.over`, serving/cohort.py) hands
each collective step's inputs to the followers first.

The outer loop (iterations x variables) stays on the host. Every entry
point runs on the card unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from code2vec_tpu_torch.common import SpecialVocabWords
from code2vec_tpu_torch.device import resolve_device
from code2vec_tpu_torch.models.encoder import (ModelDims, cross_entropy,
                                               full_logits, get_encode_fn)
from code2vec_tpu_torch.parallel.collectives import model_gather
from code2vec_tpu_torch.parallel.mesh import row_sharded
from code2vec_tpu_torch.parallel.sharding import take_window
from code2vec_tpu_torch.training.steps import topk_merged, topk_stable
from code2vec_tpu_torch.vocab.vocabularies import Vocab

_LETTERS_RE = re.compile(r"^[a-z]+$")
# Java's reserved words (+ `var`/`string`, which would shadow). Used to
# filter Java DECLARATIONS — words like `match`/`value` are legal Java
# identifiers and must stay attackable, so Python's keywords are NOT in
# this set.
JAVA_KEYWORDS = frozenset(
    "abstract assert boolean break byte case catch char class const "
    "continue default do double else enum extends final finally float "
    "for goto if implements import instanceof int interface long native "
    "new package private protected public return short static strictfp "
    "super switch synchronized this throw throws transient try void "
    "volatile while true false null var string".split())
PYTHON_KEYWORDS = frozenset(
    "and as assert async await break class continue def del elif else "
    "except finally for from global if import in is lambda nonlocal "
    "not or pass raise return try while with yield none true false "
    "match self".split())
# The NEW-name candidate pool is shared by both frontends, so a
# replacement must be a valid identifier in either language. Keywords
# are lowercase single words — camelCase renders never collide.
RESERVED_WORDS = JAVA_KEYWORDS | PYTHON_KEYWORDS


def render_identifier(token_word: str) -> Optional[str]:
    """Stored vocab token -> Java identifier, or None if not renderable.

    Vocab tokens are normalized subtoken strings (`array|index`); the
    source-level rename needs a real identifier (`arrayIndex`). Only
    all-letter subtokens render, and reserved words are rejected —
    anything else could not be a plain identifier and is excluded from
    the candidate pool."""
    subs = token_word.split("|")
    if not subs or any(not _LETTERS_RE.match(s) for s in subs):
        return None
    ident = subs[0] + "".join(s.capitalize() for s in subs[1:])
    if ident.lower() in RESERVED_WORDS:
        return None
    return ident


def spare_row(padded_rows: int, *arrays: np.ndarray) -> int:
    """A vocab row not used by any of `arrays` (the JAX package's
    occurrence-isolation remap target; the port's score remaps into a
    local table instead and keeps this helper for its callers)."""
    used = set(np.concatenate([np.asarray(a).ravel()
                               for a in arrays]).tolist())
    for cand in range(padded_rows - 1, -1, -1):
        if cand not in used:
            return cand
    raise ValueError("no spare vocab row (vocab smaller than the ids?)")


# the names a cohort's leader gives the three step calls of
# `make_batched_attack_steps` (serving/cohort.py)
ATTACK_OPS = ("attack/score", "attack/eval", "attack/predict")


def attack_succeeded(targeted: bool, pred: int, label: int,
                     original: int) -> bool:
    """Shared success predicate: targeted hits the label; untargeted
    departs from the clean prediction."""
    return pred == label if targeted else pred != original


def build_shortlist(scores: np.ndarray, legal: np.ndarray, tried: set,
                    top_k: int, cur_id: int) -> np.ndarray:
    """First-order scores -> [top_k] candidate ids. Illegal and
    already-tried rows are inf-masked before selection; the LAST slot
    re-evaluates the current id so the caller's acceptance test costs
    no extra call. Masked rows can still leak into a short selection
    (vocab barely above top_k) — guard_leaked handles them after exact
    evaluation."""
    scores[~legal] = np.inf
    for t in tried:
        scores[t] = np.inf
    cand = np.empty((top_k,), np.int32)
    # argpartition: O(V) selection beats a full argsort (~8x at the
    # java-large 1.3M-row vocab); order within the shortlist does not
    # matter — every entry is exactly re-scored anyway. Both attack
    # constructors clamp top_k <= vocab rows, making kth valid.
    k = top_k - 1
    assert k < len(scores), "top_k exceeds the vocabulary"
    cand[:-1] = np.argpartition(scores, k)[:k]
    cand[-1] = cur_id
    return cand


def guard_leaked(att_losses: np.ndarray, scores: np.ndarray,
                 shortlist: np.ndarray) -> np.ndarray:
    """Never accept a shortlist row whose first-order score was
    inf-masked (illegal/tried rows that leaked through a short
    argsort)."""
    att_losses[:-1] = np.where(np.isinf(scores[shortlist[:-1]]),
                               np.inf, att_losses[:-1])
    return att_losses


def candidate_mask(token_vocab: Vocab, padded_rows: int) -> np.ndarray:
    """[padded_rows] bool: True where a vocab row is a legal rename
    candidate — a real, identifier-renderable token (no PAD/OOV, no
    padding rows, no tokens with non-letter subtokens)."""
    mask = np.zeros((padded_rows,), dtype=bool)
    for idx, word in enumerate(token_vocab.to_word_list()):
        if word in (SpecialVocabWords.PAD, SpecialVocabWords.OOV):
            continue
        if render_identifier(word) is not None:
            mask[idx] = True
    return mask


@dataclasses.dataclass
class RenameStep:
    """One accepted rename in an attack trajectory."""
    from_token: str
    to_token: str
    loss_before: float
    loss_after: float


@dataclasses.dataclass
class AttackResult:
    success: bool
    targeted: bool
    original_prediction: str
    final_prediction: str
    target_name: Optional[str]
    # per-variable (original_token, final_token) pairs, in rename order
    renames: List[Tuple[str, str]]
    steps: List[RenameStep]       # full accepted-step trajectory
    iterations: int
    # the post-attack arrays (src, pth, dst, mask) — what detectors
    # and further analysis should score (None until attack_method ran)
    final_method: Optional[tuple] = None

    def __str__(self) -> str:
        kind = "targeted" if self.targeted else "untargeted"
        status = "SUCCESS" if self.success else "failed"
        rename = (", ".join(f"{a} -> {b}" for a, b in self.renames)
                  if self.renames else "(no rename)")
        line = (f"[{kind} {status}] rename {rename}: prediction "
                f"'{self.original_prediction}' -> "
                f"'{self.final_prediction}'")
        if self.targeted:
            line += f" (target '{self.target_name}')"
        return line


def rows_at(table: torch.Tensor, ids: torch.Tensor, mesh=None
            ) -> torch.Tensor:
    """The rows of a token or path table at global `ids` (no gradient):
    an index_select, or under a row-sharded `mesh` the model group's
    window rows summed (`take_window`), the same bits on every rank."""
    with torch.no_grad():
        if row_sharded(mesh):
            return take_window(table, ids, mesh)
        return table.index_select(0, ids)


def local_table(table: torch.Tensor, ids: Sequence[torch.Tensor],
                mesh=None) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The rows of `table` at the distinct ids of the id tensors `ids`
    (any shapes) in a local table (`rows_at`), and the ids remapped into
    it."""
    flat = torch.cat([t.reshape(-1).to(torch.int64) for t in ids])
    uniq, inv = torch.unique(flat, sorted=True, return_inverse=True)
    out, at = [], 0
    for t in ids:
        out.append(inv[at:at + t.numel()].reshape(t.shape))
        at += t.numel()
    return rows_at(table, uniq, mesh), out


def occurrence_table(table: torch.Tensor, ids: Sequence[torch.Tensor],
                      occ: Sequence[torch.Tensor], e: torch.Tensor,
                      mesh=None) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The local token table of M methods with e in their occurrence
    slots. `ids` are [M, n] id tensors read from the token table (source
    and target ids; the VarMisuse head adds its candidates), `occ` the
    bool slots of the attacked variable in each, `e` the [M, E] float32
    leaf. Returns (local table [U + M, E] in the table's dtype: the rows
    of the U distinct ids, then e cast to the table's dtype, as the JAX
    package casts it; the ids remapped into it, method m's occurrence
    slots at row U + m). Under a row-sharded `mesh` `table` is the
    rank's window and the rows are gathered from the windows
    (`rows_at`)."""
    rows, remapped = local_table(table, ids, mesh)
    row_of_e = rows.shape[0] + torch.arange(
        ids[0].shape[0], device=rows.device)[:, None]
    return (torch.cat([rows, e.to(table.dtype)]),
            [torch.where(o, row_of_e, r) for o, r in zip(occ, remapped)])


def make_attack_steps(dims: ModelDims, *, compute_dtype=torch.float32,
                      use_kernel: bool = True, mesh=None
                      ) -> Tuple[Callable, Callable, Callable]:
    """The three step functions of the attack, on the params' device.

    Returns (score_fn, eval_fn, predict_fn):
      score_fn(params, ids, occ, label, sign) -> [Vt] float32
        first-order loss delta of renaming the occurrence slots to each
        token row (lower = better for the attacker).
      eval_fn(params, ids, occ, cand_ids [K], label) ->
        (loss [K], top1 [K]) — exact model outputs for each candidate
        rename.
      predict_fn(params, ids) -> top1 on the clean input (0-d).

    `ids` is (src [C], pth [C], dst [C], mask [C]) tensors of ONE
    method; `occ` is (occ_src [C], occ_dst [C]) bool occurrence slots;
    `label` an int; `sign` is +1.0 to minimize CE(label) (targeted) or
    -1.0 to maximize it (untargeted). Each is the batched step at one
    method (`make_batched_attack_steps`, whose `mesh` it takes)."""
    return serial_steps(*make_batched_attack_steps(
        dims, compute_dtype=compute_dtype, use_kernel=use_kernel, mesh=mesh))


def serial_steps(score_b: Callable, eval_b: Callable, predict_b: Callable
                 ) -> Tuple[Callable, Callable, Callable]:
    """`make_attack_steps`'s three functions over the batched steps
    `score_b`, `eval_b` and `predict_b`, each called at one method."""
    def one(t):
        return t[None]

    def score_fn(params, ids, occ, label, sign):
        labels = torch.full((1,), int(label), dtype=torch.int64,
                            device=ids[0].device)
        return score_b(params, tuple(map(one, ids)), tuple(map(one, occ)),
                       labels, sign)[0]

    def eval_fn(params, ids, occ, cand_ids, label):
        labels = torch.full((1,), int(label), dtype=torch.int64,
                            device=ids[0].device)
        loss, top1 = eval_b(params, tuple(map(one, ids)),
                            tuple(map(one, occ)), cand_ids[None], labels)
        return loss[0], top1[0]

    def predict_fn(params, ids):
        return predict_b(params, tuple(map(one, ids)))[0]

    return score_fn, eval_fn, predict_fn


def make_batched_attack_steps(dims: ModelDims, *,
                              compute_dtype=torch.float32,
                              use_kernel: bool = True, mesh=None
                              ) -> Tuple[Callable, Callable, Callable]:
    """The steps over M methods at once: every array argument has a
    leading method dim [M, ...]; `sign` is one float.

      score_b(params, ids, occ, labels [M], sign) -> [M, Vt] float32
        (one backward of the M losses' sum w.r.t. the stacked [M, E]
        occurrence embeddings, then one [Vt, E] x [E, M] product);
      eval_b(params, ids, occ, cand_ids [M, K], labels [M]) ->
        (loss [M, K], top1 [M, K]): the M x K variants in one forward;
      predict_b(params, ids) -> top1 [M].

    Under a row-sharded `mesh` the params hold the rank's windows and
    every rank of the model group calls each step with the same
    arguments (the module docstring); any other mesh is ignored."""
    encode = get_encode_fn(dims)
    V = dims.target_vocab_size
    if not row_sharded(mesh):
        mesh = None

    def logits_of(params, src, pth, dst, mask, train=False,
                  local_tokens=False):
        # under the model axis: the rows the forward reads gathered whole
        # into local tables (the score's token table is local already)
        if mesh is not None and not local_tokens:
            tok, (src, dst) = local_table(params["token_emb"], (src, dst),
                                          mesh)
            params = dict(params, token_emb=tok)
        if mesh is not None:
            path, (pth,) = local_table(params["path_emb"], (pth,), mesh)
            params = dict(params, path_emb=path)
        code, _ = encode(params, src, pth, dst, mask,
                         compute_dtype=compute_dtype, use_kernel=use_kernel,
                         train=train)
        return full_logits(params, code, V, mesh)

    def top1(logits):
        if mesh is None:
            return torch.argmax(logits, dim=-1)
        return topk_merged(logits, 1, mesh)[1][:, 0]

    def score_b(params, ids, occ, labels, sign):
        src, pth, dst, mask = ids
        table = params["token_emb"]
        # occurrences all carry the same id (the attacked variable)
        cur_id = torch.amax(torch.where(occ[0], src, torch.where(
            occ[1], dst, torch.full_like(src, -1))), dim=1)
        e_var = rows_at(table, cur_id.to(torch.int64), mesh).to(
            torch.float32)
        e = e_var.clone().requires_grad_(True)
        with torch.enable_grad():
            local, (src2, dst2) = occurrence_table(table, (src, dst), occ,
                                                    e, mesh)
            logits = logits_of(dict(params, token_emb=local), src2, pth,
                               dst2, mask, train=True, local_tokens=True)
            ce = cross_entropy(logits, labels, mesh)
            (g,) = torch.autograd.grad((sign * ce).sum(), [e])
        # First-order delta of moving the shared embedding to row v:
        # (table[v] - e_var) @ g; the -e_var @ g term is constant and
        # kept only so the scores are true deltas (sign-interpretable).
        # Under a model axis each rank scores its window's rows and the
        # model group's columns are gathered in model order.
        with torch.no_grad():
            scores = torch.matmul(table.to(torch.float32), g.T).T
            scores = scores - (e_var * g).sum(dim=1, keepdim=True)
            if mesh is not None:
                scores = model_gather(scores, 1, mesh)
            return scores

    @torch.no_grad()
    def eval_b(params, ids, occ, cand_ids, labels):
        src, pth, dst, mask = ids
        M, K = cand_ids.shape
        C = src.shape[1]
        cand = cand_ids.to(src.dtype)[:, :, None]

        def variants(t, o):
            return torch.where(o[:, None, :], cand,
                               t[:, None, :]).reshape(M * K, C)

        def tile(t):
            return t[:, None, :].expand(M, K, C).reshape(M * K, C)

        logits = logits_of(params, variants(src, occ[0]), tile(pth),
                           variants(dst, occ[1]), tile(mask))
        lab = labels.to(torch.int64)[:, None].expand(M, K).reshape(M * K)
        loss = cross_entropy(logits, lab, mesh)
        return loss.reshape(M, K), top1(logits).reshape(M, K)

    @torch.no_grad()
    def predict_b(params, ids):
        return top1(logits_of(params, *ids))

    return score_b, eval_b, predict_b


def top_scores(scores: torch.Tensor, legal: torch.Tensor, t: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[M, V] first-order scores -> the T lowest legal ones, ascending
    (an illegal row scores inf), as (scores [M, T], ids [M, T]): equal
    scores by ascending id, `jax.lax.top_k(-s, T)`'s order, through
    `topk_stable`."""
    s = torch.where(legal[None, :], scores,
                    torch.full((), float("inf"), device=scores.device))
    neg, idx = topk_stable(-s, t)
    return -neg, idx


class GradientRenameAttack:
    """Host orchestration of the iterative rename attack on tensorized
    methods against a code2vec params dict (bag or transformer
    encoder, float32 or bf16 tables). Construct once per model, reuse
    across methods. `device=None` is the card (it raises without one);
    the params must lie there. Under a row-sharded `mesh` the params are
    the rank's windows and every rank of the model group runs the same
    attack (the module docstring); built by `over` a model that leads a
    cohort (serving/cohort.py), only the leader runs it, and each step's
    inputs go to the followers, which join its collectives."""

    def __init__(self, dims: ModelDims, token_vocab: Vocab,
                 target_vocab: Vocab, *, top_k_candidates: int = 32,
                 max_iters: int = 4, compute_dtype=torch.float32,
                 device: Optional[Union[str, torch.device]] = None,
                 use_kernel: bool = True, mesh=None):
        self.dims = dims
        self.token_vocab = token_vocab
        self.target_vocab = target_vocab
        self.compute_dtype = compute_dtype
        self.device = resolve_device(device)
        # the shortlist cannot exceed the vocab itself (tiny test vocabs)
        top_k_candidates = min(top_k_candidates,
                               dims.padded(dims.token_vocab_size))
        self.top_k = top_k_candidates
        self.max_iters = max_iters
        self.mesh = mesh if row_sharded(mesh) else None
        self._use_steps(*make_batched_attack_steps(
            dims, compute_dtype=compute_dtype, use_kernel=use_kernel,
            mesh=self.mesh))
        self.legal = candidate_mask(token_vocab,
                                    dims.padded(dims.token_vocab_size))
        self._legal_dev: Optional[torch.Tensor] = None

    @classmethod
    def over(cls, model, **kwargs) -> "GradientRenameAttack":
        """The attack over a predict-side model (models/torch_model.
        Code2VecModel): its dims, vocabs, dtype, device, kernel choice and
        mesh. Under a row-sharded mesh each step goes through
        `model.led`, so a model that leads a cohort announces it to the
        followers (serving/cohort.py)."""
        attack = cls(model.dims, model.vocabs.token_vocab,
                     model.vocabs.target_vocab,
                     compute_dtype=model.compute_dtype, device=model.device,
                     use_kernel=model.use_kernel, mesh=model.mesh, **kwargs)
        if attack.mesh is not None:
            attack._use_steps(*(model.led(op, fn) for op, fn in zip(
                ATTACK_OPS, (attack._score_b, attack._eval_b,
                             attack._predict_b))))
        return attack

    def _use_steps(self, score_b, eval_b, predict_b) -> None:
        """The batched steps, and the serial ones over them."""
        self._score_b, self._eval_b, self._predict_b = \
            score_b, eval_b, predict_b
        self.score_fn, self.eval_fn, self.predict_fn = serial_steps(
            score_b, eval_b, predict_b)

    def tensor(self, a) -> torch.Tensor:
        """A host array on the attack's device."""
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def tensors(self, arrays) -> tuple:
        return tuple(self.tensor(a) for a in arrays)

    # -- helpers ---------------------------------------------------------
    def attackable_tokens(self, src: np.ndarray, dst: np.ndarray,
                          mask: np.ndarray) -> List[Tuple[int, int]]:
        """[(token_id, n_occurrences)] of rename-candidate variables in
        one method, most frequent first. A 'variable' at tensor level is
        a token id occurring in valid src/dst slots (the extractor's
        normalized leaf tokens do not distinguish symbol kinds, so every
        leaf identifier is attackable — same granularity the paper's
        tensor-space search uses before source-level validation)."""
        valid = mask > 0
        ids, counts = np.unique(
            np.concatenate([src[valid], dst[valid]]), return_counts=True)
        out = [(int(i), int(c)) for i, c in zip(ids, counts)
               if i < len(self.legal) and self.legal[i]]
        out.sort(key=lambda ic: -ic[1])
        return out

    # -- single-variable attack -----------------------------------------
    def attack_token(self, params, method: Tuple[np.ndarray, np.ndarray,
                                                 np.ndarray, np.ndarray],
                     token_id: int, *, targeted: bool,
                     label: int, original_top1: int,
                     forbidden: frozenset = frozenset()
                     ) -> Tuple[bool, int, List[RenameStep], int]:
        """Iteratively rename `token_id`'s occurrences in one method.

        `label` is the target name id (targeted) or the clean top-1 id
        (untargeted: maximize its CE, succeed when top-1 changes).
        `forbidden` token ids are never chosen as the new name; tokens
        already PRESENT in the method are always forbidden — renaming a
        variable to an identifier the method already uses would merge
        distinct symbols in the representation (and collide with
        params/locals in real source). Returns (success, final_token_id,
        steps, iters_used)."""
        src, pth, dst, mask = (np.asarray(a) for a in method)
        occ_src = src == token_id
        occ_dst = dst == token_id
        occ = self.tensors((occ_src, occ_dst))
        sign = 1.0 if targeted else -1.0
        cur_id = token_id
        steps: List[RenameStep] = []
        tried = ({token_id} | set(forbidden)
                 | set(np.unique(np.concatenate([src, dst])).tolist()))
        cur_src, cur_dst = src.copy(), dst.copy()

        for it in range(1, self.max_iters + 1):
            ids = self.tensors((cur_src, pth, cur_dst, mask))
            scores = self.score_fn(params, ids, occ, label,
                                   sign).cpu().numpy()
            cand = build_shortlist(scores, self.legal, tried,
                                   self.top_k, cur_id)
            loss_k, top1_k = self.eval_fn(params, ids, occ,
                                          self.tensor(cand), label)
            att_loss_k = guard_leaked(sign * loss_k.cpu().numpy(),
                                      scores, cand)
            top1_k = top1_k.cpu().numpy()
            cur_attack_loss = float(att_loss_k[-1])
            best = int(np.argmin(att_loss_k[:-1]))
            tried.update(int(c) for c in cand)
            if att_loss_k[best] >= cur_attack_loss:
                return (attack_succeeded(targeted, int(top1_k[-1]),
                                         label, original_top1),
                        cur_id, steps, it)
            new_id = int(cand[best])
            steps.append(RenameStep(
                from_token=self.token_vocab.lookup_word(cur_id),
                to_token=self.token_vocab.lookup_word(new_id),
                loss_before=cur_attack_loss,
                loss_after=float(att_loss_k[best])))
            cur_src = np.where(occ_src, new_id, cur_src)
            cur_dst = np.where(occ_dst, new_id, cur_dst)
            cur_id = new_id
            if attack_succeeded(targeted, int(top1_k[best]), label,
                                original_top1):
                return True, cur_id, steps, it
        return False, cur_id, steps, self.max_iters

    # -- whole-method attack --------------------------------------------
    def attack_method(self, params, method, *, targeted: bool = False,
                      target_name: Optional[str] = None,
                      max_renames: int = 1,
                      token_ids: Optional[Sequence[int]] = None,
                      forbidden: frozenset = frozenset(),
                      baseline_top1: Optional[int] = None
                      ) -> AttackResult:
        """Attack one tensorized method: greedily rename up to
        `max_renames` variables (most-frequent first, or the explicit
        `token_ids`), carrying successful renames forward. `forbidden`
        ids are never used as new names (the source driver passes every
        identifier already present in the file). `baseline_top1`
        overrides the untargeted reference prediction — the dead-code
        driver passes the PRISTINE file's top-1 so 'flipped' means
        'differs from the original program', not 'differs from the
        placeholder-inserted variant'."""
        src, pth, dst, mask = (np.asarray(a) for a in method)
        if baseline_top1 is None:
            original_top1 = int(self.predict_fn(
                params, self.tensors((src, pth, dst, mask))))
        else:
            original_top1 = int(baseline_top1)
        if targeted:
            if target_name is None:
                raise ValueError("targeted attack needs a target name")
            label = self.target_vocab.lookup_index(target_name)
            if label == self.target_vocab.oov_index:
                raise ValueError(
                    f"target name '{target_name}' is out of vocabulary")
        else:
            label = original_top1

        if token_ids is None:
            token_ids = [t for t, _ in
                         self.attackable_tokens(src, dst, mask)]
        token_ids = list(token_ids)[:max_renames]

        cur = (src.copy(), pth, dst.copy(), mask)
        all_steps: List[RenameStep] = []
        renamed: List[Tuple[int, int]] = []  # (orig_id, final_id)/var
        iters = 0
        success = False
        for tid in token_ids:
            # a requested token can be absent from the tensorized
            # method (dead-code driver after MAX_CONTEXTS downsampling
            # dropped the inserted declaration's contexts): with no
            # occurrence slots the gradient is identically zero, so
            # skip instead of burning iterations on a no-op
            if not ((cur[0] == tid).any() or (cur[2] == tid).any()):
                continue
            ok, final_id, steps, used = self.attack_token(
                params, cur, tid, targeted=targeted, label=label,
                original_top1=original_top1, forbidden=forbidden)
            iters += used
            if steps:
                all_steps.extend(steps)
                renamed.append((tid, final_id))
                occ_s, occ_d = cur[0] == tid, cur[2] == tid
                cur = (np.where(occ_s, final_id, cur[0]), cur[1],
                       np.where(occ_d, final_id, cur[2]), cur[3])
            if ok:
                success = True
                break

        top1_f = self.predict_fn(params, self.tensors(cur))
        tv = self.target_vocab
        look = self.token_vocab.lookup_word
        return AttackResult(
            success=success, targeted=targeted,
            original_prediction=tv.lookup_word(original_top1),
            final_prediction=tv.lookup_word(int(top1_f)),
            target_name=target_name,
            renames=[(look(a), look(b)) for a, b in renamed],
            steps=all_steps, iterations=iters, final_method=cur)

    # -- lockstep batch attack ------------------------------------------
    def transfer_width(self) -> int:
        """T of the batch path's device top list: the host drops tried
        ids from it, so T covers the K-1 picks plus every id that can be
        in `tried` (initial method tokens <= 2C+1, plus K per prior
        iteration)."""
        rows = self.dims.padded(self.dims.token_vocab_size)
        return min(rows, (self.top_k - 1) + 2 * self.dims.max_contexts + 1
                   + self.top_k * self.max_iters)

    def attack_batch(self, params, methods: Sequence[Tuple]
                     ) -> List[AttackResult]:
        """Untargeted single-rename attack on M methods at once —
        semantically identical to `attack_method(m, targeted=False,
        max_renames=1)` per method (same scores, same selections, same
        acceptance), but each of the ~max_iters+2 device passes covers
        the WHOLE batch. Methods must each have at least one attackable
        token (the sweep filters first).

        Equivalence caveat: the serial path shortlists via argpartition
        (arbitrary order within the partition) while this path uses a
        sorted device top-k, so an EXACT float tie in first-order scores
        at the shortlist boundary can admit different candidate sets —
        and, since acceptance re-scores exactly, potentially a different
        accepted rename; a batch of M methods may also round otherwise
        than one method alone. The guarantee is "identical absent score
        ties", not unconditional."""
        if self._legal_dev is None:
            self._legal_dev = self.tensor(self.legal)
        T = self.transfer_width()
        M = len(methods)
        src = np.stack([np.asarray(m[0]) for m in methods])
        pth = np.stack([np.asarray(m[1]) for m in methods])
        dst = np.stack([np.asarray(m[2]) for m in methods])
        mask = np.stack([np.asarray(m[3]) for m in methods])
        tok_lists = [self.attackable_tokens(src[i], dst[i], mask[i])
                     for i in range(M)]
        for i, tl in enumerate(tok_lists):
            if len(tl) == 0:
                raise ValueError(
                    f"method {i} has no attackable tokens; filter with "
                    "attackable_tokens first (robustness.py's sweep "
                    "does this)")
        tok = np.array([tl[0][0] for tl in tok_lists], np.int32)
        occ_src = src == tok[:, None]
        occ_dst = dst == tok[:, None]
        occ = self.tensors((occ_src, occ_dst))
        pth_d, mask_d = self.tensors((pth, mask))
        labels = self._predict_b(
            params, (self.tensor(src), pth_d, self.tensor(dst),
                     mask_d)).cpu().numpy().astype(np.int32)
        original = labels.copy()
        labels_d = self.tensor(labels)

        cur_src, cur_dst = src.copy(), dst.copy()
        cur_id = tok.copy()
        tried = [({int(tok[i])}
                  | set(np.unique(np.concatenate(
                      [src[i], dst[i]])).tolist()))
                 for i in range(M)]
        steps: List[List[RenameStep]] = [[] for _ in range(M)]
        success = np.zeros((M,), bool)
        done = np.zeros((M,), bool)
        iters = np.zeros((M,), np.int32)
        look = self.token_vocab.lookup_word

        for _ in range(self.max_iters):
            ids = (self.tensor(cur_src), pth_d, self.tensor(cur_dst), mask_d)
            top_s, top_i = top_scores(
                self._score_b(params, ids, occ, labels_d, -1.0),
                self._legal_dev, T)
            top_s = top_s.cpu().numpy()
            top_i = top_i.cpu().numpy()
            cand = np.empty((M, self.top_k), np.int32)
            for i in range(M):
                # host-side: first K-1 untried, finite entries of the
                # device top list (legality was masked on device); pad
                # with cur_id when the list runs dry — those re-evaluate
                # the current loss and can never be accepted (>= test)
                cand[i, :] = cur_id[i]
                if done[i]:
                    continue
                w = 0
                for t, s in zip(top_i[i], top_s[i]):
                    if w == self.top_k - 1 or np.isinf(s):
                        break
                    if int(t) not in tried[i]:
                        cand[i, w] = int(t)
                        w += 1
            loss_k, top1_k = self._eval_b(params, ids, occ,
                                          self.tensor(cand), labels_d)
            loss_k = loss_k.cpu().numpy()
            top1_k = top1_k.cpu().numpy()
            for i in range(M):
                if done[i]:
                    continue
                att = -loss_k[i]
                iters[i] += 1
                best = int(np.argmin(att[:-1]))
                tried[i].update(int(c) for c in cand[i])
                if att[best] >= float(att[-1]):
                    success[i] = attack_succeeded(
                        False, int(top1_k[i, -1]), int(labels[i]),
                        int(original[i]))
                    done[i] = True
                    continue
                new_id = int(cand[i, best])
                steps[i].append(RenameStep(
                    from_token=look(int(cur_id[i])),
                    to_token=look(new_id),
                    loss_before=float(att[-1]),
                    loss_after=float(att[best])))
                cur_src[i] = np.where(occ_src[i], new_id, cur_src[i])
                cur_dst[i] = np.where(occ_dst[i], new_id, cur_dst[i])
                cur_id[i] = new_id
                if attack_succeeded(False, int(top1_k[i, best]),
                                    int(labels[i]), int(original[i])):
                    success[i] = True
                    done[i] = True
            if done.all():
                break

        final_top1 = self._predict_b(
            params, (self.tensor(cur_src), pth_d, self.tensor(cur_dst),
                     mask_d)).cpu().numpy()
        tv = self.target_vocab
        return [AttackResult(
            success=bool(success[i]), targeted=False,
            original_prediction=tv.lookup_word(int(original[i])),
            final_prediction=tv.lookup_word(int(final_top1[i])),
            target_name=None,
            renames=([(look(int(tok[i])), look(int(cur_id[i])))]
                     if steps[i] else []),
            steps=steps[i], iterations=int(iters[i]),
            final_method=(cur_src[i], pth[i], cur_dst[i], mask[i]))
            for i in range(M)]
