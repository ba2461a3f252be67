"""Adversarial-training defense: random variable-rename augmentation.

Counterpart of `attacks/defense.py` in the JAX package (the defense
evaluated in "Adversarial Examples for Models of Code", Yefet, Alon &
Yahav 2020): with probability p (`--adv_rename_prob`) each training
example of the dense step has one of its variables renamed to another
legal token, all its occurrences replaced consistently. This is the
attack's manipulation without its gradient guidance; it runs on the
device inside the step, before the loss (training/steps.py).

The JAX augment draws from a key inside the jitted step. JAX threefry
and torch's generators never agree, so here the draws come in as a
`RenameDraws`, as every other draw of a step does (training/draws.py):
the Gumbel noise of the slot choice (`jax.random.categorical` is the
argmax of the logits plus Gumbel noise), the replacement's index into
the legal ids, the apply uniforms (`bernoulli` is `uniform < p`), and in
`batch` mode the roll. The trainer draws them from the step's seeded
generator (`RenameAugment.draw`); tests pass the values JAX's augment
draws from its keys, and the augmented batch is then JAX's, id for id.

Under a data-parallel mesh each rank augments its rows of the global
batch with its rows of the global draws (training/draws.py), and in
`batch` mode the donor roll runs over the GLOBAL batch, as the JAX
augment's roll runs over the sharded batch: each rank picks its rows'
slots, the picked tokens are all-gathered in rank order
(parallel/distributed.all_gather_rows), rolled by the global `shift`,
and the rank takes its own rows' donors. An R-rank augment is the
one-process augment over the concatenated batch, bit for bit. Under a
ctx axis the ranks of a group hold the same rows and their draws, and
the augment runs on the rows' whole contexts (training/steps.py gathers
them), so each rank of the group renames alike.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from code2vec_tpu_torch.attacks.gradient_attack import candidate_mask
from code2vec_tpu_torch.device import resolve_device
from code2vec_tpu_torch.models.encoder import ModelDims
from code2vec_tpu_torch.vocab.vocabularies import Vocab


def legal_token_mask(token_vocab: Vocab, dims: ModelDims) -> np.ndarray:
    """bool [padded_rows] — True where a vocab row is usable as a random
    replacement name (real, identifier-renderable tokens — same pool the
    attack draws from)."""
    mask = candidate_mask(token_vocab, dims.padded(dims.token_vocab_size))
    if not mask.any():
        raise ValueError("no legal rename tokens in the vocabulary")
    return mask


@dataclasses.dataclass
class RenameDraws:
    """The random inputs of one augmented batch of B examples of C
    contexts."""
    gumbel: torch.Tensor   # float32 [B, 2C]: the slot choice's noise
    # int64 [B]: the replacement's index into the legal ids ("uniform"),
    # or the fallback's where the donor is illegal ("batch")
    index: torch.Tensor
    apply_u: torch.Tensor  # float32 [B]: the rename applies where < p
    # "batch": the donor roll, in [1, G - 1] over the global batch of G
    shift: int = 0
    # under a mesh, this rank's [start, stop) rows of the global batch
    # whose donors the roll takes across the ranks; None in one process
    rows: Optional[Tuple[int, int]] = None
    # the mesh's ctx axis: the ranks of a ctx group hold the same rows
    ctx: int = 1


class RenameAugment:
    """`augment(batch, draws) -> batch`, on the batch's tensors.

    Per example: pick one valid context slot whose source or target
    token is a LEGAL identifier token (the attack's candidate pool —
    never OOV/PAD/literal tokens, whose occurrences span many distinct
    source identifiers), then with probability `prob` replace ALL
    occurrences of that token in the example's src/dst slots with a
    replacement token. Collisions with tokens the example already uses
    are allowed: augmentation is noise injection, not a validity-checked
    attack. Examples with no legal slot are left unchanged.

    `mode` selects the replacement:
    - "uniform": one uniformly-drawn legal token;
    - "batch": the token another example of the batch selected (a roll
      by `shift`), a fallback uniform legal token where that donor is
      illegal; a batch of one takes the uniform branch (a roll over one
      example is a self-rename). With `draws.rows` (a rank of a mesh)
      the roll is over the global batch (the module docstring)."""

    def __init__(self, legal: np.ndarray, prob: float, mode: str,
                 device: Optional[Union[str, torch.device]] = None):
        if mode not in ("uniform", "batch"):
            raise ValueError(f"unknown rename mode {mode!r}")
        self.prob = float(prob)
        self.mode = mode
        self.device = resolve_device(device)
        self.legal_mask = torch.from_numpy(np.asarray(legal, bool)).to(
            self.device)
        self.legal_ids = torch.from_numpy(
            np.nonzero(legal)[0].astype(np.int64)).to(self.device)

    def draw(self, generator: torch.Generator, batch_size: int,
             max_contexts: int) -> RenameDraws:
        """A batch's draws from `generator` (on the augment's device)."""
        dev, B = self.device, batch_size
        tiny = torch.finfo(torch.float32).tiny
        u = torch.rand((B, 2 * max_contexts), generator=generator,
                       device=dev).clamp_min_(tiny)
        gumbel = -torch.log(-torch.log(u))
        shift = 0
        if self.mode == "batch" and B > 1:
            shift = int(torch.randint(1, B, (), generator=generator,
                                      device=dev))
        index = torch.randint(0, self.legal_ids.shape[0], (B,),
                              generator=generator, device=dev)
        apply_u = torch.rand((B,), generator=generator, device=dev)
        return RenameDraws(gumbel=gumbel, index=index, apply_u=apply_u,
                           shift=shift)

    def __call__(self, batch, draws: RenameDraws):
        labels, src, pth, dst, mask, weights = batch
        B = src.shape[0]
        legal = self.legal_mask
        # one valid, legal-token slot per example, drawn over BOTH
        # context sides — a variable can survive only in dst slots
        # after downsampling, and the attack renames either side, so
        # the defense must too (all-padding rows have weight 0 —
        # whatever the choice returns there is never counted)
        all_tok = torch.cat([src, dst], dim=1).to(torch.int64)  # [B, 2C]
        all_mask = torch.cat([mask, mask], dim=1)
        eligible = (all_mask > 0) & legal[all_tok]
        slot_logits = torch.where(
            eligible, torch.zeros((), device=src.device),
            torch.full((), -1e9, device=src.device))
        j = torch.argmax(slot_logits + draws.gumbel, dim=-1)
        tok = torch.gather(all_tok, 1, j[:, None])[:, 0]
        fallback = self.legal_ids[draws.index]
        donor = None
        if self.mode == "batch" and draws.rows is not None:
            from code2vec_tpu_torch.parallel.distributed import \
                all_gather_rows
            everyone = all_gather_rows(tok)  # [G * ctx], rank order
            # one copy of each batch shard's rows (rank = shard * ctx + c)
            everyone = everyone.reshape(-1, draws.ctx, B)[:, 0].reshape(-1)
            if everyone.shape[0] > 1:
                lo, hi = draws.rows
                donor = torch.roll(everyone, draws.shift)[lo:hi]
        elif self.mode == "batch" and B > 1:
            donor = torch.roll(tok, draws.shift)
        new = fallback if donor is None \
            else torch.where(legal[donor], donor, fallback)
        keep = (draws.apply_u < self.prob) & legal[tok]
        # a non-id sentinel disables the rename where keep is False
        tok_eff = torch.where(keep, tok, torch.full_like(tok, -1))[:, None]
        new = new.to(src.dtype)[:, None]
        src2 = torch.where(src == tok_eff, new, src)
        dst2 = torch.where(dst == tok_eff, new, dst)
        return labels, src2, pth, dst2, mask, weights


def make_rename_augment(legal: np.ndarray, prob: float,
                        mode: str = "uniform",
                        device: Optional[Union[str, torch.device]] = None
                        ) -> RenameAugment:
    """The augment of `legal` (the bool [padded_rows] mask from
    legal_token_mask) at probability `prob` on `device` (default: the
    card)."""
    return RenameAugment(legal, prob, mode, device)
