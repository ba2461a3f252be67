"""Adversarial attacks on path-context models, and the rename defense.

Counterpart of `attacks/` in the JAX package (the `noamyft/code2vec`
fork delta; "Adversarial Examples for Models of Code", Yefet, Alon &
Yahav 2020), module for module:

- gradient_attack: gradient-guided variable renaming (targeted and
  untargeted): one backward pass to the occurrence embedding, a
  vocab-wide first-order score, exact batched re-scoring;
- source_attack: the source-level driver (rename / dead-code insertion
  in real Java or Python source), verified by re-extraction;
- detect: the attention-weighted rarity detector;
- robustness: the untargeted attack sweep over a test split (module
  CLI);
- defense: the random rename augmentation of the dense step
  (`--adv_rename_prob`);
- vm_attack, vm_robustness: the same attack and sweep against the
  VarMisuse head.
"""

from code2vec_tpu_torch.attacks.gradient_attack import (AttackResult,
                                                        GradientRenameAttack,
                                                        candidate_mask,
                                                        render_identifier)
from code2vec_tpu_torch.attacks.robustness import evaluate_robustness
from code2vec_tpu_torch.attacks.source_attack import (SourceAttack,
                                                      SourceAttackResult)
from code2vec_tpu_torch.attacks.vm_attack import (VMAttackResult,
                                                  VMGradientRenameAttack)
from code2vec_tpu_torch.attacks.vm_robustness import evaluate_vm_robustness

__all__ = ["AttackResult", "GradientRenameAttack", "candidate_mask",
           "render_identifier", "SourceAttack", "SourceAttackResult",
           "evaluate_robustness", "VMAttackResult",
           "VMGradientRenameAttack", "evaluate_vm_robustness"]
