"""Comparison helpers shared by the tests that hold the PyTorch port
against the JAX package (tests/test_torch_*.py)."""

from __future__ import annotations

import numpy as np


def assert_topk_agree(ids, probs, ref_ids, ref_probs, tol: float,
                      rtol: float = 0.0) -> int:
    """Top-k probabilities agree within `tol + rtol * p`; top-k ids agree
    at every position whose reference probability p is more than twice
    that away from both neighbours (closer ones may legitimately swap). The last
    position is not checked: its lower neighbour is outside the top-k.
    Returns the number of positions whose ids were checked."""
    ids, probs = np.asarray(ids), np.asarray(probs)
    ref_ids, ref_probs = np.asarray(ref_ids), np.asarray(ref_probs)
    assert ids.shape == ref_ids.shape and probs.shape == ref_probs.shape
    np.testing.assert_allclose(probs, ref_probs, atol=tol, rtol=rtol)
    checked = 0
    for i in range(ids.shape[0]):
        for j in range(ids.shape[1] - 1):
            below = ref_probs[i, j] - ref_probs[i, j + 1]
            above = ref_probs[i, j - 1] - ref_probs[i, j] if j else np.inf
            if min(below, above) > 2 * (tol + rtol * ref_probs[i, j]):
                assert ids[i, j] == ref_ids[i, j], (i, j)
                checked += 1
    return checked


def max_ulp_diff(a, b) -> int:
    """Largest distance in float32 units in the last place between two
    arrays (both widened to float32; +0 and -0 are 0 apart)."""
    a = np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)
    b = np.ascontiguousarray(np.asarray(b, np.float32)).view(np.int32)
    assert a.shape == b.shape

    def ordered(x):
        x = x.astype(np.int64)
        return np.where(x < 0, -(x & 0x7FFFFFFF), x)
    if a.size == 0:
        return 0
    return int(np.max(np.abs(ordered(a) - ordered(b))))


def assert_close_f32_ulp(a, b, n: int) -> None:
    """|a - b| within `n` float32 ulp of the largest |b| in the array: a
    fused multiply-add rounds once where a separate multiply and add
    round twice, and when the two terms cancel that difference is an ulp
    of the terms, not of their sum."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    if b.size:
        tol = n * float(np.spacing(np.max(np.abs(b))))
        np.testing.assert_allclose(a, b, rtol=0, atol=tol)


def supervisor_tool_plan(monkeypatch, capsys, argv):
    """Run the port's supervisor tool on `argv` with its supervise loop
    stubbed out (no child starts): (exit code, the `Supervisor` it
    built, its standard output)."""
    from code2vec_tpu_torch.tools import train_supervisor
    from code2vec_tpu_torch.training import supervisor
    built = []

    def run(self):
        built.append(self)
        return 0

    monkeypatch.setattr(supervisor.Supervisor, "run", run)
    rc = train_supervisor.main(argv)
    (sup,) = built
    return rc, sup, capsys.readouterr().out
