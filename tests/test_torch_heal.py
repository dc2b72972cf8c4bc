"""The multigrid ``heal`` switch of the port against the JAX package's.

``segment_planes_multigrid(..., heal=True | "merge" | False)`` runs in
both packages on the CPU on the Morton-sorted scene of
tests/test_torch_multigrid.py, under its "hinted" settings.  The
contract is that of tests/test_forced_tpu_path.py: the same plane count,
cross agreement ≥ 0.99 and truth agreement within 0.01.  The switch
reaches the outermost finalize only (the inner level heals fully in
both packages); the port's finalize takes the segment sums
(``plane_sums``, kernel #8's plain version here) at ``heal=False``, the
payload-moment sums otherwise, and adopts holes only at ``heal=True``.
``heal=True`` is JAX's default: that case runs in
tests/test_torch_multigrid.py, on the hinted settings' JAX run.
"""

import pytest
import torch

from buildingsegment_tpu_torch.seg.coarse import segment_planes_multigrid
from test_torch_multigrid import (  # noqa: F401 (the fixtures)
    check_heal, jax_runs, problem,
)


@pytest.mark.parametrize("name", ["merge", "none"])
def test_heal_matches_jax(problem, jax_runs, monkeypatch, name):
    check_heal(problem, jax_runs, monkeypatch, name)


def test_heal_rejects_unknown(problem):
    spos, smask, dk, nrm, _curv, _ = problem
    with pytest.raises(ValueError, match="heal='adopt'"):
        segment_planes_multigrid(
            torch.from_numpy(spos), torch.from_numpy(nrm),
            torch.from_numpy(smask), kth_sq_dist=torch.from_numpy(dk),
            group=4, levels=2, heal="adopt")
