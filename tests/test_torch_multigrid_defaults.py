"""tests/test_torch_multigrid.py's comparison under the default settings
(``max_edge_dist=600``, ``th_point_count=400``), in a file of its own:
its JAX run compiles a program of its own."""

import pytest

from test_torch_multigrid import (  # noqa: F401 (the fixtures)
    check_multigrid, jax_runs, problem,
)


@pytest.mark.parametrize("name", ["defaults"])
def test_multigrid_matches_jax(problem, jax_runs, name):
    check_multigrid(problem, jax_runs, name)
