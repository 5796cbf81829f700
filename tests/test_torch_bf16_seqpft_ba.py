"""``run_sequential_pft --refiner ba`` (the joint window BA, the
value+Jacobian sampler's path) from a bfloat16 model directory against
the JAX package's CLI on the same directory, on the CPU: the checks of
``test_torch_bf16_seqpft.py`` (its docstring gives the setting, the rule
and the planted faults), in a file of its own so that each file holds one
JAX program.
"""

import pytest

from test_torch_bf16_seqpft import (  # noqa: F401 (collected here too)
    dirs, refiner_runs, test_printed_errors_match_jax,
    test_refiners_take_bfloat16_depths, test_saved_poses_and_losses_match_jax)
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module", params=["ba"])
def runs(request, dirs, tmp_path_factory):  # noqa: F811
    return refiner_runs(request.param, dirs, tmp_path_factory)
