"""PFT in bfloat16 in 'bottleneck' mode (the two deepest skips trained,
bfloat16 activations) against the JAX package's bfloat16
``PFTOptimizer``, on the CPU, over a whole window: the checks of
``test_torch_bf16_pft_leaves.py`` (its docstring gives the rule, the
bounds and the readings), in a file of its own so that each file holds
one JAX program (~40 s of tracing and compile here).
"""

import pytest

import bf16_pft_harness as h
from test_torch_bf16_pft_leaves import (  # noqa: F401 (collected here too)
    AVG_FINAL_EPOCHS, EPOCHS, test_first_step_gradients,
    test_first_step_losses, test_first_updates_and_what_rounds_away,
    test_leaves_gradients_and_moments_are_bfloat16, test_window)
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module", params=["bottleneck"])
def runs(request):
    return h.mode_runs(request.param, EPOCHS, AVG_FINAL_EPOCHS,
                       *h.weights(), h.window())
