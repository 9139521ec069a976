"""The port's imitation train step against the JAX package's
`make_train_step`, at an int and at the "auto" teacher horizon: the
checks of test_torch_train_step.py (metrics to a relative 1e-4, every
parameter's gradient at atol 1e-5 / rtol 1e-3, the teacher's actions
exactly) on the teacher-forced rollout alone."""
import pytest

from test_torch_train_step import (rigs, run_pair,  # noqa: F401
                                   test_actions_identical,
                                   test_grads_match, test_metrics_match)


@pytest.fixture(scope="module", params=[("imitation", 5),
                                        ("imitation", "auto")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def step_pair(request, rigs):  # noqa: F811
    return run_pair(rigs, *request.param)
