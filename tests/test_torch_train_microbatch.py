"""One microbatched train step of ``dvd_tpu_torch`` against ``dvd_tpu``'s
(CPU, f32; the check is ``test_torch_train_step.check_train_step``): a
batch of 4 as two accumulated chunks of 2, with the loss-second-moment
sampler.  A file of its own because compiling the JAX step's
accumulation scan takes about a minute on the CPU, so it runs beside the
other training tests under the parallel test runner.
"""

import test_torch_common  # noqa: F401  (sets torch to 1 thread)
from test_torch_train_step import check_train_step


def test_microbatched_train_step_matches_jax(monkeypatch):
    check_train_step("loss-second-moment", 2, monkeypatch)
