"""The port's chaos soak, continued: seeds 1, 3 and 4 of
tests/test_chaos.py, unchanged, on ``kubeflow_tpu_torch`` (the other
cases are in tests/test_torch_chaos_soak_a.py)."""

import pytest

from torch_control import clear_kftpu_env, ported, run_case

REFERENCE_CASES = ported("test_chaos.py")
CASES = ["test_chaos_soak_seed_1", "test_chaos_soak_seed_3",
         "test_chaos_soak_seed_4"]


@pytest.fixture(autouse=True)
def _defaults(monkeypatch):
    clear_kftpu_env(monkeypatch)


@pytest.mark.parametrize("case", CASES)
def test_reference_case_on_the_port(case):
    run_case(REFERENCE_CASES[case])
