"""The port's chaos soak (``kubeflow_tpu_torch/testing/chaos.py``): the
cases of tests/test_chaos.py run again on it, unchanged — here seeds 0
and 2, the poison pill and the debug queue's requeue endpoint; seeds 1, 3
and 4 in tests/test_torch_chaos_soak_b.py, so that the wall-clock seeds
spread over two files."""

import pytest

from torch_control import clear_kftpu_env, ported, run_case

REFERENCE_CASES = ported("test_chaos.py")
ALL_CASES = sorted(k for k, v in REFERENCE_CASES.items()
                   if k.startswith("test_") and callable(v))
# The cases tests/test_torch_chaos_soak_b.py runs.
IN_SOAK_B = ("test_chaos_soak_seed_1", "test_chaos_soak_seed_3",
             "test_chaos_soak_seed_4")
CASES = [c for c in ALL_CASES if c not in IN_SOAK_B]


@pytest.fixture(autouse=True)
def _defaults(monkeypatch):
    clear_kftpu_env(monkeypatch)


def test_every_reference_case_is_collected():
    assert len(ALL_CASES) == 7
    assert set(IN_SOAK_B) < set(ALL_CASES)
    assert CASES == ["test_chaos_soak_seed_0", "test_chaos_soak_seed_2",
                     "test_debug_queue_requeue_endpoint",
                     "test_poison_pill_quarantine_end_to_end"]
    assert REFERENCE_CASES["ChaosSoak"].__module__ == \
        "kubeflow_tpu_torch.testing.chaos"


@pytest.mark.parametrize("case", CASES)
def test_reference_case_on_the_port(case):
    run_case(REFERENCE_CASES[case])
