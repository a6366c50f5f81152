"""The port's own copy of the JS runtime (``kubeflow_tpu_torch.testing.
jsrt``): every case of tests/test_jsrt.py runs again on it, unchanged."""

import pytest

from torch_control import ported, run_case

REFERENCE_CASES = ported("test_jsrt.py")
CASES = sorted(k for k, v in REFERENCE_CASES.items()
               if k.startswith("test_") and callable(v))


def test_every_reference_case_is_collected():
    assert len(CASES) == 32
    assert REFERENCE_CASES["Browser"].__module__ == \
        "kubeflow_tpu_torch.testing.jsrt.browser"


@pytest.mark.parametrize("case", CASES)
def test_reference_case_on_the_port(case):
    run_case(REFERENCE_CASES[case])
