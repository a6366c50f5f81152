"""The port's controller runtime and fake apiserver behave as the
reference's: every case of tests/test_runtime.py and tests/test_fakekube.py
runs again with its imports pointed at ``kubeflow_tpu_torch`` (the
queue, the informer, the manager, apply, events, metrics, objects, the
fake apiserver's admission chain, watches, faults and the pod simulator),
asserts unchanged. Each reference case is one case here.
"""

import inspect

import pytest

from torch_control import ported, run_case

SOURCES = ("test_runtime.py", "test_fakekube.py")
MODULES = {name: ported(name) for name in SOURCES}
CASES = [(name, fn) for name, ns in MODULES.items()
         for fn in sorted(k for k, v in ns.items()
                          if k.startswith("test_") and callable(v))]


def test_every_reference_case_is_collected():
    assert len([c for c in CASES if c[0] == "test_runtime.py"]) == 26
    assert len([c for c in CASES if c[0] == "test_fakekube.py"]) == 14
    for ns in MODULES.values():
        assert ns["FakeKube"].__module__ == "kubeflow_tpu_torch.testing.fakekube"


@pytest.mark.parametrize("source,case", CASES,
                         ids=[f"{s[5:-3]}::{c}" for s, c in CASES])
def test_reference_case_on_the_port(source, case):
    fn = MODULES[source][case]
    assert not inspect.signature(fn).parameters, "fixtures are not ported"
    run_case(fn)
